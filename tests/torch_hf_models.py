"""Tiny Hugging Face models for the port's checkpoint tests.

``build(name)`` returns a seeded ``transformers`` model in eval mode: the
configs of ``tests/unit/test_hf_interop.py`` and
``tests/unit/test_hf_interop_archs.py``, under the same seeds, one entry a
case. ``save(model, directory, safe=True)`` writes it with
``save_pretrained``. This module imports neither JAX nor the JAX package,
so the gloo ranks of ``test_torch_hf_tp.py`` import it too.
"""

import numpy as np
import torch
import transformers

IDS = np.array([[3, 17, 120, 8, 0, 91, 44, 5, 66, 12]], dtype=np.int32)  # the archs tests' ids
LLAMA_IDS = np.array([[1, 5, 9, 200, 42, 7, 13, 99]], dtype=np.int32)
GPT2_IDS = np.array([[3, 17, 250, 8, 0, 91, 44, 5]], dtype=np.int32)

T = transformers
_OPT = dict(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, do_layer_norm_before=True, activation_function="relu", word_embed_proj_dim=64)
_GEMMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=32, max_position_embeddings=64, hidden_act="gelu_pytorch_tanh")
_FALCON40 = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_kv_heads=2,
                 new_decoder_architecture=True, parallel_attn=True, bias=False, alibi=False, tie_word_embeddings=True)
_FALCON7 = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, multi_query=True,
                parallel_attn=True, bias=False, new_decoder_architecture=False, alibi=False, tie_word_embeddings=True)
_PHI = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, partial_rotary_factor=0.5)
_STABLELM = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=64, partial_rotary_factor=0.25,
                 tie_word_embeddings=False)
_BERT = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64, type_vocab_size=2)
_MIXTRAL = dict(vocab_size=128, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2, max_position_embeddings=128,
                tie_word_embeddings=False)
_OLMO = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64, tie_word_embeddings=False)
_LLAMA_ROPE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=64)

# name -> (model class, config class, config kwargs, seed)
MODELS = {
    "llama": (T.LlamaForCausalLM, T.LlamaConfig,
              dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128, rms_norm_eps=1e-6, tie_word_embeddings=False),
              0),
    "gpt2": (T.GPT2LMHeadModel, T.GPT2Config, dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4), 1),
    "opt": (T.OPTForCausalLM, T.OPTConfig, _OPT, 0),
    "gpt_neox": (T.GPTNeoXForCausalLM, T.GPTNeoXConfig,
                 dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                      max_position_embeddings=64, rotary_pct=0.25, use_parallel_residual=True), 1),
    "gpt_neox_sequential": (T.GPTNeoXForCausalLM, T.GPTNeoXConfig,
                            dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                 num_attention_heads=4, max_position_embeddings=64, rotary_pct=1.0,
                                 use_parallel_residual=False), 2),
    "gptj": (T.GPTJForCausalLM, T.GPTJConfig, dict(vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
                                                  rotary_dim=8), 3),
    "falcon": (T.FalconForCausalLM, T.FalconConfig, _FALCON7, 4),
    "phi": (T.PhiForCausalLM, T.PhiConfig, _PHI, 5),
    "bloom": (T.BloomForCausalLM, T.BloomConfig, dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4), 6),
    "qwen2": (T.Qwen2ForCausalLM, T.Qwen2Config,
              dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=64, tie_word_embeddings=False), 7),
    "mistral_window": (T.MistralForCausalLM, T.MistralConfig,
                       dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, sliding_window=4,
                            tie_word_embeddings=False), 30),
    "falcon40": (T.FalconForCausalLM, T.FalconConfig, _FALCON40, 31),
    "gpt_bigcode_mq": (T.GPTBigCodeForCausalLM, T.GPTBigCodeConfig,
                       dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4, multi_query=True), 40),
    "gpt_bigcode_mha": (T.GPTBigCodeForCausalLM, T.GPTBigCodeConfig,
                        dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4, multi_query=False), 40),
    "gemma": (T.GemmaForCausalLM, T.GemmaConfig, _GEMMA, 50),
    "stablelm": (T.StableLmForCausalLM, T.StableLmConfig, dict(_STABLELM, use_qkv_bias=False), 60),
    "stablelm_qkv_bias": (T.StableLmForCausalLM, T.StableLmConfig, dict(_STABLELM, use_qkv_bias=True), 60),
    "phi3": (T.Phi3ForCausalLM, T.Phi3Config,
             dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=64, pad_token_id=0, eos_token_id=1, bos_token_id=2,
                  tie_word_embeddings=False), 70),
    "olmo_clip_qkv": (T.OlmoForCausalLM, T.OlmoConfig, dict(_OLMO, clip_qkv=0.05), 91),
    "olmo": (T.OlmoForCausalLM, T.OlmoConfig, _OLMO, 90),
    "qwen3": (T.Qwen3ForCausalLM, T.Qwen3Config,
              dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=32, max_position_embeddings=64, tie_word_embeddings=False), 100),
    "bert": (T.BertForMaskedLM, T.BertConfig, _BERT, 11),
    "gpt_neo": (T.GPTNeoForCausalLM, T.GPTNeoConfig,
                dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_position_embeddings=64,
                     window_size=4, attention_types=[[["global", "local"], 1]]), 14),
    "gpt_neo_global": (T.GPTNeoForCausalLM, T.GPTNeoConfig,
                       dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_position_embeddings=64,
                            attention_types=[[["global"], 2]]), 15),
    "distilbert": (T.DistilBertForMaskedLM, T.DistilBertConfig,
                   dict(vocab_size=128, dim=64, hidden_dim=128, n_layers=2, n_heads=4, max_position_embeddings=64), 16),
    "qwen2_suffix_window": (T.Qwen2ForCausalLM, T.Qwen2Config,
                            dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                                 num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
                                 use_sliding_window=True, sliding_window=4, max_window_layers=1), 17),
    "llama_attention_bias": (T.LlamaForCausalLM, T.LlamaConfig,
                             dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                  num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
                                  attention_bias=True), 18),
    "mixtral": (T.MixtralForCausalLM, T.MixtralConfig, _MIXTRAL, 11),
}

ROPE_SCALINGS = [
    {"rope_type": "linear", "factor": 2.0},
    {"rope_type": "dynamic", "factor": 2.0},
    {"rope_type": "dynamic", "factor": 2.0, "original_max_position_embeddings": 32},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
     "original_max_position_embeddings": 32},
    {"rope_type": "yarn", "factor": 2.0, "original_max_position_embeddings": 32},
]


def build(name: str, seed=None, **overrides):
    """The seeded tiny model ``name`` (``MODELS``), in eval mode; ``overrides``
    change its config's fields, ``seed`` its seed."""
    model_cls, config_cls, kw, default_seed = MODELS[name]
    torch.manual_seed(default_seed if seed is None else seed)
    return model_cls(config_cls(**{**kw, **overrides})).eval()


def build_rope(scaling: dict):
    """The archs tests' llama with ``rope_scaling`` (seed 23)."""
    torch.manual_seed(23)
    return T.LlamaForCausalLM(T.LlamaConfig(**_LLAMA_ROPE, rope_scaling=dict(scaling))).eval()


def save(model, directory, safe: bool = True) -> str:
    model.save_pretrained(directory, safe_serialization=safe)
    return str(directory)


def hf_logits(model, ids, **kw) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(ids, np.int64)), **kw).logits.float().numpy()


TP_ARCHS = {"gemma": 80, "falcon40": 80, "stablelm": 80, "bert": 13}  # test_new_arch_tp2_serving's and
# test_bert_tp2_serving's models and seeds


def tp_logits(rank: int, world: int, dirs: dict, out_dir: str) -> None:
    """One gloo rank of ``test_torch_hf_tp``: for each checkpoint directory,
    the v1 engine at ``tp_size`` = world on this rank's slices, built two ways
    (``load_hf_checkpoint(tp_size, rank)`` + ``init_inference(model,
    params=)``, and ``init_inference(path)``); both logits go to ``out_dir``."""
    import os

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint

    config = {"tensor_parallel": {"tp_size": world}, "dtype": "fp32", "device": "cpu"}
    for name, d in dirs.items():
        model, params = load_hf_checkpoint(d, device="cpu", tp_size=world, rank=rank)
        kernel = params["layer_0"]["attn"]["q_proj"]["kernel"]
        assert kernel.shape[1] == model.cfg.n_heads // world, kernel.shape
        a = init_inference(model, config, params=params).forward(IDS).numpy()
        b = init_inference(d, config).forward(IDS).numpy()
        np.save(os.path.join(out_dir, f"{name}_{rank}_loaded.npy"), a)
        np.save(os.path.join(out_dir, f"{name}_{rank}_path.npy"), b)
