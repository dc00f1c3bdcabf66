"""Hugging Face checkpoints into the port's ``CausalLM``, and the
tensor-parallel layouts of serving parameter trees.

Port of ``deepspeed_tpu/module_inject/load_checkpoint.py``:
- Readers (JAX ``:48-90``): ``model.safetensors`` parsed by hand (the
  8-byte little-endian header length, the JSON header, then each tensor's
  bytes through ``torch.frombuffer``), a ``model.safetensors.index.json``'s
  shards, ``pytorch_model.bin`` (and its index) through
  ``torch.load(weights_only=True)``. The package never imports
  ``safetensors`` or ``transformers``. ``load_hf_state_dict`` returns the
  tensors in their stored dtype; the JAX one returns fp32 numpy arrays.
- ``config_from_hf`` (JAX ``:150``) maps every ``model_type`` the JAX
  package maps to the same ``TransformerConfig`` fields, with the same
  refusals (longrope, OPT's projections and post-LN, falcon's interleaved
  rw layout, stablelm's qk-layernorm and parallel residual, distilbert's
  sinusoidal positions). ``dtype`` is a torch dtype (default fp32).
- One converter per family (JAX ``:564-1119``) into the flax keys and
  layouts of ``models/transformer.py``: torch ``Linear`` (out, in) is
  transposed to (in, out), fused q/k/v rows are split as each family
  stores them, attention kernels take their (d, H, Dh) / (H, Dh, d) shapes.
  The converters only move data, so the leaves are the JAX leaves' values
  bit for bit.
- ``load_hf_checkpoint(model_dir, dtype, device, tp_size, rank)`` and
  ``load_hf_model(hf_model, ...)`` (which reads only
  ``hf_model.config.to_dict()`` and ``state_dict()``) return
  ``(CausalLM, params)``: leaves cast to ``dtype`` (fp32 by default, the JAX
  loader's numpy fp32) and placed on ``device`` (default ``"cuda"``). With
  ``tp_size > 1`` each rank keeps only its slice of each leaf
  (``shard_params`` under the model's rules), the port's form of JAX's
  ``shard=True``: JAX device-puts the whole tree with a ``NamedSharding``,
  here each rank is a process.

The tensor-parallel layouts (JAX ``tp_shardings`` :1172, ``shard_params``
:1200): along every dimension that a leaf's rule puts on ``tensor``, rank
``r`` of ``tp`` takes the ``r``-th of ``tp`` equal parts, which is the JAX
shard of the same ``tensor`` index. The rules are the model's
``partition_rules()`` (``CausalLM``: column-parallel q/k/v, gate and up,
row-parallel o and down, vocab-parallel ``wte`` and ``lm_head``, the MoE
rules first: each expert's hidden dim on ``tensor``), or without a model
``auto_tp.AutoTP``'s, as in JAX. Axes other than ``tensor`` have size 1 on
a serving mesh and cut nothing. A dimension that ``tp`` does not divide
raises, as the JAX ``device_put`` does, except on the vocab-parallel leaves
(``VOCAB_LEAVES``): there the leaf stays whole on every rank (GPT-2's
vocabulary of 50,257 is odd) and the serving modules read from its shape
that it is not sharded.

``SERVING_BIAS_RULES`` are the port's own: the biases of the
column-parallel projections split with their outputs, so that a rank adds
the bias of its own heads or columns. The JAX package leaves every bias
whole (its GSPMD partitioner splits the add); the serving engines append
these rules, ``shard_params`` alone does not.
"""

import json
import logging
import mmap
import os
import struct
import time
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch

from ..models.transformer import CausalLM, TransformerConfig, param_shapes
from ..runtime.zero.partition import match_partition_rule

logger = logging.getLogger(__name__)

SAFETENSORS_NAME = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
TORCH_NAME = "pytorch_model.bin"
TORCH_INDEX = "pytorch_model.bin.index.json"

TP_AXIS = "tensor"
VOCAB_LEAVES = ("wte", "lm_head")
SERVING_BIAS_RULES = [
    (("q_proj", "bias"), (TP_AXIS, None)),
    (("k_proj", "bias"), (TP_AXIS, None)),
    (("v_proj", "bias"), (TP_AXIS, None)),
    (("gate_proj", "bias"), (TP_AXIS,)),
    (("up_proj", "bias"), (TP_AXIS,)),
    (("lm_head", "bias"), (TP_AXIS,)),
]

StateDict = Dict[str, torch.Tensor]

# the last load's wall seconds by step and the bytes read: read_s parses the headers and maps the files (a
# safetensors file's pages are read where they are first used: in to_device_s on a CUDA device, in convert_s on
# the CPU), to_device_s moves the state dict to a CUDA device at tp 1, convert_s converts, slices and places
last_load: Dict[str, float] = {}


# ----------------------------------------------------------------------
# state-dict reading (host side, the stored dtypes)
# ----------------------------------------------------------------------
_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
              "BOOL": torch.bool}


def read_safetensors(path: str) -> StateDict:
    """Every tensor of one ``.safetensors`` file, in its stored dtype, on the
    CPU. The file is an 8-byte little-endian header length, a JSON header
    ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` (and an
    optional ``__metadata__``), then the tensors' bytes. Each tensor is a
    view of a private (copy-on-write) mapping of the file, so its pages are
    read when it is first used (a copy to the device reads them once) and
    writes never reach the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else bytearray()
    base = 8 + n
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise NotImplementedError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the reader does "
                                      f"not take ({sorted(_ST_DTYPES)})")
        dt = _ST_DTYPES[info["dtype"]]
        begin, end = (base + o for o in info["data_offsets"])
        item = torch.empty((), dtype=dt).element_size()
        count = (end - begin) // item
        if count == 0:
            t = torch.empty(0, dtype=dt)
        elif begin % item:  # an unaligned tensor: copy its bytes to a buffer of its own
            t = torch.frombuffer(bytearray(buf[begin:end]), dtype=dt, count=count)
        else:
            t = torch.frombuffer(buf, dtype=dt, count=count, offset=begin)
        out[name] = t.reshape(info["shape"])
    return out


def read_torch_bin(path: str) -> StateDict:
    """A ``pytorch_model.bin`` state dict (``torch.load``, weights only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in sd.items()}


def load_hf_state_dict(model_dir: str) -> StateDict:
    """Read a Hugging Face checkpoint directory (one file or a sharded
    index, safetensors or torch .bin) into a flat state dict of CPU tensors
    in their stored dtypes (JAX ``load_hf_state_dict``: fp32 numpy)."""
    st = os.path.join(model_dir, SAFETENSORS_NAME)
    if os.path.exists(st):
        return read_safetensors(st)
    for index_name, reader in ((SAFETENSORS_INDEX, read_safetensors), (TORCH_INDEX, read_torch_bin)):
        idx = os.path.join(model_dir, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            out: StateDict = {}
            for shard in sorted(set(weight_map.values())):
                out.update(reader(os.path.join(model_dir, shard)))
            return out
    tb = os.path.join(model_dir, TORCH_NAME)
    if os.path.exists(tb):
        return read_torch_bin(tb)
    raise FileNotFoundError(f"no {SAFETENSORS_NAME}/{TORCH_NAME} (or sharded index) under {model_dir}")


# ----------------------------------------------------------------------
# config mapping
# ----------------------------------------------------------------------
def _map_gelu(hf_act: str) -> str:
    """A Hugging Face activation name -> the config's. HF 'gelu' is the exact
    erf GELU; 'gelu_new' / 'gelu_fast' / 'gelu_pytorch_tanh' are the tanh
    approximation that 'gelu' means here."""
    if hf_act == "relu":
        return "relu"
    if hf_act == "gelu":
        return "gelu_exact"
    return "gelu"


def _rope_scaling_kwargs(hf: Dict[str, Any]) -> Dict[str, Any]:
    """HF ``rope_scaling`` -> the config's rope_* fields: linear, dynamic
    NTK, llama3, yarn (``scaled_rope_frequencies``). ``longrope`` (phi-3's
    per-dimension factor tables) is refused: base rope would diverge past
    the base window."""
    rs = hf.get("rope_scaling") or hf.get("rope_parameters")
    if not isinstance(rs, dict):
        return {}
    kind = rs.get("rope_type", rs.get("type", "default"))
    factor = rs.get("factor", 1.0)
    if kind in (None, "default"):
        return {}
    if factor is None or (float(factor) == 1.0 and kind in ("linear", "dynamic")):
        return {}  # identity interpolation
    if kind not in ("linear", "dynamic", "llama3", "yarn"):
        raise NotImplementedError(
            f"HF config requests rope_scaling={rs!r} ({hf.get('model_type', '?')}); supported "
            "variants: linear/dynamic/llama3/yarn — longrope-class per-dim tables are not, and "
            "loading with base rope would silently diverge past the base context")
    kw: Dict[str, Any] = {"rope_scaling": kind, "rope_factor": float(factor)}
    # dynamic rescales against max_position_embeddings (HF ignores its original_max_position_embeddings)
    orig = hf.get("max_position_embeddings") if kind == "dynamic" else rs.get("original_max_position_embeddings")
    if orig:
        kw["rope_orig_max_seq"] = int(orig)
    if kind == "llama3":
        kw["rope_low_freq_factor"] = float(rs.get("low_freq_factor", 1.0))
        kw["rope_high_freq_factor"] = float(rs.get("high_freq_factor", 4.0))
    if kind == "yarn":
        kw["rope_beta_fast"] = float(rs.get("beta_fast") or 32.0)
        kw["rope_beta_slow"] = float(rs.get("beta_slow") or 1.0)
        if rs.get("attention_factor") is not None:
            kw["rope_attn_factor"] = float(rs["attention_factor"])
    return kw


def _heads(hf: Dict[str, Any], default: int) -> Dict[str, Any]:
    """The llama-style head counts: query heads and KV heads."""
    n = hf.get("num_attention_heads", default)
    return dict(n_heads=n, n_kv_heads=hf.get("num_key_value_heads", n))


def config_from_hf(hf: Dict[str, Any], dtype: Optional[torch.dtype] = None, **overrides) -> TransformerConfig:
    """Map a Hugging Face ``config.json`` dict to ``TransformerConfig`` (JAX
    ``config_from_hf``, field for field; ``dtype`` the compute dtype,
    default fp32)."""
    model_type = hf.get("model_type", "")
    dtype = dtype if dtype is not None else torch.float32
    rope_kw = _rope_scaling_kwargs(hf)
    if model_type == "gpt2":
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("n_layer", 12), n_heads=hf.get("n_head", 12),
                  d_model=hf.get("n_embd", 768), max_seq_len=hf.get("n_positions", 1024), norm="layernorm",
                  activation=_map_gelu(hf.get("activation_function", "gelu_new")), pos_emb="learned",
                  tie_embeddings=True, norm_eps=hf.get("layer_norm_epsilon", 1e-5))
    elif model_type in ("llama", "mistral", "qwen2", "qwen3", "mixtral", "internlm", ""):
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 2), **_heads(hf, 4),
                  d_model=hf.get("hidden_size", 128), d_ff=hf.get("intermediate_size"),
                  max_seq_len=hf.get("max_position_embeddings", 2048), norm="rmsnorm", activation="swiglu",
                  pos_emb="rope", rope_theta=hf.get("rope_theta", 10000.0),
                  tie_embeddings=hf.get("tie_word_embeddings", False), norm_eps=hf.get("rms_norm_eps", 1e-6))
        if model_type == "qwen2":
            kw["qkv_bias"] = True
        if model_type == "llama" and hf.get("attention_bias"):
            kw["qkv_bias"] = True
            kw["attn_out_bias"] = True
        if model_type == "internlm":  # the llama layout; config.bias toggles q/k/v and o biases
            kw["qkv_bias"] = bool(hf.get("bias", False))
            kw["attn_out_bias"] = bool(hf.get("bias", False))
        if model_type == "qwen3":
            kw["qk_norm"] = True
            if hf.get("head_dim"):
                kw["head_dims"] = int(hf["head_dim"])
        if model_type in ("mistral", "mixtral") and hf.get("sliding_window"):
            kw["sliding_window"] = int(hf["sliding_window"])
        # qwen2 gates its window behind use_sliding_window and windows only the layers >= max_window_layers
        if model_type in ("qwen2", "qwen3") and hf.get("use_sliding_window") and hf.get("sliding_window"):
            mwl = int(hf.get("max_window_layers", 28))  # HF Qwen2Config's default
            n_layers = kw["n_layers"]
            if mwl <= 0:
                kw["sliding_window"] = int(hf["sliding_window"])
            elif mwl < n_layers:
                kw["sliding_window"] = int(hf["sliding_window"])
                kw["window_layers"] = tuple(range(mwl, n_layers))
        if model_type == "mixtral":
            kw.update(moe_num_experts=hf.get("num_local_experts", 8), moe_top_k=hf.get("num_experts_per_tok", 2),
                      moe_layer_freq=1, moe_aux_loss_coef=hf.get("router_aux_loss_coef", 0.02))
    elif model_type == "olmo":
        kw = dict(clip_qkv=float(hf["clip_qkv"]) if hf.get("clip_qkv") else None, vocab_size=hf["vocab_size"],
                  n_layers=hf.get("num_hidden_layers", 2), **_heads(hf, 4), d_model=hf["hidden_size"],
                  d_ff=hf.get("intermediate_size"), max_seq_len=hf.get("max_position_embeddings", 2048),
                  norm="layernorm_np", activation="swiglu", pos_emb="rope", rope_theta=hf.get("rope_theta", 10000.0),
                  tie_embeddings=hf.get("tie_word_embeddings", False))
    elif model_type == "phi3":
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 2), **_heads(hf, 4),
                  d_model=hf["hidden_size"], d_ff=hf.get("intermediate_size"),
                  max_seq_len=hf.get("max_position_embeddings", 4096), norm="rmsnorm", activation="swiglu",
                  pos_emb="rope", rope_theta=hf.get("rope_theta", 10000.0),
                  tie_embeddings=hf.get("tie_word_embeddings", False), norm_eps=hf.get("rms_norm_eps", 1e-5))
        if hf.get("sliding_window"):
            kw["sliding_window"] = int(hf["sliding_window"])
    elif model_type == "stablelm":
        if hf.get("qk_layernorm", False):
            raise NotImplementedError("stablelm qk_layernorm (per-head q/k norms, stablelm-2-12b) unsupported")
        if hf.get("use_parallel_residual", False):
            raise NotImplementedError("stablelm use_parallel_residual variants are unsupported")
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 2), **_heads(hf, 4),
                  d_model=hf["hidden_size"], d_ff=hf.get("intermediate_size"),
                  max_seq_len=hf.get("max_position_embeddings", 4096), norm="layernorm", activation="swiglu",
                  pos_emb="rope", rotary_pct=hf.get("partial_rotary_factor", 0.25),
                  rope_theta=hf.get("rope_theta", 10000.0), qkv_bias=hf.get("use_qkv_bias", False),
                  dense_bias=False,  # the layernorms carry biases, the linears do not
                  tie_embeddings=hf.get("tie_word_embeddings", False), norm_eps=hf.get("layer_norm_eps", 1e-5))
    elif model_type == "gemma":
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 2), **_heads(hf, 8),
                  head_dims=hf.get("head_dim", 256), d_model=hf["hidden_size"], d_ff=hf.get("intermediate_size"),
                  max_seq_len=hf.get("max_position_embeddings", 8192), norm="rmsnorm",
                  rms_offset=True,  # zero-centred norm weights, applied as (1 + w)
                  embed_scale=True,  # embeddings times sqrt(d_model)
                  activation="geglu",  # "gelu" (legacy) and "gelu_pytorch_tanh" both mean the tanh gate
                  pos_emb="rope", rope_theta=hf.get("rope_theta", 10000.0),
                  tie_embeddings=hf.get("tie_word_embeddings", True), norm_eps=hf.get("rms_norm_eps", 1e-6))
    elif model_type == "opt":
        if hf.get("word_embed_proj_dim", hf["hidden_size"]) != hf["hidden_size"]:
            raise NotImplementedError("OPT variants with word_embed_proj_dim != hidden_size (350m) "
                                      "need the embed in/out projections")
        if not hf.get("do_layer_norm_before", True):
            raise NotImplementedError("OPT with do_layer_norm_before=False (125m-era post-LN) unsupported")
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 12),
                  n_heads=hf.get("num_attention_heads", 12), d_model=hf["hidden_size"],
                  d_ff=hf.get("ffn_dim", 4 * hf["hidden_size"]), max_seq_len=hf.get("max_position_embeddings", 2048),
                  norm="layernorm", activation=_map_gelu(hf.get("activation_function", "relu")), pos_emb="learned",
                  tie_embeddings=hf.get("tie_word_embeddings", True))
    elif model_type == "gpt_neox":
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 12),
                  n_heads=hf.get("num_attention_heads", 12), d_model=hf["hidden_size"],
                  d_ff=hf.get("intermediate_size", 4 * hf["hidden_size"]),
                  max_seq_len=hf.get("max_position_embeddings", 2048), norm="layernorm",
                  activation=_map_gelu(hf.get("hidden_act", "gelu")), pos_emb="rope",
                  rotary_pct=hf.get("rotary_pct", 1.0),
                  # transformers writes rope_theta beside a possibly stale rotary_emb_base
                  rope_theta=hf.get("rope_theta", hf.get("rotary_emb_base", 10000.0)),
                  block_type="parallel" if hf.get("use_parallel_residual", True) else "sequential",
                  tie_embeddings=hf.get("tie_word_embeddings", False), norm_eps=hf.get("layer_norm_eps", 1e-5))
    elif model_type == "gptj":
        head_dim = hf["n_embd"] // hf["n_head"]
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("n_layer", 12), n_heads=hf.get("n_head", 12),
                  d_model=hf["n_embd"], d_ff=hf.get("n_inner") or 4 * hf["n_embd"],
                  max_seq_len=hf.get("n_positions", 2048), norm="layernorm",
                  activation=_map_gelu(hf.get("activation_function", "gelu_new")), pos_emb="rope",
                  rotary_dims=hf.get("rotary_dim") or head_dim, rope_style="gptj", block_type="parallel_shared",
                  qkv_bias=False, attn_out_bias=False, dense_bias=True, lm_head_bias=True, tie_embeddings=False,
                  norm_eps=hf.get("layer_norm_epsilon", 1e-5))
    elif model_type == "falcon":
        new_arch = hf.get("new_decoder_architecture", False)
        if not hf.get("parallel_attn", True):
            raise NotImplementedError("falcon with parallel_attn=False unsupported")
        if not new_arch and not hf.get("multi_query", True):
            raise NotImplementedError("falcon multi_query=False uses an interleaved qkv layout (rw-style); "
                                      "unsupported")
        if new_arch:  # 40b / 180b: GQA and separate ln_attn / ln_mlp
            n_kv = hf.get("num_kv_heads") or hf.get("num_attention_heads", 8)
        else:  # 7b: MQA and one shared input layernorm
            n_kv = 1 if hf.get("multi_query", True) else hf.get("num_attention_heads", 8)
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 2),
                  n_heads=hf.get("num_attention_heads", 8), n_kv_heads=n_kv, d_model=hf["hidden_size"],
                  d_ff=hf.get("ffn_hidden_size") or 4 * hf["hidden_size"],
                  max_seq_len=hf.get("max_position_embeddings", 2048), norm="layernorm",
                  activation=_map_gelu(hf.get("activation", "gelu")),
                  pos_emb="alibi" if hf.get("alibi", False) else "rope", rope_theta=hf.get("rope_theta", 10000.0),
                  block_type="parallel" if new_arch else "parallel_shared", dense_bias=hf.get("bias", False),
                  tie_embeddings=hf.get("tie_word_embeddings", True), norm_eps=hf.get("layer_norm_epsilon", 1e-5))
    elif model_type == "phi":
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 2),
                  n_heads=hf.get("num_attention_heads", 4),
                  n_kv_heads=hf.get("num_key_value_heads") or hf.get("num_attention_heads", 4),
                  d_model=hf["hidden_size"], d_ff=hf.get("intermediate_size", 4 * hf["hidden_size"]),
                  max_seq_len=hf.get("max_position_embeddings", 2048), norm="layernorm",
                  activation=_map_gelu(hf.get("hidden_act", "gelu_new")), pos_emb="rope",
                  rotary_pct=hf.get("partial_rotary_factor", 0.5), rope_theta=hf.get("rope_theta", 10000.0),
                  block_type="parallel_shared", dense_bias=True, qkv_bias=True, lm_head_bias=True,
                  tie_embeddings=hf.get("tie_word_embeddings", False), norm_eps=hf.get("layer_norm_eps", 1e-5))
    elif model_type == "gpt_bigcode":
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("n_layer", 12), n_heads=hf.get("n_head", 12),
                  n_kv_heads=1 if hf.get("multi_query", True) else hf.get("n_head", 12), d_model=hf["n_embd"],
                  d_ff=hf.get("n_inner") or 4 * hf["n_embd"], max_seq_len=hf.get("n_positions", 2048),
                  norm="layernorm", activation=_map_gelu(hf.get("activation_function", "gelu_pytorch_tanh")),
                  pos_emb="learned", tie_embeddings=hf.get("tie_word_embeddings", True),
                  norm_eps=hf.get("layer_norm_epsilon", 1e-5))
    elif model_type == "bert":
        # the encoder: bidirectional post-LN blocks, segment embeddings, the MLM transform head
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("num_hidden_layers", 12),
                  n_heads=hf.get("num_attention_heads", 12), d_model=hf.get("hidden_size", 768),
                  d_ff=hf.get("intermediate_size", 3072), max_seq_len=hf.get("max_position_embeddings", 512),
                  norm="layernorm", activation=_map_gelu(hf.get("hidden_act", "gelu")), pos_emb="learned",
                  causal=False, norm_scheme="post", embedding_norm=True,
                  type_vocab_size=hf.get("type_vocab_size", 2), mlm_head=True, tie_embeddings=True,
                  norm_eps=hf.get("layer_norm_eps", 1e-12))
    elif model_type == "gpt_neo":
        # gpt2's learned positions, torch Linear projections, bias-free q/k/v, unscaled attention logits and
        # alternating global / local (window 256) layers from attention_layers
        d_model = hf.get("hidden_size", 2048)
        n_layers = hf.get("num_layers", 24)
        att_layers = hf.get("attention_layers")
        if not att_layers:  # expand [["global", "local"], 12]-style attention_types
            att_layers = []
            for kinds, n in hf.get("attention_types") or [[["global"], n_layers]]:
                att_layers += list(kinds) * n
        kw = dict(vocab_size=hf["vocab_size"], n_layers=n_layers, n_heads=hf.get("num_heads", 16), d_model=d_model,
                  d_ff=hf.get("intermediate_size") or 4 * d_model,
                  max_seq_len=hf.get("max_position_embeddings", 2048), norm="layernorm",
                  activation=_map_gelu(hf.get("activation_function", "gelu_new")), pos_emb="learned",
                  qkv_bias=False, attn_scale=1.0, tie_embeddings=hf.get("tie_word_embeddings", True),
                  norm_eps=hf.get("layer_norm_epsilon", 1e-5))
        local = tuple(i for i, kind in enumerate(att_layers[:n_layers]) if kind == "local")
        if local:
            kw["sliding_window"] = int(hf.get("window_size", 256))
            if len(local) < n_layers:
                kw["window_layers"] = local
    elif model_type == "distilbert":
        # BERT's post-LN encoder without token types; MLM head vocab_transform -> gelu -> vocab_layer_norm
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("n_layers", 6), n_heads=hf.get("n_heads", 12),
                  d_model=hf.get("dim", 768), d_ff=hf.get("hidden_dim", 3072),
                  max_seq_len=hf.get("max_position_embeddings", 512), norm="layernorm",
                  activation=_map_gelu(hf.get("activation", "gelu")), pos_emb="learned", causal=False,
                  norm_scheme="post", embedding_norm=True, type_vocab_size=0, mlm_head=True, tie_embeddings=True,
                  norm_eps=1e-12)  # HF DistilBert's LayerNorms hard-code it
        if hf.get("sinusoidal_pos_embds"):
            raise NotImplementedError("distilbert sinusoidal_pos_embds unsupported (learned positions only)")
    elif model_type == "bloom":
        kw = dict(vocab_size=hf["vocab_size"], n_layers=hf.get("n_layer", 2), n_heads=hf.get("n_head", 8),
                  d_model=hf["hidden_size"], d_ff=4 * hf["hidden_size"], max_seq_len=hf.get("seq_length", 2048),
                  norm="layernorm", activation="gelu", pos_emb="alibi", embedding_norm=True, tie_embeddings=True,
                  norm_eps=hf.get("layer_norm_epsilon", 1e-5))
    else:
        raise NotImplementedError(f"HF model_type '{model_type}' not supported (supported: gpt2, llama, "
                                  "mistral, qwen2, qwen3, mixtral, internlm, opt, gpt_neox, gptj, gpt_neo, "
                                  "falcon, phi, phi3, bloom, gpt_bigcode, gemma, stablelm, olmo, bert, "
                                  "distilbert)")
    kw["dtype"] = dtype
    if kw.get("pos_emb") == "rope":
        kw.update(rope_kw)
    elif rope_kw:
        raise NotImplementedError(f"rope_scaling on a non-rope architecture {model_type!r}")
    kw.update(overrides)
    return TransformerConfig(**kw)


# ----------------------------------------------------------------------
# weight remapping (data movement only: transposes, splits, reshapes)
# ----------------------------------------------------------------------
def _strip_prefix(sd: StateDict, prefixes=("transformer.", "model.")) -> StateDict:
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def _ln(cfg: TransformerConfig, idx: int) -> str:
    return f"{'RMSNorm' if cfg.norm == 'rmsnorm' else 'LayerNorm'}_{idx}"


def _norm(sd: StateDict, prefix: str) -> Dict[str, torch.Tensor]:
    """A biased norm's ``{scale, bias}`` from ``prefix.weight`` / ``prefix.bias``."""
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _lin(sd: StateDict, prefix: str, bias: bool = True) -> Dict[str, torch.Tensor]:
    """A torch ``Linear`` (out, in) as a flax Dense ``{kernel (in, out), bias}``."""
    out = {"kernel": sd[prefix + ".weight"].t()}
    if bias:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _qkv(w: torch.Tensor, heads: int, D: int, dm: int) -> torch.Tensor:
    """Rows of a torch (heads * D, dm) projection as the (dm, heads, D) kernel."""
    return w.t().reshape(dm, heads, D)


def convert_gpt2(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``GPT2LMHeadModel``: Conv1D weights are (in, out), the flax layout;
    the fused ``c_attn`` (in, 3 d) splits into q/k/v."""
    sd = _strip_prefix(sd)
    H, D, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["wte.weight"], "wpe": sd["wpe.weight"][:cfg.max_seq_len],
                              ln(0): _norm(sd, "ln_f")}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        qw, kw, vw = torch.chunk(sd[p + "attn.c_attn.weight"], 3, dim=1)
        qb, kb, vb = torch.chunk(sd[p + "attn.c_attn.bias"], 3)
        params[f"layer_{i}"] = {
            ln(0): _norm(sd, p + "ln_1"),
            ln(1): _norm(sd, p + "ln_2"),
            "attn": {
                "q_proj": {"kernel": qw.reshape(dm, H, D), "bias": qb.reshape(H, D)},
                "k_proj": {"kernel": kw.reshape(dm, H, D), "bias": kb.reshape(H, D)},
                "v_proj": {"kernel": vw.reshape(dm, H, D), "bias": vb.reshape(H, D)},
                "o_proj": {"kernel": sd[p + "attn.c_proj.weight"].reshape(H, D, dm),
                           "bias": sd[p + "attn.c_proj.bias"]},
            },
            "mlp": {
                "up_proj": {"kernel": sd[p + "mlp.c_fc.weight"], "bias": sd[p + "mlp.c_fc.bias"]},
                "down_proj": {"kernel": sd[p + "mlp.c_proj.weight"], "bias": sd[p + "mlp.c_proj.bias"]},
            },
        }
    return params


def convert_llama(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``LlamaForCausalLM`` (and mistral, qwen2/3, mixtral, internlm,
    gemma, olmo, stablelm; phi3 after de-fusing). Mixtral's experts w1/w3/w2
    stack into wg/wi/wo."""
    has_lm_head = "lm_head.weight" in sd
    sd = _strip_prefix(sd)
    H, KVH, D, dm = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model

    def norm_params(prefix: str) -> Dict[str, torch.Tensor]:
        out = {"scale": sd[prefix + ".weight"]}
        if prefix + ".bias" in sd:  # stablelm's biased layernorms
            out["bias"] = sd[prefix + ".bias"]
        return out

    np_norm = cfg.norm == "layernorm_np"  # olmo: no affine norm params
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["embed_tokens.weight"]}
    if not np_norm:
        params[ln(0)] = norm_params("norm" if "norm.weight" in sd else "final_layernorm")
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": (sd["lm_head.weight"] if has_lm_head else sd["embed_tokens.weight"]).t()}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        a = p + "self_attn."
        layer: Dict[str, Any] = {} if np_norm else {ln(0): norm_params(p + "input_layernorm"),
                                                    ln(1): norm_params(p + "post_attention_layernorm")}
        layer["attn"] = {
            "q_proj": {"kernel": _qkv(sd[a + "q_proj.weight"], H, D, dm)},
            "k_proj": {"kernel": _qkv(sd[a + "k_proj.weight"], KVH, D, dm)},
            "v_proj": {"kernel": _qkv(sd[a + "v_proj.weight"], KVH, D, dm)},
            "o_proj": {"kernel": sd[a + "o_proj.weight"].t().reshape(H, D, dm)},
        }
        if p + "block_sparse_moe.gate.weight" in sd:  # mixtral: h = silu(x wg) * (x wi); out = h wo
            E = cfg.moe_num_experts
            e = p + "block_sparse_moe.experts."
            layer["moe"] = {
                "gate": {"kernel": sd[p + "block_sparse_moe.gate.weight"].t()},
                "experts": {
                    "wg": torch.stack([sd[e + f"{j}.w1.weight"].t() for j in range(E)]),
                    "wi": torch.stack([sd[e + f"{j}.w3.weight"].t() for j in range(E)]),
                    "wo": torch.stack([sd[e + f"{j}.w2.weight"].t() for j in range(E)]),
                },
            }
        else:
            layer["mlp"] = {"gate_proj": _lin(sd, p + "mlp.gate_proj", False),
                            "up_proj": _lin(sd, p + "mlp.up_proj", False),
                            "down_proj": _lin(sd, p + "mlp.down_proj", False)}
        if cfg.qk_norm:  # qwen3's per-head q/k norms
            layer["attn"]["q_norm"] = {"scale": sd[a + "q_norm.weight"]}
            layer["attn"]["k_norm"] = {"scale": sd[a + "k_norm.weight"]}
        for proj, heads in (("q_proj", H), ("k_proj", KVH), ("v_proj", KVH)):  # qwen2; internlm also biases o
            if a + f"{proj}.bias" in sd:
                layer["attn"][proj]["bias"] = sd[a + f"{proj}.bias"].reshape(heads, D)
        if a + "o_proj.bias" in sd:
            layer["attn"]["o_proj"]["bias"] = sd[a + "o_proj.bias"]
        params[f"layer_{i}"] = layer
    return params


def convert_opt(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``OPTForCausalLM``: learned positions drop OPT's 2-slot offset (its
    positions are mask-cumsum + 2, arange + 2 for dense masks)."""
    sd = _strip_prefix(sd, ("model.decoder.", "decoder.", "model."))
    H, D, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["embed_tokens.weight"],
                              "wpe": sd["embed_positions.weight"][2:2 + cfg.max_seq_len],
                              ln(0): _norm(sd, "final_layer_norm")}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": sd.get("lm_head.weight", sd["embed_tokens.weight"]).t()}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        attn = {name: {"kernel": _qkv(sd[p + f"self_attn.{name}.weight"], H, D, dm),
                       "bias": sd[p + f"self_attn.{name}.bias"].reshape(H, D)}
                for name in ("q_proj", "k_proj", "v_proj")}
        attn["o_proj"] = {"kernel": sd[p + "self_attn.out_proj.weight"].t().reshape(H, D, dm),
                          "bias": sd[p + "self_attn.out_proj.bias"]}
        params[f"layer_{i}"] = {ln(0): _norm(sd, p + "self_attn_layer_norm"), ln(1): _norm(sd, p + "final_layer_norm"),
                                "attn": attn, "mlp": {"up_proj": _lin(sd, p + "fc1"), "down_proj": _lin(sd, p + "fc2")}}
    return params


def _per_head_qkv(w: torch.Tensor, b: torch.Tensor, H: int, D: int, dm: int) -> Dict[str, Any]:
    """A fused query_key_value interleaved per head as (H, 3, D, dm) rows
    (gpt-neox, bloom) -> q/k/v kernels (dm, H, D) and biases (H, D)."""
    w = w.reshape(H, 3, D, dm)
    b = b.reshape(H, 3, D)
    return {name: {"kernel": w[:, j].permute(2, 0, 1), "bias": b[:, j]}
            for j, name in enumerate(("q_proj", "k_proj", "v_proj"))}


def convert_gpt_neox(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``GPTNeoXForCausalLM`` (pythia)."""
    sd = _strip_prefix(sd, ("gpt_neox.",))
    H, D, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["embed_in.weight"], ln(0): _norm(sd, "final_layer_norm")}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": sd["embed_out.weight"].t()}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        attn = _per_head_qkv(sd[p + "attention.query_key_value.weight"], sd[p + "attention.query_key_value.bias"],
                             H, D, dm)
        attn["o_proj"] = {"kernel": sd[p + "attention.dense.weight"].t().reshape(H, D, dm),
                          "bias": sd[p + "attention.dense.bias"]}
        params[f"layer_{i}"] = {ln(0): _norm(sd, p + "input_layernorm"),
                                ln(1): _norm(sd, p + "post_attention_layernorm"),
                                "attn": attn, "mlp": {"up_proj": _lin(sd, p + "mlp.dense_h_to_4h"),
                                                      "down_proj": _lin(sd, p + "mlp.dense_4h_to_h")}}
    return params


def convert_gptj(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``GPTJForCausalLM``: parallel-shared block, interleaved rotary,
    biased MLP and untied head, bias-free attention."""
    sd = _strip_prefix(sd, ("transformer.",))
    H, D, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["wte.weight"], ln(0): _norm(sd, "ln_f"), "lm_head": _lin(sd, "lm_head")}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        params[f"layer_{i}"] = {
            ln(0): _norm(sd, p + "ln_1"),
            "attn": {
                "q_proj": {"kernel": _qkv(sd[p + "attn.q_proj.weight"], H, D, dm)},
                "k_proj": {"kernel": _qkv(sd[p + "attn.k_proj.weight"], H, D, dm)},
                "v_proj": {"kernel": _qkv(sd[p + "attn.v_proj.weight"], H, D, dm)},
                "o_proj": {"kernel": sd[p + "attn.out_proj.weight"].t().reshape(H, D, dm)},
            },
            "mlp": {"up_proj": _lin(sd, p + "mlp.fc_in"), "down_proj": _lin(sd, p + "mlp.fc_out")},
        }
    return params


def convert_falcon(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``FalconForCausalLM``. 7b-style (parallel_shared): fused rows
    [q (H D), k (D), v (D)] and one input_layernorm. 40b-style
    (new_decoder_architecture, "parallel"): per-KV-head groups of rows
    [(G q) k v] x KVH and separate ln_attn / ln_mlp."""
    new_arch = cfg.block_type == "parallel"
    sd = _strip_prefix(sd, ("transformer.",))
    H, KVH, D, dm = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    G = H // KVH
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["word_embeddings.weight"], ln(0): _norm(sd, "ln_f")}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].t()}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        qkv = sd[p + "self_attention.query_key_value.weight"]
        o = {"kernel": sd[p + "self_attention.dense.weight"].t().reshape(H, D, dm)}
        if new_arch:
            w = qkv.reshape(KVH, G + 2, D, dm)
            attn = {"q_proj": {"kernel": w[:, :G].permute(3, 0, 1, 2).reshape(dm, H, D)},
                    "k_proj": {"kernel": w[:, G].permute(2, 0, 1)},
                    "v_proj": {"kernel": w[:, G + 1].permute(2, 0, 1)}, "o_proj": o}
            norms = {ln(0): _norm(sd, p + "ln_attn"), ln(1): _norm(sd, p + "ln_mlp")}
        else:
            qw, kw, vw = torch.tensor_split(qkv, [H * D, (H + KVH) * D], dim=0)
            attn = {"q_proj": {"kernel": _qkv(qw, H, D, dm)}, "k_proj": {"kernel": _qkv(kw, KVH, D, dm)},
                    "v_proj": {"kernel": _qkv(vw, KVH, D, dm)}, "o_proj": o}
            norms = {ln(0): _norm(sd, p + "input_layernorm")}
        layer = {**norms, "attn": attn, "mlp": {"up_proj": _lin(sd, p + "mlp.dense_h_to_4h", False),
                                                "down_proj": _lin(sd, p + "mlp.dense_4h_to_h", False)}}
        if cfg.use_dense_bias:
            qkv_b = sd[p + "self_attention.query_key_value.bias"]
            if new_arch:
                b = qkv_b.reshape(KVH, G + 2, D)
                qb, kb, vb = b[:, :G].reshape(H, D), b[:, G], b[:, G + 1]
            else:
                qb, kb, vb = torch.tensor_split(qkv_b, [H * D, (H + KVH) * D])
                qb, kb, vb = qb.reshape(H, D), kb.reshape(KVH, D), vb.reshape(KVH, D)
            layer["attn"]["q_proj"]["bias"] = qb
            layer["attn"]["k_proj"]["bias"] = kb
            layer["attn"]["v_proj"]["bias"] = vb
            layer["attn"]["o_proj"]["bias"] = sd[p + "self_attention.dense.bias"]
            layer["mlp"]["up_proj"]["bias"] = sd[p + "mlp.dense_h_to_4h.bias"]
            layer["mlp"]["down_proj"]["bias"] = sd[p + "mlp.dense_4h_to_h.bias"]
        params[f"layer_{i}"] = layer
    return params


def convert_phi(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``PhiForCausalLM`` (phi-1 / phi-2): parallel-shared block with one
    layernorm, partial rotary, biases everywhere including the head."""
    has_lm_head = "lm_head.weight" in sd
    sd = _strip_prefix(sd, ("model.",))
    H, KVH, D, dm = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["embed_tokens.weight"], ln(0): _norm(sd, "final_layernorm")}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": (sd["lm_head.weight"] if has_lm_head else sd["embed_tokens.weight"]).t()}
        if cfg.lm_head_bias:
            params["lm_head"]["bias"] = sd["lm_head.bias"]
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        a = p + "self_attn."
        params[f"layer_{i}"] = {
            ln(0): _norm(sd, p + "input_layernorm"),
            "attn": {
                "q_proj": {"kernel": _qkv(sd[a + "q_proj.weight"], H, D, dm),
                           "bias": sd[a + "q_proj.bias"].reshape(H, D)},
                "k_proj": {"kernel": _qkv(sd[a + "k_proj.weight"], KVH, D, dm),
                           "bias": sd[a + "k_proj.bias"].reshape(KVH, D)},
                "v_proj": {"kernel": _qkv(sd[a + "v_proj.weight"], KVH, D, dm),
                           "bias": sd[a + "v_proj.bias"].reshape(KVH, D)},
                "o_proj": {"kernel": sd[a + "dense.weight"].t().reshape(H, D, dm), "bias": sd[a + "dense.bias"]},
            },
            "mlp": {"up_proj": _lin(sd, p + "mlp.fc1"), "down_proj": _lin(sd, p + "mlp.fc2")},
        }
    return params


def convert_phi3(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``Phi3ForCausalLM``: llama-shaped but for the fused ``qkv_proj``
    ([q (H D), k, v] rows) and ``gate_up_proj`` ([gate, up] rows), de-fused
    here before ``convert_llama``."""
    H, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    out: StateDict = {}
    for k, v in sd.items():
        if k.endswith("self_attn.qkv_proj.weight"):
            base = k[:-len("qkv_proj.weight")]
            out[base + "q_proj.weight"], out[base + "k_proj.weight"], out[base + "v_proj.weight"] = \
                torch.tensor_split(v, [H * D, (H + KVH) * D], dim=0)
        elif k.endswith("mlp.gate_up_proj.weight"):
            base = k[:-len("gate_up_proj.weight")]
            out[base + "gate_proj.weight"], out[base + "up_proj.weight"] = torch.chunk(v, 2, dim=0)
        else:
            out[k] = v
    return convert_llama(out, cfg)


def convert_gpt_bigcode(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``GPTBigCodeForCausalLM`` (StarCoder): learned positions; MQA with
    contiguous [q (H D), k (KVH D), v (KVH D)] rows, or MHA with per-head
    interleaved [q_h k_h v_h] rows, torch Linear (out, in)."""
    sd = _strip_prefix(sd, ("transformer.",))
    H, KVH, D, dm = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["wte.weight"], "wpe": sd["wpe.weight"][:cfg.max_seq_len],
                              ln(0): _norm(sd, "ln_f")}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].t()}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        qkv_w, qkv_b = sd[p + "attn.c_attn.weight"], sd[p + "attn.c_attn.bias"]
        if KVH == H:
            w3, b3 = qkv_w.reshape(H, 3, D, dm), qkv_b.reshape(H, 3, D)
            qw, kw, vw = (w3[:, j].reshape(H * D, dm) for j in range(3))
            qb, kb, vb = (b3[:, j].reshape(H * D) for j in range(3))
        else:
            qw, kw, vw = torch.tensor_split(qkv_w, [H * D, (H + KVH) * D], dim=0)
            qb, kb, vb = torch.tensor_split(qkv_b, [H * D, (H + KVH) * D])
        params[f"layer_{i}"] = {
            ln(0): _norm(sd, p + "ln_1"),
            ln(1): _norm(sd, p + "ln_2"),
            "attn": {
                "q_proj": {"kernel": _qkv(qw, H, D, dm), "bias": qb.reshape(H, D)},
                "k_proj": {"kernel": _qkv(kw, KVH, D, dm), "bias": kb.reshape(KVH, D)},
                "v_proj": {"kernel": _qkv(vw, KVH, D, dm), "bias": vb.reshape(KVH, D)},
                "o_proj": {"kernel": sd[p + "attn.c_proj.weight"].t().reshape(H, D, dm),
                           "bias": sd[p + "attn.c_proj.bias"]},
            },
            "mlp": {"up_proj": _lin(sd, p + "mlp.c_fc"), "down_proj": _lin(sd, p + "mlp.c_proj")},
        }
    return params


def _encoder_attn(sd: StateDict, a: str, names: Sequence[str], H: int, D: int, dm: int) -> Dict[str, Any]:
    """An encoder layer's q/k/v/o from the torch Linears named ``names`` under ``a``."""
    out = {proj: {"kernel": _qkv(sd[a + f"{n}.weight"], H, D, dm), "bias": sd[a + f"{n}.bias"].reshape(H, D)}
           for proj, n in zip(("q_proj", "k_proj", "v_proj"), names[:3])}
    out["o_proj"] = {"kernel": sd[a + f"{names[3]}.weight"].t().reshape(H, D, dm), "bias": sd[a + f"{names[3]}.bias"]}
    return out


def convert_bert(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``BertForMaskedLM``: post-LN blocks (``attention.output.LayerNorm``,
    ``output.LayerNorm``), token-type embeddings, and the MLM head
    ``cls.predictions.transform`` whose decoder ties to the word embeddings."""
    sd = _strip_prefix(sd, prefixes=("bert.",))
    H, D, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {
        "wte": sd["embeddings.word_embeddings.weight"],
        "wpe": sd["embeddings.position_embeddings.weight"][:cfg.max_seq_len],
        "type_emb": sd["embeddings.token_type_embeddings.weight"],
        ln(0): _norm(sd, "embeddings.LayerNorm"),
        "mlm_dense": _lin(sd, "cls.predictions.transform.dense"),
        ln(1): _norm(sd, "cls.predictions.transform.LayerNorm"),
        "mlm_bias": sd["cls.predictions.bias"],
    }
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        params[f"layer_{i}"] = {
            ln(0): _norm(sd, p + "attention.output.LayerNorm"),
            ln(1): _norm(sd, p + "output.LayerNorm"),
            "attn": _encoder_attn(sd, p + "attention.", ("self.query", "self.key", "self.value", "output.dense"),
                                  H, D, dm),
            "mlp": {"up_proj": _lin(sd, p + "intermediate.dense"), "down_proj": _lin(sd, p + "output.dense")},
        }
    return params


def convert_gpt_neo(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``GPTNeoForCausalLM``: gpt2's layout with torch Linear (out, in)
    projections and bias-free q/k/v."""
    sd = _strip_prefix(sd)
    H, D, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["wte.weight"], "wpe": sd["wpe.weight"][:cfg.max_seq_len],
                              ln(0): _norm(sd, "ln_f")}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].t()}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        a = p + "attn.attention."
        params[f"layer_{i}"] = {
            ln(0): _norm(sd, p + "ln_1"),
            ln(1): _norm(sd, p + "ln_2"),
            "attn": {
                "q_proj": {"kernel": _qkv(sd[a + "q_proj.weight"], H, D, dm)},
                "k_proj": {"kernel": _qkv(sd[a + "k_proj.weight"], H, D, dm)},
                "v_proj": {"kernel": _qkv(sd[a + "v_proj.weight"], H, D, dm)},
                "o_proj": {"kernel": sd[a + "out_proj.weight"].t().reshape(H, D, dm), "bias": sd[a + "out_proj.bias"]},
            },
            "mlp": {"up_proj": _lin(sd, p + "mlp.c_fc"), "down_proj": _lin(sd, p + "mlp.c_proj")},
        }
    return params


def convert_distilbert(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``DistilBertForMaskedLM``: BERT without token types; the MLM head
    ``vocab_transform`` / ``vocab_layer_norm`` with the projector tied to the
    word embeddings."""
    sd = _strip_prefix(sd, prefixes=("distilbert.",))
    H, D, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {
        "wte": sd["embeddings.word_embeddings.weight"],
        "wpe": sd["embeddings.position_embeddings.weight"][:cfg.max_seq_len],
        ln(0): _norm(sd, "embeddings.LayerNorm"),
        "mlm_dense": _lin(sd, "vocab_transform"),
        ln(1): _norm(sd, "vocab_layer_norm"),
        "mlm_bias": sd["vocab_projector.bias"],
    }
    for i in range(cfg.n_layers):
        p = f"transformer.layer.{i}."
        params[f"layer_{i}"] = {
            ln(0): _norm(sd, p + "sa_layer_norm"),
            ln(1): _norm(sd, p + "output_layer_norm"),
            "attn": _encoder_attn(sd, p + "attention.", ("q_lin", "k_lin", "v_lin", "out_lin"), H, D, dm),
            "mlp": {"up_proj": _lin(sd, p + "ffn.lin1"), "down_proj": _lin(sd, p + "ffn.lin2")},
        }
    return params


def convert_bloom(sd: StateDict, cfg: TransformerConfig) -> Dict:
    """HF ``BloomForCausalLM``: ALiBi, the embedding layernorm, a fused qkv
    interleaved per head (H, 3, D)."""
    sd = _strip_prefix(sd, ("transformer.",))
    H, D, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
    ln = lambda i: _ln(cfg, i)  # noqa: E731
    params: Dict[str, Any] = {"wte": sd["word_embeddings.weight"], ln(0): _norm(sd, "word_embeddings_layernorm"),
                              ln(1): _norm(sd, "ln_f")}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        attn = _per_head_qkv(sd[p + "self_attention.query_key_value.weight"],
                             sd[p + "self_attention.query_key_value.bias"], H, D, dm)
        attn["o_proj"] = {"kernel": sd[p + "self_attention.dense.weight"].t().reshape(H, D, dm),
                          "bias": sd[p + "self_attention.dense.bias"]}
        params[f"layer_{i}"] = {ln(0): _norm(sd, p + "input_layernorm"),
                                ln(1): _norm(sd, p + "post_attention_layernorm"),
                                "attn": attn, "mlp": {"up_proj": _lin(sd, p + "mlp.dense_h_to_4h"),
                                                      "down_proj": _lin(sd, p + "mlp.dense_4h_to_h")}}
    return params


_CONVERTERS = {
    "gpt2": convert_gpt2,
    "opt": convert_opt,
    "gpt_neox": convert_gpt_neox,
    "gptj": convert_gptj,
    "falcon": convert_falcon,
    "phi": convert_phi,
    "bloom": convert_bloom,
    "gpt_bigcode": convert_gpt_bigcode,
    "phi3": convert_phi3,
    "bert": convert_bert,
    "gpt_neo": convert_gpt_neo,
    "distilbert": convert_distilbert,
}


def convert_hf_state_dict(sd: StateDict, cfg: TransformerConfig, model_type: str) -> Dict:
    """The port's parameter tree of a Hugging Face state dict (llama, mistral,
    qwen2/3, mixtral, internlm, gemma, olmo and stablelm share the llama
    layout). The leaves are views or copies of ``sd``'s, in their dtype."""
    return _CONVERTERS.get(model_type, convert_llama)(sd, cfg)


# ----------------------------------------------------------------------
# top-level loaders
# ----------------------------------------------------------------------
def load_hf_checkpoint(model_dir: str, dtype: Optional[torch.dtype] = None, device="cuda", tp_size: int = 1,
                       rank: Optional[int] = None, **config_overrides) -> Tuple[CausalLM, Dict]:
    """A Hugging Face checkpoint directory as ``(CausalLM, params)``: the
    config from ``config.json`` (checked before the weights are read), the
    leaves cast to ``dtype`` (default fp32) on ``device``; with ``tp_size > 1``
    rank ``rank``'s slice of each leaf (default: this process's rank)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, dtype=dtype, **config_overrides)
    t0 = time.perf_counter()
    sd = load_hf_state_dict(model_dir)
    read_s = time.perf_counter() - t0
    out = _materialize_hf(hf_cfg, sd, cfg, device, tp_size, rank, origin=model_dir)
    last_load.update(read_s=read_s, read_bytes=float(sum(t.numel() * t.element_size() for t in sd.values())))
    return out


def load_hf_model(hf_model, dtype: Optional[torch.dtype] = None, device="cuda", tp_size: int = 1,
                  rank: Optional[int] = None, **config_overrides) -> Tuple[CausalLM, Dict]:
    """A live Hugging Face torch model as ``(CausalLM, params)``, read through
    ``hf_model.config.to_dict()`` and ``hf_model.state_dict()`` alone (the
    reference's ``init_inference(model=hf_model)``), without a save."""
    hf_cfg = hf_model.config.to_dict()
    cfg = config_from_hf(hf_cfg, dtype=dtype, **config_overrides)
    sd = {k: v.detach() for k, v in hf_model.state_dict().items()}
    return _materialize_hf(hf_cfg, sd, cfg, device, tp_size, rank, origin=type(hf_model).__name__)


def _materialize_hf(hf_cfg: Dict, sd: StateDict, cfg: TransformerConfig, device, tp_size: int, rank: Optional[int],
                    origin: str) -> Tuple[CausalLM, Dict]:
    """Convert, keep this rank's slices, cast and place. At ``tp_size`` 1 on a
    CUDA device the tensors cross to the device before the conversion's
    copies (which only move data, so the leaves are the same bits)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    model = CausalLM(cfg)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    if tp_size <= 1 and dev.type == "cuda":
        sd = {k: v.to(dev, cfg.dtype if v.is_floating_point() else v.dtype) for k, v in sd.items()}
    sync()
    t1 = time.perf_counter()
    params = convert_hf_state_dict(sd, cfg, hf_cfg.get("model_type", ""))
    if tp_size > 1:
        if rank is None:
            rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        params = shard_params(params, model, tp_size=tp_size, rank=rank)

    # on the CPU a leaf that needs no cast or transpose would stay a view of the file's mapping (or of a live
    # model's tensor), which a later rewrite of the file would change under it: those get copies of their own
    sources = {v.untyped_storage().data_ptr() for v in sd.values()} if dev.type == "cpu" else set()

    def place(t):
        t = t.to(dev, cfg.dtype if t.is_floating_point() else t.dtype).contiguous()
        return t.clone() if t.untyped_storage().data_ptr() in sources else t

    params = _tree_map(place, params)
    sync()
    last_load.clear()
    last_load.update(to_device_s=t1 - t0, convert_s=time.perf_counter() - t1)
    n = sum(t.numel() for t in _leaves(params))
    logger.info("load_hf_checkpoint: %s, %.1fM parameters (this rank's) from %s", hf_cfg.get("model_type"), n / 1e6,
                origin)
    return model, params


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------------------------
# tensor-parallel layouts
# ----------------------------------------------------------------------
def model_tp_rules(model=None) -> list:
    """The model's partition rules (``CausalLM.partition_rules``); a
    ``TransformerConfig`` or an object with ``.cfg`` gets ``CausalLM``'s."""
    if hasattr(model, "partition_rules"):
        return list(model.partition_rules())
    cfg = model if isinstance(model, TransformerConfig) else getattr(model, "cfg", None)
    if cfg is None:
        raise ValueError("tensor-parallel serving needs a CausalLM, a TransformerConfig or a model with .cfg")
    return CausalLM(cfg).partition_rules()


def _rules(params, model, tp_size: int) -> list:
    """The model's rules, or AutoTP's over ``params`` without a model (JAX ``get_tp_rules``)."""
    from .auto_tp import AutoTP

    return model_tp_rules(model) if model is not None else AutoTP(tp_size).tp_parser(params)


def _is_tp(axis) -> bool:
    return axis == TP_AXIS or (isinstance(axis, tuple) and TP_AXIS in axis)


def leaf_spec(keys: Tuple[str, ...], shape: Sequence[int], rules: Sequence, tp: int) -> tuple:
    """A leaf's spec (one mesh axis or None a dimension, trailing Nones
    dropped) at ``tensor`` = ``tp``: its rule's, or ``()`` (whole) at tp 1,
    without a rule, or for a vocab-parallel leaf that ``tp`` does not divide.
    Any other dimension on ``tensor`` that ``tp`` does not divide raises."""
    if tp <= 1:
        return ()
    s = list(match_partition_rule(keys, rules) or ())
    while s and s[-1] is None:
        s.pop()
    for dim, axis in enumerate(s):
        if _is_tp(axis) and shape[dim] % tp:
            if keys and keys[0] in VOCAB_LEAVES:
                return ()
            raise ValueError(f"{'/'.join(keys)}: dimension {dim} of {tuple(shape)} does not split over "
                             f"tensor_parallel={tp}")
    return tuple(s)


def tp_shardings(params: Dict[str, Any], model=None, tp_size: int = 1,
                 rules: Optional[Sequence] = None) -> Dict[str, Any]:
    """The spec of every leaf (``leaf_spec``) under the TP rules: the JAX
    ``tp_shardings``' ``PartitionSpec``s, as tuples."""
    rules = _rules(params, model, tp_size) if rules is None else rules

    def build(tree, keys=()):
        if isinstance(tree, dict):
            return {k: build(v, keys + (str(k),)) for k, v in tree.items()}
        return leaf_spec(keys, tuple(getattr(tree, "shape", ())), rules, tp_size)

    return build(params)


def shard_leaf(leaf: torch.Tensor, spec: Iterable, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``leaf`` along each dimension ``spec`` puts on
    ``tensor`` (``leaf_spec``): a fresh contiguous tensor, so that the whole
    leaf can be freed; the leaf itself when nothing is on ``tensor``."""
    out = leaf
    for dim, axis in enumerate(spec):
        if _is_tp(axis):
            n = leaf.shape[dim] // tp
            out = out.narrow(dim, rank * n, n)
    if out is leaf:
        return leaf
    return out.clone(memory_format=torch.contiguous_format)


def shard_params(params: Dict[str, Any], model=None, tp_size: int = 1, rank: int = 0,
                 rules: Optional[Sequence] = None) -> Dict[str, Any]:
    """This rank's slice of every leaf under the TP rules (the JAX
    ``shard_params``' shard at ``tensor`` index ``rank``); at ``tp_size`` 1
    the tree as it is."""
    if tp_size <= 1:
        return params
    rules = _rules(params, model, tp_size) if rules is None else rules
    specs = tp_shardings(params, rules=rules, tp_size=tp_size)

    def build(tree, spec_tree):
        if isinstance(tree, dict):
            return {k: build(v, spec_tree[k]) for k, v in tree.items()}
        return shard_leaf(tree, spec_tree, tp_size, rank) if isinstance(tree, torch.Tensor) else tree

    return build(params, specs)


def shard_to_rank(params: Dict[str, Any], cfg: TransformerConfig, rules: Sequence, tp: int,
                  rank: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """This rank's slice of every leaf and the specs of the tree, for a tree
    whose leaves are whole or already this rank's slices (a loader's
    ``tp_size``): a leaf at its shard's shape is kept, a whole one is cut,
    and any other shape raises. ``rules`` are the serving rules (the model's
    and ``SERVING_BIAS_RULES``); the whole shapes are ``cfg``'s."""
    from ..inference.quantization import QuantizedParam

    def walk(node, ref, keys):
        if isinstance(node, dict):
            out = {k: walk(v, ref.get(k) if isinstance(ref, dict) else None, keys + (str(k),))
                   for k, v in node.items()}
            return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}
        if isinstance(node, QuantizedParam):
            raise NotImplementedError(f"{'/'.join(keys)}: a quantised tree does not shard; give the engine "
                                      "dense weights and quant_bits (it quantises after sharding)")
        t = torch.as_tensor(node)
        full = tuple(ref[0]) if isinstance(ref, tuple) else tuple(t.shape)
        spec = leaf_spec(keys, full, rules, tp)
        local = tuple(n // tp if i < len(spec) and spec[i] == TP_AXIS else n for i, n in enumerate(full))
        if tuple(t.shape) == full:
            return shard_leaf(t, spec, tp, rank), spec
        if tuple(t.shape) == local:
            return t, spec
        raise ValueError(f"{'/'.join(keys)}: shape {tuple(t.shape)} is neither the whole {full} nor rank "
                         f"{rank}'s shard {local} at tensor_parallel={tp}")

    return walk(params, param_shapes(cfg), ())
