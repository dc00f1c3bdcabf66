"""The v1 inference engine.

Port of ``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``,
``_DequantizingModule``, ``init_inference``): ``generate`` is a prefill and
a per-token decode step over a preallocated dense KV cache
(``inference/generation.py``), and ``forward`` returns the logits of a
whole sequence.

With ``quant.enabled`` every >= 2-D weight is quantised after the cast to
the config dtype, in the flat group-wise layout (``quantize_model_params``,
through the ``quantize_groupwise`` kernel on CUDA), and the model is wrapped
in ``_DequantizingModule``: each forward call dequantises the whole tree
(one ``dequantize_groupwise`` launch per quantised leaf) into dense weights
of the config dtype, runs, and lets them go. So the device holds the codes
and scales at rest, and the dense weights only for the length of one
forward. The reference's XLA fuses the dequantisation into each consumer
instead; the port materialises the dense tree.

Tensor parallelism (``tensor_parallel.tp_size`` above 1; JAX
``engine.py:47-68``): one process a rank over the ``tensor`` axis of the
port's mesh (``parallel.mesh.serving_mesh``, so a world of tp ranks), each
holding its shard of the tree (``module_inject.shard_params``, the
column-parallel biases too) and running the model forward on it
(``_TPModule``: the row-parallel reduces, the vocab-parallel embedding and
head, caches of KVH / tp heads). Every rank computes the same full logits,
so greedy tokens agree across ranks. With ``quant.enabled`` every rank
quantises the whole tree in the flat layout, whose groups run along the
flattened weight and so do not depend on the sharding: the codes are one
device's, as ``test_v1_weight_only_quant_tp2`` asks. Each forward then
dequantises them and keeps this rank's slice of the dense weights, so a
rank holds the whole codes (not a shard) at rest.

``init_inference`` also takes a Hugging Face checkpoint directory or a
live Hugging Face torch model (JAX ``engine.py:127-152``): the config's
dtype string (``bf16`` by default; ``fp16``, or anything else for fp32, as
JAX maps them) is the loaded tree's, read by ``module_inject``'s
``load_hf_checkpoint`` / ``load_hf_model`` onto the config's device. At
``tp_size`` above 1 each rank loads the whole checkpoint and keeps its
slice of each leaf (the whole tree when ``quant.enabled``, whose flat
codes are one device's). fp16 loads, and then raises at the kernels.
"""

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..module_inject.load_checkpoint import SERVING_BIAS_RULES, model_tp_rules, shard_params, shard_to_rank
from .config import DeepSpeedInferenceConfig
from .generation import build_step_fns, generate_tokens
from .quantization import dequantize_tree, quantize_model_params

logger = logging.getLogger(__name__)


class _DequantizingModule:
    """Proxy whose ``apply`` dequantises a weight-only-quantised parameter
    tree first, so the model only ever sees dense weights while the device
    holds int8 codes and scales at rest."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, name)

    def apply(self, params, *args, **kwargs):
        return self._module.apply(dequantize_tree(params), *args, **kwargs)


class _TPModule:
    """Proxy whose ``apply`` runs the model forward on a tensor-parallel
    rank's shard (``transformer_forward(..., tp=ctx)``) and whose
    ``init_kv_caches`` makes this rank's KVH / tp heads. With ``shard_on_apply``
    (the quantised engine: the dequantised tree is whole) each call first
    keeps this rank's slice."""

    def __init__(self, module, ctx, rules=None):
        self._module = module
        self._ctx = ctx
        self._rules = rules

    def __getattr__(self, name):
        return getattr(self._module, name)

    def apply(self, params, *args, **kwargs):
        from ..models.transformer import transformer_forward

        if self._rules is not None:
            params = shard_params(params, tp_size=self._ctx.tp, rank=self._ctx.rank, rules=self._rules)
        return transformer_forward(self._module.cfg, params, *args, tp=self._ctx, **kwargs)

    def init_kv_caches(self, batch_size: int, max_len: int, dtype=None, device="cuda"):
        cfg = self._module.cfg
        shape = (batch_size, max_len, cfg.kv_heads // self._ctx.tp, cfg.head_dim)
        zeros = lambda: torch.zeros(shape, dtype=dtype or cfg.dtype, device=resolve_device(device))  # noqa: E731
        return [(zeros(), zeros(), 0) for _ in range(cfg.n_layers)]


def _is_hf(model) -> bool:
    return isinstance(model, str) or (hasattr(model, "state_dict")
                                      and hasattr(getattr(model, "config", None), "to_dict"))


class InferenceEngine:

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None, params=None, mesh=None, **kwargs):
        """``model`` is a ``CausalLM``; ``params`` its nested parameter dict
        (tensors or numpy arrays; at ``tp_size`` > 1 each leaf whole or
        already this rank's slice). Floating parameters are cast to the
        config dtype and placed on the config device, then quantised there
        when ``quant.enabled``. ``init_inference`` turns a checkpoint path or
        a Hugging Face model into the two."""
        self._config = config if isinstance(config, DeepSpeedInferenceConfig) else \
            DeepSpeedInferenceConfig.from_dict(config or {})
        tp = self._config.tensor_parallel.tp_size
        if mesh is not None:
            raise NotImplementedError("a mesh argument is not ported: the v1 engine builds its serving mesh from "
                                      "tensor_parallel.tp_size over the process world")
        self.device = resolve_device(self._config.device)
        self._tp_ctx = None
        if tp > 1:
            from ..parallel.mesh import mesh_signature, serving_mesh
            from .v2.model_runner import TPContext

            topo = serving_mesh(tp)  # a world that tp does not divide raises here
            cfg = model.cfg
            if cfg.kv_heads % tp or cfg.n_heads % tp:
                raise ValueError(f"n_heads {cfg.n_heads} and kv_heads {cfg.kv_heads} must be divisible by tp={tp}")
            self._tp_ctx = TPContext(tp=tp, rank=topo.axis_rank("tensor"), group=topo.process_group("tensor"),
                                     mesh=mesh_signature(topo))
        self.module = model
        self.dtype = self._config.torch_dtype()
        if params is None:
            if hasattr(model, "params"):
                params = model.params
            else:
                raise ValueError("init_inference needs params= (the parameter tree)")

        def place(x):
            t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
            return t.to(self.device, self.dtype if t.is_floating_point() else t.dtype)

        def walk(node):
            return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else place(node)

        self.params = walk(params)
        rules = model_tp_rules(model) + SERVING_BIAS_RULES if tp > 1 else None
        if tp > 1 and not self._config.quant.enabled:
            self.params = shard_to_rank(self.params, model.cfg, rules, tp, self._tp_ctx.rank)[0]
        if tp > 1:  # the quantised tree stays whole (its flat codes are one device's): slice after each dequantise
            self.module = _TPModule(self.module, self._tp_ctx, rules if self._config.quant.enabled else None)
        self.quant_stats: Optional[Dict[str, int]] = None
        if self._config.quant.enabled:
            qc = self._config.quant
            self.params, self.quant_stats = quantize_model_params(self.params, {"weight_quantization": {
                "post_init_quant": {"*": {"num_bits": qc.bits, "group_size": qc.group_size}}}})
            self.module = _DequantizingModule(self.module)

        self._prefill_fn = None
        self._decode_fn = None
        self._max_len = self._config.max_out_tokens
        logger.info("InferenceEngine: tp=%d dtype=%s max_out_tokens=%d device=%s", tp, self._config.dtype,
                    self._max_len, self.device)

    # ------------------------------------------------------------------
    def generate(self, input_ids, max_new_tokens: int = 32, do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, eos_token_id: Optional[int] = None, seed: int = 0,
                 fused: bool = True, **kwargs) -> torch.Tensor:
        """Greedy or sampled decode; returns (B, S + new) int64 token ids on the
        engine device. ``fused=False`` stops early once every row emitted
        ``eos_token_id``."""
        if self._prefill_fn is None:
            self._prefill_fn, self._decode_fn = build_step_fns(self.module)
        S = np.shape(input_ids)[-1]
        if S + max_new_tokens > self._max_len:
            raise ValueError(f"prompt {S} + max_new_tokens {max_new_tokens} exceeds max_out_tokens {self._max_len}")
        return generate_tokens(self.module, self.params, self._prefill_fn, self._decode_fn, input_ids,
                               max_new_tokens=max_new_tokens, cache_len=self._max_len, cache_dtype=self.dtype,
                               do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p,
                               eos_token_id=eos_token_id, seed=seed, fused=fused, device=self.device)

    @torch.no_grad()
    def forward(self, input_ids, token_type_ids=None, **kwargs) -> torch.Tensor:
        """fp32 logits (B, S, V) of a whole sequence (no cache); an encoder
        takes its ``token_type_ids`` (zeros by default)."""
        ids = torch.as_tensor(input_ids).to(self.device, torch.int64)
        extra = {} if token_type_ids is None else {"token_type_ids": torch.as_tensor(token_type_ids).to(self.device)}
        return self.module.apply(self.params, ids, train=False, **extra)

    __call__ = forward

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config

    def eval(self):
        return self

    def to(self, *args, **kwargs):  # torch-API parity no-op
        return self


_HF_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "torch.bfloat16": torch.bfloat16,
              "fp16": torch.float16, "half": torch.float16, "float16": torch.float16}


def init_inference(model=None, config=None, **kwargs) -> InferenceEngine:
    """The reference's ``deepspeed.init_inference``: ``config`` is a dict or a
    ``DeepSpeedInferenceConfig`` (without one, the keyword arguments are the
    config). ``model`` is a ``CausalLM`` with ``params=``, a Hugging Face
    checkpoint directory or a live Hugging Face torch model; the last two
    load through ``module_inject`` in the config's dtype (``bf16`` unless
    given; ``fp16``; anything else fp32) on the config's device."""
    if config is None:
        config = kwargs
        kwargs = {}
    if _is_hf(model):
        from ..module_inject.load_checkpoint import load_hf_checkpoint, load_hf_model

        cfg = config if isinstance(config, DeepSpeedInferenceConfig) else \
            DeepSpeedInferenceConfig.from_dict(config or {})
        dtype_str = (config.get("dtype") if isinstance(config, dict) else getattr(config, "dtype", None)) or "bf16"
        dtype = _HF_DTYPES.get(str(dtype_str), torch.float32)
        tp = cfg.tensor_parallel.tp_size
        loader = load_hf_checkpoint if isinstance(model, str) else load_hf_model
        model, params = loader(model, dtype=dtype, device=cfg.device, tp_size=1 if cfg.quant.enabled else tp,
                               rank=_tp_rank(tp) if tp > 1 else 0)
        kwargs.setdefault("params", params)
        config = cfg
    return InferenceEngine(model, config=config, **kwargs)


def _tp_rank(tp: int) -> int:
    """This process's rank on the ``tensor`` axis of a serving mesh of ``tp``."""
    from ..parallel.mesh import serving_mesh

    return serving_mesh(tp).axis_rank("tensor")
