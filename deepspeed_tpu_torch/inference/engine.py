"""The v1 inference engine.

Port of ``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``,
``_DequantizingModule``, ``init_inference``) at tensor-parallel size 1:
``generate`` is a prefill and a per-token decode step over a preallocated
dense KV cache (``inference/generation.py``), and ``forward`` returns the
logits of a whole sequence.

With ``quant.enabled`` every >= 2-D weight is quantised after the cast to
the config dtype, in the flat group-wise layout (``quantize_model_params``,
through the ``quantize_groupwise`` kernel on CUDA), and the model is wrapped
in ``_DequantizingModule``: each forward call dequantises the whole tree
(one ``dequantize_groupwise`` launch per quantised leaf) into dense weights
of the config dtype, runs, and lets them go. So the device holds the codes
and scales at rest, and the dense weights only for the length of one
forward. The reference's XLA fuses the dequantisation into each consumer
instead; the port materialises the dense tree.

A model given as a checkpoint path or a Hugging Face module
(``module_inject``) and a tensor-parallel size above 1 raise
``NotImplementedError``.
"""

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
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


def _is_hf(model) -> bool:
    return isinstance(model, str) or (hasattr(model, "state_dict")
                                      and hasattr(getattr(model, "config", None), "to_dict"))


class InferenceEngine:

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None, params=None, mesh=None, **kwargs):
        """``model`` is a ``CausalLM``; ``params`` its nested parameter dict
        (tensors or numpy arrays). Floating parameters are cast to the config
        dtype and placed on the config device, then quantised there when
        ``quant.enabled``."""
        self._config = config if isinstance(config, DeepSpeedInferenceConfig) else \
            DeepSpeedInferenceConfig.from_dict(config or {})
        if _is_hf(model):
            raise NotImplementedError("a checkpoint path or a Hugging Face model needs module_inject, which is not "
                                      "ported: pass a CausalLM and params=")
        tp = self._config.tensor_parallel.tp_size
        if tp > 1 or mesh is not None:
            raise NotImplementedError(f"tensor parallelism (tp_size={tp}, mesh) is not ported: the v1 engine runs "
                                      "on one device")
        self.device = resolve_device(self._config.device)
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
    def forward(self, input_ids, **kwargs) -> torch.Tensor:
        """fp32 logits (B, S, V) of a whole sequence (no cache)."""
        ids = torch.as_tensor(input_ids).to(self.device, torch.int64)
        return self.module.apply(self.params, ids, train=False)

    __call__ = forward

    @property
    def config(self) -> DeepSpeedInferenceConfig:
        return self._config

    def eval(self):
        return self

    def to(self, *args, **kwargs):  # torch-API parity no-op
        return self


def init_inference(model=None, config=None, **kwargs) -> InferenceEngine:
    """The reference's ``deepspeed.init_inference``: ``config`` is a dict or a
    ``DeepSpeedInferenceConfig`` (without one, the keyword arguments are the
    config). A checkpoint path or a Hugging Face model raises
    ``NotImplementedError`` (``module_inject`` is not ported)."""
    if config is None:
        config = kwargs
        kwargs = {}
    return InferenceEngine(model, config=config, **kwargs)
