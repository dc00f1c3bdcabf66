"""The v1 inference config.

Port of ``deepspeed_tpu/inference/config.py`` (``DeepSpeedInferenceConfig``,
``DeepSpeedTPConfig``, ``QuantizationConfig``) with the same fields,
defaults, aliases (``tp``, ``max_tokens``, ``min_tokens``, ``kernel_inject``)
and bounds, built from a dict by ``from_dict`` as the reference's config
models are (a nested section may be given as a dict, or as a bool for
``{"enabled": ...}``; unknown keys are logged). ``torch_dtype()`` replaces
``jax_dtype()``. One field is the port's own: ``device``, "cuda" (the
default, which raises without a GPU) or "cpu" (the kernels' plain versions).
"""

import logging
from dataclasses import MISSING, dataclass, field, fields
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)


def _field(default=MISSING, *, default_factory=MISSING, aliases=(), ge=None):
    meta = {"aliases": tuple(aliases), "ge": ge}
    if default_factory is not MISSING:
        return field(default_factory=default_factory, metadata=meta)
    return field(default=default, metadata=meta)


class _ConfigModel:
    """``from_dict`` over a dataclass: aliases, nested sections, bounds."""

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]] = None):
        data = dict(data or {})
        kwargs = {}
        for f in fields(cls):
            for name in (f.name, *f.metadata.get("aliases", ())):
                if name in data:
                    value = data.pop(name)
                    sub = f.default_factory if f.default_factory is not MISSING else None
                    if isinstance(sub, type) and issubclass(sub, _ConfigModel):
                        if isinstance(value, bool):
                            value = {"enabled": value}
                        if isinstance(value, dict):
                            value = sub.from_dict(value)
                    kwargs[f.name] = value
                    break
        if data:
            logger.warning("Unknown config keys for %s: %s", cls.__name__, sorted(data))
        inst = cls(**kwargs)
        for f in fields(cls):
            ge, v = f.metadata.get("ge"), getattr(inst, f.name)
            if ge is not None and isinstance(v, (int, float)) and not isinstance(v, bool) and v < ge:
                raise ValueError(f"{cls.__name__}.{f.name}={v} must be >= {ge}")
        return inst


@dataclass
class DeepSpeedTPConfig(_ConfigModel):
    enabled: bool = True
    tp_size: int = _field(1, ge=1)
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None


@dataclass
class QuantizationConfig(_ConfigModel):
    enabled: bool = False
    bits: int = 8
    group_size: int = 64


_DTYPES = {"float32": torch.float32, "fp32": torch.float32, "float16": torch.float16, "fp16": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


@dataclass
class DeepSpeedInferenceConfig(_ConfigModel):
    dtype: str = "bfloat16"  # float32 | float16 | bfloat16
    tensor_parallel: DeepSpeedTPConfig = _field(default_factory=DeepSpeedTPConfig, aliases=["tp"])
    max_out_tokens: int = _field(1024, ge=1, aliases=["max_tokens"])
    min_out_tokens: int = _field(1, ge=1, aliases=["min_tokens"])
    max_batch_size: int = _field(1, ge=1)
    replace_with_kernel_inject: bool = _field(False, aliases=["kernel_inject"])
    quant: QuantizationConfig = _field(default_factory=QuantizationConfig)
    enable_cuda_graph: bool = False  # accepted for parity; the steps run eagerly
    checkpoint: Optional[str] = None
    replace_method: str = "auto"
    injection_policy: Optional[Dict] = None
    device: str = "cuda"  # the port's: "cuda" (raises without a GPU) or "cpu"

    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]
