"""``DS_TPU_*`` environment knobs read by the port.

A copy of the part of the reference registry (``deepspeed_tpu/analysis/
knobs.py``) that the serving slice reads: same names, defaults and types,
so a tuned environment means the same thing to either package. Stdlib only.
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Knob:
    """One declared environment knob."""

    name: str
    default: Optional[str]
    kind: str  # "str" | "int" | "float" | "bool"
    doc: str
    owner: str  # module that consumes it


_REGISTRY: Dict[str, Knob] = {}


def declare(name: str, default: Optional[str], kind: str, doc: str, owner: str) -> Knob:
    knob = Knob(name=name, default=default, kind=kind, doc=doc, owner=owner)
    _REGISTRY[name] = knob
    return knob


def all_knobs() -> Dict[str, Knob]:
    return dict(_REGISTRY)


def _lookup(name: str) -> Knob:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"environment knob {name!r} is not declared in "
                       "deepspeed_tpu_torch.analysis.knobs") from None


def get_int(name: str, default: Optional[int] = None) -> int:
    knob = _lookup(name)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        if default is not None:
            return default
        return int(knob.default or 0)
    return int(raw)


_TRUTHY = ("1", "true", "yes", "on")


def get_bool(name: str, default: Optional[bool] = None) -> bool:
    knob = _lookup(name)
    raw = os.environ.get(name)
    if raw is None:
        if default is not None:
            return default
        raw = knob.default or "0"
    return raw.strip().lower() in _TRUTHY


# Serving engine (inference/v2/engine_v2.py)
declare("DS_TPU_SERVE_FUSED", "1", "bool",
        "Serve with the single-dispatch fused SplitFuse step (the unfused loop is not ported; "
        "0 raises).",
        "inference/v2/engine_v2.py")
declare("DS_TPU_DECODE_BURST", "32", "int",
        "Max fused greedy-decode steps per quantum (0 disables bursting).",
        "inference/v2/engine_v2.py")
declare("DS_TPU_MIN_DECODE_BUCKET", "8", "int",
        "Floor for the padded decode batch bucket (1 restores exact power-of-two bucketing).",
        "inference/v2/engine_v2.py")
declare("DS_TPU_PREFILL_CHUNK", "512", "int",
        "SplitFuse prefill chunk size: long prompts enter the ragged batch in chunks of this "
        "many tokens.",
        "inference/v2/scheduler.py")
declare("DS_TPU_MAX_BATCH_TOKENS", "0", "int",
        "Scheduler quantum token budget override (0 keeps the state-manager config value, "
        "default 768).",
        "inference/v2/engine_v2.py")
declare("DS_TPU_PROGRAM_CACHE", "8", "int",
        "Max live fused-step variants before LRU eviction.",
        "inference/v2/engine_v2.py")
# Paged-KV state manager (inference/v2/ragged/manager.py)
declare("DS_TPU_PREFIX_CACHE", "1", "bool",
        "Enable the radix prefix cache: retiring prompts donate KV blocks for reuse.",
        "inference/v2/ragged/manager.py")
