"""``DS_TPU_*`` environment knobs read by the port.

A copy of the part of the reference registry (``deepspeed_tpu/analysis/
knobs.py``) that the port reads: same names, defaults and types,
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


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    knob = _lookup(name)
    raw = os.environ.get(name)
    if raw is not None:
        return raw
    return default if default is not None else knob.default


def get_int(name: str, default: Optional[int] = None) -> int:
    knob = _lookup(name)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        if default is not None:
            return default
        return int(knob.default or 0)
    return int(raw)


def get_float(name: str, default: Optional[float] = None) -> float:
    knob = _lookup(name)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        if default is not None:
            return default
        return float(knob.default or 0.0)
    return float(raw)


_TRUTHY = ("1", "true", "yes", "on")


def get_bool(name: str, default: Optional[bool] = None) -> bool:
    knob = _lookup(name)
    raw = os.environ.get(name)
    if raw is None:
        if default is not None:
            return default
        raw = knob.default or "0"
    return raw.strip().lower() in _TRUTHY


def is_set(name: str) -> bool:
    """True when the knob is set in the environment."""
    _lookup(name)
    return name in os.environ


def provenance(name: str) -> str:
    """Where the current value of ``name`` comes from: 'env' or 'default'
    (the port has no tuned-profile overlay, the reference's third source)."""
    return "env" if is_set(name) else "default"


# Serving engine (inference/v2/engine_v2.py)
declare("DS_TPU_SERVE_FUSED", "1", "bool",
        "Serve with the single-dispatch fused SplitFuse step (0 serves with the unfused loop: a "
        "prefill step per chunk bucket and a decode step).",
        "inference/v2/engine_v2.py")
declare("DS_TPU_SPEC_DECODE", "0", "bool",
        "Enable speculative decoding (draft + single-dispatch K-token verify).",
        "inference/v2/engine_v2.py")
declare("DS_TPU_SPEC_K", "4", "int",
        "Speculation depth: draft tokens proposed per verify dispatch.",
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
        "Max live step variants (closures per family; captured CUDA graphs per engine) before LRU "
        "eviction.",
        "inference/v2/engine_v2.py")
# Tensor-parallel serving (inference/v2/engine_v2.py, comm/collectives.py)
declare("DS_TPU_TP", "0", "int",
        "Tensor-parallel degree for serving: shard attention heads, MLP "
        "hidden dims and the paged KV pool over a 'tensor' mesh axis of "
        "this many local devices (0/1 = off; explicit engine config wins).",
        "inference/v2/engine_v2.py")
declare("DS_TPU_TP_ALLREDUCE_BITS", "0", "int",
        "Quantized TP activation allreduce: 8 or 4 runs the two per-layer "
        "row-parallel reduces as an EQuARX-style shared-scale integer-code "
        "psum at that width (0 = exact full-precision reduce).",
        "comm/collectives.py")
# Paged-KV state manager (inference/v2/ragged/manager.py)
declare("DS_TPU_PREFIX_CACHE", "1", "bool",
        "Enable the radix prefix cache: retiring prompts donate KV blocks for reuse.",
        "inference/v2/ragged/manager.py")
# Tiered KV economy
declare("DS_TPU_KV_QUANT", "0", "int",
        "KV-cache quantization bits: 8 stores K/V pages as int8 with per-block "
        "per-head scales (fused dequant in the paged-attention kernels); 0 keeps "
        "the engine dtype.",
        "inference/v2/engine_v2.py")
declare("DS_TPU_KV_SPILL", "0", "bool",
        "Spill prefix-cache evictions to a host-RAM pool (async d2h) and re-admit "
        "matched prefixes via h2d DMA instead of re-prefilling.",
        "inference/v2/engine_v2.py")
declare("DS_TPU_KV_HOST_POOL_MB", "256", "int",
        "Capacity of the host-RAM KV spill pool in MiB (block count derives from "
        "the per-block byte size of the device pools).",
        "inference/v2/ragged/host_tier.py")
declare("DS_TPU_KV_SPILL_WATERMARK", "0.1", "float",
        "Free-block fraction below which the serving loop pre-spills LRU cached "
        "blocks to the host tier between dispatches.",
        "inference/v2/ragged/prefix_cache.py")
# Runtime sanitizers (analysis/)
declare("DS_TPU_KV_SANITIZE", "0", "bool",
        "Shadow-refcount sanitizer for paged KV blocks: traps double-free, "
        "leak-at-flush, and writes to shared blocks that skipped COW.",
        "analysis/kv_sanitizer.py")
# Telemetry (telemetry/)
declare("DS_TPU_TELEMETRY", "1", "bool",
        "Master switch for the telemetry subsystem (metrics, traces, events).",
        "telemetry/registry.py")
declare("DS_TPU_TELEMETRY_FLUSH_STEPS", "1", "int",
        "The training engine's monitor bridge flushes telemetry every N steps.",
        "runtime/engine.py")
declare("DS_TPU_TRACE_RING", "4096", "int",
        "Capacity of the span tracer's ring buffer.",
        "telemetry/tracing.py")
declare("DS_TPU_TRACE_XLA", "0", "bool",
        "Mirror spans into device profiles (the reference's XLA trace annotations; on the port NVTX "
        "ranges on a CUDA device, torch.profiler record_function ranges otherwise).",
        "telemetry/tracing.py")
declare("DS_TPU_EVENT_RING", "65536", "int",
        "Capacity of the request-lifecycle event ring buffer.",
        "telemetry/events.py")
declare("DS_TPU_EVENT_LOG", None, "str",
        "If set, append request-lifecycle events as JSONL to this path.",
        "telemetry/events.py")
declare("DS_TPU_HEALTH_LOG", None, "str",
        "If set, append health alerts as JSONL to this path.",
        "telemetry/health.py")
declare("DS_TPU_STALL_S", "30", "float",
        "Queue-stall detector threshold: alert when the oldest queued request "
        "waits longer than this many seconds.",
        "telemetry/health.py")
declare("DS_TPU_STRAGGLER_X", "4", "float",
        "Straggler detector threshold: flag a rank whose pooled "
        "collective-wait p50 exceeds this multiple of the cross-rank "
        "median p50.",
        "telemetry/health.py")
declare("DS_TPU_PERF_ACCOUNT", "1", "int",
        "Serving performance accounting: 0 off, 1 analytic cost cards (on the port FLOPs and bytes "
        "from the model config and the step's bucket; no extra work on the device). The reference's "
        "2 (XLA cost and memory analysis) has no counterpart and reads as 1.",
        "telemetry/costs.py")
declare("DS_TPU_PEAK_TFLOPS", "0", "float",
        "Declared peak dense TFLOP/s per chip for MFU and roofline "
        "readouts (0 = auto-detect from the device kind; unknown kinds "
        "report no MFU).",
        "telemetry/costs.py")
declare("DS_TPU_PEAK_GBPS", "0", "float",
        "Declared peak HBM GB/s per chip for roofline classification "
        "(0 = auto-detect from the device kind).",
        "telemetry/costs.py")
declare("DS_TPU_OPS_PORT", "0", "int",
        "Introspection server port (/metrics, /healthz, /requests, /perf, "
        "/flight, /varz). 0 (the default) starts nothing: zero threads, "
        "zero sockets.",
        "telemetry/ops_plane.py")
declare("DS_TPU_FLIGHT_DIR", None, "str",
        "If set, attach the flight recorder: every health alert snapshots "
        "the black box (events, spans, metrics, perf, residency, knobs) "
        "into a bounded capture ring under this directory.",
        "telemetry/flight.py")
declare("DS_TPU_FLIGHT_MAX", "8", "int",
        "Flight-recorder ring size: oldest on-disk captures are evicted "
        "beyond this many.",
        "telemetry/flight.py")
declare("DS_TPU_FLIGHT_PROFILE_S", "0", "float",
        "If >0, each flight capture also records a torch.profiler trace of "
        "this many seconds following the anomaly (opt-in: tracing is not "
        "free).",
        "telemetry/flight.py")
declare("DS_TPU_FLIGHT_PROFILE_MAX_MB", "64", "float",
        "Size bound on a flight capture's post-anomaly profile directory: "
        "over this many MB the raw trace is dropped (drop-and-count in "
        "the manifest) and only the parsed waterfall summary survives.",
        "telemetry/flight.py")
declare("DS_TPU_PROFILE", "0", "bool",
        "Arm a one-shot device-timeline capture at engine construction: "
        "the next DS_TPU_PROFILE_QUANTA serving quanta are wrapped in a "
        "torch.profiler trace and parsed into a per-quantum waterfall "
        "(compute / exposed-vs-overlapped collective / transfer / host "
        "gap).",
        "telemetry/profiler.py")
declare("DS_TPU_PROFILE_DIR", "profile_captures", "str",
        "Directory for device-timeline capture output (raw trace plus "
        "the parsed summary.json per capture).",
        "telemetry/profiler.py")
declare("DS_TPU_PROFILE_QUANTA", "32", "int",
        "Quanta per device-timeline capture window: the trace stops and "
        "parses after this many dispatch readback boundaries.",
        "telemetry/profiler.py")
declare("DS_TPU_JOURNAL", "0", "bool",
        "Record serving sessions to a black-box journal (engine "
        "fingerprint, arrivals, quantum composition, committed-token "
        "digests) for deterministic replay via inference/v2/replay.py.",
        "telemetry/journal.py")
declare("DS_TPU_JOURNAL_DIR", "journals", "str",
        "Directory for journal JSONL files (one per process) when "
        "DS_TPU_JOURNAL is on.",
        "telemetry/journal.py")
# Fused cross-entropy (ops/fused_ce.py)
declare("DS_TPU_CE_CHUNK", "0", "int",
        "Fused cross-entropy vocab-chunk size (0 = derive from budget).",
        "ops/fused_ce.py")
declare("DS_TPU_CE_BUDGET_MB", "4096", "int",
        "Memory budget (MB) used to derive the fused cross-entropy chunk size.",
        "ops/fused_ce.py")
