"""Performance accounting for the serving engine: per-step cost cards,
wall-time attribution, a goodput ledger, and roofline classification.

Port of ``deepspeed_tpu/telemetry/costs.py``. Every serving step the engine
dispatches goes through ``PerfAccountant.wrap``: the first sighting of a
(program, signature) pair builds a **cost card**, and on the port the
signature is the step's graph key (the bucket's shapes, steps, EOS id and
sampling signature), so a card stands for one captured CUDA graph as the
reference's stands for one XLA executable. At run time the engine
attributes each quantum's measured wall window to its card, yielding
achieved FLOP/s and bandwidth, MFU against a declared or detected peak
(``DS_TPU_PEAK_TFLOPS`` / ``DS_TPU_PEAK_GBPS``, else the card's data-sheet
row), and a compute- vs memory-bound classification per bucket.

Where the reference and the port differ, by design:

- **FLOPs come from shapes, not a jaxpr walk.** The caller hands ``wrap`` a
  ``cost`` function; the engine's computes the products of the model config
  over the step's bucket (``forward_macs``: projections, MLP or the routed
  expert rows and the gate, the LM head over the rows that reach it) and
  attention over the visible (query, key) pairs of the call's real rows
  (``attention_macs``, from host arrays the dispatch already holds). The
  shape part is the card's ``flops`` / ``macs``, constant per graph key like
  the reference's; the attention part depends on each call's contexts and
  accumulates in the card's ``attn_flops``. The reference's walk sees a
  ``pallas_call`` only by its output size and no ``ragged_dot`` at all.
- **Mode 2** (XLA's ``cost_analysis`` / ``memory_analysis`` of an AOT
  compile) has no counterpart; ``DS_TPU_PERF_ACCOUNT=2`` reads as 1, with a
  warning.

Modes (``DS_TPU_PERF_ACCOUNT``): ``0`` off (``wrap`` returns the function
unchanged); ``1`` (default) analytic cards. Nothing here reads a device
value: card construction and attribution are host arithmetic.

The goodput ledger separates useful work from overhead the bucketing
design knowingly pays: padding fill (useful vs slot tokens), speculative
tokens rejected by verification, prefill FLOPs saved by the prefix cache and
by host-tier re-admissions, and COW page-copy traffic.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..analysis import knobs

__all__ = ["CostCard", "PerfAccountant", "get_perf_accountant", "resolve_peaks", "forward_macs",
           "attention_macs", "leaf_signature"]

logger = logging.getLogger(__name__)

# Peak dense-bf16 TFLOP/s and HBM GB/s per card, by device-name substring.
# Public data-sheet numbers (NVIDIA H100: SXM5 80 GB HBM3, PCIe 80 GB HBM2e);
# first match wins (match on the lowercased name).
_PEAKS_BY_KIND: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("h100 80gb hbm3", (989.0, 3350.0)),
    ("h100 sxm", (989.0, 3350.0)),
    ("h100 pcie", (756.0, 2000.0)),
)


def resolve_peaks() -> Tuple[float, float]:
    """(peak FLOP/s, peak bytes/s): declared knobs win, else the card's name
    (``torch.cuda.get_device_name()``) is matched against the data-sheet
    table. An unknown card or the CPU resolves to 0.0, and MFU and roofline
    readouts degrade to "unknown" rather than inventing a peak."""
    tflops = knobs.get_float("DS_TPU_PEAK_TFLOPS")
    gbps = knobs.get_float("DS_TPU_PEAK_GBPS")
    if tflops <= 0.0 or gbps <= 0.0:
        import torch

        kind = torch.cuda.get_device_name().lower() if torch.cuda.is_available() else ""
        for sub, (tf, gb) in _PEAKS_BY_KIND:
            if sub in kind:
                if tflops <= 0.0:
                    tflops = tf
                if gbps <= 0.0:
                    gbps = gb
                break
    return (max(0.0, tflops) * 1e12, max(0.0, gbps) * 1e9)


# ------------------------------------------------------ FLOPs from shapes

def forward_macs(cfg, tokens: int, head_rows: int) -> int:
    """Multiply-accumulates of the products of one forward of ``cfg`` (a
    ``TransformerConfig``) over ``tokens`` token rows of which ``head_rows``
    reach the LM head: the q, k, v and o projections, the dense MLP (three
    products when gated) or, in an MoE block, the fp32 gate and the expert
    products over the ``tokens * top_k`` routed rows, and the head.
    Attention's two products are ``attention_macs``; norms, rope and the
    embedding lookup are not products."""
    from ..models.transformer import _is_moe_layer

    d, dh, ff = cfg.d_model, cfg.head_dim, cfg.ffn_dim
    proj = d * dh * (2 * cfg.n_heads + 2 * cfg.kv_heads)
    dense = d * ff * (3 if cfg.activation in ("swiglu", "geglu") else 2)
    # the serving MoE module gates its experts for swiglu only (modules.moe_tpu)
    expert = d * ff * (3 if cfg.activation == "swiglu" else 2)
    moe = d * cfg.moe_num_experts + cfg.moe_top_k * expert
    per_token = sum(proj + (moe if _is_moe_layer(cfg, i) else dense) for i in range(cfg.n_layers))
    return int(tokens) * per_token + int(head_rows) * d * cfg.vocab_size


def _keys_seen(n: np.ndarray, window: Optional[int]) -> np.ndarray:
    """sum_{i=1..n} min(i, window): the keys the queries at positions 0..n-1
    see, causally, within a window."""
    n = np.maximum(np.asarray(n, np.int64), 0)
    if window is None:
        return n * (n + 1) // 2
    w = int(window)
    return np.where(n <= w, n * (n + 1) // 2, w * (w + 1) // 2 + (n - w) * w)


def attention_macs(cfg, q_lens, ctx_end) -> int:
    """Multiply-accumulates of attention's two products (q k^T and p v) over
    the visible (query, key) pairs: each row's ``q_lens`` queries sit at the
    last consecutive positions of a context of ``ctx_end`` keys and see the
    keys at or before their own position (within each layer's window).
    Summed over rows and layers, head_dim MACs a pair a product a head."""
    q = np.asarray(q_lens, np.int64)
    end = np.asarray(ctx_end, np.int64)
    pairs: Dict[Optional[int], int] = {}
    total = 0
    for i in range(cfg.n_layers):
        w = cfg.window_for(i)
        if w not in pairs:
            pairs[w] = int((_keys_seen(end, w) - _keys_seen(end - q, w)).sum())
        total += pairs[w]
    return 2 * cfg.n_heads * cfg.head_dim * total


def leaf_signature(x: Any) -> Any:
    """Abstract signature of a call's arguments: shapes and dtypes for
    tensors and arrays, types for Python scalars (the reference's
    ``analysis/jit_audit.leaf_signature``, the default card key)."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), dtype)
    if isinstance(x, (int, float, bool, complex)) or x is None:
        return ("py", type(x).__name__)
    if isinstance(x, (list, tuple)):
        return ("seq", tuple(leaf_signature(v) for v in x))
    if isinstance(x, dict):
        return ("map", tuple(sorted((k, leaf_signature(v)) for k, v in x.items())))
    return ("obj", type(x).__name__)


def _leaf_bytes(x: Any) -> int:
    """Bytes of the tensors and arrays in a nest (shape metadata only)."""
    if isinstance(x, (list, tuple)):
        return sum(_leaf_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_leaf_bytes(v) for v in x.values())
    nbytes = getattr(x, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    numel = getattr(x, "numel", None)
    if callable(numel) and hasattr(x, "element_size"):
        return int(numel()) * int(x.element_size())
    return 0


@dataclass
class CostCard:
    """Static cost model + running attribution for one (program, signature)
    bucket: one captured step graph."""

    program: str
    signature: str
    # -- static, filled once at first sighting --------------------------
    flops: int = 0            # FLOPs per call from shapes (attention apart)
    macs: int = 0
    xla_flops: int = 0        # the reference's mode-2 field: always 0 here
    bytes_accessed: int = 0   # analytic HBM traffic per call: arg + out
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0       # the reference's mode-2 field: always 0 here
    source: str = "analytic"  # "analytic" | "unavailable"
    meta: Dict[str, Any] = field(default_factory=dict)
    # -- running attribution ---------------------------------------------
    calls: int = 0            # every dispatch through the wrapper
    timed_calls: int = 0      # dispatches whose wall window was attributed
    time_s: float = 0.0       # summed attributed wall time
    useful_tokens: int = 0
    slot_tokens: int = 0
    attn_flops: int = 0       # attention FLOPs of the timed calls (data-dependent)

    # ------------------------------------------------------------- derived
    def model_flops(self) -> int:
        """FLOPs attributed to this card: its timed calls' shape FLOPs and
        their attention FLOPs."""
        return self.flops * self.timed_calls + self.attn_flops

    def achieved_flops_per_s(self) -> float:
        return self.model_flops() / self.time_s if self.time_s > 0 else 0.0

    def achieved_bytes_per_s(self) -> float:
        return self.bytes_accessed * self.timed_calls / self.time_s if self.time_s > 0 else 0.0

    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs per HBM byte) of the program."""
        return self.flops / self.bytes_accessed if self.bytes_accessed > 0 else 0.0

    def bound(self, peak_flops: float, peak_bw: float) -> str:
        """Roofline classification against the machine balance point."""
        if peak_flops <= 0 or peak_bw <= 0 or self.bytes_accessed <= 0 or self.flops <= 0:
            return "unknown"
        return "compute" if self.intensity() >= peak_flops / peak_bw else "memory"

    def as_dict(self, peak_flops: float = 0.0, peak_bw: float = 0.0) -> Dict[str, Any]:
        d = {
            "program": self.program,
            "signature": self.signature,
            "flops": self.flops,
            "macs": self.macs,
            "xla_flops": self.xla_flops,
            "bytes_accessed": self.bytes_accessed,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes,
            "source": self.source,
            "meta": dict(self.meta),
            "calls": self.calls,
            "timed_calls": self.timed_calls,
            "time_s": self.time_s,
            "useful_tokens": self.useful_tokens,
            "slot_tokens": self.slot_tokens,
            "attn_flops": self.attn_flops,
            "achieved_tflops": self.achieved_flops_per_s() / 1e12,
            "achieved_gbps": self.achieved_bytes_per_s() / 1e9,
            "intensity_flops_per_byte": self.intensity(),
            "bound": self.bound(peak_flops, peak_bw),
        }
        if peak_flops > 0:
            d["pct_peak_flops"] = 100.0 * self.achieved_flops_per_s() / peak_flops
        if peak_bw > 0:
            d["pct_peak_bw"] = 100.0 * self.achieved_bytes_per_s() / peak_bw
        return d


def _read_mode(mode: Optional[int]) -> int:
    mode = knobs.get_int("DS_TPU_PERF_ACCOUNT") if mode is None else int(mode)
    if mode >= 2:
        logger.warning("DS_TPU_PERF_ACCOUNT=%d: XLA cost analysis has no counterpart on the port; "
                       "accounting runs as mode 1 (FLOPs from shapes)", mode)
        mode = 1
    return mode


class PerfAccountant:
    """Builds cost cards at first sighting, attributes wall time at run time.

    The engine wraps its step dispatch with ``wrap``; a fresh signature
    builds a card, a warm one is a dict hit, so steady-state cost is one
    dict lookup, the caller's cost arithmetic and a ``perf_counter`` stamp.

    Attribution is explicit: the dispatch site calls ``attribute(useful,
    slots)`` after its host-visible boundary (the readback that already
    synchronises), closing the window the wrapper opened. Functions wrapped
    with ``timed=False`` (the COW page copy, the spill gather and the
    re-admission, which run *inside* another quantum's window) never open a
    window, so they cannot clobber the quantum's attribution.
    """

    def __init__(self, mode: Optional[int] = None, use_telemetry: bool = True):
        self.mode = _read_mode(mode)
        self.enabled = self.mode > 0
        self._lock = threading.Lock()
        self._cards: Dict[Tuple[str, Any], CostCard] = {}
        self._open: Optional[Tuple[CostCard, float, int]] = None
        self._hbm: Dict[str, Any] = {}
        self._hbm_limit = 0
        # goodput ledger (host-side accumulators)
        self.useful_tokens = 0
        self.slot_tokens = 0
        self.attributed_flops = 0
        self.attributed_time_s = 0.0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prefix_hit_tokens = 0
        self.readmit_tokens = 0
        self.cow_bytes = 0
        self._peaks: Optional[Tuple[float, float]] = None
        self._m_flops = self._m_useful = self._m_slot = None
        self._m_goodput = self._m_mfu = None
        self._m_hbm = {}
        if use_telemetry and self.enabled:
            from .registry import get_registry

            tele = get_registry()
            self._m_flops = tele.counter("infer_model_flops_total")
            self._m_useful = tele.counter("infer_useful_tokens_total")
            self._m_slot = tele.counter("infer_slot_tokens_total")
            self._m_goodput = tele.gauge("infer_goodput_fraction")
            self._m_mfu = tele.gauge("infer_mfu")
            self._m_hbm = {
                "weights": tele.gauge("infer_hbm_weights_bytes"),
                "temp_peak": tele.gauge("infer_hbm_temp_peak_bytes"),
                "kv_pages": tele.gauge("kv_hbm_pages_bytes"),
                "prefix": tele.gauge("kv_hbm_prefix_bytes"),
                "host_spill": tele.gauge("kv_host_spill_bytes"),
                "pressure": tele.gauge("infer_hbm_pressure"),
            }

    # ------------------------------------------------------------ peaks
    def peaks(self) -> Tuple[float, float]:
        if self._peaks is None:
            self._peaks = resolve_peaks()
        return self._peaks

    # ----------------------------------------------------------- wiring
    def wrap(self, name: str, fn, meta: Optional[Dict[str, Any]] = None, timed: bool = True,
             signature: Optional[Callable] = None, cost: Optional[Callable] = None):
        """Return ``fn`` with cost accounting; identity when disabled (and a
        pass-through while ``enabled`` is switched off after the wrap).

        ``signature(*args, **kwargs)`` keys the cards (default: the
        arguments' shapes and dtypes, ``leaf_signature``). ``cost(*args,
        **kwargs)`` returns a dict with ``flops``, ``macs``, ``arg_bytes`` and
        ``out_bytes`` (read at a card's first sighting) and ``attn_flops``
        (read on every call); without it a card records its argument and
        output bytes only (``source="unavailable"``)."""
        if not self.enabled:
            return fn
        static_meta = dict(meta or {})
        static_meta.update(getattr(fn, "_cost_meta", None) or {})

        def wrapped(*args, **kwargs):
            if not self.enabled:  # switched off since the wrap: pass through
                return fn(*args, **kwargs)
            if signature is not None:
                sig = signature(*args, **kwargs)
            else:
                sig = leaf_signature(args) if not kwargs else (leaf_signature(args), leaf_signature(kwargs))
            c = cost(*args, **kwargs) if cost is not None else None
            key = (name, sig)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            card = self._cards.get(key)
            if card is None:
                card = self._build_card(key, c, args, kwargs, out, static_meta)
            with self._lock:
                card.calls += 1
                if timed:
                    # dispatch is asynchronous: the window stays open until the dispatch site's readback, closed by
                    # attribute()
                    self._open = (card, t0, int(c.get("attn_flops", 0)) if c else 0)
            return out

        wrapped.__wrapped__ = fn  # type: ignore[attr-defined]
        wrapped._perf_account_name = name  # type: ignore[attr-defined]
        return wrapped

    def _build_card(self, key: Tuple[str, Any], c: Optional[Dict[str, int]], args, kwargs, out,
                    meta: Dict[str, Any]) -> CostCard:
        name, sig = key
        card = CostCard(program=name, signature=repr(sig), meta=meta)
        if c is not None:
            card.flops, card.macs = int(c.get("flops", 0)), int(c.get("macs", 0))
            card.arg_bytes, card.out_bytes = int(c.get("arg_bytes", 0)), int(c.get("out_bytes", 0))
        else:
            card.arg_bytes, card.out_bytes = _leaf_bytes((args, kwargs)), _leaf_bytes(out)
            card.source = "unavailable"
        # analytic lower bound on HBM traffic: read args once, write outputs once
        card.bytes_accessed = card.arg_bytes + card.out_bytes
        with self._lock:
            return self._cards.setdefault(key, card)

    # ------------------------------------------------------ attribution
    def attribute(self, useful_tokens: int = 0, slot_tokens: int = 0) -> None:
        """Close the most recent open window: the wall time between the
        wrapped dispatch and this call (the dispatch site's host-visible
        boundary) is attributed to that program's card."""
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            opened = self._open
            self._open = None
            if opened is None:
                return
            card, t0, attn = opened
            dt = max(0.0, now - t0)
            card.timed_calls += 1
            card.time_s += dt
            card.attn_flops += attn
            card.useful_tokens += int(useful_tokens)
            card.slot_tokens += int(slot_tokens)
            self.useful_tokens += int(useful_tokens)
            self.slot_tokens += int(slot_tokens)
            flops = card.flops + attn
            self.attributed_flops += flops
            self.attributed_time_s += dt
            goodput = self.useful_tokens / self.slot_tokens if self.slot_tokens else 0.0
        if self._m_flops is not None and flops:
            self._m_flops.inc(flops)
        if self._m_useful is not None and useful_tokens:
            self._m_useful.inc(int(useful_tokens))
        if self._m_slot is not None and slot_tokens:
            self._m_slot.inc(int(slot_tokens))
        if self._m_goodput is not None and self.slot_tokens:
            self._m_goodput.set(goodput)
        peak_flops, _ = self.peaks()
        if self._m_mfu is not None and peak_flops > 0 and dt > 0:
            self._m_mfu.set(flops / dt / peak_flops)

    # --------------------------------------------------- goodput ledger
    def note_spec(self, proposed: int, accepted: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.spec_proposed += int(proposed)
            self.spec_accepted += int(accepted)

    def note_prefix_hit(self, tokens: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.prefix_hit_tokens += int(tokens)

    def note_readmit(self, tokens: int) -> None:
        """Tokens whose KV returned from the host spill tier over an h2d
        copy instead of a prefill re-run. Priced in the ledger at the
        prefill-class FLOP rate, like prefix hits: the copy replaced exactly
        that work."""
        if not self.enabled:
            return
        with self._lock:
            self.readmit_tokens += int(tokens)

    def note_cow(self, n_bytes: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.cow_bytes += int(n_bytes)

    # -------------------------------------------------------- HBM pools
    def set_hbm(self, limit: int = 0, **pools: int) -> float:
        """Record per-pool HBM bytes; returns the pressure fraction
        (resident + program temp peak over the device limit; 0.0 when no
        limit is known: a CPU engine reports none)."""
        if not self.enabled:
            return 0.0
        with self._lock:
            for k, v in pools.items():
                self._hbm[k] = int(v)
            if limit:
                self._hbm_limit = int(limit)
            temp = max((c.temp_bytes for c in self._cards.values()), default=0)
            self._hbm["temp_peak"] = temp
            # prefix-held blocks live inside the paged-KV pool: counted once via kv_pages, reported separately as
            # an informational subset
            resident = self._hbm.get("weights", 0) + self._hbm.get("kv_pages", 0) + temp
            pressure = resident / self._hbm_limit if self._hbm_limit > 0 else 0.0
            self._hbm["resident"] = resident
            self._hbm["pressure"] = pressure
        for k, g in self._m_hbm.items():
            if k == "pressure":
                g.set(pressure)
            elif k in self._hbm:
                g.set(self._hbm[k])
        return pressure

    def hbm(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._hbm)
        out.setdefault("weights", 0)
        out.setdefault("kv_pages", 0)
        out.setdefault("prefix", 0)
        out.setdefault("host_spill", 0)
        out.setdefault("temp_peak", 0)
        out.setdefault("pressure", 0.0)
        if self._hbm_limit:
            out["limit"] = self._hbm_limit
        return out

    # --------------------------------------------------------- readouts
    def cards(self) -> Dict[Tuple[str, Any], CostCard]:
        with self._lock:
            return dict(self._cards)

    def totals(self) -> Dict[str, float]:
        """Cumulative attribution totals: cheap, for windowed deltas."""
        with self._lock:
            return {
                "flops": float(self.attributed_flops),
                "time_s": self.attributed_time_s,
                "useful_tokens": float(self.useful_tokens),
                "slot_tokens": float(self.slot_tokens),
            }

    def mfu(self, flops: Optional[float] = None, time_s: Optional[float] = None) -> Optional[float]:
        """Model FLOP/s utilization; None when no peak is known."""
        peak_flops, _ = self.peaks()
        if peak_flops <= 0:
            return None
        f = self.attributed_flops if flops is None else flops
        t = self.attributed_time_s if time_s is None else time_s
        if t <= 0:
            return 0.0
        return f / t / peak_flops

    def ledger(self) -> Dict[str, Any]:
        with self._lock:
            cards = list(self._cards.values())
            useful, slot = self.useful_tokens, self.slot_tokens
            proposed, accepted = self.spec_proposed, self.spec_accepted
            prefix_tokens, cow = self.prefix_hit_tokens, self.cow_bytes
            readmit_tokens = self.readmit_tokens
        rejected = max(0, proposed - accepted)
        # wasted verify work: the spec programs' attributed FLOPs scale by the rejected fraction of proposed tokens
        spec_flops = sum(c.model_flops() for c in cards if c.program.startswith("spec"))
        rejected_flops = int(spec_flops * rejected / proposed) if proposed else 0
        # saved prefill work: prefix-cache hit tokens never re-run prefill; price them at the prefill-class
        # per-slot-token FLOP rate
        pre_cards = [c for c in cards if c.program.startswith(("prefill", "fused")) and c.slot_tokens > 0]
        pre_flops = sum(c.model_flops() for c in pre_cards)
        pre_slots = sum(c.slot_tokens for c in pre_cards)
        saved_flops = int(prefix_tokens * pre_flops / pre_slots) if pre_slots else 0
        # re-admitted tokens are a subset of prefix hits whose KV came back over an h2d copy: without the host
        # tier they would have re-run prefill
        readmit_saved = int(readmit_tokens * pre_flops / pre_slots) if pre_slots else 0
        return {
            "useful_tokens": useful,
            "slot_tokens": slot,
            "goodput_fraction": useful / slot if slot else 0.0,
            "spec_proposed_tokens": proposed,
            "spec_accepted_tokens": accepted,
            "spec_rejected_tokens": rejected,
            "spec_rejected_flops": rejected_flops,
            "prefix_hit_tokens": prefix_tokens,
            "prefix_saved_prefill_flops": saved_flops,
            "readmit_tokens": readmit_tokens,
            "readmit_saved_prefill_flops": readmit_saved,
            "cow_copy_bytes": cow,
        }

    def snapshot(self) -> Dict[str, Any]:
        """Peaks, per-card roofline rows, the goodput ledger, and the HBM
        pool gauges (the reference's ``BENCH_PERF.json`` shape)."""
        peak_flops, peak_bw = self.peaks()
        cards = sorted(self.cards().values(), key=lambda c: -c.time_s)
        return {
            "mode": self.mode,
            "peaks": {
                "flops_per_s": peak_flops,
                "bytes_per_s": peak_bw,
                "machine_balance_flops_per_byte": peak_flops / peak_bw if peak_bw > 0 else 0.0,
            },
            "totals": self.totals(),
            "mfu": self.mfu(),
            "cards": [c.as_dict(peak_flops, peak_bw) for c in cards],
            "ledger": self.ledger(),
            "hbm": self.hbm(),
        }

    # ------------------------------------------------------------ resets
    def reset_counts(self) -> None:
        """Zero all running attribution (calls, time, tokens, ledger) but
        keep the built cards."""
        with self._lock:
            for c in self._cards.values():
                c.calls = c.timed_calls = 0
                c.time_s = 0.0
                c.useful_tokens = c.slot_tokens = 0
                c.attn_flops = 0
            self._open = None
            self.useful_tokens = self.slot_tokens = 0
            self.attributed_flops = 0
            self.attributed_time_s = 0.0
            self.spec_proposed = self.spec_accepted = 0
            self.prefix_hit_tokens = 0
            self.readmit_tokens = 0
            self.cow_bytes = 0

    def reset(self) -> None:
        """Full reset: drop cards, ledger, HBM pools, and re-read the mode."""
        with self._lock:
            self._cards.clear()
            self._open = None
            self._hbm.clear()
            self._hbm_limit = 0
            self._peaks = None
        self.reset_counts()
        self.mode = _read_mode(None)
        self.enabled = self.mode > 0


_ACCOUNTANT: Optional[PerfAccountant] = None
_ACCT_LOCK = threading.Lock()


def get_perf_accountant() -> PerfAccountant:
    """Process-wide accountant (mode read from ``DS_TPU_PERF_ACCOUNT`` at
    first use; ``reset()`` re-reads it)."""
    global _ACCOUNTANT
    with _ACCT_LOCK:
        if _ACCOUNTANT is None:
            _ACCOUNTANT = PerfAccountant()
        return _ACCOUNTANT
