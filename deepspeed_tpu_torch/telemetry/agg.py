"""Rank-aware telemetry aggregation.

Port of ``deepspeed_tpu/telemetry/agg.py``. Every ``MetricsRegistry.snapshot()``
and flight capture is stamped with ``(process_index, process_count,
device_kind)`` so per-rank JSON artifacts stay attributable after they leave
the process. This module merges those snapshots (sum counters, merge
fixed-bucket histograms: bucket identity is enforced at registration, so
cumulative counts add; max gauges with a per-rank breakdown) and derives
cross-rank diagnostics from them, chiefly the collective-wait straggler
analysis consumed by ``health.StragglerDetector``.

Everything here operates on plain JSON-able dicts: the merge runs offline
(a tool, tests, a controller process) against files written by
``write_rank_snapshot``, with no live cross-process RPC. Only ``rank_stamp``
reads the process: ``torch.distributed`` where it is initialised.
"""

import json
import os
import re
from typing import Dict, List, Optional, Sequence

_RANK_STAMP: Optional[Dict] = None

# series-name parser for snapshot keys: name{k="v",...} with exposition
# escaping inside the quotes (\\, \", \n)
_SERIES_RE = re.compile(r'^([a-z_][a-z0-9_]*)(?:\{(.*)\})?$')
_LABEL_RE = re.compile(r'([a-z_][a-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def rank_stamp() -> Dict:
    """``{process_index, process_count, device_kind}`` for this process.

    The rank and world size come from ``torch.distributed`` when it is
    initialised (a single-process stamp otherwise), the kind from
    ``torch.cuda.get_device_name`` (``"cpu"`` without a card). A stamp taken
    before ``init_process_group`` is not refreshed by it: stamp after it.
    """
    global _RANK_STAMP
    if _RANK_STAMP is None:
        import torch

        idx, cnt = 0, 1
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            idx, cnt = int(torch.distributed.get_rank()), int(torch.distributed.get_world_size())
        kind = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
        _RANK_STAMP = {"process_index": idx, "process_count": cnt, "device_kind": kind}
    return dict(_RANK_STAMP)


def _reset_rank_stamp_for_tests() -> None:
    global _RANK_STAMP
    _RANK_STAMP = None


def write_rank_snapshot(dir_path: str, registry=None) -> str:
    """Dump this rank's stamped registry snapshot to
    ``<dir>/telemetry-rank<process_index>.json`` and return the path.
    The fixed naming scheme is what ``merge_snapshot_files`` globs for."""
    if registry is None:
        from .registry import get_registry
        registry = get_registry()
    snap = registry.snapshot()
    snap.setdefault("rank", rank_stamp())
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"telemetry-rank{snap['rank']['process_index']}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------------ merge

def merge_snapshots(snaps: Sequence[Dict]) -> Dict:
    """Merge per-rank snapshot dicts into one cross-rank view.

    - counters: summed per series;
    - histograms: bucket-wise cumulative sums (requires identical bucket
      edges per series name — guaranteed by registration-time bucket
      identity; mismatches raise rather than silently corrupt);
    - gauges: max per series, with the per-rank values retained under
      ``gauges_by_rank`` so a merged view never hides a divergent rank.
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    gauges_by_rank: Dict[str, Dict[str, float]] = {}
    histograms: Dict[str, Dict] = {}
    ranks: List[Dict] = []
    for snap in snaps:
        stamp = snap.get("rank", {"process_index": len(ranks),
                                  "process_count": len(snaps),
                                  "device_kind": "unknown"})
        ranks.append(stamp)
        rk = str(stamp.get("process_index", len(ranks) - 1))
        for series, v in snap.get("counters", {}).items():
            counters[series] = counters.get(series, 0.0) + float(v)
        for series, v in snap.get("gauges", {}).items():
            gauges[series] = max(gauges[series], float(v)) if series in gauges else float(v)
            gauges_by_rank.setdefault(series, {})[rk] = float(v)
        for series, h in snap.get("histograms", {}).items():
            prev = histograms.get(series)
            if prev is None:
                histograms[series] = {"sum": float(h["sum"]), "count": int(h["count"]),
                                      "buckets": {le: int(c) for le, c in h["buckets"].items()}}
                continue
            if set(prev["buckets"]) != set(h["buckets"]):
                raise ValueError(
                    f"histogram {series!r}: bucket edges differ across ranks "
                    f"({sorted(prev['buckets'])} vs {sorted(h['buckets'])})")
            prev["sum"] += float(h["sum"])
            prev["count"] += int(h["count"])
            for le, c in h["buckets"].items():
                prev["buckets"][le] += int(c)
    ts = max((float(s.get("ts_unix", 0.0)) for s in snaps), default=0.0)
    return {"ts_unix": ts, "n_ranks": len(ranks), "ranks": ranks,
            "counters": counters, "gauges": gauges,
            "gauges_by_rank": gauges_by_rank, "histograms": histograms}


def merge_snapshot_files(paths: Sequence[str]) -> Dict:
    snaps = []
    for p in paths:
        with open(p) as f:
            snaps.append(json.load(f))
    return merge_snapshots(snaps)


# ------------------------------------------------------- histogram maths

def _bucket_edges(buckets: Dict[str, int]) -> List[float]:
    return sorted(float("inf") if le == "+Inf" else float(le) for le in buckets)


def histogram_quantile(hist: Dict, q: float) -> float:
    """Quantile estimate from a snapshot-shaped histogram dict
    (``{"sum", "count", "buckets": {le: cumulative}}``), linearly
    interpolated inside the containing bucket — the promql
    ``histogram_quantile`` convention. Returns 0.0 for empty histograms;
    an estimate landing in the +Inf bucket clamps to the last finite edge."""
    total = int(hist.get("count", 0))
    if total <= 0:
        return 0.0
    target = q * total
    cum = {("+Inf" if le == "+Inf" else format(float(le), "g")): int(c)
           for le, c in hist["buckets"].items()}
    edges = _bucket_edges(hist["buckets"])
    prev_edge, prev_cum = 0.0, 0
    for edge in edges:
        le_s = "+Inf" if edge == float("inf") else format(edge, "g")
        c = cum[le_s]
        if c >= target:
            if edge == float("inf"):
                return prev_edge  # clamp: no finite upper bound to lerp to
            if c == prev_cum:
                return edge
            frac = (target - prev_cum) / (c - prev_cum)
            return prev_edge + frac * (edge - prev_edge)
        prev_edge, prev_cum = (0.0 if edge == float("inf") else edge), c
    return prev_edge


def parse_series(series: str):
    """Split a snapshot series key back into ``(name, labels)``, undoing
    the exposition-format label-value escaping."""
    m = _SERIES_RE.match(series)
    if not m:
        return series, {}
    name, raw = m.group(1), m.group(2)
    labels: Dict[str, str] = {}
    if raw:
        for lm in _LABEL_RE.finditer(raw):
            v = lm.group(2)
            v = v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
            labels[lm.group(1)] = v
    return name, labels


# --------------------------------------------------- straggler analysis

def comm_wait_profile(snap: Dict, metric: str = "comm_latency_seconds") -> Dict:
    """Pool every ``comm_latency_seconds{op=...}`` series of one rank's
    snapshot into a single histogram (the per-op bucket edges are shared
    by construction) and return it; empty dict when the rank recorded no
    collectives."""
    pooled: Dict = {}
    for series, h in snap.get("histograms", {}).items():
        name, _ = parse_series(series)
        if name != metric:
            continue
        if not pooled:
            pooled = {"sum": float(h["sum"]), "count": int(h["count"]),
                      "buckets": {le: int(c) for le, c in h["buckets"].items()}}
        else:
            pooled["sum"] += float(h["sum"])
            pooled["count"] += int(h["count"])
            for le, c in h["buckets"].items():
                pooled["buckets"][le] = pooled["buckets"].get(le, 0) + int(c)
    return pooled


def detect_stragglers(snaps: Sequence[Dict], ratio: float = 4.0,
                      min_count: int = 8) -> Dict:
    """Flag ranks whose pooled collective-wait p50 exceeds ``ratio`` × the
    lower median of all ranks' p50s. The LOWER median matters: with an
    even rank count an averaged median is dragged up by the straggler
    itself (at 2 ranks the ratio can never exceed 2, however slow the
    slow rank), while the lower median keeps a healthy rank as the
    baseline. Ranks with fewer than ``min_count`` recorded collectives
    are excluded (a cold rank is not a straggler).
    Returns ``{"p50_by_rank", "median_p50", "stragglers": [{rank, p50,
    ratio}]}``: JSON-able, consumed by StragglerDetector."""
    p50s: Dict[str, float] = {}
    for i, snap in enumerate(snaps):
        stamp = snap.get("rank", {})
        rk = str(stamp.get("process_index", i))
        prof = comm_wait_profile(snap)
        if prof and int(prof.get("count", 0)) >= min_count:
            p50s[rk] = histogram_quantile(prof, 0.5)
    if not p50s:
        return {"p50_by_rank": {}, "median_p50": 0.0, "stragglers": []}
    ordered = sorted(p50s.values())
    median = ordered[(len(ordered) - 1) // 2]
    stragglers = []
    if median > 0.0:
        for rk, p50 in sorted(p50s.items()):
            if p50 > ratio * median:
                stragglers.append({"rank": rk, "p50": p50,
                                   "ratio": p50 / median})
    return {"p50_by_rank": p50s, "median_p50": median, "stragglers": stragglers}
