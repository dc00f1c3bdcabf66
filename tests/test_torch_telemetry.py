"""Port parity: the telemetry modules (``deepspeed_tpu_torch/telemetry``).

After ``tests/unit/test_telemetry.py``, ``test_perf_accounting.py``,
``test_profiler.py`` and ``test_ops_plane.py``: the same calls and data go
through the JAX package's module and the port's, and the results must be
equal:
- the registry's ``series()`` and ``snapshot()``, the span tracer (nesting,
  ring eviction, exceptions, both dump formats), the monitor bridge and the
  CSV monitor's files;
- every detector, fed one observation or event sequence, gives the same
  alerts at the same steps, and the health monitor the same alerts, gauge,
  counters and event-log records;
- ``merge_snapshots``, ``histogram_quantile``, ``comm_wait_profile`` and
  ``detect_stragglers`` on the same snapshot dicts;
- the accountant, given the same ``attribute`` / ``note_*`` / ``set_hbm``
  calls with a card's FLOPs equal on both sides (the JAX card's from its
  jaxpr walk, the port's injected from shapes), gives the same totals,
  goodput, ledger prices, pressure and snapshot;
- ``parse_trace_events`` and ``build_waterfall`` on the reference's fixture
  trace; the port's parser on a synthetic ``torch.profiler`` trace gives
  the expected compute / transfer / collective / host split, and a real CPU
  ``torch.profiler`` capture cuts its quanta by its in-trace markers;
- the ops plane's endpoints for the same state give the same status and
  JSON keys; the flight recorder's manifests the same sections.
No test bounds a wall-clock time.
"""

import csv
import json
import os
import shutil
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import deepspeed_tpu.analysis.knobs as jax_knobs
import deepspeed_tpu.telemetry as jt
import deepspeed_tpu_torch.telemetry as tt
from deepspeed_tpu.telemetry import agg as jax_agg
from deepspeed_tpu.telemetry import bridge as jax_bridge
from deepspeed_tpu.telemetry import costs as jax_costs
from deepspeed_tpu.telemetry import events as jax_events
from deepspeed_tpu.telemetry import flight as jax_flight
from deepspeed_tpu.telemetry import health as jax_health
from deepspeed_tpu.telemetry import ops_plane as jax_ops
from deepspeed_tpu.telemetry import profiler as jax_prof
from deepspeed_tpu.telemetry import registry as jax_reg
from deepspeed_tpu.telemetry import tracing as jax_tracing
from deepspeed_tpu_torch.analysis import knobs
from deepspeed_tpu_torch.telemetry import agg, bridge, costs, events, flight, health, ops_plane, profiler, registry
from deepspeed_tpu_torch.telemetry import tracing

FIXTURE = os.path.join(os.path.dirname(__file__), "unit", "fixtures", "tiny_device_trace.trace.json")
US = 1e-6
# the modules of each package, by role
PKGS = {
    "jax": types.SimpleNamespace(reg=jax_reg, tracing=jax_tracing, events=jax_events, health=jax_health,
                                 costs=jax_costs, agg=jax_agg, flight=jax_flight, ops=jax_ops, prof=jax_prof,
                                 bridge=jax_bridge, top=jt),
    "torch": types.SimpleNamespace(reg=registry, tracing=tracing, events=events, health=health, costs=costs,
                                   agg=agg, flight=flight, ops=ops_plane, prof=profiler, bridge=bridge, top=tt),
}
SINGLETONS = (("reg", "_REGISTRY"), ("tracing", "_TRACER"), ("events", "_EVENT_LOG"), ("health", "_MONITOR"),
              ("costs", "_ACCOUNTANT"), ("flight", "_RECORDER"), ("prof", "_PROFILER"), ("agg", "_RANK_STAMP"))


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' telemetry singletons made anew for one test, and the
    previous ones restored after it (other tests hold their handles)."""
    for ns in PKGS.values():
        for mod, name in SINGLETONS:
            monkeypatch.setattr(getattr(ns, mod), name, None)
    monkeypatch.setattr(profiler, "_WINDOWS", [])
    return PKGS


def _both(fn):
    """``fn(ns)`` for the JAX package and the port; returns (jax, torch)."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


def _strip(d, keys=("ts_unix", "rank")):
    return {k: v for k, v in d.items() if k not in keys}


# ---------------------------------------------------------------- knobs
def test_port_knobs_match_reference_defaults():
    """Every telemetry knob the port declares has the reference's default and type."""
    names = [n for n in knobs.all_knobs() if knobs.all_knobs()[n].owner.startswith(("telemetry/", "runtime/engine"))]
    assert len(names) >= 20
    for n in names:
        mine, ref = knobs.all_knobs()[n], jax_knobs.all_knobs()[n]
        assert (mine.default, mine.kind) == (ref.default, ref.kind), n


# ------------------------------------------------------------- registry
def _registry_ops(ns):
    reg = ns.reg.MetricsRegistry()
    reg.counter("infer_requests_total").inc(3)
    reg.counter("health_alerts_total", detector="nan_loss").inc()
    reg.gauge("kv_block_occupancy").set(0.25)
    h = reg.histogram("infer_ttft_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v)
    return reg


def test_registry_series_and_snapshot_match_reference():
    want, got = _both(_registry_ops)
    assert list(got.series()) == list(want.series())
    assert _strip(got.snapshot()) == _strip(want.snapshot())
    assert set(got.snapshot()["rank"]) == set(want.snapshot()["rank"])
    json.dumps(got.snapshot())


# ---------------------------------------------------------------- spans
def _span_ops(ns):
    tr = ns.tracing.SpanTracer(capacity=3, registry=ns.reg.MetricsRegistry())
    with tr.span("train/step"):
        with tr.span("train/forward", micro=0):
            pass
        with tr.span("train/backward"):
            pass
    first = [(s["name"], s["depth"], s["attrs"]) for s in tr.spans()]
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    with tr.span("after", k=1):
        pass
    return first, [(s["name"], s["depth"], s["attrs"]) for s in tr.spans()], tr


def test_span_tracer_matches_reference(tmp_path):
    (w1, w2, wt), (g1, g2, gt) = _both(_span_ops)
    assert g1 == w1 == [("train/forward", 1, {"micro": 0}), ("train/backward", 1, {}), ("train/step", 0, {})]
    assert g2 == w2  # ring of 3, the exception's span kept, depth restored
    for fmt in ("trace.json", "trace.jsonl"):
        want_path, got_path = tmp_path / f"jax_{fmt}", tmp_path / f"torch_{fmt}"
        wt.dump_trace(want_path)
        gt.dump_trace(got_path)
        if fmt.endswith(".jsonl"):
            rows = [[{k: v for k, v in json.loads(line).items() if k not in ("start_s", "dur_s", "tid")}
                     for line in p.read_text().splitlines()] for p in (want_path, got_path)]
        else:
            rows = [[{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
                     for e in json.loads(p.read_text())["traceEvents"]] for p in (want_path, got_path)]
        assert rows[1] == rows[0]
    off = tracing.SpanTracer(enabled=False, registry=registry.MetricsRegistry())
    assert off.span("a") is off.span("b", k=1) is tracing._NULL_SPAN


def test_blocking_span_on_the_cpu_needs_no_device():
    tr = tracing.SpanTracer(registry=registry.MetricsRegistry())
    with tr.span("infer/decode", blocking=True, rows=2):
        pass
    assert tr.spans()[0]["attrs"] == {"rows": 2}
    assert not torch.cuda.is_initialized()  # a blocking span never initialises CUDA


def test_mirrored_spans_land_in_a_torch_profiler_trace(tmp_path):
    """DS_TPU_TRACE_XLA's port: spans become record_function ranges that a
    torch.profiler trace shows; a span that mirrored pops its range even if
    mirroring is switched off before it ends."""
    tr = tracing.SpanTracer(annotate_xla=True, registry=registry.MetricsRegistry())
    handle = profiler.start_trace(str(tmp_path))
    with tr.span("infer/prefill", rows=1):
        with tr.span("infer/prefix_match"):
            tr.annotate_xla = False
    path = profiler.stop_trace(handle, str(tmp_path))
    names = [e["name"] for e in json.load(open(path))["traceEvents"] if e.get("cat") == "user_annotation"]
    assert names.count("infer/prefill") == 1 and names.count("infer/prefix_match") == 1
    assert not getattr(tracing._TLS, "ranges", [])


# --------------------------------------------------------------- events
def test_event_log_listeners_match_reference():
    def run(ns):
        log = ns.events.EventLog(capacity=8, registry=ns.reg.MetricsRegistry())
        seen = []
        log.add_listener(lambda ts, kind, uid, attrs: seen.append((ts, kind, uid, dict(attrs))))
        log.add_listener(lambda *a: 1 / 0)  # a broken listener never reaches the emitter
        log.emit("enqueue", 1, ts=1.0, prompt=3)
        log.emit("admit", 1, ts=2.0, hit=0)
        return seen

    want, got = _both(run)
    assert got == want and len(got) == 2


# ------------------------------------------------------------- detectors
def _det_cases(ns):
    h = ns.health
    nan = float("nan")
    return {
        "nan_loss_cooldown": (h.NonFiniteLossDetector(cooldown_s=3600.0),
                              [("observe", 1.0), ("observe", nan)] + [("observe", nan)] * 5 +
                              [("observe", 2.0), ("observe", float("inf")), ("reset",), ("observe", float("inf"))]),
        "nan_loss_refire": (h.NonFiniteLossDetector(cooldown_s=0.0),
                            [("observe", nan), ("observe", 1.0), ("observe", nan)]),
        "grad_norm_spike": (h.GradNormSpikeDetector(spike_ratio=10.0, warmup=4, cooldown_s=0.0),
                            [("observe", 1.0)] * 6 + [("observe", 100.0), ("observe", 100.0), ("observe", 1.0),
                                                      ("observe", 100.0), ("observe", nan)]),
        "grad_norm_warmup": (h.GradNormSpikeDetector(spike_ratio=10.0, warmup=8, cooldown_s=0.0),
                             [("observe", 1.0), ("observe", 50.0)]),
        "queue_stall": (h.QueueStallDetector(stall_s=0.05, cooldown_s=0.0),
                        [("poll", 100.0), ("on_event", 100.0, "enqueue", 1, {}), ("on_event", 100.0, "enqueue", 2, {}),
                         ("poll", 100.04), ("poll", 100.2), ("poll", 100.3), ("on_event", 100.35, "admit", 1, {}),
                         ("poll", 100.36), ("poll", 100.5), ("on_event", 100.6, "finish", 2, {}), ("poll", 200.0)]),
        "slo_burn": (h.SLOBurnRateDetector(ttft_sla_s=1.0, tpot_sla_s=0.25, window=8, burn_threshold=0.5,
                                           min_count=4, cooldown_s=0.0),
                     [("observe", 5.0, 5.0)] * 5 + [("observe", 0.1, 0.01)] * 8 + [("observe", 9.0, 9.0)] * 8),
        "hbm_pressure": (h.HBMPressureDetector(threshold=0.9, hysteresis=0.8, cooldown_s=0.0),
                         [("observe", 0.85), ("observe", 0.95), ("observe", 0.99), ("observe", 0.85),
                          ("observe", 0.5), ("observe", 0.95), ("observe", nan)]),
    }


def _drive(det, ops):
    """Alerts (detector, severity, message, attrs) and the latch, op by op."""
    out = []
    for op, *args in ops:
        alert = det.reset() if op == "reset" else getattr(det, op)(*args)
        out.append((None if alert is None else (alert.detector, alert.severity, alert.message, alert.attrs),
                    det.firing))
    return out


@pytest.mark.parametrize("case", sorted(_det_cases(PKGS["torch"])))
def test_detectors_alert_like_the_reference(case):
    want, got = _both(lambda ns: _drive(*_det_cases(ns)[case]))
    assert got == want
    # the warm-up case is the one whose sequence must stay silent
    assert any(a is not None for a, _ in got) == (case != "grad_norm_warmup")


def _monitor(ns):
    reg = ns.reg.MetricsRegistry()
    ev = ns.events.EventLog(registry=reg)
    got = []
    hm = ns.health.HealthMonitor(registry=reg, event_log=ev, sinks=[ns.health.CallbackAlertSink(got.append)])
    ev.add_listener(hm.on_event)
    return hm, reg, ev, got


def _monitor_story(ns):
    """NaN losses, a stalled queue, an external alert with a broken sink,
    the straggler detector: alerts, status and counters after each part."""
    hm, reg, ev, got = _monitor(ns)
    h = ns.health
    hm.ensure_detector(h.NonFiniteLossDetector(cooldown_s=0.0))
    hm.ensure_detector(h.QueueStallDetector(stall_s=0.03, cooldown_s=0.0))
    first = hm.ensure_detector(h.SLOBurnRateDetector(min_count=2, cooldown_s=0.0))
    assert hm.ensure_detector(h.SLOBurnRateDetector()) is first  # idempotent
    trail = []

    def note():
        trail.append((reg.peek("health_status"), hm.healthy, [(a.detector, a.message, a.attrs) for a in got]))

    for _ in range(5):
        hm.observe_loss(float("nan"))
    note()
    hm.observe_loss(0.5)
    note()
    ev.emit("enqueue", 1, ts=50.0, prompt=4)
    for now in (50.1, 50.2, 50.3):
        hm.poll(now=now)
    note()
    ev.emit("admit", 1, ts=50.4, hit=0)
    hm.poll(now=50.41)
    note()
    hm.observe_request(5.0, 5.0)
    hm.observe_request(5.0, 5.0)
    note()
    hm.add_sink(lambda a: 1 / 0)
    hm.raise_alert("dataloader", "shard unreadable", severity="error", shard=3)
    note()
    hm.resolve("dataloader")
    fast = [0.002] * 20
    hm.observe_rank_snapshots([_snap(ns, 0, 2, 1, fast), _snap(ns, 1, 2, 1, [0.9] * 20)])
    note()
    alerts = [{k: v for k, v in e.items() if k != "ts"} for e in ev.events(kind="alert")]
    counts = {d: reg.peek("health_alerts_total", detector=d) for d in
              ("nan_loss", "queue_stall", "slo_burn", "dataloader", "comm_straggler")}
    hm.reset()
    return trail, alerts, counts, hm.healthy


def test_health_monitor_matches_reference():
    want, got = _both(_monitor_story)
    assert got == want
    assert got[2]["nan_loss"] == 1 and got[2]["comm_straggler"] == 1 and got[3]


def test_jsonl_alert_sink_matches_reference(tmp_path):
    def run(ns):
        path = tmp_path / f"{ns.health.__name__}.jsonl"
        sink = ns.health.JsonlAlertSink(str(path))
        sink(ns.health.Alert(detector="d1", severity="error", message="m", ts_unix=1.0, attrs={"k": 1}))
        sink(ns.health.Alert(detector="d2", severity="warning", message="n", ts_unix=2.0))
        return [json.loads(line) for line in path.read_text().splitlines()]

    want, got = _both(run)
    assert got == want


# ----------------------------------------------------------- aggregation
def _snap(ns, rank_idx, n_ranks, steps, latencies):
    reg = ns.reg.MetricsRegistry()
    reg.counter("train_steps_total").inc(steps)
    reg.gauge("kv_block_occupancy").set(0.1 * (rank_idx + 1))
    h = reg.histogram("comm_latency_seconds", buckets=(0.001, 0.01, 0.1, 1.0), op="all_reduce")
    for lat in latencies:
        h.observe(lat)
    h2 = reg.histogram("comm_latency_seconds", buckets=(0.001, 0.01, 0.1, 1.0), op="all_gather")
    h2.observe(latencies[0] if latencies else 0.0)
    snap = reg.snapshot()
    snap["rank"] = {"process_index": rank_idx, "process_count": n_ranks, "device_kind": "cpu"}
    snap["ts_unix"] = float(rank_idx)
    return snap


def test_merge_quantile_and_stragglers_match_reference():
    def run(ns):
        a = ns.agg
        s = [_snap(ns, 0, 4, 3, [0.002] * 20), _snap(ns, 1, 4, 4, [0.002] * 12),
             _snap(ns, 2, 4, 1, [0.5] * 20), _snap(ns, 3, 4, 2, [0.005] * 9)]
        merged = a.merge_snapshots(s)
        quantiles = [a.histogram_quantile(h, q) for h in merged["histograms"].values() for q in (0.1, 0.5, 0.99)]
        cold = list(s)
        cold[2] = _snap(ns, 2, 4, 1, [0.5] * 2)
        bad = [_snap(ns, 0, 2, 1, [0.005]), _snap(ns, 1, 2, 1, [0.005])]
        bad[1]["histograms"]['comm_latency_seconds{op="all_reduce"}']["buckets"] = {"0.5": 1, "+Inf": 1}
        with pytest.raises(ValueError, match="bucket edges differ"):
            a.merge_snapshots(bad)
        return (merged, quantiles, a.comm_wait_profile(s[0]), a.detect_stragglers(s, ratio=4.0),
                a.detect_stragglers(cold, ratio=4.0), a.detect_stragglers(s[:2], ratio=1.0, min_count=100),
                a.histogram_quantile({"sum": 0, "count": 0, "buckets": {}}, 0.5), a.parse_series(
                    'x_total{op="a\\"b",k="v"}'))

    want, got = _both(run)
    assert got == want
    assert [r["rank"] for r in got[3]["stragglers"]] == ["2"] and got[4]["stragglers"] == []


def test_rank_snapshot_files_merge(tmp_path, fresh):
    reg = registry.MetricsRegistry()
    reg.counter("train_steps_total").inc(3)
    path = agg.write_rank_snapshot(str(tmp_path), registry=reg)
    assert os.path.basename(path) == "telemetry-rank0.json"
    stamp = agg.rank_stamp()
    assert stamp["process_index"] == 0 and stamp["process_count"] == 1
    assert stamp["device_kind"] == (torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu")
    merged = agg.merge_snapshot_files([path])
    assert merged["counters"]["train_steps_total"] == 3 and merged["n_ranks"] == 1


# ---------------------------------------------------- bridge and monitors
class _FakeMonitor:
    def __init__(self, enabled=True):
        self.enabled = enabled
        self.calls = []

    def write_events(self, events):
        self.calls.append(list(events))


def test_bridge_matches_reference():
    def run(ns):
        reg = _registry_ops(ns)
        mon = _FakeMonitor()
        b = ns.bridge.MonitorBridge(reg, mon, every_n_steps=3)
        for step in range(1, 7):
            b.maybe_flush(step, extra_events=[("Train/Samples/lr", 0.01, step)])
        reg.enabled = False
        b.flush(7, extra_events=[("Train/Samples/train_loss", 2.0, 7)])
        ns.bridge.MonitorBridge(reg, None).maybe_flush(3)
        ns.bridge.MonitorBridge(reg, _FakeMonitor(enabled=False)).maybe_flush(3)
        return mon.calls

    want, got = _both(run)
    assert got == want and len(got) == 3


def test_csv_monitor_writes_the_reference_files(tmp_path):
    from deepspeed_tpu.monitor import CsvMonitor as JaxCsv, MonitorMaster as JaxMaster
    from deepspeed_tpu_torch.monitor import CsvMonitor, MonitorMaster, csvMonitor

    assert csvMonitor is CsvMonitor
    events_ = [("Train/Samples/lr", 0.01, 8), ("Telemetry/infer_mfu", 0.5, 1), ("Train/Samples/lr", 0.02, 16)]
    trees = []
    for cls, sub in ((JaxCsv, "jax"), (CsvMonitor, "torch")):
        cfg = types.SimpleNamespace(enabled=True, output_path=str(tmp_path / sub), job_name="job")
        cls(cfg).write_events(events_)
        root = tmp_path / sub / "job"
        trees.append({f: list(csv.reader(open(root / f))) for f in sorted(os.listdir(root))})
    assert trees[1] == trees[0] and len(trees[0]) == 2
    off = types.SimpleNamespace(enabled=False)
    for master in (JaxMaster, MonitorMaster):
        m = master(types.SimpleNamespace(tensorboard=off, wandb=off, csv_monitor=off))
        assert not m.enabled
        m.write_events([("a", 1.0, 0)])


def test_missing_writer_package_degrades_with_a_warning(caplog, monkeypatch):
    import builtins

    from deepspeed_tpu_torch.monitor import WandbMonitor

    real_import = builtins.__import__

    def no_wandb(name, *a, **kw):
        if name == "wandb":
            raise ImportError("No module named 'wandb'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    cfg = types.SimpleNamespace(enabled=True, project="p", group=None, team=None)
    with caplog.at_level("WARNING"):
        m = WandbMonitor(cfg)
    assert not m.enabled and "wandb unavailable" in caplog.text
    m.write_events([("a", 1.0, 0)])


# ------------------------------------------------------------ accountant
def _acct_story(ns, monkeypatch):
    """The same attribute / note_* / set_hbm calls on each package's
    accountant; the port's card gets the JAX card's FLOPs and bytes."""
    monkeypatch.setenv("DS_TPU_PEAK_TFLOPS", "1e-3")
    monkeypatch.setenv("DS_TPU_PEAK_GBPS", "1")
    acct = ns.costs.PerfAccountant(mode=1, use_telemetry=False)
    x, y = np.ones((8, 16), np.float32), np.ones((16, 4), np.float32)
    if ns is PKGS["jax"]:
        mm = jax.jit(lambda a, b: a @ b)
        run = lambda a, b: jax.block_until_ready(mm(jnp.asarray(a), jnp.asarray(b)))  # noqa: E731
        kw = {}
    else:
        run = lambda a, b: torch.from_numpy(a) @ torch.from_numpy(b)  # noqa: E731

        def cost(a, b):
            m, k = a.shape
            n = b.shape[1]
            return {"flops": 2 * m * k * n, "macs": m * k * n, "arg_bytes": (a.size + b.size) * 4,
                    "out_bytes": m * n * 4}
        kw = {"cost": cost}
    verify = acct.wrap("spec4", run, meta={"kind": "test"}, **kw)
    prefill = acct.wrap("prefill", run, **kw)
    cow = acct.wrap("cow_copy", run, timed=False, **kw)
    verify(x, y)
    cow(x, y)  # mid-window: cannot steal the verify's window
    acct.attribute(4, 8)
    acct.note_spec(proposed=10, accepted=6)
    prefill(x, y)
    acct.attribute(8, 16)
    prefill(np.ones((4, 16), np.float32), y)  # another signature: another card
    acct.attribute(3, 4)
    acct.attribute(1, 1)  # no window open: dropped
    acct.note_prefix_hit(32)
    acct.note_readmit(16)
    acct.note_cow(4096)
    pressure = acct.set_hbm(limit=1000, weights=500, kv_pages=300, prefix=100, host_spill=7)
    snap = acct.snapshot()
    volatile = ("time_s", "achieved_tflops", "achieved_gbps", "pct_peak_flops", "pct_peak_bw", "signature",
                "attn_flops")
    cards = sorted(({k: v for k, v in c.items() if k not in volatile} for c in snap["cards"]),
                   key=lambda c: (c["program"], c["flops"]))
    totals = {k: v for k, v in acct.totals().items() if k != "time_s"}
    out = (totals, acct.ledger(), pressure, acct.hbm(), cards, snap["peaks"], snap["mode"],
           acct.mfu(flops=1e9, time_s=2.0), {c["program"]: c["intensity_flops_per_byte"] for c in cards})
    acct.reset_counts()
    kept = len(acct.cards())
    acct.reset()
    return out + (kept, len(acct.cards()), acct.totals()["flops"])


def test_accountant_matches_reference(monkeypatch):
    want, got = _both(lambda ns: _acct_story(ns, monkeypatch))
    assert got == want
    ledger = got[1]
    assert ledger["spec_rejected_tokens"] == 4 and ledger["cow_copy_bytes"] == 4096
    assert ledger["prefix_saved_prefill_flops"] > 0 and ledger["readmit_saved_prefill_flops"] > 0
    assert got[2] == pytest.approx(0.8) and got[7] == pytest.approx(0.5)
    assert got[-3:] == (4, 0, 0.0)  # reset_counts kept the four cards, reset dropped them


def test_accountant_attention_flops_ride_the_window(monkeypatch):
    """The port's per-call attention FLOPs add to the card's timed calls,
    the totals and the ledger's pricing (the reference has no such term)."""
    acct = costs.PerfAccountant(mode=1, use_telemetry=False)
    step = acct.wrap("prefill", lambda n: n, signature=lambda n: "bucket",
                     cost=lambda n: {"flops": 100, "macs": 50, "attn_flops": n})
    for n in (10, 30):
        step(n)
        acct.attribute(4, 8)
    (card,) = acct.cards().values()
    assert (card.flops, card.attn_flops, card.model_flops()) == (100, 40, 240)
    assert acct.totals()["flops"] == 240
    acct.note_prefix_hit(8)
    assert acct.ledger()["prefix_saved_prefill_flops"] == 8 * 240 // 16


def test_accountant_modes_and_identity(monkeypatch, caplog):
    off = costs.PerfAccountant(mode=0, use_telemetry=False)
    fn = lambda x: x  # noqa: E731
    assert off.wrap("x", fn) is fn and off.set_hbm(limit=10, weights=5) == 0.0
    with caplog.at_level("WARNING"):
        two = costs.PerfAccountant(mode=2, use_telemetry=False)
    assert two.mode == 1 and two.enabled and "no counterpart" in caplog.text
    w = two.wrap("raw", lambda a: a + 1)
    w(torch.ones(3))
    (card,) = two.cards().values()
    assert card.source == "unavailable" and card.arg_bytes == 12 and card.out_bytes == 12


def test_resolve_peaks_knobs_and_card_table(monkeypatch):
    monkeypatch.setenv("DS_TPU_PEAK_TFLOPS", "100")
    monkeypatch.setenv("DS_TPU_PEAK_GBPS", "1000")
    assert costs.resolve_peaks() == jax_costs.resolve_peaks() == (100e12, 1000e9)
    monkeypatch.delenv("DS_TPU_PEAK_TFLOPS")
    monkeypatch.delenv("DS_TPU_PEAK_GBPS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", (989e12, 3350e9)), ("NVIDIA H100 PCIe", (756e12, 2000e9)),
                       ("NVIDIA A100-SXM4-80GB", (0.0, 0.0))):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, _n=name: _n)
        assert costs.resolve_peaks() == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    acct = costs.PerfAccountant(mode=1, use_telemetry=False)
    assert acct.peaks() == (0.0, 0.0) and acct.mfu(flops=1e9, time_s=1.0) is None


# -------------------------------------------------------------- profiler
def test_reference_fixture_parses_like_the_reference():
    doc = json.load(open(FIXTURE))
    want, got = jax_prof.parse_trace_events(doc), profiler.parse_trace_events(doc)
    assert got == want
    cats = {}
    for e in got["events"]:
        cats[e["cat"]] = cats.get(e["cat"], 0) + 1
    assert cats == {"compute": 3, "collective": 2, "transfer": 1, "infra": 1, "host": 1}


@pytest.mark.parametrize("marks", [(), (2000, 4000), (500, 2600, 3900)], ids=["window", "two", "three"])
def test_waterfall_matches_reference(marks):
    doc = json.load(open(FIXTURE))
    markers = [{"program": "fused_step", "rel_s": m * US, "attrs": {"rows": i}} for i, m in enumerate(marks)]
    want = jax_prof.build_waterfall(jax_prof.parse_trace_events(doc), markers, window_s=4000 * US,
                                    ledger={"source": "counter"})
    got = profiler.build_waterfall(profiler.parse_trace_events(doc), markers, window_s=4000 * US,
                                   ledger={"source": "counter"})
    assert got.pop("host_spans") == []  # the port's extra key: no span ranges in this trace
    assert got == want
    assert got["totals"]["compute_s"] == pytest.approx(1600 * US)
    assert got["totals"]["collective_exposed_s"] == pytest.approx(500 * US)


def _torch_trace():
    """A synthetic trace in torch.profiler's (Kineto's) format: host lanes,
    kernels (one nccl), a memcpy and a memset, a GPU annotation range over
    the kernels, a replayed graph's launch and its kernels, the capture's
    markers and a mirrored span."""
    base = 1_700_000_000_000.0  # Kineto stamps are absolute microseconds

    def x(cat, name, ts, dur, pid=1, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": base + ts, "dur": dur}

    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        x("Trace", "PyTorch Profiler (0)", 0, 5000),
        x("user_annotation", profiler.MARK_BEGIN, 100, 0),
        x("python_function", "engine_v2.py(700): _run_fused", 100, 2000),
        x("cpu_op", "aten::mm", 150, 300),
        x("cuda_runtime", "cudaGraphLaunch", 300, 50),
        x("user_annotation", "infer/graph_capture", 400, 700),
        x("kernel", "void paged_decode_kernel<128>(...)", 400, 1000, pid=0, tid=7),
        x("kernel", "ampere_bf16_s16816gemm", 1500, 500, pid=0, tid=7),
        x("kernel", "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevComm*)", 1800, 400, pid=0, tid=8),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 2300, 200, pid=0, tid=9),
        x("gpu_memset", "Memset (Device)", 2600, 100, pid=0, tid=9),
        x("gpu_user_annotation", "infer/fused_step", 400, 1600, pid=0, tid=10),
        x("user_annotation", f"{profiler.MARK_QUANTUM}0/fused_step", 2100, 0),
        x("kernel", "void rms_norm_rows_kernel(...)", 3000, 500, pid=0, tid=7),
        x("user_annotation", f"{profiler.MARK_QUANTUM}1/decode", 3600, 0),
        x("user_annotation", profiler.MARK_END, 4100, 0),
        x("kernel", "late_kernel_after_the_window", 4200, 300, pid=0, tid=7),
        {"ph": "i", "s": "g", "name": "Record Window End", "pid": "", "tid": "", "ts": base + 5000},
    ]}


def test_torch_trace_lanes_and_trace_clock_quanta():
    parsed = profiler.parse_trace_events(_torch_trace())
    cats = {}
    for e in parsed["events"]:
        cats[e["name"]] = e["cat"]
    assert cats["void paged_decode_kernel<128>(...)"] == "compute"
    assert cats["ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevComm*)"] == "collective"
    assert cats["Memcpy HtoD (Pinned -> Device)"] == cats["Memset (Device)"] == "transfer"
    assert cats["infer/fused_step"] == "infra"  # a GPU annotation range is not device time
    for host in ("aten::mm", "cudaGraphLaunch", "engine_v2.py(700): _run_fused", "PyTorch Profiler (0)",
                 profiler.MARK_BEGIN):
        assert cats[host] == "host"
    begin, end, times = profiler.trace_markers(parsed)
    assert (end - begin, [t - begin for t in times]) == (pytest.approx(4000 * US),
                                                         [pytest.approx(2000 * US), pytest.approx(3500 * US)])
    window = profiler.rebase(parsed, begin, end - begin)
    markers = [{"program": p, "rel_s": t - begin, "attrs": {}} for p, t in zip(("fused_step", "decode"), times)]
    s = profiler.build_waterfall(window, markers, window_s=end - begin)
    t = s["totals"]
    # compute: [300,1300] + [1400,1900] + [2900,3400] (us after begin); the late kernel is outside the window
    assert t["compute_s"] == pytest.approx(2000 * US)
    assert t["collective_s"] == pytest.approx(400 * US) and t["collective_exposed_s"] == pytest.approx(200 * US)
    assert t["transfer_s"] == pytest.approx(300 * US)
    assert t["device_busy_s"] == pytest.approx(2500 * US)
    assert s["fractions"]["device_busy"] == pytest.approx(2500 / 4000)
    q0, q1 = s["quanta"]
    assert (q0["program"], q1["program"]) == ("fused_step", "decode")
    assert q0["device_busy_s"] == pytest.approx(1600 * US) and q1["compute_s"] == pytest.approx(500 * US)
    assert s["host_spans"] == [["infer/graph_capture", pytest.approx(700 * US)]]
    assert [p[0] for p in s["programs"]][:2] == ["void paged_decode_kernel<128>(...)", "ampere_bf16_s16816gemm"]


def _fake_trace_seams(prof):
    """Stand-in seams that land the reference's fixture where a trace would go."""
    def start(trace_dir):
        dst = os.path.join(trace_dir, "plugins", "profile", "2026_01_01")
        os.makedirs(dst, exist_ok=True)
        shutil.copy(FIXTURE, os.path.join(dst, "host.trace.json"))
    prof._start_trace = start
    prof._stop_trace = lambda: None
    return prof


def _lifecycle(ns, tmp_path):
    prof = _fake_trace_seams(ns.prof.DeviceProfiler(out_dir=str(tmp_path / ns.prof.__name__), quanta=2))
    prof.note_quantum("fused_step")  # idle: a no-op
    steps = [prof.status()["n_markers"], prof.arm()]
    for rows in (4, 4, 3):
        prof.note_quantum("fused_step", rows=rows)
        steps.append(prof.state)
    s = prof.summary()
    short = _fake_trace_seams(ns.prof.DeviceProfiler(out_dir=str(tmp_path / "short"), quanta=100))
    short.arm()
    short.note_quantum("decode")
    short.note_quantum("decode")
    fin = short.finish()
    return (steps, prof.captures, s["trace"], s["n_quanta"], s["quanta"][0]["attrs"], s["totals"], s["fractions"],
            fin["n_quanta"], short.state)


def test_profiler_lifecycle_matches_reference(tmp_path, fresh):
    want, got = _both(lambda ns: _lifecycle(ns, tmp_path))
    assert got == want
    assert got[1] == 1 and got[2] == "ok" and got[3] == 2


def test_real_cpu_capture_cuts_quanta_on_the_trace_clock(tmp_path, fresh):
    """A live torch.profiler session on the CPU: the quanta come from the
    in-trace markers, the spans of the window are named, the gauges land."""
    prof = profiler.DeviceProfiler(out_dir=str(tmp_path), quanta=3)
    assert prof.arm()
    tr = tracing.get_tracer()
    profiler_marks = []
    for i in range(4):
        with tr.span("infer/fused_step", rows=i):
            torch.ones(64, 64) @ torch.ones(64, 64)
        prof.note_quantum("fused_step", rows=i)
        profiler_marks.append(prof.state)
    s = prof.summary()
    assert profiler_marks == ["tracing", "tracing", "tracing", "idle"]
    assert (s["trace"], s["marker_clock"], s["n_quanta"]) == ("ok", "trace", 3)
    assert [q["attrs"] for q in s["quanta"]] == [{"rows": 1}, {"rows": 2}, {"rows": 3}]
    assert s["totals"]["device_busy_s"] == 0.0  # no device on the CPU: all host gap
    assert [n for n, _ in s["host_spans"]] == ["infer/fused_step"]
    assert not tr.annotate_xla  # mirroring restored after the capture
    reg = tt.get_registry()
    assert reg.peek("profile_captures_total") == 1 and reg.peek("profile_host_gap_fraction") == 1.0
    assert os.path.isfile(os.path.join(s["trace_dir"], "summary.json"))
    assert profiler.find_trace_files(s["trace_dir"])
    path = prof.write_rank_summary(str(tmp_path / "merge"))
    assert json.load(open(path))["summary"]["n_quanta"] == 3


def test_second_capture_while_a_session_runs_degrades(tmp_path, fresh):
    """Only one torch.profiler session can run: a capture armed while one
    does (here the caller's) gets a marker-only summary, and the running
    session is left running."""
    handle = profiler.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiler.start_trace(str(tmp_path))
        prof = profiler.DeviceProfiler(out_dir=str(tmp_path / "cap"), quanta=2)
        prof.arm()
        for _ in range(3):
            prof.note_quantum("decode")
        s = prof.summary()
        assert (s["trace"], s["marker_clock"], s["n_quanta"]) == ("unavailable", "host", 2)
        assert torch.autograd._profiler_enabled()
    finally:
        profiler.stop_trace(handle, str(tmp_path))


def test_module_hooks_arm_and_windows(tmp_path, monkeypatch, fresh):
    monkeypatch.setenv("DS_TPU_PROFILE", "0")
    assert profiler.maybe_arm_profiler() is None
    profiler.note_quantum("decode")  # no profiler: a no-op
    monkeypatch.setenv("DS_TPU_PROFILE", "1")
    monkeypatch.setenv("DS_TPU_PROFILE_DIR", str(tmp_path / "caps"))
    monkeypatch.setenv("DS_TPU_PROFILE_QUANTA", "2")
    prof = _fake_trace_seams(profiler.maybe_arm_profiler())
    assert prof.state == "armed" and prof.quanta_target == 2
    for _ in range(3):
        profiler.note_quantum("decode")
    assert prof.captures == 1 and profiler.maybe_arm_profiler().state == "idle"  # not re-armed
    got = []
    win = profiler.open_window(str(tmp_path / "flight"), "profile", 0.0, got.append)
    _fake_trace_seams(win)
    profiler.note_quantum("decode")  # starts the window
    profiler.note_quantum("decode")  # its seconds (0) have passed: it closes
    assert len(got) == 1 and got[0]["n_quanta"] == 1 and profiler._WINDOWS == []


# ------------------------------------------------------------- ops plane
def _ops_state(ns, tmp_path, monkeypatch):
    """The same registry, events, detector, accountant and profiler state
    in each package, then every endpoint: status and JSON keys."""
    monkeypatch.setenv("DS_TPU_FLIGHT_DIR", str(tmp_path / f"flight_{ns.prof.__name__}"))
    reg = ns.reg.get_registry()
    reg.counter("infer_requests_total").inc(2)
    log = ns.events.get_event_log()
    for uid in (0, 1):
        log.emit("enqueue", uid, ts=1.0, prompt=4)
        log.emit("admit", uid, ts=1.1, hit=0)
        log.emit("first_token", uid, ts=1.5)
        log.emit("finish", uid, ts=2.0, n_new=3)
    hm = ns.health.get_health_monitor()
    hm.ensure_detector(ns.health.NonFiniteLossDetector(cooldown_s=0.0))
    plane = ns.ops.OpsPlane()

    def call(method, path, body=b""):
        status, ctype, payload = plane.handle(method, path, body)
        if ctype.startswith("application/json"):
            doc = json.loads(payload.decode())
            return status, sorted(doc) if isinstance(doc, dict) else type(doc).__name__
        return status, ctype

    paths = ["/", "/metrics", "/healthz", "/requests", "/requests/0", "/requests/x", "/requests/99", "/perf",
             "/journal", "/varz", "/profile", "/flight", "/flight/nope", "/bogus"]
    out = {p: call("GET", p) for p in paths}
    hm.observe_loss(float("nan"))
    out["/healthz unhealthy"] = call("GET", "/healthz")
    out["POST /flight/capture"] = call("POST", "/flight/capture", b'{"reason": "unit"}')
    name = ns.flight.get_flight_recorder().captures()[0]["name"]
    out["/flight/<name>"] = call("GET", f"/flight/{name}")
    out["POST /profile/capture bad"] = call("POST", "/profile/capture", b"not json")
    out["POST /profile/capture"] = call("POST", "/profile/capture", b'{"quanta": 2}')
    _fake_trace_seams(ns.prof.get_device_profiler()).out_dir = str(tmp_path / f"prof_{ns.prof.__name__}")
    ns.prof.note_quantum("decode")
    out["POST /profile/capture busy"] = call("POST", "/profile/capture")
    for _ in range(2):
        ns.prof.note_quantum("decode")
    out["/profile after"] = call("GET", "/profile")
    out["PUT"] = call("POST", "/metrics")
    out["perf ledger keys"] = sorted(json.loads(plane.handle("GET", "/perf")[2])["ledger"])
    out["endpoints"] = json.loads(plane.handle("GET", "/")[2])["endpoints"]
    return out


def test_ops_plane_endpoints_match_reference(tmp_path, monkeypatch, fresh):
    want, got = _both(lambda ns: _ops_state(ns, tmp_path, monkeypatch))
    assert got == want
    assert got["/healthz"][0] == 200 and got["/healthz unhealthy"][0] == 503
    assert got["POST /profile/capture busy"][0] == 409 and got["POST /flight/capture"][0] == 201


def test_ops_server_live_on_loopback(fresh):
    srv = ops_plane.OpsServer(port=0, host="127.0.0.1").start()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # loopback only: never a proxy
    try:
        tt.get_registry().counter("infer_requests_total").inc()
        base = f"http://127.0.0.1:{srv.port}"
        body = opener.open(base + "/metrics", timeout=30).read().decode()
        assert "infer_requests_total 1" in body
        for path in ("/healthz", "/perf", "/profile"):
            doc = json.loads(opener.open(base + path, timeout=30).read())
            assert "rank" in doc
        # concurrent scrapes from several threads
        errors = []

        def scrape():
            try:
                opener.open(base + "/requests", timeout=30).read()
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)
        threads = [threading.Thread(target=scrape) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
    finally:
        srv.stop()


def test_ops_port_unset_starts_nothing(monkeypatch, fresh):
    monkeypatch.setenv("DS_TPU_OPS_PORT", "0")
    before = threading.active_count()
    assert ops_plane.maybe_start_ops_server() is None and ops_plane.get_ops_server() is None
    assert threading.active_count() == before


# ---------------------------------------------------------------- flight
def _flight_story(ns, tmp_path):
    rec = ns.flight.FlightRecorder(str(tmp_path / f"ring_{ns.prof.__name__}"), max_captures=3, profile_s=0.0)
    rec.register_provider("residency", lambda: {"kv_blocks_free": 3})
    rec.register_provider("broken", lambda: 1 / 0)
    hm, _, _, _ = _monitor(ns)
    hm.add_sink(rec)
    hm.ensure_detector(ns.health.NonFiniteLossDetector(cooldown_s=0.0))
    for _ in range(5):
        hm.observe_loss(float("nan"))  # one episode: one capture
    first = rec.captures()
    for i in range(5):
        rec.capture(reason=f"Manual {i}!")
    listing = rec.captures()
    manifest = rec.read_manifest(listing[0]["name"])
    return (len(first), first[0]["reason"], [c["reason"] for c in listing], sorted(manifest),
            manifest["residency"], manifest["broken"], manifest["alert"] and manifest["alert"]["detector"],
            sorted(manifest["journal"]), manifest["tuned_profile"], rec.read_manifest("../etc"),
            rec.read_manifest("capture-00000-nan_loss"))


def test_flight_recorder_matches_reference(tmp_path):
    want, got = _both(lambda ns: _flight_story(ns, tmp_path))
    assert got == want
    assert got[0] == 1 and got[2] == ["manual_4", "manual_3", "manual_2"]
    assert "knobs" in got[3] and "perf" in got[3] and "spans_tail" in got[3]


def test_flight_profile_window_lands_in_the_manifest(tmp_path, monkeypatch, fresh):
    """The post-anomaly window starts and closes at quantum boundaries on
    the serving thread (a live CPU session here) and links its summary and
    raw trace from the manifest; over the size bound the trace is dropped."""
    for max_mb, dropped in (("64", False), ("0.0000001", True)):
        monkeypatch.setenv("DS_TPU_FLIGHT_PROFILE_MAX_MB", max_mb)
        rec = flight.FlightRecorder(str(tmp_path / max_mb), max_captures=4, profile_s=1e-6)
        cap = rec.capture(reason="unit")
        for _ in range(3):
            profiler.note_quantum("decode")
        section = rec.read_manifest(os.path.basename(cap))["profile"]
        assert section["dropped"] is dropped and section["summary"]["trace"] == "ok"
        assert section["summary"]["marker_clock"] == "trace"
        if dropped:
            assert section["dir"] is None and not os.path.isdir(os.path.join(cap, "profile"))
        else:
            assert section["dir"] == "profile" and section["bytes"] > 0
            assert os.path.isdir(os.path.join(cap, "profile"))
        assert profiler._WINDOWS == [] and not rec._profiling


def test_journal_manifest_section_matches_reference():
    from deepspeed_tpu.telemetry.journal import Journal as JaxJournal
    from deepspeed_tpu_torch.telemetry.journal import Journal

    secs = []
    for cls in (JaxJournal, Journal):
        j = cls()
        j.begin_session({"engine": {}}, kind="generate")
        j.record_request(0, [1, 2], max_new_tokens=2)
        j.record_commit(0, 1, [3, 4])
        j.end_session({"x": 1})
        sec = j.manifest_section(tail=2)
        secs.append((sorted(sec), [r["kind"] for r in sec["tail"]], sec["sessions_total"]))
    assert secs[1] == secs[0]
