"""Port parity: the tiered KV economy (host spill tier, residency, KV sanitizer).

After ``tests/unit/test_kv_tier.py`` and ``tests/unit/test_kv_sanitizer.py``,
on the CPU in fp32, where everything is held exactly:
- ``HostKVPool`` / ``SpillManager``: slot lifecycle and bytes, the d2h
  round trip, a failed copy raised where it is issued, a copy that never
  lands raised by ``wait_all``; ``BlockedAllocator`` residency transitions;
- the sanitizer's traps (shadow refcounts, COW, leaks, drift, spill of a
  shared block, readmit drift, a step over a block that is not in the device
  pool): each case is injected into the JAX modules and the port's, and
  both must trap with the same message;
- policy: one op sequence (insert, match, evict, ``spill_tick``, ``clear``,
  a full host pool, a readmit with a full device pool) through the JAX
  ``PrefixCache`` and the port's, each over a real spill manager with a
  stub snapshot; after every op the cached and spilled blocks, residency,
  refcounts, free blocks and free host slots are equal, and every
  re-admitted block received the pages of the block it was spilled from,
  also when the re-admission's own allocation has to evict under a full
  host pool;
- the engine: a tiny GQA llama (``test_kv_tier.py``'s config), kv 0 and 8,
  both loops, ``kv_spill`` on: tokens and the deltas of
  ``kv_spill_blocks_total``, ``kv_readmit_total``,
  ``kv_prefix_hit_tokens_total`` and ``infer_prefill_tokens_total`` equal
  the JAX engine's across a forced evict and a second pass, and under pool
  pressure (spills through the allocator's eviction hook and the
  watermark), where the request and tier events (``spill``, ``readmit``,
  ``evict``) also equal the JAX engine's; with ``DS_TPU_KV_SANITIZE=1``
  that run is clean and the final flush finds no leak.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.analysis import kv_sanitizer as jax_san
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.ragged import blocked_allocator as jax_alloc
from deepspeed_tpu.inference.v2.ragged import host_tier as jax_tier
from deepspeed_tpu.inference.v2.ragged import manager as jax_manager
from deepspeed_tpu.inference.v2.ragged import prefix_cache as jax_pc
from deepspeed_tpu.models import CausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.telemetry import events as jax_events
from deepspeed_tpu.telemetry import get_registry as jax_registry
from deepspeed_tpu_torch.analysis import kv_sanitizer as san
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.ragged import blocked_allocator as alloc_mod
from deepspeed_tpu_torch.inference.v2.ragged import host_tier
from deepspeed_tpu_torch.inference.v2.ragged import manager as manager_mod
from deepspeed_tpu_torch.inference.v2.ragged import prefix_cache as pc_mod
from deepspeed_tpu_torch.models import TransformerConfig, params_from_numpy
from deepspeed_tpu_torch.telemetry import get_event_log, get_registry

BS = 4
# (allocator module, sanitizer module, manager module) of each package
IMPLS = {"jax": (jax_alloc, jax_san, jax_manager), "torch": (alloc_mod, san, manager_mod)}



@pytest.fixture(autouse=True, scope="module")
def _reference_spills_land_at_once():
    """The JAX tier's worker thread lands a copy whenever it gets to run, so which spills a later tick
    drains varies from run to run; the port's tier on the CPU lands each copy as it is issued. Each JAX
    spill is waited for where it is issued, so both packages drain the same spills at the same points."""
    issue = jax_tier.SpillManager.spill_async

    def spill_async(self, block, slot):
        issue(self, block, slot)
        self.wait_all()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tier.SpillManager, "spill_async", spill_async)
        yield


# ------------------------------------------------------------- host tier
def test_host_pool_slot_lifecycle_and_bytes():
    pool = host_tier.HostKVPool(2, [(2, 4), (3,)], [torch.float32, torch.int8])
    assert pool.capacity == 2 and pool.free_slots == 2 and not pool.pinned
    assert pool.bytes_per_slot == 2 * 4 * 4 + 3
    s0, s1 = pool.try_alloc_slot(), pool.try_alloc_slot()
    assert {s0, s1} == {0, 1} and pool.try_alloc_slot() is None
    assert pool.used_bytes == 2 * pool.bytes_per_slot
    pool.write(s0, [torch.ones(2, 1, 4), torch.arange(3, dtype=torch.int8).view(3, 1)])
    got = pool.read(s0)
    assert torch.equal(got[0], torch.ones(2, 4)) and torch.equal(got[1], torch.arange(3, dtype=torch.int8))
    pool.free_slot(s0)
    assert pool.free_slots == 1
    with pytest.raises(ValueError, match="double free"):
        pool.free_slot(s0)
    with pytest.raises(ValueError, match="out of range"):
        pool.free_slot(2)


def test_spill_manager_roundtrip_failure_and_close():
    pool = host_tier.HostKVPool(4, [(4,)], [torch.float32])
    mgr = host_tier.SpillManager(pool, lambda b: [torch.full((4, 1), float(b))])
    slots = []
    for b in (7, 9):
        s = pool.try_alloc_slot()
        slots.append(s)
        mgr.spill_async(b, s)
    assert mgr.inflight == 2  # issued, not yet handed back
    mgr.wait_all(timeout=30.0)
    assert mgr.drain() == [(7, slots[0]), (9, slots[1])] and mgr.inflight == 0 and mgr.drain() == []
    assert torch.equal(pool.read(slots[0])[0], torch.full((4,), 7.0))
    assert torch.equal(pool.read(slots[1])[0], torch.full((4,), 9.0))
    with pytest.raises(IndexError):
        mgr.spill_async(3, 9)  # slot 9 does not exist: the copy fails where it is issued
    assert mgr.inflight == 0


class _StuckCopy:
    """A d2h event that never completes."""

    def query(self):
        return False


def test_spill_wait_all_raises_on_a_stuck_copy():
    pool = host_tier.HostKVPool(2, [(4,)], [torch.float32])
    mgr = host_tier.SpillManager(pool, lambda b: [torch.zeros(4, 1)])
    mgr.spill_async(1, pool.try_alloc_slot())
    mgr._pending.append((2, pool.try_alloc_slot(), None, _StuckCopy()))
    with pytest.raises(TimeoutError, match="1 KV spill copies still in flight"):
        mgr.wait_all(timeout=0.05)
    assert mgr.drain() == [(1, 0)] and mgr.inflight == 1  # the stuck copy is never handed back


def test_residency_transitions_and_reissue_resets():
    a = alloc_mod.BlockedAllocator(4)
    (b,) = a.allocate(1)
    assert a.residency(b) == alloc_mod.RES_HBM
    a.mark_residency(b, alloc_mod.RES_INFLIGHT)
    a.mark_residency(b, alloc_mod.RES_HOST)
    a.release([b])
    got = a.allocate(4)  # drains the pool: b must come back as HBM
    assert b in got and a.residency(b) == alloc_mod.RES_HBM
    with pytest.raises(ValueError, match="unknown residency state"):
        a.mark_residency(0, "tape")


# ------------------------------------------------------- sanitizer traps
def _wired(impl, n=8):
    alloc_m, san_m, _ = IMPLS[impl]
    a = alloc_m.BlockedAllocator(n)
    s = san_m.ShadowRefcounts()
    a.set_sanitizer(s)
    return a, s


def _case_double_free(impl):
    a, s = _wired(impl)
    (b,) = a.allocate(1)
    a.release([b])
    s.on_release(b)


def _case_retain_dead(impl):
    _, s = _wired(impl)
    s.on_retain(5)


def _case_shared_write(impl):
    a, s = _wired(impl)
    blocks = a.allocate(2)
    a.retain(blocks[1])
    s.check_write(7, blocks, start_pos=10, n_tokens=4, block_size=8, refcount_of=a.refcount)


def _case_leak(impl):
    a, s = _wired(impl)
    blocks = a.allocate(3)
    s.check_leaks(allocated=blocks, reachable=set(blocks[:2]))


def _case_drift(impl):
    a, s = _wired(impl, 4)
    a.allocate(2)
    a._refcount[0] += 1  # a mutation that bypassed the public API
    s.verify_against(a._refcount)


def _case_spill_shared(impl):
    a, _ = _wired(impl)
    (b,) = a.allocate(1)
    a.retain(b)
    a.mark_residency(b, IMPLS[impl][0].RES_INFLIGHT)


def _case_spill_shared_unsanitized(impl):
    a = IMPLS[impl][0].BlockedAllocator(4)
    (b,) = a.allocate(1)
    a.retain(b)
    a.mark_residency(b, IMPLS[impl][0].RES_INFLIGHT)


def _case_readmit_drift(impl):
    a, s = _wired(impl)
    (b,) = a.allocate(1)
    s.check_readmit(b, 1)  # clean: one fresh cache hold on both sides
    s.check_readmit(b, 2)


def _non_hbm(state):
    def case(impl):
        a, s = _wired(impl)
        blocks = a.allocate(3)
        a.mark_residency(blocks[1], getattr(IMPLS[impl][0], state))
        s.check_write(7, blocks, start_pos=0, n_tokens=2, block_size=BS, refcount_of=a.refcount,
                      residency_of=a.residency)
    return case


def _manager(impl, monkeypatch):
    monkeypatch.setenv("DS_TPU_KV_SANITIZE", "1")
    m = IMPLS[impl][2]
    return m.DSStateManager(m.RaggedBatchConfig(kv_block_size=4, max_context=64), num_kv_blocks=16)


def _case_manager_leak(impl, monkeypatch):
    mgr = _manager(impl, monkeypatch)
    seq = mgr.get_or_create_sequence(1)
    mgr.allocate_for(seq, 10)
    seq.blocks.pop()  # drop bookkeeping without releasing
    mgr.sanitize_verify()


def _case_manager_shared_write(impl, monkeypatch):
    mgr = _manager(impl, monkeypatch)
    seq = mgr.get_or_create_sequence(1)
    mgr.allocate_for(seq, 8)
    mgr._allocator.retain(seq.blocks[1])  # a cache holder
    mgr.sanitize_write(seq, start_pos=4, n_tokens=4)


TRAPS = {
    "double_free": (_case_double_free, r"double free of block \d+ .*refcount is already 0"),
    "retain_dead": (_case_retain_dead, r"retain of block 5 which has no live holders"),
    "shared_write": (_case_shared_write, r"writing positions \[10, 14\) into block \d+ \(refcount 2\) without"),
    "leak": (_case_leak, r"1 block\(s\) leaked at flush: \[\d+\]"),
    "drift": (_case_drift, r"refcount drift on block 0"),
    "spill_shared": (_case_spill_shared, r"spill of shared block \d+ \(allocator refcount 2, shadow 2\)"),
    "spill_shared_unsanitized": (_case_spill_shared_unsanitized, r"cannot spill block \d+.*refcount 2"),
    "readmit_drift": (_case_readmit_drift, r"readmit refcount drift on block \d+: allocator says 2, shadow"),
    "inflight_dispatch": (_non_hbm("RES_INFLIGHT"), r"\(table index 1\) whose residency is INFLIGHT — its HBM "
                                                    r"pages are being copied out"),
    "host_dispatch": (_non_hbm("RES_HOST"), r"\(table index 1\) whose residency is HOST — its HBM pages are "
                                            r"released"),
    "manager_leak": (_case_manager_leak, r"leaked at flush: \[\d+\]"),
    "manager_shared_write": (_case_manager_shared_write, "without copy-on-write"),
}


@pytest.mark.parametrize("name", sorted(TRAPS))
def test_sanitizer_traps_match_reference(name, monkeypatch):
    case, pattern = TRAPS[name]
    messages = []
    for impl in ("jax", "torch"):
        args = (impl, monkeypatch) if name.startswith("manager") else (impl,)
        with pytest.raises((ValueError, RuntimeError), match=pattern) as info:
            case(*args)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_sanitizer_mirrors_and_clean_paths(impl, monkeypatch):
    a, s = _wired(impl)
    blocks = a.allocate(3)
    assert s.live_blocks() == set(blocks)
    a.retain(blocks[0])
    assert s.refcount(blocks[0]) == 2
    s.check_write(7, blocks, 8, 8, 8, a.refcount)  # positions [8, 16) write block 1 only: block 0's sharing is fine
    a.release(blocks)
    a.release([blocks[0]])
    assert not s.live_blocks()
    mgr = _manager(impl, monkeypatch)
    (garbage,) = mgr._allocator.allocate(1)
    mgr.register_sanitizer_root(garbage)
    seq = mgr.get_or_create_sequence(1)
    mgr.allocate_for(seq, 10)
    mgr.sanitize_verify()
    mgr.flush_all()
    assert mgr.sanitizer.live_blocks() == {garbage}


# ------------------------------------------------------ prefix-cache policy
class _Tier:
    """Allocator + cache + a real spill manager of one package over a stub
    device pool: the snapshot of a block is a plane filled with its tag
    (``tags``, default its id), and the re-admission records which tag came
    back."""

    def __init__(self, impl, total, cap, watermark_blocks=0):
        self.impl = impl
        mods = (jax_alloc, jax_pc, jax_tier) if impl == "jax" else (alloc_mod, pc_mod, host_tier)
        self.alloc = mods[0].BlockedAllocator(total)
        self.pc = mods[1].PrefixCache(self.alloc, BS, watermark=0.0)
        self.scattered = {}
        self.tags = {}
        if impl == "jax":
            self.pool = jax_tier.HostKVPool(cap, [(2, BS)], [np.float32])
            gather = lambda b: [np.full((2, BS), float(self.tags.get(b, b)), np.float32)]  # noqa: E731
            scatter = lambda b, leaves: self.scattered.__setitem__(b, int(leaves[0][0, 0]))  # noqa: E731
        else:
            self.pool = host_tier.HostKVPool(cap, [(2, BS)], [torch.float32])
            gather = lambda b: [torch.full((2, 1, BS), float(self.tags.get(b, b)))]  # noqa: E731
            scatter = lambda b, leaves: self.scattered.__setitem__(b, int(leaves[0][0, 0]))  # noqa: E731
        self.mgr = mods[2].SpillManager(self.pool, gather)
        self.pc.attach_spill_tier(self.mgr, scatter, watermark_blocks=watermark_blocks)

    def state(self):
        self.mgr.wait_all(timeout=30.0)
        a = self.alloc
        return dict(cached=self.pc.cached_blocks, spilled=self.pc.spilled_blocks, free=a.free_blocks,
                    host_free=self.pool.free_slots, host_bytes=self.pc.host_tier_bytes // self.pool.bytes_per_slot,
                    refcounts=list(a._refcount), residency=[a.residency(b) for b in range(a.total_blocks)],
                    reclaimable=self.pc.reclaimable_blocks())


def _chain(base, n):
    return [base + i for i in range(n * BS)]


def _ops():
    """(name, fn(tier) -> result) in order; each result must be equal on both sides."""
    live = {}
    held = {}

    def insert(tokens):
        def op(t):
            blocks = t.alloc.allocate(len(tokens) // BS)
            return t.pc.insert(tokens, blocks)
        return op

    def match(tokens, key):
        def op(t):
            blocks, n = t.pc.match(tokens)
            held.setdefault(t.impl, {})[key] = blocks
            return len(blocks), n, [t.scattered.get(b) for b in blocks]
        return op

    def release(key):
        def op(t):
            t.alloc.release(held[t.impl].pop(key))
        return op

    def grab(n, key):
        def op(t):
            live.setdefault(t.impl, {})[key] = t.alloc.allocate(n)
        return op

    def drop(key):
        def op(t):
            t.alloc.release(live[t.impl].pop(key))
        return op

    A, B, C, D = _chain(0, 2), _chain(100, 3), _chain(200, 1), _chain(300, 2)
    return [
        ("insert A", insert(A)), ("insert B", insert(B)), ("insert C", insert(C)),
        ("match A", match(A, "a")), ("release A", release("a")),
        ("evict 14", lambda t: t.pc.evict(14)),  # spills B's and C's chains, then A's
        ("match B (readmit)", match(B, "b")),
        ("insert D", insert(D)),
        ("grab to pressure", grab(8, "p")),
        ("spill_tick", lambda t: t.pc.spill_tick()),
        ("spill_tick again", lambda t: t.pc.spill_tick()),
        ("insert C again (adopt)", insert(C)),
        ("release B", release("b")), ("drop pressure", drop("p")),
        ("evict all (host full)", lambda t: t.pc.evict(t.alloc.total_blocks)),
        ("grab rest", lambda t: live.setdefault(t.impl, {}).__setitem__("r", t.alloc.allocate(t.alloc.free_blocks))),
        ("match D (pool full: miss)", match(D, "d")),
        ("drop rest", drop("r")),
        ("match D (readmit)", match(D, "d2")),
        ("release D", release("d2")),
        ("clear", lambda t: t.pc.clear()),
    ]


def test_prefix_cache_spill_policy_matches_reference():
    tiers = {impl: _Tier(impl, total=16, cap=5, watermark_blocks=6) for impl in ("jax", "torch")}
    for name, op in _ops():
        results = {impl: op(t) for impl, t in tiers.items()}
        assert results["jax"] == results["torch"], name
        states = {impl: t.state() for impl, t in tiers.items()}
        assert states["jax"] == states["torch"], name
    final = tiers["torch"].state()
    assert final["cached"] == final["spilled"] == 0 and final["free"] == 16 and final["host_free"] == 5


def test_readmitted_blocks_carry_their_pages():
    t = _Tier("torch", total=16, cap=8)
    tokens = _chain(0, 3)
    old = t.alloc.allocate(3)
    t.pc.insert(tokens, old)
    assert t.pc.evict(t.alloc.total_blocks) == 3  # waits for the copies and drains them
    assert (t.pc.cached_blocks, t.pc.spilled_blocks) == (0, 3) and t.alloc.free_blocks == 16
    blocks, n = t.pc.match(tokens)
    assert n == 3 * BS and [t.scattered[b] for b in blocks] == old
    assert all(t.alloc.residency(b) == alloc_mod.RES_HBM for b in blocks)
    t.alloc.release(blocks)


def test_readmission_keeps_its_slot_when_pressure_fills_the_host_pool():
    """The node being re-admitted is the only host-resident leaf, the host pool is full, and the device pool
    is full of unshared cached blocks: the allocation's eviction cannot drop that node to make room for a
    spill (its slot would take another block's pages before the h2d reads it), so it evicts a cached leaf
    and the re-admitted block carries the node's own pages."""
    t = _Tier("torch", total=4, cap=1)
    x = _chain(0, 1)
    (bx,) = t.alloc.allocate(1)
    t.tags[bx] = 1000
    t.pc.insert(x, [bx])
    assert t.pc.evict(t.alloc.total_blocks) == 1 and t.pool.free_slots == 0  # x spilled: the host pool is full
    chain = t.alloc.allocate(4)
    t.tags.update({b: 2000 + i for i, b in enumerate(chain)})
    t.pc.insert(_chain(100, 4), chain)  # the device pool full of unshared cached blocks
    assert t.alloc.free_blocks == 0 and t.pc.cached_blocks == 4
    blocks, n = t.pc.match(x)
    assert n == BS and t.scattered[blocks[0]] == 1000
    assert (t.pc.cached_blocks, t.pc.spilled_blocks, t.pool.free_slots) == (4, 0, 1)
    t.alloc.release(blocks)
    assert t.pc.match(x)[1] == BS and t.alloc.residency(blocks[0]) == alloc_mod.RES_HBM  # x stays in the tree


# ------------------------------------------------------------- engine
TINY = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=256, norm="rmsnorm",
            activation="swiglu", pos_emb="rope", tie_embeddings=False)
SHARED = [(7 * i + 3) % 128 for i in range(32)]
PROMPTS = [SHARED + [100 + i] * 5 for i in range(4)]
# pressure: 8 requests, each a 24-token prefix of its own (3 blocks) and 3 more tokens, on a pool of 24 blocks:
# the second wave needs the blocks the first wave's cached prefixes hold
PRESSURE = [[(11 * i + 5 * j) % 128 for j in range(24)] + [i] * 3 for i in range(8)]
COUNTERS = ("kv_spill_blocks_total", "kv_readmit_total", "kv_prefix_hit_tokens_total", "infer_prefill_tokens_total")


@pytest.fixture(scope="module")
def tiny():
    old = os.environ.get("DS_TPU_KV_HOST_POOL_MB")
    os.environ["DS_TPU_KV_HOST_POOL_MB"] = "1"
    model = CausalLM(JaxConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = TransformerConfig(**TINY)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)

    def engines(kvq, fused, blocks=64):
        kw = dict(dtype="float32", fused_step=fused, enable_prefix_cache=True, kv_quant_bits=kvq, kv_spill=True)
        smc = dict(kv_block_size=8, max_context=256, num_kv_blocks=blocks)
        return (JaxEngine(model, params, JaxEngineConfig(state_manager=JaxBatchConfig(**smc), **kw)),
                InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
                    state_manager=RaggedBatchConfig(**smc), device="cpu", **kw)))

    yield engines
    if old is None:
        os.environ.pop("DS_TPU_KV_HOST_POOL_MB", None)
    else:
        os.environ["DS_TPU_KV_HOST_POOL_MB"] = old


def _passes(engine, registry, waves, evict=True):
    """Serve ``waves`` (each a list of prompts), with ``evict`` evicting every
    cached block before each later wave; tokens and the counters' deltas."""
    before = [registry.peek(n) or 0.0 for n in COUNTERS]
    out = []
    for i, wave in enumerate(waves):
        if i and evict:
            engine.state.prefix_cache.evict(engine.state.total_blocks)
        out.append(engine.generate(wave, max_new_tokens=8))
    return out, [(registry.peek(n) or 0.0) - b for n, b in zip(COUNTERS, before)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kvq", [0, 8])
def test_engine_spill_and_readmit_match_reference(tiny, kvq, fused):
    je, te = tiny(kvq, fused)
    want, want_counts = _passes(je, jax_registry(), [PROMPTS, PROMPTS])
    got, counts = _passes(te, get_registry(), [PROMPTS, PROMPTS])
    assert got == want and got[1] == got[0]  # re-admitted KV reproduces the first pass exactly
    assert counts == want_counts
    spilled, readmitted, hit, prefill = counts
    assert spilled == readmitted == 4 and hit == 4 * len(SHARED) * 2 - 4 * len(SHARED)
    # the second pass prefills only the suffixes: the re-admitted prefix is never prefilled again
    assert prefill == sum(len(p) for p in PROMPTS) + 4 * (len(PROMPTS[0]) - len(SHARED))
    te.state.sanitize_verify()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_engine_pressure_spills_match_reference(tiny, fused, monkeypatch):
    monkeypatch.setenv("DS_TPU_KV_SANITIZE", "1")
    je, te = tiny(8, fused, blocks=24)
    waves = [PRESSURE[:4], PRESSURE[4:], PRESSURE[:4]]
    logs = (jax_events.get_event_log(), get_event_log())
    for log in logs:
        log.clear()
    want, want_counts = _passes(je, jax_registry(), waves, evict=False)
    got, counts = _passes(te, get_registry(), waves, evict=False)
    assert got == want and counts == want_counts
    assert got[2] == got[0] and counts[0] > 0 and counts[1] > 0  # the pool pressure spilled, the third wave re-admitted
    # the request and tier events (spill, readmit, evict among them) equal the JAX engine's, timestamps aside
    want_ev, got_ev = ([(e["kind"], e["uid"], {k: v for k, v in e.items() if k not in ("ts", "kind", "uid")})
                        for e in log.events()] for log in logs)
    assert got_ev == want_ev and {"spill", "readmit", "evict"} <= {k for k, _, _ in got_ev}
    te.state.flush_all()  # sanitizer: no leak, no drift
