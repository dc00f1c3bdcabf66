"""Ragged sequence/KV state manager.

Port of ``deepspeed_tpu/inference/v2/ragged/manager.py``
(``RaggedBatchConfig``, ``DSStateManager``): owns the block allocator and
the uid -> sequence table, hands out and reclaims KV blocks, and with the
prefix cache on (``DS_TPU_PREFIX_CACHE``, default on) sits between the
allocator and the scheduler: admission matches a prompt against the radix
tree (``admit_sequence``), retiring sequences donate their block-aligned
prefixes (``flush_sequence``), and writes into cache-shared blocks go
through copy-on-write (``ensure_writable``); speculative decoding rolls a
sequence's rejected draft positions back (``rollback_tokens``). The device
pools live in the engine.

- ``spill_tick`` forwards the serving loops' between-step pre-spill to the
  prefix cache's host tier, and ``available_blocks`` counts spillable and
  mid-spill blocks as reclaimable.
- With ``DS_TPU_KV_SANITIZE`` a shadow-refcount sanitizer
  (``analysis/kv_sanitizer.py``) mirrors the allocator: ``sanitize_write``
  (called by the engine at every step-assembly site) traps writes into
  shared blocks and steps over blocks not in the device pool, and
  ``flush_all`` ends with ``sanitize_verify`` (refcount drift and leaks,
  with the engine's garbage page registered as a root).
- The ``kv_*`` gauges and counters and the ``admit`` / ``cow`` events go to
  the telemetry registry and event log under the reference's names; a
  prefix match runs under the ``infer/prefix_match`` span, and its hit
  tokens go to the perf accountant's goodput ledger (``note_prefix_hit``).
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Set

import numpy as np

from ....analysis import knobs
from ....telemetry import get_event_log, get_registry as get_telemetry_registry
from ....telemetry import span as telemetry_span
from ....telemetry.costs import get_perf_accountant
from .blocked_allocator import BlockedAllocator
from .prefix_cache import PrefixCache
from .sequence_descriptor import DSSequenceDescriptor


@dataclass
class RaggedBatchConfig:
    """Parity: reference ``inference/v2/ragged/manager_configs.py``."""
    max_tracked_sequences: int = 2048
    max_ragged_batch_size: int = 768  # token budget per engine step
    max_ragged_sequence_count: int = 512  # sequence budget per engine step
    max_context: int = 8192  # per-sequence KV capacity cap
    kv_block_size: int = 128
    num_kv_blocks: Optional[int] = None  # None => engine sizes from memory_gb
    memory_gb: float = 4.0  # KV pool budget when num_kv_blocks is None
    prefix_cache_watermark: float = 0.05  # eviction drains to this free fraction


class DSStateManager:

    def __init__(self, config: RaggedBatchConfig, num_kv_blocks: int,
                 enable_prefix_cache: Optional[bool] = None):
        self._config = config
        self._allocator = BlockedAllocator(num_kv_blocks)
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        if enable_prefix_cache is None:
            enable_prefix_cache = knobs.get_bool("DS_TPU_PREFIX_CACHE")
        # shadow-refcount sanitizer: installed before any allocation so the shadow table sees every
        # block's lifetime
        self._sanitizer = None
        self._sanitize_roots: Set[int] = set()  # engine-held blocks (the garbage page)
        if knobs.get_bool("DS_TPU_KV_SANITIZE"):
            from ....analysis.kv_sanitizer import ShadowRefcounts

            self._sanitizer = ShadowRefcounts()
            self._allocator.set_sanitizer(self._sanitizer)
        self._prefix_cache: Optional[PrefixCache] = None
        if enable_prefix_cache:
            self._prefix_cache = PrefixCache(self._allocator, config.kv_block_size,
                                             watermark=config.prefix_cache_watermark)
        self.spec_rollback_tokens = 0  # KV positions rolled back after speculative verifies
        # occupancy gauges track the most recently constructed manager (one serving engine a process)
        tele = get_telemetry_registry()
        self._m_free = tele.gauge("kv_blocks_free")
        self._m_occupancy = tele.gauge("kv_block_occupancy")
        self._m_tracked = tele.gauge("kv_tracked_sequences")
        self._m_allocated = tele.counter("kv_blocks_allocated_total")
        self._m_flushed = tele.counter("kv_sequences_flushed_total")
        self._m_cow = tele.counter("kv_cow_copies_total")
        self._m_spec_rollback = tele.counter("spec_rollback_tokens_total")
        tele.gauge("kv_blocks_total").set(num_kv_blocks)
        self._events = get_event_log()
        self._sync_gauges()

    def _sync_gauges(self) -> None:
        free = self._allocator.free_blocks
        total = max(1, self._allocator.total_blocks)
        self._m_free.set(free)
        self._m_occupancy.set(1.0 - free / total)
        self._m_tracked.set(len(self._seqs))

    @property
    def block_size(self) -> int:
        return self._config.kv_block_size

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    @property
    def available_blocks(self) -> int:
        """Free blocks plus cached blocks eviction could reclaim right now —
        what admission may plan against (the allocator evicts on demand).
        With the host spill tier this includes spillable and mid-spill
        blocks: a pressured allocate waits for in-flight d2h copies to land
        and drains them, so planning against them cannot deadlock
        admission."""
        n = self._allocator.free_blocks
        if self._prefix_cache is not None:
            n += self._prefix_cache.reclaimable_blocks()
        return n

    def spill_tick(self) -> int:
        """Forward one watermark pre-spill tick to the prefix cache's host
        tier (no-op when detached), called by the serving loops between
        steps so d2h copies overlap device compute."""
        if self._prefix_cache is None:
            return 0
        return self._prefix_cache.spill_tick()

    @property
    def max_context(self) -> int:
        return self._config.max_context

    @property
    def total_blocks(self) -> int:
        return self._allocator.total_blocks

    def shard_geometry(self, block_bytes: int, shard_degree: int = 1) -> Dict:
        """Global and per-shard pool geometry under tensor-parallel serving
        (``blocked_allocator.shard_pool_geometry`` over this pool's block
        count). The manager is shard-agnostic: block ids and every admission
        decision are global, so this is reporting only."""
        from .blocked_allocator import shard_pool_geometry
        return shard_pool_geometry(self.total_blocks, block_bytes, shard_degree)

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        return self._prefix_cache

    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        seq = self._seqs.get(uid)
        if seq is not None:
            return seq
        if len(self._seqs) >= self._config.max_tracked_sequences:
            raise RuntimeError(f"tracking {len(self._seqs)} sequences; "
                               f"max_tracked_sequences={self._config.max_tracked_sequences}")
        seq = DSSequenceDescriptor(uid=uid, block_size=self.block_size)
        self._seqs[uid] = seq
        return seq

    def admit_sequence(self, uid: int, tokens: Sequence[int]) -> DSSequenceDescriptor:
        """First-sight admission: create the descriptor and seed it with the
        longest cached block-aligned prefix of ``tokens``. A fully-cached
        prompt holds the last token back so the suffix forward still emits
        the first logit row — its write lands in a shared block and
        copy-on-writes."""
        seq = self.get_or_create_sequence(uid)
        if self._prefix_cache is None or seq.seen_tokens or seq.blocks or len(tokens) <= 1:
            self._events.emit("admit", uid, hit=seq.seen_tokens, prompt=len(tokens))
            return seq
        with telemetry_span("infer/prefix_match", uid=uid, prompt=len(tokens)):
            blocks, matched = self._prefix_cache.match(tokens)
        if blocks:
            if matched >= len(tokens):
                matched = len(tokens) - 1
            seq.extend_blocks(blocks)
            seq.shared_blocks = len(blocks)
            seq.seen_tokens = matched
            seq.token_log = [int(t) for t in tokens[:matched]]
            # goodput ledger: these tokens never re-run prefill; the accountant prices the saved FLOPs at the
            # prefill cards' rate
            get_perf_accountant().note_prefix_hit(matched)
            self._sync_gauges()
        self._events.emit("admit", uid, hit=seq.seen_tokens, prompt=len(tokens))
        return seq

    def ensure_writable(self, seq: DSSequenceDescriptor, start_pos: int,
                        copy_block_fn: Callable[[int, int], None]) -> None:
        """Copy-on-write: a KV write starting at flat position ``start_pos``
        must not land in a cache-shared block. Each shared block the write
        reaches is copied into a private block (``copy_block_fn(src, dst)``
        does the device page copy) — unless the cache has already evicted
        its reference, in which case the sequence becomes the sole owner."""
        if seq.shared_blocks == 0:
            return
        first = start_pos // self.block_size
        if first >= seq.shared_blocks:
            return
        copied = 0
        for idx in range(first, seq.shared_blocks):
            old = seq.blocks[idx]
            if self._allocator.refcount(old) == 1:
                continue  # cache evicted it; already exclusively ours
            new = self._allocator.allocate(1)[0]
            copy_block_fn(old, new)
            self._allocator.release([old])
            seq.blocks[idx] = new
            self._m_cow.inc()
            copied += 1
        if copied:
            self._events.emit("cow", seq.uid, blocks=copied)
        seq.shared_blocks = first
        self._sync_gauges()

    def allocate_for(self, seq: DSSequenceDescriptor, new_tokens: int) -> None:
        """Grow ``seq``'s block list to cover ``new_tokens`` more KV slots."""
        total = seq.seen_tokens + seq.in_flight_tokens + new_tokens
        if total > self._config.max_context:
            raise RuntimeError(f"sequence {seq.uid}: {total} tokens exceeds max_context {self._config.max_context}")
        need = seq.blocks_needed(new_tokens)
        if need:
            seq.extend_blocks(self._allocator.allocate(need))
            self._m_allocated.inc(need)
            self._sync_gauges()

    def can_allocate(self, num_blocks: int) -> bool:
        return num_blocks <= self.available_blocks

    # ------------------------------------------------------ KV sanitizer
    @property
    def sanitizer(self):
        return self._sanitizer

    def register_sanitizer_root(self, block: int) -> None:
        """Mark an engine-held block (the garbage page) as intentionally
        reachable so the leak-at-flush check does not report it."""
        self._sanitize_roots.add(block)

    def sanitize_write(self, seq: DSSequenceDescriptor, start_pos: int, n_tokens: int) -> None:
        """Trap an imminent KV write that would land in a shared block
        (copy-on-write was skipped), or a step over a block not in the
        device pool. No-op unless ``DS_TPU_KV_SANITIZE``."""
        if self._sanitizer is None:
            return
        self._sanitizer.check_write(seq.uid, seq.blocks, start_pos, n_tokens, self.block_size,
                                    self._allocator.refcount, residency_of=self._allocator.residency)

    def sanitize_verify(self) -> None:
        """Full invariant sweep: shadow-vs-allocator drift plus the leak
        check against everything reachable right now."""
        if self._sanitizer is None:
            return
        self._sanitizer.verify_against(self._allocator._refcount)
        reachable: Set[int] = set(self._sanitize_roots)
        for seq in self._seqs.values():
            reachable.update(seq.blocks)
        if self._prefix_cache is not None:
            # spilled nodes (block == -1, KV in the host tier) hold no device block
            reachable.update(n.block for n in self._prefix_cache._iter_nodes() if n.block >= 0)
        allocated = [b for b, rc in enumerate(self._allocator._refcount) if rc > 0]
        self._sanitizer.check_leaks(allocated, reachable)

    def block_table_row(self, seq: Optional[DSSequenceDescriptor], width: int,
                        fill_block: int = 0) -> np.ndarray:
        """Fixed-width block-table row: the sequence's blocks left-aligned,
        padded with ``fill_block`` (the engine's garbage page, so padded
        table slots always map to real pool memory). ``seq=None`` is all fill."""
        row = np.full((width,), fill_block, np.int32)
        if seq is not None and seq.blocks:
            row[:len(seq.blocks)] = seq.blocks
        return row

    def rollback_tokens(self, seq: DSSequenceDescriptor, n_tokens: int) -> int:
        """Speculative-decode rollback: drop the last ``n_tokens`` KV
        positions of ``seq`` (rejected draft writes) and release the tail
        blocks the shorter sequence no longer covers. Copy-on-write ran before
        the verify write, so the leading ``shared_blocks`` (prefix-cache pages)
        end at or before the rolled-back region; they are never released. The
        abandoned slots are overwritten by the next write at those positions.
        Returns the number of blocks released."""
        if n_tokens <= 0:
            return 0
        if seq.in_flight_tokens:
            raise RuntimeError(f"sequence {seq.uid}: rollback with {seq.in_flight_tokens} tokens in flight")
        if n_tokens > seq.seen_tokens:
            raise ValueError(f"sequence {seq.uid}: rollback of {n_tokens} > {seq.seen_tokens} seen")
        seq.seen_tokens -= n_tokens
        keep = max(-(-seq.seen_tokens // self.block_size), seq.shared_blocks)
        released = seq.blocks[keep:]
        if released:
            self._allocator.release(released)
            del seq.blocks[keep:]
            self._sync_gauges()
        self.spec_rollback_tokens += n_tokens
        self._m_spec_rollback.inc(n_tokens)
        return len(released)

    def flush_sequence(self, uid: int) -> None:
        """Retire a sequence: its block-aligned known prefix is donated to the
        prefix cache; everything else returns to the pool."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            return
        if seq.blocks:
            if self._prefix_cache is not None:
                n_tok = min(len(seq.token_log), seq.seen_tokens)
                self._prefix_cache.insert(seq.token_log[:n_tok], seq.blocks)
            else:
                self._allocator.free(seq.blocks)
        self._m_flushed.inc()
        self._sync_gauges()

    def flush_all(self) -> None:
        """Retire every tracked sequence, then (with the sanitizer) check that
        no allocated block is unreachable from the cache tree or a root."""
        for uid in list(self._seqs):
            self.flush_sequence(uid)
        self._sync_gauges()
        self.sanitize_verify()

    def reset_prefix_cache(self) -> int:
        """Drop every evictable cached prefix (and every host-tier copy).
        Returns nodes evicted."""
        if self._prefix_cache is None:
            return 0
        n = self._prefix_cache.clear()
        self._sync_gauges()
        return n
