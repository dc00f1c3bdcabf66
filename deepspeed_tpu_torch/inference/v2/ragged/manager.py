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
pools live in the engine. The KV sanitizer and the spill tick come with
later slices.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ....analysis import knobs
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
        self._prefix_cache: Optional[PrefixCache] = None
        if enable_prefix_cache:
            self._prefix_cache = PrefixCache(self._allocator, config.kv_block_size,
                                             watermark=config.prefix_cache_watermark)
        self.spec_rollback_tokens = 0  # KV positions rolled back after speculative verifies

    @property
    def block_size(self) -> int:
        return self._config.kv_block_size

    @property
    def free_blocks(self) -> int:
        return self._allocator.free_blocks

    @property
    def available_blocks(self) -> int:
        """Free blocks plus cached blocks eviction could reclaim right now —
        what admission may plan against (the allocator evicts on demand)."""
        n = self._allocator.free_blocks
        if self._prefix_cache is not None:
            n += self._prefix_cache.reclaimable_blocks()
        return n

    @property
    def max_context(self) -> int:
        return self._config.max_context

    @property
    def total_blocks(self) -> int:
        return self._allocator.total_blocks

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
            return seq
        blocks, matched = self._prefix_cache.match(tokens)
        if blocks:
            if matched >= len(tokens):
                matched = len(tokens) - 1
            seq.extend_blocks(blocks)
            seq.shared_blocks = len(blocks)
            seq.seen_tokens = matched
            seq.token_log = [int(t) for t in tokens[:matched]]
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
        for idx in range(first, seq.shared_blocks):
            old = seq.blocks[idx]
            if self._allocator.refcount(old) == 1:
                continue  # cache evicted it; already exclusively ours
            new = self._allocator.allocate(1)[0]
            copy_block_fn(old, new)
            self._allocator.release([old])
            seq.blocks[idx] = new
        seq.shared_blocks = first

    def allocate_for(self, seq: DSSequenceDescriptor, new_tokens: int) -> None:
        """Grow ``seq``'s block list to cover ``new_tokens`` more KV slots."""
        total = seq.seen_tokens + seq.in_flight_tokens + new_tokens
        if total > self._config.max_context:
            raise RuntimeError(f"sequence {seq.uid}: {total} tokens exceeds max_context {self._config.max_context}")
        need = seq.blocks_needed(new_tokens)
        if need:
            seq.extend_blocks(self._allocator.allocate(need))

    def can_allocate(self, num_blocks: int) -> bool:
        return num_blocks <= self.available_blocks

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
        self.spec_rollback_tokens += n_tokens
        return len(released)

    def flush_sequence(self, uid: int) -> None:
        """Retire a sequence: its block-aligned known prefix is donated to the
        prefix cache; everything else returns to the pool."""
        seq = self._seqs.pop(uid, None)
        if seq is None or not seq.blocks:
            return
        if self._prefix_cache is not None:
            n_tok = min(len(seq.token_log), seq.seen_tokens)
            self._prefix_cache.insert(seq.token_log[:n_tok], seq.blocks)
        else:
            self._allocator.free(seq.blocks)

    def reset_prefix_cache(self) -> int:
        """Drop every evictable cached prefix. Returns nodes evicted."""
        if self._prefix_cache is None:
            return 0
        return self._prefix_cache.clear()
