"""Paged-KV block allocator with refcounted sharing.

Port of ``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``
(``BlockedAllocator``): a fixed pool of KV blocks handed out to sequences
and returned on free. ``allocate`` hands out blocks at refcount 1,
``retain`` adds a holder, ``release`` (alias ``free``) drops one; a block
returns to the LIFO free list only at refcount 0. An optional eviction
hook lets a cache give blocks back under allocation pressure before
``allocate`` gives up.

With the host spill tier (``host_tier.py``) every block also carries a
**residency** state:

- ``RES_HBM``: the block's pages are live in the device pool (the only
  state in which a step may read or write its KV);
- ``RES_INFLIGHT``: the prefix cache snapshotted the block and its d2h
  copy is queued or running; the device block stays allocated (the
  snapshot is a separate buffer, but the id must not go to a new owner
  until the copy lands);
- ``RES_HOST``: the copy landed and the device block was released; the
  state is informational until ``allocate`` hands the id out again, which
  resets it to ``RES_HBM`` (the new owner writes fresh pages).

The allocator only *records* residency (``mark_residency``/``residency``);
the prefix cache drives the transitions and the KV sanitizer
(``analysis/kv_sanitizer.py``, installed with ``set_sanitizer``) traps steps
that would read a block that is not in the device pool.

``shard_pool_geometry`` is the per-shard arithmetic of a head-sharded pool
under tensor-parallel serving: block ids stay global, only the bytes behind
each id split over the ranks.
"""

from typing import Callable, Iterable, List, Optional, Union

# residency states (host spill tier)
RES_HBM = "hbm"
RES_INFLIGHT = "inflight"
RES_HOST = "host"


def shard_pool_geometry(num_blocks: int, block_bytes: int, shard_degree: int = 1) -> dict:
    """Per-shard view of a head-sharded paged pool (JAX
    ``blocked_allocator.shard_pool_geometry``). One host allocator serves
    every rank and the block table is the same on each, so allocation is
    untouched by TP; each rank holds ``block_bytes / shard_degree`` of every
    block. Bytes that do not divide raise: every pool byte scales with the
    KV heads, which the engine checks divide by the degree."""
    if shard_degree < 1:
        raise ValueError(f"shard_degree must be >= 1, got {shard_degree}")
    if block_bytes % shard_degree:
        raise ValueError(f"block_bytes {block_bytes} not divisible by shard_degree {shard_degree}")
    per_shard = block_bytes // shard_degree
    return {
        "num_blocks": int(num_blocks),
        "shard_degree": int(shard_degree),
        "block_bytes_global": int(block_bytes),
        "block_bytes_per_shard": int(per_shard),
        "pool_bytes_global": int(num_blocks) * int(block_bytes),
        "pool_bytes_per_shard": int(num_blocks) * int(per_shard),
    }


class BlockedAllocator:

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        # LIFO free list: recently-freed (still-warm) blocks are reused first.
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._free_set = set(self._free)  # O(1) membership for the double-free check
        self._refcount = [0] * num_blocks
        self._residency = [RES_HBM] * num_blocks
        self._evict_hook: Optional[Callable[[int], None]] = None
        # optional shadow-refcount sanitizer: mirrors every allocate/retain/release and traps invariant
        # breaks BEFORE this allocator mutates, so the two tables stay in lockstep
        self._sanitizer = None

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._refcount[block]

    def residency(self, block: int) -> str:
        return self._residency[block]

    def mark_residency(self, block: int, state: str) -> None:
        """Record a residency transition (driven by the prefix cache's spill
        machinery). ``RES_INFLIGHT`` is only legal on an unshared live block:
        a shared block's other holder could run steps reading it while the
        d2h is in flight."""
        if state not in (RES_HBM, RES_INFLIGHT, RES_HOST):
            raise ValueError(f"unknown residency state {state!r}")
        if state == RES_INFLIGHT:
            if self._sanitizer is not None:
                self._sanitizer.on_spill(block, self._refcount[block])
            if self._refcount[block] != 1:
                raise ValueError(f"cannot spill block {block}: refcount {self._refcount[block]} != 1")
        self._residency[block] = state

    def set_sanitizer(self, sanitizer) -> None:
        """Install a ``ShadowRefcounts`` mirror (``DS_TPU_KV_SANITIZE``)."""
        self._sanitizer = sanitizer

    @property
    def sanitizer(self):
        return self._sanitizer

    def set_eviction_hook(self, hook: Optional[Callable[[int], None]]) -> None:
        """``hook(shortfall)`` is called when ``allocate`` is short by
        ``shortfall`` blocks; it may ``release`` cached blocks to make room
        (it must not call ``allocate``)."""
        self._evict_hook = hook

    def allocate(self, num_blocks: int) -> List[int]:
        """Take ``num_blocks`` block ids at refcount 1; raises if the pool is
        exhausted even after the eviction hook runs."""
        if num_blocks < 0:
            raise ValueError(f"cannot allocate {num_blocks} blocks")
        if num_blocks > len(self._free) and self._evict_hook is not None:
            self._evict_hook(num_blocks - len(self._free))
        if num_blocks > len(self._free):
            raise RuntimeError(f"out of KV blocks: want {num_blocks}, have {len(self._free)}")
        out = []
        for _ in range(num_blocks):
            b = self._free.pop()
            self._free_set.discard(b)
            self._refcount[b] = 1
            # a re-issued id starts a fresh device life: the new owner writes its own pages (a prior host
            # copy belongs to the cache node that spilled it, keyed by host slot, not by this id)
            self._residency[b] = RES_HBM
            out.append(b)
        if self._sanitizer is not None:
            self._sanitizer.on_allocate(out)
        return out

    def retain(self, blocks: Union[int, Iterable[int]]) -> None:
        """Add one holder to each block (it must be live)."""
        for b in ((blocks,) if isinstance(blocks, int) else blocks):
            if self._sanitizer is not None:
                self._sanitizer.on_retain(b)
            if self._refcount[b] <= 0:
                raise ValueError(f"retain of unallocated block {b}")
            self._refcount[b] += 1

    def release(self, blocks: Iterable[int]) -> None:
        """Drop one holder from each block; a block returns to the free list
        only when its last holder releases it."""
        for b in blocks:
            if not (0 <= b < self._num_blocks):
                raise ValueError(f"block id {b} out of range")
            if self._sanitizer is not None:
                self._sanitizer.on_release(b)
            if b in self._free_set or self._refcount[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                self._free.append(b)
                self._free_set.add(b)

    # the single-holder API: free == release
    free = release
