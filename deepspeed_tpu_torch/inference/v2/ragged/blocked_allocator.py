"""Paged-KV block allocator with refcounted sharing.

Port of ``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``
(``BlockedAllocator``): a fixed pool of KV blocks handed out to sequences
and returned on free. ``allocate`` hands out blocks at refcount 1,
``retain`` adds a holder, ``release`` (alias ``free``) drops one; a block
returns to the LIFO free list only at refcount 0. An optional eviction
hook lets a cache give blocks back under allocation pressure before
``allocate`` gives up. The host-tier residency states come with the spill
tier in a later slice.
"""

from typing import Callable, Iterable, List, Optional, Union


class BlockedAllocator:

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        # LIFO free list: recently-freed (still-warm) blocks are reused first.
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._free_set = set(self._free)  # O(1) membership for the double-free check
        self._refcount = [0] * num_blocks
        self._evict_hook: Optional[Callable[[int], None]] = None

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._refcount[block]

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
            out.append(b)
        return out

    def retain(self, blocks: Union[int, Iterable[int]]) -> None:
        """Add one holder to each block (it must be live)."""
        for b in ((blocks,) if isinstance(blocks, int) else blocks):
            if self._refcount[b] <= 0:
                raise ValueError(f"retain of unallocated block {b}")
            self._refcount[b] += 1

    def release(self, blocks: Iterable[int]) -> None:
        """Drop one holder from each block; a block returns to the free list
        only when its last holder releases it."""
        for b in blocks:
            if not (0 <= b < self._num_blocks):
                raise ValueError(f"block id {b} out of range")
            if b in self._free_set or self._refcount[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                self._free.append(b)
                self._free_set.add(b)

    # the single-holder API: free == release
    free = release
