"""Host-RAM spill tier for paged KV blocks.

Port of ``deepspeed_tpu/inference/v2/ragged/host_tier.py``. The prefix cache
(``prefix_cache.py``) turns eviction from "forget" into "demote": instead of
freeing an LRU unshared block's KV, the block's pages are snapshotted on the
device and copied device-to-host while the steps go on. A later radix
``match`` that lands on a spilled node re-admits the block with a
host-to-device copy instead of running prefill again.

This module is *mechanism* only: a preallocated host slab with a slot free
list (:class:`HostKVPool`) and the d2h copies (:class:`SpillManager`). All
*policy* (which node spills, when to drop host-LRU entries, residency against
the allocator) lives in ``prefix_cache.py``.

On a CUDA engine:

- the slabs are page-locked (``pin_memory=True``), one per pool leaf (two for
  a bf16 pool pair, four for int8 ``(codes, scales)`` pools, so spilled int8
  blocks stay quantised), allocated once when the engine is built and reused:
  the serving path allocates no host memory;
- the snapshot (the engine's gather) runs on the stream the steps run on; the
  d2h copy runs on a dedicated ``torch.cuda.Stream`` that first waits on an
  event recorded after the gather, and records its own event after the copy;
- the serving thread keeps each pending copy with its snapshot and event:
  ``drain`` hands back the copies whose events have completed (it never
  blocks) and only then drops their snapshots, so the caching allocator never
  reuses a snapshot's memory while the copy reads it; ``wait_all`` waits for
  the rest and raises if they do not land in time;
- a slot freed after a re-admission records an event on the serving stream,
  after the h2d that read it; the next d2h into that slot makes the spill
  stream wait on it, so a slot is never overwritten before its h2d landed.

No thread is involved (the reference runs the d2h readback on a worker
thread): the copy engine does the work, and every CUDA call comes from the
serving thread, so none can fall inside a CUDA graph capture. On a CPU engine
the slabs are plain tensors and ``spill_async`` copies the snapshot into its
slot at once; ``drain`` hands the landing back as on the card.
"""

import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["HostKVPool", "SpillManager"]


class HostKVPool:
    """Fixed-capacity host slab holding per-block KV slices.

    One slab per device-pool leaf; slot ``i`` of every slab together holds one
    block's KV across all layers (each slab is ``(capacity,) + leaf shape``
    with the block axis dropped). ``pin``: page-locked slabs (a CUDA engine).
    """

    def __init__(self, capacity_blocks: int, leaf_shapes: Sequence[Tuple[int, ...]],
                 leaf_dtypes: Sequence[torch.dtype], pin: bool = False) -> None:
        if capacity_blocks < 0:
            raise ValueError(f"capacity_blocks must be >= 0, got {capacity_blocks}")
        self._capacity = int(capacity_blocks)
        self.pinned = bool(pin)
        self._slabs: List[torch.Tensor] = [
            torch.empty((self._capacity,) + tuple(shape), dtype=dtype, pin_memory=True) if pin
            else torch.zeros((self._capacity,) + tuple(shape), dtype=dtype)
            for shape, dtype in zip(leaf_shapes, leaf_dtypes)]
        # LIFO free list, same discipline as BlockedAllocator: a just-freed slot is reused first
        self._free: List[int] = list(range(self._capacity - 1, -1, -1))
        # pinned pools: slot -> event recorded after the last h2d that read the slot
        self._read_events = {}

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def used_slots(self) -> int:
        return self._capacity - len(self._free)

    @property
    def bytes_per_slot(self) -> int:
        return sum(s[0].numel() * s.element_size() for s in self._slabs) if self._capacity else 0

    @property
    def used_bytes(self) -> int:
        return self.used_slots * self.bytes_per_slot

    def try_alloc_slot(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def free_slot(self, slot: int) -> None:
        """Return ``slot`` to the free list. A pinned pool records an event on
        the current CUDA stream: a re-admission's h2d from this slot was
        issued there just before, and the next write into the slot waits on
        it (``write``)."""
        if not (0 <= slot < self._capacity):
            raise ValueError(f"host slot {slot} out of range")
        if slot in self._free:
            raise ValueError(f"double free of host slot {slot}")
        if self.pinned:
            ev = torch.cuda.Event()
            ev.record()
            self._read_events[slot] = ev
        self._free.append(slot)

    def write(self, slot: int, leaves: Sequence[torch.Tensor]) -> None:
        """Copy one block's snapshot leaves (each ``(L, 1, ...)``) into
        ``slot``. Pinned: issued on the current stream (the spill stream),
        after the slot's last h2d read; returns before the copy lands.
        Otherwise a blocking copy."""
        ev = self._read_events.pop(slot, None)
        if ev is not None:
            torch.cuda.current_stream().wait_event(ev)
        for slab, leaf in zip(self._slabs, leaves):
            slab[slot].copy_(leaf.squeeze(1), non_blocking=self.pinned)

    def read(self, slot: int) -> List[torch.Tensor]:
        """Host views of ``slot``'s leaves. The re-admission copies them to the
        device right away and frees the slot after issuing the copy
        (``free_slot`` orders any later write after it)."""
        return [slab[slot] for slab in self._slabs]


class SpillManager:
    """The d2h side of the tier: ``gather_fn(block)`` (the engine's snapshot of
    the block's pages, one ``(L, 1, ...)`` tensor per pool leaf) and the copy
    into the host slot are issued on the serving thread, so the device work
    stays ordered with the steps; ``drain`` reports the landed copies.
    ``device``: the engine's device (CUDA: the copy runs on a dedicated
    stream)."""

    def __init__(self, pool: HostKVPool, gather_fn: Callable[[int], Sequence[torch.Tensor]],
                 device: Optional[torch.device] = None) -> None:
        self._pool = pool
        self._gather = gather_fn
        self._stream = torch.cuda.Stream(device) if pool.pinned else None
        # (block, slot, snapshot leaves, d2h event), in issue order: one stream lands them in that order
        self._pending: deque = deque()

    @property
    def pool(self) -> HostKVPool:
        return self._pool

    @property
    def inflight(self) -> int:
        """Copies issued and not yet handed back by ``drain``."""
        return len(self._pending)

    def spill_async(self, block: int, slot: int) -> None:
        """Snapshot ``block`` and issue its d2h into ``slot``."""
        leaves = self._gather(block)
        done = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record()  # after the gather, on the serving stream
            self._stream.wait_event(ready)
            with torch.cuda.stream(self._stream):
                self._pool.write(slot, leaves)
                done = torch.cuda.Event()
                done.record()
        else:
            self._pool.write(slot, leaves)
            leaves = None
        self._pending.append((block, slot, leaves, done))

    def drain(self) -> List[Tuple[int, int]]:
        """Collect every landed (block, slot) pair, in issue order; never
        blocks. The landed snapshots are dropped here."""
        out = []
        while self._pending and (self._pending[0][3] is None or self._pending[0][3].query()):
            block, slot, _, _ = self._pending.popleft()
            out.append((block, slot))
        return out

    def wait_all(self, timeout: float = 60.0) -> None:
        """Block until every issued d2h has landed (``drain`` then hands them
        all back). Raises ``TimeoutError`` if they have not after
        ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        for _, _, _, done in self._pending:
            while done is not None and not done.query():
                if time.monotonic() > deadline:
                    n = sum(1 for *_, d in self._pending if d is not None and not d.query())
                    raise TimeoutError(f"{n} KV spill copies still in flight after {timeout} s")
                time.sleep(2e-5)
