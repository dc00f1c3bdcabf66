"""Radix prefix cache: block-granular KV reuse across requests.

Port of ``deepspeed_tpu/inference/v2/ragged/prefix_cache.py``. One tree node
is one *full* KV block, keyed by the tuple of ``block_size`` token ids it
covers; a root-to-node path spells a block-aligned prefix. Every node holds
one refcount on its block, and ``match`` retains matched blocks for the
caller's sequence, so a cached block is freed only when the cache and every
sequence using it let go. Cached blocks are immutable (writers
copy-on-write first). Under allocation pressure the allocator's eviction
hook reclaims least-recently-used unshared nodes down to a free-block
watermark, so the cache never deadlocks admission. Partial blocks are never
cached: ``insert`` takes ownership of a retiring sequence's blocks and
releases everything past the last fully known block.

**Host spill tier** (``attach_spill_tier``): with a
:class:`~.host_tier.SpillManager` attached, eviction *demotes* instead of
forgetting: the LRU unshared node's block is snapshotted on the device and
copied to a host slot on a stream of its own (residency ``HBM ->
IN_FLIGHT``, then ``-> HOST`` when the copy lands and the device block is
released; the node stays in the tree with ``block == -1`` and its
``host_slot``). A later ``match`` that walks onto a spilled node re-admits
it: one fresh device block and one h2d copy instead of a prefill of those
tokens. ``insert`` promotes a spilled node it walks through by adopting the
retiring sequence's live block, and the host pool drops its own LRU entries
when full, so both tiers stay bounded. A node being re-admitted is never
the host-LRU entry dropped to make room for a spill (where the reference
can drop it and hand its slot to that spill).

Counters (``kv_prefix_*``, ``kv_spill_blocks_total``, ``kv_readmit_*``) and
gauges (``kv_cached_blocks``, ``kv_spilled_blocks``) go to the telemetry
registry, and ``spill`` / ``readmit`` / ``evict`` records to the event log,
under the reference's names, and each re-admission's tokens go to the perf
accountant's goodput ledger (``note_readmit``), priced as saved prefill.
"""

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ....telemetry import get_event_log, get_registry as get_telemetry_registry
from ....telemetry.costs import get_perf_accountant
from .blocked_allocator import RES_HOST, RES_INFLIGHT, BlockedAllocator


class _RadixNode:
    __slots__ = ("key", "block", "parent", "children", "stamp", "host_slot")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int, parent: Optional["_RadixNode"]):
        self.key = key        # the block_size token ids this node's block covers
        self.block = block    # KV block id (-1 at the root / when spilled to host)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.stamp = 0        # LRU clock of the last match/insert touching this node
        self.host_slot = -1   # host-tier slot (>= 0 once spilling/spilled)


class PrefixCache:

    def __init__(self, allocator: BlockedAllocator, block_size: int, watermark: float = 0.05):
        self._alloc = allocator
        self._bs = int(block_size)
        # eviction drains past the immediate shortfall to this fraction of
        # the pool, so one pressured allocate doesn't thrash the hook
        self._watermark_blocks = int(watermark * allocator.total_blocks)
        self._root = _RadixNode(None, -1, None)
        self._nodes = 0
        self._clock = 0
        tele = get_telemetry_registry()
        self._m_hits = tele.counter("kv_prefix_hits_total")
        self._m_hit_tokens = tele.counter("kv_prefix_hit_tokens_total")
        self._m_evictions = tele.counter("kv_prefix_evictions_total")
        self._m_cached = tele.gauge("kv_cached_blocks")
        # host spill tier (attach_spill_tier; zero-valued while detached)
        self._m_spilled = tele.gauge("kv_spilled_blocks")
        self._m_spill_total = tele.counter("kv_spill_blocks_total")
        self._m_readmit = tele.counter("kv_readmit_total")
        self._m_readmit_tokens = tele.counter("kv_readmit_tokens_total")
        self._events = get_event_log()
        self._spill = None        # host_tier.SpillManager once attached
        self._readmitting = None  # the node _readmit is finding a block for
        self._scatter = None      # engine closure: (block, host leaves) -> h2d
        self._spill_watermark_blocks = 0
        self._inflight: Dict[int, _RadixNode] = {}  # host slot -> node mid-d2h
        self._spilled = 0         # nodes resident on host only (block == -1)
        allocator.set_eviction_hook(self._on_pressure)

    @property
    def block_size(self) -> int:
        return self._bs

    @property
    def cached_blocks(self) -> int:
        """HBM-resident cached blocks (spilled nodes are counted by
        ``spilled_blocks`` instead — their HBM block is released)."""
        return self._nodes

    @property
    def spilled_blocks(self) -> int:
        """Nodes whose KV lives only in the host tier."""
        return self._spilled

    @property
    def host_tier_bytes(self) -> int:
        """Host-RAM bytes the spill pool currently holds."""
        return self._spill.pool.used_bytes if self._spill is not None else 0

    def attach_spill_tier(self, spill, scatter_fn, watermark_blocks: int = 0) -> None:
        """Enable the host spill tier: ``spill`` is a
        :class:`~.host_tier.SpillManager` (owns the d2h copies and the
        host pool); ``scatter_fn(block, host_leaves)`` is the engine's
        h2d re-admit into the device pools; ``watermark_blocks``
        is the free-block target ``spill_tick`` pre-spills toward."""
        self._spill = spill
        self._scatter = scatter_fn
        self._spill_watermark_blocks = max(0, int(watermark_blocks))

    def _iter_nodes(self) -> Iterator[_RadixNode]:
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def reclaimable_blocks(self) -> int:
        """Cached HBM blocks no live sequence shares — what eviction (or
        an in-flight spill landing) could free right now. Admission
        accounting treats these as available; spilled nodes hold no HBM
        block, so they are excluded."""
        return sum(1 for n in self._iter_nodes()
                   if n.block >= 0 and self._alloc.refcount(n.block) == 1)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached block-aligned prefix of ``tokens``.

        Returns ``(blocks, n_tokens)``; each returned block has been
        ``retain``-ed on behalf of the caller's sequence (the caller owns
        releasing them, normally via ``flush_sequence``).

        A walk that lands on a *spilled* node re-admits it from the host
        tier (fresh HBM block + h2d copy) before retaining —
        the caller sees a plain hit and skips re-prefilling those
        tokens. If no HBM block can be found even after eviction, the
        walk stops there: the suffix prefills normally, admission never
        deadlocks on the host tier.
        """
        node, blocks = self._root, []
        stamp = self._tick()
        i = 0
        while i + self._bs <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + self._bs]))
            if child is None:
                break
            if child.host_slot >= 0 and not self._readmit(child):
                break
            self._alloc.retain(child.block)
            blocks.append(child.block)
            child.stamp = stamp
            node = child
            i += self._bs
        if blocks:
            self._m_hits.inc()
            self._m_hit_tokens.inc(len(blocks) * self._bs)
        return blocks, len(blocks) * self._bs

    def _readmit(self, node: _RadixNode) -> bool:
        """Bring a spilled node's KV back to a fresh HBM block via h2d."""
        if self._spill is None or self._scatter is None:
            return False
        if node.block >= 0:
            # the d2h is still in flight (evicted and re-requested within
            # one spill latency): let it land, release the old block, then
            # re-admit from the host copy like any other spilled node
            self._spill.wait_all()
            self._drain_spills()
        # the allocation may evict, and a spill there may drop host-LRU leaves to find a slot: never this
        # node, whose slot is about to be read (the reference can drop it and reuse its slot)
        self._readmitting = node
        try:
            blk = self._alloc.allocate(1)[0]
        except RuntimeError:
            return False  # pool full of live blocks: treat as a cache miss
        finally:
            self._readmitting = None
        slot = node.host_slot
        self._scatter(blk, self._spill.pool.read(slot))
        self._spill.pool.free_slot(slot)
        node.host_slot = -1
        node.block = blk
        self._spilled -= 1
        self._nodes += 1
        san = self._alloc.sanitizer
        if san is not None:
            san.check_readmit(blk, self._alloc.refcount(blk))
        self._m_readmit.inc()
        self._m_readmit_tokens.inc(self._bs)
        self._m_cached.set(self._nodes)
        self._m_spilled.set(self._spilled)
        # goodput ledger: these tokens came back over an h2d copy instead of re-running prefill
        get_perf_accountant().note_readmit(self._bs)
        self._events.emit("readmit", blocks=1, tokens=self._bs)
        return True

    # ------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Insert/promote a retiring sequence's block-aligned prefix.

        Takes ownership of the sequence's reference on EVERY block in
        ``blocks``: block ``i`` either becomes the node for
        ``tokens[i*bs:(i+1)*bs]`` (reference transfers to the cache) or
        is released (already-cached duplicate, partial tail, or tokens
        unknown to the host). ``tokens`` is the sequence's host-known
        token log clipped to its KV coverage. Returns nodes created.
        """
        bs = self._bs
        n_full = min(len(tokens) // bs, len(blocks))
        node = self._root
        stamp = self._tick()
        created = 0
        for i in range(n_full):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key, blocks[i], node)
                node.children[key] = child
                self._nodes += 1
                created += 1
            elif child.block < 0:
                # spilled copy superseded: the retiring sequence carries a
                # live HBM block with the same content — adopt it (free
                # readmit) and drop the host copy
                self._spill.pool.free_slot(child.host_slot)
                child.host_slot = -1
                child.block = blocks[i]
                self._spilled -= 1
                self._m_spilled.set(self._spilled)
                self._nodes += 1
                created += 1
            else:
                # duplicate prefix (or our own shared block): the cache
                # already holds a reference — drop the sequence's
                self._alloc.release([blocks[i]])
            child.stamp = stamp
            node = child
        self._alloc.release(blocks[n_full:])
        self._m_cached.set(self._nodes)
        return created

    # ------------------------------------------------------------ eviction
    def _evict_node(self, node: _RadixNode) -> None:
        del node.parent.children[node.key]
        self._nodes -= 1
        self._alloc.release([node.block])
        self._m_evictions.inc()

    def _lru_candidate(self, require_leaf: bool) -> Optional[_RadixNode]:
        """Least-recently-used unshared HBM-resident node, or None.

        Plain eviction (``require_leaf``) must only take leaves — the
        node is deleted and children would be orphaned. Spilling keeps
        the node in the tree (``block = -1``), so ANY unshared node
        qualifies: a chain demotes top-down without ever orphaning, and
        ``match`` re-admits along the path in walk order."""
        best = None
        for n in self._iter_nodes():
            if n.block < 0 or n.host_slot >= 0:
                continue  # spilled, or already mid-spill
            if require_leaf and n.children:
                continue
            if self._alloc.refcount(n.block) != 1:
                continue  # shared with a live sequence
            if best is None or n.stamp < best.stamp:
                best = n
        return best

    def _spill_node(self, node: _RadixNode) -> bool:
        """Demote one node: host slot + residency IN_FLIGHT + async d2h.
        The HBM block frees only when the copy lands (``_drain_spills``)."""
        slot = self._spill.pool.try_alloc_slot()
        while slot is None and self._drop_host_lru():
            slot = self._spill.pool.try_alloc_slot()
        if slot is None:
            return False  # zero-capacity host pool
        self._alloc.mark_residency(node.block, RES_INFLIGHT)
        self._spill.spill_async(node.block, slot)
        node.host_slot = slot
        self._inflight[slot] = node
        self._m_spill_total.inc()
        self._events.emit("spill", blocks=1)
        return True

    def _drain_spills(self) -> int:
        """Collect landed d2h copies: release each HBM block (residency
        HOST) and mark its node host-only. Returns blocks released."""
        n = 0
        for block, slot in self._spill.drain():
            node = self._inflight.pop(slot)
            self._alloc.mark_residency(block, RES_HOST)
            self._alloc.release([block])
            node.block = -1
            self._nodes -= 1
            self._spilled += 1
            n += 1
        if n:
            self._m_cached.set(self._nodes)
            self._m_spilled.set(self._spilled)
        return n

    def _drop_host_lru(self) -> bool:
        """Forget the LRU host-resident node entirely (host pool full)."""
        victim = None
        for n in self._iter_nodes():
            if n.block >= 0 or n.children or n is self._readmitting:
                continue
            if victim is None or n.stamp < victim.stamp:
                victim = n
        if victim is None:
            return False
        self._spill.pool.free_slot(victim.host_slot)
        del victim.parent.children[victim.key]
        self._spilled -= 1
        self._m_spilled.set(self._spilled)
        return True

    def evict(self, want_free: int) -> int:
        """Make ``want_free`` blocks free by dropping (or, with the host
        tier attached, spilling) LRU unshared leaves. Spills satisfy the
        target only once their d2h lands, so a pressured evict waits for
        the in-flight copies at the end. Returns nodes evicted/spilled."""
        spill = self._spill
        evicted = 0
        pending = self._drain_spills() if spill is not None else 0
        while self._alloc.free_blocks + pending < want_free and self._nodes:
            if spill is not None:
                node = self._lru_candidate(require_leaf=False)
                if node is not None and self._spill_node(node):
                    pending += 1
                    evicted += 1
                    continue
            leaf = self._lru_candidate(require_leaf=True)
            if leaf is None:
                break  # every remaining node is shared or mid-spill
            self._evict_node(leaf)
            evicted += 1
        if spill is not None and self._inflight:
            spill.wait_all()
            self._drain_spills()
        if evicted:
            self._m_cached.set(self._nodes)
            self._events.emit("evict", blocks=evicted)
        return evicted

    def spill_tick(self) -> int:
        """Watermark pre-spiller, called by the serving loops between
        dispatches: while the free pool sits below the spill watermark,
        start demoting LRU leaves so the d2h overlaps decode compute and
        a later pressured allocate mostly finds landed copies to drain
        instead of paying the copy latency inline. Never blocks."""
        if self._spill is None:
            return 0
        self._drain_spills()
        avail = self._alloc.free_blocks + len(self._inflight)
        n = 0
        while avail < self._spill_watermark_blocks:
            node = self._lru_candidate(require_leaf=False)
            if node is None or not self._spill_node(node):
                break
            avail += 1
            n += 1
        return n

    def _on_pressure(self, shortfall: int) -> None:
        # allocator eviction hook: free the shortfall plus the watermark
        self.evict(self._alloc.free_blocks + shortfall + self._watermark_blocks)

    def clear(self) -> int:
        """Drop every unshared cached block (live-shared nodes survive
        until their sequences flush) and forget every host-tier copy.
        Returns nodes evicted."""
        n = self.evict(self._alloc.total_blocks + self._nodes + 1)
        if self._spill is not None:
            while self._drop_host_lru():
                n += 1
        return n
