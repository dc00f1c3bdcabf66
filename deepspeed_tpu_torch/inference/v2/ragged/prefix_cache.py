"""Radix prefix cache: block-granular KV reuse across requests.

Port of ``deepspeed_tpu/inference/v2/ragged/prefix_cache.py`` without the
host spill tier. One tree node is one *full* KV block, keyed by the tuple
of ``block_size`` token ids it covers; a root-to-node path spells a
block-aligned prefix. Every node holds one refcount on its block, and
``match`` retains matched blocks for the caller's sequence, so a cached
block is freed only when the cache and every sequence using it let go.
Cached blocks are immutable (writers copy-on-write first). Under
allocation pressure the allocator's eviction hook drops least-recently-
used unshared leaves down to a free-block watermark, so the cache never
deadlocks admission. Partial blocks are never cached.
"""

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .blocked_allocator import BlockedAllocator


class _RadixNode:
    __slots__ = ("key", "block", "parent", "children", "stamp")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int, parent: Optional["_RadixNode"]):
        self.key = key        # the block_size token ids this node's block covers
        self.block = block    # KV block id (-1 at the root)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.stamp = 0        # LRU clock of the last match/insert touching this node


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
        allocator.set_eviction_hook(self._on_pressure)

    @property
    def block_size(self) -> int:
        return self._bs

    @property
    def cached_blocks(self) -> int:
        return self._nodes

    def _iter_nodes(self) -> Iterator[_RadixNode]:
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def reclaimable_blocks(self) -> int:
        """Cached blocks no live sequence shares: what eviction could free now."""
        return sum(1 for n in self._iter_nodes() if self._alloc.refcount(n.block) == 1)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached block-aligned prefix of ``tokens``: ``(blocks,
        n_tokens)``. Each returned block is retained for the caller's
        sequence (released normally via ``flush_sequence``)."""
        node, blocks = self._root, []
        stamp = self._tick()
        i = 0
        while i + self._bs <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + self._bs]))
            if child is None:
                break
            self._alloc.retain(child.block)
            blocks.append(child.block)
            child.stamp = stamp
            node = child
            i += self._bs
        return blocks, len(blocks) * self._bs

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Insert/promote a retiring sequence's block-aligned prefix. Takes
        ownership of the sequence's reference on EVERY block: block ``i``
        becomes the node for ``tokens[i*bs:(i+1)*bs]`` or is released
        (duplicate, partial tail, or tokens unknown to the host). Returns
        nodes created."""
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
            else:
                # duplicate prefix (or our own shared block): the cache
                # already holds a reference — drop the sequence's
                self._alloc.release([blocks[i]])
            child.stamp = stamp
            node = child
        self._alloc.release(blocks[n_full:])
        return created

    def _evict_node(self, node: _RadixNode) -> None:
        del node.parent.children[node.key]
        self._nodes -= 1
        self._alloc.release([node.block])

    def _lru_leaf(self) -> Optional[_RadixNode]:
        """Least-recently-used unshared leaf, or None."""
        best = None
        for n in self._iter_nodes():
            if n.children or self._alloc.refcount(n.block) != 1:
                continue
            if best is None or n.stamp < best.stamp:
                best = n
        return best

    def evict(self, want_free: int) -> int:
        """Drop LRU unshared leaves until ``want_free`` blocks are free.
        Returns nodes evicted."""
        evicted = 0
        while self._alloc.free_blocks < want_free and self._nodes:
            leaf = self._lru_leaf()
            if leaf is None:
                break  # every remaining node is shared
            self._evict_node(leaf)
            evicted += 1
        return evicted

    def _on_pressure(self, shortfall: int) -> None:
        # allocator eviction hook: free the shortfall plus the watermark
        self.evict(self._alloc.free_blocks + shortfall + self._watermark_blocks)

    def clear(self) -> int:
        """Drop every unshared cached block. Returns nodes evicted."""
        return self.evict(self._alloc.total_blocks + self._nodes + 1)
