"""Shadow-refcount sanitizer for the paged-KV block economy.

Port of ``deepspeed_tpu/analysis/kv_sanitizer.py`` (framework-free, the same
traps and messages). Enabled via ``DS_TPU_KV_SANITIZE``. The state manager
installs a :class:`ShadowRefcounts` into the block allocator; every
``allocate``/``retain``/``release`` is mirrored into an independent shadow
table, and three invariant classes are trapped with precise messages:

- **double-free**: releasing a block the shadow table says has no holders
  (caught before the allocator mutates, so allocator and shadow stay in
  lockstep and the report names the exact block);
- **write-to-shared-without-COW**: ``DSStateManager.sanitize_write`` is
  called by the engine at every dispatch-assembly site with the exact KV
  positions about to be written; any covered block with refcount > 1
  means copy-on-write was skipped and a cached/shared page would be
  corrupted;
- **leak-at-flush**: ``DSStateManager.flush_all`` cross-checks every
  allocated block against what is reachable from live sequence
  descriptors, radix-tree nodes, and registered engine roots (the garbage
  page); allocated-but-unreachable blocks can never be freed again.

``verify_against`` additionally detects shadow-vs-allocator refcount drift,
which would indicate an allocator mutation that bypassed the public API.

With the host spill tier three **residency** invariants join the mirror:

- **dispatch-of-non-resident-block**: ``check_write`` (the same
  dispatch-assembly hook) traps any block in the batch's table whose
  residency is HOST or IN_FLIGHT: its device pages are gone or about to
  be reused, so the kernel would read garbage;
- **spill-of-shared-block**: ``on_spill`` (mirrored from
  ``BlockedAllocator.mark_residency``) traps a spill of a block the
  shadow table says has more than one holder: a live sequence could
  still dispatch reads against it while the d2h is in flight;
- **readmit-refcount drift**: ``check_readmit`` traps a re-admitted
  block whose shadow and allocator counts disagree, or whose count is
  not exactly the cache's single fresh hold.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set


class KVSanitizerError(RuntimeError):
    """A paged-KV refcount/COW invariant was violated."""


class ShadowRefcounts:
    """Independent mirror of the allocator's per-block holder counts."""

    def __init__(self) -> None:
        self._rc: Dict[int, int] = {}

    # ------------------------------------------------------ allocator hooks
    def on_allocate(self, blocks: Iterable[int]) -> None:
        for b in blocks:
            if self._rc.get(b, 0) > 0:
                raise KVSanitizerError(
                    f"KV sanitizer: allocator handed out block {b} which the shadow "
                    f"table says is still live (refcount {self._rc[b]})")
            self._rc[b] = 1

    def on_retain(self, block: int) -> None:
        if self._rc.get(block, 0) <= 0:
            raise KVSanitizerError(
                f"KV sanitizer: retain of block {block} which has no live holders")
        self._rc[block] += 1

    def on_release(self, block: int) -> None:
        count = self._rc.get(block, 0)
        if count <= 0:
            raise KVSanitizerError(
                f"KV sanitizer: double free of block {block} (shadow refcount is "
                "already 0 — some holder released it twice)")
        if count == 1:
            del self._rc[block]
        else:
            self._rc[block] = count - 1

    # ------------------------------------------------------------- queries
    def refcount(self, block: int) -> int:
        return self._rc.get(block, 0)

    def live_blocks(self) -> Set[int]:
        return set(self._rc)

    # ------------------------------------------------------ residency hooks
    def on_spill(self, block: int, allocator_rc: int) -> None:
        """Trap a spill of a block some live sequence still shares."""
        shadow = self._rc.get(block, 0)
        if shadow != 1 or allocator_rc != 1:
            raise KVSanitizerError(
                f"KV sanitizer: spill of shared block {block} (allocator refcount "
                f"{allocator_rc}, shadow {shadow}) — a live holder could dispatch "
                "reads against its HBM pages while the d2h copy is in flight")

    def check_readmit(self, block: int, allocator_rc: int) -> None:
        """Trap refcount drift on a block just re-admitted from the host
        tier: it must carry exactly the cache's single fresh hold."""
        shadow = self._rc.get(block, 0)
        if shadow != allocator_rc or shadow != 1:
            raise KVSanitizerError(
                f"KV sanitizer: readmit refcount drift on block {block}: "
                f"allocator says {allocator_rc}, shadow table says {shadow} "
                "(a re-admitted block must hold exactly the cache's one "
                "reference before the caller retains it)")

    # ------------------------------------------------------------ checking
    def check_write(self, seq_uid: int, blocks: List[int], start_pos: int,
                    n_tokens: int, block_size: int,
                    refcount_of,
                    residency_of: Optional[Callable[[int], str]] = None) -> None:
        """Trap a KV write into a block some other holder shares, and —
        when residency tracking is on — any block in the dispatch's table
        whose HBM pages are spilled (HOST) or mid-spill (IN_FLIGHT)."""
        if residency_of is not None:
            for idx, b in enumerate(blocks):
                res = residency_of(b)
                if res != "hbm":
                    raise KVSanitizerError(
                        f"KV sanitizer: sequence {seq_uid} is assembling a dispatch "
                        f"over block {b} (table index {idx}) whose residency is "
                        f"{res.upper()} — its HBM pages are "
                        f"{'being copied out' if res == 'inflight' else 'released'}, "
                        "so the kernel would read stale or reused memory; re-admit "
                        "the block (h2d) before dispatching")
        if n_tokens <= 0:
            return
        first = start_pos // block_size
        last = (start_pos + n_tokens - 1) // block_size
        for idx in range(first, min(last + 1, len(blocks))):
            b = blocks[idx]
            rc = refcount_of(b)
            if rc > 1:
                raise KVSanitizerError(
                    f"KV sanitizer: sequence {seq_uid} is writing positions "
                    f"[{start_pos}, {start_pos + n_tokens}) into block {b} "
                    f"(refcount {rc}) without copy-on-write — a shared/cached "
                    "page would be corrupted")

    def check_leaks(self, allocated: Iterable[int], reachable: Set[int]) -> None:
        leaked = sorted(set(allocated) - reachable)
        if leaked:
            raise KVSanitizerError(
                f"KV sanitizer: {len(leaked)} block(s) leaked at flush: {leaked} "
                "— allocated but unreachable from any live sequence, cache node, "
                "or registered root, so they can never be freed")

    def verify_against(self, refcounts: List[int]) -> None:
        """Shadow vs allocator drift (a mutation bypassed the public API)."""
        for b, rc in enumerate(refcounts):
            if rc != self._rc.get(b, 0):
                raise KVSanitizerError(
                    f"KV sanitizer: refcount drift on block {b}: allocator says "
                    f"{rc}, shadow table says {self._rc.get(b, 0)}")
