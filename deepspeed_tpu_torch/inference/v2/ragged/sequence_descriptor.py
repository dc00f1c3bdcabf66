"""Per-sequence KV bookkeeping.

Port of ``deepspeed_tpu/inference/v2/ragged/sequence_descriptor.py``
(``DSSequenceDescriptor``), line for line: a live sequence's seen tokens,
its KV block ids, the in-flight tokens of the current step, the leading
blocks shared with the prefix cache (copy-on-write before any write), and
the host-side token log that lets a retiring prefix enter the radix tree.
"""

from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class DSSequenceDescriptor:
    uid: int
    block_size: int
    seen_tokens: int = 0  # tokens whose KV already lives in the cache
    blocks: List[int] = field(default_factory=list)
    in_flight_tokens: int = 0  # tokens in the currently-running forward
    # prefix-cache state: blocks[:shared_blocks] are cache-owned and
    # immutable (copy-on-write before any KV write lands in them)
    shared_blocks: int = 0
    # host-known token ids aligned with the KV slots, prompt side only —
    # decode tokens may live on the device (deferred serving), so the log
    # freezes at the first unknown write and the cacheable prefix is
    # whatever full blocks it still covers
    token_log: List[int] = field(default_factory=list)
    token_log_open: bool = True

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.blocks)

    @property
    def max_context(self) -> int:
        return len(self.blocks) * self.block_size

    def blocks_needed(self, new_tokens: int) -> int:
        """Extra blocks required to hold ``new_tokens`` more KV entries."""
        total = self.seen_tokens + self.in_flight_tokens + new_tokens
        need = -(-total // self.block_size)  # ceil
        return max(0, need - len(self.blocks))

    def cow_blocks_needed(self, start_pos: int) -> int:
        """Shared blocks a write starting at ``start_pos`` would touch —
        each needs a private copy (upper bound for admission accounting)."""
        return max(0, self.shared_blocks - start_pos // self.block_size)

    def record_tokens(self, tokens: Optional[Sequence[int]]) -> None:
        """Append host-known token ids whose KV the imminent forward writes.
        The log is only valid while it stays aligned with the KV write
        position; a write whose ids the host never sees (deferred decode)
        breaks alignment and freezes the log for good."""
        if not self.token_log_open:
            return
        if tokens is None or len(self.token_log) != self.seen_tokens:
            self.token_log_open = False
            return
        self.token_log.extend(int(t) for t in tokens)

    def extend_blocks(self, new_blocks: List[int]) -> None:
        self.blocks.extend(new_blocks)

    def pre_forward(self, num_tokens: int) -> None:
        self.in_flight_tokens = num_tokens

    def post_forward(self) -> None:
        self.seen_tokens += self.in_flight_tokens
        self.in_flight_tokens = 0
