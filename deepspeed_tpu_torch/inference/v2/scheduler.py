"""Continuous-batching scheduler.

Port of ``deepspeed_tpu/inference/v2/scheduler.py``: a FIFO queue with
chunked prefill, a per-step token budget and decode-priority admission
(decodes are one token each and keep latency low; prefills fill the rest
of the budget), in the style of FastGen's Dynamic SplitFuse.
``schedule_fused`` repackages a step as the ``FusedQuantum`` descriptor
that the single-dispatch step consumes; ``schedule_spec`` admits the rows
of a speculative draft -> verify quantum. Events, journal and telemetry
come with later slices.
"""

from dataclasses import dataclass, field
from typing import List

from .ragged.manager import DSStateManager


@dataclass
class RaggedRequest:
    uid: int
    tokens: List[int]  # prompt tokens not yet prefilled
    max_new_tokens: int = 64
    generated: List[int] = field(default_factory=list)
    done: bool = False

    @property
    def remaining_prefill(self) -> int:
        return len(self.tokens)


@dataclass
class ScheduledPrefill:
    uid: int
    tokens: List[int]
    start_pos: int
    final: bool = False  # last chunk of the prompt: this row emits a token


@dataclass
class ScheduledStep:
    prefills: List[ScheduledPrefill]
    decode_uids: List[int]

    @property
    def empty(self) -> bool:
        return not self.prefills and not self.decode_uids


@dataclass
class FusedQuantum:
    """One fused scheduler quantum: decode rows first, then prefill rows,
    each carrying its (start, len, is_final) metadata."""
    prefills: List[ScheduledPrefill]
    decode_uids: List[int]

    @property
    def empty(self) -> bool:
        return not self.prefills and not self.decode_uids

    @property
    def n_rows(self) -> int:
        return len(self.prefills) + len(self.decode_uids)

    @property
    def total_tokens(self) -> int:
        return len(self.decode_uids) + sum(len(p.tokens) for p in self.prefills)


class RaggedBatchScheduler:

    def __init__(self, state: DSStateManager, max_batch_tokens: int = 768, max_sequences: int = 512,
                 prefill_chunk: int = 512):
        self._state = state
        self.max_batch_tokens = max_batch_tokens
        self.max_sequences = max_sequences
        self.prefill_chunk = prefill_chunk

    def schedule(self, pending_prefills: List[RaggedRequest], decode_uids: List[int]) -> ScheduledStep:
        """Pick the work for one engine step: decodes first (1 token each),
        then FIFO prefills chunked to ``prefill_chunk`` within the remaining
        token budget. A request is admitted only if its KV blocks fit."""
        bs = self._state.block_size
        budget = self.max_batch_tokens
        seqs = 0
        sched_decodes: List[int] = []
        # plan against free + cache-reclaimable blocks: the allocator's
        # eviction hook reclaims on demand, so cached prefixes never
        # back-pressure admission into a deadlock
        free = self._state.available_blocks

        for uid in decode_uids:
            seq = self._state.get_sequence(uid)
            if seq is None or budget < 1 or seqs >= self.max_sequences:
                continue
            need = seq.blocks_needed(1) + seq.cow_blocks_needed(seq.seen_tokens)
            if need > free:
                continue  # back-pressure: leave it for the next step
            free -= need
            budget -= 1
            seqs += 1
            sched_decodes.append(uid)

        prefills: List[ScheduledPrefill] = []
        for req in pending_prefills:
            if budget <= 0 or seqs >= self.max_sequences:
                break
            seq = self._state.get_sequence(req.uid)
            if seq is None:
                # first sight: match the longest cached block-aligned prefix
                # and trim the request to its uncached suffix
                seq = self._state.admit_sequence(req.uid, req.tokens)
                if seq.seen_tokens:
                    req.tokens = req.tokens[seq.seen_tokens:]
            take = min(req.remaining_prefill, self.prefill_chunk, budget)
            if take <= 0:
                continue
            total = seq.seen_tokens + take
            need = (-(-total // bs) - len(seq.blocks) + seq.cow_blocks_needed(seq.seen_tokens))
            if need > free:
                break  # FIFO: do not let later requests starve this one
            free -= max(0, need)
            budget -= take
            seqs += 1
            final = take == req.remaining_prefill
            prefills.append(ScheduledPrefill(uid=req.uid, tokens=req.tokens[:take], start_pos=seq.seen_tokens,
                                             final=final))
        return ScheduledStep(prefills=prefills, decode_uids=sched_decodes)

    def schedule_spec(self, decode_uids: List[int], tokens_per_row: int) -> List[int]:
        """Admit pure-decode rows for a draft -> verify quantum: each row costs
        ``tokens_per_row`` (the carry token and K drafts) of the token budget
        and must fit ``blocks_needed(tokens_per_row)`` plus its copy-on-write
        blocks in the available pool, the back-pressure of ``schedule`` with
        the row's footprint scaled to the verify window. A row whose window
        would pass ``max_context`` or that does not fit stays in the caller's
        decode set for a later step. Returns the admitted uids."""
        budget = self.max_batch_tokens
        free = self._state.available_blocks
        admitted: List[int] = []
        for uid in decode_uids:
            seq = self._state.get_sequence(uid)
            if seq is None:
                continue
            if budget < tokens_per_row or len(admitted) >= self.max_sequences:
                break
            if seq.seen_tokens + seq.in_flight_tokens + tokens_per_row > self._state.max_context:
                continue  # the verify window would overflow this row's context
            need = seq.blocks_needed(tokens_per_row) + seq.cow_blocks_needed(seq.seen_tokens)
            if need > free:
                continue  # back-pressure: leave it for the next step
            free -= need
            budget -= tokens_per_row
            admitted.append(uid)
        return admitted

    def schedule_fused(self, pending_prefills: List[RaggedRequest], decode_uids: List[int]) -> FusedQuantum:
        """One fused quantum: ``schedule``'s admission policy, repackaged as
        the ragged-batch descriptor the single-dispatch step consumes."""
        step = self.schedule(pending_prefills, decode_uids)
        return FusedQuantum(prefills=step.prefills, decode_uids=step.decode_uids)
