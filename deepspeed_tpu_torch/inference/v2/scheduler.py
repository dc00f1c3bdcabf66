"""Continuous-batching scheduler.

Port of ``deepspeed_tpu/inference/v2/scheduler.py``: a FIFO queue with
chunked prefill, a per-step token budget and decode-priority admission
(decodes are one token each and keep latency low; prefills fill the rest
of the budget), in the style of FastGen's Dynamic SplitFuse.
``schedule_fused`` repackages a step as the ``FusedQuantum`` descriptor
that the single-dispatch step consumes; ``schedule_spec`` admits the rows
of a speculative draft -> verify quantum. Every quantum takes the next id
of one monotone clock (``last_quantum_id``; the engine's out-of-band bursts
claim theirs with ``next_quantum``), emits the ``prefill_chunk`` and
``quantum`` events, records its composition in an active journal, and moves
the ``sched_*`` counters and gauges, under the reference's names.
"""

from dataclasses import dataclass, field
from typing import List, Tuple

from ...telemetry import get_event_log, get_journal, get_registry as get_telemetry_registry
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
                 prefill_chunk: int = 512, shard_degree: int = 1):
        self._state = state
        self.max_batch_tokens = max_batch_tokens
        self.max_sequences = max_sequences
        self.prefill_chunk = prefill_chunk
        # tensor-parallel serving runs this same scheduler on every rank over the same global block ids, so
        # budgets and block accounting stay in global units: the degree is recorded, nothing divides by it
        self.shard_degree = max(1, int(shard_degree))
        tele = get_telemetry_registry()
        self._m_queue_depth = tele.gauge("sched_queue_depth")
        self._m_step_tokens = tele.gauge("sched_step_tokens")
        self._m_decodes = tele.counter("sched_decodes_total")
        self._m_prefill_chunks = tele.counter("sched_prefill_chunks_total")
        self._m_quantum_rows = tele.gauge("sched_quantum_rows")
        # real (unpadded) tokens scheduled across all quanta (the steps' buckets add padding on top)
        self._m_useful = tele.counter("sched_useful_tokens_total")
        self._events = get_event_log()
        self._quantum_seq = 0  # monotone id shared by the fused and unfused paths

    @property
    def last_quantum_id(self) -> int:
        """Id of the most recently assembled quantum."""
        return self._quantum_seq

    def next_quantum(self) -> int:
        """Claim a fresh quantum id (the engine's out-of-band decode bursts
        bypass ``schedule`` and still need distinct ids)."""
        self._quantum_seq += 1
        return self._quantum_seq

    def schedule(self, pending_prefills: List[RaggedRequest], decode_uids: List[int]) -> ScheduledStep:
        """Pick the work for one engine step: decodes first (1 token each),
        then FIFO prefills chunked to ``prefill_chunk`` within the remaining
        token budget. A request is admitted only if its KV blocks fit."""
        bs = self._state.block_size
        budget = self.max_batch_tokens
        seqs = 0
        q = self.next_quantum()
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
            self._events.emit("prefill_chunk", req.uid, q=q, tokens=take, start=seq.seen_tokens, final=final)

        self._m_queue_depth.set(len(pending_prefills))
        self._m_step_tokens.set(self.max_batch_tokens - budget)
        self._m_decodes.inc(len(sched_decodes))
        self._m_prefill_chunks.inc(len(prefills))
        self._m_useful.inc(self.max_batch_tokens - budget)
        if prefills or sched_decodes:
            self._events.emit("quantum", q=q, prefills=len(prefills), decodes=len(sched_decodes),
                              tokens=self.max_batch_tokens - budget)
            journal = get_journal()
            if journal is not None and journal.active:
                journal.record_quantum(q, sched_decodes, [(p.uid, p.start_pos, len(p.tokens), p.final)
                                                          for p in prefills])
        return ScheduledStep(prefills=prefills, decode_uids=sched_decodes)

    def schedule_spec(self, decode_uids: List[int], tokens_per_row: int) -> Tuple[List[int], int]:
        """Admit pure-decode rows for a draft -> verify quantum: each row costs
        ``tokens_per_row`` (the carry token and K drafts) of the token budget
        and must fit ``blocks_needed(tokens_per_row)`` plus its copy-on-write
        blocks in the available pool, the back-pressure of ``schedule`` with
        the row's footprint scaled to the verify window. A row whose window
        would pass ``max_context`` or that does not fit stays in the caller's
        decode set for a later step. Returns the admitted uids and the
        claimed quantum id."""
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
        q = self.next_quantum()
        self._m_decodes.inc(len(admitted))
        self._m_step_tokens.set(len(admitted) * tokens_per_row)
        self._m_quantum_rows.set(len(admitted))
        self._m_useful.inc(len(admitted) * tokens_per_row)
        if admitted:
            self._events.emit("quantum", q=q, prefills=0, decodes=len(admitted),
                              tokens=len(admitted) * tokens_per_row, spec_k=tokens_per_row - 1)
            journal = get_journal()
            if journal is not None and journal.active:
                journal.record_quantum(q, admitted, [], spec_chunk=tokens_per_row)
        return admitted, q

    def schedule_fused(self, pending_prefills: List[RaggedRequest], decode_uids: List[int]) -> FusedQuantum:
        """One fused quantum: ``schedule``'s admission policy, repackaged as
        the ragged-batch descriptor the single-dispatch step consumes."""
        step = self.schedule(pending_prefills, decode_uids)
        q = FusedQuantum(prefills=step.prefills, decode_uids=step.decode_uids)
        self._m_quantum_rows.set(q.n_rows)
        return q
