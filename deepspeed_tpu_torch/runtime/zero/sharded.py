"""The ZeRO machinery of the training engine: bucketed, counted collectives
over the mesh's groups, and stage 3's gather-on-read parameters.

``Collectives`` runs every collective the engine issues over its process
groups (the ZeRO group of ``zero_axes_for``; the replica group, the ``data``
ranks that hold the same fsdp shard, when both axes exceed 1; the world)
and counts calls and bytes by op. Leaves travel in flat buckets of at most
``reduce_bucket_size`` elements: a leaf sharded on dimension ``d`` over
``W`` ranks enters a bucket as ``W`` chunks laid out rank by rank, so one
``reduce_scatter_tensor`` hands each rank the sum of its chunk and one
``all_gather_into_tensor`` rebuilds whole leaves from chunks.

``Stage3Params`` is the parameter tree that stage 3 hands the model: a
mapping whose ``params[key]`` gathers that top-level subtree's shards in the
compute dtype through ``_GatherGroup``, an autograd function whose forward
all-gathers and whose backward reduce-scatters the gradient into the
engine's shard buffers. A transformer block (``layer_<i>``, read once per
block by ``transformer_forward``) is released when the next key is read: its
buffer's storage is freed, and the tensors autograd saved from it are
packed as (offset, size, stride) into the block, so the backward gathers
the block again instead of keeping it alive. Every other key (the
embedding, read by the embedding and by the tied head, the final norm, an
untied head) is gathered once per forward and held until its gradient is
reduced. ``gathered_bytes`` / ``peak_gathered_bytes`` account for the
gathered copies.

With ZeRO-3 parameter offload (``param_offload.py``) a group's host
masters reach the device through a ``ParamStream`` first: reading
``layer_<i>`` issues ``layer_<i+1>``'s copies ahead, and gathering a block
again in the backward issues ``layer_<i-1>``'s.

A checkpointed block (the model's ``remat``, through
``activation_checkpointing``) reads ``params["layer_<i>"]`` inside the
checkpointed function, so non-reentrant checkpoint's recompute reads it
again during the backward (``in_backward`` set by the engine). That read
gathers the block once more, through a gather node whose backward does
nothing: the recompute's graph only refills the saved tensors of the
original one, whose gather node reduces the block's gradient once and then
frees the recompute's buffer. Inside the checkpointed function the
checkpoint's own saved-tensor hooks are the innermost, so ``pack`` never
sees a block's tensors there.
"""

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ... import comm as dist
from ...checkpoint.utils import unflatten_tree
from .param_offload import ParamStream
from .partition import BLOCK_KEY, ZeroPlan


class Collectives:
    """The engine's collectives, counted: ``stats[op] = [calls, bytes]``
    (bytes of the larger side: a reduce-scatter's input, an all-gather's
    output)."""

    def __init__(self, plan: ZeroPlan, zero_group, replica_group, replica_size: int, bucket: int):
        self.plan = plan
        self.zero_group = zero_group
        self.replica_group = replica_group
        self.replica_size = replica_size
        self.bucket = int(bucket)
        self.stats: Dict[str, List[int]] = {}

    def _count(self, op: str, t: torch.Tensor) -> None:
        s = self.stats.setdefault(op, [0, 0])
        s[0] += 1
        s[1] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, group="zero") -> torch.Tensor:
        """Sum ``t`` in place over the ZeRO group, the replica group or the world (``None``)."""
        self._count("all_reduce", t)
        dist.all_reduce(t, group={"zero": self.zero_group, "replica": self.replica_group}.get(group, None))
        return t

    def _buckets(self, items: Sequence, numel) -> Iterator[list]:
        bucket, n = [], 0
        for it in items:
            k = numel(it)
            if bucket and n + k > self.bucket:
                yield bucket
                bucket, n = [], 0
            bucket.append(it)
            n += k
        if bucket:
            yield bucket

    def _chunks_view(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """A full leaf seen as (W, *chunk shape): chunk r along ``dim`` at index r."""
        W = self.plan.size
        return full.unflatten(dim, (W, full.shape[dim] // W)).movedim(dim, 0)

    def reduce(self, items: Sequence[Tuple[torch.Tensor, Optional[int]]]) -> List[torch.Tensor]:
        """Sum each full tensor over the ZeRO group: this rank's chunk along the
        given dimension (a reduce-scatter), or the whole tensor where it is
        ``None`` (an all-reduce), in flat buckets."""
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        whole = [(i, t) for i, (t, d) in enumerate(items) if d is None]
        for bucket in self._buckets(whole, lambda it: it[1].numel()):
            flat = self.all_reduce(torch.cat([t.reshape(-1) for _, t in bucket]))
            off = 0
            for i, t in bucket:
                out[i] = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()
        W = self.plan.size
        parts = [(i, t, d) for i, (t, d) in enumerate(items) if d is not None]
        for bucket in self._buckets(parts, lambda it: it[1].numel()):
            n_chunk = sum(t.numel() // W for _, t, _ in bucket)
            t0 = bucket[0][1]
            send = torch.empty((W, n_chunk), dtype=t0.dtype, device=t0.device)
            off = 0
            for _, t, d in bucket:
                view = self._chunks_view(t, d)
                n = t.numel() // W
                send[:, off:off + n].view(view.shape).copy_(view)
                off += n
            recv = torch.empty(n_chunk, dtype=t0.dtype, device=t0.device)
            self._count("reduce_scatter", send)
            dist.reduce_scatter_tensor(recv, send.view(-1), group=self.zero_group)
            off = 0
            for i, t, d in bucket:
                n = t.numel() // W
                out[i] = recv[off:off + n].view(self._chunks_view(t, d).shape[1:])
                off += n
        return out

    def reduce_replicas(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum in place over the replica group (no-op without one)."""
        if self.replica_size == 1:
            return
        for bucket in self._buckets(list(tensors), lambda t: t.numel()):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            self.all_reduce(flat, "replica")
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()

    def gather(self, items: Sequence[Tuple[torch.Tensor, int, torch.Tensor]]) -> None:
        """For each (chunk, dim, full): write the ZeRO group's chunks into
        ``full`` (in ``full``'s dtype), in flat buckets."""
        W = self.plan.size
        for bucket in self._buckets(list(items), lambda it: it[2].numel()):
            full0 = bucket[0][2]
            send = torch.cat([c.reshape(-1).to(full0.dtype) for c, _, _ in bucket])
            recv = torch.empty((W, send.numel()), dtype=full0.dtype, device=full0.device)
            self._count("all_gather", recv)
            dist.all_gather_into_tensor(recv.view(-1), send, group=self.zero_group)
            off = 0
            for c, d, full in bucket:
                view = self._chunks_view(full, d)
                view.copy_(recv[:, off:off + c.numel()].view(view.shape))
                off += c.numel()


class _Saved:
    """A tensor autograd saved from a released block: where it sat in the block's buffer."""
    __slots__ = ("key", "size", "stride", "offset")

    def __init__(self, key, size, stride, offset):
        self.key, self.size, self.stride, self.offset = key, size, stride, offset


class _GatherGroup(torch.autograd.Function):
    """Forward: a group's leaves gathered whole in the compute dtype. Backward:
    their gradients reduced into the engine's shard buffers (nothing flows to
    the masters through autograd; ``anchor`` only makes the outputs need
    gradients). A recompute's gather (``recompute``) reduces nothing."""

    @staticmethod
    def forward(ctx, params, key, recompute, anchor):
        ctx.params, ctx.key, ctx.recompute = params, key, recompute
        return tuple(params.gather(key, recompute))

    @staticmethod
    def backward(ctx, *grads):
        if not ctx.recompute:
            ctx.params.reduce_grads(ctx.key, grads)
        return None, None, None, None


class Stage3Params:
    """The parameter tree stage 3 hands the model (see the module note).

    ``masters`` are the engine's fp32 masters (chunks where the plan shards
    them); ``on_grads(indices, reduced)`` takes each gathered group's reduced
    gradients (the engine adds them into its accumulation buffers)."""

    def __init__(self, plan: ZeroPlan, masters: List[torch.Tensor], coll: Collectives, dtype: torch.dtype,
                 acc_dtype: torch.dtype, on_grads, device: torch.device, stream: Optional[ParamStream] = None):
        self.plan, self.masters, self.coll, self.dtype, self.acc_dtype = plan, masters, coll, dtype, acc_dtype
        self.on_grads = on_grads
        self.device = device
        self.stream = stream  # host masters' copies to the device (ZeRO-3 parameter offload), or None
        self._anchor = torch.zeros((), device=device, requires_grad=True)
        self.in_backward = False  # set by the engine around loss.backward(): a read is a checkpoint's recompute
        self.itemsize = torch.empty((), dtype=dtype).element_size()
        self.groups: Dict[str, List[int]] = {}
        for i, leaf in enumerate(plan.leaves):
            self.groups.setdefault(leaf.group, []).append(i)
        self.gathered_bytes = 0
        self.peak_gathered_bytes = 0
        self._live: Optional[Tuple[str, torch.Tensor, Dict]] = None  # (block key, its buffer, its tree)
        self._held: Dict[str, Dict] = {}  # the other keys, gathered once per forward
        self._bwd: Dict[str, torch.Tensor] = {}  # blocks gathered again for the backward
        self._bwd_trees: Dict[str, Dict] = {}  # the trees of blocks a recompute gathered

    # ---------------------------------------------------------------- gather and release
    def group_bytes(self, key: str) -> int:
        return sum(self.plan.leaves[i].numel for i in self.groups[key]) * self.itemsize

    def _note(self, nbytes: int) -> None:
        self.gathered_bytes += nbytes
        self.peak_gathered_bytes = max(self.peak_gathered_bytes, self.gathered_bytes)

    def _buffer(self, key: str) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Gather a group into one flat buffer: its leaves as views, in plan order."""
        idx = self.groups[key]
        leaves = [self.plan.leaves[i] for i in idx]
        buf = torch.empty(sum(lf.numel for lf in leaves), dtype=self.dtype, device=self.device)
        views, off, items = [], 0, []
        for i, lf in zip(idx, leaves):
            v = buf[off:off + lf.numel].view(lf.shape)
            off += lf.numel
            views.append(v)
            src = self.stream.take(i) if self.stream is not None and self.stream.offloaded[i] else self.masters[i]
            if lf.param_dim is None:
                v.copy_(src)
            else:
                items.append((src, lf.param_dim, v))
        if items:
            self.coll.gather(items)
        self._note(self.group_bytes(key))
        return buf, views

    def _free(self, key: str, buf: torch.Tensor) -> None:
        buf.untyped_storage().resize_(0)
        self.gathered_bytes -= self.group_bytes(key)

    def _prefetch(self, key: str, step: int) -> None:
        """Issue the host copies of the block ``step`` after ``key`` (offload only)."""
        if self.stream is None or not BLOCK_KEY.match(key):
            return
        nxt = f"layer_{int(key.rsplit('_', 1)[1]) + step}"
        if nxt in self.groups:
            self.stream.prefetch(self.groups[nxt])

    def gather(self, key: str, recompute: bool = False) -> List[torch.Tensor]:
        buf, views = self._buffer(key)
        if recompute:
            self._bwd[key] = buf
            self._prefetch(key, -1)
        elif BLOCK_KEY.match(key):
            self._live = (key, buf, None)
            self._prefetch(key, +1)
        return views

    def release_block(self) -> None:
        if self._live is not None:
            key, buf, _ = self._live
            self._live = None
            self._free(key, buf)

    def __getitem__(self, key: str):
        if self._live is not None and self._live[0] == key:
            return self._live[2]
        if key in self._held:
            return self._held[key]
        if key not in self.groups:
            raise KeyError(key)
        if self.in_backward:
            return self._recompute_read(key)
        self.release_block()
        idx = self.groups[key]
        if torch.is_grad_enabled():
            views = _GatherGroup.apply(self, key, False, self._anchor)
        else:
            views = self.gather(key)
        tree = self._tree(key, views)
        if BLOCK_KEY.match(key):
            k, buf, _ = self._live
            self._live = (k, buf, tree)
        else:
            self._held[key] = tree
        return tree

    def _tree(self, key: str, views) -> Dict:
        idx = self.groups[key]
        rel = [(self.plan.leaves[i].path.split("/", 1)[1] if "/" in self.plan.leaves[i].path else "", v)
               for i, v in zip(idx, views)]
        return rel[0][1] if rel[0][0] == "" else unflatten_tree(rel)

    def _recompute_read(self, key: str):
        """A checkpointed block read again by its recompute in the backward:
        gathered once more and held until the original gather node reduces
        its gradient."""
        if key not in self._bwd_trees:
            views = _GatherGroup.apply(self, key, True, self._anchor)
            self._bwd_trees[key] = self._tree(key, views)
        return self._bwd_trees[key]

    def __contains__(self, key) -> bool:
        return key in self.groups

    def end_forward(self, training: bool) -> None:
        """After the loss: release the last block; the held keys stay gathered
        until their gradients are reduced (or now, without a backward)."""
        self.release_block()
        if not training:
            for key in self._held:
                self.gathered_bytes -= self.group_bytes(key)
        self._held = {}

    # ---------------------------------------------------------------- saved tensors
    def pack(self, t: torch.Tensor):
        live = self._live
        if live is None or t.dtype != self.dtype or t.device != live[1].device:
            return t
        if t.untyped_storage().data_ptr() != live[1].untyped_storage().data_ptr():
            return t
        return _Saved(live[0], t.size(), t.stride(), t.storage_offset())

    def unpack(self, s):
        if not isinstance(s, _Saved):
            return s
        buf = self._bwd.get(s.key)
        if buf is None:
            with torch.no_grad():
                buf, _ = self._buffer(s.key)
            self._bwd[s.key] = buf
            self._prefetch(s.key, -1)
        return torch.as_strided(buf, s.size, s.stride, s.offset)

    def saved_tensors_hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)

    # ---------------------------------------------------------------- backward
    def reduce_grads(self, key: str, grads: Sequence[Optional[torch.Tensor]]) -> None:
        idx = self.groups[key]
        items = []
        for i, g in zip(idx, grads):
            lf = self.plan.leaves[i]
            g = torch.zeros(lf.shape, dtype=self.acc_dtype, device=self.masters[i].device) if g is None \
                else g.to(self.acc_dtype)
            items.append((g, lf.grad_dim))
        self.on_grads(idx, self.coll.reduce(items))
        buf = self._bwd.pop(key, None)
        self._bwd_trees.pop(key, None)
        if buf is not None:
            self._free(key, buf)
        elif not BLOCK_KEY.match(key):
            self.gathered_bytes -= self.group_bytes(key)
