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

ZeRO++ (``zeropp.py``) changes the wire formats of these collectives, not
their place: ``gather(..., qwz=True)`` all-gathers int8 codes and scales
(qwZ), ``reduce_quantized`` reduces stage 3's gradients over fsdp and then
``data`` through the int8 all-to-all (qgZ), and with hpZ ``Stage3Params``
keeps a block's secondary slices after its forward and regathers the block
for the backward from them over the hpZ group (``gather(..., group="hpz")``).

Under expert parallelism every shape here is the rank's local one
(``LeafPlan.local_shape``: E / ep experts of an expert leaf): the ZeRO and
replica groups lie at this rank's expert coordinate.

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
from ..comm.compressed import all_to_all_quant_reduce_coalesced
from .zeropp import dequant_int8, quant_int8


class Collectives:
    """The engine's collectives, counted: ``stats[op] = [calls, bytes]``
    (bytes of the larger side: a reduce-scatter's input, an all-gather's
    output; an all-to-all's input). Groups by name: ``zero``, ``replica``
    (the ``data`` ranks holding the same fsdp chunk), ``dp`` (every rank of
    the batch at this expert coordinate), ``expert``, ``hpz`` (ZeRO++'s
    secondary group) and ``None``, the world."""

    def __init__(self, plan: ZeroPlan, zero_group, replica_group, replica_size: int, bucket: int, dp_group=None,
                 expert_group=None, hpz_group=None, hpz_size: int = 1):
        self.plan = plan
        self.zero_group = zero_group
        self.replica_group = replica_group
        self.replica_size = replica_size
        self.bucket = int(bucket)
        self.groups = {"zero": zero_group, "replica": replica_group, "dp": dp_group, "expert": expert_group,
                       "hpz": hpz_group}
        self.sizes = {"zero": plan.size, "replica": replica_size, "hpz": hpz_size}
        self.stats: Dict[str, List[int]] = {}

    def _count(self, op: str, *ts: torch.Tensor) -> None:
        s = self.stats.setdefault(op, [0, 0])
        s[0] += 1
        s[1] += sum(t.numel() * t.element_size() for t in ts)

    def all_reduce(self, t: torch.Tensor, group="zero") -> torch.Tensor:
        """Sum ``t`` in place over a named group or the world (``None``)."""
        self._count("all_reduce", t)
        dist.all_reduce(t, group=self.groups.get(group) if group is not None else None)
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

    def _chunks_view(self, full: torch.Tensor, dim: int, W: Optional[int] = None) -> torch.Tensor:
        """A full leaf seen as (W, *chunk shape): chunk r along ``dim`` at index r."""
        W = self.plan.size if W is None else W
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
        if self.replica_size > 1:
            self.sum_in_place(tensors, "replica")

    def sum_in_place(self, tensors: Sequence[torch.Tensor], group: str) -> None:
        """Sum each tensor in place over a named group, in flat buckets."""
        for bucket in self._buckets(list(tensors), lambda t: t.numel()):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            self.all_reduce(flat, group)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()

    def gather(self, items: Sequence[Tuple[torch.Tensor, int, torch.Tensor]], qwz: bool = False,
               group: str = "zero") -> None:
        """For each (chunk, dim, full): write the group's chunks into ``full``
        (in ``full``'s dtype), in flat buckets; with ``qwz`` as int8 codes
        and scales, each chunk dequantised in ``full``'s dtype (ZeRO++ qwZ).
        ``group``: ``zero``, or ``hpz`` for hpZ's regather of secondary
        slices (counted as ``hpz_all_gather``)."""
        W = self.sizes[group]
        op = "hpz_all_gather" if group == "hpz" else "all_gather"
        for bucket in self._buckets(list(items), lambda it: it[2].numel()):
            full0 = bucket[0][2]
            if qwz:
                self._gather_int8(bucket, W, op, self.groups[group])
                continue
            send = torch.cat([c.reshape(-1).to(full0.dtype) for c, _, _ in bucket])
            recv = torch.empty((W, send.numel()), dtype=full0.dtype, device=full0.device)
            self._count(op, recv)
            dist.all_gather_into_tensor(recv.view(-1), send, group=self.groups[group])
            off = 0
            for c, d, full in bucket:
                view = self._chunks_view(full, d, W)
                view.copy_(recv[:, off:off + c.numel()].view(view.shape))
                off += c.numel()

    def _gather_int8(self, bucket, W: int, op: str, group) -> None:
        codes, scales = zip(*(quant_int8(c) for c, _, _ in bucket))
        send_q = torch.cat([q.reshape(-1) for q in codes])
        send_s = torch.cat([sc.reshape(-1) for sc in scales])
        recv_q = torch.empty((W, send_q.numel()), dtype=torch.int8, device=send_q.device)
        recv_s = torch.empty((W, send_s.numel()), dtype=torch.float32, device=send_s.device)
        self._count(op, recv_q, recv_s)
        dist.all_gather_into_tensor(recv_q.view(-1), send_q, group=group)
        dist.all_gather_into_tensor(recv_s.view(-1), send_s, group=group)
        off = soff = 0
        for (c, d, full), q in zip(bucket, codes):
            rows, g = q.shape
            view = self._chunks_view(full, d, W)
            for r in range(W):  # each rank's chunk dequantised on its own, as the JAX gather
                view[r].copy_(dequant_int8(recv_q[r, off:off + rows * g].view(rows, g),
                                           recv_s[r, soff:soff + rows].view(rows, 1), c.shape, full.dtype))
            off += rows * g
            soff += rows

    def _quant_sum(self, flats: List[torch.Tensor], group: str) -> List[torch.Tensor]:
        """qgZ: each flat tensor's sum over ``group`` (its length a multiple of
        the group size): the JAX ``all_to_all_quant_reduce``'s mean times the
        group size, the tensors of a bucket sharing its collectives."""
        W, pg = self.sizes[group], self.groups[group]
        out: List[torch.Tensor] = []
        for bucket in self._buckets(flats, lambda t: t.numel()):
            n = sum(t.numel() for t in bucket)
            s = self.stats.setdefault("quant_all_to_all", [0, 0])  # int8 codes and a scale a chunk, each way
            s[0], s[1] = s[0] + 1, s[1] + n + 4 * W * len(bucket)
            s = self.stats.setdefault("quant_all_gather", [0, 0])
            s[0], s[1] = s[0] + 1, s[1] + n + 4 * W * len(bucket)
            out += [t * W for t in all_to_all_quant_reduce_coalesced(bucket, pg)]
        return out

    def reduce_quantized(self, items: Sequence[Tuple[torch.Tensor, int]]) -> List[torch.Tensor]:
        """ZeRO++ qgZ for stage 3's sharded leaves: each full gradient's sum
        over the fsdp group, then over the replica (``data``) group, this
        rank's chunk along the given dimension (JAX ``_gather_leaf``'s
        backward and ``reduce_grads``)."""
        W = self.plan.size
        flats = []
        for g, _ in items:
            n = g.numel()
            flat = g.reshape(-1).to(torch.float32)
            flats.append(torch.cat([flat, flat.new_zeros((-n) % W)]) if n % W else flat)
        sums = self._quant_sum(flats, "zero")
        out = []
        for (g, d), full in zip(items, sums):
            full = full[:g.numel()].view(g.shape)
            n = g.shape[d] // W
            out.append(full.narrow(d, self.plan.rank * n, n).clone(memory_format=torch.contiguous_format))
        if self.replica_size > 1:
            R = self.replica_size
            flats = [torch.cat([t.reshape(-1), t.new_zeros((-t.numel()) % R)]) for t in out]
            out = [s[:t.numel()].view(t.shape) for t, s in zip(out, self._quant_sum(flats, "replica"))]
        return [t.to(g.dtype) for t, (g, _) in zip(out, items)]


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
        return tuple(params.gather(key, recompute, backward=True))

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
                 acc_dtype: torch.dtype, on_grads, device: torch.device, stream: Optional[ParamStream] = None,
                 qwz: bool = False, qgz: bool = False, hpz: int = 1):
        self.plan, self.masters, self.coll, self.dtype, self.acc_dtype = plan, masters, coll, dtype, acc_dtype
        self.on_grads = on_grads
        self.device = device
        self.stream = stream  # host masters' copies to the device (ZeRO-3 parameter offload), or None
        # ZeRO++: int8 weight gathers, int8 gradient reduction, hpZ's k (its slice: fsdp rank mod k)
        self.qwz, self.qgz, self.hpz = qwz, qgz, hpz
        self._secondary: Dict[str, List[Tuple[int, torch.Tensor]]] = {}  # a block's hpZ slices, until its backward
        self.secondary_bytes = 0
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
        return sum(self.plan.leaves[i].local_numel for i in self.groups[key]) * self.itemsize

    def _note(self, nbytes: int) -> None:
        self.gathered_bytes += nbytes
        self.peak_gathered_bytes = max(self.peak_gathered_bytes, self.gathered_bytes)

    def _buffer(self, key: str, regather: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Gather a group into one flat buffer: its leaves as views, in plan
        order (``regather``, for the backward, from its hpZ slices where it
        kept them)."""
        idx = self.groups[key]
        leaves = [self.plan.leaves[i] for i in idx]
        buf = torch.empty(sum(lf.local_numel for lf in leaves), dtype=self.dtype, device=self.device)
        secondary = dict(self._secondary.get(key, ())) if regather else {}
        views, off, items = [], 0, []
        for i, lf in zip(idx, leaves):
            v = buf[off:off + lf.local_numel].view(lf.local_shape)
            off += lf.local_numel
            views.append(v)
            if lf.param_dim is not None and i in secondary:
                items.append((secondary[i], lf.param_dim, v))
                continue
            src = self.stream.take(i) if self.stream is not None and self.stream.offloaded[i] else self.masters[i]
            if lf.param_dim is None:
                v.copy_(src)
            else:
                items.append((src, lf.param_dim, v))
        if items and secondary:
            self.coll.gather(items, group="hpz")
        elif items:
            self.coll.gather(items, qwz=self.qwz)
        self._note(self.group_bytes(key))
        return buf, views

    def _keep_secondary(self, key: str, views: List[torch.Tensor]) -> None:
        """hpZ: this rank's 1/k slice of each sharded leaf of a gathered block, along its ZeRO dimension."""
        k, r = self.hpz, self.plan.rank % self.hpz
        kept = []
        for i, v in zip(self.groups[key], views):
            d = self.plan.leaves[i].param_dim
            if d is not None:
                kept.append((i, self.coll._chunks_view(v, d, k)[r].clone(memory_format=torch.contiguous_format)))
        stale = self._secondary.pop(key, ())  # a forward whose backward never ran
        self.secondary_bytes -= sum(t.numel() * t.element_size() for _, t in stale)
        self._secondary[key] = kept
        self.secondary_bytes += sum(t.numel() * t.element_size() for _, t in kept)

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

    def gather(self, key: str, recompute: bool = False, backward: bool = False) -> List[torch.Tensor]:
        """Gather a group; ``backward``: a backward will regather it (hpZ keeps its slices now)."""
        buf, views = self._buffer(key, regather=recompute)
        if recompute:
            self._bwd[key] = buf
            self._prefetch(key, -1)
        elif BLOCK_KEY.match(key):
            self._live = (key, buf, None)
            self._prefetch(key, +1)
            if self.hpz > 1 and backward:
                self._keep_secondary(key, views)
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
                buf, _ = self._buffer(s.key, regather=True)
            self._bwd[s.key] = buf
            self._prefetch(s.key, -1)
        return torch.as_strided(buf, s.size, s.stride, s.offset)

    def saved_tensors_hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)

    # ---------------------------------------------------------------- backward
    def _hpz_transpose(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """The backward of hpZ's regather (an all-gather of the k slices over
        the hpZ group) taken as a reduce-scatter: this rank's slice of the
        group's summed gradient, in place in an otherwise zero leaf. The sum
        is exact, so only qgZ, which quantises the result (JAX
        ``hpz_resplit``'s transpose under ``_gather_leaf``'s backward), sees
        a difference."""
        k, coll = self.hpz, self.coll
        send = coll._chunks_view(g, dim, k).contiguous()
        mine = torch.empty_like(send[0])
        coll._count("hpz_reduce_scatter", send)
        dist.reduce_scatter_tensor(mine.view(-1), send.view(-1), group=coll.groups["hpz"])
        out = torch.zeros_like(g)
        coll._chunks_view(out, dim, k)[self.plan.rank % k].copy_(mine)
        return out

    def reduce_grads(self, key: str, grads: Sequence[Optional[torch.Tensor]]) -> None:
        idx = self.groups[key]
        items = []
        for i, g in zip(idx, grads):
            lf = self.plan.leaves[i]
            g = torch.zeros(lf.local_shape, dtype=self.acc_dtype, device=self.device) if g is None \
                else g.to(self.acc_dtype)
            items.append((g, lf.grad_dim))
        if self.qgz:  # ZeRO++: the sharded leaves through the int8 all-to-all, the whole ones in full precision
            quant = [j for j, i in enumerate(idx) if self.plan.leaves[i].param_dim is not None]
            if self.hpz > 1:
                for j in quant:
                    items[j] = (self._hpz_transpose(*items[j]), items[j][1])
            rest = [j for j in range(len(idx)) if j not in set(quant)]
            reduced = [None] * len(idx)
            for j, t in zip(quant, self.coll.reduce_quantized([items[j] for j in quant])):
                reduced[j] = t
            for j, t in zip(rest, self.coll.reduce([items[j] for j in rest])):
                reduced[j] = t
            self.on_grads(idx, reduced)
        else:
            self.on_grads(idx, self.coll.reduce(items))
        kept = self._secondary.pop(key, ())
        self.secondary_bytes -= sum(t.numel() * t.element_size() for _, t in kept)
        buf = self._bwd.pop(key, None)
        self._bwd_trees.pop(key, None)
        if buf is not None:
            self._free(key, buf)
        elif not BLOCK_KEY.match(key):
            self.gathered_bytes -= self.group_bytes(key)
