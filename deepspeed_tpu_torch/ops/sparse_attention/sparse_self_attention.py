"""Block-sparse attention: hand-written CUDA kernels and their plain versions.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``
(after DeepSpeed's ``deepspeed/ops/sparse_attention/``, whose Triton
block-sparse ``MatMul``/``Softmax`` ``SparseSelfAttention`` composes). The
static block layout of a ``SparsityConfig`` becomes per-(head, query-block)
lists of active key blocks (``kidx``) and their transpose (``qidx``: the
query blocks that attend each key block); the kernels
(``csrc/sparse_fwd.cu``, ``sparse_dq.cu`` and ``sparse_dkv.cu`` in bf16,
``csrc/sparse_attention.cu`` in fp32) run the flash online softmax over only
those blocks, so work and traffic scale with the layout's density, not S^2. They
replace the Pallas ``_sp_fwd_kernel``, ``_sp_dq_kernel`` and
``_sp_dkv_kernel``; see the source note for the design.

Layout: q, k, v, o and the gradients are (B, S, H, D), read with strides
(the reference transposes to (B*H, S, D) first); lse and delta are
(B, H, S) fp32 without the TPU's 128-lane padding; ``kidx`` (H, S/blk, A)
and ``qidx`` (H, S/blk, Aq) int32, sorted, -1 padded.

Each wrapper (``sparse_fwd``, ``sparse_bwd_dq``, ``sparse_bwd_dkv``) takes
its plain version for CPU tensors, launches its kernel (or raises) for any
other device, and counts its launches. The bf16 kernels walk a plan
(``WalkPlan``, numpy on the host, built once per configuration beside the
lists): blocks of one side grouped into one CUDA block, which walks the
union of their lists. The forward and dq group neighbouring query blocks
(``query_plan``); dk/dv groups key blocks with alike lists and splits long
walks across blocks whose fp32 partials are summed in a fixed order
(``dkv_plan``). ``_SparseAttention`` is the reference's ``custom_vjp``: the
forward saves q, k, v, o and lse; the backward computes delta =
rowsum(o * do) in fp32 and launches dq and dk/dv.
There is no ``interpret`` argument: the tensors' device picks the route.
"""

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..flash_attention import _stream, flash_delta
from .sparsity_config import SparsityConfig

NEG_INF = -1e30  # the reference kernels' mask value
KERNEL_BLOCKS = (16, 32, 64, 128)  # layout blocks the CUDA kernels take (the upstream Triton kernels' set)
KERNEL_HEAD_DIMS = (32, 64, 128)
PLAIN_CHUNK_ELEMS = 1 << 27  # the plain versions gather at most this many K (or Q) elements at a time
# the bf16 dk/dv kernel (csrc/sparse_dkv.cu): the key rows a CUDA block owns (4 warps of 16), the query rows a
# step of its walk stages, and the most steps one block walks (a longer walk is split across blocks)
DKV_ROWS = 64
DKV_TILE = 64
DKV_SPLIT_TILES = 64
# the bf16 forward and dq kernels (csrc/sparse_fwd.cu, csrc/sparse_dq.cu): the query rows a CUDA block owns
# (4 warps of 16) and the keys a step of its walk stages; their walks are not split
QUERY_ROWS = 64
QUERY_TILE = 64

# ----------------------------------------------------------------------
# static layout -> active block lists
# ----------------------------------------------------------------------
def _sorted_active(lay: np.ndarray):
    """For each row of a (H, n, m) bool array: its True columns in ascending
    order, -1 padded to the longest row (at least 1)."""
    counts = lay.sum(axis=2)
    width = max(1, int(counts.max()))
    # a stable sort of ~lay puts the True columns first, in ascending order
    order = np.argsort(~lay, axis=2, kind="stable")[:, :, :width].astype(np.int32)
    return np.where(np.arange(width)[None, None, :] < counts[:, :, None], order, np.int32(-1)).astype(np.int32)


def _active_lists(layout: np.ndarray, causal: bool):
    """(kidx, qidx) padded active-block index arrays, -1 padded.

    kidx[h, i]: key blocks query block i attends; qidx[h, j]: query
    blocks that attend key block j (for the dkv pass). Equal to the
    reference's loop over ``np.nonzero``, vectorised."""
    H, nq, nk = layout.shape
    lay = layout.copy()
    if causal:
        tri = np.tril(np.ones((nq, nk), dtype=bool))
        lay &= tri[None]
    return _sorted_active(lay), _sorted_active(np.ascontiguousarray(lay.transpose(0, 2, 1)))


@dataclasses.dataclass
class WalkPlan:
    """A bf16 kernel's work over one side's block lists, from the lists alone
    (numpy): ``lists`` says which, "kidx" (the forward and dq, over query
    blocks) or "qidx" (dk/dv, over key blocks).

    A *member* is ``R = min(block, rows)`` rows of one block of the walking
    side, with that block's list; a *group* is up to ``rows // R`` members of
    one head, owned by one CUDA block: its warps share each staged tile of the
    union of their lists (``walk``: ascending blocks of the other side, each
    with a bit per member that attends it). ``query_plan`` groups neighbouring
    query blocks; ``dkv_plan`` groups key blocks with alike lists and splits a
    walk of more than ``DKV_SPLIT_TILES`` steps into pieces, each a CUDA block
    writing fp32 partials of the group's dk and dv into its slot of a
    workspace; the ``reduce`` rows sum a group's pieces in order.

    ``items`` (n_items, 4 + rows // 16) int32, one CUDA block per batch row,
    longest walk first: [head, first entry, entries, slot (-1: write the
    outputs directly), first row of each member (-1: none)]; ``reduce``
    (n_reduce, same width): [head, first slot, pieces, 0, members];
    ``entries`` int32: the groups' walks one after another, block | owner
    bits << 24."""
    items: np.ndarray
    reduce: np.ndarray
    entries: np.ndarray
    n_slots: int
    max_entries: int
    lists: str  # what the plan is for: the lists it walks, the layout block, rows, and the lists' heads and blocks
    block: int
    rows: int
    heads: int
    n_blocks: int

    @property
    def table(self) -> np.ndarray:
        """items, reduce and entries in one int32 array, as the kernel reads them."""
        return np.concatenate([self.items.ravel(), self.reduce.ravel(), self.entries])


def _walk_steps(n, block: int, tile: int):
    """Steps (staged tiles of ``tile`` rows) of a walk over n list entries."""
    per = max(1, tile // block)
    return -(-np.asarray(n) // per) * max(1, block // tile)


def _owner_walk(owns: List[np.ndarray]) -> np.ndarray:
    """The walk of a group whose member i attends the blocks owns[i] (ascending): their union, ascending,
    each entry block | owner bits << 24, as int32."""
    union = np.unique(np.concatenate(owns)).astype(np.int64)
    bits = np.zeros(len(union), np.int64)
    for i, own in enumerate(owns):
        bits[np.searchsorted(union, own)] |= 1 << i
    return (union | bits << 24).astype(np.uint32).view(np.int32)


def _dkv_groups(lists: np.ndarray, block: int) -> List[Tuple[List[int], np.ndarray]]:
    """One head's groups: [(first key row of each member, walk)] for its
    (n_blocks, Aq) qidx lists. Members in order of (length class, key block);
    a member joins the open group when the group has room, the class is the
    same and the union's steps stay within the longest member's."""
    nb, rows, tile = lists.shape[0], DKV_ROWS, DKV_TILE
    R = min(block, rows)
    subs = block // R
    lens = (lists >= 0).sum(1)
    mem_block = np.repeat(np.arange(nb), subs)
    mem_row = mem_block * block + np.tile(np.arange(subs) * R, nb)
    steps = _walk_steps(lens[mem_block], block, tile)
    cls = np.where(steps > 0, np.floor(np.log2(np.maximum(steps, 1))).astype(np.int64) + 1, 0)
    own = lambda m: lists[mem_block[m], :lens[mem_block[m]]]
    out = []
    cur, union, most = [], None, 0
    for m in np.argsort(cls, kind="stable"):
        n_steps = int(steps[m])
        if cur and len(cur) < rows // R and cls[m] == cls[cur[0]]:
            joined = np.union1d(union, own(m))
            if _walk_steps(len(joined), block, tile) <= max(most, n_steps):
                cur.append(m)
                union, most = joined, max(most, n_steps)
                continue
        if cur:
            out.append(([int(mem_row[i]) for i in cur], _owner_walk([own(i) for i in cur])))
        cur, union, most = [m], own(m), n_steps
    if cur:
        out.append(([int(mem_row[i]) for i in cur], _owner_walk([own(i) for i in cur])))
    return out


def _query_groups(lists: np.ndarray, block: int) -> List[Tuple[List[int], np.ndarray]]:
    """One head's groups: [(first query row of each member, walk)] for its
    (n_blocks, A) kidx lists: QUERY_ROWS // R neighbouring members a group.
    Neighbouring query blocks of the layouts users run attend nearly the same
    key blocks (one local window, the same global columns), so the union is
    about as long as one list."""
    nb = lists.shape[0]
    R = min(block, QUERY_ROWS)
    subs, per = block // R, QUERY_ROWS // R
    lens = (lists >= 0).sum(1)
    out = []
    for m0 in range(0, nb * subs, per):
        members = range(m0, min(m0 + per, nb * subs))
        walk = _owner_walk([lists[m // subs, :lens[m // subs]] for m in members])
        out.append(([(m // subs) * block + (m % subs) * R for m in members], walk))
    return out


def _walk_plan(idx: np.ndarray, block: int, lists: str, rows: int, tile: int, groups,
               split_tiles: Optional[int]) -> WalkPlan:
    """The plan of ``groups`` over idx (H, S/block, A) int32 lists; heads with equal lists share one grouping.
    A walk of more than ``split_tiles`` steps (None: never) is split into pieces of whole steps."""
    if block % 16 or rows % min(block, rows):
        raise NotImplementedError(f"the bf16 kernels' plans take layout blocks of 16 rows or a multiple, not {block}")
    width = 4 + rows // 16
    per_piece = None
    if split_tiles is not None:
        per_piece = max(1, split_tiles // max(1, block // tile)) * max(1, tile // block)  # entries, in whole steps
    items, reduce, walks = [], [], []
    seen, slot, off = {}, 0, 0
    for h in range(idx.shape[0]):
        key = idx[h].tobytes()
        if key not in seen:
            seen[key] = groups(idx[h], block)
        for members, walk in seen[key]:
            n = len(walk)
            mem = members + [-1] * (width - 4 - len(members))
            if per_piece is None or n <= per_piece:
                items.append([h, off, n, -1] + mem)
            else:
                pieces = -(-n // per_piece)
                items += [[h, off + p * per_piece, min(per_piece, n - p * per_piece), slot + p] + mem
                          for p in range(pieces)]
                reduce.append([h, slot, pieces, 0] + mem)
                slot += pieces
            walks.append(walk)
            off += n
    items = np.asarray(items, np.int32).reshape(-1, width)
    items = items[np.argsort(-_walk_steps(items[:, 2], block, tile), kind="stable")]  # longest walk first
    entries = np.concatenate(walks).astype(np.int32) if walks else np.zeros(0, np.int32)
    return WalkPlan(items, np.asarray(reduce, np.int32).reshape(-1, width), entries, slot,
                    int(items[:, 2].max(initial=0)), lists, block, rows, idx.shape[0], idx.shape[1])


def dkv_plan(qidx: np.ndarray, block: int) -> WalkPlan:
    """The bf16 dk/dv kernel's plan for qidx (H, S/block, Aq) int32 (see ``WalkPlan``): alike key blocks
    grouped, walks split every DKV_SPLIT_TILES steps."""
    return _walk_plan(qidx, block, "qidx", DKV_ROWS, DKV_TILE, _dkv_groups, DKV_SPLIT_TILES)


def query_plan(kidx: np.ndarray, block: int) -> WalkPlan:
    """The bf16 forward and dq kernels' plan for kidx (H, S/block, A) int32 (see ``WalkPlan``): neighbouring
    query blocks grouped, no walk split (no slots, no reduce rows)."""
    return _walk_plan(kidx, block, "kidx", QUERY_ROWS, QUERY_TILE, _query_groups, None)


@dataclasses.dataclass
class DevicePlan:
    """A ``WalkPlan``'s table on the device, with the counts the launch needs
    and what the plan is for (checked against the call's lists)."""
    table: torch.Tensor
    n_items: int
    n_reduce: int
    n_slots: int
    max_entries: int
    lists: str
    block: int
    rows: int
    heads: int
    n_blocks: int

    @classmethod
    def of(cls, plan: WalkPlan, device) -> "DevicePlan":
        return cls(torch.from_numpy(plan.table).to(device), len(plan.items), len(plan.reduce), plan.n_slots,
                   plan.max_entries, plan.lists, plan.block, plan.rows, plan.heads, plan.n_blocks)

    def check(self, fn: str, lists: str, idx: torch.Tensor, block: int) -> None:
        """Raise unless the plan walks ``lists`` and was made for idx's heads and blocks at this layout block,
        on its device."""
        got, want = (self.lists, self.block, self.heads, self.n_blocks), (lists, block, idx.shape[0], idx.shape[1])
        if got != want:
            raise ValueError(f"{fn}: the plan is for (lists, block, heads, blocks) {got}, the call's {want}")
        if self.table.device != idx.device:
            raise ValueError(f"{fn}: the plan must be on {idx.device}, not {self.table.device}")


# the plan builder of each side's lists
_PLANS = {"kidx": query_plan, "qidx": dkv_plan}


class _Lists:
    """kidx and qidx of one configuration on a device, and the plan of each,
    built on first use."""

    def __init__(self, kidx: np.ndarray, qidx: np.ndarray, block: int, device):
        self.kidx, self.qidx = torch.from_numpy(kidx).to(device), torch.from_numpy(qidx).to(device)
        self._host, self._block, self._plans = {"kidx": kidx, "qidx": qidx}, block, {}

    def plan(self, lists: str) -> DevicePlan:
        if lists not in self._plans:
            built = _PLANS[lists](self._host[lists], self._block)
            self._plans[lists] = DevicePlan.of(built, self.kidx.device)
        return self._plans[lists]


_LISTS_CACHE: dict = {}
_LISTS_CACHE_SIZE = 16


def _cached_lists(config: SparsityConfig, S: int, H: int, causal: bool, device) -> _Lists:
    key = (type(config), repr(config), S, H, causal, str(device))
    hit = _LISTS_CACHE.get(key)
    if hit is not None:
        return hit
    layout = config.make_layout(S)
    if layout.shape[0] == 1 and H > 1:
        layout = np.broadcast_to(layout, (H,) + layout.shape[1:])
    hit = _Lists(*_active_lists(layout, causal), config.block, device)
    if len(_LISTS_CACHE) >= _LISTS_CACHE_SIZE:
        _LISTS_CACHE.pop(next(iter(_LISTS_CACHE)))
    _LISTS_CACHE[key] = hit
    return hit


def _device_lists(config: SparsityConfig, S: int, H: int, causal: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """kidx and qidx of ``config``'s layout at length S over H heads, as int32
    tensors on ``device``. Built once per (config's type and fields, S, H,
    causal, device): eager PyTorch would otherwise rebuild the Python-loop
    layout on every call (what ``jit`` did once at trace time)."""
    hit = _cached_lists(config, S, H, causal, device)
    return hit.kidx, hit.qidx


def _device_query_plan(config: SparsityConfig, S: int, H: int, causal: bool, device) -> DevicePlan:
    """The forward's and dq's plan of ``_device_lists``' kidx, built once beside them."""
    return _cached_lists(config, S, H, causal, device).plan("kidx")


def _device_dkv_plan(config: SparsityConfig, S: int, H: int, causal: bool, device) -> DevicePlan:
    """The dk/dv plan of ``_device_lists``' qidx, built once beside them."""
    return _cached_lists(config, S, H, causal, device).plan("qidx")


# ----------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick on the card)
# ----------------------------------------------------------------------
def _blocks(x: torch.Tensor, blk: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, H, S/blk, blk, D) fp32."""
    B, S, H, D = x.shape
    return x.float().reshape(B, S // blk, blk, H, D).permute(0, 3, 1, 2, 4)


def _rows(x: torch.Tensor, blk: int) -> torch.Tensor:
    """(B, H, S) -> (B, H, S/blk, blk)."""
    B, H, S = x.shape
    return x.reshape(B, H, S // blk, blk)


def _gather(xb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """xb (B, H, n, blk, ...) and idx (H, c, A) -> (B, H, c, A, blk, ...): the
    blocks the lists name (padding reads block 0 and is masked by the caller)."""
    h = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return xb[:, h, idx.clamp_min(0).long()]


def _chunks(n_rows: int, per_row: int):
    """Slices of [0, n_rows) whose gathers hold at most PLAIN_CHUNK_ELEMS elements."""
    step = max(1, PLAIN_CHUNK_ELEMS // max(1, per_row))
    return [slice(a, min(n_rows, a + step)) for a in range(0, n_rows, step)]


def _masked_scores(a, b_g, idx_c, rows0: int, blk: int, scale: float, causal: bool, transposed: bool):
    """Scores of a chunk's blocks against their gathered blocks, fp32, with
    NEG_INF at padding and, on causal runs, where a key follows its query.

    a (B, H, c, blk, D) are the walking blocks (query blocks, or key blocks
    when ``transposed``) numbered from ``rows0``; b_g (B, H, c, A, blk, D)
    the gathered ones; idx_c (H, c, A). Returns (B, H, c, blk, A*blk)."""
    B, H, c, A = b_g.shape[:4]
    s = torch.einsum("bhcid,bhcajd->bhciaj", a, b_g) * scale
    valid = (idx_c >= 0)[None, :, :, None, :, None]
    if causal:
        own = (rows0 + torch.arange(c, device=a.device))[:, None] * blk + torch.arange(blk, device=a.device)
        other = idx_c.clamp_min(0)[..., None] * blk + torch.arange(blk, device=a.device)  # (H, c, A, blk)
        own = own[None, :, :, None, None]      # (1, c, blk, 1, 1)
        other = other[:, :, None, :, :]        # (H, c, 1, A, blk)
        keep = own >= other if not transposed else own <= other
        valid = valid & keep[None]
    s = torch.where(valid, s, torch.full((), NEG_INF, device=a.device))
    return s.reshape(B, H, c, blk, A * blk)


def sparse_fwd_ref(q, k, v, kidx, block: int, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o like q, lse (B, H, S) fp32).
    Each query block's active key blocks are gathered (padded to A), masked,
    and softmaxed; p is rounded to v's type before the PV product. A row with
    no active key gives o = 0 and lse = NEG_INF."""
    B, S, H, D = q.shape
    qb, kb, vb = _blocks(q, block), _blocks(k, block), _blocks(v, block)
    A = kidx.shape[2]
    o = torch.empty((B, H, S // block, block, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, S // block, block), dtype=torch.float32, device=q.device)
    for sl in _chunks(S // block, B * H * A * block * D):
        idx = kidx[:, sl]
        s = _masked_scores(qb[:, :, sl], _gather(kb, idx), idx, sl.start, block, scale, causal, False)
        m = s.amax(-1, keepdim=True)
        p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - m))
        l = p.sum(-1, keepdim=True)
        l_safe = torch.where(l == 0.0, 1.0, l)
        vg = _gather(vb, idx).flatten(3, 4)
        acc = torch.einsum("bhcij,bhcjd->bhcid", p.to(v.dtype).float(), vg)
        o[:, :, sl] = acc / l_safe
        lse[:, :, sl] = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return o.reshape(B, H, S, D).transpose(1, 2).to(q.dtype), lse.reshape(B, H, S)


def sparse_bwd_dq_ref(q, k, v, do, lse, delta, kidx, block: int, scale: float, causal: bool) -> torch.Tensor:
    """Plain version of the dq kernel: p = exp(s - lse), ds = p (dp - delta)
    scale rounded to k's type, dq = ds k over the active key blocks, like q."""
    B, S, H, D = q.shape
    qb, kb, vb, dob = _blocks(q, block), _blocks(k, block), _blocks(v, block), _blocks(do, block)
    lse_b, delta_b = _rows(lse, block), _rows(delta, block)
    A = kidx.shape[2]
    dq = torch.empty((B, H, S // block, block, D), dtype=torch.float32, device=q.device)
    for sl in _chunks(S // block, B * H * A * block * D):
        idx = kidx[:, sl]
        kg = _gather(kb, idx)
        s = _masked_scores(qb[:, :, sl], kg, idx, sl.start, block, scale, causal, False)
        p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - lse_b[:, :, sl, :, None]))
        dp = torch.einsum("bhcid,bhcjd->bhcij", dob[:, :, sl], _gather(vb, idx).flatten(3, 4))
        ds = (p * (dp - delta_b[:, :, sl, :, None]) * scale).to(k.dtype).float()
        dq[:, :, sl] = torch.einsum("bhcij,bhcjd->bhcid", ds, kg.flatten(3, 4))
    return dq.reshape(B, H, S, D).transpose(1, 2).to(q.dtype)


def sparse_bwd_dkv_ref(q, k, v, do, lse, delta, qidx, block: int, scale: float,
                       causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: each key block walks the query
    blocks of ``qidx``; dv = p^T do with p rounded to do's type, dk = ds^T q
    with ds = p (dp - delta) scale rounded to q's type."""
    B, S, H, D = q.shape
    qb, kb, vb, dob = _blocks(q, block), _blocks(k, block), _blocks(v, block), _blocks(do, block)
    lse_b, delta_b = _rows(lse, block), _rows(delta, block)
    Aq = qidx.shape[2]
    dk = torch.empty((B, H, S // block, block, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for sl in _chunks(S // block, B * H * Aq * block * D):
        idx = qidx[:, sl]
        qg, dog = _gather(qb, idx), _gather(dob, idx)
        s = _masked_scores(kb[:, :, sl], qg, idx, sl.start, block, scale, causal, True)  # (B, H, c, keys, Aq*blk)
        lse_g = _gather(lse_b, idx).flatten(3, 4)[:, :, :, None, :]
        delta_g = _gather(delta_b, idx).flatten(3, 4)[:, :, :, None, :]
        p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - lse_g))
        dog = dog.flatten(3, 4)
        dv[:, :, sl] = torch.einsum("bhcij,bhcjd->bhcid", p.to(do.dtype).float(), dog)
        dp = torch.einsum("bhcid,bhcjd->bhcij", vb[:, :, sl], dog)
        ds = (p * (dp - delta_g) * scale).to(q.dtype).float()
        dk[:, :, sl] = torch.einsum("bhcij,bhcjd->bhcid", ds, qg.flatten(3, 4))
    back = lambda x: x.reshape(B, H, S, D).transpose(1, 2).to(k.dtype)
    return back(dk), back(dv)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _check(what, q, k, v, idx, block, do=None, lse=None, delta=None):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} must all be "
                         "(B, S, H, D) (expand GQA's KV heads first)")
    B, S, H, D = q.shape
    if block not in KERNEL_BLOCKS:
        raise NotImplementedError(f"{what}: the CUDA kernels take layout blocks {KERNEL_BLOCKS}, not {block}")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"{what}: the CUDA kernels take head dims {KERNEL_HEAD_DIMS}, not {D}")
    _build.dtype_code(q.dtype)  # raises for any type but float32 and bfloat16
    if S % block:
        raise ValueError(f"{what}: sequence length {S} is not a multiple of the layout block {block}")
    given = [t for t in (q, k, v, do, lse, delta, idx) if t is not None]
    if any(not t.is_cuda or t.device != q.device or not t.is_contiguous() for t in given):
        raise ValueError(f"{what}: every tensor must be contiguous on one CUDA device (got q on {q.device})")
    if k.dtype != q.dtype or v.dtype != q.dtype or (do is not None and (do.dtype, do.shape) != (q.dtype, q.shape)):
        raise ValueError(f"{what}: k, v (and do) must have q's dtype {q.dtype} (and do q's shape)")
    for t in (lse, delta):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (B, H, S)):
            raise ValueError(f"{what}: lse and delta must be ({B}, {H}, {S}) float32")
    if idx.dtype != torch.int32 or idx.dim() != 3 or tuple(idx.shape[:2]) != (H, S // block):
        raise ValueError(f"{what}: the block lists must be ({H}, {S // block}, A) int32, not "
                         f"{tuple(idx.shape)} {idx.dtype}")


def _plan_args(fn: str, q, lists: str, plan: Optional[DevicePlan]) -> tuple:
    """The plan's table and counts as the C entry points take them: bf16 walks ``plan`` and raises without
    one; fp32 walks the lists themselves (null and zeros)."""
    if q.dtype != torch.bfloat16:
        return None, 0, 0, 0, 0, 0
    if plan is None:
        fn_plan = "_device_query_plan" if lists == "kidx" else "_device_dkv_plan"
        raise ValueError(f"{fn}: bf16 on the card walks a plan; pass {fn_plan}(...)")
    return plan.table.data_ptr(), plan.n_items, plan.n_reduce, plan.n_slots, plan.max_entries, plan.rows


def sparse_fwd(q, k, v, kidx, block: int, scale: float, causal: bool,
               plan: Optional[DevicePlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o like q, lse (B, H, S) fp32). q, k, v (B, S, H, D);
    kidx (H, S/block, A) int32. CUDA: float32 or bfloat16, block in
    KERNEL_BLOCKS, D in KERNEL_HEAD_DIMS; bf16 walks ``plan`` (kidx's
    ``DevicePlan``, from ``_device_query_plan``) and raises without one."""
    if plan is not None:
        plan.check("sparse_fwd", "kidx", kidx, block)
    if q.device.type == "cpu":
        return sparse_fwd_ref(q, k, v, kidx, block, scale, causal)
    _check("sparse_fwd", q, k, v, kidx, block)
    table, n_items, _, _, max_entries, rows = _plan_args("sparse_fwd", q, "kidx", plan)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = _build.lib().ds_sparse_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), kidx.data_ptr(), table, o.data_ptr(),
                                    lse.data_ptr(), B, S, H, D, block, kidx.shape[2], n_items, max_entries, rows,
                                    float(scale), int(causal), _build.dtype_code(q.dtype), _stream(q))
    _build.check(rc, "sparse_fwd")
    sparse_fwd.launches += 1
    return o, lse


def sparse_bwd_dq(q, k, v, do, lse, delta, kidx, block: int, scale: float, causal: bool,
                  plan: Optional[DevicePlan] = None) -> torch.Tensor:
    """dq kernel: dq like q. lse, delta (B, H, S) fp32. bf16 on the card
    walks ``plan``, as ``sparse_fwd`` does."""
    if plan is not None:
        plan.check("sparse_bwd_dq", "kidx", kidx, block)
    if q.device.type == "cpu":
        return sparse_bwd_dq_ref(q, k, v, do, lse, delta, kidx, block, scale, causal)
    _check("sparse_bwd_dq", q, k, v, kidx, block, do, lse, delta)
    table, n_items, _, _, max_entries, rows = _plan_args("sparse_bwd_dq", q, "kidx", plan)
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    rc = _build.lib().ds_sparse_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                       delta.data_ptr(), kidx.data_ptr(), table, dq.data_ptr(), B, S, H, D, block,
                                       kidx.shape[2], n_items, max_entries, rows, float(scale), int(causal),
                                       _build.dtype_code(q.dtype), _stream(q))
    _build.check(rc, "sparse_bwd_dq")
    sparse_bwd_dq.launches += 1
    return dq


def sparse_bwd_dkv(q, k, v, do, lse, delta, qidx, block: int, scale: float, causal: bool,
                   plan: Optional[DevicePlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel: (dk, dv) like k. qidx (H, S/block, Aq) int32. bf16 on
    the card walks ``plan`` (qidx's ``DevicePlan``, from
    ``_device_dkv_plan``), and raises without one; fp32 walks qidx itself."""
    if plan is not None:
        plan.check("sparse_bwd_dkv", "qidx", qidx, block)
    if q.device.type == "cpu":
        return sparse_bwd_dkv_ref(q, k, v, do, lse, delta, qidx, block, scale, causal)
    _check("sparse_bwd_dkv", q, k, v, qidx, block, do, lse, delta)
    table, *counts, rows = _plan_args("sparse_bwd_dkv", q, "qidx", plan)
    B, S, H, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ws = None
    if q.dtype == torch.bfloat16 and plan.n_slots:  # fp32 partials of the split walks
        ws = torch.empty((2, plan.n_slots, B, rows, D), dtype=torch.float32, device=q.device)  # dk's, then dv's
    rc = _build.lib().ds_sparse_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                        delta.data_ptr(), qidx.data_ptr(), table,
                                        ws.data_ptr() if ws is not None else None, dk.data_ptr(), dv.data_ptr(), B, S,
                                        H, D, block, qidx.shape[2], *counts, rows, float(scale), int(causal),
                                        _build.dtype_code(q.dtype), _stream(q))
    _build.check(rc, "sparse_bwd_dkv")
    sparse_bwd_dkv.launches += 1
    return dk, dv


sparse_fwd.launches = 0  # kernel launches since the last reset (CPU calls do not count)
sparse_bwd_dq.launches = 0
sparse_bwd_dkv.launches = 0


class _SparseAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kidx, qidx, plans, block, scale, causal):
        o, lse = sparse_fwd(q, k, v, kidx, block, scale, causal, plan=plans[0])
        ctx.save_for_backward(q, k, v, o, lse, kidx, qidx)
        ctx.args, ctx.plans = (block, scale, causal), plans
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kidx, qidx = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        dq = sparse_bwd_dq(q, k, v, do, lse, delta, kidx, *ctx.args, plan=ctx.plans[0])
        dk, dv = sparse_bwd_dkv(q, k, v, do, lse, delta, qidx, *ctx.args, plan=ctx.plans[1])
        return dq, dk, dv, None, None, None, None, None, None


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------
def layout_to_token_mask(layout: np.ndarray, block: int, causal: bool) -> np.ndarray:
    """Expand a block layout to a (H, S, S) token mask (oracle path)."""
    H, nq, nk = layout.shape
    mask = np.repeat(np.repeat(layout, block, axis=1), block, axis=2)
    if causal:
        S = nq * block
        mask = mask & np.tril(np.ones((S, S), dtype=bool))[None]
    return mask


def sparse_attention_xla(q, k, v, layout: np.ndarray, block: int, *, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Dense-masked reference implementation (numerics oracle); the name is
    the reference's. A query row with no active key gives zeros."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1]**0.5)
    mask = torch.from_numpy(np.ascontiguousarray(layout_to_token_mask(layout, block, causal))).to(q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(mask[None], logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask[None].any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _expand_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, KVH * n_rep, D): query head h reads KV head h // n_rep."""
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def sparse_attention(q, k, v, config: SparsityConfig, *, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention per a :class:`SparsityConfig` layout, with
    gradients for q, k and v.

    q/k/v: (B, S, H, D) (k, v may have fewer heads: GQA expands them, and
    autograd sums dk/dv over each group); the layout block is
    ``config.block``. CPU tensors run the kernels' plain versions; CUDA
    tensors the kernels, or raise."""
    B, S, H, D = q.shape
    if config.num_heads not in (1, H):
        raise ValueError(f"config.num_heads {config.num_heads} != attention heads {H}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[2]} KV heads")
    n_rep = H // k.shape[2]
    if n_rep > 1:
        k, v = _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    kidx, qidx = _device_lists(config, S, H, causal, q.device)
    plans = (None, None)  # the bf16 kernels' walks, for a configuration the kernels take (else sparse_fwd raises)
    if q.is_cuda and q.dtype == torch.bfloat16 and config.block in KERNEL_BLOCKS:
        plans = (_device_query_plan(config, S, H, causal, q.device), _device_dkv_plan(config, S, H, causal, q.device))
    scale = scale if scale is not None else 1.0 / (D**0.5)
    return _SparseAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), kidx, qidx, plans, config.block,
                                  float(scale), bool(causal))


class SparseSelfAttention:
    """Reference ``sparse_self_attention.py SparseSelfAttention`` — holds a
    sparsity config, applies block-sparse attention to (B, S, H, D) qkv."""

    def __init__(self, sparsity_config: SparsityConfig, causal: bool = True, scale: Optional[float] = None):
        self.sparsity_config = sparsity_config
        self.causal = causal
        self.scale = scale

    def __call__(self, q, k, v):
        return sparse_attention(q, k, v, self.sparsity_config, causal=self.causal, scale=self.scale)
