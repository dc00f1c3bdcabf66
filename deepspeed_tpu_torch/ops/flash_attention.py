"""Flash attention: hand-written CUDA kernels and their plain versions.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``. The kernels
replace the Pallas ``_fwd_kernel``, ``_dq_kernel``, ``_dq_kernel_collapsed``,
``_dkv_kernel`` and ``_dkv_kernel_gqa``. The bf16 forward is
``csrc/flash_fwd.cu`` (scores, probabilities and the output accumulator in
registers on mma.sync, K/V through a cp.async ring, mask arithmetic only on
the tiles a mask cuts, the longest causal tiles first); the fp32 forward and
the dq and dk/dv kernels are ``csrc/flash_attention.cu``; see their source
notes for the design.
``flash_attention`` wraps them in a ``torch.autograd.Function``: the
forward saves ``o`` and ``lse``; the backward computes
``delta = rowsum(o * do)`` in fp32 and launches dq and dk/dv. GQA stays
collapsed: KV keeps its KVH heads and dk/dv sum over each group in the
kernel. Layout (B, S, H, D); lse and delta are (B, H, Sq) fp32.

An additive ``bias`` (evoformer's pair and mask biases) is fp32 and flat,
``(Bb * Hb, Sqb, Sk)``, described by ``bias_meta = (Bb, Hb, Sqb, repeat)``:
its batch, head and row dims may each be 1 and stay collapsed, and query
batch ``b`` reads bias batch ``b // repeat``. When nothing is collapsed,
the dq kernel writes dbias per program; otherwise ``flash_bwd_dq_collapsed``
sums dbias over the programs that share a bias slice, in the bias's own
shape.

Each wrapper (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dq_collapsed``,
``flash_bwd_dkv``) takes its plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors, and counts its launches.
"""

from typing import Optional, Tuple

import torch

from . import _build
from .attention import _repeat_kv, attention_xla

NEG_INF = -1e30  # the reference kernels' mask value


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick on the card)
# ------------------------------------------------------------------
def expand_bias(bias, bias_meta, B: int, H: int, Sq: int) -> torch.Tensor:
    """The flat (Bb*Hb, Sqb, Sk) bias broadcast to (B, H, Sq, Sk): program
    (b, h) reads slice ``(b // repeat if Bb > 1 else 0) * Hb + (h if Hb > 1
    else 0)``, the reference's ``_bias_bh_fn``."""
    Bb, Hb, Sqb, _ = bias_meta
    Sk = bias.shape[-1]
    return bias.reshape(Bb, 1, Hb, Sqb, Sk).expand(Bb, B // Bb, H, Sq, Sk).reshape(B, H, Sq, Sk)


def collapse_dbias(dlogits, bias_meta) -> torch.Tensor:
    """(B, H, Sq, Sk) dlogits summed over the programs (and, when Sqb == 1,
    the rows) that share each bias slice: the flat (Bb*Hb, Sqb, Sk) dbias."""
    Bb, Hb, Sqb, _ = bias_meta
    B, H, Sq, Sk = dlogits.shape
    d = dlogits.reshape(Bb, B // Bb, H, Sq, Sk).sum(1)
    if Hb == 1:
        d = d.sum(1, keepdim=True)
    if Sqb == 1:
        d = d.sum(2, keepdim=True)
    return d.reshape(Bb * Hb, Sqb, Sk)


def _scores(q, k, slopes, scale, causal, window, bias=None, bias_meta=None):
    """(B, H, Sq, Sk) fp32 masked scores, the reference's ``_scores``:
    ``q.k * scale + slope * key_pos + bias``, NEG_INF outside the causal (and
    window) band; queries are aligned to the end of the keys. The bias is
    added before masking, so masked entries are exactly NEG_INF."""
    n_rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _repeat_kv(k, n_rep).float()) * scale
    B, sq, H, _ = q.shape
    sk = k.shape[1]
    cols = torch.arange(sk, device=q.device)
    if slopes is not None:
        s = s + slopes.float()[None, :, None, None] * cols.float()[None, None, None, :]
    if bias is not None:
        s = s + expand_bias(bias, bias_meta, B, H, sq)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = cols[None, :] <= rows
        if window:
            mask = mask & (cols[None, :] > rows - window)
        s = torch.where(mask[None, None], s, torch.full((), NEG_INF, device=q.device))
    return s


def flash_fwd_ref(q, k, v, slopes, scale: float, causal: bool, window: int, bias=None,
                  bias_meta=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o like q, lse (B, H, Sq) fp32). A
    row that sees no key gives o = 0 and lse = NEG_INF."""
    s = _scores(q, k, slopes, scale, causal, window, bias, bias_meta)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    n_rep = q.shape[2] // k.shape[2]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _repeat_kv(v, n_rep).float())
    o = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def _dscores(q, k, v, do, lse, delta, slopes, scale, causal, window, bias=None, bias_meta=None):
    """p = exp(s - lse) and dlogits = p * (dp - delta), both (B, H, Sq, Sk)
    fp32; ds = dlogits * scale, and dbias = dlogits (the bias is unscaled)."""
    s = _scores(q, k, slopes, scale, causal, window, bias, bias_meta)
    p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - lse[..., None]))
    n_rep = q.shape[2] // k.shape[2]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _repeat_kv(v, n_rep).float())
    return p, p * (dp - delta[..., None])


def _dq_from(dlogits, k, q, scale):
    n_rep = q.shape[2] // k.shape[2]
    dq = torch.einsum("bhqk,bkhd->bqhd", (dlogits * scale).to(k.dtype).float(), _repeat_kv(k, n_rep).float())
    return dq.to(q.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, slopes, scale: float, causal: bool, window: int, bias=None,
                     bias_meta=None, dbias=None) -> torch.Tensor:
    """Plain version of the dq kernel: dq = (p (dp - delta) scale) k, like q.
    With a bias that nothing collapses, ``dbias`` (B*H, Sq, Sk) fp32 receives
    dlogits = p (dp - delta) of every program."""
    _, dl = _dscores(q, k, v, do, lse, delta, slopes, scale, causal, window, bias, bias_meta)
    if dbias is not None:
        dbias.copy_(dl.reshape(dbias.shape))
    return _dq_from(dl, k, q, scale)


def flash_bwd_dq_collapsed_ref(q, k, v, do, lse, delta, slopes, scale: float, causal: bool, window: int, bias,
                               bias_meta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the collapsed dq kernel: (dq like q, dbias in the
    bias's own flat shape (Bb*Hb, Sqb, Sk) fp32, summed over the programs and,
    when Sqb == 1, the query rows that share each slice)."""
    _, dl = _dscores(q, k, v, do, lse, delta, slopes, scale, causal, window, bias, bias_meta)
    return _dq_from(dl, k, q, scale), collapse_dbias(dl, bias_meta)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, slopes, scale: float, causal: bool, window: int, bias=None,
                      bias_meta=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: dv = p^T do and dk = (p (dp - delta)
    scale)^T q, each summed over the query heads of its KV head, in k's dtype."""
    p, dl = _dscores(q, k, v, do, lse, delta, slopes, scale, causal, window, bias, bias_meta)
    B, Sk, KVH, D = k.shape
    n_rep = q.shape[2] // KVH
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", (dl * scale).to(q.dtype).float(), q.float())
    fold = lambda x: x.reshape(B, Sk, KVH, n_rep, D).sum(3).to(k.dtype)
    return fold(dk), fold(dv)


# ------------------------------------------------------------------
# kernel wrappers
# ------------------------------------------------------------------
def _check(what, q, k, v, slopes, do=None, lse=None, delta=None, bias=None, bias_meta=None):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, Sq, H, D) / (B, Sk, KVH, D)")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{what}: {q.shape[2]} query heads are not a multiple of {k.shape[2]} KV heads")
    given = [t for t in (q, k, v, do, lse, delta, bias) if t is not None]
    if any(not t.is_cuda or t.device != q.device or not t.is_contiguous() for t in given):
        raise ValueError(f"{what}: every tensor must be contiguous on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype or (do is not None and (do.dtype, do.shape) != (q.dtype, q.shape)):
        raise ValueError(f"{what}: k, v (and do) must have q's dtype {q.dtype} (and do q's shape)")
    B, Sq, H, _ = q.shape
    for t in (lse, delta):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq)):
            raise ValueError(f"{what}: lse and delta must be ({B}, {H}, {Sq}) float32")
    if slopes is not None and (slopes.dtype != torch.float32 or slopes.device != q.device
                               or slopes.shape != (q.shape[2],)):
        raise ValueError(f"{what}: slopes must be ({q.shape[2]},) float32 on {q.device}")
    if bias is not None:
        Bb, Hb, Sqb, repeat = bias_meta
        if (bias.dtype != torch.float32 or tuple(bias.shape) != (Bb * Hb, Sqb, k.shape[1]) or Sqb not in (1, Sq)
                or Hb not in (1, H) or (Bb != 1 and Bb * repeat != B) or (Bb == 1 and repeat != 1)):
            raise ValueError(f"{what}: bias {tuple(bias.shape)} float32 with meta {bias_meta} does not fit "
                             f"({B}, {H}, {Sq}, {k.shape[1]})")


def _bias_args(bias, bias_meta):
    """The C entry points' bias arguments: pointer (or null), Bb, Hb, Sqb, repeat."""
    if bias is None:
        return None, 1, 1, 1, 1
    return (bias.data_ptr(), *bias_meta)


def _dims(q, k):
    B, Sq, H, D = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], D


def flash_fwd(q, k, v, slopes, scale: float, causal: bool, window: int, bias=None,
              bias_meta=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (o, lse). q (B, Sq, H, D); k, v (B, Sk, KVH, D); slopes
    (H,) fp32 or None; window 0 = none (only with causal); bias the flat fp32
    (Bb*Hb, Sqb, Sk) or None. CUDA: float32 or bfloat16, D in {32, 64, 128}."""
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, slopes, scale, causal, window, bias, bias_meta)
    _check("flash_fwd", q, k, v, slopes, bias=bias, bias_meta=bias_meta)
    B, Sq, Sk, H, KVH, D = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _build.lib().ds_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   slopes.data_ptr() if slopes is not None else None, *_bias_args(bias, bias_meta),
                                   o.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, KVH, D, float(scale), int(causal),
                                   int(window), _build.dtype_code(q.dtype), _stream(q))
    _build.check(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, slopes, scale: float, causal: bool, window: int, bias=None,
                 bias_meta=None, dbias=None) -> torch.Tensor:
    """dq kernel: dq like q. lse, delta (B, H, Sq) fp32. With a bias that
    nothing collapses, ``dbias`` (B*H, Sq, Sk) fp32 receives every program's
    dlogits."""
    if not q.is_cuda:
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, slopes, scale, causal, window, bias, bias_meta, dbias)
    _check("flash_bwd_dq", q, k, v, slopes, do, lse, delta, bias, bias_meta)
    B, Sq, Sk, H, KVH, D = _dims(q, k)
    if (dbias is None) != (bias is None) or (dbias is not None and (
            dbias.dtype != torch.float32 or tuple(dbias.shape) != (B * H, Sq, Sk) or not dbias.is_contiguous()
            or tuple(bias.shape) != tuple(dbias.shape) or dbias.device != q.device)):
        raise ValueError(f"flash_bwd_dq: dbias must come with a bias that nothing collapses, contiguous "
                         f"({B * H}, {Sq}, {Sk}) float32 on {q.device}")
    dq = torch.empty_like(q)
    rc = _build.lib().ds_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                      delta.data_ptr(), slopes.data_ptr() if slopes is not None else None,
                                      *_bias_args(bias, bias_meta), dq.data_ptr(),
                                      dbias.data_ptr() if dbias is not None else None, B, Sq, Sk, H, KVH, D,
                                      float(scale), int(causal), int(window), _build.dtype_code(q.dtype), _stream(q))
    _build.check(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dq_collapsed(q, k, v, do, lse, delta, slopes, scale: float, causal: bool, window: int, bias,
                           bias_meta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapsed dq kernel: (dq like q, dbias (Bb*Hb, Sqb, Sk) fp32 summed over
    the programs sharing each slice). The sharing programs are split into
    chunks; each block owns its fp32 partial in scratch, and the partials are
    summed in a fixed order, so dbias repeats bit for bit from run to run."""
    if not q.is_cuda:
        return flash_bwd_dq_collapsed_ref(q, k, v, do, lse, delta, slopes, scale, causal, window, bias, bias_meta)
    _check("flash_bwd_dq_collapsed", q, k, v, slopes, do, lse, delta, bias, bias_meta)
    B, Sq, Sk, H, KVH, D = _dims(q, k)
    Bb, Hb, Sqb, repeat = bias_meta
    lib, dtype = _build.lib(), _build.dtype_code(q.dtype)
    n_parts = lib.ds_flash_dq_collapsed_parts(B, Sq, H, Bb, Hb, Sqb, dtype)
    _build.check(min(n_parts, 0), "flash_bwd_dq_collapsed")
    dq = torch.empty_like(q)
    dbias = torch.empty_like(bias)
    parts = torch.empty((n_parts, *bias.shape), dtype=torch.float32, device=q.device) if n_parts > 1 else None
    rc = lib.ds_flash_bwd_dq_collapsed(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                       delta.data_ptr(), slopes.data_ptr() if slopes is not None else None,
                                       bias.data_ptr(), dq.data_ptr(), dbias.data_ptr(),
                                       parts.data_ptr() if parts is not None else None, B, Sq, Sk, H, KVH, D,
                                       float(scale), int(causal), int(window), Bb, Hb, Sqb, repeat, dtype, _stream(q))
    _build.check(rc, "flash_bwd_dq_collapsed")
    flash_bwd_dq_collapsed.launches += 1
    return dq, dbias


def flash_bwd_dkv(q, k, v, do, lse, delta, slopes, scale: float, causal: bool, window: int, bias=None,
                  bias_meta=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel: (dk, dv) like k, summed over each KV head's query heads."""
    if not q.is_cuda:
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, slopes, scale, causal, window, bias, bias_meta)
    _check("flash_bwd_dkv", q, k, v, slopes, do, lse, delta, bias, bias_meta)
    B, Sq, Sk, H, KVH, D = _dims(q, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _build.lib().ds_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                       delta.data_ptr(), slopes.data_ptr() if slopes is not None else None,
                                       *_bias_args(bias, bias_meta), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KVH,
                                       D, float(scale), int(causal), int(window), _build.dtype_code(q.dtype),
                                       _stream(q))
    _build.check(rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0  # kernel launches since the last reset (CPU calls do not count)
flash_bwd_dq.launches = 0
flash_bwd_dq_collapsed.launches = 0
flash_bwd_dkv.launches = 0


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(o * do) in fp32, laid out (B, H, Sq)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def bias_is_collapsed(bias_meta, B: int, H: int) -> bool:
    """The reference's test (``_flash_bwd``): a bias slice shared by several
    programs, or one row shared by every query row, takes the collapsed dq."""
    Bb, Hb, Sqb, _ = bias_meta
    return Bb * Hb < B * H or Sqb == 1


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, slopes, bias, bias_meta, scale, causal, window):
        o, lse = flash_fwd(q, k, v, slopes, scale, causal, window, bias, bias_meta)
        ctx.save_for_backward(q, k, v, o, lse, slopes, bias)
        ctx.bias_meta = bias_meta
        ctx.args = (scale, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, slopes, bias = ctx.saved_tensors
        meta = ctx.bias_meta
        do = do.contiguous()
        delta = flash_delta(o, do)
        dbias = None
        if bias is None:
            dq = flash_bwd_dq(q, k, v, do, lse, delta, slopes, *ctx.args)
        elif bias_is_collapsed(meta, q.shape[0], q.shape[2]):
            dq, dbias = flash_bwd_dq_collapsed(q, k, v, do, lse, delta, slopes, *ctx.args, bias, meta)
        else:
            dbias = torch.empty_like(bias)
            dq = flash_bwd_dq(q, k, v, do, lse, delta, slopes, *ctx.args, bias, meta, dbias)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, slopes, *ctx.args, bias, meta)
        return dq, dk, dv, None, dbias, None, None, None, None


def routes_to_plain(causal: bool, segment_ids=None, kv_len=None, window=None, alibi_slopes=None) -> bool:
    """The reference's routing (``flash_attention``, ``:612-622``): packed
    segments, padded KV, and non-causal ALiBi or windows go to the plain path."""
    return (segment_ids is not None or kv_len is not None or (alibi_slopes is not None and not causal)
            or (window is not None and not causal))


def _pad4(bias: torch.Tensor) -> torch.Tensor:
    while bias.dim() < 4:  # pad first so axis 0 is batch, not heads
        bias = bias[None]
    return bias


def flat_bias(bias: torch.Tensor, bias_repeat: int, B: int, H: int, Sq: int, Sk: int):
    """A bias broadcastable to (B, H, Sq, Sk), its batch dim times
    ``bias_repeat`` being B, -> (the flat fp32 (Bb*Hb, Sqb, Sk) bias,
    ``bias_meta``); raises the reference's ``ValueError`` on any other shape."""
    bias = _pad4(bias.float())
    Bb, Hb, Sqb, Skb = bias.shape
    if Skb != Sk or Sqb not in (1, Sq) or Hb not in (1, H) or (Bb != 1 and Bb * bias_repeat != B):
        raise ValueError(f"bias shape {tuple(bias.shape)} is not broadcastable to ({B},{H},{Sq},{Sk}) "
                         f"with bias_repeat={bias_repeat}")
    return bias.reshape(Bb * Hb, Sqb, Sk).contiguous(), (Bb, Hb, Sqb, bias_repeat if Bb > 1 else 1)


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None, bias=None, segment_ids=None,
                    kv_len=None, window: Optional[int] = None, alibi_slopes=None,
                    bias_repeat: int = 1) -> torch.Tensor:
    """Attention over (B, S, H, D) through the flash kernels, with gradients.

    Takes causal masks (queries aligned to the end of the keys), ALiBi, a
    causal sliding window and an additive ``bias`` in the kernels; segment
    ids, ``kv_len`` and non-causal windows or ALiBi go to ``attention_xla`` as
    in the reference. On the CPU the same autograd function runs the
    kernels' plain versions.

    ``bias``: additive logits bias broadcastable to (B, H, Sq, Sk) whose
    batch, head and row dims may each be 1 and stay collapsed; the gradient
    comes back in its own shape. ``bias_repeat``: the query batch is
    ``bias.shape[0] * bias_repeat`` (consecutive query batches share one bias
    slice, as evoformer's MSA rows share a pair bias). With GQA and a bias,
    KV is expanded to the query heads, as in the reference."""
    if routes_to_plain(causal, segment_ids, kv_len, window, alibi_slopes):
        if bias is not None and bias_repeat != 1:
            bias = _pad4(torch.as_tensor(bias)).repeat_interleave(bias_repeat, dim=0)
        return attention_xla(q, k, v, causal=causal, scale=scale, bias=bias, segment_ids=segment_ids,
                             kv_len=kv_len, window=window, alibi_slopes=alibi_slopes)
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1 and bias is not None:
        # the bias kernels route per query head: expand KV; autograd sums the
        # gradients back into (B, S, KVH, D)
        k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window}); pass None to disable the sliding window")
    scale = scale if scale is not None else 1.0 / (q.shape[-1]**0.5)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32).to(q.device).contiguous()
    bias_meta = None
    if bias is not None:
        bias, bias_meta = flat_bias(torch.as_tensor(bias).to(q.device), bias_repeat, q.shape[0], q.shape[2],
                                    q.shape[1], k.shape[1])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), slopes, bias, bias_meta,
                                 float(scale), bool(causal), int(window or 0))
