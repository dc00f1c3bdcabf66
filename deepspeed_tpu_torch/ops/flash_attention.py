"""Flash attention: three hand-written CUDA kernels and their plain versions.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``. The kernels
(``csrc/flash_attention.cu``) replace the Pallas ``_fwd_kernel``,
``_dq_kernel`` and ``_dkv_kernel_gqa``; see its source note for the design.
``flash_attention`` wraps them in a ``torch.autograd.Function``: the
forward saves ``o`` and ``lse``; the backward computes
``delta = rowsum(o * do)`` in fp32 and launches dq and dk/dv. GQA stays
collapsed: KV keeps its KVH heads and dk/dv sum over each group in the
kernel. Layout (B, S, H, D); lse and delta are (B, H, Sq) fp32.

Each wrapper (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) takes its
plain version for CPU tensors and launches its kernel (or raises) for CUDA
tensors, and counts its launches. The additive ``bias`` of the reference
(evoformer's, with the ``_dq_kernel_collapsed``/``_dkv_kernel`` variants)
is not ported: it raises on CUDA.
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
def _scores(q, k, slopes, scale, causal, window):
    """(B, H, Sq, Sk) fp32 masked scores, the reference's ``_scores``:
    ``q.k * scale + slope * key_pos``, NEG_INF outside the causal (and
    window) band; queries are aligned to the end of the keys."""
    n_rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _repeat_kv(k, n_rep).float()) * scale
    sq, sk = q.shape[1], k.shape[1]
    cols = torch.arange(sk, device=q.device)
    if slopes is not None:
        s = s + slopes.float()[None, :, None, None] * cols.float()[None, None, None, :]
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = cols[None, :] <= rows
        if window:
            mask = mask & (cols[None, :] > rows - window)
        s = torch.where(mask[None, None], s, torch.full((), NEG_INF, device=q.device))
    return s


def flash_fwd_ref(q, k, v, slopes, scale: float, causal: bool, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel A: (o like q, lse (B, H, Sq) fp32). A row that
    sees no key gives o = 0 and lse = NEG_INF."""
    s = _scores(q, k, slopes, scale, causal, window)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    n_rep = q.shape[2] // k.shape[2]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _repeat_kv(v, n_rep).float())
    o = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def _dscores(q, k, v, do, lse, delta, slopes, scale, causal, window):
    """p = exp(s - lse) and ds = p * (dp - delta) * scale, both (B, H, Sq, Sk) fp32."""
    s = _scores(q, k, slopes, scale, causal, window)
    p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - lse[..., None]))
    n_rep = q.shape[2] // k.shape[2]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _repeat_kv(v, n_rep).float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_ref(q, k, v, do, lse, delta, slopes, scale: float, causal: bool, window: int) -> torch.Tensor:
    """Plain version of kernel B: dq = (p (dp - delta) scale) k, like q."""
    _, ds = _dscores(q, k, v, do, lse, delta, slopes, scale, causal, window)
    n_rep = q.shape[2] // k.shape[2]
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), _repeat_kv(k, n_rep).float())
    return dq.to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, slopes, scale: float, causal: bool,
                      window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel C: dv = p^T do and dk = (p (dp - delta) scale)^T q,
    each summed over the query heads of its KV head, in k's dtype."""
    p, ds = _dscores(q, k, v, do, lse, delta, slopes, scale, causal, window)
    B, Sk, KVH, D = k.shape
    n_rep = q.shape[2] // KVH
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    fold = lambda x: x.reshape(B, Sk, KVH, n_rep, D).sum(3).to(k.dtype)
    return fold(dk), fold(dv)


# ------------------------------------------------------------------
# kernel wrappers
# ------------------------------------------------------------------
def _check(what, q, k, v, slopes, do=None, lse=None, delta=None):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, Sq, H, D) / (B, Sk, KVH, D)")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{what}: {q.shape[2]} query heads are not a multiple of {k.shape[2]} KV heads")
    given = [t for t in (q, k, v, do, lse, delta) if t is not None]
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


def _dims(q, k):
    B, Sq, H, D = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], D


def flash_fwd(q, k, v, slopes, scale: float, causal: bool, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: (o, lse). q (B, Sq, H, D); k, v (B, Sk, KVH, D); slopes (H,)
    fp32 or None; window 0 = none (only with causal). CUDA: float32 or
    bfloat16, D in {32, 64, 128}."""
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, slopes, scale, causal, window)
    _check("flash_fwd", q, k, v, slopes)
    B, Sq, Sk, H, KVH, D = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _build.lib().ds_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   slopes.data_ptr() if slopes is not None else None, o.data_ptr(), lse.data_ptr(),
                                   B, Sq, Sk, H, KVH, D, float(scale), int(causal), int(window),
                                   _build.dtype_code(q.dtype), _stream(q))
    _build.check(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, slopes, scale: float, causal: bool, window: int) -> torch.Tensor:
    """Kernel B: dq like q. lse, delta (B, H, Sq) fp32."""
    if not q.is_cuda:
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, slopes, scale, causal, window)
    _check("flash_bwd_dq", q, k, v, slopes, do, lse, delta)
    B, Sq, Sk, H, KVH, D = _dims(q, k)
    dq = torch.empty_like(q)
    rc = _build.lib().ds_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                      delta.data_ptr(), slopes.data_ptr() if slopes is not None else None,
                                      dq.data_ptr(), B, Sq, Sk, H, KVH, D, float(scale), int(causal), int(window),
                                      _build.dtype_code(q.dtype), _stream(q))
    _build.check(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, slopes, scale: float, causal: bool,
                  window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C: (dk, dv) like k, summed over each KV head's query heads."""
    if not q.is_cuda:
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, slopes, scale, causal, window)
    _check("flash_bwd_dkv", q, k, v, slopes, do, lse, delta)
    B, Sq, Sk, H, KVH, D = _dims(q, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _build.lib().ds_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                       delta.data_ptr(), slopes.data_ptr() if slopes is not None else None,
                                       dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KVH, D, float(scale),
                                       int(causal), int(window), _build.dtype_code(q.dtype), _stream(q))
    _build.check(rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0  # kernel launches since the last reset (CPU calls do not count)
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(o * do) in fp32, laid out (B, H, Sq)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, slopes, scale, causal, window):
        o, lse = flash_fwd(q, k, v, slopes, scale, causal, window)
        ctx.save_for_backward(q, k, v, o, lse, slopes)
        ctx.args = (scale, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, slopes = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, slopes, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, slopes, *ctx.args)
        return dq, dk, dv, None, None, None, None


def routes_to_plain(causal: bool, segment_ids=None, kv_len=None, window=None, alibi_slopes=None) -> bool:
    """The reference's routing (``flash_attention``, ``:612-622``): packed
    segments, padded KV, and non-causal ALiBi or windows go to the plain path."""
    return (segment_ids is not None or kv_len is not None or (alibi_slopes is not None and not causal)
            or (window is not None and not causal))


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None, bias=None, segment_ids=None,
                    kv_len=None, window: Optional[int] = None, alibi_slopes=None) -> torch.Tensor:
    """Attention over (B, S, H, D) through the flash kernels, with gradients.

    Takes causal masks (queries aligned to the end of the keys), ALiBi and a
    causal sliding window in the kernels; segment ids, ``kv_len`` and
    non-causal windows or ALiBi go to ``attention_xla`` as in the reference.
    On the CPU the same autograd function runs the kernels' plain versions.
    An additive ``bias`` is taken by the plain path on the CPU and raises on
    CUDA (its kernels are not ported)."""
    if routes_to_plain(causal, segment_ids, kv_len, window, alibi_slopes) or (bias is not None and not q.is_cuda):
        return attention_xla(q, k, v, causal=causal, scale=scale, bias=bias, segment_ids=segment_ids,
                             kv_len=kv_len, window=window, alibi_slopes=alibi_slopes)
    if bias is not None:
        raise NotImplementedError("flash_attention: the additive-bias kernels (evoformer) are not ported to CUDA")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window}); pass None to disable the sliding window")
    scale = scale if scale is not None else 1.0 / (q.shape[-1]**0.5)
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32).to(q.device).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), slopes, float(scale), bool(causal),
                                 int(window or 0))
