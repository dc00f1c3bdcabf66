"""Compressed collectives: error-compensated 1-bit all-reduce and the int8
all-to-all gradient reduction of ZeRO++'s qgZ.

Port of ``deepspeed_tpu/runtime/comm/compressed.py`` (reference
``runtime/comm/nccl.py:51 compressed_allreduce`` and
``coalesced_collectives.py:81 all_to_all_quant_reduce``). The JAX functions
run inside ``shard_map`` over a mesh axis; these take a
``torch.distributed`` process group (``None``: the world) and move int8
codes over ``all_to_all_single`` and ``all_gather_into_tensor``, the same
wire format. Every function is pure: the 1-bit error feedback is the
caller's state.

One int8 scheme serves the repository (``_quantize_int8``): the scale is a
row's absmax / 127 (1.0 for a row of zeros), codes round half to even and
clip to +-127.
"""

from typing import List, Sequence, Tuple

import torch

from ... import comm as dist


def _quantize_int8(x: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, fp32 scales keeping ``dim`` as 1) of an fp32 tensor."""
    scale = x.abs().amax(dim=dim, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_1bit(x: torch.Tensor, error: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-compensated sign compression, one scale per last-dim row:
    (int8 signs in {-1, +1}, fp32 scales (..., 1), the new error). The scale
    ``mean(|x + error|)`` minimises the L2 error of sign codes."""
    compensated = x + error
    scale = compensated.abs().mean(dim=-1, keepdim=True)
    sign = torch.where(compensated >= 0, 1, -1).to(torch.int8)
    new_error = compensated - scale * sign.to(torch.float32)
    return sign, scale, new_error


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row j of ``x`` (world, ...) to rank j; row i of the result from rank i."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x`` in rank order."""
    out = torch.empty((dist.get_world_size(group),) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out.view(-1), x.contiguous().view(-1), group=group)
    return out


def _flat_chunks(x: torch.Tensor, world: int, what: str) -> torch.Tensor:
    n = x.numel()
    if n % world != 0:
        raise ValueError(f"{what} needs size {n} divisible by the group size {world} (pad first)")
    return x.reshape(world, n // world)


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor, server_error: torch.Tensor,
                         group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-phase error-compensated 1-bit all-reduce (the mean) over ``group``.

    ``x`` and ``worker_error``: this rank's whole vector; ``server_error``:
    one chunk (n // world). Returns (the mean, the new worker error, the new
    server error). Phase 1 sends each rank one chunk of every peer's signs
    (per-chunk scales); phase 2 recompresses the mean of that chunk and
    all-gathers the int8 signs."""
    world = dist.get_world_size(group)
    flat = _flat_chunks(x, world, "compressed_allreduce")
    sign_w, scale_w, new_worker_error = compress_1bit(flat, worker_error.reshape(flat.shape))
    chunks = _all_to_all(sign_w, group)  # (world, chunk): chunk r of every peer
    peer_scales = _all_to_all(scale_w, group)  # (world, 1)
    server_chunk = (chunks.to(torch.float32) * peer_scales).mean(dim=0)
    sign_s, scale_s, new_server_error = compress_1bit(server_chunk, server_error)
    out = (_all_gather(sign_s, group).to(torch.float32) * _all_gather(scale_s, group)).reshape(x.shape)
    return out, new_worker_error.reshape(worker_error.shape), new_server_error


def all_to_all_quant_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """qgZ's quantised reduction: the mean of ``x`` over ``group`` (its full
    shape) with int8 on the wire. Each rank quantises its ``world`` flat
    chunks (a scale each), the all-to-all hands rank r chunk r of every
    peer, rank r dequantises and averages them, requantises its chunk (one
    scale), and an all-gather of the codes and scales rebuilds the whole."""
    return all_to_all_quant_reduce_coalesced([x], group)[0]


def all_to_all_quant_reduce_coalesced(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """``all_to_all_quant_reduce`` of each tensor, the tensors sharing each of
    the four collectives: each tensor's numbers are those of its own call."""
    world = dist.get_world_size(group)
    flats = [_flat_chunks(x, world, "all_to_all_quant_reduce").to(torch.float32) for x in tensors]
    codes, scales = zip(*(_quantize_int8(f, dim=1) for f in flats))
    chunks = _all_to_all(torch.cat(codes, dim=1), group)  # (world, sum of chunks): chunk r of every tensor
    chunk_scales = _all_to_all(torch.cat(scales, dim=1), group)  # (world, tensors)
    owned_q, owned_s, off = [], [], 0
    for i, f in enumerate(flats):
        c = f.shape[1]
        owned = (chunks[:, off:off + c].to(torch.float32) * chunk_scales[:, i:i + 1]).mean(dim=0)
        q2, s2 = _quantize_int8(owned[None, :], dim=1)
        owned_q.append(q2[0])
        owned_s.append(s2[0])
        off += c
    gathered = _all_gather(torch.cat(owned_q), group).to(torch.float32)
    gathered_scales = _all_gather(torch.cat(owned_s), group)
    out, off = [], 0
    for i, (x, f) in enumerate(zip(tensors, flats)):
        c = f.shape[1]
        out.append((gathered[:, off:off + c] * gathered_scales[:, i:i + 1]).reshape(x.shape))
        off += c
    return out


def reduce_scatter_coalesced(tensors: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """The tensors flattened, concatenated and zero-padded to a multiple of
    the group size; returns this rank's chunk of their mean over ``group``
    (reference ``coalesced_collectives.py:31``)."""
    world = dist.get_world_size(group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    pad = (-flat.numel()) % world
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = flat.new_empty(flat.numel() // world)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out / world
