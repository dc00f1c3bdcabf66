"""The tensor-parallel serving reduce.

Port of ``deepspeed_tpu/comm/collectives.py:57-92`` (``tp_all_reduce``,
``_tp_reduce_chunk``). The JAX functions run inside ``shard_map`` over a
named mesh axis; here each rank is a process and ``group`` is the
``torch.distributed`` process group of the ``tensor`` axis (None: the
world). Plain PyTorch around ``comm.all_reduce``: the JAX reduce is
``jax.lax`` code, not a Pallas kernel.

- ``bits = 0``: a sum, in the tensor's dtype.
- ``interleave > 1``: one all-reduce per chunk of the last dimension, where
  it divides (the T3 seam: each chunk's reduce is independent of the
  others); each element is still reduced exactly once, so the result is
  the same bits as one reduce.
- ``bits`` 8 or 4 (EQuARX): the ranks agree on a per-row scale (the MAX of
  each rank's row amax), sum the int32 codes exactly, then rescale. An
  integer sum does not depend on the order of its terms, so every rank
  decodes the same bits; each element is off by at most ``tp * scale / 2``.
"""

import torch

from .comm import all_reduce
from .reduce_op import ReduceOp


def _tp_reduce_chunk(x: torch.Tensor, group, bits: int) -> torch.Tensor:
    if bits <= 0:
        out = x.contiguous().clone()
        all_reduce(out, ReduceOp.SUM, group=group)
        return out
    qmax = (1 << (bits - 1)) - 1
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).contiguous()
    all_reduce(amax, ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax, 1e-30) / qmax
    codes = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int32)
    all_reduce(codes, ReduceOp.SUM, group=group)
    return (codes.float() * scale).to(x.dtype)


def tp_all_reduce(tensor: torch.Tensor, group=None, bits: int = 0, interleave: int = 1) -> torch.Tensor:
    """Row-parallel activation reduce of tensor-parallel serving (after
    ``o_proj`` and after the MLP or MoE output). Returns a new tensor; the
    input is left as it was."""
    if interleave > 1 and tensor.shape[-1] % interleave == 0:
        chunks = torch.chunk(tensor, interleave, dim=-1)
        return torch.cat([_tp_reduce_chunk(c, group, bits) for c in chunks], dim=-1)
    return _tp_reduce_chunk(tensor, group, bits)

