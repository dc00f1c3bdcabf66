"""ZeRO++: quantised weight gathers (qwZ), quantised gradient reduction
(qgZ) and a secondary partition for the backward's regather (hpZ).

Port of ``deepspeed_tpu/runtime/zero/zeropp.py`` (reference ZeRO++:
``zero/config.py:264-280``, ``partition_parameters.py:728``,
``coalesced_collectives.py:81``, ``groups.py:517``). The JAX package runs
its stage-3 step as one ``shard_map`` whose collectives it writes out; here
the same wire formats live in stage 3's own collectives
(``sharded.py``: ``Collectives`` and ``Stage3Params``):

- qwZ: each rank quantises its fp32 chunk of a leaf, flattened and
  zero-padded, in groups of ``GROUP`` elements (``quant_int8``); the int8
  codes and fp32 scales are all-gathered over fsdp and each chunk is
  dequantised in the compute type before the chunks join along the leaf's
  ZeRO dimension (JAX ``_gather_leaf``'s forward). A chunk of n elements
  moves rows x GROUP code bytes and 4 x rows scale bytes, rows =
  ceil(n / GROUP) (n + 4 ceil(n / 2048) when GROUP divides n or n < GROUP).
- qgZ: the gather's backward turns each leaf's whole gradient into this
  rank's chunk through ``all_to_all_quant_reduce`` over fsdp (its flat
  gradient in fsdp chunks, a scale each), times the group size; with
  ``data`` > 1 the chunk is reduced the same way over ``data`` (JAX
  ``bwd`` and ``reduce_grads``). The engine's gradients are already
  weighted by 1 / (data x fsdp) (``_weigh``), so both steps take the sum
  (mean x group size) where the JAX step takes the data mean and 1 / fsdp.
  Leaves that stay whole reduce in full precision, as there.
- hpZ with k: after a block's forward gather each rank keeps only its 1/k
  of each sharded leaf along the leaf's ZeRO dimension (fsdp rank mod k),
  and the backward's regather all-gathers those slices over the k
  neighbouring fsdp ranks (``MeshTopology.hpz_group``) instead of the
  whole fsdp group. The same numbers arrive, so hpZ is exact.

ZeRO++ acts at stage 3 over an fsdp axis above 1 with every model axis
(tensor, pipe, seq, context, expert) at 1; otherwise the engine logs
``zeropp_applicable``'s reason and trains plain stage 3 (JAX
``engine.py:411-418``).
"""

from typing import Tuple

import torch

from ..comm.compressed import _quantize_int8

GROUP = 2048  # elements a quantisation scale (JAX ``_GROUP``)


def zeropp_requested(config) -> bool:
    z = config.zero_config
    return bool(z.zero_quantized_weights or z.zero_quantized_gradients or z.zero_hpz_partition_size > 1)


def zeropp_applicable(config, topo) -> Tuple[bool, str]:
    """(whether ZeRO++ runs, the reason it does not): the JAX function's answers, word for word."""
    z = config.zero_config
    if not zeropp_requested(config):
        return False, "no ZeRO++ feature enabled"
    for axis in ("tensor", "pipe", "seq", "context", "expert"):
        if topo.axis_size(axis) > 1:
            return False, f"ZeRO++ manual path needs axis {axis}=1 (got {topo.axis_size(axis)})"
    if topo.axis_size("fsdp") <= 1:
        return False, "ZeRO++ needs an fsdp axis > 1"
    if z.stage != 3:
        return False, f"ZeRO++ manual path expects stage 3 (got {z.stage})"
    return True, ""


def check_hpz(config, topo) -> int:
    """hpZ's k, which must divide the fsdp axis (JAX ``zeropp.py:162-163``)."""
    k = config.zero_config.zero_hpz_partition_size
    fsdp = topo.axis_size("fsdp")
    if k > 1 and fsdp % k != 0:
        raise ValueError(f"zero_hpz_partition_size {k} must divide the fsdp axis size {fsdp}")
    return k


def quant_rows(n: int) -> Tuple[int, int]:
    """(rows, group) of a flat chunk of n elements: one scale a row."""
    g = min(GROUP, n)
    return -(-n // g), g


def quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk flattened, zero-padded to whole groups and quantised a group at
    a time: (codes (rows, g) int8, scales (rows, 1) fp32) (JAX ``_quant_int8``)."""
    flat = x.reshape(-1).to(torch.float32)
    rows, g = quant_rows(flat.numel())
    pad = rows * g - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return _quantize_int8(flat.view(rows, g), dim=1)


def dequant_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """A chunk of ``shape`` back from its codes and scales, in ``dtype`` (JAX ``_dequant_int8``)."""
    n = 1
    for s in shape:
        n *= int(s)
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(shape).to(dtype)
