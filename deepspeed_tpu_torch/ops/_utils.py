"""Shared helpers of the ops (the port's copy of ``deepspeed_tpu/ops/pallas/_utils.py``, and the split-K
kernels' tile counters)."""

import torch


def block_that_divides(n: int, want: int) -> int:
    """Largest power-of-two-reduced block <= ``want`` that divides ``n``."""
    b = min(n, want)
    while n % b:
        b //= 2
    return max(b, 1)


_COUNTERS = {}  # device -> int32 zeros: a split-K launch's counter of arrived slices a tile (its kernel re-zeroes them)


def tile_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, kept across calls (so a
    graph's replay finds them zero, as the last launch left them) and shared
    by the split-K kernels, which run in stream order."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf
