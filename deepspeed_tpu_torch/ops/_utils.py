"""Shared helpers of the ops (the port's copy of ``deepspeed_tpu/ops/pallas/_utils.py``)."""


def block_that_divides(n: int, want: int) -> int:
    """Largest power-of-two-reduced block <= ``want`` that divides ``n``."""
    b = min(n, want)
    while n % b:
        b //= 2
    return max(b, 1)
