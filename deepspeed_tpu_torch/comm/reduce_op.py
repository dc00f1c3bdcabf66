"""Reduce ops (reference ``deepspeed/comm/reduce_op.py``), mapped onto
``torch.distributed.ReduceOp`` by ``comm.py``."""

from enum import Enum


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    BAND = 4
    BOR = 5
    BXOR = 6
    AVG = 7
    UNUSED = 8
