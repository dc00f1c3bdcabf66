"""Top-level ``deepspeed_tpu_torch.zero``: the reference's ``deepspeed.zero``
(``zero.Init``, MiCS, the memory-needs estimators, the planners),
re-exported from ``runtime/zero``."""

from ..runtime.zero import *  # noqa: F401,F403
from ..runtime.zero import __all__  # noqa: F401
