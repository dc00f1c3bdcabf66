"""Top-level ``deepspeed_tpu_torch.pipe``: the reference's ``deepspeed.pipe``
re-export shim (JAX ``deepspeed_tpu/pipe/__init__.py``): ``PipelineModule``,
``LayerSpec``, ``TiedLayerSpec`` plus the schedule taxonomy."""

from ..runtime.pipe import *  # noqa: F401,F403
from ..runtime.pipe import __all__  # noqa: F401
