"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside this one is the reference. This package serves the
same models through the same v2 ragged engine (SplitFuse quanta over a
paged KV pool), with the Pallas kernels of that path rewritten by hand in
CUDA C++ for Hopper (``csrc/``). It imports ``torch`` and numpy only.

Entry points:
- ``deepspeed_tpu_torch.inference.v2``: ``InferenceEngineV2``,
  ``RaggedInferenceEngineConfig``, ``RaggedBatchConfig``;
- ``deepspeed_tpu_torch.models``: ``TransformerConfig``, the presets
  (``llama3_8b``, ...), ``init_params`` and ``params_from_numpy``.

Everything runs on the CUDA device unless the caller asks for the CPU
(``device="cpu"``), where each kernel wrapper takes its plain PyTorch
version.
"""

from .device import resolve_device
from .version import __version__

__all__ = ["resolve_device", "__version__"]
