"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside this one is the reference. This package serves the
same models through the v1 engine (a dense KV cache) and the same v2 ragged
engine (SplitFuse quanta over a paged KV pool) and trains them with the same ``DeepSpeedEngine`` contract,
with the Pallas kernels of those paths rewritten by hand in CUDA C++ for
Hopper (``csrc/``). It imports ``torch`` and numpy only.

Entry points:
- ``deepspeed_tpu_torch.initialize``: the training engine
  (``runtime/engine.py``), returning (engine, optimizer, loader, scheduler):
  data parallelism and ZeRO stages 0-3 over ``torch.distributed``
  (``comm``, ``parallel``, ``runtime/zero``, the top-level ``zero``), with
  native and universal checkpoints and ``zero_to_fp32`` (``checkpoint``);
  the pipeline engine for a ``pipe.PipelineModule`` or ``mesh.pipe`` > 1
  (``runtime/pipe``: 1F1B and GPipe), and sequence parallelism over
  ``mesh.seq`` (Ulysses) or ``mesh.context`` (ring attention, ``sequence``);
- ``deepspeed_tpu_torch.init_inference``: the v1 ``InferenceEngine``
  (``inference/engine.py``: ``generate`` over a dense KV cache, ``forward``),
  with optional flat weight-only quantisation, at ``tp_size`` > 1 over as
  many ranks;
- ``deepspeed_tpu_torch.inference.v2``: ``InferenceEngineV2``,
  ``RaggedInferenceEngineConfig``, ``RaggedBatchConfig``; tensor-parallel
  serving (``tensor_parallel``) one process a rank over the mesh's
  ``tensor`` axis (``module_inject`` shards the tree);
- ``deepspeed_tpu_torch.models``: ``TransformerConfig``, the presets
  (``llama3_8b``, ``gpt2_1_3b``, ...), ``CausalLM``, ``init_params`` and
  ``params_from_numpy`` (MoE blocks through ``moe_num_experts``);
- ``deepspeed_tpu_torch.moe``: the MoE gates, the ``MoE`` layer (expert
  parallelism in the training engine) and the expert-TP token mappings.

Everything runs on the CUDA device unless the caller asks for the CPU
(``device="cpu"``), where each kernel wrapper takes its plain PyTorch
version.
"""

from .device import resolve_device
from .inference.engine import InferenceEngine, init_inference
from .runtime.engine import DeepSpeedEngine, initialize
from .version import __version__

__all__ = ["DeepSpeedEngine", "InferenceEngine", "init_inference", "initialize", "resolve_device", "__version__"]
