"""MiCS: ZeRO-3 sharded within groups of ranks and replicated across them.

Port of ``deepspeed_tpu/runtime/zero/mics.py`` (reference ``mics.py``):
MiCS's layout is the mesh ``{data: replica groups, fsdp: shard group size}``
with stage 3, which the engine runs: each block is gathered over its fsdp
group only, and the ``data`` groups all-reduce the chunks' gradients.
``zero_optimization.mics_shard_size = k`` sizes that mesh (``DeepSpeedConfig``
sets ``mesh.fsdp = k`` unless the mesh names ``fsdp``), and the engine
checks the mesh against it (``validate_mics_mesh``, as the JAX engine at
``engine.py:111-113``). ``mics_hierarchical_params_gather`` is read and
ignored, as in the JAX package. ``MiCS_Init`` is ``zero.Init`` under such a
mesh.
"""

from .init import Init


class MiCS_Init(Init):
    """Sharded construction under a MiCS mesh (reference ``mics.py:64``)."""


def validate_mics_mesh(config, topo) -> None:
    k = config.zero_config.mics_shard_size
    if k and k > 0:
        fsdp = topo.axis_size("fsdp")
        if fsdp != k:
            raise ValueError(f"mics_shard_size={k} but the mesh fsdp axis is {fsdp}; either drop the explicit mesh "
                             "fsdp setting (MiCS will size it) or make them equal")
