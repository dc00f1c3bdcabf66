"""Parallel-group getters.

Port of ``deepspeed_tpu/utils/groups.py`` (reference ``utils/groups.py``
getters at ``:397-515``) for the axes the port runs: each getter asks the
current mesh (``parallel/mesh.py``) for the world size, the rank or the
process group along a parallel dimension. The data-parallel ranks are
``data`` x ``fsdp``; the ZeRO shards live on ``fsdp`` when it exceeds 1,
else on ``data``. The expert groups are the ranks along the mesh's
``expert`` axis (they see the same rows and hold different experts); the
expert-data group of a rank is the ranks that share its expert coordinate
(data x fsdp), over which its experts' gradients reduce. The tensor
(model-parallel) getters read the ``tensor`` axis, which tensor-parallel
serving and training run over. The pipe getters read the ``pipe`` axis (a rank's stage),
the sequence getters the ``seq`` axis (Ulysses) and the context getters the
``context`` axis (the ring); without a mesh each is 1 (rank 0). The
``*_axis`` getters name the mesh axis, as the JAX package's do.
"""

from ..parallel.mesh import get_mesh_topology, initialize_mesh, reset_mesh  # noqa: F401 (re-export)


def _topo():
    return get_mesh_topology(required=True)


def initialize(ep_size: int = 1, mpu=None):
    """Reference-compat entry (``groups.py:52``): the expert-parallel size is
    the mesh's ``expert`` axis, so this validates rather than builds (JAX
    ``utils/groups.py:20-25``). An ``mpu`` is accepted and unused, as in the
    JAX package: the mesh's ``tensor`` axis is the model-parallel group."""
    topo = get_mesh_topology(required=False)
    if topo is not None and ep_size not in (1, topo.expert_parallel_size):
        raise ValueError(f"ep_size {ep_size} conflicts with mesh expert axis {topo.expert_parallel_size}; set "
                         "mesh.expert in config")
    return topo


def get_data_parallel_world_size() -> int:
    return _topo().data_parallel_size


def get_data_parallel_rank() -> int:
    return _topo().data_parallel_rank


def get_data_parallel_group():
    """The data x fsdp ranks at this rank's expert coordinate (``None``, the
    default group, without expert parallelism)."""
    return _topo().process_group("expert_data")


def get_expert_parallel_world_size(group_name: str = "") -> int:
    return _topo().expert_parallel_size


def get_expert_parallel_rank(group_name: str = "") -> int:
    return _topo().axis_rank("expert")


def get_expert_parallel_group(group_name: str = ""):
    """The ranks along the ``expert`` axis that hold this rank (``get_axis_comm_lists("expert")``)."""
    return _topo().process_group("expert")


def get_expert_data_parallel_world_size(group_name: str = "") -> int:
    """The ranks that share this rank's experts: the world over the expert
    axis, data x fsdp (the reference's world // ep)."""
    return _topo().data_parallel_size


def get_expert_data_parallel_rank(group_name: str = "") -> int:
    return _topo().data_parallel_rank


def get_expert_data_parallel_group(group_name: str = ""):
    return _topo().process_group("expert_data")


def get_fsdp_world_size() -> int:
    return _topo().axis_size("fsdp")


def get_fsdp_rank() -> int:
    return _topo().axis_rank("fsdp")


def get_fsdp_group():
    return _topo().process_group("fsdp")


def get_zero_param_shard_size() -> int:
    return _topo().sharding_size


def get_tensor_model_parallel_world_size() -> int:
    """The ``tensor`` axis's size (1 without a mesh)."""
    topo = get_mesh_topology(required=False)
    return topo.model_parallel_size if topo is not None else 1


def get_tensor_model_parallel_rank() -> int:
    topo = get_mesh_topology(required=False)
    return topo.axis_rank("tensor") if topo is not None else 0


def get_tensor_model_parallel_group():
    """The ranks along the ``tensor`` axis that hold this rank (the axis must exceed 1)."""
    return _topo().process_group("tensor")


get_model_parallel_world_size = get_tensor_model_parallel_world_size
get_model_parallel_rank = get_tensor_model_parallel_rank
get_model_parallel_group = get_tensor_model_parallel_group


def _axis_size(axis: str) -> int:
    topo = get_mesh_topology(required=False)
    return topo.axis_size(axis) if topo is not None else 1


def _axis_rank(axis: str) -> int:
    topo = get_mesh_topology(required=False)
    return topo.axis_rank(axis) if topo is not None else 0


def get_sequence_parallel_world_size() -> int:
    """The ``seq`` axis's size (1 without a mesh)."""
    return _axis_size("seq")


def get_sequence_parallel_rank() -> int:
    """This rank's place along ``seq``: it holds tokens [r S / P, (r + 1) S / P) of each row."""
    return _axis_rank("seq")


def get_sequence_parallel_group():
    """The ranks along the ``seq`` axis that hold this rank (the axis must exceed 1)."""
    return _topo().process_group("seq")


def get_sequence_parallel_axis() -> str:
    return "seq"


def get_context_parallel_world_size() -> int:
    return _axis_size("context")


def get_context_parallel_rank() -> int:
    return _axis_rank("context")


def get_context_parallel_group():
    return _topo().process_group("context")


def get_context_parallel_axis() -> str:
    return "context"


def get_pipe_parallel_world_size() -> int:
    """The ``pipe`` axis's size: the number of stages (1 without a mesh)."""
    return _axis_size("pipe")


def get_pipe_parallel_rank() -> int:
    """This rank's stage."""
    return _axis_rank("pipe")


def get_pipe_parallel_group():
    """The ranks along the ``pipe`` axis that hold this rank: its pipeline's stages (the axis must exceed 1)."""
    return _topo().process_group("pipe")


def get_data_parallel_axis():
    return ("data", "fsdp")


def get_model_parallel_axis() -> str:
    return "tensor"


def get_expert_parallel_axis() -> str:
    return "expert"


def get_fsdp_axis() -> str:
    return "fsdp"
