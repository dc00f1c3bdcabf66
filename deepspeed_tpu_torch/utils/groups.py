"""Parallel-group getters.

Port of ``deepspeed_tpu/utils/groups.py`` (reference ``utils/groups.py``
getters at ``:397-515``) for the axes the port runs: each getter asks the
current mesh (``parallel/mesh.py``) for the world size, the rank or the
process group along a parallel dimension. The data-parallel group is the
whole world (``data`` x ``fsdp``); the ZeRO shards live on ``fsdp`` when it
exceeds 1, else on ``data``. Tensor, pipe, expert, sequence and context
parallelism are 1 here.
"""

from ..parallel.mesh import get_mesh_topology, initialize_mesh, reset_mesh  # noqa: F401 (re-export)


def _topo():
    return get_mesh_topology(required=True)


def initialize(ep_size: int = 1, mpu=None):
    """Reference-compat entry (``groups.py:52``): validates rather than builds."""
    if ep_size != 1 or mpu is not None:
        raise NotImplementedError("expert parallelism and an mpu are not ported yet")
    return get_mesh_topology(required=False)


def get_data_parallel_world_size() -> int:
    return _topo().data_parallel_size


def get_data_parallel_rank() -> int:
    topo = _topo()
    return topo.axis_rank("data") * topo.axis_size("fsdp") + topo.axis_rank("fsdp")


def get_data_parallel_group():
    """The whole world (``None``, the default group): data x fsdp is every rank."""
    return None


def get_fsdp_world_size() -> int:
    return _topo().axis_size("fsdp")


def get_fsdp_rank() -> int:
    return _topo().axis_rank("fsdp")


def get_fsdp_group():
    return _topo().process_group("fsdp")


def get_zero_param_shard_size() -> int:
    return _topo().sharding_size


def get_model_parallel_world_size() -> int:
    return 1


get_tensor_model_parallel_world_size = get_model_parallel_world_size


def get_model_parallel_rank() -> int:
    return 0


get_tensor_model_parallel_rank = get_model_parallel_rank


def get_expert_parallel_world_size(group_name: str = "") -> int:
    return 1


def get_sequence_parallel_world_size() -> int:
    return 1


def get_pipe_parallel_world_size() -> int:
    return 1
