"""The mesh of the process world: axis sizes, a rank's coordinates and the
process groups along the axes.

Port of ``deepspeed_tpu/parallel/mesh.py``. The JAX package builds one
``jax.sharding.Mesh`` over its devices; here each rank is one process on one
device, the mesh is a ``ProcessTopology`` over the ranks of the default
process group, and an axis's "group" is a ``torch.distributed`` process
group of the ranks that differ only along it (the reference's
``utils/groups.py``). The axes and their order are the JAX package's:
``pipe, data, fsdp, expert, seq, context, tensor``, first slowest, so the
fsdp groups are runs of neighbouring ranks. ``data`` and ``fsdp`` may exceed
1; the other axes above 1 raise ``NotImplementedError``.
"""

from typing import Dict, Optional

from .. import comm as dist
from ..runtime.config import MESH_AXES, MeshConfig
from .topology import ProcessTopology

ALL_AXES = MESH_AXES
PORTED_AXES = ("data", "fsdp")


def _resolve_axis_sizes(cfg: MeshConfig, world_size: int) -> Dict[str, int]:
    sizes = {a: int(getattr(cfg, a)) for a in ALL_AXES}
    wildcard = [a for a, s in sizes.items() if s == -1]
    if len(wildcard) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {wildcard}")
    fixed = 1
    for a, s in sizes.items():
        if s != -1:
            if s < 1:
                raise ValueError(f"Mesh axis {a} must be >=1 or -1, got {s}")
            fixed *= s
    if wildcard:
        if world_size % fixed != 0:
            raise ValueError(f"world size {world_size} not divisible by the fixed mesh axes' product {fixed}")
        sizes[wildcard[0]] = world_size // fixed
    elif fixed != world_size:
        raise ValueError(f"Mesh axes product {fixed} != world size {world_size}: each rank is one process on one "
                         "device, so the mesh must cover exactly the process world")
    big = {a: s for a, s in sizes.items() if a not in PORTED_AXES and s > 1}
    if big:
        raise NotImplementedError(f"mesh axes {big}: the port runs the data and fsdp axes only")
    return sizes


class MeshTopology:
    """The mesh over ``world_size`` ranks (default: the default process
    group's), seen from ``rank``. Axis sizes, coordinates and rank lists are
    pure arithmetic; ``process_group(axis)`` builds every axis group on the
    first call, which every rank must make at the same point."""

    def __init__(self, config: Optional[MeshConfig] = None, world_size: Optional[int] = None,
                 rank: Optional[int] = None):
        self.config = config or MeshConfig()
        self.n_devices = dist.get_world_size() if world_size is None else int(world_size)
        self.rank = dist.get_rank() if rank is None else int(rank)
        self.axis_sizes = _resolve_axis_sizes(self.config, self.n_devices)
        order = list(self.config.axis_order)
        if sorted(order) != sorted(ALL_AXES):
            raise ValueError(f"axis_order must be a permutation of {ALL_AXES}, got {order}")
        self.axis_order = order
        self.topology = ProcessTopology(order, [self.axis_sizes[a] for a in order])
        self.coord = self.topology.get_coord(self.rank)
        self._groups: Optional[Dict[str, object]] = None

    def axis_size(self, axis: str) -> int:
        return self.axis_sizes.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        return getattr(self.coord, axis)

    @property
    def data_parallel_size(self) -> int:
        # ZeRO's shards live on fsdp, but every fsdp rank still sees its own rows of the batch
        return self.axis_size("data") * self.axis_size("fsdp")

    @property
    def sharding_size(self) -> int:
        return self.axis_size("fsdp")

    def process_group(self, axis: str):
        """The process group of this rank's ranks along ``axis`` (``None``, the
        default group, when that is the whole world)."""
        if self._groups is None:
            groups = {}
            for a in PORTED_AXES:  # every rank creates every group, in this order
                for ranks in self.topology.get_axis_comm_lists(a):
                    g = None if len(ranks) == self.n_devices else dist.new_group(ranks)
                    if self.rank in ranks:
                        groups[a] = g
            self._groups = groups
        return self._groups[axis]

    def __repr__(self):
        return f"MeshTopology({self.axis_sizes}, rank={self.rank})"


_TOPOLOGY: Optional[MeshTopology] = None


def initialize_mesh(config: Optional[MeshConfig] = None, force: bool = False) -> MeshTopology:
    """The mesh over the process world (reference ``groups.initialize``),
    rebuilt when the requested sizes differ from the current mesh's."""
    global _TOPOLOGY
    if _TOPOLOGY is not None and not force and config is not None:
        force = _resolve_axis_sizes(config, dist.get_world_size()) != _TOPOLOGY.axis_sizes
    if _TOPOLOGY is None or force:
        _TOPOLOGY = MeshTopology(config)
    return _TOPOLOGY


def get_mesh_topology(required: bool = True) -> Optional[MeshTopology]:
    if _TOPOLOGY is None and required:
        raise RuntimeError("Mesh not initialized: call deepspeed_tpu_torch.initialize() or initialize_mesh() first")
    return _TOPOLOGY


def reset_mesh() -> None:
    global _TOPOLOGY
    _TOPOLOGY = None
