"""The mesh of the process world: axis sizes, a rank's coordinates and the
process groups along the axes.

Port of ``deepspeed_tpu/parallel/mesh.py``. The JAX package builds one
``jax.sharding.Mesh`` over its devices; here each rank is one process on one
device, the mesh is a ``ProcessTopology`` over the ranks of the default
process group, and an axis's "group" is a ``torch.distributed`` process
group of the ranks that differ only along it (the reference's
``utils/groups.py``). The axes and their order are the JAX package's:
``pipe, data, fsdp, expert, seq, context, tensor``, first slowest, so the
fsdp groups are runs of neighbouring ranks. Every axis may exceed 1.
``tensor`` is the axis of tensor parallelism, in serving (``serving_mesh``)
and in training (``parallel/tensor.py``); its ranks see the same rows, and
the data rank and size count ``data`` x ``fsdp`` only. ``pipe`` carries the pipeline's
stages, ``seq`` Ulysses' and ``context`` the ring's sequence slices. The
batch is split over ``data`` x ``fsdp`` only (JAX
``MeshTopology.batch_axes``): the ranks of an expert group, of a sequence
group and of a pipeline line see the same rows. Besides the axis groups
there is the ``expert_data`` group, the ranks that share this rank's expert
coordinate (data x fsdp), over which expert leaves reduce their gradients
and MoE layers gate their tokens; the ``dp_seq`` group (data x fsdp x seq x
context, when a sequence axis exceeds 1), the ranks that hold different
tokens of a step, over which the loss counts its tokens; and ZeRO++'s hpZ
groups (``hpz_group``), runs of k neighbouring fsdp ranks.
``mesh_signature`` names a mesh in step keys and journal fingerprints as the
JAX package does.
"""

from typing import Dict, Optional

from .. import comm as dist
from ..runtime.config import MESH_AXES, MeshConfig
from .topology import ProcessTopology

ALL_AXES = MESH_AXES
PORTED_AXES = ("pipe", "data", "fsdp", "expert", "seq", "context", "tensor")
BATCH_AXES = ("data", "fsdp")
SEQ_AXES = ("seq", "context")
ALWAYS_GROUPED = ("data", "fsdp", "expert")  # the other axes have groups only above size 1


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
        self._hpz: Dict[int, object] = {}

    def axis_size(self, axis: str) -> int:
        return self.axis_sizes.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        return getattr(self.coord, axis)

    @property
    def data_parallel_size(self) -> int:
        # ZeRO's shards live on fsdp, but every fsdp rank still sees its own rows of the batch
        return self.axis_size("data") * self.axis_size("fsdp")

    @property
    def data_parallel_rank(self) -> int:
        """This rank's place among the ranks that split the batch (data x fsdp)."""
        return self.axis_rank("data") * self.axis_size("fsdp") + self.axis_rank("fsdp")

    @property
    def sharding_size(self) -> int:
        return self.axis_size("fsdp")

    @property
    def expert_parallel_size(self) -> int:
        return self.axis_size("expert")

    @property
    def model_parallel_size(self) -> int:
        """The ``tensor`` axis: the tensor-parallel degree."""
        return self.axis_size("tensor")

    @property
    def pipe_parallel_size(self) -> int:
        return self.axis_size("pipe")

    @property
    def sequence_parallel_size(self) -> int:
        """Ulysses' degree: the ``seq`` axis."""
        return self.axis_size("seq")

    @property
    def context_parallel_size(self) -> int:
        """The ring's degree: the ``context`` axis."""
        return self.axis_size("context")

    def _comm_lists(self, name: str):
        if name == "expert_data":
            return self.topology.get_axes_comm_lists(BATCH_AXES)
        if name == "dp_seq":
            return self.topology.get_axes_comm_lists(BATCH_AXES + SEQ_AXES)
        return self.topology.get_axis_comm_lists(name)

    def process_group(self, axis: str):
        """The process group of this rank's ranks along ``axis`` (a mesh axis;
        ``expert_data``: data x fsdp at this rank's expert coordinate;
        ``dp_seq``: data x fsdp x seq x context); ``None``, the default group,
        when that is the whole world. ``data``, ``fsdp``, ``expert`` and
        ``expert_data`` always have groups; ``pipe``, ``seq``, ``context`` and
        ``tensor`` only when the axis exceeds 1, ``dp_seq`` only when ``seq``
        or ``context`` does (every rank knows the sizes, so all agree)."""
        if self._groups is None:
            groups = {}
            names = [a for a in PORTED_AXES if a in ALWAYS_GROUPED or self.axis_size(a) > 1] + ["expert_data"]
            if any(self.axis_size(a) > 1 for a in SEQ_AXES):
                names.append("dp_seq")
            for a in names:  # every rank creates every group, in this order
                for ranks in self._comm_lists(a):
                    g = None if len(ranks) == self.n_devices else dist.new_group(ranks)
                    if self.rank in ranks:
                        groups[a] = g
            self._groups = groups
        if axis not in self._groups:  # an axis of size 1 without a group: this rank alone
            raise ValueError(f"no {axis!r} group: the axis has size {self.axis_size(axis)}")
        return self._groups[axis]

    def hpz_group(self, k: int):
        """ZeRO++ hpZ's secondary group: the ``k`` neighbouring fsdp ranks
        that hold this rank (JAX ``zeropp._hpz_groups``); the fsdp group when
        ``k`` is the fsdp size. Every rank must call it, with the same ``k``."""
        fsdp = self.axis_size("fsdp")
        if k < 1 or fsdp % k:
            raise ValueError(f"zero_hpz_partition_size {k} must divide the fsdp axis size {fsdp}")
        if k == fsdp:
            return self.process_group("fsdp")
        if k not in self._hpz:
            mine = None
            for ranks in self.topology.get_axis_comm_lists("fsdp"):
                for i in range(0, fsdp, k):
                    g = dist.new_group(ranks[i:i + k])
                    if self.rank in ranks[i:i + k]:
                        mine = g
            self._hpz[k] = mine
        return self._hpz[k]

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


def serving_mesh(tp: int = 1) -> MeshTopology:
    """The serving mesh (JAX ``parallel/mesh.py:169``): ``tensor=tp`` with every
    other rank of the world on ``data``. Each rank is one process: a tp = 2
    engine runs in a world of (a multiple of) 2 ranks."""
    return initialize_mesh(MeshConfig.from_dict({"data": -1, "tensor": int(tp)}))


def mesh_signature(topo: Optional[MeshTopology] = None) -> str:
    """Compact topology identity for step keys and journal fingerprints (JAX
    ``parallel/mesh.py:179``): the axes above 1 in mesh order
    (``mesh[tensor2]``), ``mesh[1]`` for a trivial mesh, ``mesh[none]`` with
    no mesh."""
    topo = topo if topo is not None else _TOPOLOGY
    if topo is None:
        return "mesh[none]"
    axes = ",".join(f"{a}{topo.axis_sizes[a]}" for a in topo.axis_order if topo.axis_sizes[a] > 1)
    return f"mesh[{axes or '1'}]"


def get_mesh_topology(required: bool = True) -> Optional[MeshTopology]:
    if _TOPOLOGY is None and required:
        raise RuntimeError("Mesh not initialized: call deepspeed_tpu_torch.initialize() or initialize_mesh() first")
    return _TOPOLOGY


def reset_mesh() -> None:
    global _TOPOLOGY
    _TOPOLOGY = None
