"""Named-axis cartesian process topology.

Port of ``deepspeed_tpu/parallel/topology.py`` (``ProcessTopology``,
``PipeDataParallelTopology``, ``PipeModelDataParallelTopology``,
``PipelineParallelGrid``; reference ``runtime/pipe/topology.py``): a rank
<-> coordinate bijection over a grid of named axes, first axis slowest, and
the rank groups along an axis. ``ProcessTopology`` is pure arithmetic:
``mesh.py`` turns its groups into process groups. ``PipelineParallelGrid``
is a rank's view of the pipeline (its stage, its neighbours' ranks) and,
after ``build_groups()``, holds the groups the pipeline engine talks over:
one for each pair of neighbouring stages and one for each set of stages
that share a tied layer (reference ``topology.py:251,274``).
"""

from collections import namedtuple
from itertools import product
from typing import Dict, List, Optional, Sequence


class ProcessTopology:
    """A cartesian grid of ranks with named axes (row-major, first axis slowest)."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have equal length")
        self.axes = list(axes)
        self.dims = [int(d) for d in dims]
        if any(d < 1 for d in self.dims):
            raise ValueError(f"axis dims must be >= 1, got {self.dims}")
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self._coord_to_rank: Dict[tuple, int] = {
            self.ProcessCoord(*coord): rank for rank, coord in enumerate(product(*[range(d) for d in self.dims]))}
        self._rank_to_coord = {r: c for c, r in self._coord_to_rank.items()}

    def get_rank(self, **coord_kwargs) -> int:
        if sorted(coord_kwargs) != sorted(self.axes):
            raise ValueError(f"get_rank() requires all axes {self.axes}, got {list(coord_kwargs)}")
        return self._coord_to_rank[self.ProcessCoord(**coord_kwargs)]

    def get_coord(self, rank: int):
        return self._rank_to_coord[rank]

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)] if axis in self.axes else 0

    def world_size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Every rank group that varies only along ``axis``, one per combination
        of the other axes (the groups the reference builds with ``new_group``)."""
        if axis not in self.axes:
            return []
        others = [a for a in self.axes if a != axis]
        return [[self.get_rank(**{axis: i, **dict(zip(others, combo))}) for i in range(self.get_dim(axis))]
                for combo in product(*[range(self.get_dim(a)) for a in others])]

    def get_axes_comm_lists(self, axes: Sequence[str]) -> List[List[int]]:
        """Every rank group that varies only along ``axes`` (together), one per
        combination of the other axes, ranks ascending."""
        axes = [a for a in axes if a in self.axes]
        others = [a for a in self.axes if a not in axes]
        return [sorted(r for r in range(self.world_size())
                       if all(getattr(self.get_coord(r), a) == v for a, v in zip(others, combo)))
                for combo in product(*[range(self.get_dim(a)) for a in others])]

    def filter_match(self, **filter_kwargs) -> List[int]:
        """Ranks whose coordinates match every given axis=value."""
        return [r for r in range(self.world_size())
                if all(getattr(self.get_coord(r), k) == v for k, v in filter_kwargs.items())]

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return self.filter_match(**{axis: idx})

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """pipe x data grid; data is innermost, so a data group is neighbouring ranks."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """pipe x data x model grid (model innermost, for the fastest collectives)."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """A rank's place in the pipeline: its stage, data and model ranks, and
    the world rank of any stage at its other coordinates. ``build_groups``
    (every rank, at the same point) makes the process groups of each pair of
    neighbouring stages and of each tied set of stages."""

    def __init__(self, topology: ProcessTopology, global_rank: int = 0):
        self._topo = topology
        self.global_rank = global_rank
        self.data_parallel_size = max(1, topology.get_dim("data"))
        self.pipe_parallel_size = max(1, topology.get_dim("pipe"))
        # the model axis: ``model`` in the reference's topologies, ``tensor`` in the mesh's
        self.model_parallel_size = max(1, topology.get_dim("model") or topology.get_dim("tensor") or 1)
        self.world_size = topology.world_size()
        coord = topology.get_coord(global_rank)
        self._coord = coord._asdict()
        self.stage_id = getattr(coord, "pipe", 0)
        self.data_parallel_id = getattr(coord, "data", 0)
        self.model_parallel_id = getattr(coord, "model", getattr(coord, "tensor", 0))
        self._pair_groups: Dict[int, object] = {}
        self._tied_groups: Dict[tuple, object] = {}

    def get_stage_id(self) -> int:
        return self.stage_id

    def get_data_parallel_id(self) -> int:
        return self.data_parallel_id

    def get_pipe_parallel_rank(self) -> int:
        return self.stage_id

    def get_data_parallel_rank(self) -> int:
        return self.data_parallel_id

    def get_model_parallel_rank(self) -> int:
        return self.model_parallel_id

    def get_global_rank_from_stage(self, stage_id: int, **other) -> int:
        """The world rank of ``stage_id`` at this rank's other coordinates (or those given)."""
        coord = dict(self._coord, **other)
        coord["pipe"] = stage_id
        return self._topo.get_rank(**coord)

    def stage_to_global(self, stage_id: int) -> int:
        return self.get_global_rank_from_stage(stage_id)

    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    def is_last_stage(self) -> bool:
        return self.stage_id == self.pipe_parallel_size - 1

    def _lines(self) -> List[List[int]]:
        """Every line of ranks along the pipe axis (stage order)."""
        return self._topo.get_axis_comm_lists("pipe") if "pipe" in self._topo.get_axis_names() \
            else [[r] for r in range(self.world_size)]

    def build_groups(self, tied_stages: Sequence[Sequence[int]] = ()) -> None:
        """The process groups of every pair of neighbouring stages and of every
        set in ``tied_stages`` (stage ids sharing a tied layer), on every
        line of the pipe axis, made in one order on every rank."""
        from .. import comm as dist

        for line in self._lines():
            for s in range(len(line) - 1):
                g = dist.new_group([line[s], line[s + 1]])
                if self.global_rank in (line[s], line[s + 1]):
                    self._pair_groups[s] = g
            for stages in tied_stages:
                stages = tuple(sorted(set(stages)))
                if len(stages) < 2:
                    continue
                ranks = [line[s] for s in stages]
                g = dist.new_group(ranks)
                if self.global_rank in ranks:
                    self._tied_groups[stages] = g

    def pair_group(self, lower_stage: int):
        """The group of stages ``lower_stage`` and ``lower_stage + 1`` on this rank's line."""
        return self._pair_groups[lower_stage]

    def tied_group(self, stages: Sequence[int]) -> Optional[object]:
        """The group of this rank's line over ``stages`` (None for a set of one)."""
        stages = tuple(sorted(set(stages)))
        return self._tied_groups.get(stages) if len(stages) > 1 else None
