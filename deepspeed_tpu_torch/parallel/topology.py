"""Named-axis cartesian process topology.

Port of ``deepspeed_tpu/parallel/topology.py`` (``ProcessTopology``;
reference ``runtime/pipe/topology.py``): a rank <-> coordinate bijection
over a grid of named axes, first axis slowest, and the rank groups along an
axis. Pure arithmetic, no communication: ``mesh.py`` turns the groups into
process groups.
"""

from collections import namedtuple
from itertools import product
from typing import Dict, List, Sequence


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
