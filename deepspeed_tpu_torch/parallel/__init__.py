"""The mesh of the process world (``mesh.py``) and its coordinate maths (``topology.py``)."""

from .mesh import MeshTopology, get_mesh_topology, initialize_mesh, mesh_signature, reset_mesh, serving_mesh
from .topology import (PipeDataParallelTopology, PipeModelDataParallelTopology, PipelineParallelGrid,
                       ProcessTopology)

__all__ = ["MeshTopology", "ProcessTopology", "PipeDataParallelTopology", "PipeModelDataParallelTopology",
           "PipelineParallelGrid", "initialize_mesh", "get_mesh_topology", "reset_mesh",
           "serving_mesh", "mesh_signature"]
