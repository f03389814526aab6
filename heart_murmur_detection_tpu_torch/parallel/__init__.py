"""Data parallelism over torch.distributed (parallel/mesh.py) and the
launcher of its ranks (parallel/launch.py)."""

from .launch import launch
from .mesh import DataParallelMesh, DataParallelPlan, data_parallel_mesh, mesh_from_cli
