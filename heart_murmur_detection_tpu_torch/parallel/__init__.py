"""Data and tensor parallelism over torch.distributed (parallel/mesh.py,
parallel/tensor.py) and the launcher of their ranks (parallel/launch.py)."""

from .launch import launch
from .mesh import (DataParallelMesh, DataParallelPlan, TensorParallelMesh, data_parallel_mesh,
                   mesh_2d, mesh_from_cli)
