"""Data parallelism and row-sharded grid tables over torch.distributed
(``tcnn_tpu/parallel/``)."""

from .mesh import DataParallel, make_mesh
from .table_parallel import HybridParallel, make_hybrid_mesh

__all__ = ["DataParallel", "make_mesh", "HybridParallel", "make_hybrid_mesh"]
