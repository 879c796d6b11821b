"""Data parallelism over ``torch.distributed`` (port of
``theanet_tpu/parallel``): ``make_mesh`` and the rank launcher."""

from .launch import launch
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "launch"]
