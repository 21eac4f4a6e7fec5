"""Flat parameter codec and static partition groups."""

from .flat import flatten_params, leaf_offsets, param_shapes, total_size, unflatten_params
from .spec import Partition, Segment, build_partition

__all__ = [
    "Partition",
    "Segment",
    "build_partition",
    "flatten_params",
    "leaf_offsets",
    "param_shapes",
    "total_size",
    "unflatten_params",
]
