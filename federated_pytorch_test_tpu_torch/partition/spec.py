"""Static partition specs over the flat parameter vector.

Counterpart of the JAX package's `partition/spec.py`: a `Partition` names,
per group, the `(start, size)` segments of the flat vector that one
federated round trains and exchanges (one layer of the simple CNNs).
`extract`/`insert` act on the last axis, so they serve one client `[N]`
and the stacked clients `[K, N]` alike.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from .flat import Shapes, leaf_offsets, total_size


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous [start, start+size) span of the flat parameter vector."""

    start: int
    size: int


@dataclasses.dataclass(frozen=True)
class Partition:
    """A static decomposition of the flat parameter vector into groups.

    groups: per-group tuple of `Segment`s (merged where contiguous).
    total: length of the flat vector.
    linear_group_ids: groups that carry the elastic-net penalty.
    train_order: default group visit order per outer loop.
    """

    groups: Tuple[Tuple[Segment, ...], ...]
    total: int
    linear_group_ids: Tuple[int, ...] = ()
    train_order: Tuple[int, ...] = ()

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def group_size(self, gid: int) -> int:
        return sum(s.size for s in self.groups[gid])

    def extract(self, flat: torch.Tensor, gid: int) -> torch.Tensor:
        """The group's coordinates of `flat [..., N]` (a view for one segment)."""
        parts = [flat[..., s.start : s.start + s.size] for s in self.groups[gid]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def insert(self, flat: torch.Tensor, gid: int, vec: torch.Tensor) -> torch.Tensor:
        """A copy of `flat` with the group's coordinates replaced by `vec`."""
        out = flat.clone()
        self.insert_(out, gid, vec)
        return out

    def insert_(self, flat: torch.Tensor, gid: int, vec: torch.Tensor) -> torch.Tensor:
        """In-place `insert`: the trainer owns its flat state and updates it
        in place rather than keeping two copies."""
        off = 0
        for s in self.groups[gid]:
            flat[..., s.start : s.start + s.size] = vec[..., off : off + s.size]
            off += s.size
        return flat

    def validate(self) -> None:
        """Check groups tile the flat vector exactly once (no overlap, no gap)."""
        spans = sorted((s.start, s.size) for segs in self.groups for s in segs)
        cursor = 0
        for start, size in spans:
            if start != cursor:
                raise ValueError(
                    f"partition groups do not tile flat vector: gap/overlap at {start} (expected {cursor})"
                )
            cursor += size
        if cursor != self.total:
            raise ValueError(f"partition covers {cursor} of {self.total} parameters")


def _merge_segments(spans: Sequence[Tuple[int, int]]) -> Tuple[Segment, ...]:
    merged = []
    for start, size in sorted(spans):
        if merged and merged[-1][0] + merged[-1][1] == start:
            merged[-1][1] += size
        else:
            merged.append([start, size])
    return tuple(Segment(s, n) for s, n in merged)


def build_partition(
    shapes: Shapes,
    group_paths: Sequence[Sequence[Tuple[str, ...]]],
    linear_group_ids: Sequence[int] = (),
    train_order: Sequence[int] = (),
) -> Partition:
    """Build a `Partition` from parameter shapes and per-group path prefixes.

    `group_paths[g]` lists path prefixes (tuples of name parts); every leaf
    whose path starts with one of them belongs to group `g`, and every leaf
    must belong to exactly one group.
    """
    offsets = leaf_offsets(shapes)
    groups = []
    claimed: Dict[Tuple[str, ...], int] = {}
    for g, prefixes in enumerate(group_paths):
        spans = []
        for path, start, size in offsets:
            if any(path[: len(p)] == tuple(p) for p in prefixes):
                if path in claimed:
                    raise ValueError(f"leaf {path} claimed by groups {claimed[path]} and {g}")
                claimed[path] = g
                spans.append((start, size))
        if not spans:
            raise ValueError(f"group {g} with prefixes {prefixes} matched no leaves")
        groups.append(_merge_segments(spans))
    unclaimed = [path for path, _, _ in offsets if path not in claimed]
    if unclaimed:
        raise ValueError(f"leaves not claimed by any group: {unclaimed}")
    part = Partition(
        groups=tuple(groups),
        total=total_size(shapes),
        linear_group_ids=tuple(linear_group_ids),
        train_order=tuple(train_order) if train_order else tuple(range(len(groups))),
    )
    part.validate()
    return part
