"""AMR hierarchy flattening: integer box arithmetic and ``convexify``.

The reference relies on ``amrex::convexify`` (VolumeRenderer.cpp:670,
VolumeRendererApi.cpp:97-98) to turn an overlapping AMR level hierarchy into
mutually exclusive boxes: every region is represented exactly once, by the
finest level that covers it (coarse boxes are chopped around fine coverage).
This module provides the same operation on host NumPy box lists.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .scene import LevelBox

IntVec = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class IndexBox:
    """Closed integer cell-index box [lo, hi] (amrex::Box equivalent)."""

    lo: IntVec
    hi: IntVec

    def valid(self) -> bool:
        return all(self.lo[d] <= self.hi[d] for d in range(3))

    def intersect(self, other: "IndexBox") -> "IndexBox":
        return IndexBox(
            tuple(max(self.lo[d], other.lo[d]) for d in range(3)),
            tuple(min(self.hi[d], other.hi[d]) for d in range(3)),
        )

    def shape(self) -> IntVec:
        return tuple(self.hi[d] - self.lo[d] + 1 for d in range(3))

    def coarsen(self, ratio: Sequence[int]) -> "IndexBox":
        """amrex::coarsen semantics: floor division of both corners."""

        def fdiv(v, r):
            return v // r  # Python floor division handles negatives correctly

        return IndexBox(
            tuple(fdiv(self.lo[d], ratio[d]) for d in range(3)),
            tuple(fdiv(self.hi[d], ratio[d]) for d in range(3)),
        )


def box_subtract(box: IndexBox, cut: IndexBox) -> List[IndexBox]:
    """``box`` minus ``box ∩ cut`` as a disjoint list of boxes (axis sweep)."""
    inter = box.intersect(cut)
    if not inter.valid():
        return [box]
    pieces: List[IndexBox] = []
    remaining = box
    for axis in range(3):
        lo = list(remaining.lo)
        hi = list(remaining.hi)
        if remaining.lo[axis] < inter.lo[axis]:
            below_hi = list(remaining.hi)
            below_hi[axis] = inter.lo[axis] - 1
            pieces.append(IndexBox(tuple(lo), tuple(below_hi)))
            lo[axis] = inter.lo[axis]
        if remaining.hi[axis] > inter.hi[axis]:
            above_lo = list(lo)
            above_lo[axis] = inter.hi[axis] + 1
            pieces.append(IndexBox(tuple(above_lo), tuple(hi)))
            hi[axis] = inter.hi[axis]
        remaining = IndexBox(tuple(lo), tuple(hi))
    return [p for p in pieces if p.valid()]


def box_list_subtract(boxes: List[IndexBox], cuts: Sequence[IndexBox]) -> List[IndexBox]:
    for cut in cuts:
        boxes = [piece for box in boxes for piece in box_subtract(box, cut)]
        if not boxes:
            break
    return boxes


def convexify(
    levels: Sequence[Sequence[LevelBox]],
    refinement_ratios: Sequence[Sequence[int]],
    materialize=np.ascontiguousarray,
) -> List[List[LevelBox]]:
    """Chop every coarse level's boxes around the next-finer level's
    coverage so levels tile space without overlap (``amrex::convexify``).

    ``refinement_ratios[l]`` is the (3,) ratio from level l to level l+1.
    Box data is cropped from the original arrays through ``materialize``
    (contiguous host copies by default; pass identity for device arrays —
    jnp slices stay lazy views until consumed on device).
    """
    num_levels = len(levels)
    out: List[List[LevelBox]] = [list(levels[-1])] if num_levels else []
    if num_levels == 0:
        return []
    out = [None] * num_levels  # type: ignore[list-item]
    out[num_levels - 1] = [
        LevelBox(materialize(b.data), np.asarray(b.lo)) for b in levels[-1]
    ]
    for level in range(num_levels - 2, -1, -1):
        ratio = refinement_ratios[level] if level < len(refinement_ratios) else (2, 2, 2)
        fine_coarsened = [
            IndexBox(
                tuple(int(v) for v in b.lo),
                tuple(int(b.lo[d] + b.data.shape[d] - 1) for d in range(3)),
            ).coarsen(ratio)
            for b in levels[level + 1]
        ]
        new_boxes: List[LevelBox] = []
        for box in levels[level]:
            region = IndexBox(
                tuple(int(v) for v in box.lo),
                tuple(int(box.lo[d] + box.data.shape[d] - 1) for d in range(3)),
            )
            pieces = box_list_subtract([region], fine_coarsened)
            for piece in pieces:
                offset = tuple(piece.lo[d] - region.lo[d] for d in range(3))
                shape = piece.shape()
                data = box.data[
                    offset[0] : offset[0] + shape[0],
                    offset[1] : offset[1] + shape[1],
                    offset[2] : offset[2] + shape[2],
                ]
                new_boxes.append(
                    LevelBox(materialize(data), np.asarray(piece.lo))
                )
        out[level] = new_boxes
    return out  # type: ignore[return-value]
