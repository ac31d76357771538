"""The yardstick's work counts for the differentiable path's pair-list
kernels, the ones with ``diffpairs_`` in their names: the build of a
view's (brick, pixel) pair list, and the fold of its rows forward and
backward.  Frozen here, from the work the algorithm needs, so that a later
change to the program cannot move the yardstick.

A view of B bricks at P pixels with N hit pairs (a pair whose ray meets
the brick's box):

* the build: the slab test of every hit pair, 17 operations (three
  axes' two products by the direction's reciprocal, the axis's minimum and
  maximum; two maxima and two minima across the axes; the hit compare),
  and its first distance, 2 (the nudge, the floor).  A build may test
  more pairs than hit (the program tests every (brick, pixel) pair, a
  cull by tiles fewer), but none tests fewer than hit, so the count stays
  a bound.  It reads each pixel's direction (12 B) and each box (its
  corners, nudge and rank: 40 B), and writes a pair's brick, pixel, first
  and last distance and fold slot (20 B) and a pixel's first slot and
  count (8 B);
* the fold forward: a pair's row clipped (8), its transmittance (1) and
  four FMAs (8): 17 a pair, and the image's clip, 8 a pixel; it reads a
  pair's slot and row and writes its transmittance (24 B), and reads a
  pixel's slots and writes its image and unclipped image (40 B);
* the fold backward: a pair's layer gradient (8), its clip's rule (16),
  the transmittance's gradient (7) and the row's clip (8): 40 a pair (the
  image clip's rule, 16 a pixel); it reads a pair's slot, transmittance
  and row and writes its row's gradient (40 B), and reads a pixel's
  gradient, unclipped image and slots (40 B).

Each launch is bound by the larger of its operations over the float32
peak and its bytes over HBM's bandwidth (``roofline.bound_s``); N comes
from the benchmark's own count (``reference/raymarch.py::valid_samples``),
never from the program.
"""

from __future__ import annotations

from . import roofline

SLAB_FLOPS = 17
FIRST_DISTANCE_FLOPS = 2
FOLD_PAIR_FLOPS = 17
FOLD_PIXEL_FLOPS = 8
FOLD_BACK_PAIR_FLOPS = 40
FOLD_BACK_PIXEL_FLOPS = 16


def view_bounds_s(bricks: int, pixels: int, pairs: int) -> dict:
    """The least time each pair-list launch of one view could take: the
    build, the fold forward and the fold backward, in s."""
    return {
        "build": roofline.bound_s((SLAB_FLOPS + FIRST_DISTANCE_FLOPS) * pairs,
                                  20 * pixels + 40 * bricks + 20 * pairs),
        "fold": roofline.bound_s(FOLD_PAIR_FLOPS * pairs + FOLD_PIXEL_FLOPS * pixels,
                                 24 * pairs + 40 * pixels),
        "fold_backward": roofline.bound_s(
            FOLD_BACK_PAIR_FLOPS * pairs + FOLD_BACK_PIXEL_FLOPS * pixels,
            40 * pairs + 40 * pixels),
    }


def view_bound_s(bricks: int, pixels: int, pairs: int) -> float:
    """A fitting step's pair-list bound for one view: build, fold forward
    and backward."""
    return sum(view_bounds_s(bricks, pixels, pairs).values())
