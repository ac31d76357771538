"""The yardstick's peaks and work counts.

Peaks: NVIDIA's data sheet for one H100 SXM at its full 700 W (dense,
without sparsity): 67 TFLOP/s in float32 outside the tensor cores and
3.35 TB/s of HBM bandwidth.  A run reports the card's power limit beside
every share it computes (``device_power_limit``).

Operations a sample, counted by hand from the kernels' loop bodies (an FMA
counts 2, a compare 1), frozen here so that a later change to the program
cannot move the yardstick:

* the slice march, nearest sampling, post-classification: 63 (window
  weight, position, cell index, LUT classification, the exponential and
  the fold); trilinear post 88, trilinear pre 118;
* the differentiable march's forward: 114 (distance, position and gate
  16; per axis the cell coordinate, clips, floor and weight 36; seven
  lerps 28; the finite test 1; the range, LUT coordinate and weight 11;
  the LUT lerp 13; the over step 9), +4 with the normalisation, +30 with
  the log transform, +13 with the soft tail;
* its backward: one forward sample and 178 for the adjoint (over step
  15, LUT lerp 18, LUT weight 12, clips and scalars 24, trilinear weights
  and corners 52, cell coordinates and position 54, distance 3).

Samples are those the rays need: a slice whose half-cell window overlaps
the ray's stretch inside a brick (slice march), a step inside the box and
short of its exit (differentiable march).  Bytes: every input read once
and every output written once per launch.
"""

from __future__ import annotations

import subprocess
from typing import Optional

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

SLICE_SAMPLE_FLOPS = {("nearest", "post"): 63, ("trilinear", "post"): 88,
                      ("trilinear", "pre"): 118}
DIFF_FORWARD_FLOPS = 114
DIFF_ADJOINT_FLOPS = 178


def diff_sample_flops(normalize: bool, log_scale: bool, soft_tail: bool) -> int:
    return (DIFF_FORWARD_FLOPS + (4 if normalize else 0) + (30 if log_scale else 0)
            + (13 if soft_tail else 0))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the HBM bandwidth."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)


def share(bound: float, seconds: float) -> Optional[float]:
    """``bound / seconds`` in percent; None when nothing was timed."""
    if not seconds or seconds <= 0.0:
        return None
    return 100.0 * bound / seconds


def peak_percent(flops: float, seconds: float) -> Optional[float]:
    """``flops`` over ``seconds`` as a share of the float32 peak, %."""
    if not flops or seconds <= 0.0:
        return None
    return 100.0 * flops / F32_FLOPS / seconds


def device_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
