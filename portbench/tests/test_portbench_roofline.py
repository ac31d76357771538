"""The yardstick's counts on a tiny scene equal a hand count."""

import numpy as np
import torch

from portbench import roofline, scenes
from portbench.reference import raymarch, slicemarch


def _cube(n: int):
    data = torch.zeros((n, n, n))
    return scenes.Box(data, (0, 0, 0), 0, np.zeros(3), np.ones(3))


# eye 2 above the unit cube's top face, a 1 degree field of view: every
# ray of the buffer enters the top face and leaves by the bottom one
CAMERA = scenes.Camera((0.5, 0.5, 3.0), (0.5, 0.5, 0.5), (0.0, 1.0, 0.0), 1.0, 0.1, 20.0)


def test_slice_march_samples_by_hand():
    # two slices along z, each crossed by every ray of an 8 x 8 buffer
    # (4 x 4 pixels at 2 x 2 antialiasing): 64 rays x 2 samples
    pieces = [(b.data, b.min_corner, b.max_corner) for b in [_cube(2)]]
    count = slicemarch.count_samples(pieces, CAMERA, width=4, height=4, sqrt_aa=2, device="cpu")
    assert count == 64 * 2


def test_diff_march_samples_by_hand():
    # 4 cells an edge: a step of 0.125; each ray's 1.00008 inside the
    # box, less the 1.7e-4 start offset, holds 8 steps; 36 rays, 36 pairs
    bricks = raymarch.Bricks([_cube(4)], "cpu")
    samples, pairs = raymarch.valid_samples(bricks, CAMERA, 6, 6)
    assert (samples, pairs) == (36 * 8, 36)


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(67e12, 0.0) == 1.0
    assert roofline.bound_s(0.0, 3.35e12) == 1.0
    assert roofline.bound_s(67e12, 6.7e12) == 2.0
    assert roofline.share(1.0, 4.0) == 25.0 and roofline.share(1.0, 0.0) is None
    assert roofline.diff_sample_flops(False, False, False) == 114
    assert roofline.diff_sample_flops(True, False, False) == 118
