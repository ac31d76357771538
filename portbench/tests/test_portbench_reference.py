"""The plain references render tiny seeded scenes, and agree with the
program run on the CPU at those sizes."""

import numpy as np
import pytest
import torch

from portbench import run, scenes
from portbench.reference import raymarch, slicemarch, transfer

from .small import small_cell


def test_transfer_table_ends():
    t = transfer.table(256, 0.0, 1.0)
    assert t.shape == (256, 4) and t.dtype == np.float32
    np.testing.assert_allclose(t[0], [0.0, 0.0, 0.5625, 0.05], atol=1e-7)
    np.testing.assert_allclose(t[-1], [0.5, 0.0, 0.0, 0.5], atol=1e-7)
    half = transfer.table(256, 0.0, 1.0, ratio=0.5)
    np.testing.assert_allclose(half[0, 3], 1 - (1 - 0.05) ** 0.5, rtol=1e-6)


def test_slice_march_renders_a_seeded_scene():
    scene = scenes.turbulence_scene({"domain": 16, "brick": 8}, 5, "cpu")
    rgba = transfer.table(256, 0.0, 1.0)
    cam = scenes.Orbit({"radius": 2.6, "height_above": 1.2, "per_rev": 36,
                        "fov_y_degrees": 45.0}, 5).camera(0)
    frame, samples = slicemarch.render(
        slicemarch.pieces_of(scene.boxes, lambda v: v), cam, width=24, height=24, sqrt_aa=2,
        lut_rgba=torch.from_numpy(rgba), log_t=torch.from_numpy(transfer.log_transmittance(rgba)),
        ref_distance=0.5 / 16, range_min=0.0, inv_range=1.0)
    assert frame.shape == (24 * 24, 4) and frame.dtype == torch.uint8
    covered = (frame[:, 3] > 0).float().mean()
    assert 0.05 < covered < 0.9 and samples > 0


def test_diff_reference_follows_autograd():
    scene = scenes.insitu_scene({"domain": 8, "brick": 4}, 3, "cpu")
    boxes = scene.boxes
    assert len(boxes) == 8
    bricks = raymarch.Bricks(boxes, "cpu")
    data = bricks.tensor([b.data for b in boxes]).requires_grad_(True)
    cam = scenes.fit_views({"views": 6, "radius": 2.5, "fov_y_degrees": 45.0}, 3)[0]
    image = raymarch.render_view(bricks, data, cam, 10, 10)
    image.sum().backward()
    assert image.shape == (100, 4) and float(image[:, 3].detach().max()) > 0
    assert float(data.grad.abs().sum()) > 0


@pytest.mark.parametrize("name", ["turb512.orbit", "insitu32.fit"])
def test_program_agrees_on_the_cpu(name):
    out, checks = run.run(name, 20260418, 0.5, False, device="cpu", cell_override=small_cell(name))
    assert out["correct"], checks
    assert out["attempted"] > 0 and out["failed"] == 0

