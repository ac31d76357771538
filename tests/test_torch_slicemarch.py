"""The port's work-list slice march (amrvolumerenderer_torch/ops/
slicemarch.py) against the JAX package's Pallas kernels in interpret mode.

The plain version must match ``slicemarch_render_worklist_raw`` on every
scheduled (piece, tile) block, and the masked, untiled entry must match
``slicemarch_render_worklist`` everywhere, at the manifest's atol of 2e-6
with the same non-finite pattern (measured: bit for bit).  Inputs come from
the JAX package's own host prep (``prepare_slicemarch_scene``) on the
golden r^2 scene and bench.py's 3-level scene: nearest, trilinear/post,
trilinear/pre, an eye inside the domain, and 48x48 frames padded to 64x64.
The host helpers (piece split, slice pack, slice bounds, untile) return
arrays equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu.camera import auto_orbit_camera
from amrvolumerenderer_tpu.ops import slicemarch as jsm
from amrvolumerenderer_tpu.renderer import (
    compute_global_bounds,
    compute_global_scalar_range,
    compute_reference_sample_distance,
)
from amrvolumerenderer_tpu.renderer_fast import prepare_slicemarch_scene
from amrvolumerenderer_tpu.types import CameraParameters, RenderParameters
from amrvolumerenderer_torch.ops import slicemarch as sm

from tests.conftest import make_r2_scene_data
from test_torch_worklist import one_torch_thread, three_level_geometry  # noqa: F401

ATOL = 2e-6
KEYS = ("vol", "meta", "dims", "luts", "cam", "wb", "wt")
OBLIQUE = CameraParameters(eye=(-1.9, 2.3, -1.2), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
INSIDE = CameraParameters(eye=(0.4, 0.45, 0.5), look_at=(0.9, 0.5, 0.5),
                          up=(0, 1, 0))
# (scene, (sampling, classification, lut_size), camera, width x height):
# the golden scene and view at 48x48 (a 64x64 padded frame) for every knob
# set; the 3-level scene from an oblique view and from inside the domain
CASES = [
    ("r2", ("nearest", "post", 256), None, 48),
    ("r2", ("trilinear", "post", 256), None, 48),
    ("r2", ("trilinear", "pre", 128), None, 48),
    ("3lvl", ("nearest", "post", 256), OBLIQUE, 64),
    ("3lvl", ("trilinear", "pre", 128), OBLIQUE, 48),
    ("3lvl", ("trilinear", "post", 256), INSIDE, 64),
]


@pytest.fixture(scope="module")
def geometries():
    levels, geoms = make_r2_scene_data(16, 8)
    return {
        "r2": jax_api.load_amr_geometry(
            jax_api.AmrData(level_data=levels, level_geometry=geoms),
            0, -1, 0, False, True, verbose=False,
        ),
        "3lvl": three_level_geometry(),
    }


def jax_prep(geometry, knobs, camera, size):
    """The JAX package's slice-march inputs for one frame, and the kernel
    keywords."""
    sampling, classification, lut_size = knobs
    params = RenderParameters(width=size, height=size, sampling=sampling,
                              classification=classification, lut_size=lut_size)
    bounds = compute_global_bounds(geometry)
    camera = camera or auto_orbit_camera(bounds)
    prep = prepare_slicemarch_scene(
        geometry, params, camera, compute_global_scalar_range(geometry),
        compute_reference_sample_distance(geometry, bounds), size, size, None)
    kw = dict(width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
              logical_width=size, logical_height=size, sampling=sampling,
              ghost=prep["ghost"], classification=classification)
    return prep, kw


def assert_matches(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=ATOL)


def torch_args(prep):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return [t(prep[k]) for k in KEYS], t(prep["wbounds"]), t(prep["coverage"])


@pytest.mark.parametrize(
    "scene,knobs,camera,size", CASES,
    ids=[f"{c[0]}-{'-'.join(map(str, c[1]))}-{'auto' if c[2] is None else 'inside' if c[2] is INSIDE else 'oblique'}-{c[3]}"
         for c in CASES],
)
def test_raw_matches_jax_kernel_on_covered_blocks(geometries, scene, knobs,
                                                  camera, size):
    prep, kw = jax_prep(geometries[scene], knobs, camera, size)
    rc, rd = jsm.slicemarch_render_worklist_raw(
        *(jnp.asarray(prep[k]) for k in KEYS), jnp.asarray(prep["wbounds"]),
        interpret=True, **kw)
    args, bounds, _ = torch_args(prep)
    gc, gd = sm.slicemarch_render_worklist_raw(*args, bounds, **kw)
    cov = prep["coverage"]
    rc, rd = np.asarray(rc)[cov], np.asarray(rd)[cov]
    assert (rc[:, 3] > 0).mean() > 0.02  # premise: a real frame
    assert_matches(gc.numpy()[cov], rc)
    assert_matches(gd.numpy()[cov], rd)


@pytest.mark.parametrize("knobs", [("nearest", "post", 256),
                                   ("trilinear", "pre", 128)])
def test_masked_matches_jax_kernel(geometries, knobs):
    """The coverage-masked, untiled entry (the layered path) everywhere."""
    prep, kw = jax_prep(geometries["3lvl"], knobs, OBLIQUE, 48)
    rc, rd = jsm.slicemarch_render_worklist(
        *(jnp.asarray(prep[k]) for k in KEYS), jnp.asarray(prep["coverage"]),
        jnp.asarray(prep["wbounds"]), interpret=True, **kw)
    args, bounds, cov = torch_args(prep)
    gc, gd = sm.slicemarch_render_worklist(*args, cov, bounds, **kw)
    assert_matches(gc.numpy(), rc)
    assert_matches(gd.numpy(), rd)


def test_default_bounds_come_from_dims(geometries):
    """Without per-item bounds each item marches its piece's dims[:, 7]."""
    prep, kw = jax_prep(geometries["r2"], ("nearest", "post", 256), None, 48)
    args, _, _ = torch_args(prep)
    gc, gd = sm.slicemarch_render_worklist_raw(*args, **kw)
    rc, rd = jsm.slicemarch_render_worklist_raw(
        *(jnp.asarray(prep[k]) for k in KEYS), interpret=True, **kw)
    cov = prep["coverage"]
    assert_matches(gc.numpy()[cov], np.asarray(rc)[cov])
    assert_matches(gd.numpy()[cov], np.asarray(rd)[cov])


@pytest.mark.parametrize("ghost", [0, 1])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_split_pack_and_bounds_match_jax(axis, ghost):
    rng = np.random.default_rng(11 + axis)
    data = rng.uniform(0.0, 1.0, (40, 36, 44)).astype(np.float32)
    data[:, :4] = 0.0  # empty slices at one end of axis 1
    mn, mx = np.array([0.1, 0.2, 0.3]), np.array([0.5, 0.56, 0.74])
    padded = np.pad(data, ghost, mode="reflect") if ghost else None
    got = sm.split_brick_for_slices(data, mn, mx, axis, ghost=ghost, padded=padded)
    want = jsm.split_brick_for_slices(data, mn, mx, axis, ghost=ghost, padded=padded)
    assert len(got) == len(want) > 1
    lut_alpha = np.where(np.arange(256) > 100, 0.3, 0.0)
    for (gd, gmn, gmx), (wd, wmn, wmx) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gmn, wmn)
        np.testing.assert_array_equal(gmx, wmx)
        gv, gdims = sm.pack_slice_volume(gd, axis, ghost=ghost)
        wv, wdims = jsm.pack_slice_volume(wd, axis, ghost=ghost)
        np.testing.assert_array_equal(gv, wv)
        assert gdims == wdims
        for lo, inv in ((0.0, 1.0), (0.2, 2.5)):
            assert (sm.compute_slice_bounds(gv, lut_alpha, lo, inv)
                    == jsm.compute_slice_bounds(wv, lut_alpha, lo, inv))
    empty = np.zeros((6, 8, 128), np.float32)
    assert sm.compute_slice_bounds(empty, lut_alpha) == (6 << 16) | 6


def test_untile_matches_jax():
    rng = np.random.default_rng(2)
    colors = rng.standard_normal((3, 6, 4, 8, 128)).astype(np.float32)
    depths = rng.standard_normal((3, 6, 8, 128)).astype(np.float32)
    got = sm.untile(torch.from_numpy(colors), torch.from_numpy(depths), 96, 64)
    want = jsm.untile(jnp.asarray(colors), jnp.asarray(depths), 96, 64, 32, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_checks_device_and_args():
    vol = torch.zeros((1, 32, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sm.slicemarch_render_worklist_raw(vol, *([vol] * 6), width=32, height=32,
                                          max_slices=32)
    with pytest.raises(ValueError, match="unknown sampling"):
        sm.slicemarch_reference(*([torch.zeros(1)] * 7), width=32, height=32,
                                max_slices=32, sampling="cubic")
