"""The port's FastSceneRenderer (and its state, ghost, downsample and byte
helpers) against the golden rows and the JAX package's renderer.

Tolerance: atol 2e-6 on RGBA and finite depth with the same non-finite
depth pattern (the golden manifest's); host-side tables must be equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer as JaxFSR
from amrvolumerenderer_tpu.fast_scene import _repack_for_axis as jax_repack
from amrvolumerenderer_tpu.ghost import ghost_fill as jax_ghost_fill
from amrvolumerenderer_tpu import image as jax_image
from amrvolumerenderer_tpu.image import color_to_byte_device as jax_to_byte
from amrvolumerenderer_tpu.renderer import downsample_image as jax_downsample_image
from amrvolumerenderer_tpu.renderer_fast import _device_downsample as jax_down
from amrvolumerenderer_tpu.renderer_fast import _pretransform as jax_pretransform
from amrvolumerenderer_torch import api
from amrvolumerenderer_torch.camera import auto_orbit_camera
from amrvolumerenderer_torch.fast_scene import FastSceneRenderer, _repack_for_axis
from amrvolumerenderer_torch.ghost import ghost_fill
from amrvolumerenderer_torch.image import ImageBuffer, ImageKind, color_to_byte_device
from amrvolumerenderer_torch.ops import numerics
from amrvolumerenderer_torch.renderer import downsample_image
from amrvolumerenderer_torch.renderer_fast import _device_downsample, _pretransform
from amrvolumerenderer_torch.state import (
    geometry_from,
    renderer_from_state,
    state_from_renderer,
)
from amrvolumerenderer_torch.types import (
    CameraParameters,
    RenderParameters,
    color_map_from_tuples,
)

from tests.conftest import make_r2_scene_data
from test_torch_worklist import (  # noqa: F401
    as_jax,
    one_torch_thread,
    port_levels,
    three_level_geometry,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "manifest_pixels.npz")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def r2_geometry():
    """The golden scene through the port's own ingestion."""
    levels, geoms = port_levels(*make_r2_scene_data(16, 8))
    return api.load_amr_geometry(
        api.AmrData(level_data=levels, level_geometry=geoms),
        0, -1, 0, False, True, verbose=False,
    )


@pytest.fixture(scope="module")
def geometry3():
    """bench.py's 3-level scene: (the JAX package's geometry, the port's
    own copy of it)."""
    geometry = three_level_geometry()
    return geometry, geometry_from(geometry)


def assert_pixels_close(got, ref, atol=2e-6):
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=atol)


@pytest.mark.parametrize("row", ["tilemarch-1dev", "slicemarch-1dev"])
def test_golden_rows(r2_geometry, row):
    """The port's single-device frame reproduces both golden rows, under
    the rsqrt model the rows were rendered with."""
    fsr = FastSceneRenderer(r2_geometry, RenderParameters(width=48, height=48),
                            device=CPU)
    with numerics.seed_rsqrt():
        pixels = fsr.render(auto_orbit_camera(fsr.bounds), overlay=True)
    assert_pixels_close(pixels, np.load(GOLDEN)[row])


@pytest.mark.parametrize("knobs", [("nearest", "post", 256),
                                   ("trilinear", "pre", 128)])
def test_matches_jax_renderer_with_antialiasing(geometry3, knobs):
    """3-level scene at 64x64 with antialiasing=4 (128x128 rendered, box
    filtered on the device), overlay included."""
    sampling, classification, lut_size = knobs
    params = RenderParameters(width=64, height=64, antialiasing=4,
                              sampling=sampling, classification=classification,
                              lut_size=lut_size)
    port = FastSceneRenderer(geometry3[1], params, device=CPU)
    ref = JaxFSR(geometry3[0], as_jax(params))
    cam = auto_orbit_camera(port.bounds)
    got = port.render(cam)
    want = ref.render(as_jax(cam))
    assert got.shape == (64 * 64, 5)
    assert (want[:, 3] > 0).mean() > 0.2
    assert_pixels_close(got, want)


@pytest.mark.parametrize("sampling", ["nearest", "trilinear"])
def test_state_round_trip(geometry3, sampling):
    """renderer_from_state(state_from_renderer(jax_fsr)) holds the same
    tables as a port renderer built from the geometry, and renders the
    same frame."""
    params = RenderParameters(width=64, height=64, sampling=sampling)
    jax_fsr = JaxFSR(geometry3[0], as_jax(params))
    state = state_from_renderer(jax_fsr)
    from_state = renderer_from_state(state, params, device=CPU)
    built = FastSceneRenderer(geometry3[1], params, device=CPU)
    assert isinstance(from_state.canonical, torch.Tensor)
    for key, value in state_from_renderer(built).items():
        np.testing.assert_array_equal(value, state[key], err_msg=key)
    np.testing.assert_array_equal(from_state.canonical.numpy(),
                                  np.asarray(jax_fsr.canonical))
    cam = CameraParameters(eye=(-1.9, 2.3, -1.2), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    np.testing.assert_array_equal(from_state.render(cam), built.render(cam))
    with pytest.raises(ValueError, match="ghost width"):
        other = "nearest" if sampling == "trilinear" else "trilinear"
        renderer_from_state(state, RenderParameters(sampling=other), device=CPU)


@pytest.mark.parametrize("eye", [(3.1, 0.5, 0.4), (0.45, 0.4, -2.2),
                                 (0.52, 3.0, 0.55), (-1.9, 2.3, -1.2)])
@pytest.mark.parametrize("sampling", ["nearest", "trilinear"])
def test_frame_inputs_match_jax(geometry3, eye, sampling):
    """Per-frame host prep (piece tables, camera pack, compacted CSR work
    list with tightened item bands) equals the JAX renderer's."""
    params = RenderParameters(width=96, height=64, sampling=sampling)
    port = FastSceneRenderer(geometry3[1], params, device=CPU)
    ref = JaxFSR(geometry3[0], as_jax(params))
    cam = CameraParameters(eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))
    got = port.frame_inputs(cam, as_numpy=True)
    want = ref.frame_inputs(as_jax(cam), as_numpy=True)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key
    on_device = port.frame_inputs(cam)
    for key in got:
        np.testing.assert_array_equal(on_device[key].numpy(), got[key])
    np.testing.assert_array_equal(port._packed_vol.numpy(),
                                  np.asarray(ref._packed_vol))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_repack_and_extrema_match_jax(geometry3, axis):
    params = RenderParameters(width=32, height=32, sampling="trilinear")
    port = FastSceneRenderer(geometry3[1], params, device=CPU)
    ref = JaxFSR(geometry3[0], as_jax(params))
    np.testing.assert_array_equal(
        _repack_for_axis(port.canonical, axis, 32).numpy(),
        np.asarray(jax_repack(ref.canonical, axis=axis, cube=32)),
    )
    # XLA:CPU flushes subnormal floats to zero; torch keeps them.  The
    # extrema only feed LUT-bin indices, where a subnormal is 0 either way.
    ftz = lambda a: np.where(np.abs(a) < np.finfo(np.float32).tiny, 0.0, a)
    for got, want in ((port._slice_minmax, ref._slice_minmax),
                      (port._slice_quad_minmax, ref._slice_quad_minmax)):
        for g, w in zip(got[axis], want[axis]):
            np.testing.assert_array_equal(ftz(g), ftz(w))


def test_ghost_fill_and_pretransform_match_jax(geometry3):
    jax_geometry, port_geometry = geometry3
    t = port_geometry.scalar_transform
    datas = [_pretransform(b.data, t, 1.0, False) for b in port_geometry.bricks]
    ref = [jax_pretransform(b.data, jax_geometry.scalar_transform, 1.0, False)
           for b in jax_geometry.bricks]
    for got, want in zip(datas, ref):
        np.testing.assert_array_equal(got, want)
    boxes = [(b.min_corner, b.max_corner) for b in port_geometry.bricks]
    assert len(boxes) > 1
    for got, want in zip(ghost_fill(datas, boxes, 1),
                         jax_ghost_fill(datas, boxes, 1)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_downsample_and_byte_codec_match_jax():
    rng = np.random.default_rng(5)
    frame = rng.uniform(-0.1, 1.1, (24 * 16, 5)).astype(np.float32)
    np.testing.assert_allclose(
        _device_downsample(torch.from_numpy(frame), 24, 16, 2).numpy(),
        np.asarray(jax_down(jnp.asarray(frame), 24, 16, 2)), rtol=0, atol=1e-7,
    )
    colors = np.concatenate([frame[:, :4].ravel(),
                             [0.0, 1.0, 255 / 256, -7.0, 1e9, np.nan]])
    colors = colors.astype(np.float32)
    np.testing.assert_array_equal(
        color_to_byte_device(torch.from_numpy(colors)).numpy(),
        np.asarray(jax_to_byte(jnp.asarray(colors))),
    )


@pytest.mark.parametrize("kind", list(ImageKind))
def test_image_blend_and_downsample_match_jax(kind):
    """The host image helpers the overlay and IO use: the per-kind blend
    under ImageBuffer.blend (union-region semantics) and the AA
    downsample of the unfused path."""
    rng = np.random.default_rng(9)
    channels = {ImageKind.RGBA_F32_DEPTH_SORT: 5, ImageKind.RGBA_U8_DEPTH_F32: 5}
    c = channels.get(kind, 4)
    dtype = np.uint8 if kind == ImageKind.RGBA_U8 else np.float32
    top = (rng.uniform(0, 255 if dtype == np.uint8 else 1, (6, c))).astype(dtype)
    bottom = (rng.uniform(0, 255 if dtype == np.uint8 else 1, (8, c))).astype(dtype)
    got = ImageBuffer(kind, 4, 4, top, 2, 8).blend(ImageBuffer(kind, 4, 4, bottom, 6, 14))
    want = jax_image.ImageBuffer(jax_image.ImageKind(kind.value), 4, 4, top, 2, 8).blend(
        jax_image.ImageBuffer(jax_image.ImageKind(kind.value), 4, 4, bottom, 6, 14))
    assert (got.region_begin, got.region_end) == (want.region_begin, want.region_end)
    np.testing.assert_array_equal(got.pixels, want.pixels)
    if kind == ImageKind.RGBA_F32_DEPTH_SORT:
        src = rng.uniform(0, 1, (16 * 8, 5)).astype(np.float32)
        got = downsample_image(ImageBuffer(kind, 16, 8, src), 8, 4, 2)
        want = jax_downsample_image(jax_image.ImageBuffer(
            jax_image.ImageKind(kind.value), 16, 8, src), 8, 4, 2)
        np.testing.assert_array_equal(got.pixels, want.pixels)


def test_fully_transparent_scene_renders_background(r2_geometry):
    transparent = color_map_from_tuples([(0.0, 1, 1, 1, 0.0), (1.0, 1, 1, 1, 0.0)])
    fsr = FastSceneRenderer(r2_geometry, RenderParameters(width=32, height=32),
                            color_map=transparent, device=CPU)
    cam = auto_orbit_camera(fsr.bounds)
    assert fsr.frame_inputs(cam) is None
    pixels = fsr.render(cam, overlay=False)
    assert (pixels[:, :4] == 0).all() and np.isinf(pixels[:, 4]).all()


def test_cuda_device_without_card_raises(r2_geometry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastSceneRenderer(r2_geometry, RenderParameters(width=32, height=32))
