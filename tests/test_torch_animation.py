"""The port's animation path against the JAX package's: the batched
tile-march kernel (float32 and bfloat16 volumes), ``render_batch`` in every
output mode, ``precision="bfloat16"``, ``set_transfer_function``,
``update_data`` (NumPy and tensors), the tensor pre-transform, and orbit
rendering through the CLI.

The JAX package runs on the CPU with ``interpret=True``, as its own tests
run it.  Inputs come from numpy with fixed seeds (and the 3-level scene at
a quarter of bench.py's width).  Tolerance: atol 2e-6 on RGBA and finite
depth with the same non-finite depth pattern (the golden manifest's);
byte frames, PPM files and host tables must be equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu.device_scene import _pretransform_device as jax_pretransform_device
from amrvolumerenderer_tpu.driver import main as jax_main
from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer as JaxFSR
from amrvolumerenderer_tpu.ops import tilemarch as jtm
from amrvolumerenderer_tpu import transforms as jax_transforms
from amrvolumerenderer_tpu.plotfile import write_plotfile
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
from amrvolumerenderer_tpu.types import ScalarTransform as JaxScalarTransform
from amrvolumerenderer_tpu.types import color_map_from_tuples as as_jax_map
from amrvolumerenderer_torch import fast_scene as port_fast_scene
from amrvolumerenderer_torch import render as port_render
from amrvolumerenderer_torch import transforms
from amrvolumerenderer_torch.device_scene import _pretransform_device
from amrvolumerenderer_torch.driver import RunOptions, main as port_main, run_options
from amrvolumerenderer_torch.fast_scene import FastSceneRenderer, pack_batch_tables
from amrvolumerenderer_torch.ops import tilemarch as tm
from amrvolumerenderer_torch.state import (
    _canonical_tensor,
    geometry_from,
    renderer_from_state,
    state_from_renderer,
)
from amrvolumerenderer_torch.types import (
    CameraParameters,
    RenderParameters,
    ScalarTransform,
    color_map_from_tuples,
)

from test_torch_worklist import (  # noqa: F401
    as_jax,
    one_torch_thread,
    three_level_geometry,
)

CPU = torch.device("cpu")
TABLES = ("cam", "offsets", "bricks", "owners", "item_bounds", "tile_ids")
CLEAR = [(0.0, 0.0, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0, 0.0)]
# a map that is transparent below 0.8: pieces that hold only the outer
# shell (values up to 0.7) cull
STEP_MAP = [(0.0, 0.1, 0.2, 0.9, 0.0), (0.8, 0.1, 0.2, 0.9, 0.0),
            (0.85, 0.9, 0.6, 0.1, 0.6), (1.0, 1.0, 1.0, 0.2, 0.9)]


@pytest.fixture(scope="module")
def geometry3():
    """bench.py's 3-level scene: (the JAX package's geometry, the port's
    own copy of it)."""
    geometry = three_level_geometry()
    return geometry, geometry_from(geometry)


def orbit(n, dist=3.0):
    """``n`` eyes around the scene centre (tests/test_fast_scene.py's
    orbit): march axes change along it."""
    return [
        CameraParameters(
            eye=(0.5 + dist * np.sin(2 * np.pi * k / n), 1.2,
                 0.5 + dist * np.cos(2 * np.pi * k / n)),
            look_at=(0.5, 0.5, 0.5), up=(0, 1, 0), fov_y_degrees=45.0,
            near_plane=0.1, far_plane=20.0,
        )
        for k in range(n)
    ]


def jax_cams(cams):
    return [as_jax(c) for c in cams]


def assert_pixels_close(got, ref, atol=2e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=atol)


def renderers(geometry3, params, **kw):
    """(port renderer on the CPU, JAX renderer in interpret mode)."""
    port = FastSceneRenderer(geometry3[1], params, device=CPU, **kw)
    ref = JaxFSR(geometry3[0], as_jax(params), interpret=True, **kw)
    return port, ref


# ---- the batched kernel ----------------------------------------------------


@pytest.mark.parametrize("case", ["float32", "bfloat16", "owner-runs"])
def test_batch_kernel_plain_matches_jax(geometry3, case):
    """Three frames of one march axis whose work lists differ in width,
    packed from the JAX renderer's own frame_inputs: the plain batched
    kernel equals JAX's interpret-mode tilemarch_render_batch."""
    precision = "bfloat16" if case == "bfloat16" else "float32"
    params = RenderParameters(width=64, height=48)
    ref = JaxFSR(geometry3[0], as_jax(params), interpret=True, precision=precision)
    cams = [CameraParameters(eye=(0.5 + d * np.sin(a), 1.1, 0.5 + d * np.cos(a)),
                             look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))
            for d, a in ((2.2, 0.1), (3.0, 0.25), (4.5, 0.4))]
    frames = [ref.frame_inputs(as_jax(c), as_numpy=True) for c in cams]
    assert len(ref._axis_meta_cache) == 1
    assert len({len(f["bricks"]) for f in frames}) == 3
    num_tiles = (ref.pad_w // 32) * (ref.pad_h // 32)
    tables = pack_batch_tables(frames, num_tiles)
    if case == "owner-runs":
        # owners change inside each tile's list: runs of two items
        tables["owners"] = (np.arange(tables["owners"].size).reshape(
            tables["owners"].shape) // 2 % 3).astype(np.int32)
    meta, dims = frames[0]["meta"], frames[0]["dims"]
    kw = dict(width=ref.pad_w, height=ref.pad_h, max_slices=ref.cube,
              logical_width=ref.render_width, logical_height=ref.render_height,
              sampling="nearest", ghost=ref.ghost, classification="post")
    want_c, want_d = jtm.tilemarch_render_batch(
        ref._packed_vol, jnp.asarray(meta), jnp.asarray(dims), ref._lut_device,
        *(jnp.asarray(tables[k]) for k in TABLES), interpret=True, **kw)
    vol = _canonical_tensor(np.asarray(ref._packed_vol))
    assert vol.dtype == (torch.bfloat16 if case == "bfloat16" else torch.float32)
    got_c, got_d = tm.tilemarch_render_batch(
        vol, torch.from_numpy(meta), torch.from_numpy(dims),
        torch.from_numpy(np.asarray(ref._lut_device)),
        *(torch.from_numpy(tables[k]) for k in TABLES), **kw)
    assert got_c.shape == want_c.shape and got_d.shape == want_d.shape
    assert (np.asarray(want_c)[:, :, 3] > 0).mean() > 0.05
    assert_pixels_close(got_c.numpy(), want_c)
    assert_pixels_close(got_d.numpy(), want_d)


# ---- render_batch ------------------------------------------------------------


@pytest.fixture(scope="module")
def orbit_pair(geometry3):
    """32x32 renderers and a 6-frame orbit crossing march axes, with the
    JAX float frames."""
    port, ref = renderers(geometry3, RenderParameters(width=32, height=32))
    cams = orbit(6)
    return port, ref, cams, ref.render_batch(jax_cams(cams), overlay=False)


def test_render_batch_float_frames_match_jax(orbit_pair):
    port, ref, cams, want = orbit_pair
    got = port.render_batch(cams, overlay=False)
    assert got.shape == (6, 32 * 32, 5) and got.dtype == np.float32
    assert (want[:, :, 3] > 0).mean() > 0.1
    assert_pixels_close(got, want)
    stats = port.last_batch_stats
    assert stats["frames"] == 6 and stats["dispatch_count"] >= 2
    assert set(stats) == set(ref.last_batch_stats)
    # one launch per chunk, and the frames equal the per-frame render
    np.testing.assert_array_equal(got[2], port.render(cams[2], overlay=False))
    np.testing.assert_array_equal(port.render_batch(cams, overlay=False,
                                                    max_chunk_bytes=1), got)


@pytest.mark.parametrize("bytes_out", [True, "rgb"])
def test_render_batch_bytes_match_jax(orbit_pair, bytes_out):
    """The first three frames (two march axes) as bytes."""
    port, ref, cams, want_float = orbit_pair
    cams = cams[:3]
    got = port.render_batch(cams, overlay=False, bytes_out=bytes_out)
    want = ref.render_batch(jax_cams(cams), overlay=False, bytes_out=bytes_out)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    codec = np.clip((want_float[:3, :, :4] * np.float32(256.0)).astype(np.int32),
                    0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, codec[..., : got.shape[-1]])
    with pytest.raises(ValueError, match="overlay"):
        port.render_batch(cams[:1], overlay=True, bytes_out=bytes_out)


def test_render_batch_antialiasing_matches_jax(geometry3):
    port, ref = renderers(geometry3, RenderParameters(width=16, height=16,
                                                      antialiasing=4))
    cams = orbit(2)
    got = port.render_batch(cams, overlay=False)
    assert got.shape == (2, 16 * 16, 5)
    assert_pixels_close(got, ref.render_batch(jax_cams(cams), overlay=False))
    # downsample, then encode
    codec = np.clip((got[..., :4] * np.float32(256.0)).astype(np.int32), 0, 255)
    np.testing.assert_array_equal(
        port.render_batch(cams, overlay=False, bytes_out=True),
        codec.astype(np.uint8))


def test_render_batch_eager_window_flush(geometry3, monkeypatch):
    """17 frames: the first 16-frame window is dispatched before the last
    frame's host prep (dispatch interleaves with prep), and the frames
    stay in input order, equal to per-frame renders (which match JAX)."""
    port = FastSceneRenderer(geometry3[1], RenderParameters(width=16, height=16),
                             device=CPU)
    cams = orbit(17, dist=4.0)
    events = []
    real_launch = tm.tilemarch_render_batch
    real_prep = FastSceneRenderer.frame_inputs

    def spy_launch(*a, **k):
        events.append("dispatch")
        return real_launch(*a, **k)

    def spy_prep(self, *a, **k):
        events.append("prep")
        return real_prep(self, *a, **k)

    monkeypatch.setattr(port_fast_scene.tm, "tilemarch_render_batch", spy_launch)
    monkeypatch.setattr(FastSceneRenderer, "frame_inputs", spy_prep)
    got = port.render_batch(cams, overlay=False)
    monkeypatch.undo()
    assert port.last_batch_stats["dispatch_count"] >= 2
    assert events.count("prep") == 17
    assert events[: events.index("dispatch")].count("prep") < 17
    for i in (0, 15, 16):
        np.testing.assert_array_equal(got[i], port.render(cams[i], overlay=False))


def test_render_batch_culled_frames_and_saves_match_jax(geometry3, tmp_path):
    """A fully transparent map culls every item: frames come back cleared.
    With the overlay and an output pattern, the saved PPMs equal JAX's."""
    port, ref = renderers(geometry3, RenderParameters(width=24, height=24))
    cams = orbit(2)
    got = port.render_batch(cams, overlay=True,
                            output_pattern=str(tmp_path / "p{:02d}.ppm"))
    want = ref.render_batch(jax_cams(cams), overlay=True,
                            output_pattern=str(tmp_path / "j{:02d}.ppm"))
    assert_pixels_close(got, want)
    for i in range(2):
        assert (tmp_path / f"p{i:02d}.ppm").read_bytes() == \
            (tmp_path / f"j{i:02d}.ppm").read_bytes()
    port.set_transfer_function(color_map=color_map_from_tuples(CLEAR))
    ref.set_transfer_function(color_map=as_jax_map(CLEAR))
    cleared = port.render_batch(cams, overlay=False)
    assert (cleared[..., :4] == 0).all() and np.isinf(cleared[..., 4]).all()
    np.testing.assert_array_equal(
        cleared, ref.render_batch(jax_cams(cams), overlay=False))
    assert port.render_batch([], overlay=False).shape == (0, 24 * 24, 5)


# ---- bfloat16 storage --------------------------------------------------------


def test_bfloat16_matches_jax_from_geometry_and_state(geometry3):
    params = RenderParameters(width=32, height=32)
    port, ref = renderers(geometry3, params, precision="bfloat16")
    assert port.canonical.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        port.canonical.float().numpy(), np.asarray(ref.canonical).astype(np.float32))
    from_state = renderer_from_state(state_from_renderer(ref), params, device=CPU)
    assert from_state.canonical.dtype == torch.bfloat16
    assert from_state.precision == "bfloat16"
    cams = orbit(3)
    want = ref.render_batch(jax_cams(cams), overlay=False)
    assert_pixels_close(port.render_batch(cams, overlay=False), want)
    assert_pixels_close(from_state.render(cams[1], overlay=False), want[1])
    # bfloat16 frames stay within the JAX package's 0.02 of float32's
    f32 = FastSceneRenderer(geometry3[1], params, device=CPU)
    diff = np.abs(f32.render(cams[1], overlay=False)[:, :4] - want[1][:, :4])
    assert diff.max() < 0.02
    with pytest.raises(ValueError, match="precision"):
        FastSceneRenderer(geometry3[1], params, device=CPU, precision="fp8")


# ---- transfer-function swap and in-situ update ------------------------------


def test_set_transfer_function_matches_jax(geometry3):
    params = RenderParameters(width=32, height=32)
    port, ref = renderers(geometry3, params)
    port.set_transfer_function(color_map=color_map_from_tuples(STEP_MAP),
                               box_transparency=0.25)
    ref.set_transfer_function(color_map=as_jax_map(STEP_MAP), box_transparency=0.25)
    assert not port.visible.all()
    np.testing.assert_array_equal(port.visible, ref.visible)
    cam = orbit(5)[1]
    got = port.render(cam, overlay=False)
    assert_pixels_close(got, ref.render(as_jax(cam), overlay=False))
    fresh = FastSceneRenderer(geometry3[1], RenderParameters(
        width=32, height=32, box_transparency=0.25),
        color_map=color_map_from_tuples(STEP_MAP), device=CPU)
    np.testing.assert_array_equal(fresh.render(cam, overlay=False), got)
    # the mask and ranges travel through state.py
    state = state_from_renderer(ref)
    np.testing.assert_array_equal(
        renderer_from_state(state, params, device=CPU).visible, ref.visible)


def evolved(geometry):
    """Next time step: the field inverted inside the fixed scalar range."""
    lo, hi = geometry.scalar_range
    return [np.float32(hi) - np.asarray(b.data, np.float32) + np.float32(lo)
            for b in geometry.bricks]


@pytest.mark.parametrize("path", ["numpy", "tensor"])
def test_update_data_matches_jax(geometry3, path):
    """Each update path against the same path in JAX: NumPy arrays (host
    float64 pre-transform, one upload) and tensors (float32 pre-transform
    on the device, bit-exact with JAX's jnp path)."""
    port, ref = renderers(geometry3, RenderParameters(width=32, height=32))
    cam = orbit(5)[2]
    before = port.render(cam, overlay=False)
    arrays = evolved(geometry3[1])
    if path == "numpy":
        port.update_data(arrays)
        ref.update_data(arrays)
    else:
        port.update_data([torch.from_numpy(a) for a in arrays])
        ref.update_data([jnp.asarray(a) for a in arrays])
    np.testing.assert_array_equal(port.canonical.numpy(), np.asarray(ref.canonical))
    np.testing.assert_array_equal(port.visible, ref.visible)
    got = port.render(cam, overlay=False)
    assert np.abs(got[:, :4] - before[:, :4]).max() > 0.05  # really changed
    assert_pixels_close(got, ref.render(as_jax(cam), overlay=False))


def test_update_data_tensor_ghost_fill(geometry3):
    """Trilinear: the tensor path's ghost rings (filled where the tensors
    lie) equal the NumPy ghost fill of the same pre-transformed values."""
    from amrvolumerenderer_torch.fast_scene import _split_to_cubes
    from amrvolumerenderer_torch.ghost import ghost_fill

    geometry = geometry3[1]
    port = FastSceneRenderer(geometry, RenderParameters(
        width=16, height=16, sampling="trilinear"), device=CPU)
    arrays = evolved(geometry)
    port.update_data([torch.from_numpy(a) for a in arrays])
    datas = [_pretransform_device(torch.from_numpy(a), geometry.scalar_transform,
                                  1.0, False).numpy() for a in arrays]
    boxes = [(b.min_corner, b.max_corner) for b in geometry.bricks]
    want = []
    for data, padded, brick in zip(datas, ghost_fill(datas, boxes, 1),
                                   geometry.bricks):
        for block, *_ in _split_to_cubes(data, brick.min_corner, brick.max_corner,
                                         30, ghost=1, padded=padded):
            buf = np.zeros((32, 32, 32), np.float32)
            buf[: block.shape[0], : block.shape[1], : block.shape[2]] = block
            want.append(buf)
    np.testing.assert_array_equal(port.canonical.numpy(), np.stack(want))


def test_update_data_validates_layout(geometry3):
    port = FastSceneRenderer(geometry3[1], RenderParameters(width=16, height=16),
                             device=CPU)
    with pytest.raises(ValueError, match="brick arrays"):
        port.update_data([np.zeros((4, 4, 4), np.float32)])
    with pytest.raises(ValueError, match="shape changed"):
        port.update_data([torch.zeros((4, 4, 4))] * len(geometry3[1].bricks))
    state_built = renderer_from_state(state_from_renderer(port),
                                      RenderParameters(width=16, height=16),
                                      device=CPU)
    with pytest.raises(ValueError, match="SceneGeometry"):
        state_built.update_data(evolved(geometry3[1]))


@pytest.mark.parametrize("log_scale", [False, True])
def test_tensor_pretransform_matches_jax_elementwise(log_scale):
    """The port's float32 pre-transform (log, normalisation, active soft
    clip) equals JAX's device pre-transform bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.lognormal(0.0, 2.0, 20011) * rng.choice([1, 1, 1, -1, 0], 20011)
    x[:6] = [np.nan, np.inf, -np.inf, 0.0, 1e-300, 5e-39]
    kw = dict(log_scale_input=log_scale, normalize_to_unit_range=True,
              positive_floor=1e-3, normalization_min=-2.5 if log_scale else 0.1,
              inverse_normalization_span=1 / 7.3)
    for clip in (0.3, 0.77, 1.0):
        want = np.asarray(jax_pretransform_device(
            jnp.asarray(x), JaxScalarTransform(**kw), clip, clip < 1.0))
        got = _pretransform_device(torch.from_numpy(x), ScalarTransform(**kw),
                                   clip, clip < 1.0)
        np.testing.assert_array_equal(got.numpy(), want)
    v = jnp.asarray(x.astype(np.float32))
    t = torch.from_numpy(x.astype(np.float32))
    np.testing.assert_array_equal(
        transforms.apply_scalar_transform(t, **transforms.transform_arrays(
            ScalarTransform(**kw))).numpy(),
        np.asarray(jax_transforms.apply_scalar_transform(
            v, **jax_transforms.transform_arrays(JaxScalarTransform(**kw)))))
    np.testing.assert_array_equal(
        transforms.saturate_soft_tail(torch.nan_to_num(t), 0.6, 1.0).numpy(),
        np.asarray(jax_transforms.saturate_soft_tail(jnp.nan_to_num(v), 0.6, 1.0)))


# ---- orbit rendering -----------------------------------------------------------


@pytest.fixture(scope="module")
def plotfile(tmp_path_factory):
    """A one-level r^2 plotfile in four boxes."""
    c = np.arange(16) / 15
    field = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    boxes = [LevelBox(field[i:i + 8, j:j + 8, :], np.array([i, j, 0]))
             for i in (0, 8) for j in (0, 8)]
    path = str(tmp_path_factory.mktemp("plt") / "plt00000")
    write_plotfile(path, [boxes], [LevelGeometry(np.zeros(3), np.full(3, 1 / 16))])
    return path


def test_orbit_cli_matches_jax_cli(tmp_path, plotfile):
    flags = ["--width", "32", "--height", "32", "--orbit-frames", "3",
             "--render-method", "tilemarch"]
    assert port_main(flags + ["--device", "cpu", "--output",
                              str(tmp_path / "port.ppm"), plotfile]) == 0
    assert jax_main(flags + ["--output", str(tmp_path / "jax.ppm"), plotfile]) == 0
    frames = [(tmp_path / f"port_{i:04d}.ppm").read_bytes() for i in range(3)]
    for i, blob in enumerate(frames):
        assert blob == (tmp_path / f"jax_{i:04d}.ppm").read_bytes(), i
    assert len(set(frames)) == 3  # the camera moves
    # frame 0 is the base camera: equal to a single render
    assert port_main(flags[:4] + flags[6:] + ["--device", "cpu", "--output",
                                              str(tmp_path / "one.ppm"),
                                              plotfile]) == 0
    assert (tmp_path / "one.ppm").read_bytes() == frames[0]
    # the API entry renders the same orbit
    assert port_render(plotfile, width=32, height=32, orbit_frames=3,
                       output=str(tmp_path / "api.ppm"), device="cpu") == 0
    assert (tmp_path / "api_0002.ppm").exists()


def test_orbit_rejects_raymarch(tmp_path, plotfile):
    options = RunOptions(plotfile_path=plotfile,
                         output_filename=str(tmp_path / "o.ppm"), device="cpu")
    options.parameters.render_method = "raymarch"
    options.orbit_frames = 2
    with pytest.raises(ValueError, match="fast kernel family"):
        run_options(options, verbose=False)
    assert not os.path.exists(tmp_path / "o_0000.ppm")
