"""The port's host work-list builders (amrvolumerenderer_torch/ops/
worklist.py) against their JAX-package twins: every function must return
arrays equal to the original's on the same inputs.

Inputs come from the JAX ``FastSceneRenderer`` on the r^2 golden scene and
bench.py's 3-level scene, for cameras that march every axis in both
directions, an oblique view and an eye inside the domain.
"""

import dataclasses

import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu import native as jax_native
from amrvolumerenderer_tpu import types as jax_types
from amrvolumerenderer_tpu.camera import (
    auto_orbit_camera,
    camera_basis,
    orbit_camera_sequence,
)
from amrvolumerenderer_tpu.colormap import build_color_table
from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer as JaxFSR
from amrvolumerenderer_tpu.ops import slicemarch as jsm
from amrvolumerenderer_tpu.ops import tilemarch as jtm
from amrvolumerenderer_tpu.types import CameraParameters, RenderParameters
from amrvolumerenderer_torch import native
from amrvolumerenderer_torch import scene as port_scene
from amrvolumerenderer_torch.ops import worklist as wl

from tests.conftest import make_r2_scene_data

EYES = [
    (3.1, 0.5, 0.4),     # march axis 0, backward
    (-2.1, 0.6, 0.45),   # march axis 0, forward
    (0.5, 0.6, 3.2),     # axis 2, backward
    (0.45, 0.4, -2.2),   # axis 2, forward
    (0.52, 3.0, 0.55),   # axis 1, nearly top-down
    (-1.9, 2.3, -1.2),   # oblique
    (0.4, 0.45, 0.5),    # eye inside the domain
]
# four frames of the auto-orbit camera's 360-degree orbit (march axes and
# directions change along it) plus the fixed eyes above
CAMS = [f"orbit{k}" for k in range(4)] + list(range(len(EYES)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process: the suite runs several pytest
    workers on the box's cores, and a full OpenMP pool in each of them
    oversubscribes the cores (measured 5x slower wall time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_levels(levels, geoms):
    """The port's own LevelBox / LevelGeometry objects over the same arrays
    as the JAX package's (each side builds its own types)."""
    return (
        [[port_scene.LevelBox(b.data, b.lo) for b in level] for level in levels],
        [port_scene.LevelGeometry(g.prob_lo, g.cell_size) for g in geoms],
    )


def as_jax(obj):
    """The JAX package's dataclass of the same name and fields as the port
    dataclass ``obj`` (RenderParameters, CameraParameters, ...)."""
    return getattr(jax_types, type(obj).__name__)(**dataclasses.asdict(obj))


def three_level_geometry():
    """bench.py's 3-level scene (bench.py:70-93) at a quarter of its width."""
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    n = 32

    def field(lo, hi):
        c = lo + (np.arange(n) + 0.5) / n * (hi - lo)
        r = np.sqrt((c[:, None, None] - 0.5) ** 2 + (c[None, :, None] - 0.5) ** 2
                    + (c[None, None, :] - 0.5) ** 2)
        return np.exp(-((r - 0.18) / 0.06) ** 2) + 0.7 * np.exp(
            -((r - 0.38) / 0.05) ** 2)

    data = jax_api.AmrData(
        level_data=[[LevelBox(field(0.0, 1.0), np.zeros(3, int))],
                    [LevelBox(field(0.25, 0.75), np.full(3, 16, int))],
                    [LevelBox(field(0.375, 0.625), np.full(3, 48, int))]],
        level_geometry=[LevelGeometry(np.zeros(3), np.full(3, 1.0 / (s * n)))
                        for s in (1, 2, 4)],
        refinement_ratios=[(2, 2, 2), (2, 2, 2)],
    )
    return jax_api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


@pytest.fixture(scope="module")
def renderers():
    levels, geoms = make_r2_scene_data(16, 8)
    r2 = jax_api.load_amr_geometry(
        jax_api.AmrData(level_data=levels, level_geometry=geoms),
        0, -1, 0, False, True, verbose=False,
    )
    params = RenderParameters(width=96, height=64)
    return {
        "r2": JaxFSR(r2, params),
        "3lvl": JaxFSR(three_level_geometry(), params),
    }


def _camera(fsr, cam):
    if isinstance(cam, str):
        frames = orbit_camera_sequence(auto_orbit_camera(fsr.bounds), 4, 360.0)
        return frames[int(cam[len("orbit"):])]
    return CameraParameters(eye=EYES[cam], look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))


def _frame(fsr, cam):
    """Everything the work-list stage consumes for one camera."""
    camera = _camera(fsr, cam)
    forward, right, up = camera_basis(camera)
    axis = jsm.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]
    meta, dims = fsr._axis_metadata(axis)
    from amrvolumerenderer_tpu.visibility import order_keys_or_hints

    hints = order_keys_or_hints(
        camera, fsr.render_width / fsr.render_height, fsr.box_min,
        fsr.box_max, parents=fsr.parents, parent_min=fsr._parent_min,
        parent_max=fsr._parent_max,
    )
    qmin, qmax = fsr._slice_quad_minmax[axis]
    return dict(
        camera=camera, eye=np.asarray(camera.eye), forward=forward,
        right=right, up=up, axis=axis, axes=axes, meta=meta, dims=dims,
        hints=hints, qmin=qmin, qmax=qmax,
    )


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_constants_match():
    assert (wl.LANES, wl.SUBLANES, wl.TILE_P, wl.SLICE_CELLS) == (
        jsm.LANES, jsm.SUBLANES, jsm.TILE_P, jsm.SLICE_CELLS)
    assert (wl.TILE_W, wl.TILE_H) == (jsm.TILE_W, jsm.TILE_H)


@pytest.mark.parametrize("scene", ["r2", "3lvl"])
@pytest.mark.parametrize("cam", CAMS)
def test_screen_bboxes_and_worklist(renderers, scene, cam):
    fsr = renderers[scene]
    f = _frame(fsr, cam)
    geo = (fsr.box_min, fsr.box_max, f["eye"], f["forward"], f["right"],
           f["up"], f["camera"].fov_y_degrees)
    _equal(wl.project_screen_bboxes(*geo, fsr.render_width, fsr.render_height),
           jsm.project_screen_bboxes(*geo, fsr.render_width, fsr.render_height))
    for kw in (dict(), dict(pad_to=1, with_coverage=False)):
        _equal(wl.compute_worklist(*geo, fsr.pad_w, fsr.pad_h, **kw),
               jsm.compute_worklist(*geo, fsr.pad_w, fsr.pad_h, **kw))
    assert wl.choose_march_axis(f["forward"]) == jsm.choose_march_axis(f["forward"])


@pytest.mark.parametrize("scene", ["r2", "3lvl"])
@pytest.mark.parametrize("cam", CAMS)
def test_tile_worklist_and_item_bands(renderers, scene, cam):
    """build_tile_worklist -> compute_item_bands (native and NumPy oracle,
    with its pieces compute_item_slice_bounds / find_second_bands) ->
    expand_bands, stage by stage."""
    fsr = renderers[scene]
    f = _frame(fsr, cam)
    tw = (fsr.box_min, fsr.box_max, f["hints"], fsr.owners, f["eye"],
          f["forward"], f["right"], f["up"], f["camera"].fov_y_degrees,
          fsr.pad_w, fsr.pad_h)
    lw = dict(logical_width=fsr.render_width, logical_height=fsr.render_height)
    got = wl.build_tile_worklist(*tw, **lw)
    _equal(got, jtm.build_tile_worklist(*tw, **lw))
    offsets, bricks, owners = got
    wt = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    occ = jtm.block_occupancy_bits(f["qmin"], f["qmax"], fsr._lut_alpha, 0.0, 1.0)
    _equal(wl.block_occupancy_bits(f["qmin"], f["qmax"], fsr._lut_alpha, 0.0, 1.0),
           occ)
    args = (f["meta"], f["dims"][:, 7], wt, bricks, f["eye"], f["forward"],
            f["right"], f["up"], f["camera"].fov_y_degrees, f["axes"],
            fsr.pad_w, fsr.pad_h, fsr.render_width, fsr.render_height, occ,
            fsr._quad_blocks, fsr._quad_split)
    kw = dict(ghost=fsr.ghost, seg_len=2,
              margin=wl.footprint_margin(fsr.ghost, "nearest"))
    bands = wl.compute_item_bands(*args, **kw)
    _equal(bands, jtm.compute_item_bands(*args, **kw))
    # the native pass and the NumPy oracle agree in the port as well
    sb = wl.compute_item_slice_bounds(*args, return_mask=True, **kw)
    _equal(sb, jtm.compute_item_slice_bounds(*args, return_mask=True, **kw))
    split = wl.find_second_bands(sb[1], sb[0], sb[2])
    _equal(split, jtm.find_second_bands(sb[1], sb[0], sb[2]))
    _equal(bands, split + (sb[3],))
    _equal(wl.expand_bands(wt, bricks, owners, *bands),
           jtm.expand_bands(wt, bricks, owners, *bands))


def test_native_item_bands_call_matches():
    """The port's own bindings' item_bands (its ctypes call of
    avr_item_bands_v2) is the JAX package's native.item_bands (or both are
    unavailable)."""
    rng = np.random.default_rng(7)
    n, cap = 12, 16
    box_min = rng.uniform(0, 1, (n, 3))
    meta = np.zeros((n, 12), np.float32)
    meta[:, 0:3] = box_min
    meta[:, 3:6] = box_min + 0.25
    meta[:, 6:9] = 0.25 / cap
    bb = ((rng.integers(0, 4, n) << 16) | rng.integers(8, cap, n)).astype(np.int32)
    occ = rng.integers(0, 2**63, (n, cap), dtype=np.uint64)
    wt = np.sort(rng.integers(0, 6, 40))
    wb = rng.integers(0, n, 40)
    cam = (np.array([2.5, 1.5, 3.0]), np.array([-0.5, -0.3, -0.8]))
    fwd = cam[1] / np.linalg.norm(cam[1])
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    args = (meta, bb, wt, wb, cam[0], fwd, right, up, 45.0, [2, 0, 1],
            96, 96, 64, occ, 4, 4.0)
    _equal(native.item_bands(*args, ghost=1, seg_len=2, margin=2.51),
           jax_native.item_bands(*args, ghost=1, seg_len=2, margin=2.51))


@pytest.mark.parametrize("scene", ["r2", "3lvl"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_slice_bounds_batch(renderers, scene, axis):
    fsr = renderers[scene]
    smin, smax = fsr._slice_minmax[axis]
    n_slices = fsr.dims_world[:, axis].astype(np.int32)
    for lut_alpha, lo, inv in ((fsr._lut_alpha, 0.0, 1.0),
                               (np.where(np.arange(256) > 140, 0.5, 0.0), 0.1, 1.3)):
        _equal(wl.compute_slice_bounds_batch(smin, smax, lut_alpha, lo, inv, n_slices),
               jsm.compute_slice_bounds_batch(smin, smax, lut_alpha, lo, inv, n_slices))


@pytest.mark.parametrize("size", [128, 256])
def test_log_lut_camera_pack_and_margin(size):
    table = build_color_table(0.8, 1.0, (0.0, 1.0), None, size=size)
    table[size // 2, 3] = 1.0  # an opaque entry: log(1 - alpha) = -inf
    _equal(wl.build_log_lut(table), jsm.build_log_lut(table))
    with pytest.raises(ValueError):
        wl.build_log_lut(table[:100])
    pack = (np.array([1.0, 2.0, 3.0]), np.array([0.0, 0.0, -1.0]),
            np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]), 45.0,
            1.5, 0.1, 2.5, 0.004)
    _equal(wl.pack_camera(*pack), jsm.pack_camera(*pack))
    for ghost in (0, 1):
        for sampling in ("nearest", "trilinear"):
            assert wl.footprint_margin(ghost, sampling) == jtm.footprint_margin(
                ghost, sampling)


def test_owner_range_validated():
    with pytest.raises(ValueError, match="owner ids"):
        wl.build_tile_worklist(
            np.zeros((1, 3)), np.ones((1, 3)), np.zeros(1),
            np.array([40000]), np.array([0.5, 0.5, 3.0]),
            np.array([0.0, 0.0, -1.0]), np.array([1.0, 0.0, 0.0]),
            np.array([0.0, 1.0, 0.0]), 45.0, 64, 64,
        )
