"""The port's tile-march plain version against the JAX kernel.

``tilemarch_reference`` (and ``tilemarch_render`` on CPU tensors, which
runs it) is fed exactly what the JAX ``tilemarch_render(interpret=True)``
gets: the JAX ``FastSceneRenderer``'s packed volume and
``frame_inputs(as_numpy=True)``, in the full-gather form
(``row_chords=None``, no DMA window; both are pixel-exact TPU devices).
Tolerance: atol 2e-6 on RGBA and on finite depth with the same non-finite
depth pattern (the golden manifest's).  ``numerics`` reproduces XLA:CPU's
rounding, so the two agree bit for bit on these scenes; the tolerance is
the contract, not the measured gap.

The CUDA kernel itself runs only on a GPU: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu.camera import auto_orbit_camera
from amrvolumerenderer_tpu.fast_scene import FastSceneRenderer as JaxFSR
from amrvolumerenderer_tpu.ops import tilemarch as jtm
from amrvolumerenderer_tpu.types import CameraParameters, RenderParameters
from amrvolumerenderer_torch.ops import numerics
from amrvolumerenderer_torch.ops import tilemarch as tm

from tests.conftest import make_r2_scene_data
from test_torch_worklist import one_torch_thread, three_level_geometry  # noqa: F401

ATOL = 2e-6
KNOBS = [  # (sampling, classification, lut_size)
    ("nearest", "post", 256),
    ("nearest", "post", 128),
    ("trilinear", "post", 256),
    ("trilinear", "pre", 128),
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


def assert_frames_close(got_c, got_d, ref_c, ref_d, atol=ATOL):
    got_c, got_d = np.asarray(got_c), np.asarray(got_d)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)
    assert got_c.shape == ref_c.shape and got_d.shape == ref_d.shape
    np.testing.assert_allclose(got_c, ref_c, rtol=0, atol=atol)
    finite = np.isfinite(ref_d)
    np.testing.assert_array_equal(np.isfinite(got_d), finite)
    np.testing.assert_allclose(got_d[finite], ref_d[finite], rtol=0, atol=atol)


def _dense(inputs, num_tiles):
    """The compacted step list expanded to the dense grid (one step per
    frame tile, tile_ids=None)."""
    counts = np.zeros(num_tiles, np.int64)
    steps = np.diff(inputs["offsets"])
    live = inputs["tile_ids"] < num_tiles
    counts[inputs["tile_ids"][live]] = steps[live]
    offsets = np.zeros(num_tiles + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    return offsets


def _case(geometry, knobs, camera, size=64):
    sampling, classification, lut_size = knobs
    fsr = JaxFSR(geometry, RenderParameters(
        width=size, height=size, sampling=sampling,
        classification=classification, lut_size=lut_size,
    ))
    if camera is None:
        camera = auto_orbit_camera(fsr.bounds)
    inputs = fsr.frame_inputs(camera, as_numpy=True)
    kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
              logical_width=fsr.render_width, logical_height=fsr.render_height,
              sampling=sampling, ghost=fsr.ghost, classification=classification)
    return fsr, inputs, kw


def _run_both(fsr, inputs, kw, dense):
    num_tiles = (fsr.pad_w // 32) * (fsr.pad_h // 32)
    offsets = _dense(inputs, num_tiles) if dense else inputs["offsets"]
    tile_ids = None if dense else inputs["tile_ids"]
    vol = np.asarray(fsr._packed_vol)
    lut = np.asarray(fsr._lut_device)
    ref = jtm.tilemarch_render(
        jnp.asarray(vol), inputs["meta"], inputs["dims"], jnp.asarray(lut),
        inputs["cam"], offsets, inputs["bricks"], inputs["owners"],
        inputs["item_bounds"], tile_ids, None, interpret=True, **kw,
    )
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    got = tm.tilemarch_render(
        t(vol), t(inputs["meta"]), t(inputs["dims"]), t(lut), t(inputs["cam"]),
        t(offsets), t(inputs["bricks"]), t(inputs["owners"]),
        t(inputs["item_bounds"]), t(tile_ids), **kw,
    )
    return got, ref


OBLIQUE = CameraParameters(eye=(-1.9, 2.3, -1.2), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
# the golden scene (auto-orbit camera, the golden rows' view) on both grids
# for every knob set; bench.py's 3-level scene from an oblique view with
# negative direction components on the compacted grid (plus one dense)
CASES = (
    [("r2", k, g) for k in KNOBS for g in ("dense", "compacted")]
    + [("3lvl", k, "compacted") for k in KNOBS]
    + [("3lvl", KNOBS[0], "dense")]
)


@pytest.mark.parametrize(
    "scene,knobs,grid", CASES,
    ids=["-".join([c[0], *map(str, c[1]), c[2]]) for c in CASES],
)
def test_reference_matches_jax_kernel(geometries, scene, knobs, grid):
    if scene == "r2":
        fsr, inputs, kw = _case(geometries["r2"], knobs, None, size=48)
    else:
        fsr, inputs, kw = _case(geometries["3lvl"], knobs, OBLIQUE)
    (gc, gd), (rc, rd) = _run_both(fsr, inputs, kw, grid == "dense")
    assert (np.asarray(rc)[:, 3] > 0).mean() > 0.1  # premise: a real frame
    assert_frames_close(gc.numpy(), gd.numpy(), rc, rd)


def test_reference_eye_inside_domain(geometries):
    """An eye inside the domain: rays start inside bricks (entry depth 0
    clips to the eye) and march both ways within one tile."""
    cam = CameraParameters(eye=(0.4, 0.45, 0.5), look_at=(0.9, 0.5, 0.5),
                           up=(0, 1, 0))
    fsr, inputs, kw = _case(geometries["3lvl"], KNOBS[2], cam)
    (gc, gd), (rc, rd) = _run_both(fsr, inputs, kw, dense=False)
    assert_frames_close(gc.numpy(), gd.numpy(), rc, rd)


@pytest.mark.parametrize("knobs", [KNOBS[0], KNOBS[2]],
                         ids=lambda k: "-".join(map(str, k)))
def test_reference_wide_fov_eye_inside(geometries, knobs):
    """An eye inside the domain with a 120-degree field of view on a
    diagonal view: tiles around the plane where the rays' march-axis
    component changes sign hold rays that march both ways."""
    cam = CameraParameters(eye=(0.4, 0.45, 0.5), look_at=(1.4, 1.35, 1.3),
                           up=(0, 1, 0), fov_y_degrees=120.0)
    fsr, inputs, kw = _case(geometries["3lvl"], knobs, cam)
    (gc, gd), (rc, rd) = _run_both(fsr, inputs, kw, dense=False)
    assert (np.asarray(rc)[:, 3] > 0).mean() > 0.05  # premise: a real frame
    assert_frames_close(gc.numpy(), gd.numpy(), rc, rd)


def test_scatter_tiles_drops_sentinel():
    """Pad steps carry tile_ids == num_tiles; the scatter drops them
    (indexing with the sentinel would raise) and uncovered tiles are
    background."""
    num_tiles = 4
    out_c = torch.arange(3 * 4 * 8 * 128, dtype=torch.float32).reshape(3, 4, 8, 128)
    out_d = torch.full((3, 8, 128), 7.0)
    ids = torch.tensor([2, num_tiles, 0], dtype=torch.int32)
    full_c, full_d = tm.scatter_tiles(out_c, out_d, ids, num_tiles)
    ref_c, ref_d = jtm.scatter_tiles(jnp.asarray(out_c.numpy()),
                                     jnp.asarray(out_d.numpy()),
                                     jnp.asarray(ids.numpy()), num_tiles)
    np.testing.assert_array_equal(full_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(full_d.numpy(), np.asarray(ref_d))
    assert torch.equal(full_c[2], out_c[0]) and torch.equal(full_c[0], out_c[2])
    assert (full_c[[1, 3]] == 0).all() and torch.isinf(full_d[[1, 3]]).all()


def test_sentinel_steps_render_background(geometries):
    """A compacted grid padded with sentinel steps (empty lists) renders
    those steps as background and the live steps unchanged."""
    fsr, inputs, kw = _case(geometries["r2"], KNOBS[0], None, size=48)
    num_tiles = (fsr.pad_w // 32) * (fsr.pad_h // 32)
    t = lambda a: torch.from_numpy(np.array(a))
    base = (t(fsr._packed_vol), t(inputs["meta"]), t(inputs["dims"]),
            t(fsr._lut_device), t(inputs["cam"]))
    items = (t(inputs["bricks"]), t(inputs["owners"]), t(inputs["item_bounds"]))
    c0, d0 = tm.tilemarch_render(*base, t(inputs["offsets"]), *items,
                                 t(inputs["tile_ids"]), **kw)
    off = np.concatenate([inputs["offsets"], np.repeat(inputs["offsets"][-1:], 2)])
    ids = np.concatenate([inputs["tile_ids"], [num_tiles, num_tiles]]).astype(np.int32)
    c1, d1 = tm.tilemarch_render(*base, t(off), *items, t(ids), **kw)
    assert torch.equal(c1[:-2], c0) and torch.equal(d1[:-2], d0)
    assert (c1[-2:] == 0).all() and torch.isinf(d1[-2:]).all()


def test_numerics_reproduce_xla_cpu():
    """exp and rsqrt as XLA compiles them for this CPU, bit for bit, on the
    ranges the kernel feeds them (exp: q * log(1 - alpha) <= 0; rsqrt:
    squared ray-direction lengths around 1).  XLA flushes subnormal exp
    results (below -87.33) to zero, which ``1 - exp`` cannot see, so the
    exp range stops there."""
    rng = np.random.default_rng(3)
    x = np.concatenate([-np.logspace(-8, np.log10(87.3), 20000), [0.0, -87.0]])
    x = x.astype(np.float32)
    ref = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(numerics.exp(torch.from_numpy(x)).numpy(), ref)
    y = rng.uniform(0.25, 4.0, 20000).astype(np.float32)
    ref = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(y)))
    np.testing.assert_array_equal(numerics.rsqrt(torch.from_numpy(y)).numpy(), ref)
    a, b, c = (rng.standard_normal(1000).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))  # contracted
    np.testing.assert_array_equal(
        numerics.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy(), ref)


def test_wrapper_checks_device_and_args():
    vol = torch.zeros((1, 32, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tm.tilemarch_render(vol, *([vol] * 7), width=32, height=32, max_slices=32)
    with pytest.raises(ValueError, match="multiple of the tile"):
        tm.tilemarch_reference(*([torch.zeros(1)] * 8), width=40, height=32,
                               max_slices=32)
