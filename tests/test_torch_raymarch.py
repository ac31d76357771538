"""The port's raymarch oracle (amrvolumerenderer_torch/ops/raymarch.py and
the routes over it) against the JAX package on the CPU.

The JAX side is its XLA program (``render_brick_bucket`` jitted on the
CPU); inputs are seeded NumPy arrays or the same scenes through both
packages' host prep.  Every comparison is bit for bit (max |diff| 0, same
non-finite pattern), except the golden row, held at the manifest's 2e-6
(measured: 0).  Covered: the JAX package's own oracle cases
(tests/test_raymarch.py), seeded buckets over every transform flag,
non-square frames and fields of view whose ``tan`` the C library rounds
off the nearest float32, ``max_steps_for_bucket``, ``build_brick_buckets``,
the layered ``render_layers``, whole frames through ``render_scene``, the
CLI and ``api.render``, and ``render_and_composite_sharded`` over 2 and 8
shards, whose JAX program folds the camera.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu import driver as jax_driver
from amrvolumerenderer_tpu.camera import camera_basis as jax_camera_basis
from amrvolumerenderer_tpu.ops import raymarch as jax_rm
from amrvolumerenderer_tpu.parallel import directsend as jds
from amrvolumerenderer_tpu.renderer import _build_camera_arrays as jax_camera_arrays
from amrvolumerenderer_tpu.renderer import render_layers as jax_render_layers
from amrvolumerenderer_tpu.renderer import render_scene as jax_render_scene
from amrvolumerenderer_tpu.scene import assign_owners as jax_assign_owners
from amrvolumerenderer_tpu.scene import build_brick_buckets as jax_buckets
from amrvolumerenderer_tpu.types import CameraParameters as JaxCamera
from amrvolumerenderer_torch import api, driver, renderer
from amrvolumerenderer_torch.camera import auto_orbit_camera, camera_basis
from amrvolumerenderer_torch.colormap import build_color_table
from amrvolumerenderer_torch.compositor import composite_layers_host
from amrvolumerenderer_torch.ops import numerics
from amrvolumerenderer_torch.ops import raymarch as rm
from amrvolumerenderer_torch.parallel import directsend as ds
from amrvolumerenderer_torch.scene import assign_owners, build_brick_buckets
from amrvolumerenderer_torch.state import geometry_from
from amrvolumerenderer_torch.types import CameraParameters, RenderParameters

from tests.conftest import make_r2_scene_data
from test_torch_worklist import as_jax, one_torch_thread, port_levels  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "manifest_pixels.npz")
CPU = torch.device("cpu")
SIMPLE = dict(eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.5), up=(0.0, 1.0, 0.0),
              fov_y_degrees=45.0, near_plane=0.1, far_plane=10.0)


def assert_same(got, ref, atol=0.0):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=atol)


def both_buckets(data, bmin, bmax, dims, lut, step, camera, width, height,
                 scalars=(0.0, 1.0, 0.0, 0.0, 1.0), log_scale=False,
                 normalize=False, clip_start=1.0, apply_clip=False):
    """One bucket through the JAX function and the port's; returns
    ((jax colors, depths), (port colors, depths)) as NumPy arrays."""
    forward, right, up = jax_camera_basis(JaxCamera(**camera))
    num_steps = rm.max_steps_for_bucket(bmin, bmax, step)
    kw = dict(width=width, height=height, num_steps=num_steps,
              log_scale=log_scale, normalize=normalize, clip_start=clip_start,
              apply_clip=apply_clip)
    basis = [np.asarray(v, np.float32) for v in (camera["eye"], forward, right, up)]
    jc, jd = jax_rm.render_brick_bucket(
        *(jnp.asarray(a) for a in (data, bmin, bmax, dims, lut, step)),
        *(jnp.asarray(v) for v in basis), jnp.float32(camera["fov_y_degrees"]),
        *(jnp.float32(v) for v in scalars), **kw)
    pc, pd = rm.render_bucket_impl(
        data, bmin, bmax, dims, lut, step, *basis, camera["fov_y_degrees"],
        *(float(np.float32(v)) for v in scalars), **kw)
    assert pc.device == CPU
    return (np.asarray(jc), np.asarray(jd)), (pc.numpy(), pd.numpy())


def one_brick(data, bmin, bmax, lut, step, width, height):
    return both_buckets(
        data[None].astype(np.float32), np.asarray([bmin], np.float32),
        np.asarray([bmax], np.float32), np.asarray([data.shape], np.int32),
        lut[None], np.asarray([step], np.float32), SIMPLE, width, height)


def test_matches_jax_on_the_oracle_case():
    """tests/test_raymarch.py::test_kernel_matches_scalar_oracle's bucket."""
    rng = np.random.default_rng(7)
    data = rng.uniform(0.0, 1.0, size=(8, 8, 8)).astype(np.float32)
    lut = np.zeros((256, 4), dtype=np.float32)
    lut[:, 0] = np.linspace(0, 1, 256)
    lut[:, 1] = 0.3
    lut[:, 3] = np.linspace(0.02, 0.4, 256)
    (jc, jd), (pc, pd) = one_brick(data, (0, 0, 0), (1, 1, 1), lut, 0.0625, 16, 16)
    assert (jc[0, :, 3] > 0).mean() > 0.3
    assert_same(pc, jc)
    assert_same(pd, jd)


def test_miss_rays_are_empty():
    data = np.ones((4, 4, 4), dtype=np.float32)
    lut = np.ones((256, 4), dtype=np.float32)
    (jc, jd), (pc, pd) = one_brick(data, (5.0, 5.0, 0.0), (5.2, 5.2, 0.2), lut,
                                   0.05, 8, 8)
    assert np.all(pc[..., 3] == 0.0) and np.all(np.isinf(pd))
    assert_same(pc, jc)
    assert_same(pd, jd)


def test_opaque_box_saturates():
    data = np.ones((4, 4, 4), dtype=np.float32)
    lut = np.zeros((256, 4), dtype=np.float32)
    lut[:, 0] = 1.0
    lut[:, 3] = 1.0
    (jc, jd), (pc, pd) = one_brick(data, (0, 0, 0), (1, 1, 1), lut, 0.125, 8, 8)
    center = 4 * 8 + 4
    assert pc[0, center, 3] == pytest.approx(1.0)
    assert pc[0, center, 0] == pytest.approx(1.0)
    assert pd[0, center] == pytest.approx(2.0, abs=0.05)
    assert_same(pc, jc)
    assert_same(pd, jd)


def test_empty_lut_accumulates_nothing():
    data = np.ones((4, 4, 4), dtype=np.float32)
    lut = np.zeros((256, 4), dtype=np.float32)
    (jc, jd), (pc, pd) = one_brick(data, (0, 0, 0), (1, 1, 1), lut, 0.125, 8, 8)
    assert np.all(pc == 0.0) and np.all(np.isinf(pd))
    assert_same(pc, jc)
    assert_same(pd, jd)


# fovs 11.628 and 10.074: glibc's tanf and the float32 nearest to tan differ
@pytest.mark.parametrize("case", [
    dict(seed=0, size=(16, 16), fov=45.0, flags=(True, True, True)),
    dict(seed=1, size=(24, 16), fov=11.628, flags=(True, True, True)),
    dict(seed=2, size=(40, 32), fov=30.0, flags=(False, True, True)),
    dict(seed=3, size=(33, 17), fov=60.0, flags=(False, False, False)),
    dict(seed=4, size=(32, 24), fov=10.074, flags=(True, False, False)),
    dict(seed=5, size=(32, 32), fov=45.0, flags=(True, True, True), inside=True),
], ids=lambda c: f"seed{c['seed']}")
def test_seeded_bucket_matches_jax(case):
    """Seeded buckets of 4 bricks with cropped cell counts, per-brick LUTs
    and steps, every transform flag, and an eye inside a box."""
    rng = np.random.default_rng(case["seed"])
    nb, shape = 4, (12, 10, 9)
    data = (rng.random((nb,) + shape) * 2.0 + 0.01).astype(np.float32)
    data[0, 0, 0, 0] = np.nan
    data[1, 1, 1, 1] = -np.inf
    bmin = rng.uniform(-0.2, 0.6, (nb, 3)).astype(np.float32)
    bmax = (bmin + rng.uniform(0.25, 0.7, (nb, 3))).astype(np.float32)
    dims = np.array([[12 - rng.integers(0, 3), 10, 9 - rng.integers(0, 2)]
                     for _ in range(nb)], np.int32)
    lut = rng.random((nb, 256, 4)).astype(np.float32)
    lut[..., 3] *= 0.3
    step = rng.uniform(0.01, 0.04, nb).astype(np.float32)
    eye = (0.5, 0.55, 0.45) if case.get("inside") else (1.6, 1.2, 1.9)
    camera = dict(SIMPLE, eye=eye, fov_y_degrees=case["fov"])
    log_scale, normalize, apply_clip = case["flags"]
    width, height = case["size"]
    (jc, jd), (pc, pd) = both_buckets(
        data, bmin, bmax, dims, lut, step, camera, width, height,
        scalars=(0.0, 1.3, 0.05, -1.0, 0.7), log_scale=log_scale,
        normalize=normalize, clip_start=0.8, apply_clip=apply_clip)
    assert (jc[..., 3] > 0).mean() > 0.02
    assert_same(pc, jc)
    assert_same(pd, jd)


def test_pair_batches_and_early_exit_change_nothing(monkeypatch):
    """A pair budget smaller than one brick's hits and a test for finished
    rays after every step give the same layers."""
    rng = np.random.default_rng(11)
    data = rng.random((3, 8, 8, 8)).astype(np.float32)
    bmin = np.array([[0, 0, 0], [0.3, 0.2, 0.1], [-0.2, 0.4, 0.3]], np.float32)
    bmax = bmin + np.float32(0.6)
    dims = np.full((3, 3), 8, np.int32)
    lut = rng.random((3, 128, 4)).astype(np.float32)
    step = np.full(3, 0.02, np.float32)
    args = (data, bmin, bmax, dims, lut, step, SIMPLE, 24, 24)
    _, (pc, pd) = both_buckets(*args)
    monkeypatch.setattr(rm, "PAIR_BUDGET", 37)
    monkeypatch.setattr(rm, "_CHECK_EVERY", 1)
    (jc, jd), (qc, qd) = both_buckets(*args)
    assert_same(qc, pc)
    assert_same(qd, pd)
    assert_same(qc, jc)
    assert_same(qd, jd)


def test_max_steps_and_buckets_match_jax():
    rng = np.random.default_rng(3)
    mins = rng.uniform(-1, 1, (7, 3))
    maxs = mins + rng.uniform(0.01, 2, (7, 3))
    steps = rng.uniform(0.001, 0.1, 7).astype(np.float32)
    steps[2] = 0.0
    assert rm.max_steps_for_bucket(mins, maxs, steps) == \
        jax_rm.max_steps_for_bucket(mins, maxs, steps)
    assert rm.max_steps_for_bucket(mins[:0], maxs[:0], steps[:0]) == 1

    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    boxes = [LevelBox(rng.random(s), np.array(lo)) for s, lo in (
        ((8, 8, 8), (0, 0, 0)), ((7, 8, 6), (8, 0, 0)), ((8, 8, 8), (0, 8, 0)),
        ((5, 3, 8), (8, 8, 0)))]
    jax_geometry = jax_api.load_amr_geometry(
        jax_api.AmrData(level_data=[boxes], level_geometry=[
            LevelGeometry(np.zeros(3), np.full(3, 1 / 16))]),
        0, -1, 0, False, True, verbose=False)
    jax_assign_owners(jax_geometry, 3)
    geometry = geometry_from(jax_geometry)
    assign_owners(geometry, 3)
    for granularity in (1, 4):
        got = build_brick_buckets(geometry.bricks, granularity)
        want = jax_buckets(jax_geometry.bricks, granularity)
        assert len(got) == len(want) == (3 if granularity == 1 else 2)
        for g, w in zip(got, want):
            for name in ("data", "min_corner", "max_corner", "cell_dims",
                         "owners", "brick_indices"):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
                assert getattr(g, name).dtype == getattr(w, name).dtype


def test_golden_row_raymarch(tmp_path):
    """api.render(render_method="raymarch") reproduces ``raymarch-1dev``."""
    levels, geoms = port_levels(*make_r2_scene_data(16, 8))
    with numerics.seed_rsqrt():  # the row's rsqrt model
        image, _ = api.render(
            api.AmrData(level_data=levels, level_geometry=geoms),
            api.RenderOptions(width=48, height=48, render_method="raymarch",
                              device="cpu", output_filename=str(tmp_path / "r.ppm")),
            verbose=False)
    assert_same(image.pixels, np.load(GOLDEN)["raymarch-1dev"], atol=2e-6)


@pytest.fixture(scope="module")
def r2_scene():
    """(JAX geometry, the port's copy) of the 32^3 r^2 scene in 8 bricks."""
    levels, geoms = make_r2_scene_data(32, 16)
    g = jax_api.load_amr_geometry(
        jax_api.AmrData(level_data=levels, level_geometry=geoms),
        0, -1, 0, False, True, verbose=False)
    return g, geometry_from(g)


def test_render_layers_matches_jax(r2_scene):
    jax_geometry, geometry = r2_scene
    params = RenderParameters(width=40, height=28, box_transparency=0.2)
    camera = CameraParameters(eye=(1.9, 1.3, 2.4), look_at=(0.5, 0.5, 0.5),
                              up=(0, 1, 0), fov_y_degrees=37.0)
    bounds = renderer.compute_global_bounds(geometry)
    rsd = renderer.compute_reference_sample_distance(geometry, bounds)
    srange = geometry.scalar_range
    got = renderer.render_layers(geometry, params, camera, bounds, srange, rsd,
                                 40, 28, None, method="raymarch", device=CPU)
    want = jax_render_layers(jax_geometry, as_jax(params), as_jax(camera),
                             as_jax(bounds), srange, rsd, 40, 28, None,
                             method="raymarch")
    assert (want[0][..., 3] > 0).any(axis=0).mean() > 0.3
    for g, w in zip(got, want):
        assert_same(g, w)
    with pytest.raises(ValueError, match="no layered route"):
        renderer.render_layers(geometry, params, camera, bounds, srange, rsd,
                               40, 28, None, method="tilemarch", device=CPU)


@pytest.mark.parametrize("aa", [1, 4])
def test_render_scene_matches_jax(r2_scene, aa):
    """The layered route end to end: layers, the fold on the device, the
    host AA downsample and the overlay."""
    jax_geometry, geometry = r2_scene
    params = RenderParameters(width=36, height=30, antialiasing=aa,
                              render_method="raymarch")
    got, _ = renderer.render_scene("", params, geometry, verbose=False,
                                   device=CPU)
    want, _ = jax_render_scene("", as_jax(params), jax_geometry, verbose=False)
    assert (want.pixels[:, 3] > 0).mean() > 0.2
    assert_same(got.pixels, want.pixels)


def test_log_scale_raymarch_matches_jax_and_slicemarch(r2_scene):
    """tests/test_api.py:181: log scale through the oracle's per-sample
    transform against the slice-march pre-transform, within the
    cross-integrator tolerance; the oracle itself equals JAX's."""
    levels, geoms = make_r2_scene_data(32, 16)
    for box in levels[0]:
        box.data = box.data + 0.05
    jax_geometry = jax_api.load_amr_geometry(
        jax_api.AmrData(level_data=levels, level_geometry=geoms),
        0, -1, 0, True, True, verbose=False)
    geometry = geometry_from(jax_geometry)
    params = RenderParameters(width=40, height=40)
    ray, _ = renderer.render_scene("", params, geometry, verbose=False,
                                   method="raymarch", device=CPU)
    slab, _ = renderer.render_scene("", params, geometry, verbose=False,
                                    method="slicemarch", device=CPU)
    want, _ = jax_render_scene("", as_jax(params), jax_geometry, verbose=False,
                               method="raymarch")
    assert_same(ray.pixels, want.pixels)
    diff = np.abs(ray.pixels[:, :4] - slab.pixels[:, :4])
    assert diff.mean() < 0.015
    assert (diff > 0.02).any(axis=-1).mean() <= 0.12


def test_cli_and_api_render_raymarch_like_jax(tmp_path):
    """``--render-method raymarch`` and render(render_method="raymarch")
    write the JAX CLI's bytes; trilinear sampling is refused as in JAX."""
    from amrvolumerenderer_tpu.plotfile import write_plotfile
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    import amrvolumerenderer_torch

    c = np.arange(16) / 15
    field = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    plotfile = str(tmp_path / "plt00000")
    write_plotfile(plotfile, [[LevelBox(field[i:i + 8], np.array([i, 0, 0]))
                               for i in (0, 8)]],
                   [LevelGeometry(np.zeros(3), np.full(3, 1 / 16))])
    flags = ["--width", "40", "--height", "32", "--antialiasing", "4",
             "--render-method", "raymarch"]
    got, api_out, want = (str(tmp_path / n) for n in ("p.ppm", "a.ppm", "j.ppm"))
    assert driver.main([*flags, "--device", "cpu", "--output", got, plotfile]) == 0
    assert jax_driver.main([*flags, "--output", want, plotfile]) == 0
    assert amrvolumerenderer_torch.render(
        plotfile, width=40, height=32, antialiasing=4, output=api_out,
        render_method="raymarch", device="cpu") == 0
    expected = open(want, "rb").read()
    assert open(got, "rb").read() == expected
    assert open(api_out, "rb").read() == expected
    with pytest.raises(ValueError, match="requires the slicemarch"):
        renderer.resolve_render_method("raymarch", "trilinear")
    with pytest.raises(ValueError, match="single-device"):
        amrvolumerenderer_torch.render(
            plotfile, width=16, height=16, output=got, devices=2,
            render_method="raymarch", device="cpu")


def owned_r2_geometry(num_devices):
    """The port's r^2 scene of 8 bricks, owned round-robin by the
    shards."""
    levels, geoms = port_levels(*make_r2_scene_data(32, 16))
    geometry = api.load_amr_geometry(
        api.AmrData(level_data=levels, level_geometry=geoms), 0, -1, 0, False,
        True, verbose=False)
    assign_owners(geometry, num_devices)
    return geometry


def sharded_tables(geometry, num_devices, camera, srange, rsd):
    """The padded per-shard brick table of tests/test_parallel.py's
    raymarch pipeline test (bricks owned round-robin)."""
    from amrvolumerenderer_torch.camera import compute_box_depth_hint

    bricks = geometry.bricks
    bmax = max(sum(1 for b in bricks if b.owner == d) for d in range(num_devices))
    shape = bricks[0].cell_dimensions
    total = num_devices * bmax
    t = dict(data=np.zeros((total,) + shape, np.float32),
             min=np.zeros((total, 3), np.float32), max=np.ones((total, 3), np.float32),
             dims=np.ones((total, 3), np.int32),
             lut=np.zeros((total, 256, 4), np.float32),
             step=np.full(total, 1.0, np.float32), valid=np.zeros(total, bool),
             hints=np.full(total, np.inf, np.float32))
    count = [0] * num_devices
    for b in bricks:
        slot = b.owner * bmax + count[b.owner]
        count[b.owner] += 1
        sample_distance = max(b.min_spacing() * 0.5, 1e-5)
        t["data"][slot] = b.data
        t["min"][slot], t["max"][slot] = b.min_corner, b.max_corner
        t["dims"][slot] = b.cell_dimensions
        t["step"][slot] = sample_distance
        t["lut"][slot] = build_color_table(1.0, sample_distance / rsd, srange, None)
        t["valid"][slot] = True
        t["hints"][slot] = compute_box_depth_hint(b.min_corner, b.max_corner, camera)
    return [t[k] for k in ("data", "min", "max", "dims", "lut", "step", "valid",
                           "hints")]


@pytest.mark.parametrize("num_devices,fov", [(2, 45.0), (8, 60.0), (8, 11.628)])
def test_render_and_composite_sharded_matches_jax(num_devices, fov):
    """The raymarch sharded frame against JAX's on the CPU mesh, with the
    camera its program folds; ``transport="ubyte"`` equals the port's
    byte exchange of the same layers."""
    geometry = owned_r2_geometry(num_devices)
    width, height = 32, 24
    camera = CameraParameters(eye=(1.7, 1.3, 2.1), look_at=(0.5, 0.5, 0.5),
                              up=(0, 1, 0), fov_y_degrees=fov)
    bounds = renderer.compute_global_bounds(geometry)
    rsd = renderer.compute_reference_sample_distance(geometry, bounds)
    srange = geometry.scalar_range
    tables = sharded_tables(geometry, num_devices, camera, srange, rsd)
    t = geometry.scalar_transform
    num_steps = rm.max_steps_for_bucket(tables[1], tables[2], tables[5])
    scalars = (camera.fov_y_degrees, srange[0], 1.0 / (srange[1] - srange[0]),
               (t.positive_floor, t.normalization_min, t.inverse_normalization_span))
    kw = dict(width=width, height=height, num_steps=num_steps,
              log_scale=t.log_scale_input, normalize=t.normalize_to_unit_range,
              clip_start=1.0, apply_clip=False)
    want = np.asarray(jds.render_and_composite_sharded(
        jds.make_mesh(num_devices), *(jnp.asarray(a) for a in tables),
        jax_camera_arrays(as_jax(camera)), *scalars, **kw))
    forward, right, up = camera_basis(camera)
    cams = [np.asarray(v, np.float32) for v in (camera.eye, forward, right, up)]
    mesh = ds.make_mesh(num_devices, "cpu")
    got = ds.render_and_composite_sharded(mesh, *tables, cams, *scalars, **kw)
    assert len(got) == num_devices
    assert (want[:, 3] > 0).mean() > 0.15
    assert_same(np.concatenate([g.numpy() for g in got]), want)

    colors, depths = rm.render_bucket_impl(
        *tables[:6], *cams, camera.fov_y_degrees, float(np.float32(srange[0])),
        float(np.float32(scalars[2])), *(float(np.float32(v)) for v in scalars[3]),
        fold_camera=True, **kw)
    layers = torch.cat([colors, depths[..., None]], dim=-1)
    layers[~torch.from_numpy(tables[6])] = torch.tensor([0, 0, 0, 0, np.inf])
    hints = np.where(tables[6], tables[7], np.inf).astype(np.float32)
    ubyte = ds.render_and_composite_sharded(mesh, *tables, cams, *scalars,
                                            transport="ubyte", **kw)
    ref = ds.composite_layers_sharded(mesh, layers, hints, transport="ubyte")
    for g, r in zip(ubyte, ref):
        assert_same(g, r)


def test_sharded_raymarch_equals_host_fold():
    """Over 8 shards the frame equals the one-device layers folded by the
    host oracle (composite_layers_host) within the JAX test's 2e-5 (the
    folded camera may move a sample)."""
    geometry = owned_r2_geometry(8)
    params = RenderParameters(width=32, height=32)
    bounds = renderer.compute_global_bounds(geometry)
    camera = auto_orbit_camera(bounds)
    rsd = renderer.compute_reference_sample_distance(geometry, bounds)
    srange = geometry.scalar_range
    layers, hints, owners, local = renderer.render_layers(
        geometry, params, camera, bounds, srange, rsd, 32, 32, None,
        method="raymarch", device=CPU)
    expected = composite_layers_host(layers, hints, owners, local)
    tables = sharded_tables(geometry, 8, camera, srange, rsd)
    t = geometry.scalar_transform
    forward, right, up = camera_basis(camera)
    got = ds.render_and_composite_sharded(
        ds.make_mesh(8, "cpu"), *tables,
        [np.asarray(v, np.float32) for v in (camera.eye, forward, right, up)],
        camera.fov_y_degrees, srange[0], 1.0 / (srange[1] - srange[0]),
        (t.positive_floor, t.normalization_min, t.inverse_normalization_span),
        width=32, height=32,
        num_steps=rm.max_steps_for_bucket(tables[1], tables[2], tables[5]),
        log_scale=t.log_scale_input, normalize=t.normalize_to_unit_range,
        clip_start=1.0, apply_clip=False)
    np.testing.assert_allclose(np.concatenate([g.numpy() for g in got]),
                               expected, atol=2e-5)
