"""The port's persistent multi-device renderer
(amrvolumerenderer_torch/parallel/persistent.py) and run pre-blend
exchange (parallel/directsend.py) against the JAX package on the 8
virtual CPU devices of tests/conftest.py.

Both packages build their renderers from one seeded scene, so their host
tables are byte-identical; the JAX side runs its Pallas kernels in
interpret mode.  Every frame comparison holds the manifest's atol of 2e-6
with the same non-finite pattern (measured: bit for bit).  Covered: the
host run plan, the runs-mode fold's plain version against JAX's
``_preblend_runs`` (an all-invalid shard, chunks folded with ``carry``),
the pre-blend exchange in both transports, the Morton placement, the
golden rows ``persistent-8dev-*``, a mirror of each case of
tests/test_persistent_multichip.py, the persistent and transport dry runs
of __graft_entry__.py, and multi-device orbits through ``render_orbit``,
``render`` and the CLI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu import renderer as jax_renderer
from amrvolumerenderer_tpu.parallel import directsend as jds
from amrvolumerenderer_tpu.parallel import persistent as jp
from amrvolumerenderer_tpu.types import color_map_from_tuples as jax_color_map_from_tuples
from amrvolumerenderer_torch import driver, renderer
from amrvolumerenderer_torch import render as port_render
from amrvolumerenderer_torch.camera import auto_orbit_camera
from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
from amrvolumerenderer_torch.image import color_to_byte
from amrvolumerenderer_torch.ops import composite as comp
from amrvolumerenderer_torch.ops import numerics
from amrvolumerenderer_torch.parallel import directsend as ds
from amrvolumerenderer_torch.parallel import persistent as pp
from amrvolumerenderer_torch.parallel.persistent import MultiChipSceneRenderer
from amrvolumerenderer_torch.state import geometry_from
from amrvolumerenderer_torch.types import (
    CameraParameters,
    RenderParameters,
    color_map_from_tuples,
)

from tests.conftest import make_r2_scene_data
from test_torch_worklist import as_jax, one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "manifest_pixels.npz")
ATOL = 2e-6
SIDE = CameraParameters(eye=(3.1, 0.5, 0.4), look_at=(0.5, 0.5, 0.5),
                        up=(0, 1, 0))  # another march axis than the orbit's


def assert_matches(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=ATOL)


def load(levels, geoms):
    g = jax_api.load_amr_geometry(
        jax_api.AmrData(level_data=levels, level_geometry=geoms),
        0, -1, 0, False, True, verbose=False)
    return g, geometry_from(g)


def grid_levels(n, brick, radius, width, column=False):
    """A shell field in 8^3-style bricks: a ``n``^3 grid, or (``column``)
    ``n`` bricks in a 1-D column along x (__graft_entry__.py:274-300)."""
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    if column:
        cx = (np.arange(n * brick) + 0.5) / (n * brick)
        cy = (np.arange(brick) + 0.5) / brick
        f = np.exp(-((cx[:, None, None] - 0.5) ** 2 + (cy[None, :, None] - 0.5) ** 2
                     + (cy[None, None, :] - 0.5) ** 2) / 0.05)
        boxes = [LevelBox(f[i * brick:(i + 1) * brick], np.array([i * brick, 0, 0]))
                 for i in range(n)]
        cell = np.array([1.0 / (n * brick), 1.0 / brick, 1.0 / brick])
        return [boxes], [LevelGeometry(np.zeros(3), cell)]
    c = (np.arange(n) + 0.5) / n
    r = np.sqrt((c[:, None, None] - 0.5) ** 2 + (c[None, :, None] - 0.5) ** 2
                + (c[None, None, :] - 0.5) ** 2)
    f = np.exp(-((r - radius) / width) ** 2)
    boxes = [LevelBox(f[i:i + brick, j:j + brick, k:k + brick], np.array([i, j, k]))
             for i in range(0, n, brick) for j in range(0, n, brick)
             for k in range(0, n, brick)]
    return [boxes], [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]


@pytest.fixture(scope="module")
def scenes():
    """(JAX geometry, the port's copy): the golden r^2 scene, the r^2 scene
    of tests/test_persistent_multichip.py, its 216-piece deep-AMR grid and
    the 64-brick Morton column."""
    return {
        "golden": load(*make_r2_scene_data(16, 8)),
        "r2": load(*make_r2_scene_data()),
        "deep": load(*grid_levels(48, 8, 0.35, 0.1)),
        "column": load(*grid_levels(64, 8, 0, 0, column=True)),
    }


def pair(scenes, scene, width=32, height=32, num=8, **kw):
    """The JAX and the port's renderer of one scene and parameters."""
    jg, pg = scenes[scene]
    params = RenderParameters(width=width, height=height,
                              **{k: v for k, v in kw.items() if k == "antialiasing"})
    extra = {k: v for k, v in kw.items() if k != "antialiasing"}
    return (jp.MultiChipSceneRenderer(jg, as_jax(params), num_devices=num, **extra),
            MultiChipSceneRenderer(pg, params, num_devices=num, device="cpu", **extra))


@pytest.fixture(scope="module")
def r2_pair(scenes):
    """The 32x32 r^2 renderers and the JAX frames of the orbit and side
    cameras (float32)."""
    jr, pr = pair(scenes, "r2")
    cams = [auto_orbit_camera(pr.bounds), SIDE]
    want = [jr.render(as_jax(c), overlay=False) for c in cams]
    return jr, pr, cams, want


# ---- the host run plan ------------------------------------------------------


@pytest.mark.parametrize("num,lmax,seed", [(2, 1, 0), (4, 5, 1), (8, 6, 2), (8, 3, 3)])
def test_preblend_plan_matches_jax(num, lmax, seed):
    """Seeded [D, Lmax] hints with ties, +inf padding, -inf heads and NaN,
    an all-invalid shard; the plan at its own and a forced rmax."""
    rng = np.random.default_rng(seed)
    hints = rng.integers(0, 6, (num, lmax)).astype(np.float32)
    hints[rng.random((num, lmax)) < 0.2] = np.inf
    hints[rng.random((num, lmax)) < 0.1] = -np.inf
    hints[rng.random((num, lmax)) < 0.1] = np.nan
    hints[num - 1] = np.inf  # a shard with no valid layer
    got, want = ds.preblend_plan(hints), jds.preblend_plan(hints)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    forced = got[3] + 4
    for g, w in zip(ds.preblend_plan(hints, rmax=forced),
                    jds.preblend_plan(hints, rmax=forced)):
        np.testing.assert_array_equal(g, w)


def test_preblend_plan_forced_rmax_error():
    hints = np.array([[0.0, 2.0, 4.0], [1.0, 3.0, 5.0]], np.float32)  # 3 runs each
    for plan in (ds.preblend_plan, jds.preblend_plan):
        with pytest.raises(ValueError, match="forced rmax=2 < required run depth 3"):
            plan(hints, rmax=2)


# ---- the runs-mode fold -----------------------------------------------------


def seeded_layers(rng, num, pixels):
    """[L, P, 5] layers with premultiplied colour, depth ties, an +inf
    depth (a miss), cleared layers and -0.0 colours."""
    a = rng.uniform(0, 1, (num, pixels)).astype(np.float32)
    c = rng.uniform(0, 1, (num, pixels, 3)).astype(np.float32) * a[..., None]
    d = rng.integers(0, 4, (num, pixels)).astype(np.float32)
    d[rng.random((num, pixels)) < 0.1] = np.inf
    layers = np.concatenate([c, a[..., None], d[..., None]], axis=-1)
    layers[rng.random((num, pixels)) < 0.1] = [0, 0, 0, 0, np.inf]
    layers[..., :4][rng.random((num, pixels, 4)) < 0.05] = -0.0
    return layers


@pytest.mark.parametrize("num,lmax,seed", [(4, 6, 0), (8, 5, 1), (2, 1, 2)])
def test_preblend_runs_matches_jax(num, lmax, seed):
    """Each shard's runs, plain version vs JAX's jitted ``_preblend_runs``
    on the plan of seeded hints (one shard all invalid), and folded in
    chunks with ``carry`` vs in one call."""
    rng = np.random.default_rng(seed)
    hints = rng.integers(0, 4, (num, lmax)).astype(np.float32)
    hints[rng.random((num, lmax)) < 0.2] = np.inf
    hints[0] = np.inf  # all invalid
    local_order, run_slot, _perm, rmax = ds.preblend_plan(hints)
    jax_runs = jax.jit(jds._preblend_runs, static_argnums=3)
    for d in range(num):
        layers = seeded_layers(rng, lmax, 96)
        want = np.asarray(jax_runs(jnp.asarray(layers), jnp.asarray(local_order[d]),
                                   jnp.asarray(run_slot[d]), rmax))
        t = torch.from_numpy(layers)
        got = comp.composite_runs_reference(
            t, torch.from_numpy(local_order[d]), torch.from_numpy(run_slot[d]), rmax)
        assert_matches(got.numpy(), want)
        # the same steps in chunks of 2, as the scan mode folds them
        order, slots, out = local_order[d], run_slot[d], None
        for c0 in range(0, lmax, 2):
            sel = order[c0:c0 + 2].astype(np.int64)
            out = comp.composite_runs_reference(
                t[sel], torch.arange(len(sel)), torch.from_numpy(slots[c0:c0 + 2]),
                rmax, out=out, carry=bool(c0 > 0 and slots[c0] == slots[c0 - 1]))
        np.testing.assert_array_equal(out.numpy(), got.numpy())
        assert composite_runs_cpu_is_plain(t, local_order[d], run_slot[d], rmax, got)


def composite_runs_cpu_is_plain(layers, order, slots, rmax, want) -> bool:
    """The wrapper on CPU tensors runs the plain version, no launch."""
    before = comp.composite_runs.launches
    got = comp.composite_runs(layers, torch.from_numpy(order), torch.from_numpy(slots),
                              rmax)
    return comp.composite_runs.launches == before and torch.equal(got, want)


@pytest.mark.parametrize("transport", ["float32", "ubyte"])
def test_composite_layers_sharded_preblend_matches_jax(transport):
    """Seeded layers and hints over 8 shards (runs of several layers, an
    all-invalid shard) through the pre-blend exchange, vs JAX."""
    rng = np.random.default_rng(7)
    num, lmax, pixels = 8, 4, 64
    layers = seeded_layers(rng, num * lmax, pixels)
    hints = np.sort(rng.integers(0, 10, num * lmax)).astype(np.float32)
    hints[lmax:2 * lmax] = np.inf
    layers[lmax:2 * lmax] = [0, 0, 0, 0, np.inf]
    want = np.asarray(jds.composite_layers_sharded_preblend(
        jds.make_mesh(num), jnp.asarray(layers), hints, transport))
    got = ds.composite_layers_sharded_preblend(ds.make_mesh(num, "cpu"), layers,
                                               hints, transport)
    assert_matches(np.concatenate([s.numpy() for s in got]), want)
    plain = ds.composite_layers_sharded(ds.make_mesh(num, "cpu"), layers, hints,
                                        transport)
    if transport == "float32":  # the same fold tree
        np.testing.assert_array_equal(np.concatenate([s.numpy() for s in plain]),
                                      np.concatenate([s.numpy() for s in got]))


def test_morton_order_matches_jax():
    rng = np.random.default_rng(3)
    lo = rng.uniform(0, 1, (40, 3))
    hi = lo + rng.uniform(0.01, 0.2, (40, 3))
    lo[5], hi[5] = lo[9], hi[9]  # coincident centres
    np.testing.assert_array_equal(pp._morton_order(lo, hi), jp._morton_order(lo, hi))
    flat = lo.copy()
    flat[:, 2] = 0.5  # a degenerate axis
    np.testing.assert_array_equal(pp._morton_order(flat, flat),
                                  jp._morton_order(flat, flat))


# ---- golden rows -------------------------------------------------------------


@pytest.mark.parametrize("row,force", [("persistent-8dev-preblend", True),
                                       ("persistent-8dev-plain", False)])
def test_golden_rows(scenes, row, force):
    """As scripts/generate_golden_manifest.py:78-92 renders them, under
    the rsqrt model the rows were rendered with."""
    r = MultiChipSceneRenderer(scenes["golden"][1],
                               RenderParameters(width=48, height=48),
                               num_devices=8, device="cpu")
    r._use_preblend = lambda rmax: force
    with numerics.seed_rsqrt():
        frame = r.render(auto_orbit_camera(r.bounds), overlay=False)
    assert_matches(frame, np.load(GOLDEN)[row])


# ---- mirrors of tests/test_persistent_multichip.py ---------------------------


def test_matches_jax_single_device_mesh_and_fast_scene(scenes, r2_pair):
    _jr, r8, cams, want = r2_pair
    r1 = MultiChipSceneRenderer(scenes["r2"][1], RenderParameters(width=32, height=32),
                                num_devices=1, device="cpu")
    fsr = FastSceneRenderer(scenes["r2"][1], RenderParameters(width=32, height=32),
                            device="cpu")
    for cam, ref in zip(cams, want):
        f8 = r8.render(cam, overlay=False)
        assert_matches(f8, ref)
        assert np.abs(f8[np.isfinite(f8)]).sum() > 0
        f1 = r1.render(cam, overlay=False)
        ft = fsr.render(cam, overlay=False)
        np.testing.assert_allclose(f8[:, :4], f1[:, :4], atol=1e-5)
        np.testing.assert_allclose(f8[:, :4], ft[:, :4], atol=1e-5)
        fin8, fint = np.isfinite(f8[:, 4]), np.isfinite(ft[:, 4])
        np.testing.assert_array_equal(fin8, fint)
        np.testing.assert_allclose(f8[fin8, 4], ft[fint, 4], atol=1e-5)


def test_resident_state_reused_across_frames(r2_pair, monkeypatch):
    """The port's counterpart of "compiled program reused": the placed
    tables are the same objects across frames of one axis, and no frame
    places them again."""
    _jr, _pr, cams, want = r2_pair
    r = MultiChipSceneRenderer(_pr.geometry, RenderParameters(width=32, height=32),
                               num_devices=8, device="cpu")
    a = r.render(cams[0], overlay=False)
    axis = next(iter(r._placed_cache))
    placed = (r._placed_vol(axis), r._placed_luts(), r._placed_tables(axis))
    calls = []
    real = ds.shard_leading
    monkeypatch.setattr(ds, "shard_leading", lambda *a: calls.append(1) or real(*a))
    b = r.render(cams[0], overlay=False)
    assert calls == []
    assert r._placed_vol(axis) is placed[0] and r._placed_luts() is placed[1]
    assert r._placed_tables(axis) is placed[2]
    np.testing.assert_array_equal(a, b)
    c = r.render(cams[1], overlay=False)  # another march axis: its tables once
    assert len(calls) == 1 and len(r._placed_cache) == 2
    assert_matches(c, want[1])


def test_transfer_function_swap(scenes, r2_pair):
    entries = [(0.0, 0, 0, 0, 0.0), (0.5, 1.0, 0.2, 0.1, 0.6), (1.0, 1.0, 1.0, 1.0, 0.9)]
    cam = r2_pair[2][0]
    jr, r = pair(scenes, "r2")
    r.render(cam, overlay=False)  # default map first
    r.set_transfer_function(color_map=color_map_from_tuples(entries))
    swapped = r.render(cam, overlay=False)
    fresh = MultiChipSceneRenderer(scenes["r2"][1], RenderParameters(width=32, height=32),
                                   num_devices=8, color_map=color_map_from_tuples(entries),
                                   device="cpu").render(cam, overlay=False)
    np.testing.assert_array_equal(swapped, fresh)
    jr.set_transfer_function(color_map=jax_color_map_from_tuples(entries))
    assert_matches(swapped, jr.render(as_jax(cam), overlay=False))


def test_update_data(scenes, r2_pair):
    jg, pg = scenes["r2"]
    _jr, _pr, cams, want = r2_pair
    r = MultiChipSceneRenderer(pg, RenderParameters(width=32, height=32),
                               num_devices=8, device="cpu")
    before = r.render(cams[0], overlay=False)
    assert_matches(before, want[0])
    r.update_data([0.5 * np.asarray(b.data) for b in pg.bricks])
    after = r.render(cams[0], overlay=False)
    assert not np.allclose(before[:, :4], after[:, :4])
    j = jp.MultiChipSceneRenderer(jg, as_jax(RenderParameters(width=32, height=32)),
                                  num_devices=8)
    j.update_data([0.5 * np.asarray(b.data) for b in jg.bricks])
    assert_matches(after, j.render(as_jax(cams[0]), overlay=False))
    r.update_data([np.asarray(b.data) for b in pg.bricks])
    np.testing.assert_array_equal(r.render(cams[0], overlay=False), before)


def test_ubyte_transport_matches_jax(scenes, r2_pair):
    jr, pr = pair(scenes, "r2", transport="ubyte")
    cam = r2_pair[2][0]
    got = pr.render(cam, overlay=False)
    assert_matches(got, jr.render(as_jax(cam), overlay=False))
    np.testing.assert_allclose(got[:, :4], r2_pair[3][0][:, :4], atol=2 / 255)


def test_antialiasing_matches_jax(scenes):
    jr, pr = pair(scenes, "r2", antialiasing=4)
    cam = auto_orbit_camera(pr.bounds)
    got = pr.render(cam, overlay=False)
    assert got.shape == (32 * 32, 5)
    assert_matches(got, jr.render(as_jax(cam), overlay=False))


def test_validation_errors(scenes):
    pg = scenes["r2"][1]
    params = RenderParameters(width=32, height=32)
    with pytest.raises(ValueError, match="device"):
        MultiChipSceneRenderer(pg, params, num_devices=99, device="cpu")
    with pytest.raises(ValueError, match="device"):
        MultiChipSceneRenderer(pg, params, num_devices=0, device="cpu")
    with pytest.raises(ValueError, match="transport"):
        MultiChipSceneRenderer(pg, params, num_devices=2, transport="f16",
                               device="cpu")
    r = MultiChipSceneRenderer(pg, params, num_devices=2, device="cpu")
    with pytest.raises(ValueError, match="overlay"):
        r.render_batch([], bytes_out=True, overlay=True)
    aa = MultiChipSceneRenderer(pg, RenderParameters(width=32, height=32,
                                                     antialiasing=4),
                                num_devices=2, device="cpu")
    with pytest.raises(ValueError, match="antialiasing"):
        aa.render_batch([], bytes_out=True, overlay=False)


def test_parameter_mutation_matches_jax(scenes, r2_pair):
    jr, pr = pair(scenes, "r2")
    cam = r2_pair[2][0]
    nearest = pr.render(cam, overlay=False)
    pr.parameters.sampling = "trilinear"
    jr.parameters.sampling = "trilinear"
    trilinear = pr.render(cam, overlay=False)
    assert np.abs(trilinear[:, :4] - nearest[:, :4]).max() > 1e-4
    assert_matches(trilinear, jr.render(as_jax(cam), overlay=False))


def test_placed_tables_per_shard(r2_pair):
    """Each shard's cached axis tables sit on its own device (the port's
    counterpart of a mesh-sharded cache)."""
    pr = r2_pair[1]
    pr.render(r2_pair[2][0], overlay=False)
    assert pr._meta_cache
    for meta, dims in pr._meta_cache.values():
        assert len(meta) == len(dims) == 8
        assert [m.device for m in meta] == list(pr.mesh.devices)
        assert sum(m.shape[0] for m in meta) == len(pr._slot_to_idx)


def test_render_batch_matches_per_frame(r2_pair, tmp_path):
    _jr, r, cams, want = r2_pair
    cams = [cams[0], cams[0], cams[1], cams[0]]  # axis change mid-batch
    batch = r.render_batch(cams, overlay=False,
                           output_pattern=str(tmp_path / "f_{:03d}.ppm"))
    assert batch.shape == (4, 32 * 32, 5)
    for i, cam in enumerate(cams):
        np.testing.assert_array_equal(batch[i], r.render(cam, overlay=False))
    assert_matches(batch[2], want[1])
    assert (tmp_path / "f_003.ppm").exists()
    stats = r.last_batch_stats
    assert stats["frames"] == 4
    assert stats["dispatch_count"] == 3  # [cam0, cam0], [cam1], [cam0]
    assert stats["readback_mb"] > 0


def test_render_batch_antialiased(scenes):
    r = MultiChipSceneRenderer(scenes["r2"][1],
                               RenderParameters(width=16, height=16, antialiasing=4),
                               num_devices=8, device="cpu")
    cams = [auto_orbit_camera(r.bounds)] * 2
    batch = r.render_batch(cams, overlay=False)
    assert batch.shape == (2, 16 * 16, 5)
    np.testing.assert_array_equal(batch[0], r.render(cams[0], overlay=False))
    np.testing.assert_array_equal(batch[0], batch[1])


def test_render_batch_bytes_out(r2_pair):
    r, cams, want = r2_pair[1], r2_pair[2], r2_pair[3]
    rgba = r.render_batch(cams, overlay=False, bytes_out=True)
    rgb = r.render_batch(cams, overlay=False, bytes_out="rgb")
    assert rgba.dtype == np.uint8 and rgba.shape == (2, 32 * 32, 4)
    assert rgb.dtype == np.uint8 and rgb.shape == (2, 32 * 32, 3)
    np.testing.assert_array_equal(rgb, rgba[..., :3])
    for i in range(2):
        np.testing.assert_array_equal(rgba[i], color_to_byte(want[i][:, :4]))


def test_render_batch_chunking(r2_pair):
    r, cam = r2_pair[1], r2_pair[2][0]
    batch = r.render_batch([cam] * 3, overlay=False, max_chunk_bytes=1)
    assert r.last_batch_stats["dispatch_count"] == 3
    for i in range(3):
        np.testing.assert_array_equal(batch[i], r2_pair[3][0])


def test_render_batch_empty(scenes):
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(scenes["r2"][1], params, num_devices=2, device="cpu")
    out = r.render_batch([], overlay=False)
    assert out.shape == (0, 32 * 32, 5) and out.dtype == np.float32
    fsr = FastSceneRenderer(scenes["r2"][1], params, device="cpu")
    out1 = fsr.render_batch([], overlay=False)
    assert out1.shape == (0, 32 * 32, 5) and out1.dtype == np.float32


@pytest.fixture(scope="module")
def deep_pair(scenes):
    """216 pieces over 8 shards (27 a shard: scan mode) at 32x32, with the
    JAX frame of the orbit camera."""
    jr, pr = pair(scenes, "deep")
    cam = auto_orbit_camera(pr.bounds)
    return pr, cam, jr.render(as_jax(cam), overlay=False)


def test_deep_amr_scan_mode_parity(scenes, deep_pair):
    """Scan mode (the layer stack never built) equals the stack mode bit
    for bit and the JAX scan-mode frame."""
    r8, cam, want = deep_pair
    assert r8._scan_pieces()
    f8 = r8.render(cam, overlay=False)
    assert_matches(f8, want)
    stack = MultiChipSceneRenderer(scenes["deep"][1], RenderParameters(width=32,
                                                                      height=32),
                                   num_devices=8, device="cpu")
    stack.scan_piece_threshold = 10_000
    assert not stack._scan_pieces()
    stack._use_preblend = lambda rmax: True
    np.testing.assert_array_equal(f8, stack.render(cam, overlay=False))
    stack._use_preblend = lambda rmax: False
    np.testing.assert_array_equal(f8, stack.render(cam, overlay=False))
    assert np.abs(f8[np.isfinite(f8)]).sum() > 0


def test_deep_amr_batch_scan_matches_per_frame(deep_pair):
    r, cam, want = deep_pair
    cams = [cam, SIDE]
    batch = r.render_batch(cams, overlay=False)
    assert_matches(batch[0], want)
    for i, c in enumerate(cams):
        np.testing.assert_array_equal(batch[i], r.render(c, overlay=False))


def test_preblend_cost_model_gate(scenes):
    """(lmax - rmax) * R > (lmax + rmax), as in the JAX package: real
    savings pre-blend, marginal ones do not, R = 1 never does; ubyte and
    scan mode always."""
    r = MultiChipSceneRenderer(scenes["r2"][1], RenderParameters(width=32, height=32),
                               num_devices=2, device="cpu")
    assert r.preblend_link_ratio == 4.5  # measured on the card (PERF.md)
    lmax = len(r._slot_to_idx) // r.num_devices
    assert lmax >= 2
    for ratio in (4.5, 18.0):
        r.preblend_link_ratio = ratio
        assert r._use_preblend(1)
        assert not r._use_preblend(lmax)
        marginal = lmax - 1
        assert r._use_preblend(marginal) == ((lmax - marginal) * ratio > lmax + marginal)
    r.preblend_link_ratio = 1.0
    assert not r._use_preblend(1)
    r.transport = "ubyte"
    assert r._use_preblend(lmax)
    r.transport = "float32"
    r.scan_piece_threshold = 0
    assert r._use_preblend(lmax)


# ---- __graft_entry__.py's dry runs -------------------------------------------


def test_dryrun_persistent(scenes):
    """dryrun_persistent (:189-225): two frames alike, placed tables kept,
    one batch chunk for both frames, equal to render."""
    r = MultiChipSceneRenderer(scenes["golden"][1], RenderParameters(width=32,
                                                                    height=32),
                               num_devices=8, device="cpu")
    cam = auto_orbit_camera(r.bounds)
    first = r.render(cam, overlay=False)
    placed = dict(r._placed_cache)
    second = r.render(cam, overlay=False)
    assert r._placed_cache.keys() == placed.keys()
    assert all(r._placed_cache[k] is v for k, v in placed.items())
    np.testing.assert_array_equal(first, second)
    assert np.abs(first[np.isfinite(first)]).sum() > 0.0
    batch = r.render_batch([cam, cam], overlay=False)
    np.testing.assert_array_equal(batch[0], first)
    np.testing.assert_array_equal(batch[1], first)
    assert r.last_batch_stats["dispatch_count"] == 1


def test_dryrun_transports(scenes):
    """dryrun_transports (a) and (b) (:274-314) on the 64-brick Morton
    column: the pre-blend activates at the JAX package's R = 18 and equals
    the raw layered exchange; scan mode equals it; all equal JAX."""
    jg, pg = scenes["column"]
    params = RenderParameters(width=32, height=32)
    r = MultiChipSceneRenderer(pg, params, num_devices=8, device="cpu")
    r.preblend_link_ratio = 18.0
    cam = auto_orbit_camera(r.bounds)
    _axis, _cam, slot_hints, slot_valid = r._frame_state(cam)
    rmax = ds.preblend_plan(r._effective_hints(slot_hints, slot_valid))[3]
    assert r._use_preblend(rmax)
    pre = r.render(cam, overlay=False)
    raw_r = MultiChipSceneRenderer(pg, params, num_devices=8, device="cpu")
    raw_r._use_preblend = lambda rmax: False
    np.testing.assert_array_equal(pre, raw_r.render(cam, overlay=False))
    scan_r = MultiChipSceneRenderer(pg, params, num_devices=8, device="cpu")
    scan_r.scan_piece_threshold = 4  # 8 pieces a shard: scan mode
    assert scan_r._scan_pieces()
    np.testing.assert_array_equal(scan_r.render(cam, overlay=False), pre)
    j = jp.MultiChipSceneRenderer(jg, as_jax(params), num_devices=8)
    assert j._use_preblend(rmax)
    assert_matches(pre, j.render(as_jax(cam), overlay=False))


# ---- multi-device orbits ------------------------------------------------------


@pytest.fixture(scope="module")
def plotfile(tmp_path_factory):
    from amrvolumerenderer_tpu.plotfile import write_plotfile

    levels, geoms = make_r2_scene_data(16, 8)
    path = str(tmp_path_factory.mktemp("plt") / "plt00000")
    write_plotfile(path, levels, geoms)
    return path


def test_orbits_over_devices_match_jax(tmp_path, scenes, plotfile):
    """render_orbit(devices=8), render(orbit_frames=, devices=) and the
    CLI's --devices 8 --orbit-frames 3 write the JAX orbit's frames."""
    jg, pg = scenes["golden"]
    params = RenderParameters(width=32, height=32, devices=8)
    jax_renderer.render_orbit(str(tmp_path / "jax_{:04d}.ppm"), as_jax(params), jg, 3,
                              verbose=False)
    renderer.render_orbit(str(tmp_path / "port_{:04d}.ppm"), params, pg, 3,
                          verbose=False, device="cpu")
    want = [(tmp_path / f"jax_{i:04d}.ppm").read_bytes() for i in range(3)]
    assert len(set(want)) == 3  # the camera moves
    for i in range(3):
        assert (tmp_path / f"port_{i:04d}.ppm").read_bytes() == want[i], i
    flags = ["--width", "32", "--height", "32", "--devices", "8", "--orbit-frames", "3"]
    assert driver.main(flags + ["--device", "cpu", "--output", str(tmp_path / "cli.ppm"),
                                plotfile]) == 0
    assert port_render(plotfile, width=32, height=32, devices=8, orbit_frames=3,
                       output=str(tmp_path / "api.ppm"), device="cpu") == 0
    geometry = driver.load_plotfile_geometry(plotfile, "", 0, -1, False, verbose=False)
    r = MultiChipSceneRenderer(geometry, RenderParameters(width=32, height=32),
                               num_devices=8, device="cpu")
    from amrvolumerenderer_torch.camera import orbit_camera_sequence

    frames = r.render_batch(orbit_camera_sequence(auto_orbit_camera(r.bounds), 3, 360.0))
    for i in range(3):
        cli = (tmp_path / f"cli_{i:04d}.ppm").read_bytes()
        assert cli == (tmp_path / f"api_{i:04d}.ppm").read_bytes()
        with open(tmp_path / f"cli_{i:04d}.ppm", "rb") as f:
            assert f.readline().strip() == b"P6"
            w, h = map(int, f.readline().split())
            f.readline()
            rgb = np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)
        np.testing.assert_array_equal(
            rgb, color_to_byte(frames[i][:, :4])[:, :3].reshape(h, w, 3)[::-1])
