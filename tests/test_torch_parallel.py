"""The port's one-shot multi-device render (amrvolumerenderer_torch/
parallel/directsend.py, renderer_fast.render_composited_sharded) against
the JAX package on the 8 virtual CPU devices of tests/conftest.py.

Inputs are seeded NumPy arrays or the two packages' own host prep of the
same scenes; the JAX side runs its Pallas kernels in interpret mode.  Every
comparison holds the manifest's atol of 2e-6 with the same non-finite
pattern (measured: bit for bit).  Covered: the dense slice-march kernel's
plain version (every knob set, ghost 0 and 1, a zero padding slot), the
run-grouped fold, ``all_to_all`` / ``all_gather``, the three exchanges in
float32 and ubyte, the host packers and coverage compaction, whole sharded
frames over both pipelines and transports (AA, a non-square frame, two
shards, a scene of more than 96 pieces on the tile-march pipeline), the
golden rows ``slicemarch-8dev-*`` through ``api.render(devices=8)`` and
the CLI's ``--devices``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu import compositor as jax_comp
from amrvolumerenderer_tpu import renderer_fast as jax_rf
from amrvolumerenderer_tpu.ops import slicemarch as jax_sm
from amrvolumerenderer_tpu.parallel import directsend as jds
from amrvolumerenderer_torch import api, compositor, driver, renderer, renderer_fast
from amrvolumerenderer_torch.camera import auto_orbit_camera
from amrvolumerenderer_torch.image import byte_to_color_device
from amrvolumerenderer_torch.ops import slicemarch as sm
from amrvolumerenderer_torch.parallel import directsend as ds
from amrvolumerenderer_torch.state import geometry_from
from amrvolumerenderer_torch.types import CameraParameters, RenderParameters

from tests.conftest import make_r2_scene_data
from test_torch_worklist import (  # noqa: F401
    as_jax,
    one_torch_thread,
    port_levels,
    three_level_geometry,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "manifest_pixels.npz")
ATOL = 2e-6
OBLIQUE = (-1.9, 2.3, -1.2)


def assert_matches(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=ATOL)


def gathered(shards):
    return np.concatenate([s.numpy() for s in shards])


def meshes(num):
    return jds.make_mesh(num), ds.make_mesh(num, "cpu")


@pytest.fixture(scope="module")
def scenes():
    """(JAX geometry, the port's copy) of the golden r^2 scene, bench.py's
    3-level scene and the 125-brick r^2 scene (more than 96 pieces)."""
    def r2(n_cells, box):
        levels, geoms = make_r2_scene_data(n_cells, box)
        g = jax_api.load_amr_geometry(
            jax_api.AmrData(level_data=levels, level_geometry=geoms),
            0, -1, 0, False, True, verbose=False)
        return g, geometry_from(g)

    g3 = three_level_geometry()
    return {"r2": r2(16, 8), "3lvl": (g3, geometry_from(g3)), "r2-125": r2(40, 8)}


def frame_args(geometry, knobs, eye, width, height):
    sampling, classification, lut_size = knobs
    params = RenderParameters(width=width, height=height, sampling=sampling,
                              classification=classification, lut_size=lut_size)
    bounds = renderer.compute_global_bounds(geometry)
    camera = (auto_orbit_camera(bounds) if eye is None else
              CameraParameters(eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)))
    return (params, camera, renderer.compute_global_scalar_range(geometry),
            renderer.compute_reference_sample_distance(geometry, bounds))


# ---- kernel 4: the dense slice march -------------------------------------

@pytest.mark.parametrize("scene,knobs,eye", [
    ("r2", ("nearest", "post", 256), None),
    ("3lvl", ("trilinear", "post", 256), OBLIQUE),
    ("3lvl", ("trilinear", "pre", 128), None),
], ids=["r2-nearest-ghost0", "3lvl-trilinear-post-ghost1", "3lvl-trilinear-pre-ghost1"])
def test_dense_reference_matches_jax_kernel(scenes, scene, knobs, eye):
    """Every (piece, tile) block, with a zero padding slot appended (dims
    and meta 0, as ``_pack_slots`` pads): it must come out as colour 0 and
    depth +inf on both sides."""
    jax_geometry, geometry = scenes[scene]
    params, camera, srange, rsd = frame_args(geometry, knobs, eye, 48, 48)
    prep = renderer_fast.prepare_slicemarch_scene(
        geometry, params, camera, srange, rsd, 48, 48, None)
    arrays = [np.concatenate([prep[k], np.zeros((1,) + prep[k].shape[1:],
                                                prep[k].dtype)])
              for k in ("vol", "meta", "dims", "luts")]
    kw = dict(width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
              logical_width=48, logical_height=48, sampling=params.sampling,
              ghost=prep["ghost"], classification=params.classification)
    jc, jd = jax_sm.slicemarch_render(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(prep["cam"]),
        interpret=True, **kw)
    before = sm.slicemarch_render.launches
    pc, pd = sm.slicemarch_render(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(prep["cam"]), **kw)
    assert sm.slicemarch_render.launches == before  # the CPU runs the plain version
    jc, jd = np.asarray(jc), np.asarray(jd)
    assert (jc[:-1, :, 3] > 0).any(axis=0).mean() > 0.1  # premise: a real frame
    # premise: some piece misses some tile entirely (the cull's case)
    tiles = jd[:-1].reshape(len(jd) - 1, -1, 1024)
    assert np.isinf(tiles).all(axis=2).any()
    assert_matches(pc.numpy(), jc)
    assert_matches(pd.numpy(), jd)
    assert (pc[-1] == 0).all() and torch.isinf(pd[-1]).all()
    assert (jc[-1] == 0).all() and np.isinf(jd[-1]).all()


def test_dense_wrapper_checks_device():
    vol = torch.zeros((1, 32, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sm.slicemarch_render(vol, *([vol] * 4), width=32, height=32, max_slices=32)


# ---- the run-grouped fold and the byte codec ------------------------------

def seeded_layers(rng, count, pixels):
    alpha = rng.uniform(0, 0.9, (count, pixels, 1)).astype(np.float32)
    rgb = rng.uniform(0, 1, (count, pixels, 3)).astype(np.float32) * alpha
    depth = rng.choice(np.array([0.5, 1.0, 2.0, np.inf], np.float32), (count, pixels, 1))
    return np.concatenate([rgb, alpha, depth], axis=-1)


def test_composite_sorted_runs_matches_jax():
    rng = np.random.default_rng(5)
    layers = seeded_layers(rng, 14, 256)
    owners = np.sort(rng.integers(0, 5, 14)).astype(np.int32)
    want = jax_comp._composite_sorted_runs(jnp.asarray(layers), jnp.asarray(owners))
    got = compositor._composite_sorted_runs(torch.from_numpy(layers),
                                            torch.from_numpy(owners))
    assert_matches(got.numpy(), want)
    # host-sorted form: hint ties and +-inf hints, owners interleaved
    hints = rng.choice(np.array([-np.inf, 0.1, 0.2, np.inf], np.float32), 14)
    owners = rng.integers(0, 4, 14).astype(np.int32)
    local = np.arange(14, dtype=np.int32)
    want = jax_comp.composite_layers_device(jnp.asarray(layers), hints, owners, local)
    got = compositor.composite_layers_device(torch.from_numpy(layers), hints,
                                             owners, local)
    assert_matches(got.numpy(), want)
    assert_matches(got.numpy(), compositor.composite_layers_host(
        layers, hints, owners, local))


@pytest.mark.parametrize("count,pixels", [(0, 40), (1, 40), (9, 2500)])
def test_composite_sorted_runs_tile_blocks_match_jax(count, pixels):
    """The fold is one pixel-mode composite call over any pixel count:
    fewer than 1024 pixels, a count that is not a multiple of 1024, one
    layer, and no layer at all (colour 0, depth +inf; JAX's loop needs a
    first layer)."""
    rng = np.random.default_rng(count)
    layers = seeded_layers(rng, count, pixels)
    owners = np.sort(rng.integers(0, 3, count)).astype(np.int32)
    if count:
        want = jax_comp._composite_sorted_runs(jnp.asarray(layers),
                                               jnp.asarray(owners))
    else:
        want = np.zeros((pixels, 5), np.float32)
        want[:, 4] = np.inf
    got = compositor._composite_sorted_runs(torch.from_numpy(layers),
                                            torch.from_numpy(owners))
    assert got.shape == (pixels, 5)
    assert_matches(got.numpy(), want)


def recorded_folds(monkeypatch):
    """Record every ``composite_pixels`` call (the folds' one entry)."""
    from amrvolumerenderer_torch.ops import composite as comp

    calls, fold = [], comp.composite_pixels

    def record(layers, order, owners_sorted):
        calls.append((layers, order, owners_sorted))
        return fold(layers, order, owners_sorted)

    monkeypatch.setattr(comp, "composite_pixels", record)
    return calls


def test_local_precomposite_reads_the_stack_in_place(monkeypatch):
    """Each shard's local fold is one fold call on the shard's own layer
    stack, here a rect slice whose layers are not adjacent in memory, with
    the stable argsort of its hints as the order (ties and +inf padding):
    no gathered copy, and the JAX fold of the gathered stack's pixels."""
    calls = recorded_folds(monkeypatch)
    num, slots = 2, 5
    mesh = ds.make_mesh(num, "cpu")
    rng = np.random.default_rng(23)
    frames = torch.from_numpy(seeded_layers(rng, num * slots, 12 * 10))
    stacks = [ds._slice_rect(frames[r * slots:(r + 1) * slots], (0, 1, 12, 9), 12, 10)
              for r in range(num)]
    hints = [torch.tensor([0.5, np.inf, 0.25, 0.5, 0.25], dtype=torch.float32),
             torch.tensor([1.0, 0.75, 1.0, np.inf, np.inf], dtype=torch.float32)]
    assert not stacks[0].is_contiguous()
    got = ds._local_precomposite(mesh, stacks, hints)
    assert len(calls) == num
    for r in range(num):
        layers, order, keys = calls[r]
        assert layers is stacks[r] and order.dtype == torch.int32
        want_order = np.argsort(hints[r].numpy(), kind="stable")
        np.testing.assert_array_equal(order.numpy(), want_order)
        want = jax_comp._composite_sorted_runs(
            jnp.asarray(stacks[r].numpy()[want_order]), jnp.arange(slots, dtype=jnp.int32))
        assert_matches(got[r].numpy(), want)


@pytest.mark.parametrize("num", [2, 8])
def test_fold_layers_indexes_the_exchanged_stack(monkeypatch, num):
    """The layered pipeline's fold reads the exchanged [D * Lmax, P / D, 5]
    stack through the global order (stable argsort of the gathered hints;
    owner = sending shard), one fold call per shard, and equals the JAX
    fold of the gathered stack."""
    calls = recorded_folds(monkeypatch)
    mesh = ds.make_mesh(num, "cpu")
    rng = np.random.default_rng(29 + num)
    layers, hints = device_layers(rng, num, 3, 16 * num)
    layers_s, hints_s = ds.shard_leading(mesh, layers, hints)
    received = ds._exchange(mesh, layers_s)
    gathered_hints = ds.all_gather(mesh, hints_s)
    got = ds._fold_layers(mesh, received, gathered_hints)
    assert len(calls) == num
    owners = np.repeat(np.arange(num, dtype=np.int32), 3)
    for r in range(num):
        stack, order, owners_sorted = calls[r]
        assert stack.data_ptr() == received[r].data_ptr()
        want_order = np.argsort(gathered_hints[r].numpy().reshape(-1), kind="stable")
        np.testing.assert_array_equal(order.numpy(), want_order)
        np.testing.assert_array_equal(owners_sorted.numpy(), owners[want_order])
        want = jax_comp._composite_sorted_runs(
            jnp.asarray(stack.numpy()[want_order]), jnp.asarray(owners[want_order]))
        assert_matches(got[r].numpy(), want)


def test_byte_decode_matches_jitted_jax():
    from amrvolumerenderer_tpu.image import byte_to_color_device as jax_decode

    b = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax.jit(jax_decode)(jnp.asarray(b)))
    np.testing.assert_array_equal(byte_to_color_device(torch.from_numpy(b)).numpy(),
                                  want)


# ---- collectives and exchanges -------------------------------------------

@pytest.mark.parametrize("num", [2, 8])
def test_collectives_match_jax(num):
    jax_mesh, mesh = meshes(num)
    rng = np.random.default_rng(num)
    x = rng.standard_normal((num * num, 3, 5)).astype(np.float32)
    h = rng.standard_normal(num * 4).astype(np.float32)
    a2a = jax.jit(jax.shard_map(
        lambda v: jax.lax.all_to_all(v, "ranks", 0, 0), mesh=jax_mesh,
        in_specs=P("ranks"), out_specs=P("ranks")))
    gather = jax.jit(jax.shard_map(
        lambda v: jax.lax.all_gather(v, "ranks"), mesh=jax_mesh,
        in_specs=P("ranks"), out_specs=P("ranks")))
    (xs, hs) = ds.shard_leading(mesh, x, h)
    np.testing.assert_array_equal(gathered(ds.all_to_all(mesh, xs)),
                                  np.asarray(a2a(jnp.asarray(x))))
    np.testing.assert_array_equal(gathered(ds.all_gather(mesh, hs)),
                                  np.asarray(gather(jnp.asarray(h))))


def device_layers(rng, num, lmax, pixels):
    """Per-shard layers with padding slots (tests/test_parallel.py:23)."""
    layers = seeded_layers(rng, num * lmax, pixels)
    hints = rng.uniform(0, 5, num * lmax).astype(np.float32)
    hints[: num * lmax // 3] = np.round(hints[: num * lmax // 3])  # ties
    valid = rng.uniform(0, 1, num * lmax) > 0.25
    layers[~valid] = 0.0
    layers[~valid, :, 4] = np.inf
    hints[~valid] = np.inf
    return layers, hints


@pytest.mark.parametrize("transport", ["float32", "ubyte"])
@pytest.mark.parametrize("num", [2, 8])
def test_exchanges_match_jax(num, transport):
    """composite_layers_sharded, composite_partials_sharded and
    compose_flat_sharded (tests/test_parallel.py:43, 436, 464, 522)."""
    jax_mesh, mesh = meshes(num)
    rng = np.random.default_rng(19 + num)
    layers, hints = device_layers(rng, num, 3, 64)
    assert_matches(
        gathered(ds.composite_layers_sharded(mesh, layers, hints, transport)),
        jds.composite_layers_sharded(jax_mesh, jnp.asarray(layers),
                                     jnp.asarray(hints), transport))
    partials = seeded_layers(rng, num, 64)
    assert_matches(
        gathered(ds.composite_partials_sharded(mesh, partials, transport)),
        jds.composite_partials_sharded(jax_mesh, jnp.asarray(partials), transport))
    if transport == "float32":
        images = rng.uniform(0, 0.6, (num, 64, 4)).astype(np.float32)
        order = rng.permutation(num).astype(np.int32)
        assert_matches(gathered(ds.compose_flat_sharded(mesh, images, order)),
                       jds.compose_flat_sharded(jax_mesh, jnp.asarray(images), order))


def test_mesh_placement():
    mesh = ds.make_mesh(3, "cpu")
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert ds._subset_devices(["a", "b"], 5) == ["a", "b", "a", "b", "a"]
    assert ds._subset_devices(["a", "b", "c"], 2) == jds._subset_devices(
        ["a", "b", "c"], 2, 1)
    with pytest.raises(ValueError, match="positive"):
        ds.make_mesh(0, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ds.shard_leading(mesh, np.zeros(4))


# ---- host packing and coverage compaction --------------------------------

def test_packers_match_jax():
    rng = np.random.default_rng(3)
    n = 11
    hints = rng.choice(np.array([0.5, 1.0, 1.5], np.float32), n)
    ties = rng.permutation(n).astype(np.int32)
    arrays = (rng.standard_normal((n, 4, 2)).astype(np.float32),
              rng.integers(0, 9, (n, 8)).astype(np.int32))
    for num in (2, 4, 8):
        assert ds._contiguous_chunk_counts(n, num) == jds._contiguous_chunk_counts(n, num)
        np.testing.assert_array_equal(
            ds.depth_contiguous_assignment(hints, ties, num),
            jds.depth_contiguous_assignment(hints, ties, num))
        for got, want in ((ds.pack_depth_contiguous(hints, ties, num, *arrays),
                           jds.pack_depth_contiguous(hints, ties, num, *arrays)),
                          (ds.pack_contiguous(num, hints, *arrays),
                           jds.pack_contiguous(num, hints, *arrays))):
            for g, w in zip(got[0], want[0]):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("layout", ["contiguous", "bimodal", "empty"])
def test_compaction_matches_jax(layout):
    """A bimodal coverage (clusters in opposite corners) picks the tile
    list; a contiguous one the union rect."""
    tiles_x, tiles_y, num = 6, 4, 8
    width, height = tiles_x * 32, tiles_y * 32
    coverage = np.zeros((3, tiles_x * tiles_y), bool)
    if layout == "contiguous":
        coverage[0, [7, 8, 13]] = coverage[2, 14] = True
    elif layout == "bimodal":
        coverage[0, 0] = coverage[1, tiles_x * tiles_y - 1] = True
    got = ds.select_compaction(coverage, width, height, 32, 32, num)
    want = jds.select_compaction(coverage, width, height, 32, 32, num)
    assert (got[0] is None) == (want[0] is None) and got[0] == want[0]
    assert (got[1] is None) == (want[1] is None)
    if layout == "bimodal":
        assert got[0] is None and got[1] is not None
    if got[1] is not None:
        np.testing.assert_array_equal(got[1][0], want[1][0])
        assert got[1][1:] == want[1][1:]
    assert ds.coverage_rect(coverage, width, height, 32, 32, num) == jds.coverage_rect(
        coverage, width, height, 32, 32, num)
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, width * height, 5)).astype(np.float32)
    rect, tiles = got
    cut = ds._slice_tiles(ds._slice_rect(torch.from_numpy(frames), rect, width, height),
                          tiles[0] if tiles else None)
    jcut = jds._slice_tiles(jds._slice_rect(jnp.asarray(frames), rect, width, height),
                            tiles[0] if tiles else None)
    np.testing.assert_array_equal(cut.numpy(), np.asarray(jcut))
    pasted = ds.paste_tiles(ds.paste_rect(cut.numpy()[0], rect, width, height),
                            tiles, width, height)
    jpasted = jds.paste_tiles(jds.paste_rect(np.asarray(jcut)[0], rect, width, height),
                              tiles, width, height)
    np.testing.assert_array_equal(pasted, jpasted)


def test_tile_worklists_match_jax(scenes):
    jax_geometry, geometry = scenes["r2-125"]
    params, camera, srange, rsd = frame_args(geometry, ("nearest", "post", 256),
                                             None, 64, 64)
    prep = renderer_fast.prepare_slicemarch_scene(
        geometry, params, camera, srange, rsd, 64, 64, None)
    order = compositor.sort_layers(prep["depth_hints"], prep["owners"],
                                   prep["local_indices"])
    args = (prep["wb"], prep["wt"], prep["wbounds"], order, 8, 4)
    for g, w in zip(renderer_fast._depth_contiguous_tile_worklists(*args),
                    jax_rf._depth_contiguous_tile_worklists(*args)):
        np.testing.assert_array_equal(g, w)


# ---- whole sharded frames --------------------------------------------------

# the golden rows below cover the r^2 scene at 48x48 over 8 shards (depth
# and layered in float32, depth in ubyte)
FRAMES = [
    # scene, knobs, eye, (width, height), devices, pipeline, transport, AA block
    ("r2", ("nearest", "post", 256), OBLIQUE, (64, 48), 8, "layered", "ubyte", 1),
    ("r2", ("nearest", "post", 256), None, (96, 96), 8, "auto", "float32", 2),
    ("3lvl", ("trilinear", "post", 256), OBLIQUE, (48, 48), 8, "depth", "float32", 1),
    ("3lvl", ("trilinear", "pre", 128), None, (64, 48), 2, "layered", "float32", 1),
    ("3lvl", ("nearest", "post", 256), None, (48, 48), 8, "layered", "ubyte", 1),
    ("r2-125", ("nearest", "post", 256), None, (64, 64), 8, "depth", "float32", 1),
]


@pytest.mark.parametrize(
    "scene,knobs,eye,size,devices,pipeline,transport,block", FRAMES,
    ids=[f"{f[0]}-{f[1][0]}-{f[1][1]}-{f[3][0]}x{f[3][1]}-{f[4]}dev-{f[5]}-"
         f"{f[6]}-aa{f[7] ** 2}" for f in FRAMES])
def test_sharded_frame_matches_jax(scenes, scene, knobs, eye, size, devices,
                                   pipeline, transport, block):
    jax_geometry, geometry = scenes[scene]
    params, camera, srange, rsd = frame_args(geometry, knobs, eye, *size)
    launches = sm.slicemarch_render.launches
    got = renderer_fast.render_composited_sharded(
        geometry, params, camera, srange, rsd, *size, None, devices,
        downsample_block=block, pipeline=pipeline, transport=transport,
        device="cpu")
    assert sm.slicemarch_render.launches == launches
    want = jax_rf.render_composited_sharded(
        jax_geometry, as_jax(params), as_jax(camera), srange, rsd, *size, None,
        devices, interpret=True, downsample_block=block, pipeline=pipeline,
        transport=transport)
    assert got.shape == ((size[0] // block) * (size[1] // block), 5)
    assert (want[:, 3] > 0).mean() > 0.05  # premise: a real frame
    assert_matches(got, want)


@pytest.mark.parametrize("pipeline", ["depth", "layered"])
def test_sharded_frame_renders_each_shard_once(scenes, monkeypatch, pipeline):
    """One dense march per shard, on the shard's own device, and a
    ``devices=1``-equivalent frame within the JAX tests' 1e-5
    (tests/test_multichip_product.py:262)."""
    jax_geometry, geometry = scenes["3lvl"]
    params, camera, srange, rsd = frame_args(geometry, ("nearest", "post", 256),
                                             OBLIQUE, 48, 48)
    calls = []
    dense = sm.slicemarch_render

    def counted(vol, *args, **kw):
        calls.append(vol.shape[0])
        return dense(vol, *args, **kw)

    monkeypatch.setattr(ds.sm, "slicemarch_render", counted)
    got = renderer_fast.render_composited_sharded(
        geometry, params, camera, srange, rsd, 48, 48, None, 8,
        pipeline=pipeline, device="cpu")
    assert len(calls) == 8 and len(set(calls)) == 1
    one = renderer_fast.render_composited_slicemarch(
        geometry, params, camera, srange, rsd, 48, 48, None, device="cpu")
    np.testing.assert_allclose(got, one, atol=1e-5)


# ---- entry points -----------------------------------------------------------

@pytest.mark.parametrize("row,opts", [
    ("slicemarch-8dev-depth-f32", dict(multichip_pipeline="depth")),
    ("slicemarch-8dev-layered-f32", dict(multichip_pipeline="layered")),
    ("slicemarch-8dev-depth-ubyte", dict(multichip_pipeline="depth",
                                         multichip_transport="ubyte")),
])
def test_api_render_reproduces_golden_row(tmp_path, row, opts):
    image, _ = api.render(
        api.AmrData(*port_levels(*make_r2_scene_data(16, 8))),
        api.RenderOptions(width=48, height=48, devices=8, render_method="slicemarch",
                          device="cpu", output_filename=str(tmp_path / "g.ppm"),
                          **opts),
        verbose=False)
    assert_matches(image.pixels, np.load(GOLDEN)[row])


@pytest.fixture(scope="module")
def plotfile(tmp_path_factory):
    from amrvolumerenderer_tpu.plotfile import write_plotfile

    levels, geoms = make_r2_scene_data(16, 8)
    path = str(tmp_path_factory.mktemp("plt") / "plt00000")
    write_plotfile(path, levels, geoms)
    return path


def test_cli_devices_matches_in_process_frame(tmp_path, plotfile):
    out = str(tmp_path / "cli.ppm")
    assert driver.main(["--width", "48", "--height", "40", "--devices", "8",
                        "--device", "cpu", "--output", out, plotfile]) == 0
    geometry = driver.load_plotfile_geometry(plotfile, "", 0, -1, False,
                                             verbose=False)
    params = RenderParameters(width=48, height=40, devices=8)
    image, _ = renderer.render_scene("", params, geometry, verbose=False,
                                     device="cpu")
    one, _ = renderer.render_scene("", RenderParameters(width=48, height=40),
                                   geometry, verbose=False, device="cpu")
    np.testing.assert_allclose(image.pixels, one.pixels, atol=1e-5)
    with open(out, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        f.readline()
        rgb = np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)
    want = np.clip((image.pixels[:, :3] * np.float32(256.0)).astype(np.int32), 0, 255)
    np.testing.assert_array_equal(rgb, want.astype(np.uint8).reshape(h, w, 3)[::-1])


@pytest.mark.parametrize("argv,message", [
    (["--devices", "2", "--render-method", "tilemarch"], "is single-device"),
    (["--devices", "2", "--render-method", "raymarch"], "is single-device"),
    (["--devices", "3"], "not divisible by the device count 3"),
])
def test_cli_devices_errors_match_jax(tmp_path, plotfile, capsys, argv, message):
    """The errors JAX raises (renderer.py:570-578, renderer_fast.py:750-755)."""
    common = ["--width", "48", "--height", "48", *argv, plotfile]
    assert driver.main([*common[:-1], "--device", "cpu", "--output",
                        str(tmp_path / "x.ppm"), plotfile]) == 1
    assert message in capsys.readouterr().err
    from amrvolumerenderer_tpu import driver as jax_driver

    assert jax_driver.main([*common[:-1], "--output", str(tmp_path / "j.ppm"),
                            plotfile]) == 1
    assert message in capsys.readouterr().err
