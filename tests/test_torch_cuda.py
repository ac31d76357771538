"""The port's CUDA kernels on the card: tile-march (one frame and batched,
float32 and bfloat16 volumes), slice-march (work list and dense), the
composite (tile, pixel and runs modes), the multi-device route over 8
shards of one card, the persistent multi-device renderer, the raymarch
oracle, the differentiable path (its march's forward, backward and
tangent kernels against their plain versions, their launch counts and a
fitting step replayed as a CUDA graph) and the one-shot tile-march route
against the same on the CPU, two processes of the CLI sharing the card against
one process, and the differentiable path over a sharded brick axis
(``diff.render_image_diff(mesh=make_mesh(N, "cuda"))``, whole data and
data as shards) against the single call on the card and the same mesh on
the CPU (marked ``cuda``; every test skips itself when
``torch.cuda.is_available()`` is false).

This file imports neither jax nor the tests' conftest (which does), so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -o markers=cuda -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same device
(atol 2e-6; the two round alike, so they agree bit for bit) and the routes
against the golden rows (the manifest's atol of 2e-6).  The march kernels
are also held on the eye inside the domain (one view whose tiles all march
one way, and a 120-degree view with tiles whose rays march both ways), a
2048-entry LUT, bfloat16 batches of 1, 2 and 8 frames, and the dense
mode's padding slots and background tiles.
"""

import os

import numpy as np
import pytest
import torch

from amrvolumerenderer_torch import api
from amrvolumerenderer_torch.camera import (
    auto_orbit_camera,
    camera_basis,
    orbit_camera_sequence,
)
from amrvolumerenderer_torch.compositor import sort_layers
from amrvolumerenderer_torch.fast_scene import FastSceneRenderer, pack_batch_tables
from amrvolumerenderer_torch.ops import composite as comp
from amrvolumerenderer_torch.ops import raymarch as rm
from amrvolumerenderer_torch.ops import slicemarch as sm
from amrvolumerenderer_torch.ops import tilemarch as tm
from amrvolumerenderer_torch.ops.worklist import choose_march_axis
from amrvolumerenderer_torch.renderer import (
    compute_global_bounds,
    compute_global_scalar_range,
    compute_reference_sample_distance,
    render_scene,
)
from amrvolumerenderer_torch.renderer_fast import (
    prepare_slicemarch_scene,
    slicemarch_device_inputs,
)
from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry, build_brick_buckets
from amrvolumerenderer_torch.types import CameraParameters, RenderParameters

from test_torch_fold_diff import fold_case, fold_counters, fold_run, same_bits

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "manifest_pixels.npz")
ATOL = 2e-6
KNOBS = [("nearest", "post", 256), ("nearest", "post", 128),
         ("trilinear", "post", 256), ("trilinear", "pre", 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def r2_data(n=16, box=8):
    """The golden manifest's scene (tests/conftest.make_r2_scene_data(n, box);
    the default is the manifest's 16^3 in 8 boxes)."""
    c = np.arange(n) / (n - 1)
    f = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    boxes = [LevelBox(f[i:i + box, j:j + box, k:k + box], np.array([i, j, k]))
             for i in range(0, n, box) for j in range(0, n, box)
             for k in range(0, n, box)]
    return api.AmrData(level_data=[boxes],
                       level_geometry=[LevelGeometry(np.zeros(3), np.full(3, 1 / n))])


def three_level_geometry(n=32):
    """bench.py's 3-level scene at a quarter of its width."""
    def field(lo, hi):
        c = lo + (np.arange(n) + 0.5) / n * (hi - lo)
        r = np.sqrt((c[:, None, None] - 0.5) ** 2 + (c[None, :, None] - 0.5) ** 2
                    + (c[None, None, :] - 0.5) ** 2)
        return np.exp(-((r - 0.18) / 0.06) ** 2) + 0.7 * np.exp(
            -((r - 0.38) / 0.05) ** 2)

    data = api.AmrData(
        level_data=[[LevelBox(field(0.0, 1.0), np.zeros(3, int))],
                    [LevelBox(field(0.25, 0.75), np.full(3, n // 2, int))],
                    [LevelBox(field(0.375, 0.625), np.full(3, 3 * n // 2, int))]],
        level_geometry=[LevelGeometry(np.zeros(3), np.full(3, 1.0 / (s * n)))
                        for s in (1, 2, 4)],
        refinement_ratios=[(2, 2, 2), (2, 2, 2)],
    )
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


def assert_close(got, ref):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(map(str, k)))
def test_kernel_matches_plain(cuda, knobs):
    sampling, classification, lut_size = knobs
    fsr = FastSceneRenderer(three_level_geometry(), RenderParameters(
        width=256, height=192, sampling=sampling,
        classification=classification, lut_size=lut_size,
    ), device=cuda)
    cam = CameraParameters(eye=(-1.9, 2.3, -1.2), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    inputs = fsr.frame_inputs(cam)
    args = (fsr._packed_vol, inputs["meta"], inputs["dims"], fsr.lut,
            inputs["cam"], inputs["offsets"], inputs["bricks"],
            inputs["owners"], inputs["item_bounds"], inputs["tile_ids"])
    kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
              logical_width=fsr.render_width, logical_height=fsr.render_height,
              sampling=sampling, ghost=fsr.ghost, classification=classification)
    before = tm.tilemarch_render.launches
    kc, kd = tm.tilemarch_render(*args, **kw)
    pc, pd = tm.tilemarch_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tm.tilemarch_render.launches == before + 1
    assert (pc[:, 3] > 0).float().mean() > 0.1
    assert_close(kc, pc)
    assert_close(kd, pd)


@pytest.mark.cuda
@pytest.mark.parametrize("method,row", [("tilemarch", "tilemarch-1dev"),
                                        ("slicemarch", "slicemarch-1dev")])
def test_kernel_reproduces_golden_rows(cuda, tmp_path, method, row):
    """Each route reproduces its golden row and launches its own kernels:
    tile-march alone, or slice-march + composite (16 pieces <= 96)."""
    counters = (tm.tilemarch_render, sm.slicemarch_render_worklist_raw,
                comp.composite_tiles)
    before = [f.launches for f in counters]
    image, _ = api.render(r2_data(), api.RenderOptions(
        width=48, height=48, render_method=method, device=cuda,
        output_filename=str(tmp_path / "golden.ppm"),
    ), verbose=False)
    launched = [f.launches - b for f, b in zip(counters, before)]
    assert launched == ([1, 0, 0] if method == "tilemarch" else [0, 1, 1])
    ref = np.load(GOLDEN)[row]
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(image.pixels), finite)
    np.testing.assert_allclose(image.pixels[finite], ref[finite], rtol=0, atol=ATOL)


def slicemarch_case(dev, knobs, camera, size=(256, 192)):
    """Prepared slice-march inputs of the 3-level scene on ``dev``."""
    sampling, classification, lut_size = knobs
    geometry = three_level_geometry()
    params = RenderParameters(width=size[0], height=size[1], sampling=sampling,
                              classification=classification, lut_size=lut_size)
    bounds = compute_global_bounds(geometry)
    prep = prepare_slicemarch_scene(
        geometry, params, camera, compute_global_scalar_range(geometry),
        compute_reference_sample_distance(geometry, bounds), *size, None)
    inp = slicemarch_device_inputs(prep, dev)
    args = tuple(inp[k] for k in ("vol", "meta", "dims", "luts", "cam", "wb",
                                  "wt", "wbounds"))
    kw = dict(width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
              logical_width=size[0], logical_height=size[1], sampling=sampling,
              ghost=prep["ghost"], classification=classification)
    return prep, inp, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(map(str, k)))
def test_slicemarch_kernel_matches_plain(cuda, knobs):
    cam = CameraParameters(eye=(-1.9, 2.3, -1.2), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    prep, inp, args, kw = slicemarch_case(cuda, knobs, cam)
    before = sm.slicemarch_render_worklist_raw.launches
    kc, kd = sm.slicemarch_render_worklist_raw(*args, **kw)
    pc, pd = sm.slicemarch_reference(*args, **kw)
    torch.cuda.synchronize()
    assert sm.slicemarch_render_worklist_raw.launches == before + 1
    cov = inp["coverage"]
    assert (pc[cov][:, 3] > 0).float().mean() > 0.05
    assert_close(kc[cov], pc[cov])
    assert_close(kd[cov], pd[cov])
    # the masked, untiled entry is the same render
    mc, md = sm.slicemarch_render_worklist(*args[:7], cov, args[7], **kw)
    rc, rd = sm.untile(torch.where(cov[:, :, None, None, None], pc, 0.0),
                       torch.where(cov[:, :, None, None], pd, float("inf")),
                       kw["width"], kw["height"])
    assert_close(mc, rc)
    assert_close(md, rd)


@pytest.mark.cuda
@pytest.mark.parametrize("num_layers", [5, 128])
def test_composite_kernel_matches_plain(cuda, num_layers):
    """Seeded layers with depth ties, owner runs and coverage holes whose
    blocks hold NaN; 128 layers is the TPU's streamed-kernel regime."""
    rng = np.random.default_rng(num_layers)
    tiles = 12
    alpha = rng.uniform(0, 1, (num_layers, tiles, 1, 8, 128))
    colors = np.concatenate([rng.uniform(0, 1, (num_layers, tiles, 3, 8, 128))
                             * alpha, alpha], axis=2).astype(np.float32)
    depths = rng.choice(np.array([0.5, 1.0, 2.0, np.inf], np.float32),
                        (num_layers, tiles, 8, 128))
    coverage = rng.uniform(0, 1, (num_layers, tiles)) < 0.7
    colors[~coverage] = np.nan
    depths[~coverage] = np.nan
    owners = np.sort(rng.integers(0, num_layers // 2, num_layers))
    order = sort_layers(rng.choice(np.array([0.1, 0.2], np.float32), num_layers),
                        owners, np.arange(num_layers))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        colors, depths, order, owners[order].astype(np.int32), coverage)]
    before = comp.composite_tiles.launches
    kc, kd = comp.composite_tiles(*args)
    pc, pd = comp.composite_reference(*args)
    torch.cuda.synchronize()
    assert comp.composite_tiles.launches == before + 1
    assert torch.isfinite(kc).all()
    assert_close(kc, pc)
    assert_close(kd, pd)


def composite_case(num_layers, seed, tiles=6):
    """Tile-mode inputs with the cases the kernel's compaction must keep:
    tile 0 has no covered layer, tile 1 misses the first sorted layer, and
    tile 2 holds an all-uncovered owner run between two runs of one owner
    with tied depths.  Uncovered blocks hold NaN."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0, 1, (num_layers, tiles, 1, 8, 128))
    colors = np.concatenate([rng.uniform(0, 1, (num_layers, tiles, 3, 8, 128))
                             * alpha, alpha], axis=2).astype(np.float32)
    depths = rng.choice(np.array([0.5, 1.0, 2.0, np.inf], np.float32),
                        (num_layers, tiles, 8, 128))
    coverage = rng.uniform(0, 1, (num_layers, tiles)) < 0.6
    order = rng.permutation(num_layers).astype(np.int32)
    owners = np.sort(rng.integers(0, max(num_layers // 3, 2), num_layers))
    coverage[:, 0] = False
    coverage[order[0], 1] = False
    if num_layers >= 3:
        owners[:3] = [owners[0], num_layers + 5, owners[0]]  # A, B, A
        coverage[order[:3], 2] = [True, False, True]
        depths[order[[0, 2]], 2] = 1.0
    colors[~coverage] = np.nan
    depths[~coverage] = np.nan
    return colors, depths, order, owners.astype(np.int32), coverage


@pytest.mark.cuda
@pytest.mark.parametrize("num_layers", [1, 16, 97, 200])
def test_composite_modes_match_plain_exactly(cuda, num_layers):
    """Both entries of composite.cu against their plain versions at max
    |diff| 0: the tile mode on ``composite_case``, the pixel mode on a
    ragged pixel count read through a strided view of a larger stack."""
    args = [torch.from_numpy(a).to(cuda)
            for a in composite_case(num_layers, num_layers)]
    rng = np.random.default_rng(num_layers + 1)
    pixels = 1000 + num_layers
    alpha = rng.uniform(0, 0.9, (num_layers, pixels + 7, 1))
    stack = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 1, (num_layers, pixels + 7, 3)) * alpha, alpha,
         rng.choice(np.array([0.5, 1.0, 2.0, np.inf]), (num_layers, pixels + 7, 1))],
        axis=-1).astype(np.float32)).to(cuda)
    layers = stack[:, 3:3 + pixels]
    order = torch.from_numpy(rng.permutation(num_layers).astype(np.int32)).to(cuda)
    owners = torch.from_numpy(np.sort(rng.integers(0, 4, num_layers))
                              .astype(np.int32)).to(cuda)
    before = (comp.composite_tiles.launches, comp.composite_pixels.launches)
    kc, kd = comp.composite_tiles(*args)
    kp = comp.composite_pixels(layers, order, owners)
    pc, pd = comp.composite_reference(*args)
    pp = comp.composite_pixels_reference(layers, order, owners)
    torch.cuda.synchronize()
    assert (comp.composite_tiles.launches, comp.composite_pixels.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(kc).all() and not torch.isnan(kd).any()
    assert (kc[0] == 0).all() and torch.isinf(kd[0]).all()  # no covered layer
    assert torch.equal(kc, pc) and torch.equal(kd, pd)
    assert kp.shape == (pixels, 5) and torch.equal(kp, pp)


@pytest.mark.cuda
def test_composite_nan_depth_and_negative_zero(cuda):
    """A covered block outside the compaction's precondition (composite.cu's
    comment): the kernel folds the covered layers alone, grouped by run id.
    Owners 0, 1, 1.  Layer 1 has colour -0.0, alpha 0.5 and a NaN depth;
    tile 0 covers only layer 1, tile 1 covers layer 0 (colour and alpha
    0.25, depth 1) and layer 1.  The plain version folds every layer, so
    it turns -0.0 into +0.0 and keeps the NaN depth of tile 1 (ROADMAP.md
    section 3, Differences)."""
    colors = np.zeros((3, 2, 4, 8, 128), np.float32)
    depths = np.ones((3, 2, 8, 128), np.float32)
    colors[1, :, :3] = -0.0
    colors[1, :, 3] = 0.5
    depths[1] = np.nan
    colors[0, 1] = 0.25
    coverage = np.array([[False, True], [True, True], [False, False]])
    colors[~coverage] = np.nan
    depths[~coverage] = np.nan
    args = [torch.from_numpy(a).to(cuda) for a in (
        colors, depths, np.arange(3, dtype=np.int32),
        np.array([0, 1, 1], np.int32), coverage)]
    kc, kd = comp.composite_tiles(*args)
    pc, pd = comp.composite_reference(*args)
    torch.cuda.synchronize()
    # tile 0: layer 1 as it is
    assert (kc[0, :3] == 0).all() and torch.signbit(kc[0, :3]).all()
    assert (kc[0, 3] == 0.5).all() and torch.isnan(kd[0]).all()
    assert not torch.signbit(pc[0, :3]).any() and torch.isnan(pd[0]).all()
    assert torch.equal(kc[0], pc[0])
    # tile 1: blend(layer 0, layer 1); the NaN compares false, so layer 1 is
    # in front: 0.25 * (1 - 0.5) + (-0.0), alpha 0.25 * 0.5 + 0.5, and
    # fminf(1, NaN) = 1 where the plain torch.minimum gives NaN
    assert (kc[1, :3] == 0.125).all() and (kc[1, 3] == 0.625).all()
    assert (kd[1] == 1.0).all() and torch.isnan(pd[1]).all()
    assert torch.equal(kc[1], pc[1])


@pytest.mark.cuda
def test_sentinel_steps_and_wrapper_checks(cuda):
    fsr = FastSceneRenderer(three_level_geometry(), RenderParameters(
        width=64, height=64), device=cuda)
    inputs = fsr.frame_inputs(auto_orbit_camera(fsr.bounds))
    num_tiles = (fsr.pad_w // 32) * (fsr.pad_h // 32)
    kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube)
    head = (fsr._packed_vol, inputs["meta"], inputs["dims"], fsr.lut, inputs["cam"])
    items = (inputs["bricks"], inputs["owners"], inputs["item_bounds"])
    c0, d0 = tm.tilemarch_render(*head, inputs["offsets"], *items,
                                 inputs["tile_ids"], **kw)
    pad = torch.full((2,), num_tiles, dtype=torch.int32, device=cuda)
    offsets = torch.cat([inputs["offsets"], inputs["offsets"][-1:].repeat(2)])
    c1, d1 = tm.tilemarch_render(*head, offsets, *items,
                                 torch.cat([inputs["tile_ids"], pad]), **kw)
    assert torch.equal(c1[:-2], c0) and torch.equal(d1[:-2], d0)
    assert (c1[-2:] == 0).all() and torch.isinf(d1[-2:]).all()
    with pytest.raises(TypeError, match="dtype"):
        tm.tilemarch_render(*head, offsets.long(), *items,
                            torch.cat([inputs["tile_ids"], pad]), **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        tm.tilemarch_render(*head[:4], inputs["cam"].cpu(), inputs["offsets"],
                            *items, inputs["tile_ids"], **kw)
    with pytest.raises(TypeError, match="dtype"):
        sm.slicemarch_render_worklist_raw(
            fsr._packed_vol.double(), inputs["meta"], inputs["dims"],
            fsr.lut[None].expand(fsr._packed_vol.shape[0], -1, -1, -1).contiguous(),
            inputs["cam"], inputs["bricks"], inputs["bricks"], **kw)


def batch_case(dev, precision, count=3, size=(256, 192)):
    """A renderer of the 3-level scene and the batched kernel's tables for
    ``count`` orbit frames that share a march axis (on ``dev``)."""
    fsr = FastSceneRenderer(three_level_geometry(), RenderParameters(
        width=size[0], height=size[1]), device=dev, precision=precision)
    base = auto_orbit_camera(fsr.bounds)
    cams = orbit_camera_sequence(base, 8 * count, 45.0)[:count]
    frames = [fsr.frame_inputs(c, as_numpy=True) for c in cams]
    assert len(fsr._axis_meta_cache) == 1  # one march axis
    num_tiles = (fsr.pad_w // 32) * (fsr.pad_h // 32)
    tables = {k: torch.from_numpy(v).to(dev)
              for k, v in pack_batch_tables(frames, num_tiles).items()}
    _m, _d, meta, dims = fsr._axis_meta_cache[fsr._packed_axis]
    args = (fsr._packed_vol, meta, dims, fsr.lut, tables["cam"],
            tables["offsets"], tables["bricks"], tables["owners"],
            tables["item_bounds"], tables["tile_ids"])
    kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
              logical_width=fsr.render_width, logical_height=fsr.render_height)
    return fsr, frames, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_batched_kernel_matches_plain_and_single(cuda, precision):
    fsr, frames, args, kw = batch_case(cuda, precision)
    assert fsr._packed_vol.dtype == (torch.bfloat16 if precision == "bfloat16"
                                     else torch.float32)
    before = tm.tilemarch_render_batch.launches
    kc, kd = tm.tilemarch_render_batch(*args, **kw)
    pc, pd = tm.tilemarch_batch_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tm.tilemarch_render_batch.launches == before + 1
    assert kc.shape == (3,) + tuple(args[9].shape[1:]) + (4, 8, 128)
    assert (pc[:, :, 3] > 0).float().mean() > 0.1
    assert_close(kc, pc)
    assert_close(kd, pd)
    # each frame of the batch equals the one-frame launch, bit for bit
    for f, inp in enumerate(frames):
        steps = len(inp["tile_ids"])
        one = [torch.from_numpy(np.ascontiguousarray(inp[k])).to(cuda) for k in (
            "cam", "offsets", "bricks", "owners", "item_bounds", "tile_ids")]
        sc, sd = tm.tilemarch_render(*args[:4], *one, **kw)
        assert torch.equal(kc[f, :steps], sc) and torch.equal(kd[f, :steps], sd)


@pytest.mark.cuda
def test_render_batch_equals_render_bit_for_bit(cuda):
    """A 16-frame orbit over 360 degrees crosses march axes; every batched
    mode equals the per-frame render (floats, bytes, rgb)."""
    fsr = FastSceneRenderer(three_level_geometry(), RenderParameters(
        width=128, height=96), device=cuda)
    cams = orbit_camera_sequence(auto_orbit_camera(fsr.bounds), 16, 360.0)
    before = (tm.tilemarch_render_batch.launches, tm.tilemarch_render.launches)
    batch = fsr.render_batch(cams, overlay=False)
    assert tm.tilemarch_render_batch.launches > before[0]
    assert tm.tilemarch_render.launches == before[1]
    assert len({choose_march_axis(camera_basis(c)[0]) for c in cams}) > 1
    singles = np.stack([fsr.render(c, overlay=False) for c in cams])
    np.testing.assert_array_equal(batch, singles)
    rgba = fsr.render_batch(cams, overlay=False, bytes_out=True)
    want = np.clip((singles[..., :4] * np.float32(256.0)).astype(np.int32), 0, 255)
    np.testing.assert_array_equal(rgba, want.astype(np.uint8))
    np.testing.assert_array_equal(
        fsr.render_batch(cams, overlay=False, bytes_out="rgb"), rgba[..., :3])
    np.testing.assert_array_equal(
        fsr.render_batch(cams, overlay=False, max_chunk_bytes=1), batch)


@pytest.mark.cuda
def test_batched_wrapper_checks(cuda):
    fsr, frames, args, kw = batch_case(cuda, "float32", count=2, size=(64, 64))
    with pytest.raises(TypeError, match="dtype"):
        tm.tilemarch_render_batch(*args[:5], args[5].long(), *args[6:], **kw)
    with pytest.raises(ValueError, match="shape"):
        tm.tilemarch_render_batch(*args[:4], args[4][:, :19].contiguous(),
                                  *args[5:], **kw)
    with pytest.raises(ValueError, match="shape"):
        tm.tilemarch_render_batch(*args[:6], args[6][:1], *args[7:], **kw)
    with pytest.raises(ValueError):
        tm.tilemarch_render_batch(*args[:9], args[9][0], **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tm.tilemarch_render_batch(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        tm.tilemarch_render_batch(*args[:8], args[8].cpu(), args[9], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(map(str, k)))
def test_dense_kernel_matches_plain(cuda, knobs):
    """Kernel 4 on every (piece, tile) block, with a zero padding slot
    appended: the slot comes out as colour 0 and depth +inf."""
    cam = CameraParameters(eye=(-1.9, 2.3, -1.2), look_at=(0.5, 0.5, 0.5),
                           up=(0, 1, 0))
    prep, inp, args, kw = slicemarch_case(cuda, knobs, cam)
    tables = [torch.cat([inp[k], torch.zeros_like(inp[k][:1])])
              for k in ("vol", "meta", "dims", "luts")]
    before = sm.slicemarch_render.launches
    kc, kd = sm.slicemarch_render(*tables, inp["cam"], **kw)
    pc, pd = sm.untile(*sm.slicemarch_dense_reference(*tables, inp["cam"], **kw),
                       kw["width"], kw["height"])
    torch.cuda.synchronize()
    assert sm.slicemarch_render.launches == before + 1
    assert (pc[:-1, :, 3] > 0).any(dim=0).float().mean() > 0.1
    assert_close(kc, pc)
    assert_close(kd, pd)
    assert (kc[-1] == 0).all() and torch.isinf(kd[-1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("scene,pipeline,transport", [
    ("3lvl", "depth", "float32"), ("3lvl", "layered", "float32"),
    ("3lvl", "depth", "ubyte"), ("125-bricks", "depth", "float32"),
])
def test_sharded_route_matches_cpu_route(cuda, scene, pipeline, transport):
    """``render_scene(devices=8)``: 8 shards on the card equal 8 shards on
    the CPU; one kernel launch per shard (the dense slice march, or the
    tile march above 96 pieces) and one pixel-mode composite launch per
    shard and fold (the local fold of the depth pipeline, then the
    exchanged one), no tile-mode launch."""
    geometry = (three_level_geometry() if scene == "3lvl" else
                api.load_amr_geometry(r2_data(40, 8), 0, -1, 0, False, True,
                                      verbose=False))
    params = RenderParameters(width=256, height=192, devices=8,
                              multichip_pipeline=pipeline,
                              multichip_transport=transport)
    counter = sm.slicemarch_render if scene == "3lvl" else tm.tilemarch_render
    before, folds = counter.launches, comp.composite_pixels.launches
    tiles = comp.composite_tiles.launches
    gpu, _ = render_scene("", params, geometry, verbose=False, device=cuda)
    assert counter.launches == before + 8
    local_folds = 8 if (scene, pipeline) == ("3lvl", "depth") else 0
    assert comp.composite_pixels.launches == folds + 8 + local_folds
    assert comp.composite_tiles.launches == tiles
    cpu, _ = render_scene("", params, geometry, verbose=False, device="cpu")
    assert (cpu.pixels[:, 3] > 0).mean() > 0.05
    assert_close(torch.from_numpy(gpu.pixels), torch.from_numpy(cpu.pixels))


# The eye inside the domain (tests/test_torch_slicemarch.py, test_torch_
# tilemarch.py): every ray of a tile marches one way along the frame's
# march axis.  With a 120-degree field of view and a diagonal view some
# rays are more than 90 degrees off that axis, so the tiles around the
# plane d_a = 0 hold rays of both directions in the pieces around the eye.
INSIDE = CameraParameters(eye=(0.4, 0.45, 0.5), look_at=(0.9, 0.5, 0.5),
                          up=(0, 1, 0))
WIDE_INSIDE = CameraParameters(eye=(0.4, 0.45, 0.5), look_at=(1.4, 1.35, 1.3),
                               up=(0, 1, 0), fov_y_degrees=120.0)
CAMERAS = {"inside": INSIDE, "wide-inside": WIDE_INSIDE}


def tile_case(dev, camera, lut_size=256, size=(256, 192)):
    """One frame's tile-march arguments on the 3-level scene."""
    fsr = FastSceneRenderer(three_level_geometry(), RenderParameters(
        width=size[0], height=size[1], lut_size=lut_size), device=dev)
    inputs = fsr.frame_inputs(camera)
    args = (fsr._packed_vol, inputs["meta"], inputs["dims"], fsr.lut,
            inputs["cam"], inputs["offsets"], inputs["bricks"],
            inputs["owners"], inputs["item_bounds"], inputs["tile_ids"])
    kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
              logical_width=fsr.render_width, logical_height=fsr.render_height)
    return args, kw


def run_route(route, dev, camera, lut_size=256):
    """(kernel outputs, plain outputs) of one march route: tile march,
    work-list slice march (covered blocks) or the dense slice march with a
    zero padding slot in the middle."""
    if route == "tilemarch":
        args, kw = tile_case(dev, camera, lut_size)
        assert args[3].shape[1] * 128 == lut_size
        got = tm.tilemarch_render(*args, **kw)
        return got, tm.tilemarch_reference(*args, **kw)
    prep, inp, args, kw = slicemarch_case(dev, ("nearest", "post", lut_size),
                                          camera)
    assert args[3].shape[2] * 128 == lut_size
    if route == "slicemarch":
        kc, kd = sm.slicemarch_render_worklist_raw(*args, **kw)
        pc, pd = sm.slicemarch_reference(*args, **kw)
        cov = inp["coverage"]
        return (kc[cov], kd[cov]), (pc[cov], pd[cov])
    half = inp["vol"].shape[0] // 2
    tables = [torch.cat([inp[k][:half], torch.zeros_like(inp[k][:1]), inp[k][half:]])
              for k in ("vol", "meta", "dims", "luts")]
    got = sm.slicemarch_render(*tables, inp["cam"], **kw)
    want = sm.untile(*sm.slicemarch_dense_reference(*tables, inp["cam"], **kw),
                     kw["width"], kw["height"])
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tilemarch", "slicemarch", "dense"])
@pytest.mark.parametrize("camera", list(CAMERAS))
def test_eye_inside_matches_plain(cuda, camera, route):
    """Tiles whose rays all march one way along the march axis, and (at
    fov 120) tiles whose rays march both ways."""
    got, want = run_route(route, cuda, CAMERAS[camera])
    torch.cuda.synchronize()
    alpha = want[0][..., 3].amax(dim=0) if route == "dense" else want[0][:, 3]
    assert (alpha > 0).float().mean() > 0.05  # premise: a real frame
    assert_close(got[0], want[0])
    assert_close(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tilemarch", "slicemarch", "dense"])
def test_large_lut_matches_plain(cuda, route):
    """A 2048-entry LUT (32 KiB a table)."""
    got, want = run_route(route, cuda, WIDE_INSIDE, lut_size=2048)
    torch.cuda.synchronize()
    assert_close(got[0], want[0])
    assert_close(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 2, 8])
def test_batched_bfloat16_matches_plain(cuda, frames):
    fsr, _, args, kw = batch_case(cuda, "bfloat16", count=frames)
    assert args[0].dtype == torch.bfloat16
    kc, kd = tm.tilemarch_render_batch(*args, **kw)
    pc, pd = tm.tilemarch_batch_reference(*args, **kw)
    torch.cuda.synchronize()
    assert kc.shape[0] == frames
    assert_close(kc, pc)
    assert_close(kd, pd)


@pytest.mark.cuda
def test_dense_background_blocks(cuda, monkeypatch):
    """The dense mode writes a padding slot and every pixel whose ray
    misses its piece as background itself, and the GPU path neither builds
    the dense work list nor untiles."""
    def forbidden(*args, **kw):
        raise AssertionError("the GPU path must not call this")

    monkeypatch.setattr(sm, "dense_worklist", forbidden)
    monkeypatch.setattr(sm, "untile", forbidden)
    prep, inp, args, kw = slicemarch_case(cuda, ("nearest", "post", 256), INSIDE)
    tables = [torch.cat([torch.zeros_like(inp[k][:1]), inp[k]])
              for k in ("vol", "meta", "dims", "luts")]
    kc, kd = sm.slicemarch_render(*tables, inp["cam"], **kw)
    monkeypatch.undo()
    pc, pd = sm.untile(*sm.slicemarch_dense_reference(*tables, inp["cam"], **kw),
                       kw["width"], kw["height"])
    torch.cuda.synchronize()
    assert kc.shape == (len(tables[0]), kw["width"] * kw["height"], 4)
    assert (kc[0] == 0).all() and torch.isinf(kd[0]).all()
    blocks = pd.reshape(len(pd), kw["height"] // 32, 32, kw["width"] // 32, 32)
    miss = torch.isinf(blocks).all(dim=4).all(dim=2)
    assert int(miss[1:].sum()) > 0  # premise: all-miss tiles exist
    assert_close(kc, pc)
    assert_close(kd, pd)


# ---- the runs mode and the persistent multi-device renderer -----------------


def runs_case(num_layers, rmax, seed):
    """Seeded pixel-major layers (depth ties, misses, cleared layers,
    -0.0 colours) and a step order whose run slots fill [0, rmax) in
    non-decreasing blocks, as ``preblend_plan`` gives them."""
    rng = np.random.default_rng(seed)
    pixels = 1000  # a ragged last warp and block
    a = rng.uniform(0, 1, (num_layers, pixels)).astype(np.float32)
    c = rng.uniform(0, 1, (num_layers, pixels, 3)).astype(np.float32) * a[..., None]
    d = rng.integers(0, 4, (num_layers, pixels)).astype(np.float32)
    d[rng.random((num_layers, pixels)) < 0.1] = np.inf
    layers = np.concatenate([c, a[..., None], d[..., None]], axis=-1)
    layers[rng.random((num_layers, pixels)) < 0.1] = [0, 0, 0, 0, np.inf]
    layers[..., :4][rng.random((num_layers, pixels, 4)) < 0.05] = -0.0
    order = rng.permutation(num_layers).astype(np.int32)
    cuts = np.sort(rng.choice(np.arange(1, num_layers), min(rmax, num_layers) - 1,
                              replace=False)) if num_layers > 1 else []
    slots = np.zeros(num_layers, np.int32)
    for cut in cuts:
        slots[cut:] += 1
    return (torch.from_numpy(layers), torch.from_numpy(order),
            torch.from_numpy(slots))


@pytest.mark.cuda
@pytest.mark.parametrize("num_layers", [1, 16, 64])
@pytest.mark.parametrize("rmax", [4, 8])
def test_composite_runs_matches_plain(cuda, num_layers, rmax):
    """One launch, and the same steps in chunks of 5 with ``carry``, at max
    |diff| 0 with the plain version; untouched slots hold the identity."""
    layers, order, slots = runs_case(num_layers, rmax, num_layers + rmax)
    want = comp.composite_runs_reference(layers, order, slots, rmax)
    before = comp.composite_runs.launches
    got = comp.composite_runs(layers.to(cuda), order.to(cuda), slots.to(cuda), rmax)
    torch.cuda.synchronize()
    assert comp.composite_runs.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert torch.isinf(got[int(slots.max()) + 1:, :, 4]).all()
    # the same runs by one pixel-mode launch per run over its steps
    for s in range(int(slots.max()) + 1):
        steps = order[slots == s].to(cuda)
        run = comp.composite_pixels(layers.to(cuda), steps,
                                    torch.zeros_like(steps))
        np.testing.assert_array_equal(run.cpu().numpy(), want[s].numpy())
    lay = layers[order.long()].to(cuda)
    out = None
    for c0 in range(0, num_layers, 5):
        s = slots[c0:c0 + 5]
        out = comp.composite_runs(
            lay[c0:c0 + 5], torch.arange(len(s), dtype=torch.int32, device=cuda),
            s.to(cuda), rmax, out=out,
            carry=bool(c0 > 0 and slots[c0] == slots[c0 - 1]))
    np.testing.assert_array_equal(out.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_composite_runs_all_invalid_shard(cuda):
    """A shard with no valid layer: cleared layers folded into slot 0 from
    the first layer (not from a zero accumulator)."""
    layers = torch.zeros((6, 300, 5))
    layers[..., 4] = float("inf")
    layers[2, :, 0] = -0.0
    order = torch.arange(6, dtype=torch.int32)
    slots = torch.zeros(6, dtype=torch.int32)
    want = comp.composite_runs_reference(layers, order, slots, 4)
    got = comp.composite_runs(layers.to(cuda), order.to(cuda), slots.to(cuda), 4)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert np.array_equal(np.signbit(got.cpu().numpy()), np.signbit(want.numpy()))


def persistent_pair(cuda, geometry, width=64, height=48, **kw):
    from amrvolumerenderer_torch.parallel.persistent import MultiChipSceneRenderer

    params = RenderParameters(width=width, height=height)
    return (MultiChipSceneRenderer(geometry, params, num_devices=8, device=cuda, **kw),
            MultiChipSceneRenderer(geometry, params, num_devices=8, device="cpu", **kw))


def deep_geometry(n=48, brick=8):
    """216 pieces: 27 a shard over 8, above the scan threshold."""
    c = (np.arange(n) + 0.5) / n
    r = np.sqrt((c[:, None, None] - 0.5) ** 2 + (c[None, :, None] - 0.5) ** 2
                + (c[None, None, :] - 0.5) ** 2)
    f = np.exp(-((r - 0.35) / 0.1) ** 2)
    boxes = [LevelBox(f[i:i + brick, j:j + brick, k:k + brick], np.array([i, j, k]))
             for i in range(0, n, brick) for j in range(0, n, brick)
             for k in range(0, n, brick)]
    return api.load_amr_geometry(
        api.AmrData(level_data=[boxes],
                    level_geometry=[LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]),
        0, -1, 0, False, True, verbose=False)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["3lvl", "deep"])
@pytest.mark.parametrize("transport", ["float32", "ubyte"])
def test_persistent_matches_cpu(cuda, scene, transport):
    """The persistent renderer on the card equals it on the CPU: stack
    mode with the pre-blend forced on and off, scan mode, and
    ``render_batch`` over an orbit; kernel 4, the runs mode and the pixel
    mode launch on the card."""
    geometry = three_level_geometry() if scene == "3lvl" else deep_geometry()
    gpu, cpu = persistent_pair(cuda, geometry, transport=transport)
    assert gpu._scan_pieces() == (scene == "deep")
    cams = orbit_camera_sequence(auto_orbit_camera(gpu.bounds), 4, 360.0)
    want = [cpu.render(c, overlay=False) for c in cams]
    counters = (sm.slicemarch_render, comp.composite_pixels, comp.composite_runs)
    before = [f.launches for f in counters]
    got = gpu.render(cams[0], overlay=False)
    # float32 stack mode pre-blends only where the cost model says so,
    # which it refuses here (a run depth of 4 at 1 layer a shard)
    preblend = scene == "deep" or transport == "ubyte"
    assert [f.launches > b for f, b in zip(counters, before)] == [True, True, preblend]
    assert (want[0][:, 3] > 0).mean() > 0.05
    assert_close(torch.from_numpy(got), torch.from_numpy(want[0]))
    for force in (True, False):
        gpu.scan_piece_threshold = 10_000 if scene == "deep" else 16
        gpu._use_preblend = lambda rmax, _f=force: _f or transport == "ubyte"
        runs = comp.composite_runs.launches
        np.testing.assert_array_equal(gpu.render(cams[0], overlay=False), got)
        assert (comp.composite_runs.launches > runs) == (force or transport == "ubyte")
    del gpu._use_preblend
    gpu.scan_piece_threshold = 16 if scene == "deep" else 0
    np.testing.assert_array_equal(gpu.render(cams[0], overlay=False), got)
    gpu.scan_piece_threshold = 16
    batch = gpu.render_batch(cams, overlay=False)
    for frame, ref in zip(batch, want):
        assert_close(torch.from_numpy(frame), torch.from_numpy(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("row,force", [("persistent-8dev-preblend", True),
                                       ("persistent-8dev-plain", False)])
def test_persistent_golden_rows(cuda, row, force):
    from amrvolumerenderer_torch.parallel.persistent import MultiChipSceneRenderer

    geometry = api.load_amr_geometry(r2_data(), 0, -1, 0, False, True, verbose=False)
    r = MultiChipSceneRenderer(geometry, RenderParameters(width=48, height=48),
                               num_devices=8, device=cuda)
    r._use_preblend = lambda rmax: force
    before = comp.composite_runs.launches
    got = r.render(auto_orbit_camera(r.bounds), overlay=False)
    assert comp.composite_runs.launches == before + (8 if force else 0)
    assert_close(torch.from_numpy(got), torch.from_numpy(np.load(GOLDEN)[row]))


def r2_tensor_levels(dev):
    """The golden scene's boxes as (tensor, lo) pairs on ``dev``."""
    data = r2_data()
    return [[(torch.as_tensor(np.asarray(b.data, np.float32)).to(dev), b.lo)
             for b in level] for level in data.level_data], data.level_geometry


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["nearest", "trilinear"])
def test_device_ingestion_matches_cpu(cuda, sampling):
    """prepare_device_amr from CUDA tensors equals the same call on the
    CPU: canonical table, scalar ranges and the frame, which launches the
    tile-march kernel."""
    from amrvolumerenderer_torch.device_scene import prepare_device_amr

    params = RenderParameters(width=64, height=48, sampling=sampling)
    renderers = []
    for dev in (cuda, torch.device("cpu")):
        levels, geoms = r2_tensor_levels(dev)
        renderers.append(prepare_device_amr(levels, geoms, parameters=params,
                                            device=dev))
    gpu, cpu = renderers
    assert gpu.canonical.device.type == "cuda"
    assert torch.equal(gpu.canonical.cpu(), cpu.canonical)
    assert gpu.geometry.original_scalar_range == cpu.geometry.original_scalar_range
    assert gpu.scalar_range == cpu.scalar_range
    cam = auto_orbit_camera(gpu.bounds)
    before = tm.tilemarch_render.launches
    got = gpu.render(cam)
    assert tm.tilemarch_render.launches == before + 1
    want = cpu.render(cam)
    assert (want[:, 3] > 0).mean() > 0.1
    assert_close(torch.from_numpy(got), torch.from_numpy(want))


@pytest.mark.cuda
def test_device_histogram_and_stats_match_cpu(cuda):
    """device_histogram and device_scalar_stats of CUDA tensors equal the
    CPU tensor route's, with NaN, inf and subnormal samples."""
    from amrvolumerenderer_torch.device_scene import (
        device_histogram,
        device_scalar_stats,
    )
    from amrvolumerenderer_torch.types import ScalarTransform

    rng = np.random.default_rng(5)
    arrays = [(rng.random((16, 16, 16)) * 2 - 0.3).astype(np.float32)
              for _ in range(3)]
    arrays[0][0, 0, 0], arrays[1][1, 1, 1], arrays[2][2, 2, 2] = np.nan, np.inf, 1e-40
    cpu = [torch.from_numpy(a) for a in arrays]
    gpu = [t.to(cuda) for t in cpu]
    assert device_scalar_stats(gpu) == device_scalar_stats(cpu)
    for t in (ScalarTransform(),
              ScalarTransform(log_scale_input=True, positive_floor=1e-3,
                              normalize_to_unit_range=True,
                              normalization_min=-6.9, normalization_max=0.7,
                              inverse_normalization_span=1 / 7.6)):
        got = device_histogram(gpu, t, 97, (0.0, 1.0))
        want = device_histogram(cpu, t, 97, (0.0, 1.0))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 3 * 16 ** 3


@pytest.mark.cuda
def test_compute_histogram_bins_on_the_card_by_default(cuda, tmp_path, monkeypatch):
    """``compute_histogram(plotfile)`` and ``api.compute_histogram`` with
    no device bin the bricks as CUDA tensors, with the CPU call's counts."""
    import amrvolumerenderer_torch
    from amrvolumerenderer_torch import device_scene
    from amrvolumerenderer_torch.plotfile import write_plotfile

    data = r2_data()
    plotfile = str(tmp_path / "plt00000")
    write_plotfile(plotfile, data.level_data, data.level_geometry)
    seen = []
    binned = device_scene.device_histogram

    def spy(arrays, *args, **kw):
        seen.append([a.device.type if isinstance(a, torch.Tensor) else "numpy"
                     for a in arrays])
        return binned(arrays, *args, **kw)

    monkeypatch.setattr(device_scene, "device_histogram", spy)
    got = amrvolumerenderer_torch.compute_histogram(plotfile, bins=64)
    assert seen and set(seen[-1]) == {"cuda"}
    assert got == amrvolumerenderer_torch.compute_histogram(plotfile, bins=64,
                                                           device="cpu")
    assert set(seen[-1]) == {"cpu"}
    hist = api.compute_histogram(data, api.HistogramOptions(bin_count=64))
    assert set(seen[-1]) == {"cuda"}
    want = api.compute_histogram(data, api.HistogramOptions(bin_count=64,
                                                            device="cpu"))
    np.testing.assert_array_equal(hist.bin_counts, want.bin_counts)
    assert hist.sample_count == want.sample_count > 0


@pytest.mark.cuda
def test_raymarch_golden_row(cuda, tmp_path):
    """render_method="raymarch" on the card reproduces ``raymarch-1dev``,
    marching its one bucket with one launch of the march kernel and
    folding its layers with one pixel-mode composite launch."""
    before = comp.composite_pixels.launches
    marched = rm.render_bucket_into.launches
    image, _ = api.render(r2_data(), api.RenderOptions(
        width=48, height=48, render_method="raymarch", device=cuda,
        output_filename=str(tmp_path / "ray.ppm")), verbose=False)
    assert comp.composite_pixels.launches == before + 1
    assert rm.render_bucket_into.launches == marched + 1  # one bucket
    ref = np.load(GOLDEN)["raymarch-1dev"]
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(image.pixels), finite)
    np.testing.assert_allclose(image.pixels[finite], ref[finite], rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("aa", [1, 4])
def test_raymarch_matches_cpu(cuda, aa):
    """The 3-level scene through the raymarch route on the card (one march
    kernel launch a bucket) equals the same call on the CPU, bit for
    bit."""
    geometry = three_level_geometry()
    params = RenderParameters(width=96, height=80, antialiasing=aa)
    marched = rm.render_bucket_into.launches
    got, _ = render_scene("", params, geometry, verbose=False,
                          method="raymarch", device=cuda)
    buckets = len(build_brick_buckets(geometry.bricks))
    assert rm.render_bucket_into.launches == marched + buckets
    want, _ = render_scene("", params, geometry, verbose=False,
                           method="raymarch", device="cpu")
    assert (want.pixels[:, 3] > 0).mean() > 0.1
    np.testing.assert_array_equal(got.pixels, want.pixels)


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["float32", "ubyte"])
def test_sharded_raymarch_matches_cpu(cuda, transport):
    """render_and_composite_sharded over 8 shards of the card equals the
    CPU mesh's frame; each shard's march is one launch of the march
    kernel and its fold a pixel-mode launch."""
    from amrvolumerenderer_torch.camera import compute_box_depth_hint
    from amrvolumerenderer_torch.colormap import build_color_table
    from amrvolumerenderer_torch.ops.raymarch import max_steps_for_bucket
    from amrvolumerenderer_torch.parallel import directsend as ds
    from amrvolumerenderer_torch.scene import assign_owners, build_brick_buckets

    geometry = api.load_amr_geometry(r2_data(), 0, -1, 0, False, True, verbose=False)
    assign_owners(geometry, 8)
    bounds = compute_global_bounds(geometry)
    camera = auto_orbit_camera(bounds)
    rsd = compute_reference_sample_distance(geometry, bounds)
    srange = geometry.scalar_range
    (bucket,) = build_brick_buckets(geometry.bricks)
    steps = np.array([max(b.min_spacing() * 0.5, 1e-5) for b in geometry.bricks],
                     np.float32)
    luts = np.stack([build_color_table(1.0, s / rsd, srange, None) for s in steps])
    hints = np.array([compute_box_depth_hint(b.min_corner, b.max_corner, camera)
                      for b in geometry.bricks], np.float32)
    tables = (bucket.data, bucket.min_corner, bucket.max_corner, bucket.cell_dims,
              luts, steps, np.ones(8, bool), hints)
    forward, right, up = camera_basis(camera)
    t = geometry.scalar_transform
    args = ([np.asarray(v, np.float32) for v in (camera.eye, forward, right, up)],
            camera.fov_y_degrees, srange[0], 1.0 / (srange[1] - srange[0]),
            (t.positive_floor, t.normalization_min, t.inverse_normalization_span))
    kw = dict(width=64, height=48, transport=transport,
              num_steps=max_steps_for_bucket(tables[1], tables[2], steps),
              log_scale=t.log_scale_input, normalize=t.normalize_to_unit_range,
              clip_start=1.0, apply_clip=False)
    before = comp.composite_pixels.launches
    marched = rm.render_bucket_into.launches
    got = ds.render_and_composite_sharded(ds.make_mesh(8, cuda), *tables, *args, **kw)
    assert comp.composite_pixels.launches == before + 8
    assert rm.render_bucket_into.launches == marched + 8  # one a shard
    want = ds.render_and_composite_sharded(ds.make_mesh(8, "cpu"), *tables, *args, **kw)
    assert (torch.cat(want)[:, 3] > 0).float().mean() > 0.1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def raymarch_bucket(case):
    """(positional, keyword) arguments of ``render_bucket_into`` after
    ``out`` for one kernel-vs-plain case: the golden r^2 scene's bucket,
    or 4 seeded bricks (tests/test_torch_raymarch.py's generator: cropped
    cell counts, non-finite cells, per-brick LUTs and steps) seen
    obliquely (also on a 33x17 frame, whose rows are not 16-byte
    aligned), along an axis on a one-pixel-wide frame (rays parallel to
    the x axis: the slab test's guard), or from inside a box."""
    from amrvolumerenderer_torch.colormap import build_color_table
    from amrvolumerenderer_torch.ops.raymarch import max_steps_for_bucket

    name, lut_size, flags, fold = case
    camera = CameraParameters(eye=(1.6, 1.2, 1.9), look_at=(0.5, 0.5, 0.5),
                              up=(0, 1, 0), fov_y_degrees=41.0)
    width, height = 64, 48
    scalars = (0.0, 1.3, 0.05, -1.0, 0.7)
    if name == "r2":
        geometry = api.load_amr_geometry(r2_data(), 0, -1, 0, False, True,
                                         verbose=False)
        (bucket,) = build_brick_buckets(geometry.bricks)
        bounds = compute_global_bounds(geometry)
        rsd = compute_reference_sample_distance(geometry, bounds)
        srange = geometry.scalar_range
        step = np.array([max(b.min_spacing() * 0.5, 1e-5) for b in geometry.bricks],
                        np.float32)
        lut = np.stack([build_color_table(1.0, s / rsd, srange, None, size=lut_size)
                        for s in step])
        data, bmin, bmax, dims = (bucket.data, bucket.min_corner, bucket.max_corner,
                                  bucket.cell_dims)
        camera = auto_orbit_camera(bounds)
        scalars = (srange[0], 1.0 / (srange[1] - srange[0]), 0.0, 0.0, 1.0)
    else:
        rng = np.random.default_rng(len(name) + lut_size)
        nb, shape = 4, (12, 10, 9)
        data = (rng.random((nb,) + shape) * 2.0 + 0.01).astype(np.float32)
        data[0, 0, 0, 0] = np.nan
        data[1, 1, 1, 1] = -np.inf
        bmin = rng.uniform(-0.2, 0.6, (nb, 3)).astype(np.float32)
        bmax = (bmin + rng.uniform(0.25, 0.7, (nb, 3))).astype(np.float32)
        dims = np.array([[12 - rng.integers(0, 3), 10, 9 - rng.integers(0, 2)]
                         for _ in range(nb)], np.int32)
        lut = rng.random((nb, lut_size, 4)).astype(np.float32)
        lut[..., 3] *= 0.3
        step = rng.uniform(0.01, 0.04, nb).astype(np.float32)
        center = (0.5 * (bmin[0] + bmax[0])).tolist()
        if name == "axis":
            camera = CameraParameters(eye=(center[0], center[1], 3.0),
                                      look_at=(center[0], center[1], 0.5),
                                      up=(0, 1, 0), fov_y_degrees=45.0)
            width, height = 1, 96
        elif name == "odd":  # rows of 561 pixels: no 16-byte row alignment
            width, height = 33, 17
        elif name == "inside":
            camera = CameraParameters(eye=tuple(center), look_at=(0.5, 0.5, -1.0),
                                      up=(0, 1, 0), fov_y_degrees=60.0)
    forward, right, up = camera_basis(camera)
    args = (np.arange(len(data))[::-1].copy(), data, bmin, bmax, dims, lut, step,
            *(np.asarray(v, np.float32) for v in (camera.eye, forward, right, up)),
            camera.fov_y_degrees, *(float(np.float32(v)) for v in scalars))
    log_scale, normalize, apply_clip = flags
    kw = dict(width=width, height=height,
              num_steps=max_steps_for_bucket(bmin, bmax, step), log_scale=log_scale,
              normalize=normalize, clip_start=0.8, apply_clip=apply_clip,
              fold_camera=fold)
    return args, kw


# (scene, LUT entries, (log scale, normalize, soft clip), fold_camera)
RAYMARCH_CASES = [("r2", 256, (False, False, False), False),
                  ("r2", 128, (False, False, False), True),
                  ("seeded", 256, (True, True, True), False),
                  ("seeded", 128, (True, False, True), False),
                  ("seeded-flat", 256, (False, True, False), True),
                  ("axis", 256, (True, True, True), False),
                  ("odd", 128, (True, True, False), False),
                  ("inside", 256, (False, True, True), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAYMARCH_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}{'-fold' if c[3] else ''}")
def test_raymarch_kernel_matches_plain(cuda, case):
    """One launch of the march kernel against its plain version on the
    card, max |diff| 0 with the same non-finite pattern; both write their
    rows whole (a NaN-filled stack keeps only its spare row)."""
    args, kw = raymarch_bucket(case)
    rows, pixels = len(args[0]), kw["width"] * kw["height"]
    got = torch.full((rows + 1, pixels, 5), float("nan"), device=cuda)
    want = torch.full((rows + 1, pixels, 5), float("nan"), device=cuda)
    before = rm.render_bucket_into.launches
    rm.render_bucket_into(got, *args, **kw)
    assert rm.render_bucket_into.launches == before + 1
    samples = rm.render_bucket_into_reference(want, *args, count_samples=True, **kw)
    torch.cuda.synchronize()
    assert rm.render_bucket_into.launches == before + 1
    assert torch.isnan(got[rows]).all() and not torch.isnan(got[:rows]).any()
    assert (want[:rows, :, 3] > 0).any() and int(samples) > 0
    got, want = got[:rows].cpu().numpy(), want[:rows].cpu().numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[finite], want[finite])


# the contention scene's 2^3 cells, 0.6 to 0.6035: one LUT bin of 256 over
# [0, 1], and a gradient along every axis
CONTENTION_CELLS = (0.6 + 0.0005 * np.fromfunction(lambda x, y, z: x + 2 * y + 4 * z,
                                                   (2, 2, 2))).astype(np.float32)


def diff_scene(name):
    """(args, static) of the differentiable path as NumPy arrays:
    tests/test_diff.py's 6^3 scene at 12x12 and 64 steps (its smooth LUT,
    an opaque-tail LUT whose rays saturate at alpha exactly 1, and a
    log-scaled, normalised, soft-clipped variant, and a 1024-entry LUT, whose
    backward's float64 copies are shared by warps), the golden manifest's
    r^2 scene through ``prepare_geometry``, or the march's worst
    contention: one brick of 2^3 cells (``CONTENTION_CELLS``) seen face on
    at 64x64, so that every sample reads the same eight cells and falls
    into one LUT bin."""
    from amrvolumerenderer_torch import diff

    if name == "contention":
        camera = CameraParameters(eye=(0.5, 0.5, 2.5), look_at=(0.5, 0.5, 0.5),
                                  up=(0.0, 1.0, 0.0), fov_y_degrees=20.0)
        args, static = diff.prepare_scene(
            [(CONTENTION_CELLS, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))],
            camera, width=64, height=64, device="cpu")
        return tuple(a.numpy() for a in args), static
    if name == "r2":
        geometry = api.load_amr_geometry(r2_data(), 0, -1, 0, False, True,
                                         verbose=False)
        camera = CameraParameters(eye=(1.6, 1.3, 2.4), look_at=(0.5, 0.5, 0.5),
                                  up=(0.0, 1.0, 0.0))
        args, static = diff.prepare_geometry(geometry, camera, width=48, height=40,
                                             device="cpu")
        return tuple(a.numpy() for a in args), static
    rng = np.random.default_rng(11)
    data = rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32)
    t = np.linspace(0.0, 1.0, 1024 if name == "lut1024" else 256)
    lut = np.stack([t, np.full_like(t, 0.4), 1.0 - t, 0.3 * t], 1).astype(np.float32)
    scalars = (0.0, 1.0, 0.0, 0.0, 1.0)
    static = dict(width=12, height=12, num_steps=64, log_scale=False,
                  normalize=False, clip_start=1.0, apply_clip=False)
    if name == "saturating":
        lut[160:, 3] = 1.0
    if name == "log":
        data = rng.uniform(0.01, 5.0, size=(6, 6, 6)).astype(np.float32)
        scalars = (0.0, 1.0, 0.02, np.log(0.02), 1.0 / (np.log(5.0) - np.log(0.02)))
        static.update(log_scale=True, normalize=True, apply_clip=True, clip_start=0.7)
    camera = CameraParameters(eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.5),
                              up=(0.0, 1.0, 0.0), fov_y_degrees=45.0)
    forward, right, up = camera_basis(camera)
    f32 = np.float32
    args = (data[None], np.zeros((1, 3), f32), np.ones((1, 3), f32),
            np.full((1, 3), 6, np.int32), lut[None], np.full(1, 1.0 / 12, f32),
            *(np.asarray(v, f32) for v in (camera.eye, forward, right, up)),
            f32(camera.fov_y_degrees), *(f32(v) for v in scalars))
    return args, static


def diff_run(args, static, weights, argnums, device):
    """The image, layer depths and the gradients of ``sum(image *
    weights)`` with respect to ``argnums``, computed on ``device``."""
    from amrvolumerenderer_torch import diff

    targs = list(diff.args_from_arrays(args, device))
    for i in argnums:
        targs[i].requires_grad_(True)
    image = diff.render_image_diff(*targs, **static)
    (image * torch.from_numpy(weights).to(device)).sum().backward()
    with torch.no_grad():
        _, depth = diff.render_layers_diff(*targs, **static)
    return (image.detach().cpu(), depth.cpu(),
            [targs[i].grad.cpu().numpy() for i in argnums])


def camera_terms(args, static, weights, argnum):
    """Per component of camera argument ``argnum``, the sum over pixels of
    ``|weights * d image / d component|``: the scale a reordered sum of a
    camera gradient's terms rounds against.  Forward mode on the CPU, one
    pass a component."""
    import torch.autograd.forward_ad as fwAD

    from amrvolumerenderer_torch import diff

    targs = list(diff.args_from_arrays(args, "cpu"))
    base = targs[argnum]
    terms = []
    for c in range(base.numel()):
        tangent = torch.zeros(base.numel())
        tangent[c] = 1.0
        with fwAD.dual_level():
            full = list(targs)
            full[argnum] = fwAD.make_dual(base, tangent.reshape(base.shape))
            out = diff.render_image_diff(*full, remat=False, **static)
            column = fwAD.unpack_dual(out).tangent
        terms.append(float((column * torch.from_numpy(weights)).abs().sum()))
    return np.asarray(terms).reshape(base.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test_diff", "saturating", "log", "r2"])
def test_diff_matches_cpu(cuda, name):
    """``diff.render_image_diff`` on the card against the same call on the
    CPU: the image at 2e-6 with the same non-finite depth pattern; the
    gradients of a randomly weighted loss with respect to data and LUT at
    1e-4 x max |g_CPU| (the card's scatter-add backward adds in another
    order), and with respect to eye, basis and field of view, each a sum
    over the frame whose terms cancel, at 1e-4 x the sum of their terms'
    magnitudes (``camera_terms``)."""
    args, static = diff_scene(name)
    n = static["width"] * static["height"]
    w = np.random.default_rng(7).uniform(0, 1, size=(n, 4)).astype(np.float32)
    argnums = (0, 4, 6, 7, 8, 9, 10)
    got_image, got_depth, got = diff_run(args, static, w, argnums, cuda)
    want_image, want_depth, want = diff_run(args, static, w, argnums, "cpu")
    assert float(want_image[:, 3].max()) > 0.0
    if name == "saturating":
        assert float(want_image[:, 3].max()) == 1.0
    assert_close(got_image, want_image)
    assert_close(got_depth, want_depth)
    for g, ref in zip(got[:2], want[:2]):
        assert np.abs(g - ref).max() <= 1e-4 * np.abs(ref).max()
    for i, g, ref in zip(argnums[2:], got[2:], want[2:]):
        terms = camera_terms(args, static, w, i)
        assert np.all(terms > 0.0)
        assert np.all(np.abs(g - ref) <= 1e-4 * terms), (i, np.abs(g - ref) / terms)


def diff_march_case(name, dev):
    """The ``MarchInputs`` and ``MarchConfig`` that ``render_layers_diff``
    hands the march on ``dev`` for ``diff_scene(name)``."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm

    args, static = diff_scene(name)
    seen, inner = [], dm.march
    dm.march = lambda m, cfg: (seen.append((m, cfg)), inner(m, cfg))[1]
    try:
        with torch.no_grad():
            diff.render_layers_diff(*diff.args_from_arrays(args, dev), **static)
    finally:
        dm.march = inner
    (case,) = seen
    return case


# fields that carry a tangent: the eye's forward mode (the first distance
# and the eye), the data alone, the LUT alone, every field
TANGENT_MASKS = {"eye": ("d0", "eye"), "data": ("data",), "lut": ("luts",),
                 "all": ("data", "luts", "d0", "directions", "eye", "steps", "bmin", "cell",
                         "scalars")}


def assert_rel_close(got, want, rel=1e-4):
    """Each pair at ``rel`` of the reference's scale (``DIFF_GRAD_REL``)."""
    for g, w in zip(got, want):
        w = w.to(g.device)
        assert float((g - w).abs().max()) <= rel * float(w.abs().max()), (
            float((g - w).abs().max()), float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test_diff", "saturating", "log", "r2", "contention",
                                  "lut1024"])
def test_diffmarch_kernels_match_plain(cuda, name):
    """The differentiable march's kernels on the card against their plain
    versions: the forward at max |diff| 0 with the same non-finite pattern
    (on the card and on the CPU), the backward (from the forward's
    checkpoints) and the tangent at 1e-4 of each output's scale against the
    plain versions on the card and on the CPU (the kernels add with
    atomics, in another order); the tangent for the fields of each of
    ``TANGENT_MASKS`` (the others None: their terms compiled out), against
    the plain version given the same fields."""
    from amrvolumerenderer_torch.ops import diffmarch as dm

    m, cfg = diff_march_case(name, cuda)
    mc = dm.MarchInputs(*(t.cpu() for t in m))
    out, ckpt = dm.diffmarch_forward(m, cfg, keep=True)
    for plain in (dm.march_forward_reference(m, cfg).cpu(),
                  dm.march_forward_reference(mc, cfg)):
        assert_close(out.cpu(), plain)
        assert torch.equal(out.cpu(), plain)
    rng = np.random.default_rng(4)
    grad = torch.from_numpy(rng.uniform(-1, 1, size=(*m.d0.shape, 4)).astype(
        np.float32))
    got = dm.diffmarch_backward(m, cfg, grad.to(cuda), ckpt)
    assert all(float(g.abs().max()) > 0.0 for g in got[:2])
    assert_rel_close(got, dm.march_backward_reference(m, cfg, grad.to(cuda)))
    assert_rel_close(got, dm.march_backward_reference(mc, cfg, grad))
    every = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
             for t in mc[:dm.DIFFERENTIABLE]]
    for fields in TANGENT_MASKS.values():
        tangents = [t if f in fields else None
                    for f, t in zip(dm.MarchInputs._fields, every)]
        on_card = [None if t is None else t.to(cuda) for t in tangents]
        got_t = dm.diffmarch_tangent(m, cfg, on_card)
        assert_rel_close([got_t], [dm.march_tangent_reference(m, cfg, on_card)])
        assert_rel_close([got_t], [dm.march_tangent_reference(mc, cfg, tangents)])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["both", "no_lut", "no_data", "neither"])
@pytest.mark.parametrize("name", ["r2", "contention"])
def test_diffmarch_backward_needs_match_plain(cuda, name, which):
    """The backward kernel forming the data and LUT gradients or not (the
    ``needs`` of the Function's backward): each formed gradient at 1e-4 of
    its scale against the plain version on the card and on the CPU, the
    others zero; on the contention scene every step adds into the same
    eight cells and the same LUT rows."""
    from amrvolumerenderer_torch.ops import diffmarch as dm

    needs = {"both": (True, True), "no_lut": (True, False), "no_data": (False, True),
             "neither": (False, False)}[which] + (True,) * (dm.DIFFERENTIABLE - 2)
    m, cfg = diff_march_case(name, cuda)
    mc = dm.MarchInputs(*(t.cpu() for t in m))
    _, ckpt = dm.diffmarch_forward(m, cfg, keep=True)
    grad = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, size=(*m.d0.shape, 4)).astype(np.float32))
    got = dm.diffmarch_backward(m, cfg, grad.to(cuda), ckpt, needs)
    formed = [i for i in range(dm.DIFFERENTIABLE) if i >= 2 or needs[i]]
    for i in range(2):
        if needs[i]:
            assert float(got[i].abs().max()) > 0.0
        else:
            assert float(got[i].abs().max()) == 0.0
    for plain in (dm.march_backward_reference(m, cfg, grad.to(cuda), needs),
                  dm.march_backward_reference(mc, cfg, grad, needs)):
        assert_rel_close([got[i] for i in formed], [plain[i] for i in formed])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["r2", "contention"])
def test_diffmarch_pairs_match_plain(cuda, name):
    """The pair list on the card: each brick's count equal to the plain
    version's (and to NumPy's), its listed pixels the same set (each
    kernel block's in pixel order, the blocks in any order), and with
    ``zero_rows`` the misses' rows zero and the hits' rows untouched."""
    from amrvolumerenderer_torch.ops import diffmarch as dm

    m, _ = diff_march_case(name, cuda)
    pixels, counts = dm.diffmarch_pairs(m.hit)
    want_pixels, want_counts = dm.hit_pairs_reference(m.hit.cpu())
    hit = m.hit.cpu().numpy()
    np.testing.assert_array_equal(counts.cpu().numpy(), hit.sum(1))
    assert torch.equal(counts.cpu(), want_counts)
    for b, c in enumerate(want_counts.tolist()):
        np.testing.assert_array_equal(np.sort(pixels[b, :c].cpu().numpy()),
                                      want_pixels[b, :c].numpy())
    rows = torch.full((*m.hit.shape, 4), 7.0, device=cuda)
    dm.diffmarch_pairs(m.hit, rows)
    rows = rows.cpu().numpy()
    assert np.all(rows[~hit] == 0.0) and np.all(rows[hit] == 7.0)


def double_rounding_triples(n, seed=0):
    """float32 ``(a, b, c)`` whose float64 ``a * b + c`` falls exactly
    halfway between two float32 values while the exact sum lies just
    beyond it: ``a = 1 + u 2^-12`` and ``b = 2^-24 (1 - u 2^-12 + u^2
    2^-24)`` for u in 1..5 give ``a * b = 2^-24 + u^3 2^-60``, and ``c`` is
    in +-[1, 2); where ``c``'s last bit is even a second rounding goes the
    wrong way.  Then ``n`` random normal triples."""
    rng = np.random.default_rng(seed)
    u = rng.integers(1, 6, n).astype(np.float64)
    a64 = 1.0 + u * 2.0 ** -12
    b64 = 2.0 ** -24 * (1.0 - u * 2.0 ** -12 + u ** 2 * 2.0 ** -24)
    a, b = a64.astype(np.float32), b64.astype(np.float32)
    assert np.array_equal(a, a64) and np.array_equal(b, b64)  # exact in float32
    sign = rng.choice([-1.0, 1.0], n).astype(np.float32)
    c = (1.0 + rng.integers(0, 2 ** 23, n) * 2.0 ** -23).astype(np.float32)
    rand = rng.standard_normal((3, n)).astype(np.float32)
    return (np.concatenate([a * sign, rand[0]]), np.concatenate([b, rand[1]]),
            np.concatenate([c * sign, rand[2]]))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["ties", "broadcast", "special", "tracked", "diff-walks",
                                  "straddle", "unaligned", "scalar-positions"])
def test_fma_kernel_matches_plain(cuda, form):
    """``numerics.fma`` on the card (``csrc/numerics.cu``, one launch a
    call) against its plain version ``fma_reference`` on the card and on
    the CPU, bit for bit: on constructed double-rounding ties and random
    triples, on broadcast operands (rows, a number, a transposed view, a
    strided view, 0-d tensors), on special values, with autograd tracking
    (the value once rounded, the gradient the float64 expression's), on the
    diff call's walks (the depth's entry over 13 bricks, whose directions
    repeat along the bricks, the fold step, the depth's dot product, the
    ray grid's rows), on rows of 3 whose runs straddle a row end, on
    operands one float off 16-byte alignment, and with a 0-d tensor and a
    number in each operand position."""
    from amrvolumerenderer_torch.ops import numerics

    rng = np.random.default_rng(12)
    f = torch.float32
    if form in ("ties", "tracked"):
        cases = [tuple(torch.from_numpy(v) for v in double_rounding_triples(2048))]
    elif form == "broadcast":
        cases = [(torch.randn(50, 3), torch.randn(7, 50, 1), torch.randn(3)),
                 (torch.randn(7, 50, 4), 0.5, torch.randn(7, 50, 4)),
                 (torch.randn(60, 40).t(), torch.randn(40, 60), 1.0),
                 (torch.randn(7, 50, 2, 2)[..., 0], torch.randn(7, 50, 1), torch.randn(())),
                 (torch.tensor(2.0), 3.0, torch.tensor(1.0))]
    elif form == "diff-walks":
        n = 1 << 16
        cases = [(torch.randn(n, 3), torch.randn(13, n, 1), torch.randn(3)),
                 (torch.randn(n, 4), 1.0 - torch.rand(n, 4)[:, 3:4], torch.randn(n, 4)),
                 (torch.randn(13, n, 3)[..., 2], torch.tensor(0.25), torch.randn(13, n)),
                 (torch.randn(1024, 1, 1), torch.randn(3), torch.randn(1, 1024, 3))]
    elif form == "straddle":
        cases = [(torch.randn(4097, 3), torch.randn(3), torch.randn(4097, 1)),
                 (torch.randn(5, 999, 3), torch.randn(999, 1), torch.randn(3)),
                 (torch.randn(4099), torch.randn(4099), -1.0)]
    elif form == "unaligned":  # views made on each device, so the card keeps them
        bases = [torch.randn(4097), torch.randn(4096), torch.randn(4099),
                 torch.randn(3, 4097), torch.randn(3, 1)]
        cases = [lambda b: (b[0][1:], b[1], b[2][3:]),
                 lambda b: (b[2][1:4097], 2.0, b[0][:4096]),
                 lambda b: (b[3][:, 1:], b[0][1:], b[4])]
    elif form == "scalar-positions":
        cases = []
        for k in range(3):
            for scalar in (torch.tensor(0.75), 0.75):
                ops = [torch.randn(33, 5), torch.randn(5), torch.randn(33, 1)]
                ops[k] = scalar
                cases.append(tuple(ops))
    else:
        special = torch.tensor([np.inf, -np.inf, np.nan, 0.0, -0.0, 1.0, -1.5, 3.4e38,
                                -3.4e38, 2.0 ** -60, 1e-40], dtype=f)
        cases = [tuple(g.reshape(-1) for g in torch.meshgrid(special, special, special,
                                                              indexing="ij"))]
    del rng
    for ops in cases:
        if callable(ops):
            ops, on_card = ops(bases), ops([t.to(cuda) for t in bases])
        else:
            on_card = [v.to(cuda) if isinstance(v, torch.Tensor) else v for v in ops]
        before = numerics.fma.launches
        if form == "tracked":
            leaves = [v.clone().requires_grad_(True) for v in on_card]
            got = numerics.fma(*leaves)
            got.sum().backward()
            ref = [v.clone().requires_grad_(True) for v in on_card]
            (ref[0].double() * ref[1].double() + ref[2].double()).float().sum().backward()
            for g, w in zip(leaves, ref):
                assert torch.equal(g.grad, w.grad)
            got = got.detach()
        else:
            got = numerics.fma(*on_card)
        torch.cuda.synchronize()
        assert numerics.fma.launches == before + 1
        for want in (numerics.fma_reference(*on_card).cpu(), numerics.fma_reference(*ops)):
            got_c = got.cpu()
            assert got_c.shape == want.shape
            assert torch.equal(torch.isnan(got_c), torch.isnan(want))
            finite = ~torch.isnan(want)
            assert torch.equal(got_c[finite], want[finite])
            assert torch.equal(torch.signbit(got_c[finite]), torch.signbit(want[finite]))
    with pytest.raises(ValueError, match="float32 tensors"):
        numerics.fma(torch.ones(3, dtype=torch.float64, device=cuda), 1.0, 1.0)


@pytest.mark.cuda
def test_diffmarch_launch_counts(cuda):
    """A call takes the pair path: one pair build (``diffpairs_build``),
    one march forward launch over its rows, one pair fold forward launch,
    and under reverse mode one backward launch of each; no dense pair list
    and no dense fold.  Forward mode takes the dense rows: the forward and
    its tangent instantiation, each after a dense pair list, and the eager
    fold (the layers carry a tangent).  A sharded call takes the dense rows
    a shard: one march forward and backward, one dense pair list, one
    ``fold_diff`` forward and backward a shard."""
    import torch.autograd.forward_ad as fwAD

    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm
    from amrvolumerenderer_torch.parallel import directsend as ds

    fns = (dm.diffmarch_forward, dm.diffmarch_backward, dm.diffmarch_tangent,
           dm.diffmarch_pairs, comp.fold_diff_forward, comp.fold_diff_backward,
           dm.diffpairs_build, comp.diffpairs_fold_forward, comp.diffpairs_fold_backward)

    def counted(fn):
        for f in fns:
            f.launches = 0
        fn()
        torch.cuda.synchronize()
        return [f.launches for f in fns]

    args, static = diff_scene("test_diff")
    targs = list(diff.args_from_arrays(args, cuda))
    with torch.no_grad():
        assert counted(lambda: diff.render_image_diff(*targs, **static)) == [
            1, 0, 0, 0, 0, 0, 1, 1, 0]
    lut = targs[4].clone().requires_grad_(True)
    assert counted(lambda: diff.render_image_diff(
        *targs[:4], lut, *targs[5:], **static).sum().backward()) == [1, 1, 0, 0, 0, 0, 1, 1, 1]

    def forward_mode():
        with fwAD.dual_level():
            eye = fwAD.make_dual(targs[6], torch.ones(3, device=cuda))
            out = diff.render_image_diff(*targs[:6], eye, *targs[7:], **static)
            assert float(fwAD.unpack_dual(out).tangent.abs().max()) > 0.0

    assert counted(forward_mode) == [1, 0, 1, 2, 0, 0, 0, 0, 0]
    bargs, bstatic = sharded_diff_scene(cuda)
    data = bargs[0].clone().requires_grad_(True)
    mesh = ds.make_mesh(4, "cuda")
    assert counted(lambda: diff.render_image_diff(
        data, *bargs[1:], mesh=mesh, **bstatic).mean().backward()) == [
        4, 4, 0, 4, 4, 4, 0, 0, 0]


@pytest.mark.cuda
def test_diff_fitting_step_replays_as_cuda_graph(cuda):
    """One transfer-function fitting step (forward, ``backward()`` through
    the backward kernel, an SGD step), captured as a CUDA graph after two
    warm-up steps on a side stream and replayed three times, against the
    same steps run eagerly: losses and parameters at 1e-5 (the backward's
    atomics add in another order each run); the loss falls.  The capture
    holds one pair build and one launch of each pair fold kernel."""
    from amrvolumerenderer_torch import diff

    args, static = diff_scene("test_diff")
    targs = list(diff.args_from_arrays(args, cuda))
    targs[10] = float(args[10])  # a number: the field of view reads no device value
    with torch.no_grad():
        target = diff.render_image_diff(*targs, **static)
    start = (targs[4] * 0.5).clone()

    def make():
        lut = start.clone().requires_grad_(True)
        opt = torch.optim.SGD([lut], lr=10.0)

        def step():
            image = diff.render_image_diff(*targs[:4], lut, *targs[5:], **static)
            loss = ((image - target) ** 2).mean()
            loss.backward()
            opt.step()
            return loss.detach()

        return lut, opt, step

    lut_e, opt_e, step_e = make()
    eager = []
    for _ in range(5):
        opt_e.zero_grad(set_to_none=True)
        eager.append(float(step_e()))
    lut_g, opt_g, step_g = make()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graphed = []
    with torch.cuda.stream(side):
        for _ in range(2):
            opt_g.zero_grad(set_to_none=True)
            graphed.append(float(step_g()))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    opt_g.zero_grad(set_to_none=True)
    from amrvolumerenderer_torch.ops import diffmarch as dm

    counters = (dm.diffpairs_build, comp.diffpairs_fold_forward, comp.diffpairs_fold_backward)
    folds = [f.launches for f in counters]
    with torch.cuda.graph(graph):
        loss = step_g()
    assert [f.launches for f in counters] == [n + 1 for n in folds]
    for _ in range(3):
        graph.replay()
        graphed.append(float(loss))
    np.testing.assert_allclose(graphed, eager, rtol=1e-5)
    assert eager[-1] < eager[0]
    assert float((lut_g - lut_e).abs().max()) <= 1e-5 * float(lut_e.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("order_kind", ["identity", "permuted"])
@pytest.mark.parametrize("num_layers", [1, 8, 13])
def test_fold_diff_kernels_match_layer_loop(cuda, num_layers, order_kind):
    """``diff.composite_layers_diff`` on the card (``comp.fold_diff``: one
    forward and one backward launch, no ``numerics.fma`` launch) against
    the eager loop on the same card (a ``numerics.fma`` launch a layer and
    ``_Fma``'s float64 backward), over 1000 pixels (not a multiple of the
    kernels' 256-pixel block): the image and the layers' gradient equal
    bit for bit, clip ties, opaque layers and -0.0 products included.
    Each kernel also equals its plain version run on the card."""
    from amrvolumerenderer_torch import diff

    colors, order, weights = fold_case(num_layers, 1000, order_kind)
    before = fold_counters()
    image, grad = fold_run(diff.composite_layers_diff, colors, order, weights, cuda)
    assert fold_counters() == (before[0] + 1, before[1] + 1, before[2])
    want_image, want_grad = fold_run(diff._fold_layer_loop, colors, order, weights, cuda)
    assert fold_counters() == (before[0] + 1, before[1] + 1, before[2] + num_layers)
    assert float(want_image[:, 3].max()) == 1.0
    assert same_bits(image, want_image)
    differ = grad.view(torch.int32) != want_grad.view(torch.int32)
    assert int(differ.sum()) == 0, (int(differ.sum()), float((grad - want_grad).abs().max()))

    c, o = colors.to(cuda), order.to(cuda)
    got = comp.fold_diff_forward(c, o, keep=True)
    ref = comp.fold_diff_forward_reference(c, o, keep=True)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    g = weights.to(cuda)
    assert same_bits(comp.fold_diff_backward(g, c, o, *got[1:]),
                     comp.fold_diff_backward_reference(g, c, o, *ref[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tangent", "short_order", "long_order"])
def test_fold_diff_routing_on_card(cuda, case):
    """Layers with a forward-mode tangent, and an order of another length
    than the layers', take the eager loop on the card: a ``numerics.fma``
    launch a folded layer and no fold kernel; the result is the loop's."""
    import torch.autograd.forward_ad as fwAD

    from amrvolumerenderer_torch import diff

    colors, order, _ = fold_case(8, 1000, "permuted")
    colors, order = colors.to(cuda), order.to(cuda)
    if case != "tangent":
        order = order[:5] if case == "short_order" else torch.cat([order, order[:3]])
    before = fold_counters()
    if case == "tangent":
        with fwAD.dual_level():
            dual = fwAD.make_dual(colors, torch.ones_like(colors))
            image, tangent = fwAD.unpack_dual(diff.composite_layers_diff(dual, order))
        assert float(tangent.abs().max()) > 0.0
    else:
        layers = colors.clone().requires_grad_(True)
        image = diff.composite_layers_diff(layers, order)
        image.sum().backward()
        assert layers.grad is not None
    assert fold_counters() == (before[0], before[1], before[2] + order.shape[0])
    with torch.no_grad():
        assert same_bits(image.detach(), diff._fold_layer_loop(colors, order))


FOLD_STOP = """
import os, sys
import torch
from test_torch_fold_diff import fold_case
from amrvolumerenderer_torch.ops import composite as comp

which, value = sys.argv[1], int(sys.argv[2])
colors, order, weights = fold_case(8, 1000, "permuted")
c, o, g = colors.cuda(), order.cuda(), weights.cuda()
_, trans, pre = comp.fold_diff_forward(c, o, keep=True)
comp.fold_diff_backward(g, c, o, trans, pre)
torch.cuda.synchronize()
print("a permutation folds", flush=True)
bad = o.clone()
bad[5] = int(order[0]) if value < 0 else value
try:
    if which == "backward":
        comp.fold_diff_backward(g, c, bad, trans, pre)
    else:
        comp.fold_diff_forward(c, bad, keep=which == "forward_keep")
    torch.cuda.synchronize()
except RuntimeError as e:
    print("stopped:", str(e).splitlines()[0], flush=True)
    os._exit(3)
print("ran to its end", flush=True)
os._exit(0)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("which, value", [
    ("forward", -1), ("forward_keep", -1), ("backward", -1), ("forward", 8)],
    ids=["forward-repeat", "forward_keep-repeat", "backward-repeat",
         "forward-out_of_range"])
def test_fold_diff_kernels_stop_on_an_order_that_is_no_permutation(cuda, which, value):
    """An order of the layers' length that repeats an index (``value`` -1:
    layer ``order[0]`` again) or holds one out of range stops each fold
    kernel (both instantiations of the forward, and the backward), which
    would otherwise leave a layer's gradient rows unwritten: the launch
    traps and the process's next synchronisation raises.  A trap loses the
    process's CUDA context, so each case runs in a process of its own,
    which first folds the sound order forward and backward."""
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests]))
    env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    proc = subprocess.run([sys.executable, "-c", FOLD_STOP, which, str(value)], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    assert proc.returncode == 3, proc.stdout[-3000:]
    assert "a permutation folds" in proc.stdout and "stopped:" in proc.stdout, proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [True, False], ids=["graph", "nograph"])
@pytest.mark.parametrize("sampling", ["nearest", "trilinear"])
def test_tilemarch_route_matches_cpu(cuda, sampling, graph):
    """The one-shot tile-march route (``render_composited_tilemarch``, the
    JAX package's route on the slice-march prep): one kernel-1 launch on
    the card, and the frame equals the CPU's bit for bit."""
    from amrvolumerenderer_torch.renderer_fast import render_composited_tilemarch

    geometry = three_level_geometry()
    params = RenderParameters(width=128, height=96, sampling=sampling,
                              use_visibility_graph=graph)
    bounds = compute_global_bounds(geometry)
    route = (geometry, params, auto_orbit_camera(bounds),
             compute_global_scalar_range(geometry),
             compute_reference_sample_distance(geometry, bounds), 128, 96, None)
    before = tm.tilemarch_render.launches
    got = render_composited_tilemarch(*route, device=cuda)
    assert tm.tilemarch_render.launches == before + 1
    want = render_composited_tilemarch(*route, device="cpu")
    assert (want[:, 3] > 0).mean() > 0.05
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[finite], want[finite])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["--orbit-frames", "2"]],
                         ids=["oneshot", "orbit"])
def test_two_processes_on_one_card_match_one_process(cuda, tmp_path, extra):
    """Two processes of the CLI on ``cuda:0`` (gloo through pinned host
    memory, as NCCL refuses two ranks on one device), ``--devices 8``:
    rank 0's images equal a one-process render's byte for byte; rank 1
    saves nothing."""
    import socket
    import subprocess
    import sys

    from amrvolumerenderer_torch.plotfile import write_plotfile

    data = r2_data()
    plotfile = str(tmp_path / "plt00000")
    write_plotfile(plotfile, data.level_data, data.level_geometry)
    argv = [plotfile, "--devices", "8", "--width", "64", "--height", "64",
            "--render-method", "slicemarch", *extra, "--output", "mh.ppm"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for tag, launch in (("rank0", {"JAX_PROCESS_ID": "0"}),
                        ("rank1", {"JAX_PROCESS_ID": "1"}), ("single", None)):
        os.makedirs(tmp_path / tag)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "LOCAL_")) and k != "AVR_DISTRIBUTED"}
        env["PYTHONPATH"] = root
        # one card, whatever the machine has
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        if launch:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES="2", LOCAL_WORLD_SIZE="2",
                       LOCAL_RANK=launch["JAX_PROCESS_ID"], **launch)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "amrvolumerenderer_torch.driver", *argv],
            cwd=str(tmp_path / tag), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "2 host(s), 1 device(s), backend gloo" in logs[0]
    assert os.listdir(tmp_path / "rank1") == []
    names = sorted(os.listdir(tmp_path / "single"))
    assert names and sorted(os.listdir(tmp_path / "rank0")) == names
    for name in names:
        assert ((tmp_path / "rank0" / name).read_bytes()
                == (tmp_path / "single" / name).read_bytes()), name


def sharded_diff_scene(device):
    """tests/test_diff.py's 8 bricks of 4^3 (seed 13) seen obliquely at 8x8
    (tests/test_torch_diff_sharded.py's "oblique" scene) on ``device``."""
    from amrvolumerenderer_torch import diff

    rng = np.random.default_rng(13)
    bricks = [(rng.uniform(0.1, 0.9, size=(4, 4, 4)).astype(np.float32),
               (0.0, 0.0, float(b)), (1.0, 1.0, float(b) + 1.0)) for b in range(8)]
    camera = CameraParameters(eye=(2.0, 1.5, 14.0), look_at=(0.5, 0.5, 4.0),
                              up=(0.0, 1.0, 0.0), fov_y_degrees=12.0)
    return diff.prepare_scene(bricks, camera, width=8, height=8, device=device)


def sharded_diff_run(device, mesh, shards=False):
    """The frame and the gradients of ``mean(frame)`` with respect to data,
    LUT and eye of ``sharded_diff_scene`` over ``mesh`` (None: the single
    call); ``shards`` passes the data as ``shard_leading`` blocks."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.parallel import directsend as ds

    args, static = sharded_diff_scene(device)
    args = list(args)
    for i in (4, 6):
        args[i].requires_grad_(True)
    if shards:
        data = [d.clone().requires_grad_(True) for d in ds.shard_leading(mesh, args[0])[0]]
    else:
        data = args[0].requires_grad_(True)
    image = diff.render_image_diff(data, *args[1:], mesh=mesh, **static)
    image.mean().backward()
    g_data = torch.cat([d.grad for d in data]) if shards else data.grad
    return image.detach().cpu(), [g.cpu().numpy() for g in
                                  (g_data, args[4].grad, args[6].grad)]


@pytest.mark.cuda
@pytest.mark.parametrize("num", [2, 8])
@pytest.mark.parametrize("shards", [False, True], ids=["whole", "shards"])
def test_sharded_diff_matches_cpu_mesh(cuda, num, shards):
    """``diff.render_image_diff(mesh=make_mesh(num, "cuda"))`` (every shard
    on ``cuda:0``): the frame equals the single call on the card and the
    same mesh on the CPU; the data gradient is the card's single call's at
    rtol 1e-6 / atol 1e-9; data and LUT gradients are within 1e-4 of max
    |g| of the CPU mesh's (the card's scatter-add order, as
    test_diff_matches_cpu), the LUT's of the single call's too; the eye
    gradient within 1e-4 of its terms' sum (``camera_terms``) of both."""
    from amrvolumerenderer_torch.parallel import directsend as ds

    mesh = ds.make_mesh(num, "cuda")
    assert all(d == cuda for d in mesh.devices)
    image, got = sharded_diff_run(cuda, mesh, shards)
    single_image, single = sharded_diff_run(cuda, None)
    cpu_image, cpu = sharded_diff_run("cpu", ds.make_mesh(num, "cpu"), shards)
    assert float(single_image[:, 3].max()) > 0.0
    assert torch.equal(image, single_image)
    assert torch.equal(image, cpu_image)
    np.testing.assert_allclose(got[0], single[0], rtol=1e-6, atol=1e-9)
    for g, ref in zip(got[:2], cpu[:2]):
        assert np.abs(g - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.abs(got[1] - single[1]).max() <= 1e-4 * np.abs(single[1]).max()
    args, static = sharded_diff_scene("cpu")
    w = np.full((64, 4), 1.0 / 256, np.float32)
    terms = camera_terms(tuple(a.numpy() for a in args), static, w, 6)
    for ref in (cpu[2], single[2]):
        assert np.all(np.abs(got[2] - ref) <= 1e-4 * terms), (got[2], ref, terms)


# ---- the pair path: diff.render_image_pairs on the card ----------------------

from test_torch_diff_pairs import BOXES, VIEWS, build, fold_rows, program_args  # noqa: E402


def pair_scene(name, dev):
    """(args on ``dev``, static): a ``diff_scene``, or the 64-brick
    turbulence field of tests/test_torch_diff_pairs.py seen from view
    ``turbulence<k>``."""
    from amrvolumerenderer_torch import diff

    if name.startswith("turbulence"):
        args, static = program_args(BOXES, VIEWS[int(name[-1])])
        return [a.to(dev) for a in args], static
    args, static = diff_scene(name)
    return list(diff.args_from_arrays(args, dev)), static


def built_with_inputs(args, static):
    """The pair list ``render_image_pairs`` builds and what it built it
    from: ``(pairs, (eye, directions, bmin, bmax, eps, order))``."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm

    seen, inner = [], dm.diffpairs_build
    dm.diffpairs_build = lambda *a: seen.append((inner(*a), a)) or seen[-1][0]
    try:
        with torch.no_grad():
            diff.render_image_pairs(*args, **static)
    finally:
        dm.diffpairs_build = inner
    (case,) = seen
    return case


def pairs_by_key(pairs, num_pixels):
    """A list's pairs sorted by (brick, pixel): keys, d0, tmax (on the
    CPU), and each pixel's bricks in fold order, -1 padded."""
    total = int(pairs.total)
    brick, pixel = pairs.brick[:total].long().cpu(), pairs.pixel[:total].long().cpu()
    key = brick * num_pixels + pixel
    at = torch.argsort(key)
    count, start = pairs.pixel_count.long().cpu(), pairs.pixel_start.long().cpu()
    most = int(count.max()) if count.numel() else 0
    folds = torch.full((num_pixels, max(most, 1)), -1, dtype=torch.long)
    for s in range(most):
        on = count > s
        folds[on, s] = brick[pairs.fold_index.long().cpu()[start[on] + s]]
    return key[at], pairs.d0[:total].cpu()[at], pairs.tmax[:total].cpu()[at], folds


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test_diff", "r2", "contention", "turbulence0",
                                  "turbulence2"])
def test_diffpairs_build_kernel_matches_plain(cuda, name):
    """``diffpairs_build_kernel`` against ``diffpairs_build_reference`` on
    the card and on the CPU, on the inputs ``render_image_pairs`` hands it:
    the same pairs, each pair's d0 and tmax bit for bit, each brick's and
    each pixel's count, each tile's runs, each pixel's bricks in fold
    order; and the kernel's own layout: every run one brick in one tile in
    pixel order, the pixels' slots tiling the list."""
    from amrvolumerenderer_torch.ops import diffmarch as dm

    args, static = pair_scene(name, cuda)
    got, inputs = built_with_inputs(args, static)
    num_pixels = inputs[1].shape[0]
    total = int(got.total)
    assert total > 0
    for ref in (dm.diffpairs_build_reference(*inputs),
                dm.diffpairs_build_reference(*(t.cpu() for t in inputs))):
        assert int(ref.total) == total
        for a, b in zip(pairs_by_key(got, num_pixels), pairs_by_key(ref, num_pixels)):
            assert same_bits(a, b) if a.dtype == torch.float32 else torch.equal(a, b)
        for field in ("pixel_count", "run_cnt", "brick_count"):
            assert torch.equal(getattr(got, field).cpu(), getattr(ref, field).cpu()), field
    tile = dm.tile_pixels(num_pixels)
    brick, pixel = got.brick[:total].long().cpu(), got.pixel[:total].long().cpu()
    covered = torch.zeros(total, dtype=torch.long)
    run_off, run_cnt = got.run_off.long().cpu(), got.run_cnt.long().cpu()
    for b, t in zip(*run_cnt.nonzero(as_tuple=True)):
        q = torch.arange(int(run_off[b, t]), int(run_off[b, t] + run_cnt[b, t]))
        covered[q] += 1
        assert bool((brick[q] == b).all()) and bool((pixel[q] // tile == t).all())
        assert bool((pixel[q][1:] > pixel[q][:-1]).all())
    assert bool((covered == 1).all())
    slots = torch.zeros(total, dtype=torch.long)
    count, start = got.pixel_count.long().cpu(), got.pixel_start.long().cpu()
    for p in count.nonzero()[:, 0].tolist():
        slots[start[p]:start[p] + count[p]] += 1
    assert bool((slots == 1).all())
    assert torch.equal(torch.sort(got.fold_index[:total].long().cpu())[0], torch.arange(total))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_diffpairs_fold_kernels_match_plain(cuda, seed):
    """``diffpairs_fold_forward_kernel`` (both instantiations) and
    ``diffpairs_fold_backward_kernel`` against their plain versions on the
    card, bit for bit, and against the dense fold of the clipped, masked
    layers on the card (``comp.fold_diff`` and the clip's autograd): the
    image and each pair's row gradient bit for bit."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm

    raw, hit, order, rows, index = fold_rows(seed=seed)
    raw, hit, order, rows = raw.to(cuda), hit.to(cuda), order.to(cuda), rows.to(cuda)
    fold_index, start, count = (t.to(cuda) for t in index)
    got = comp.diffpairs_fold_forward(rows, fold_index, start, count, keep=True)
    ref = comp.diffpairs_fold_forward_reference(rows, fold_index, start, count, keep=True)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    assert same_bits(comp.diffpairs_fold_forward(rows, fold_index, start, count)[0], got[0])
    w = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (raw.shape[1], 4))
                         .astype(np.float32)).to(cuda)
    g = comp.diffpairs_fold_backward(w, rows, fold_index, start, count, *got[1:])
    assert same_bits(g, comp.diffpairs_fold_backward_reference(w, rows, fold_index, start,
                                                               count, *ref[1:]))
    dense = raw.clone().requires_grad_(True)
    image = diff.composite_layers_diff(
        torch.where(hit[..., None], dm._clip(dense, 0.0, 1.0), 0.0), order)
    (image * w).sum().backward()
    assert same_bits(got[0], image.detach())
    ranks, pix = hit[order].nonzero(as_tuple=True)
    assert same_bits(g, dense.grad[order[ranks], pix])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test_diff", "log", "r2", "contention", "turbulence0"])
def test_pair_march_kernels_match_plain(cuda, name):
    """The march kernels over a pair list's rows against
    ``march_pairs_forward_reference`` / ``march_pairs_backward_reference``
    on the card: the forward bit for bit on every pair, the backward of
    every differentiable field at 1e-4 of its scale (atomics)."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm

    args, static = pair_scene(name, cuda)
    seen, inner = [], dm.march_pairs
    dm.march_pairs = lambda m, pairs, cfg: seen.append((m, pairs, cfg)) or inner(m, pairs, cfg)
    try:
        with torch.no_grad():
            diff.render_image_pairs(*args, **static)
    finally:
        dm.march_pairs = inner
    ((m, pairs, cfg),) = seen
    total = int(pairs.total)
    with torch.no_grad():
        out, ckpt = dm.diffmarch_forward_pairs(m, pairs, cfg, keep=True)
        want = dm.march_pairs_forward_reference(m, pairs, cfg)
        assert same_bits(out[:total], want[:total])
        grad = torch.from_numpy(np.random.default_rng(3).uniform(
            -1, 1, size=(pairs.brick.shape[0], 4)).astype(np.float32)).to(cuda)
        got = dm.diffmarch_backward_pairs(m, pairs, cfg, grad, ckpt)
        ref = dm.march_pairs_backward_reference(m, pairs, cfg, grad)
    got[2], ref[2] = got[2][:total], ref[2][:total]  # d0: the rows of a pair
    assert_rel_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test_diff", "saturating", "r2", "turbulence1"])
def test_pair_path_is_the_dense_path_on_the_card(cuda, name):
    """``render_image_diff`` on the card (the pair path) against the dense
    layers on the card (``render_layers_diff`` and the fold): the image bit
    for bit, the volume's and the LUT's gradients at 1e-4 of their scale
    (atomics add in another order)."""
    from amrvolumerenderer_torch import diff

    args, static = pair_scene(name, cuda)
    n = static["width"] * static["height"]
    w = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, size=(n, 4))
                         .astype(np.float32)).to(cuda)

    def run(dense):
        targs = list(args)
        for i in (0, 4):
            targs[i] = targs[i].clone().requires_grad_(True)
        if dense:
            colors, _ = diff.render_layers_diff(*targs, **static)
            order = diff.default_order(targs[1], targs[2], targs[6], targs[7])
            image = diff.composite_layers_diff(colors, order)
        else:
            image = diff.render_image_diff(*targs, **static)
        (image * w).sum().backward()
        return image.detach(), [targs[i].grad for i in (0, 4)]

    image, grads = run(False)
    want_image, want = run(True)
    assert float(want_image[:, 3].max()) > 0.0
    assert same_bits(image, want_image)
    assert_rel_close(grads, want)


@pytest.mark.cuda
def test_pair_path_launches_in_a_captured_step(cuda):
    """A fitting step over three views captured as one CUDA graph after two
    eager warm-up steps: one pair build, one march forward and backward and
    one pair fold forward and backward a view, no dense pair list and no
    dense fold; three replays give the eager steps' losses at 1e-5."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm

    views = []
    for cam in VIEWS[:3]:
        args, static = program_args(BOXES, cam)
        args = [a.to(cuda) for a in args]
        args[10] = float(cam.fov_y_degrees)
        with torch.no_grad():
            views.append((args, static, diff.render_image_diff(*args, **static)))

    def make():
        param = torch.full_like(views[0][0][0], 0.3).requires_grad_(True)
        opt = torch.optim.Adam([param], lr=0.05, capturable=True)

        def step():
            loss = sum(torch.mean((diff.render_image_diff(param, *a[1:], **s) - t) ** 2)
                       for a, s, t in views)
            loss.backward()
            opt.step()
            return loss.detach()

        return opt, step

    opt_e, step_e = make()
    eager = []
    for _ in range(5):
        opt_e.zero_grad(set_to_none=True)
        eager.append(float(step_e()))
    opt_g, step_g = make()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graphed = []
    with torch.cuda.stream(side):
        for _ in range(2):
            opt_g.zero_grad(set_to_none=True)
            graphed.append(float(step_g()))
    torch.cuda.current_stream().wait_stream(side)
    fns = (dm.diffpairs_build, dm.diffmarch_forward, dm.diffmarch_backward,
           comp.diffpairs_fold_forward, comp.diffpairs_fold_backward, dm.diffmarch_pairs,
           comp.fold_diff_forward, comp.fold_diff_backward)
    before = [f.launches for f in fns]
    graph = torch.cuda.CUDAGraph()
    opt_g.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph):
        loss = step_g()
    assert [f.launches - b for f, b in zip(fns, before)] == [3, 3, 3, 3, 3, 0, 0, 0]
    for _ in range(3):
        graph.replay()
        graphed.append(float(loss))
    np.testing.assert_allclose(graphed, eager, rtol=1e-5)
    assert eager[-1] < eager[0]


@pytest.mark.cuda
def test_pair_list_overflow_and_growth(cuda):
    """A list built smaller than the view's pairs writes none of an
    overflowing tile's pairs, marks its pixels -1 and still counts every
    pair; the pair fold makes those pixels NaN.  Outside a capture
    ``diffpairs_build`` reads the count and builds again larger (two
    launches), and keeps that capacity for its sizes."""
    from amrvolumerenderer_torch.ops import diffmarch as dm

    args, static = pair_scene("turbulence0", cuda)
    full, inputs = built_with_inputs(args, static)
    total = int(full.total)
    small = dm._build_launch(*inputs, total // 3)
    assert int(small.total) == total
    over = small.pixel_count < 0
    assert bool(over.any()) and int(small.pixel_count[~over].sum()) <= total // 3
    raw = torch.rand((small.brick.shape[0], 4), device=cuda)
    image = comp.diffpairs_fold_forward(raw, small.fold_index, small.pixel_start,
                                        small.pixel_count)[0]
    assert bool(torch.isnan(image[over]).all()) and not bool(torch.isnan(image[~over]).any())
    key = (str(cuda), inputs[2].shape[0], inputs[1].shape[0])
    dm._capacity[key] = 16
    launches = dm.diffpairs_build.launches
    grown = dm.diffpairs_build(*inputs)
    assert dm.diffpairs_build.launches == launches + 2
    assert int(grown.total) == total <= grown.brick.shape[0] == dm._capacity[key]
    assert bool((grown.pixel_count >= 0).all())


@pytest.mark.cuda
def test_216_brick_view_keeps_pair_sized_state(cuda):
    """A view of the turbulence field at 192^3 in 216 bricks of 32^3 at
    512^2 (the fitting cell's): forward and backward of the pair path peak
    under 1 GiB of device memory, a tenth of the dense layers' peak or
    less; no tensor saved for the backward has [B, H*W] elements; the
    image equals the dense path's bit for bit."""
    from amrvolumerenderer_torch import diff
    from portbench import scenes

    boxes = scenes.turbulence_scene({"domain": 192, "brick": 32}, 11, cuda).boxes
    assert len(boxes) == 216
    cam = scenes.fit_views({"views": 36, "radius": 2.5, "fov_y_degrees": 45.0}, 11)[0]
    host = [(b.data.cpu().numpy(), b.min_corner, b.max_corner) for b in boxes]
    camera = CameraParameters(eye=cam.eye, look_at=cam.look_at, up=cam.up,
                              fov_y_degrees=cam.fov_y_degrees)
    args, static = diff.prepare_scene(host, camera, width=512, height=512, device=cuda)
    args = list(args)
    args[10] = float(cam.fov_y_degrees)
    bricks, pixels = len(boxes), 512 * 512
    with torch.no_grad():
        diff.render_image_diff(*args, **static)  # the list's capacity for these sizes

    def peak(fn):
        data = args[0].clone().requires_grad_(True)
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            image = fn(data)
        image.sum().backward()
        torch.cuda.synchronize()
        return image.detach(), torch.cuda.max_memory_allocated() - start, saved

    def dense(data):
        colors, _ = diff.render_layers_diff(data, *args[1:], **static)
        order = diff.default_order(args[1], args[2], args[6], args[7])
        return diff.composite_layers_diff(colors, order)

    image, pair_peak, saved = peak(lambda d: diff.render_image_diff(d, *args[1:], **static))
    want, dense_peak, _ = peak(dense)
    print(f"216 bricks at 512^2: pair path peak {pair_peak / 2 ** 20:.1f} MiB, dense "
          f"{dense_peak / 2 ** 20:.1f} MiB; saved {sorted(set(saved))}")
    assert same_bits(image, want) and float(image[:, 3].max()) > 0.0
    assert pair_peak < 2 ** 30 and pair_peak * 10 <= dense_peak
    assert all(int(np.prod(s)) < bricks * pixels for s in saved), saved


BUILD_STOP = """
import os, sys
import torch
from amrvolumerenderer_torch.ops import diffmarch as dm

value = int(sys.argv[1])
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
bmin = torch.rand((8, 3), generator=g).to(dev)
inputs = [torch.tensor([0.5, 0.5, 3.0], device=dev),
          torch.nn.functional.normalize(torch.randn((64, 3), generator=g), dim=1).to(dev),
          bmin, bmin + 0.5, torch.full((8,), 1e-4, device=dev)]
order = torch.arange(8, device=dev)
dm._build_launch(*inputs, order, 512)
torch.cuda.synchronize()
print("a permutation builds", flush=True)
order[5] = 0 if value < 0 else value
try:
    dm._build_launch(*inputs, order, 512)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("stopped:", str(e).splitlines()[0], flush=True)
    os._exit(3)
print("ran to its end", flush=True)
os._exit(0)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("value", [-1, 8], ids=["repeat", "out_of_range"])
def test_diffpairs_build_stops_on_an_order_that_is_no_permutation(cuda, value):
    """An order that repeats a brick or names one out of range stops the
    pair build (each block checks it, as the fold kernels do): the launch
    traps and the next synchronisation raises, in a process of its own."""
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests]))
    env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    proc = subprocess.run([sys.executable, "-c", BUILD_STOP, str(value)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert "a permutation builds" in proc.stdout, proc.stderr
    assert proc.returncode == 3 and "stopped:" in proc.stdout, (proc.returncode, proc.stdout,
                                                                proc.stderr[-2000:])
