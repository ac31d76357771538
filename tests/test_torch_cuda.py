"""The port's CUDA kernels on the card: tile-march (one frame and batched,
float32 and bfloat16 volumes), slice-march (work list and dense), the
composite (tile and pixel modes), and the multi-device route over 8
shards of one card against the same route on the CPU (marked ``cuda``;
every test skips itself when ``torch.cuda.is_available()`` is false).

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
from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry
from amrvolumerenderer_torch.types import CameraParameters, RenderParameters

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
