#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's three CUDA kernels (tile-march, slice-march, tile
composite) from the checkout's sources, all at once, holds each against
the golden rows and against its plain PyTorch version on the card, drives
both main paths through the entry points a user calls: a 512-brick 256^3
plotfile at 1024x1024 through ``amrvolumerenderer_torch.render`` and the
CLI (more than 96 pieces: the tile-march route), and bench.py's 3-level
scene at 1024x1024 through ``render_scene`` for three knob sets (at most 96
pieces: the slice-march + composite route), plus one 2048^2 AA=4 frame.
It times every kernel and its plain version and splits the host wall time
of the one-shot route.  Every phase asserts; any failure ends the run with
a non-zero exit code.  The second-to-last line of standard output is a
JSON object with each kernel's launches, error, times and bound; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.  Scratch files go to ``build/chip_smoke/`` in the checkout.  It
imports only the port (``amrvolumerenderer_torch``), never jax and never
the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
ATOL = 2e-6  # golden manifest tolerance; kernel vs plain is held to it too
ROUTE_ATOL = 2e-5  # slice-march vs tile-march route (tests/test_tilemarch.py:162)
ALPHA_FRACTION = (0.05, 0.95)  # plausible covered share of the full frame
KNOBS = (("nearest", "post", 256), ("trilinear", "post", 256),
         ("trilinear", "pre", 128))
# H100 SXM published peaks: HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float32 operations per valid sample of march.cuh's loop body, counted by
# hand (an FMA counts 2): window weight, position, cell index, LUT
# classification, XLA's exp and the fold; trilinear adds the bilinear
# stencil, pre-classification four classifications and their weighting
SAMPLE_FLOPS = {("nearest", "post"): 63, ("trilinear", "post"): 88,
                ("trilinear", "pre"): 118}
BLEND_FLOPS = 12  # composite: one depth-sorted blend per covered pixel layer


def log(msg: str) -> None:
    print(msg, flush=True)


def r2_scene_data(n_cells: int = 16, box_size: int = 8):
    """The golden manifest's scene (scripts/generate_golden_manifest.py:
    38-60, tests/conftest.make_r2_scene_data): x^2 + y^2 + z^2 on an n^3
    grid in box_size^3 boxes."""
    from amrvolumerenderer_torch.api import LevelBox, LevelGeometry

    c = np.arange(n_cells) / (n_cells - 1)
    field = (c[:, None, None] ** 2 + c[None, :, None] ** 2
             + c[None, None, :] ** 2).astype(np.float64)
    boxes = [
        LevelBox(field[i:i + box_size, j:j + box_size, k:k + box_size],
                 np.array([i, j, k]))
        for i in range(0, n_cells, box_size)
        for j in range(0, n_cells, box_size)
        for k in range(0, n_cells, box_size)
    ]
    return [boxes], [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n_cells))]


def radial_field(n: int, lo: float, hi: float) -> np.ndarray:
    """bench.py's two-shell density over [lo, hi]^3 cell centres."""
    c = lo + (np.arange(n) + 0.5) / n * (hi - lo)
    r = np.sqrt((c[:, None, None] - 0.5) ** 2 + (c[None, :, None] - 0.5) ** 2
                + (c[None, None, :] - 0.5) ** 2)
    f = np.exp(-((r - 0.18) / 0.06) ** 2) + 0.7 * np.exp(-((r - 0.38) / 0.05) ** 2)
    return f.astype(np.float64)


def three_level_geometry():
    """bench.py:70-93: 64^3 base, 2x refinement over the central half and
    another over the central quarter, through the port's ingestion."""
    from amrvolumerenderer_torch import api
    from amrvolumerenderer_torch.api import LevelBox, LevelGeometry

    n = 64
    data = api.AmrData(
        level_data=[
            [LevelBox(radial_field(n, 0.0, 1.0), np.zeros(3, dtype=int))],
            [LevelBox(radial_field(n, 0.25, 0.75), np.full(3, 32, dtype=int))],
            [LevelBox(radial_field(n, 0.375, 0.625), np.full(3, 96, dtype=int))],
        ],
        level_geometry=[
            LevelGeometry(np.zeros(3), np.full(3, 1.0 / (s * n))) for s in (1, 2, 4)
        ],
        refinement_ratios=[(2, 2, 2), (2, 2, 2)],
    )
    return api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)


def orbit_cameras(center, eye, count):
    """bench.py:575-587: ``count`` eyes within one march-axis octant."""
    from amrvolumerenderer_torch.api import CameraParameters

    base = np.asarray(eye) - center
    cams = []
    for k in range(count):
        ang = 2 * np.pi * k / (4 * count)
        c, s = np.cos(ang), np.sin(ang)
        cams.append(CameraParameters(
            eye=center + np.array([c * base[0] + s * base[2], base[1],
                                   -s * base[0] + c * base[2]]),
            look_at=center, up=(0.0, 1.0, 0.0),
        ))
    return cams


def read_png_rgb(path: str) -> np.ndarray:
    """[H, W, 3] bytes of a PNG written by the port (filter type 0)."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n", path
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(blob):
        (length,) = np.frombuffer(blob[pos:pos + 4], ">u4")
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + int(length)]
        if tag == b"IHDR":
            w, h = (int(v) for v in np.frombuffer(payload[:8], ">u4"))
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + int(length)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    assert (rows[:, 0] == 0).all(), "unexpected PNG filter"
    return rows[:, 1:].reshape(h, w, 3)


def max_diff(got: np.ndarray, ref: np.ndarray):
    """(same non-finite pattern, max |diff| over finite entries)."""
    fin = np.isfinite(ref)
    same = bool(np.array_equal(np.isfinite(got), fin))
    return same, float(np.abs(got[fin] - ref[fin]).max()) if fin.any() else 0.0


def valid_samples(torch, meta, dims, cam, bricks, tiles, bounds, tiles_x,
                  logical_w, logical_h, max_slices):
    """Valid samples of a march over (piece, tile, band) items: pixels x
    slices inside the band whose half-cell window overlaps the ray's
    interval in the piece (march.cuh's ``valid``), counted in float64 on
    the card.  The work the kernel must do on this run's data."""
    f64 = torch.float64
    dev = meta.device
    m = meta.double()[bricks.long()]
    dm = dims.long()[bricks.long()]
    c = cam.double()
    p = torch.arange(1024, device=dev)
    t = tiles.long()[:, None]
    px = ((t % tiles_x) * 32 + p % 32).to(f64) + 0.5
    py = ((t // tiles_x) * 32 + p // 32).to(f64) + 0.5
    plane_x = (px * (2.0 / logical_w) - 1.0) * c[12] * c[13]
    plane_y = (py * (2.0 / logical_h) - 1.0) * c[12]
    d = torch.stack([c[3 + i] + plane_x * c[6 + i] + plane_y * c[9 + i]
                     for i in range(3)])
    d = d / torch.linalg.vector_norm(d, dim=0)
    idx = torch.arange(len(bricks), device=dev)
    dp = [d[dm[:, 3 + i], idx] for i in range(3)]  # [W, 1024] permuted
    ep = [c[dm[:, 3 + i]][:, None] for i in range(3)]
    tmin = torch.full_like(dp[0], -float("inf"))
    tmax = torch.full_like(dp[0], float("inf"))
    for a in range(3):
        inv = 1.0 / torch.where(dp[a].abs() < 1e-8, 1.0, dp[a])
        t1 = (m[:, a, None] - ep[a]) * inv
        t2 = (m[:, 3 + a, None] - ep[a]) * inv
        inside = (ep[a] >= m[:, a, None]) & (ep[a] <= m[:, 3 + a, None])
        par = dp[a].abs() < 1e-8
        lo = torch.where(par, torch.where(inside, -float("inf"), float("inf")),
                         torch.minimum(t1, t2))
        hi = torch.where(par, torch.where(inside, float("inf"), -float("inf")),
                         torch.maximum(t1, t2))
        tmin, tmax = torch.maximum(tmin, lo), torch.minimum(tmax, hi)
    live = (tmax >= tmin) & (tmax > 0) & (dp[0].abs() > 1e-8)
    b = bounds.long()
    s_lo = torch.where(b > 0, b >> 16, 0)
    s_hi = torch.where(b > 0, b & 0xFFFF, dm[:, 0])
    hi = torch.minimum(torch.minimum(s_hi, dm[:, 0]), torch.full_like(s_hi, max_slices))
    total = 0
    cell = m[:, 6, None]
    dt = cell / dp[0].abs()
    for k in range(int(hi.max()) if len(hi) else 0):
        band = ((k >= s_lo) & (k < hi))[:, None] & live
        if not band.any():
            continue
        k_eff = torch.where(dp[0] < 0, (s_lo + s_hi - 1 - k)[:, None], k)
        z = m[:, 0, None] + (k_eff.to(f64) + 0.5) * cell
        t_k = (z - ep[0]) / dp[0]
        w = (torch.minimum(t_k + 0.5 * dt, tmax)
             - torch.maximum(t_k - 0.5 * dt, tmin.clamp(min=0.0)))
        total += int((band & (w > 0)).sum())
    return total


def bound(byte_count: float, flop_count: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    float32 operations over the float32 peak."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = flop_count / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "amrvolumerenderer_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    # ---- phase 0: the card ------------------------------------------------
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this test needs a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.makedirs(SCRATCH, exist_ok=True)

    import amrvolumerenderer_torch
    from amrvolumerenderer_torch import api
    from amrvolumerenderer_torch.api import LevelBox, LevelGeometry, RenderParameters
    from amrvolumerenderer_torch.compositor import sort_layers
    from amrvolumerenderer_torch.driver import load_plotfile_geometry, write_plotfile
    from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
    from amrvolumerenderer_torch.ops import _build
    from amrvolumerenderer_torch.ops import composite as comp
    from amrvolumerenderer_torch.ops import slicemarch as sm
    from amrvolumerenderer_torch.ops import tilemarch as tm
    from amrvolumerenderer_torch.renderer import (
        auto_orbit_camera,
        compute_global_bounds,
        compute_global_scalar_range,
        compute_reference_sample_distance,
        render_scene,
    )
    from amrvolumerenderer_torch import renderer_fast as rf

    assert "jax" not in sys.modules, "the port imported jax"
    assert "amrvolumerenderer_tpu" not in sys.modules, \
        "the port imported the JAX package"
    counters = {"tilemarch": tm.tilemarch_render,
                "slicemarch": sm.slicemarch_render_worklist_raw,
                "composite": comp.composite_tiles}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    # ---- phase 1: build the three kernels, one nvcc each, in parallel -----
    t0 = time.perf_counter()
    _build.build_all(tuple(counters))
    for name in counters:
        _build.load(name)
    log(f"phase 1: built {', '.join(counters)} in {time.perf_counter() - t0:.3f} s "
        f"(nvcc " + ", ".join(f"{n} {_build.build_seconds[n]:.3f} s"
                              for n in counters) + ")")
    for name in counters:
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: " + line.strip())

    # ---- phase 2: the routes vs the golden rows ---------------------------
    golden = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                       "manifest_pixels.npz")))
    levels, geoms = r2_scene_data(16, 8)
    r2 = api.AmrData(level_data=levels, level_geometry=geoms)
    for method, row, want in (
        ("tilemarch", "tilemarch-1dev", {"tilemarch": 1, "slicemarch": 0, "composite": 0}),
        ("slicemarch", "slicemarch-1dev", {"tilemarch": 0, "slicemarch": 1, "composite": 1}),
    ):
        reset_counts()
        image, _ = api.render(r2, api.RenderOptions(
            width=48, height=48, render_method=method, device="cuda",
            output_filename=os.path.join(SCRATCH, f"golden-{method}.ppm"),
        ), verbose=False)
        same, diff = max_diff(image.pixels, golden[row])
        log(f"phase 2: {method} vs {row}: non-finite pattern same {same}, "
            f"max |diff| {diff:.3g} (atol {ATOL:g}); launches {counts()}")
        assert counts() == want, (method, counts())
        assert same and diff <= ATOL, row

    def event_ms(fn) -> float:
        """Device time of ``fn``'s launches, by CUDA events."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    worst = dict.fromkeys(counters, 0.0)

    def hold(name, label, pairs) -> None:
        """Assert kernel == plain (same non-finite pattern, atol) for each
        (kernel output, plain output) pair and record the worst diff."""
        result = []
        for k, p in pairs:
            same, d = max_diff(k.cpu().numpy(), p.cpu().numpy())
            worst[name] = max(worst[name], d)
            result.append((same, d))
        log(f"{label}: max |diff| " + ", ".join(f"{d:.3g}" for _, d in result)
            + f", non-finite pattern same {all(s for s, _ in result)}")
        assert all(s and d <= ATOL for s, d in result), label

    def kernel_vs_plain(phase: str, fsr, sentinel: bool = False) -> None:
        """Tile-march kernel and plain version on one frame's inputs
        (auto-orbit camera); with ``sentinel``, also on the grid with 3
        sentinel steps appended."""
        p = fsr.parameters
        inputs = fsr.frame_inputs(auto_orbit_camera(fsr.bounds))
        args = (fsr._packed_vol, inputs["meta"], inputs["dims"], fsr.lut,
                inputs["cam"], inputs["offsets"], inputs["bricks"],
                inputs["owners"], inputs["item_bounds"], inputs["tile_ids"])
        kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
                  logical_width=fsr.render_width,
                  logical_height=fsr.render_height, sampling=p.sampling,
                  ghost=fsr.ghost, classification=p.classification)
        num_tiles = (fsr.pad_w // 32) * (fsr.pad_h // 32)
        cases = [("", args)]
        if sentinel:
            pad_ids = torch.cat([inputs["tile_ids"], torch.full(
                (3,), num_tiles, dtype=torch.int32, device=dev)])
            pad_off = torch.cat([inputs["offsets"], inputs["offsets"][-1:].repeat(3)])
            cases.append((" +3 sentinel steps", args[:5] + (pad_off,) + args[6:9]
                          + (pad_ids,)))
        for label, a in cases:
            kc, kd = tm.tilemarch_render(*a, **kw)
            pc, pd = tm.tilemarch_reference(*a, **kw)
            torch.cuda.synchronize()
            ms = min(event_ms(lambda: tm.tilemarch_render(*a, **kw))
                     for _ in range(3))
            hold("tilemarch", f"{phase}: tile-march {p.sampling}/"
                 f"{p.classification}/{p.lut_size}{label}: {a[9].shape[0]} "
                 f"steps, {a[6].shape[0]} items, kernel {ms:.4f} ms",
                 [(kc, pc), (kd, pd)])
            if label:
                keep = a[9] < num_tiles
                assert (kc[~keep] == 0).all() and torch.isinf(kd[~keep]).all()

    # ---- phase 3: tile-march kernel vs plain, 3-level scene at 1024^2 -----
    geometry3 = three_level_geometry()
    for sampling, classification, lut_size in KNOBS:
        kernel_vs_plain("phase 3", FastSceneRenderer(geometry3, RenderParameters(
            width=1024, height=1024, sampling=sampling,
            classification=classification, lut_size=lut_size,
        ), device=dev), sentinel=sampling == "nearest")

    # ---- phase 4: the tile-march main path at full size -------------------
    n, bs = 256, 32
    field = radial_field(n, 0.0, 1.0).astype(np.float32)
    boxes = [LevelBox(field[i:i + bs, j:j + bs, k:k + bs], np.array([i, j, k]))
             for i in range(0, n, bs) for j in range(0, n, bs)
             for k in range(0, n, bs)]
    plotfile = os.path.join(SCRATCH, "plt_radial_512")
    write_plotfile(plotfile, [boxes], [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))])
    png_api = os.path.join(SCRATCH, "radial_render.png")
    png_cli = os.path.join(SCRATCH, "radial_cli.png")
    reset_counts()  # counted run: the tile-march main path, once
    t0 = time.perf_counter()
    rc = amrvolumerenderer_torch.render(plotfile, width=1024, height=1024,
                                        output=png_api)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"tilemarch": counts()["tilemarch"]}
    log(f"phase 4: render(plotfile) 512 bricks at 1024x1024: rc {rc}, "
        f"{main_s:.3f} s wall (scene build included), launches {counts()}")
    assert rc == 0 and counts() == {"tilemarch": 1, "slicemarch": 0, "composite": 0}
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "amrvolumerenderer_torch.driver", "--width",
         "1024", "--height", "1024", "--output", png_cli, plotfile],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    log(f"phase 4: CLI rc {cli.returncode} in {time.perf_counter() - t0:.3f} s")
    assert cli.returncode == 0, cli.stderr[-4000:]
    geometry = load_plotfile_geometry(plotfile, "", 0, -1, False, verbose=False)
    image, _ = render_scene("", RenderParameters(width=1024, height=1024),
                            geometry, verbose=False, device=dev)
    px = image.pixels
    covered = float((px[:, 3] > 0).mean())
    log(f"phase 4: float frame {px.shape}, finite colours "
        f"{bool(np.isfinite(px[:, :4]).all())}, alpha > 0 on {covered:.4f}")
    assert px.shape == (1024 * 1024, 5) and np.isfinite(px[:, :4]).all()
    assert ALPHA_FRACTION[0] <= covered <= ALPHA_FRACTION[1], covered
    expect = np.clip((px[:, :3] * np.float32(256.0)).astype(np.int32), 0, 255)
    expect = expect.astype(np.uint8).reshape(1024, 1024, 3)[::-1]
    for png in (png_api, png_cli):
        rgb = read_png_rgb(png)
        assert np.array_equal(rgb, expect), f"{png} differs from the frame"
    log("phase 4: both PNGs equal the byte-coded float frame")
    # the kernel against its plain version at the main path's own shapes
    kernel_vs_plain("phase 4", FastSceneRenderer(
        geometry, RenderParameters(width=1024, height=1024), device=dev))

    # ---- phase 5: the slice-march main path at full size ------------------
    bounds3 = compute_global_bounds(geometry3)
    srange3 = compute_global_scalar_range(geometry3)
    rsd3 = compute_reference_sample_distance(geometry3, bounds3)

    def slicemarch_frame(params, camera, width, height):
        """Prepared inputs of one slice-march frame on the card: (prep, the
        march's positional args, its keywords, the composite's order and
        owners)."""
        prep = rf.prepare_slicemarch_scene(geometry3, params, camera, srange3,
                                           rsd3, width, height, None)
        inp = rf.slicemarch_device_inputs(prep, dev)
        args = tuple(inp[k] for k in ("vol", "meta", "dims", "luts", "cam",
                                      "wb", "wt", "wbounds"))
        kw = dict(width=prep["pad_w"], height=prep["pad_h"],
                  max_slices=prep["s_max"], logical_width=width,
                  logical_height=height, sampling=params.sampling,
                  ghost=prep["ghost"], classification=params.classification)
        order = sort_layers(prep["depth_hints"], prep["owners"],
                            prep["local_indices"])
        order_t = torch.from_numpy(order).to(dev)
        owners_t = torch.from_numpy(np.ascontiguousarray(prep["owners"][order])).to(dev)
        return prep, inp, args, kw, order_t, owners_t

    slice_launches = {"slicemarch": 0, "composite": 0}
    for sampling, classification, lut_size in KNOBS:
        params = RenderParameters(width=1024, height=1024, sampling=sampling,
                                  classification=classification, lut_size=lut_size)
        tag = f"{sampling}/{classification}/{lut_size}"
        reset_counts()  # counted run: the slice-march main path
        t0 = time.perf_counter()
        image, _ = render_scene(os.path.join(SCRATCH, f"3level-{sampling}-"
                                             f"{classification}.png"),
                                params, geometry3, verbose=False, device=dev)
        wall = time.perf_counter() - t0
        got = counts()
        log(f"phase 5: render_scene 3-level 1024x1024 {tag}: {wall:.3f} s "
            f"wall, launches {got}")
        assert got["slicemarch"] >= 1 and got["composite"] >= 1, got
        assert got["tilemarch"] == 0, got
        for name in slice_launches:
            slice_launches[name] += got[name]
        px = image.pixels
        covered = float((px[:, 3] > 0).mean())
        assert px.shape == (1024 * 1024, 5) and np.isfinite(px[:, :4]).all()
        assert ALPHA_FRACTION[0] <= covered <= ALPHA_FRACTION[1], covered
        # the kernels against their plain versions at the path's own shapes
        camera = auto_orbit_camera(bounds3, params.camera_seed, params.camera_up)
        prep, inp, args, kw, order_t, owners_t = slicemarch_frame(
            params, camera, 1024, 1024)
        pieces = prep["vol"].shape[0]
        cov = inp["coverage"]
        log(f"phase 5: {tag}: {pieces} pieces (<= "
            f"{rf.TILEMARCH_PIECE_THRESHOLD}), {len(prep['wb'])} work items, "
            f"{int(cov.sum())} covered (piece, tile) blocks, alpha > 0 on "
            f"{covered:.4f}")
        assert pieces <= rf.TILEMARCH_PIECE_THRESHOLD
        kc, kd = sm.slicemarch_render_worklist_raw(*args, **kw)
        pc, pd = sm.slicemarch_reference(*args, **kw)
        torch.cuda.synchronize()
        hold("slicemarch", f"phase 5: slice-march kernel vs plain {tag} "
             "(covered blocks)", [(kc[cov], pc[cov]), (kd[cov], pd[cov])])
        cc, cd = comp.composite_tiles(kc, kd, order_t, owners_t, cov)
        qc, qd = comp.composite_reference(kc, kd, order_t, owners_t, cov)
        torch.cuda.synchronize()
        hold("composite", f"phase 5: composite kernel vs plain {tag}",
             [(cc, qc), (cd, qd)])
        # the two routes render the same frame within the JAX tests' bound
        tile_image, _ = render_scene("", params, geometry3, verbose=False,
                                     method="tilemarch", device=dev)
        same, d = max_diff(image.pixels, tile_image.pixels)
        log(f"phase 5: {tag}: slice-march vs tile-march route: max |diff| "
            f"{d:.3g} (atol {ROUTE_ATOL:g}), non-finite pattern same {same}")
        assert same and d <= ROUTE_ATOL
    launches.update(slice_launches)

    # one 2048^2 AA=4 frame (a 4096^2 render buffer) on the same route
    params = RenderParameters(width=2048, height=2048, antialiasing=4)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    image, _ = render_scene("", params, geometry3, verbose=False, device=dev)
    wall = time.perf_counter() - t0
    px = image.pixels
    covered = float((px[:, 3] > 0).mean())
    log(f"phase 5: 2048x2048 AA=4: {wall:.3f} s wall, launches {counts()}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
        f"alpha > 0 on {covered:.4f}")
    assert counts()["slicemarch"] == 1 and counts()["composite"] == 1
    assert px.shape == (2048 * 2048, 5) and np.isfinite(px[:, :4]).all()
    assert ALPHA_FRACTION[0] <= covered <= ALPHA_FRACTION[1], covered

    # ---- phase 6: composite kernel vs plain at 128 layers (the TPU's
    # streamed regime), 1024^2, seeded layers with NaN in holes ------------
    rng = np.random.default_rng(6)
    layers, tiles = 128, 1024
    alpha = torch.from_numpy(rng.uniform(0, 1, (layers, tiles, 1, 8, 128))
                             .astype(np.float32)).to(dev)
    colors = torch.cat([torch.rand((layers, tiles, 3, 8, 128), device=dev,
                                   generator=torch.Generator(dev).manual_seed(6))
                        * alpha, alpha], dim=2)
    depths = torch.from_numpy(rng.choice(np.array([0.5, 1.0, 2.0, np.inf],
                                                  np.float32),
                                         (layers, tiles, 8, 128))).to(dev)
    cover = torch.from_numpy(rng.uniform(0, 1, (layers, tiles)) < 0.7).to(dev)
    colors[~cover] = float("nan")
    depths[~cover] = float("nan")
    owners = np.sort(rng.integers(0, 48, layers))
    order = sort_layers(rng.choice(np.array([0.1, 0.2], np.float32), layers),
                        owners, np.arange(layers))
    order_t = torch.from_numpy(order).to(dev)
    owners_t = torch.from_numpy(owners[order].astype(np.int32)).to(dev)
    cc, cd = comp.composite_tiles(colors, depths, order_t, owners_t, cover)
    qc, qd = comp.composite_reference(colors, depths, order_t, owners_t, cover)
    torch.cuda.synchronize()
    ms = min(event_ms(lambda: comp.composite_tiles(colors, depths, order_t,
                                                   owners_t, cover))
             for _ in range(3))
    plain_ms = event_ms(lambda: comp.composite_reference(colors, depths, order_t,
                                                         owners_t, cover))
    blocks = int(cover.sum())
    b_ms, by = bound((blocks + tiles) * 1024 * 20, blocks * 1024 * BLEND_FLOPS)
    assert bool(torch.isfinite(cc).all()), "an uncovered block leaked"
    hold("composite", f"phase 6: composite kernel vs plain, {layers} layers x "
         f"{tiles} tiles, {blocks} covered blocks: kernel {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by})", [(cc, qc), (cd, qd)])
    del colors, depths, alpha, cc, cd, qc, qd

    # ---- phase 7: timing, 8 orbit cameras on the 3-level scene at 1024^2 --
    fsr = FastSceneRenderer(geometry3, RenderParameters(width=1024, height=1024),
                            device=dev)
    center = 0.5 * (fsr.bounds.min_corner + fsr.bounds.max_corner)
    cams = orbit_cameras(center, auto_orbit_camera(fsr.bounds).eye, 8)
    tile_frames = [fsr.frame_inputs(c) for c in cams]
    tkw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
               logical_width=fsr.render_width, logical_height=fsr.render_height)
    tile_args = [(fsr._packed_vol, f["meta"], f["dims"], fsr.lut, f["cam"],
                  f["offsets"], f["bricks"], f["owners"], f["item_bounds"],
                  f["tile_ids"]) for f in tile_frames]
    params = RenderParameters(width=1024, height=1024)
    slice_frames = [slicemarch_frame(params, c, 1024, 1024) for c in cams]
    layer_bufs = [sm.slicemarch_render_worklist_raw(*f[2], **f[3])
                  for f in slice_frames]

    calls = {
        "tilemarch": (lambda fn: [lambda a=a: fn(*a, **tkw) for a in tile_args],
                      tm.tilemarch_render, tm.tilemarch_reference),
        "slicemarch": (lambda fn: [lambda f=f: fn(*f[2], **f[3])
                                   for f in slice_frames],
                       sm.slicemarch_render_worklist_raw, sm.slicemarch_reference),
        "composite": (lambda fn: [lambda f=f, b=b: fn(b[0], b[1], f[4], f[5],
                                                      f[1]["coverage"])
                                  for f, b in zip(slice_frames, layer_bufs)],
                      comp.composite_tiles, comp.composite_reference),
    }

    def per_frame_ms(thunks) -> float:
        return sum(event_ms(t) for t in thunks) / len(thunks)

    times = {}
    for name, (make, kernel, plain) in calls.items():
        per_frame_ms(make(kernel))  # warm-up
        kernel_ms = [per_frame_ms(make(kernel)), per_frame_ms(make(kernel))]
        plain_ms = per_frame_ms(make(plain))
        kernel_ms.append(per_frame_ms(make(kernel)))
        times[name] = (min(kernel_ms), plain_ms, kernel_ms)
        log(f"phase 7: {smi}: {name} kernel {min(kernel_ms):.4f} ms/frame (runs "
            f"{', '.join(f'{v:.4f}' for v in kernel_ms)}), plain PyTorch "
            f"{plain_ms:.4f} ms/frame (1024x1024, 8 orbit cameras, 3-level "
            f"scene, nearest/post/256, CUDA events)")

    # bounds from this run's inputs, per frame (mean over the 8 cameras)
    bounds_ms = {}
    flops = SAMPLE_FLOPS[("nearest", "post")]
    tile_samples, tile_bytes = 0, 0
    for a in tile_args:
        steps = a[9].shape[0]
        wt = torch.repeat_interleave(a[9].long(), torch.diff(a[5].long()))
        tile_samples += valid_samples(torch, a[1], a[2], a[4], a[6], wt, a[8],
                                      fsr.pad_w // 32, 1024, 1024, fsr.cube)
        tile_bytes += (band_bytes(torch, a[6], a[8], a[2], fsr.cube)
                       + a[3].numel() * 4 + steps * 1024 * 20)
    bounds_ms["tilemarch"] = bound(tile_bytes / 8, tile_samples * flops / 8)
    sm_samples, sm_bytes, comp_bytes, comp_flops = 0, 0, 0, 0
    for f in slice_frames:
        prep, inp, args, kw = f[:4]
        # one item per scheduled (piece, tile) block: the list's padding
        # repeats its last item
        num_tiles = inp["coverage"].shape[1]
        sel = torch.from_numpy(np.unique(
            prep["wb"].astype(np.int64) * num_tiles + prep["wt"],
            return_index=True)[1]).to(dev)
        sm_samples += valid_samples(
            torch, inp["meta"], inp["dims"], inp["cam"], inp["wb"][sel],
            inp["wt"][sel], inp["wbounds"][sel], kw["width"] // 32, 1024, 1024,
            kw["max_slices"])
        sm_bytes += (band_bytes(torch, inp["wb"][sel], inp["wbounds"][sel],
                                inp["dims"], kw["max_slices"])
                     + inp["luts"][0].numel() * 4 + len(sel) * 1024 * 20)
        blocks = int(inp["coverage"].sum())
        comp_bytes += (blocks + num_tiles) * 1024 * 20
        comp_flops += blocks * 1024 * BLEND_FLOPS
    bounds_ms["slicemarch"] = bound(sm_bytes / 8, sm_samples * flops / 8)
    bounds_ms["composite"] = bound(comp_bytes / 8, comp_flops / 8)
    for name, (b_ms, by) in bounds_ms.items():
        log(f"phase 7: {name} bound {b_ms:.5f} ms/frame ({by}); kernel at "
            f"{b_ms / times[name][0]:.4f} of its bound")
    log(f"phase 7: valid samples per frame: tile-march {tile_samples / 8:.0f}, "
        f"slice-march {sm_samples / 8:.0f}")

    # host wall split of render_composited_slicemarch, per frame
    def wall_split(camera):
        sync = torch.cuda.synchronize
        t = [time.perf_counter()]
        prep, inp, args, kw, order_t, owners_t = slicemarch_frame(
            params, camera, 1024, 1024)
        sync(); t.append(time.perf_counter())
        colors, depths = sm.slicemarch_render_worklist_raw(*args, **kw)
        sync(); t.append(time.perf_counter())
        out_c, out_d = comp.composite_tiles(colors, depths, order_t, owners_t,
                                            inp["coverage"])
        sync(); t.append(time.perf_counter())
        c, d = sm.untile(out_c[None], out_d[None], kw["width"], kw["height"])
        frame = torch.cat([c[0], d[0, :, None]], dim=-1)
        frame = frame.reshape(kw["height"], kw["width"], 5)[:1024, :1024]
        sync(); t.append(time.perf_counter())
        frame.reshape(-1, 5).cpu().numpy()
        t.append(time.perf_counter())
        return np.diff(t) * 1e3

    wall_split(cams[0])
    split = np.mean([wall_split(c) for c in cams], axis=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in cams:
        rf.render_composited_slicemarch(geometry3, params, c, srange3, rsd3,
                                        1024, 1024, None, device=dev)
    total = (time.perf_counter() - t0) * 1e3 / len(cams)
    log("phase 7: render_composited_slicemarch host wall per frame: prep "
        f"{split[0]:.3f} ms, march {split[1]:.3f} ms, composite {split[2]:.3f} "
        f"ms, assembly/untile {split[3]:.3f} ms, readback {split[4]:.3f} ms; "
        f"whole call {total:.3f} ms")

    # tile-march route wall split (kept from the earlier record)
    def wall_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in cams:
            fn(c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(cams)

    fsr.render(cams[0], overlay=False)
    prep_ms = wall_ms(fsr.frame_inputs)
    frame_ms = wall_ms(fsr.render_frame)
    e2e_ms = wall_ms(lambda c: fsr.render(c, overlay=False))
    log(f"phase 7: tile-march route host wall per frame: frame_inputs "
        f"{prep_ms:.3f} ms, render_frame (prep + kernel + assembly) "
        f"{frame_ms:.3f} ms, render (+ readback) {e2e_ms:.3f} ms")

    sources = {
        "tilemarch": ("ops/csrc/tilemarch.cu", "amrvolumerenderer_tpu/ops/tilemarch.py:819"),
        "slicemarch": ("ops/csrc/slicemarch.cu", "amrvolumerenderer_tpu/ops/slicemarch.py:750"),
        "composite": ("ops/csrc/composite.cu", "amrvolumerenderer_tpu/ops/composite.py:114"),
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "amrvolumerenderer_torch/" + sources[name][0],
        "replaces": sources[name][1],
        "launches": launches[name],
        "max_abs_err": worst[name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": bounds_ms[name][0],
        "bound_by": bounds_ms[name][1],
        "library_ms": None,
    } for name in counters]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def band_bytes(torch, bricks, bounds, dims, max_slices) -> int:
    """Bytes of the distinct (piece, slice) pairs the items' slice bands
    touch, 4 KiB each: the volume a march must read at least once."""
    b = bounds.long()
    d = dims.long()[bricks.long()]
    lo = torch.where(b > 0, b >> 16, 0)
    hi = torch.minimum(torch.where(b > 0, b & 0xFFFF, d[:, 0]),
                       torch.full_like(lo, max_slices))
    touched = torch.zeros((int(dims.shape[0]), max_slices), dtype=torch.bool,
                          device=dims.device)
    k = torch.arange(max_slices, device=dims.device)
    for chunk in torch.split(torch.arange(len(lo), device=dims.device), 4096):
        mask = (k[None] >= lo[chunk, None]) & (k[None] < hi[chunk, None])
        touched.index_put_((bricks.long()[chunk, None].expand_as(mask)[mask],
                            k[None].expand_as(mask)[mask]),
                           torch.ones((), dtype=torch.bool, device=dims.device))
    return int(touched.sum()) * 4096


if __name__ == "__main__":
    sys.exit(main())
