#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the checkout's sources, holds it
against the golden rows and against its plain PyTorch version on the card,
drives the port's main path (``amrvolumerenderer_torch.render`` and the
CLI) on a 512-brick 256^3 plotfile at 1024x1024, and times the kernel and
the plain version.  Every phase asserts; any failure ends the run with a
non-zero exit code.  The second-to-last line of standard output is a JSON
object with each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
Scratch files go to ``build/chip_smoke/`` in the checkout.  It imports
only the port (``amrvolumerenderer_torch``), never jax.
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
ALPHA_FRACTION = (0.05, 0.95)  # plausible covered share of the full frame


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

    base =np.asarray(eye) - center
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
    try:
        import triton

        log(f"triton {triton.__version__} imports")
    except ImportError as error:
        log(f"triton does not import: {error}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.makedirs(SCRATCH, exist_ok=True)

    import amrvolumerenderer_torch
    from amrvolumerenderer_torch import api
    from amrvolumerenderer_torch.api import LevelBox, LevelGeometry, RenderParameters
    from amrvolumerenderer_torch.driver import load_plotfile_geometry, write_plotfile
    from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
    from amrvolumerenderer_torch.ops import _build
    from amrvolumerenderer_torch.ops import tilemarch as tm
    from amrvolumerenderer_torch.renderer import auto_orbit_camera, render_scene

    assert "jax" not in sys.modules, "the port imported jax"

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.load("tilemarch")
    log(f"phase 1: built tilemarch in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds['tilemarch']:.3f} s)")
    for line in _build.build_log.get("tilemarch", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    # ---- phase 2: kernel vs golden rows -----------------------------------
    golden = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                       "manifest_pixels.npz")))
    levels, geoms = r2_scene_data(16, 8)
    r2 = api.AmrData(level_data=levels, level_geometry=geoms)
    for method, row in (("tilemarch", "tilemarch-1dev"),
                        ("slicemarch", "slicemarch-1dev")):
        before = tm.tilemarch_render.launches
        image, _ = api.render(r2, api.RenderOptions(
            width=48, height=48, render_method=method, device="cuda",
            output_filename=os.path.join(SCRATCH, f"golden-{method}.ppm"),
        ), verbose=False)
        same, diff = max_diff(image.pixels, golden[row])
        log(f"phase 2: {method} vs {row}: non-finite pattern same {same}, "
            f"max |diff| {diff:.3g} (atol {ATOL:g})")
        assert tm.tilemarch_render.launches > before, "kernel not launched"
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

    worst = 0.0

    def kernel_vs_plain(phase: str, fsr, sentinel: bool = False) -> None:
        """Kernel and plain version on one frame's inputs (auto-orbit
        camera); with ``sentinel``, also on the grid with 3 sentinel
        steps appended."""
        nonlocal worst
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
            same, dc = max_diff(kc.cpu().numpy(), pc.cpu().numpy())
            same_d, dd = max_diff(kd.cpu().numpy(), pd.cpu().numpy())
            worst = max(worst, dc, dd)
            ms = min(event_ms(lambda: tm.tilemarch_render(*a, **kw))
                     for _ in range(3))
            log(f"{phase}: {p.sampling}/{p.classification}/{p.lut_size}{label}: "
                f"{a[9].shape[0]} steps, {a[6].shape[0]} items, "
                f"max |dRGBA| {dc:.3g}, max |ddepth| {dd:.3g}, "
                f"non-finite pattern same {same and same_d}, kernel {ms:.4f} ms")
            assert same and same_d and dc <= ATOL and dd <= ATOL
            if label:
                keep = a[9] < num_tiles
                assert (kc[~keep] == 0).all() and torch.isinf(kd[~keep]).all()

    # ---- phase 3: kernel vs plain on the card, 3-level scene at 1024^2 ----
    geometry3 = three_level_geometry()
    for sampling, classification, lut_size in (
        ("nearest", "post", 256), ("trilinear", "post", 256),
        ("trilinear", "pre", 128),
    ):
        kernel_vs_plain("phase 3", FastSceneRenderer(geometry3, RenderParameters(
            width=1024, height=1024, sampling=sampling,
            classification=classification, lut_size=lut_size,
        ), device=dev), sentinel=sampling == "nearest")

    # ---- phase 4: the main path at full size ------------------------------
    n, bs = 256, 32
    field = radial_field(n, 0.0, 1.0).astype(np.float32)
    boxes = [LevelBox(field[i:i + bs, j:j + bs, k:k + bs], np.array([i, j, k]))
             for i in range(0, n, bs) for j in range(0, n, bs)
             for k in range(0, n, bs)]
    plotfile = os.path.join(SCRATCH, "plt_radial_512")
    write_plotfile(plotfile, [boxes], [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))])
    png_api = os.path.join(SCRATCH, "radial_render.png")
    png_cli = os.path.join(SCRATCH, "radial_cli.png")
    tm.tilemarch_render.launches = 0  # counted run: the main path, once
    t0 = time.perf_counter()
    rc = amrvolumerenderer_torch.render(plotfile, width=1024, height=1024,
                                        output=png_api)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = tm.tilemarch_render.launches
    log(f"phase 4: render(plotfile) 512 bricks at 1024x1024: rc {rc}, "
        f"{main_s:.3f} s wall (scene build included), kernel launches {launches}")
    assert rc == 0 and launches >= 1
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

    # ---- phase 5: timing, 8 orbit cameras on the 3-level scene at 1024^2 --
    fsr = FastSceneRenderer(geometry3, RenderParameters(width=1024, height=1024),
                            device=dev)
    center = 0.5 * (fsr.bounds.min_corner + fsr.bounds.max_corner)
    cams = orbit_cameras(center, auto_orbit_camera(fsr.bounds).eye, 8)
    frames = [fsr.frame_inputs(c) for c in cams]
    kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
              logical_width=fsr.render_width, logical_height=fsr.render_height)

    def run(fn):
        total = 0.0
        for inp in frames:
            a = (fsr._packed_vol, inp["meta"], inp["dims"], fsr.lut, inp["cam"],
                 inp["offsets"], inp["bricks"], inp["owners"],
                 inp["item_bounds"], inp["tile_ids"])
            total += event_ms(lambda: fn(*a, **kw))
        return total / len(frames)

    def wall_ms(fn) -> float:
        """Host wall time per camera of ``fn(camera)``, synchronised."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in cams:
            fn(c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(cams)

    run(tm.tilemarch_render)  # warm-up
    run(tm.tilemarch_reference)
    kernel_ms = [run(tm.tilemarch_render), run(tm.tilemarch_render)]
    plain_ms = [run(tm.tilemarch_reference)]
    kernel_ms.append(run(tm.tilemarch_render))
    fsr.render(cams[0], overlay=False)
    prep_ms = wall_ms(fsr.frame_inputs)
    frame_ms = wall_ms(fsr.render_frame)
    e2e_ms = wall_ms(lambda c: fsr.render(c, overlay=False))
    log(f"phase 5: {smi}: tile-march kernel {min(kernel_ms):.4f} ms/frame "
        f"(runs {', '.join(f'{v:.4f}' for v in kernel_ms)}), plain PyTorch "
        f"{plain_ms[0]:.4f} ms/frame (1024x1024, 8 orbit cameras, 3-level "
        f"scene, CUDA events)")
    log(f"phase 5: host wall per frame: frame_inputs {prep_ms:.3f} ms, "
        f"render_frame (prep + kernel + assembly) {frame_ms:.3f} ms, "
        f"render (+ readback) {e2e_ms:.3f} ms")

    print(json.dumps({"kernels": [{
        "name": "tilemarch",
        "route": "cuda",
        "source": "amrvolumerenderer_torch/ops/csrc/tilemarch.cu",
        "replaces": "amrvolumerenderer_tpu/ops/tilemarch.py:62",
        "launches": launches,
        "max_abs_err": worst,
        "ms": min(kernel_ms),
        "plain_ms": plain_ms[0],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
