#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's three CUDA kernel libraries (tile-march, slice-march,
composite with its tile and pixel modes) from the checkout's sources, all
at once, holds each against
the golden rows and against its plain PyTorch version on the card, drives
both one-shot main paths through the entry points a user calls: a
512-brick 256^3 plotfile at 1024x1024 through
``amrvolumerenderer_torch.render`` and the CLI (more than 96 pieces: the
tile-march route), and bench.py's 3-level scene at 1024x1024 through
``render_scene`` for three knob sets (at most 96 pieces: the slice-march +
composite route), plus one 2048^2 AA=4 frame.  It times every kernel and
its plain version and splits the host wall time of the one-shot route.

Then the animation path (phases 8-13): the batched tile-march kernel on
float32 and bfloat16 volumes against its plain version;
``FastSceneRenderer.render_batch`` over a 16-frame orbit that crosses
march axes against per-frame ``render``, bit for bit, in every output mode
and at 2048^2 AA=4; the bfloat16 frame against the float32 one;
``set_transfer_function`` against a renderer built with the new map;
two ``update_data`` time steps on the 512-brick scene from CUDA tensors
and two from NumPy arrays against the plain path on the CPU; orbits through
``render(plotfile, orbit_frames=)`` and the CLI's ``--orbit-frames``, with
every batched launch of those orbits (float32 and bfloat16) replayed
against the plain version on its own arguments; and the batched kernel's
and ``render_batch``'s times, with ``render_batch``'s pinned side-stream
readback against a plain ``.cpu()`` in alternating pairs.

Then the one-shot multi-device render over 8 shards on the card (phases
14-19): the dense slice-march kernel (kernel 4) against its plain version
for every shard of the golden scene and of the 3-level scene at 1024^2
(16 nearest and 28 trilinear pieces, padding slots included); the golden
rows ``slicemarch-8dev-*`` through ``api.render(devices=8)``;
``render_scene(devices=8)`` on the 3-level scene over both pipelines and
transports against the one-device frame; the 512-brick plotfile through
``render(plotfile, devices=8)`` and the CLI's ``--devices 8`` (the
tile-march pipeline), with every kernel-4, tile-march and pixel-mode
composite (fold) launch of those sharded frames replayed against its plain
version on the same arguments; one 2048^2 AA=4 frame with its peak memory;
kernel 4's times and bound, each fold launch of a sharded frame timed
alone against its byte bound, and the sharded frame's wall split for 2 and
8 shards.

Phase 1 also logs each kernel instantiation's registers, shared memory and
spills (and fails on a spill) and counts the SASS instructions of one
valid sample and of one composite fold step (``ops/csrc/sample_probe.cu``),
from which the timing phases give an issue bound beside the FLOP bound.  Phase 20 holds the
tile-march, slice-march and dense kernels against their plain versions
with the eye inside the domain at 1024^2 (fov 45 and a fov-120 view whose
tiles hold rays of both march directions).  Every phase asserts;
any failure ends the run with a non-zero exit code.  The second-to-last line of standard output is a
JSON object with each kernel's launches, error, times and bound; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.  Scratch files go to ``build/chip_smoke/`` in the checkout.  It
imports only the port (``amrvolumerenderer_torch``), never jax and never
the JAX package.
"""

from __future__ import annotations

import contextlib
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
# sharded frame with the JAX pipelines' folded camera vs the one-device
# frame: a flipped sample moved a pixel by up to 3.3e-3 (3-level scene,
# 2048^2 AA=4, H100) and 8.7e-5 (512-brick plotfile, 1024^2)
FOLDED_ATOL = 1e-2
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
SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz


START = time.perf_counter()


def log(msg: str) -> None:
    """One line of the record, prefixed with the seconds since start."""
    print(f"[{time.perf_counter() - START:7.1f} s] {msg}", flush=True)


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


def batch_case(torch, fsr, cams):
    """The batched tile-march kernel's arguments for ``cams`` (one march
    axis) on ``fsr``: (positional args, keywords, per-frame host inputs)."""
    from amrvolumerenderer_torch.fast_scene import BATCH_TABLES, pack_batch_tables

    frames, axes = [], set()
    for c in cams:
        frames.append(fsr.frame_inputs(c, as_numpy=True))
        axes.add(fsr._packed_axis)
    assert len(axes) == 1 and all(f is not None for f in frames), axes
    num_tiles = (fsr.pad_w // 32) * (fsr.pad_h // 32)
    tables = pack_batch_tables(frames, num_tiles)
    _m, _d, meta, dims = fsr._axis_meta_cache[fsr._packed_axis]
    args = (fsr._packed_vol, meta, dims, fsr.lut) + tuple(
        torch.from_numpy(tables[k]).to(fsr.device) for k in BATCH_TABLES)
    kw = dict(width=fsr.pad_w, height=fsr.pad_h, max_slices=fsr.cube,
              logical_width=fsr.render_width, logical_height=fsr.render_height,
              sampling=fsr.parameters.sampling, ghost=fsr.ghost,
              classification=fsr.parameters.classification)
    return args, kw, frames


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
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.makedirs(SCRATCH, exist_ok=True)

    import amrvolumerenderer_torch
    from amrvolumerenderer_torch import api
    from amrvolumerenderer_torch.api import LevelBox, LevelGeometry, RenderParameters
    from amrvolumerenderer_torch import compositor
    from amrvolumerenderer_torch.compositor import sort_layers
    from amrvolumerenderer_torch.driver import load_plotfile_geometry, write_plotfile
    from amrvolumerenderer_torch.camera import camera_basis, orbit_camera_sequence
    from amrvolumerenderer_torch import fast_scene
    from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
    from amrvolumerenderer_torch.ops.worklist import choose_march_axis
    from amrvolumerenderer_torch.types import color_map_from_tuples
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
    libraries = ("tilemarch", "slicemarch", "composite")
    counters = {"tilemarch": tm.tilemarch_render,
                "slicemarch": sm.slicemarch_render_worklist_raw,
                "composite": comp.composite_tiles,  # tile mode
                "composite_pixels": comp.composite_pixels}  # the sharded folds
    batch_fn = tm.tilemarch_render_batch  # its launches count both batch entries
    dense_fn = sm.slicemarch_render  # kernel 4, in the slicemarch library

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        batch_fn.launches = 0
        dense_fn.launches = 0

    @contextlib.contextmanager
    def recorded(holder, attr, fn_name):
        """Record the arguments of every ``fn_name`` call that module
        ``holder`` makes through its module reference ``holder.<attr>``
        inside the block; the calls still go through the counted wrapper."""
        module = getattr(holder, attr)
        fn, seen = getattr(module, fn_name), []

        class Recording:
            def __getattr__(self, name):
                return getattr(module, name)

        def record(*args, **kw):
            seen.append((args, kw))
            return fn(*args, **kw)

        proxy = Recording()
        setattr(proxy, fn_name, record)
        setattr(holder, attr, proxy)
        try:
            yield seen
        finally:
            setattr(holder, attr, module)

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    # ---- phase 1: build the three kernels, one nvcc each, in parallel -----
    t0 = time.perf_counter()
    _build.build_all(libraries)
    for name in libraries:
        _build.load(name)
    log(f"phase 1: built {', '.join(libraries)} in {time.perf_counter() - t0:.3f} s "
        f"(nvcc " + ", ".join(f"{n} {_build.build_seconds[n]:.3f} s"
                              for n in libraries) + ")")
    spills = 0
    for name in libraries:
        report = ptxas_report(_build.build_log.get(name, ""))
        assert report, f"no ptxas report for {name}"
        for fn, regs, smem, stores, loads in report:
            log(f"  ptxas {name}: {fn}: {regs} registers, {smem} bytes smem, "
                f"spill stores {stores} B, spill loads {loads} B")
            spills += stores + loads
    assert spills == 0, "a kernel spills registers"
    smi_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    issue_rate = (torch.cuda.get_device_properties(0).multi_processor_count
                  * 4 * 32 * float(smi_clock) * 1e6)
    sass = sass_per_sample(_build._nvcc(), _build.NVCC_FLAGS, _build._CSRC, SCRATCH)
    log("phase 1: SASS instructions per valid sample or fold step ("
        "ops/csrc/sample_probe.cu, cuobjdump -sass): " + ", ".join(
            f"{k} {n} ({c} CALLs)" for k, (n, c) in sass.items())
        + f"; issue rate {issue_rate:.4g} thread-instructions/s ("
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x 4 "
        f"schedulers x 32 lanes x {smi_clock} MHz max SM clock)")

    def issue_ms(samples: float, key: str) -> float:
        """The least time the card takes to issue ``samples`` valid samples
        (or fold steps) of probe ``key``, every lane busy."""
        return samples * sass[key][0] / issue_rate * 1e3

    # ---- phase 2: the routes vs the golden rows ---------------------------
    golden = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                       "manifest_pixels.npz")))
    levels, geoms = r2_scene_data(16, 8)
    r2 = api.AmrData(level_data=levels, level_geometry=geoms)
    for method, row, want in (
        ("tilemarch", "tilemarch-1dev",
         {"tilemarch": 1, "slicemarch": 0, "composite": 0, "composite_pixels": 0}),
        ("slicemarch", "slicemarch-1dev",
         {"tilemarch": 0, "slicemarch": 1, "composite": 1, "composite_pixels": 0}),
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
        """Device time of ``fn``'s launches, by CUDA events.  A spin kernel
        of about 10 ms runs first, so the host has queued a wrapper's
        launches before the start event fires: a kernel's time leaves out
        its wrapper's host work (a plain version that runs longer on the
        host than the spin still counts it)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    worst = dict.fromkeys(counters, 0.0)

    def hold(name, label, pairs, atol=ATOL) -> None:
        """Assert kernel == plain (same non-finite pattern, within atol)
        for each (kernel output, plain output) pair and record the worst
        diff."""
        result = []
        for k, p in pairs:
            same, d = max_diff(k.cpu().numpy(), p.cpu().numpy())
            worst[name] = max(worst.get(name, 0.0), d)
            result.append((same, d))
        log(f"{label}: max |diff| " + ", ".join(f"{d:.3g}" for _, d in result)
            + f", non-finite pattern same {all(s for s, _ in result)}")
        assert all(s and d <= atol for s, d in result), label

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
    assert rc == 0 and counts() == {"tilemarch": 1, "slicemarch": 0, "composite": 0,
                                    "composite_pixels": 0}
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
        assert got == {"tilemarch": 0, "slicemarch": 1, "composite": 1,
                       "composite_pixels": 0}, got
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
             [(cc, qc), (cd, qd)], atol=0.0)
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
    assert counts() == {"tilemarch": 0, "slicemarch": 1, "composite": 1,
                        "composite_pixels": 0}, counts()
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
         f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), SASS issue bound "
         f"{issue_ms(blocks * 1024 / 4, 'fold_tile'):.5f} ms",
         [(cc, qc), (cd, qd)], atol=0.0)
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
    # a fold step folds 4 pixels of a covered block in the tile mode
    issue7 = {"tilemarch": issue_ms(tile_samples / 8, "tilemarch_nearest_post"),
              "slicemarch": issue_ms(sm_samples / 8, "slicemarch_nearest_post"),
              "composite": issue_ms(comp_flops / BLEND_FLOPS / 8 / 4, "fold_tile")}
    for name, (b_ms, by) in bounds_ms.items():
        log(f"phase 7: {name} bound {b_ms:.5f} ms/frame ({by}); kernel at "
            f"{b_ms / times[name][0]:.4f} of its bound"
            + (f"; SASS issue bound {issue7[name]:.5f} ms/frame, kernel at "
               f"{issue7[name] / times[name][0]:.4f} of it" if name in issue7 else ""))
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

    # ---- phase 8: batched kernel vs plain, float32 and bfloat16 ------------
    fsr_by = {"float32": fsr, "bfloat16": FastSceneRenderer(
        geometry3, RenderParameters(width=1024, height=1024), device=dev,
        precision="bfloat16")}
    batch_name = {"float32": "tilemarch_batch", "bfloat16": "tilemarch_batch_bf16"}
    for prec, r in fsr_by.items():
        args, kw, _ = batch_case(torch, r, cams[:2])
        assert args[0].dtype == getattr(torch, prec)
        kc, kd = tm.tilemarch_render_batch(*args, **kw)
        pc, pd = tm.tilemarch_batch_reference(*args, **kw)
        torch.cuda.synchronize()
        hold(batch_name[prec], f"phase 8: batched tile-march {prec} vs plain, 2 "
             f"frames x {args[9].shape[1]} steps, {args[6].shape[1]}-item rows",
             [(kc, pc), (kd, pd)])
        for f in range(2):  # each frame against the one-frame launch
            steps = int((args[9][f] < (r.pad_w // 32) * (r.pad_h // 32)).sum())
            sc, sd = tm.tilemarch_render(*args[:4], *(a[f] for a in args[4:]), **kw)
            assert torch.equal(sc[:steps], kc[f, :steps]), (prec, f)
            assert torch.equal(sd[:steps], kd[f, :steps]), (prec, f)
    log("phase 8: each batched frame equals its one-frame launch bit for bit")

    # ---- phase 9: render_batch vs per-frame render -----------------------
    orbit16 = orbit_camera_sequence(auto_orbit_camera(fsr.bounds), 16, 360.0)
    axes16 = sorted({choose_march_axis(camera_basis(c)[0]) for c in orbit16})
    batch16 = fsr.render_batch(orbit16, overlay=False)
    singles = np.stack([fsr.render(c, overlay=False) for c in orbit16])
    assert len(axes16) > 1 and np.array_equal(batch16, singles)
    stats16 = dict(fsr.last_batch_stats)
    rgba16 = fsr.render_batch(orbit16, overlay=False, bytes_out=True)
    codec = np.clip((singles[..., :4] * np.float32(256.0)).astype(np.int32), 0, 255)
    assert np.array_equal(rgba16, codec.astype(np.uint8)), "bytes_out != codec"
    assert np.array_equal(fsr.render_batch(orbit16, overlay=False, bytes_out="rgb"),
                          rgba16[..., :3]), "rgb != RGBA[:3]"
    assert np.array_equal(fsr.render_batch(orbit16, overlay=False,
                                           max_chunk_bytes=1), batch16)
    log(f"phase 9: 16-frame orbit over 360 deg (march axes {axes16}) at 1024^2: "
        f"render_batch == per-frame render bit for bit ({stats16['dispatch_count']} "
        "launches); bytes_out == host codec; rgb == RGBA[:3]; max_chunk_bytes=1 "
        f"== default; alpha > 0 on {float((batch16[..., 3] > 0).mean()):.4f}")
    fsr_aa = FastSceneRenderer(geometry3, RenderParameters(
        width=2048, height=2048, antialiasing=4), device=dev)
    aa = fsr_aa.render_batch(cams[:2], overlay=False)
    for i in range(2):
        assert np.array_equal(aa[i], fsr_aa.render(cams[i], overlay=False)), i
    assert aa.shape == (2, 2048 * 2048, 5) and np.isfinite(aa[..., :4]).all()
    log(f"phase 9: 2 frames at 2048^2 AA=4: render_batch == render bit for bit, "
        f"alpha > 0 on {float((aa[..., 3] > 0).mean()):.4f}")
    del fsr_aa, aa

    # ---- phase 10: bfloat16 storage -------------------------------------
    bf = fsr_by["bfloat16"]
    a32 = fsr.render(cams[0], overlay=False)
    a16 = bf.render(cams[0], overlay=False)
    bf_diff = float(np.abs(a32[:, :4] - a16[:, :4]).max())
    nbytes = {k: r.canonical.numel() * r.canonical.element_size()
              for k, r in fsr_by.items()}
    log(f"phase 10: bfloat16 vs float32 frame: max |diff| {bf_diff:.4g} (limit "
        f"0.02); canonical table {nbytes['float32']} bytes float32, "
        f"{nbytes['bfloat16']} bytes bfloat16")
    assert bf_diff < 0.02 and bf.canonical.dtype == torch.bfloat16
    reset_counts()  # counted run: the bfloat16 animation path
    bf.render_batch(cams, overlay=False, bytes_out=True)
    torch.cuda.synchronize()
    launches["tilemarch_batch_bf16"] = batch_fn.launches
    log(f"phase 10: bfloat16 render_batch of the 8-camera orbit: launches "
        f"{launches['tilemarch_batch_bf16']} batched, {counts()}")
    assert launches["tilemarch_batch_bf16"] >= 1 and counts()["tilemarch"] == 0

    # ---- phase 11: transfer-function swap and in-situ update --------------
    step_map = [(0.0, 0.1, 0.2, 0.9, 0.0), (0.8, 0.1, 0.2, 0.9, 0.0),
                (0.85, 0.9, 0.6, 0.1, 0.6), (1.0, 1.0, 1.0, 0.2, 0.9)]
    params = RenderParameters(width=1024, height=1024)
    swapped = FastSceneRenderer(geometry3, params, device=dev)
    swapped.set_transfer_function(color_map=color_map_from_tuples(step_map))
    built = FastSceneRenderer(geometry3, params, device=dev,
                              color_map=color_map_from_tuples(step_map))
    got_tf = swapped.render_batch(cams[:2], overlay=False)
    assert np.array_equal(got_tf, built.render_batch(cams[:2], overlay=False))
    assert np.array_equal(swapped.visible, built.visible)
    log(f"phase 11: set_transfer_function == renderer built with the map, bit "
        f"for bit; {int((~swapped.visible).sum())} of {len(swapped.visible)} "
        "pieces culled")
    del swapped, built
    upd = {"cuda": FastSceneRenderer(geometry, RenderParameters(width=512, height=512),
                                     device=dev)}
    upd["cpu"] = FastSceneRenderer(geometry, RenderParameters(width=512, height=512),
                                   device="cpu")
    ucam = auto_orbit_camera(upd["cuda"].bounds)
    base = [torch.from_numpy(np.asarray(b.data, np.float32)).to(dev)
            for b in geometry.bricks]
    for kind in ("tensor", "numpy"):
        for step in range(1, 3):  # the CPU render of each step dominates the script
            mix = 0.15 * step
            new = [b * (1.0 - mix) + (1.0 - b) * mix for b in base]
            t0 = time.perf_counter()
            if kind == "tensor":
                upd["cuda"].update_data(new)
                torch.cuda.synchronize()
                update_s = time.perf_counter() - t0
                upd["cpu"].update_data([a.cpu() for a in new])
            else:
                host = [a.cpu().numpy() for a in new]
                t0 = time.perf_counter()
                upd["cuda"].update_data(host)
                torch.cuda.synchronize()
                update_s = time.perf_counter() - t0
                upd["cpu"].update_data(host)
            assert torch.equal(upd["cuda"].canonical.cpu(), upd["cpu"].canonical)
            g = upd["cuda"].render(ucam, overlay=False)
            c = upd["cpu"].render(ucam, overlay=False)
            same, d = max_diff(g, c)
            log(f"phase 11: update_data ({kind}) step {step}: 512 bricks in "
                f"{update_s * 1e3:.1f} ms, tables equal the CPU path's, frame vs "
                f"plain CPU path max |diff| {d:.3g}, non-finite pattern same "
                f"{same}, alpha > 0 on {float((g[:, 3] > 0).mean()):.4f}")
            assert same and d <= ATOL
    del upd, base, new

    # ---- phase 12: orbit entry points -------------------------------------
    def replay(name, label, calls):
        """Hold each recorded batched launch against the plain version on
        the same arguments; returns [(frames, kernel ms)] per launch."""
        timed = []
        for args, kw in calls:
            kc, kd = batch_fn(*args, **kw)
            pc, pd = tm.tilemarch_batch_reference(*args, **kw)
            torch.cuda.synchronize()
            frames = args[4].shape[0]
            ms = min(event_ms(lambda: batch_fn(*args, **kw)) for _ in range(3))
            hold(name, f"{label}: F={frames}, {args[9].shape[1]} steps, "
                 f"{args[6].shape[1]}-item rows, kernel {ms:.4f} ms "
                 f"({ms / frames:.4f} ms/frame)", [(kc, pc), (kd, pd)])
            timed.append((frames, ms))
        return timed

    reset_counts()  # counted run: the float32 animation path, from render()
    t0 = time.perf_counter()
    with recorded(fast_scene, "tm", "tilemarch_render_batch") as api_batches:
        rc = amrvolumerenderer_torch.render(
            plotfile, width=1024, height=1024, orbit_frames=4,
            output=os.path.join(SCRATCH, "api_orbit.png"))
    torch.cuda.synchronize()
    orbit_s = time.perf_counter() - t0
    launches["tilemarch_batch"] = batch_fn.launches
    log(f"phase 12: render(plotfile, orbit_frames=4) at 1024^2: rc {rc}, "
        f"{orbit_s:.3f} s wall (scene build included), launches "
        f"{launches['tilemarch_batch']} batched of "
        f"{[a[4].shape[0] for a, _ in api_batches]} frames, {counts()}")
    assert rc == 0 and launches["tilemarch_batch"] == len(api_batches) >= 1
    assert counts() == {"tilemarch": 0, "slicemarch": 0, "composite": 0,
                        "composite_pixels": 0}
    for i in range(4):
        assert os.path.exists(os.path.join(SCRATCH, f"api_orbit_{i:04d}.png")), i
    # the batched kernel against its plain version at the shapes this run
    # gave it (512 pieces, pow2-padded rows, sentinel steps)
    replay("tilemarch_batch", "phase 12: render(orbit_frames=4) launch replayed",
           api_batches)
    del api_batches
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "amrvolumerenderer_torch.driver", "--width", "1024",
         "--height", "1024", "--orbit-frames", "8", "--output",
         os.path.join(SCRATCH, "cli_orbit.png"), plotfile],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    log(f"phase 12: CLI --orbit-frames 8 rc {cli.returncode} in "
        f"{time.perf_counter() - t0:.3f} s")
    assert cli.returncode == 0, cli.stderr[-4000:]
    pngs = [read_png_rgb(os.path.join(SCRATCH, f"cli_orbit_{i:04d}.png"))
            for i in range(8)]
    # the two-shell field is symmetric under quarter turns, so frames 90
    # degrees apart may repeat; neighbours 45 degrees apart differ
    assert all(not np.array_equal(a, b) for a, b in zip(pngs, pngs[1:])), \
        "neighbouring orbit frames are equal"
    image, _ = render_scene("", RenderParameters(width=1024, height=1024),
                            geometry, verbose=False, method="tilemarch", device=dev)

    def png_bytes(pixels):
        b = np.clip((pixels[:, :3] * np.float32(256.0)).astype(np.int32), 0, 255)
        return b.astype(np.uint8).reshape(1024, 1024, 3)[::-1]

    expect = png_bytes(image.pixels)
    assert np.array_equal(pngs[0], expect), "orbit frame 0 != single render"
    assert np.array_equal(read_png_rgb(os.path.join(SCRATCH, "api_orbit_0000.png")),
                          expect)
    log(f"phase 12: 8 PNGs, {len({p.tobytes() for p in pngs})} distinct, "
        "neighbours differ; frame 0 (CLI and render()) equals the single "
        "tile-march render")
    # the CLI's orbit in this process, float32 and bfloat16: its chunking,
    # every launch against the plain version, and the per-frame kernel
    # time at the chunk sizes an orbit user gets
    p12 = RenderParameters(width=1024, height=1024)
    cams8 = orbit_camera_sequence(auto_orbit_camera(
        compute_global_bounds(geometry), p12.camera_seed, p12.camera_up), 8, 360.0)
    orbit8, orbit_f_ms = {}, {}
    for prec, name in batch_name.items():
        r = FastSceneRenderer(geometry, p12, device=dev, precision=prec)
        with recorded(fast_scene, "tm", "tilemarch_render_batch") as rec:
            orbit8[prec] = r.render_batch(cams8)
        sizes = [a[4].shape[0] for a, _ in rec]
        log(f"phase 12: render_batch({prec}) of the CLI's 8-frame orbit, 512 "
            f"bricks at 1024^2: {len(rec)} launches of {sizes} frames")
        timed = replay(name, f"phase 12: batched tile-march {prec} vs plain, "
                       "CLI orbit launch", rec)
        orbit_f_ms[prec] = {f: min(ms / f for g, ms in timed if g == f)
                            for f in sorted(set(sizes))}
        log(f"phase 12: {smi}: batched tile-march {prec}, 512 bricks at "
            "1024^2, kernel ms/frame by chunk size: " + ", ".join(
                f"F={f} {v:.4f}" for f, v in orbit_f_ms[prec].items()))
        del r, rec
    for i, png in enumerate(pngs):
        assert np.array_equal(png, png_bytes(orbit8["float32"][i])), i
    bf_orbit = float(np.abs(orbit8["float32"][..., :4]
                            - orbit8["bfloat16"][..., :4]).max())
    log(f"phase 12: every CLI frame equals the in-process render_batch frame; "
        f"bfloat16 vs float32 orbit max |diff| {bf_orbit:.4g} (limit 0.02)")
    assert bf_orbit < 0.02
    del orbit8

    # ---- phase 13: timing of the animation path ----------------------------
    log(f"phase 13: {smi}")
    one_axis = orbit_camera_sequence(auto_orbit_camera(fsr.bounds), 8, 8.0)
    batch_times, batch_bounds = {}, {}
    for prec, r in fsr_by.items():
        args8, kw8, frames8 = batch_case(torch, r, one_axis)
        singles1 = [batch_case(torch, r, [c])[0] for c in one_axis]
        pairs2 = [batch_case(torch, r, one_axis[j:j + 2])[0] for j in range(0, 8, 2)]
        batch_fn(*args8, **kw8)  # warm-up
        f8 = [event_ms(lambda: batch_fn(*args8, **kw8)) / 8 for _ in range(3)]
        f2 = [sum(event_ms(lambda a=a: batch_fn(*a, **kw8)) for a in pairs2) / 8
              for _ in range(3)]
        f1 = [sum(event_ms(lambda a=a: batch_fn(*a, **kw8)) for a in singles1) / 8
              for _ in range(3)]
        plain = event_ms(lambda: tm.tilemarch_batch_reference(*args8, **kw8)) / 8
        samples, nbytes_ = 0, 0
        for fr, cam_t in zip(frames8, args8[4]):
            ids = torch.from_numpy(fr["tile_ids"]).to(dev)
            wt = torch.repeat_interleave(
                ids.long(), torch.diff(torch.from_numpy(fr["offsets"]).to(dev).long()))
            br = torch.from_numpy(fr["bricks"]).to(dev)
            ib = torch.from_numpy(fr["item_bounds"]).to(dev)
            samples += valid_samples(torch, args8[1], args8[2], cam_t, br, wt, ib,
                                     r.pad_w // 32, 1024, 1024, r.cube)
            nbytes_ += (band_bytes(torch, br, ib, args8[2], r.cube,
                                   cell_bytes=args8[0].element_size())
                        + r.lut.numel() * 4 + len(fr["tile_ids"]) * 1024 * 20)
        batch_bounds[prec] = bound(nbytes_ / 8, samples * SAMPLE_FLOPS[
            ("nearest", "post")] / 8)
        issue13 = issue_ms(samples / 8, "tilemarch_nearest_post" if prec == "float32"
                           else "tilemarch_bf16_nearest_post")
        batch_times[prec] = (min(f8), plain, min(f1), f8, f1)
        log(f"phase 13: batched tile-march {prec}, 8 frames of one march axis at "
            f"1024^2: F=8 {min(f8):.4f} ms/frame (runs "
            f"{', '.join(f'{v:.4f}' for v in f8)}), F=2 {min(f2):.4f} ms/frame "
            f"(runs {', '.join(f'{v:.4f}' for v in f2)}), F=1 {min(f1):.4f} ms/frame "
            f"(runs {', '.join(f'{v:.4f}' for v in f1)}), plain PyTorch "
            f"{plain:.4f} ms/frame; bound {batch_bounds[prec][0]:.5f} ms/frame "
            f"({batch_bounds[prec][1]}; {samples / 8:.0f} valid samples/frame); "
            f"SASS issue bound {issue13:.5f} ms/frame")
    for mode in (True, "rgb"):
        fsr.render_batch(cams, overlay=False, bytes_out=mode)  # warm-up
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fsr.render_batch(cams, overlay=False, bytes_out=mode)
            runs.append(((time.perf_counter() - t0) * 1e3 / 8,
                         dict(fsr.last_batch_stats)))
        wall, st = min(runs, key=lambda x: x[0])
        log(f"phase 13: render_batch(8-camera orbit, bytes_out={mode!r}) at "
            f"1024^2: {wall:.3f} ms/frame wall (runs "
            f"{', '.join(f'{w:.3f}' for w, _ in runs)}); per frame host prep "
            f"{st['host_prep_ms'] / 8:.3f} ms, dispatch {st['dispatch_ms'] / 8:.3f} "
            f"ms, readback {st['readback_ms'] / 8:.3f} ms "
            f"({st['readback_mb'] / 8:.3f} MB); {st['dispatch_count']} launches")

    # readback: the pinned side-stream copy render_batch makes against a
    # plain .cpu() of each chunk, in alternating pairs, on 32 frames of one
    # march axis (two 16-frame chunks) and bench.py's 8-camera orbit (four
    # 2-frame chunks), bytes_out=True; both variants warmed first
    def plain_readback(on):
        if on:
            fsr._start_readback = lambda frames, slot: frames
            fsr._finish_readback = lambda frames: frames.cpu().numpy()
        else:
            fsr.__dict__.pop("_start_readback", None)
            fsr.__dict__.pop("_finish_readback", None)

    orbit32 = orbit_camera_sequence(auto_orbit_camera(fsr.bounds), 32, 16.0)
    workloads = {"32 frames, 2 chunks": orbit32, "8-camera orbit, 4 chunks": cams}
    refs = {k: fsr.render_batch(v, overlay=False, bytes_out=True)
            for k, v in workloads.items()}
    rb_samples = {(k, v): [] for k in workloads for v in ("pinned", "plain")}
    pairs = 10
    for turn in range(pairs + 1):  # turn 0 warms both variants
        order = ("pinned", "plain") if turn % 2 else ("plain", "pinned")
        for variant in order:
            plain_readback(variant == "plain")
            for k, cams_k in workloads.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fsr.render_batch(cams_k, overlay=False, bytes_out=True)
                wall = (time.perf_counter() - t0) * 1e3 / len(cams_k)
                assert np.array_equal(got, refs[k]), (variant, k)
                if turn:
                    rb_samples[(k, variant)].append(
                        (wall, fsr.last_batch_stats["readback_ms"] / len(cams_k)))
    plain_readback(False)
    for k in workloads:
        med = {v: float(np.median([w for w, _ in rb_samples[(k, v)]]))
               for v in ("pinned", "plain")}
        log(f"phase 13: {smi}: readback, {k}, bytes_out, {pairs} alternating "
            f"pairs: " + "; ".join(
                f"{v}: wall median {med[v]:.3f} ms/frame (runs "
                f"{', '.join(f'{w:.3f}' for w, _ in rb_samples[(k, v)])}), readback "
                f"{', '.join(f'{r:.3f}' for _, r in rb_samples[(k, v)])} ms/frame"
                for v in ("pinned", "plain"))
            + f"; pinned/plain wall {med['pinned'] / med['plain']:.3f}")

    # ---- phases 14-19: the one-shot multi-device render (devices=8) --------
    from amrvolumerenderer_torch.parallel import directsend as ds

    def dense_case(geom, params, camera, width, height, num):
        """Kernel 4's per-shard arguments for one depth-contiguous frame of
        ``geom`` over ``num`` shards, as the pipeline packs them: (prep,
        mesh, sharded tables, [(args, kw)] per shard)."""
        b = compute_global_bounds(geom)
        prep = rf.prepare_slicemarch_scene(
            geom, params, camera, compute_global_scalar_range(geom),
            compute_reference_sample_distance(geom, b), width, height, None)
        order = sort_layers(prep["depth_hints"], prep["owners"],
                            prep["local_indices"])
        packed, valid, hints = ds.pack_depth_contiguous(
            prep["depth_hints"][order], np.arange(len(order), dtype=np.int32),
            num, *(prep[k][order] for k in ("vol", "meta", "dims", "luts")))
        mesh = ds.make_mesh(num, dev)
        tables = ds.shard_leading(mesh, *packed, valid, hints)
        cam = ds._constant_camera(prep["cam"]).to(dev)
        kw = dict(width=prep["pad_w"], height=prep["pad_h"],
                  max_slices=prep["s_max"], logical_width=width,
                  logical_height=height, sampling=params.sampling,
                  ghost=prep["ghost"], classification=params.classification)
        return prep, mesh, tables, [(tuple(t[r] for t in tables[:4]) + (cam,), kw)
                                    for r in range(num)]

    def hold_dense(label, shards):
        """Each shard's kernel-4 launch against the plain version on the
        same arguments."""
        pairs = []
        for args, kw in shards:
            kc, kd = dense_fn(*args, **kw)
            pc, pd = sm.untile(*sm.slicemarch_dense_reference(*args, **kw),
                               kw["width"], kw["height"])
            pairs += [(kc, pc), (kd, pd)]
        torch.cuda.synchronize()
        hold("slicemarch_dense", label, pairs)

    def hold_calls(name, kernel, plain, label, calls, atol=ATOL):
        """Each recorded launch of ``kernel`` against ``plain`` on the same
        arguments."""
        pairs = []
        for args, kw in calls:
            pairs += list(zip(kernel(*args, **kw), plain(*args, **kw)))
        torch.cuda.synchronize()
        hold(name, label, pairs, atol)

    @contextlib.contextmanager
    def recorded_folds():
        """Record every fold (pixel-mode composite) call: directsend's own
        and those through ``compositor._composite_sorted_runs``."""
        with recorded(ds, "comp", "composite_pixels") as direct, \
                recorded(compositor, "comp", "composite_pixels") as via_runs:
            calls = []
            yield calls
        calls += direct + via_runs

    def sharded_run(render):
        """One counted run of a sharded frame with every kernel-4,
        tile-march and fold launch recorded: (result, wall s, counts,
        kernel-4 launches, {name: recorded calls})."""
        reset_counts()
        t0 = time.perf_counter()
        with recorded(ds, "sm", "slicemarch_render") as dense_rec, \
                recorded(ds, "tm", "tilemarch_render") as tile_rec, \
                recorded_folds() as fold_rec:
            out = render()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, counts(), dense_fn.launches,
                {"slicemarch_dense": dense_rec, "tilemarch": tile_rec,
                 "composite_pixels": fold_rec})

    def replay_sharded(label, rec):
        """Every recorded launch of a sharded run against its plain version."""
        if rec["slicemarch_dense"]:
            hold_dense(f"{label}: {len(rec['slicemarch_dense'])} kernel-4 launches "
                       "replayed", rec["slicemarch_dense"])
        if rec["tilemarch"]:
            hold_calls("tilemarch", tm.tilemarch_render, tm.tilemarch_reference,
                       f"{label}: {len(rec['tilemarch'])} tile-march launches "
                       "replayed", rec["tilemarch"])
        folds = rec["composite_pixels"]
        hold_calls("composite_pixels",
                   lambda *a: [comp.composite_pixels(*a)],
                   lambda *a: [comp.composite_pixels_reference(*a)],
                   f"{label}: {len(folds)} fold launches replayed "
                   f"({[tuple(a[0].shape[:2]) for a, _ in folds]} layers x "
                   "pixels)", folds, atol=0.0)

    # fold (pixel-mode composite) launches of one sharded frame over 8
    # shards: the local fold of each shard's depth run, then the fold of the
    # exchanged partials (depth) or of the exchanged layers (layered); no
    # tile-mode launch
    fold_launches = {"depth": 16, "layered": 8}

    # phase 14: kernel 4 vs plain on the card, one launch per shard
    r2_geometry = api.load_amr_geometry(r2, 0, -1, 0, False, True, verbose=False)
    p14 = [("golden scene 48x48", r2_geometry, RenderParameters(width=48, height=48),
            None, 48, 48)]
    for sampling, classification, lut_size in KNOBS[:2]:
        p14.append((f"3-level 1024x1024 {sampling}/{classification}/{lut_size}",
                    geometry3, RenderParameters(
                        width=1024, height=1024, sampling=sampling,
                        classification=classification, lut_size=lut_size),
                    auto_orbit_camera(bounds3), 1024, 1024))
    for label, geom, params, camera, w, h in p14:
        camera = camera or auto_orbit_camera(compute_global_bounds(geom))
        prep, _, tables, shards = dense_case(geom, params, camera, w, h, 8)
        slots = int(tables[4][0].numel())
        hold_dense(f"phase 14: kernel 4 vs plain, {label}: "
                   f"{prep['vol'].shape[0]} pieces over 8 shards of {slots} slots "
                   f"({8 * slots - prep['vol'].shape[0]} padding)", shards)

    # phase 15: the golden rows slicemarch-8dev-* through api.render(devices=8)
    for row, opts in (("slicemarch-8dev-depth-f32", dict(multichip_pipeline="depth")),
                      ("slicemarch-8dev-layered-f32",
                       dict(multichip_pipeline="layered")),
                      ("slicemarch-8dev-depth-ubyte",
                       dict(multichip_pipeline="depth", multichip_transport="ubyte"))):
        (image, _), _, got, dense_n, rec = sharded_run(lambda: api.render(
            r2, api.RenderOptions(
                width=48, height=48, devices=8, render_method="slicemarch",
                device="cuda", output_filename=os.path.join(SCRATCH, f"{row}.ppm"),
                **opts), verbose=False))
        same, diff = max_diff(image.pixels, golden[row])
        log(f"phase 15: api.render(devices=8) vs {row}: non-finite pattern same "
            f"{same}, max |diff| {diff:.3g} (atol {ATOL:g}); launches kernel 4 "
            f"{dense_n}, {got}")
        assert same and diff <= ATOL, row
        assert dense_n == 8 and got == {
            "tilemarch": 0, "slicemarch": 0, "composite": 0,
            "composite_pixels": fold_launches[opts["multichip_pipeline"]]}, got
        replay_sharded(f"phase 15: {row}", rec)

    @contextlib.contextmanager
    def unfolded_camera():
        """The sharded pipelines with the camera pack as a one-device frame
        takes it.  The JAX pipelines' programs fold the camera into their
        ray arithmetic (``directsend._constant_camera``, ROADMAP.md section
        3), which moves rays by an ulp and can flip a sample at a cell or
        LUT-bin edge; without it the pipeline alone is held at 1e-5."""
        folded = ds._constant_camera
        ds._constant_camera = ds._as_tensor
        try:
            yield
        finally:
            ds._constant_camera = folded

    def near_one_device(label, render_sharded, one):
        """Hold a sharded frame against the one-device frame: with the
        camera unfolded within 1e-5 (the JAX tests' bound,
        tests/test_multichip_product.py:262); as rendered, the same
        non-finite pattern, at most 0.1% of pixels beyond 1e-5 and none
        beyond FOLDED_ATOL."""
        frame = render_sharded()
        with unfolded_camera():
            plain = render_sharded()
        same_p, d_p = max_diff(plain, one)
        same, d = max_diff(frame, one)
        diff = np.where(np.isfinite(one), np.abs(frame - one), 0.0).max(axis=1)
        beyond = int((diff > 1e-5).sum())
        log(f"{label}: vs one device, camera unfolded: max |diff| {d_p:.3g}, "
            f"non-finite pattern same {same_p}; as rendered (JAX's folded "
            f"camera): max |diff| {d:.3g}, {beyond} of {len(diff)} pixels beyond "
            f"1e-5 (limit {FOLDED_ATOL:g}), non-finite pattern same {same}")
        assert same_p and d_p <= 1e-5 and same and beyond <= 1e-3 * len(diff)
        assert d <= FOLDED_ATOL, (label, d)
        return frame

    # phase 16: the 3-level scene at 1024^2 over 8 shards, both pipelines and
    # transports, against the one-device frame; every launch replayed
    p16 = RenderParameters(width=1024, height=1024)
    one_device, _ = render_scene("", p16, geometry3, verbose=False, device=dev)
    for pipeline, transport in (("depth", "float32"), ("layered", "float32"),
                                ("depth", "ubyte"), ("layered", "ubyte")):
        params = RenderParameters(width=1024, height=1024, devices=8,
                                  multichip_pipeline=pipeline,
                                  multichip_transport=transport)
        # counted run: the multi-device main path
        (image, _), wall, got, dense_n, rec = sharded_run(lambda: render_scene(
            "", params, geometry3, verbose=False, device=dev))
        if (pipeline, transport) == ("depth", "float32"):
            launches["slicemarch_dense"] = dense_n
            launches["composite_pixels"] = got["composite_pixels"]
        d_rgba = float(np.abs(image.pixels[:, :4] - one_device.pixels[:, :4]).max())
        log(f"phase 16: render_scene(devices=8) 3-level 1024x1024 {pipeline}/"
            f"{transport}: {wall:.3f} s wall, launches kernel 4 {dense_n} "
            f"({[a[0].shape[0] for a, _ in rec['slicemarch_dense']]} slots each), "
            f"{got}; vs one device: colour max |diff| {d_rgba:.3g}")
        assert dense_n == 8 == len(rec["slicemarch_dense"])
        assert got == {"tilemarch": 0, "slicemarch": 0, "composite": 0,
                       "composite_pixels": fold_launches[pipeline]}, got
        if transport == "float32":
            near_one_device(f"phase 16: {pipeline}/{transport}", lambda: render_scene(
                "", params, geometry3, verbose=False, device=dev)[0].pixels,
                one_device.pixels)
        else:
            assert d_rgba < 0.02
        replay_sharded(f"phase 16: {pipeline}/{transport}", rec)
        del rec

    # phase 17: the 512-brick plotfile through render(devices=8) and the CLI
    png_api8 = os.path.join(SCRATCH, "radial_devices8.png")
    png_cli8 = os.path.join(SCRATCH, "radial_cli_devices8.png")
    # counted run: the tile-march pipeline over 8 shards
    rc, wall, got, dense_n, rec = sharded_run(lambda: amrvolumerenderer_torch.render(
        plotfile, width=1024, height=1024, devices=8, output=png_api8))
    log(f"phase 17: render(plotfile, devices=8) 512 bricks at 1024x1024: rc {rc}, "
        f"{wall:.3f} s wall, launches {got}, kernel 4 {dense_n}; tile-march "
        f"launches on {[a[0].shape[0] for a, _ in rec['tilemarch']]} slots and "
        f"{[a[6].shape[0] for a, _ in rec['tilemarch']]} items")
    assert rc == 0 and got == {"tilemarch": 8, "slicemarch": 0, "composite": 0,
                               "composite_pixels": 8}, got
    assert dense_n == 0 and len(rec["tilemarch"]) == 8
    replay_sharded("phase 17: render(plotfile, devices=8)", rec)
    del rec
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "amrvolumerenderer_torch.driver", "--width", "1024",
         "--height", "1024", "--devices", "8", "--output", png_cli8, plotfile],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    log(f"phase 17: CLI --devices 8 rc {cli.returncode} in "
        f"{time.perf_counter() - t0:.3f} s")
    assert cli.returncode == 0, cli.stderr[-4000:]
    image1, _ = render_scene("", RenderParameters(width=1024, height=1024),
                             geometry, verbose=False, device=dev)
    frame8 = near_one_device("phase 17: 512 bricks, 8 shards", lambda: render_scene(
        "", RenderParameters(width=1024, height=1024, devices=8), geometry,
        verbose=False, device=dev)[0].pixels, image1.pixels)
    rgb_api, rgb_cli = read_png_rgb(png_api8), read_png_rgb(png_cli8)
    byte_d = int(np.abs(rgb_api.astype(int) - png_bytes(image1.pixels)).max())
    log(f"phase 17: render() PNG == CLI PNG {np.array_equal(rgb_api, rgb_cli)}, "
        f"== the 8-shard frame's bytes "
        f"{np.array_equal(rgb_api, png_bytes(frame8))}, vs one-device bytes max "
        f"{byte_d}")
    assert np.array_equal(rgb_api, rgb_cli) and np.array_equal(rgb_api, png_bytes(frame8))
    assert byte_d <= 1

    # phase 18: one 2048^2 AA=4 depth frame over 8 shards
    params = RenderParameters(width=2048, height=2048, antialiasing=4, devices=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    image, _ = render_scene("", params, geometry3, verbose=False, device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    covered = float((image.pixels[:, 3] > 0).mean())
    log(f"phase 18: 2048x2048 AA=4 devices=8 (depth): {wall:.3f} s wall, kernel 4 "
        f"launches {dense_fn.launches}, {counts()}, peak device memory {peak:.3f} "
        f"GiB, alpha > 0 on {covered:.4f}")
    assert dense_fn.launches == 8 and counts() == {
        "tilemarch": 0, "slicemarch": 0, "composite": 0,
        "composite_pixels": fold_launches["depth"]}
    assert ALPHA_FRACTION[0] <= covered <= ALPHA_FRACTION[1], covered
    one_aa, _ = render_scene("", RenderParameters(width=2048, height=2048,
                                                  antialiasing=4),
                             geometry3, verbose=False, device=dev)
    near_one_device("phase 18: 2048x2048 AA=4", lambda: render_scene(
        "", params, geometry3, verbose=False, device=dev)[0].pixels, one_aa.pixels)
    del image, one_aa

    # phase 19: kernel 4's times and bound; the sharded frame's wall split
    log(f"phase 19: {smi}")
    prep19, _, tables19, shards19 = dense_case(
        geometry3, RenderParameters(width=1024, height=1024), cams[0], 1024, 1024, 8)
    for args, kw in shards19:  # warm-up
        dense_fn(*args, **kw)
    per_frame = [event_ms(lambda: [dense_fn(*a, **k) for a, k in shards19])
                 for _ in range(3)]
    per_launch = [min(event_ms(lambda a=a, k=k: dense_fn(*a, **k)) for _ in range(3))
                  for a, k in shards19]
    plain_frame = event_ms(lambda: [sm.slicemarch_dense_reference(*a, **k)
                                    for a, k in shards19])
    samples, nbytes = 0, 0
    kw19 = shards19[0][1]
    num_tiles = (kw19["width"] // 32) * (kw19["height"] // 32)
    for args, kw in shards19:
        slots = args[0].shape[0]
        bricks, tiles = sm.dense_worklist(slots, num_tiles, dev)
        bounds = args[2][:, 7][bricks.long()]
        samples += valid_samples(torch, args[1], args[2], args[4], bricks, tiles,
                                 bounds, kw["width"] // 32, 1024, 1024,
                                 kw["max_slices"])
        nbytes += (band_bytes(torch, bricks, bounds, args[2], kw["max_slices"])
                   + args[3].numel() * 4 + slots * num_tiles * 1024 * 20)
    bounds_ms["slicemarch_dense"] = bound(nbytes, samples * SAMPLE_FLOPS[
        ("nearest", "post")])
    times["slicemarch_dense"] = (min(per_frame), plain_frame)
    log(f"phase 19: kernel 4 SASS issue bound "
        f"{issue_ms(samples, 'slicemarch_nearest_post'):.5f} ms per frame")
    log(f"phase 19: kernel 4, 3-level 1024x1024 nearest/post/256 over 8 shards "
        f"({prep19['vol'].shape[0]} pieces, {args[0].shape[0]} slots per shard): "
        f"{min(per_frame):.4f} ms per frame of 8 launches (runs "
        f"{', '.join(f'{v:.4f}' for v in per_frame)}), per launch "
        f"{', '.join(f'{v:.4f}' for v in per_launch)} ms; plain PyTorch "
        f"{plain_frame:.4f} ms per frame; bound {bounds_ms['slicemarch_dense'][0]:.5f}"
        f" ms ({bounds_ms['slicemarch_dense'][1]}; {samples} valid samples, "
        f"{nbytes} bytes); kernel at "
        f"{bounds_ms['slicemarch_dense'][0] / min(per_frame):.4f} of its bound")
    del tables19, shards19

    # each fold launch of a sharded frame timed alone (the pixel-mode
    # composite), against its byte bound: each of its L layers read once
    # and the frame written once, (L + 1) * P * 20 bytes
    fold_rows = {}
    for num in (2, 8):
        for pipeline in ("depth", "layered"):
            with recorded_folds() as folds:
                rf.render_composited_sharded(
                    geometry3, RenderParameters(width=1024, height=1024), cams[0],
                    srange3, rsd3, 1024, 1024, None, num, pipeline=pipeline,
                    device=dev)
            torch.cuda.synchronize()
            rows = []
            for args, _ in folds:
                n_l, n_p = args[0].shape[:2]
                ms = min(event_ms(lambda a=args: comp.composite_pixels(*a))
                         for _ in range(3))
                plain = event_ms(lambda a=args: comp.composite_pixels_reference(*a))
                rows.append((n_l, n_p, ms, plain, (n_l + 1) * n_p * 20,
                             n_l * n_p * BLEND_FLOPS))
            fold_rows[(num, pipeline)] = rows
            log(f"phase 19: {smi}: fold launches of one D={num} {pipeline} frame, "
                "each timed alone (layers x pixels: kernel ms, plain ms, byte "
                "bound ms, share of the bound, SASS issue bound ms): " + "; ".join(
                    f"{n_l}x{n_p}: {ms:.4f}, {plain:.4f}, "
                    f"{bound(nb, nf)[0]:.5f}, {bound(nb, nf)[0] / ms:.3f}, "
                    f"{issue_ms(n_l * n_p, 'fold_pixel'):.5f}"
                    for n_l, n_p, ms, plain, nb, nf in rows))
    rows8 = fold_rows[(8, "depth")]
    times["composite_pixels"] = (sum(r[2] for r in rows8), sum(r[3] for r in rows8))
    bounds_ms["composite_pixels"] = bound(sum(r[4] for r in rows8),
                                          sum(r[5] for r in rows8))
    log(f"phase 19: fold launches of one D=8 depth frame: {len(rows8)} launches, "
        f"{times['composite_pixels'][0]:.4f} ms in all, bound "
        f"{bounds_ms['composite_pixels'][0]:.5f} ms "
        f"({bounds_ms['composite_pixels'][1]}), kernel at "
        f"{bounds_ms['composite_pixels'][0] / times['composite_pixels'][0]:.4f} "
        "of its bound")

    def sharded_split(camera, num, pipeline):
        """Host wall split of one sharded frame (depth or layered pipeline,
        float32), synchronised after each stage; returns ([ms per stage],
        the frame)."""
        sync = torch.cuda.synchronize
        t = [time.perf_counter()]
        prep = rf.prepare_slicemarch_scene(geometry3, params19, camera, srange3,
                                           rsd3, 1024, 1024, None)
        rect, tiles = ds.select_compaction(prep["coverage"], prep["pad_w"],
                                           prep["pad_h"], 32, 32, num)
        t.append(time.perf_counter())
        if pipeline == "layered":
            order = np.lexsort((prep["local_indices"], prep["owners"]))
            packed, valid, hints = ds.pack_contiguous(
                num, prep["depth_hints"][order],
                *(prep[k][order] for k in ("vol", "meta", "dims", "luts")))
        else:
            order = sort_layers(prep["depth_hints"], prep["owners"],
                                prep["local_indices"])
            packed, valid, hints = ds.pack_depth_contiguous(
                prep["depth_hints"][order], np.arange(len(order), dtype=np.int32),
                num, *(prep[k][order] for k in ("vol", "meta", "dims", "luts")))
        t.append(time.perf_counter())
        mesh = ds.make_mesh(num, dev)
        tables = ds.shard_leading(mesh, *packed, valid, hints)
        sync(); t.append(time.perf_counter())
        kw = dict(max_slices=prep["s_max"], logical_width=1024, logical_height=1024,
                  ghost=prep["ghost"])
        layers, hints = ds._render_shards(mesh, tables, prep["cam"], rect, tiles,
                                          prep["pad_w"], prep["pad_h"], **kw)
        sync(); t.append(time.perf_counter())
        if pipeline == "layered":
            received = ds._exchange(mesh, layers)
            gathered = ds.all_gather(mesh, hints)
            sync(); t.append(time.perf_counter())
            out = ds._fold_layers(mesh, received, gathered)
        else:
            partials = ds._local_precomposite(mesh, layers, hints)
            sync(); t.append(time.perf_counter())
            received = ds._exchange(mesh, partials)
            sync(); t.append(time.perf_counter())
            out = ds._fold_partials(mesh, received)
        sync(); t.append(time.perf_counter())
        frame = ds.paste_tiles(ds.paste_rect(rf._fetch_global(out), rect,
                                             prep["pad_w"], prep["pad_h"]),
                               tiles, prep["pad_w"], prep["pad_h"])
        frame = frame.reshape(prep["pad_h"], prep["pad_w"], 5)[:1024, :1024]
        t.append(time.perf_counter())
        ms = np.diff(t) * 1e3
        if pipeline == "layered":  # no local fold
            ms = np.concatenate([ms[:4], [0.0], ms[4:]])
        return ms, frame.reshape(-1, 5)

    params19 = RenderParameters(width=1024, height=1024)
    stages = ("host prep", "packing", "uploads", "per-shard render", "local fold",
              "exchange", "fold", "gather")
    for num in (2, 8):
        for pipeline in ("depth", "layered"):
            ms0, frame = sharded_split(cams[0], num, pipeline)  # warm-up
            whole = rf.render_composited_sharded(
                geometry3, params19, cams[0], srange3, rsd3, 1024, 1024, None, num,
                pipeline=pipeline, device=dev)
            assert np.array_equal(frame, whole), (num, pipeline)
            split = np.mean([sharded_split(c, num, pipeline)[0] for c in cams], axis=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for c in cams:
                rf.render_composited_sharded(geometry3, params19, c, srange3, rsd3,
                                             1024, 1024, None, num,
                                             pipeline=pipeline, device=dev)
            total = (time.perf_counter() - t0) * 1e3 / len(cams)
            log(f"phase 19: {smi}: render_composited_sharded D={num} {pipeline}/"
                "float32, 3-level 1024x1024, host wall per frame (8 orbit cameras): "
                + ", ".join(f"{s} {v:.3f} ms" for s, v in zip(stages, split))
                + f"; sum {split.sum():.3f} ms; whole call {total:.3f} ms")

    # ---- phase 20: the eye inside the domain at 1024^2 ---------------------
    # At fov 45 every ray of a tile marches one way along the frame's march
    # axis.  At fov 120 on a diagonal view some rays are more than 90
    # degrees off that axis, so tiles around the plane d_a = 0 hold rays of
    # both directions in the pieces around the eye.
    from amrvolumerenderer_torch.api import CameraParameters

    inside = {
        "fov 45": CameraParameters(eye=(0.4, 0.45, 0.5), look_at=(0.9, 0.5, 0.5),
                                   up=(0.0, 1.0, 0.0)),
        "fov 120": CameraParameters(eye=(0.4, 0.45, 0.5), look_at=(1.4, 1.35, 1.3),
                                    up=(0.0, 1.0, 0.0), fov_y_degrees=120.0),
    }
    p20 = RenderParameters(width=1024, height=1024)
    for label, camera in inside.items():
        inputs = fsr.frame_inputs(camera)
        a = (fsr._packed_vol, inputs["meta"], inputs["dims"], fsr.lut,
             inputs["cam"], inputs["offsets"], inputs["bricks"], inputs["owners"],
             inputs["item_bounds"], inputs["tile_ids"])
        kc, kd = tm.tilemarch_render(*a, **tkw)
        pc, pd = tm.tilemarch_reference(*a, **tkw)
        torch.cuda.synchronize()
        hold("tilemarch", f"phase 20: eye inside, {label}: tile-march kernel vs "
             f"plain, {a[9].shape[0]} steps, {a[6].shape[0]} items",
             [(kc, pc), (kd, pd)])
        prep, inp, args, kw, _, _ = slicemarch_frame(p20, camera, 1024, 1024)
        cov = inp["coverage"]
        kc, kd = sm.slicemarch_render_worklist_raw(*args, **kw)
        pc, pd = sm.slicemarch_reference(*args, **kw)
        torch.cuda.synchronize()
        hold("slicemarch", f"phase 20: eye inside, {label}: slice-march kernel vs "
             f"plain, {len(prep['wb'])} items, {int(cov.sum())} covered blocks",
             [(kc[cov], pc[cov]), (kd[cov], pd[cov])])
        _, _, _, shards = dense_case(geometry3, p20, camera, 1024, 1024, 8)
        hold_dense(f"phase 20: eye inside, {label}: kernel 4 vs plain over 8 "
                   "shards", shards)

    sources = {
        "tilemarch": ("ops/csrc/tilemarch.cu", "amrvolumerenderer_tpu/ops/tilemarch.py:819"),
        "slicemarch": ("ops/csrc/slicemarch.cu", "amrvolumerenderer_tpu/ops/slicemarch.py:750"),
        "composite": ("ops/csrc/composite.cu", "amrvolumerenderer_tpu/ops/composite.py:114"),
        "composite_pixels": ("ops/csrc/composite.cu",
                             "amrvolumerenderer_tpu/compositor.py:81"),
        "tilemarch_batch": ("ops/csrc/tilemarch.cu",
                            "amrvolumerenderer_tpu/ops/tilemarch.py:711"),
        "tilemarch_batch_bf16": ("ops/csrc/tilemarch.cu",
                                 "amrvolumerenderer_tpu/ops/tilemarch.py:711"),
        "slicemarch_dense": ("ops/csrc/slicemarch.cu",
                             "amrvolumerenderer_tpu/ops/slicemarch.py:555"),
    }
    for prec, name in batch_name.items():
        times[name] = batch_times[prec][:2]
        bounds_ms[name] = batch_bounds[prec]
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
    } for name in sources]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def ptxas_report(build_log: str):
    """[(kernel, registers, smem bytes, spill store bytes, spill load
    bytes)] of every entry function in an ``nvcc -Xptxas -v`` log."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((demangle(name), int(m.group(1)),
                         int(smem.group(1)) if smem else 0, *spill))
            name, spill = None, (0, 0)
    return rows


def demangle(name: str) -> str:
    """A kernel's C++ name (``c++filt``), or ``name`` as it is."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return name
    return out.replace("(anonymous namespace)::", "") or name


def sass_per_sample(nvcc: str, flags, csrc: str, out_dir: str) -> dict:
    """SASS instructions a valid sample issues, per march flavour: the
    ``probe_<name>`` kernels of ``csrc/sample_probe.cu`` (one
    ``march.cuh::ray_step``) minus their
    ``probe_base_<name>`` twins, counting each kernel's instructions up to
    its last EXIT (NOPs left out; a division's out-of-line slow path,
    reached by CALL, is not counted).  Returns {name: (count, CALLs)}."""
    import re

    cubin = os.path.join(out_dir, "sample_probe.cubin")
    flags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin,
                    os.path.join(csrc, "sample_probe.cu")],
                   check=True, capture_output=True, text=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", chunk)
        last = max(i for i, op in enumerate(ops) if op.split()[-1] == "EXIT"
                   or op.strip() == "EXIT")
        body = [op for op in ops[:last + 1] if not op.strip().startswith("NOP")]
        counts[name] = (len(body), sum("CALL" in op for op in body))
    return {name[len("probe_"):]: (n - counts["probe_base_" + name[6:]][0], calls)
            for name, (n, calls) in counts.items()
            if name.startswith("probe_") and not name.startswith("probe_base_")}


def band_bytes(torch, bricks, bounds, dims, max_slices, cell_bytes=4) -> int:
    """Bytes of the distinct (piece, slice) pairs the items' slice bands
    touch, 1024 cells of ``cell_bytes`` each: the volume a march must read
    at least once."""
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
    return int(touched.sum()) * 1024 * cell_bytes


if __name__ == "__main__":
    sys.exit(main())
