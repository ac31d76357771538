#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's six CUDA kernel libraries (tile-march, slice-march,
composite with its tile, pixel and runs modes, the raymarch oracle's
march, the differentiable path's march with its pair list, forward,
tangent and backward kernels, and ``numerics.fma``'s once-rounding
multiply-add) from the checkout's sources, all at once, holds each against
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
and two from NumPy arrays against the plain path on the CPU (the tables
and the 128^2 frame after each step); orbits through
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

Then the persistent multi-device renderer (phases 21-23,
``parallel/persistent.py``): the golden rows ``persistent-8dev-*`` over 8
shards of the card; ``MultiChipSceneRenderer`` at 1024^2 over 8 shards on
the 3-level scene (stack mode) and the 512-brick plotfile (64 pieces a
shard: scan mode), in both transports, with every kernel-4, runs-mode and
pixel-mode launch of a frame held against its plain version at max |diff|
0, the pre-blend forced on against off, scan against stack mode and
``render_batch`` against ``render`` over an 8-camera orbit, bit for bit;
``render(plotfile, devices=8, orbit_frames=4)`` (the slice's counted run)
and the CLI's ``--devices 8 --orbit-frames 8`` against the in-process
frames; then the runs mode's time per launch against its byte bound and
against one pixel-mode launch per run, the persistent frame's wall split
beside the one-shot call, and the pre-blend step against the plain step
on the 3-level scene and a 64-brick Morton column, from which it fits the
cost model's ratio ``preblend_link_ratio``.

Then in-situ ingestion, histograms and the raymarch oracle (phases 24-26):
the 256^3 field of phase 4 as 512 CUDA tensors through
``device_scene.prepare_device_amr`` and the 3-level scene through
``prepare_device_scene`` (nearest and trilinear), each against the same
call on the CPU (canonical table, statistics and scalar range bit for bit,
the frame bit for bit at 96^2), every tile-march launch of the ingested
frames replayed against its plain version; ``device_histogram`` of the 512
tensors against the CPU tensor route and ``compute_histogram(plotfile)``
against the same bricks binned on the card, exactly; the golden row
``raymarch-1dev`` through ``api.render(render_method="raymarch")``; the
3-level scene's raymarch frame at 1024^2 against the CPU's, bit for bit;
the 512-brick plotfile at 1024^2 through ``render(plotfile,
render_method="raymarch")`` (the counted run of the raymarch path: one
march kernel launch, one fold) and the CLI, with the PNGs equal to each
other and to the frame, the wall split into march (bucket build, upload,
stack allocation, set-up and classification, kernel), fold and readback, the peak
memory, the march kernel timed on its own launch against its bound, and
the 512-layer pixel-mode fold replayed against its plain version and
timed against its byte bound; and ``render_and_composite_sharded`` over 8
shards of the card in both transports against the one-device layers
folded in the same order, every fold launch replayed.  Every march of
these frames (``ops.raymarch.render_bucket_into``, one kernel launch a
bucket or shard) is replayed into fresh rows against the plain version
on the card at max |diff| 0.

Then the differentiable path (phase 27, ``amrvolumerenderer_torch.diff``:
the ray set-up in PyTorch, the march one autograd node whose forward,
backward and tangent are the kernels of ``ops/csrc/diffmarch.cu``): the
6^3 scene of tests/test_diff.py and the golden r^2 scene on the card
against the CPU (the image at 2e-6 with the same non-finite depth
pattern; gradients with respect to data and LUT at 1e-4 of the largest,
with respect to eye, basis and field of view at 1e-4 of the sum of their
terms' magnitudes), and on each scene's march the three kernels against
their plain versions on the card and on the CPU (forward max |diff| 0,
backward under each ``needs`` of data and LUT gradients and tangent at
1e-4 of their scale), also on a contention scene (one brick of 2^3 cells
whose every sample falls into one LUT bin); bench.py's 3-level scene
through ``diff.prepare_geometry`` (13 bricks padded to 64^3, 224 steps),
the forward at 1024^2 under ``no_grad`` and ``loss.backward()`` with
respect to data and LUT at 512^2 with ``remat=True``, each timed with its
peak memory, with the launch counts read around each call (one forward
launch after one launch of the pair list, and one backward launch over
that list with the gradient, one fold forward and, with the gradient,
one fold backward launch, 17 ``numerics.fma`` launches, no other
kernel), each march launch held once against its plain version, every
fma launch of a checked rerun of each call held as it returns against
``fma_reference`` at max |diff| 0, every fold launch of those reruns
likewise against its plain version (the forward without its kept outputs
at 1024^2, with them and the backward at 512^2), and the kernels timed
against their bounds, the backward
also by the gradients it forms (both, no LUT, no data, neither), the
forward with every pair a miss (its floor) and the pair list alone
against its byte bound; the differentiable fold's two kernels at 512^2
and 8 layers against their plain versions and the eager loop they
replace (bit for bit), timed against their byte bounds and beside that
loop; and both fitting examples with their defaults on
the card, run together, each replaying its step as a CUDA graph (the loss
must fall below half its first value, and each example must reach its own
goal).

Then the several-process launch and the repaired one-shot tile-march route
(phase 28): ``renderer_fast.render_composited_tilemarch`` (the JAX
package's route on the slice-march prep) on the 3-level scene at 1024^2
with the visibility graph on and off, against the same route on the CPU,
its one kernel-1 launch replayed against the plain version; then the CLI
path in two processes on this one card (the JAX package's launch
variables, a free localhost port, gloo through pinned host memory) over 8
shards at 1024^2, one-shot in float32 and ubyte transport and a 4-frame
orbit of the persistent renderer: rank 0's images byte-identical to a
one-process run's, rank 1 saving nothing, kernel 4 and the pixel or runs
mode launched on both ranks, each rank's wall time beside one process's.

Then the differentiable path over a sharded brick axis and the two
benchmark examples (phase 29): ``diff.render_image_diff(mesh=
make_mesh(8, "cuda"))`` on tests/test_diff.py's 8 bricks of 4^3 and the
same bricks seen obliquely, at 8x8, against the single call on the card
and the 8-shard CPU mesh (frames equal, the data gradient at rtol 1e-6 of
the card's single call); bench_orbit's field at ``--domain 64`` as 8
bricks of 32^3 at 512^2, forward and ``backward()`` with ``remat=True``
with respect to data, LUT and eye, as one call and over 8 shards of one
process, each timed with its peak memory, one forward and one backward
launch of the march a call or a shard and no other kernel (each forward
launch held against its plain version), and the eye's forward-mode terms
through the tangent kernel (three launches, each held against its plain
version at 1e-4 of its scale, the first timed against its bound); the same over two
processes on this card (gloo through pinned host memory), 4 shards each
(four forward and four backward launches a rank), each rank's rows of
the data gradient against the one-process gradient and the eye and LUT
gradients equal on both ranks;
and ``examples/bench_scaling_torch.py`` and ``examples/bench_orbit_torch.py``
(per frame and ``--batch``) with their defaults, each launching kernel 1,
and kernel 1 on their own inputs (bench_scaling's 64-brick tables at
1024^2, bench_orbit's first frame at 2048^2 AA=4 and a 2-frame batched
chunk) against its plain version at max |diff| 0.

Phase 1 also logs each kernel instantiation's registers, shared memory and
spills (and fails on a spill), the diff march's stack frames and SASS
atomics by opcode (``cuobjdump -sass``), and counts the SASS instructions of one
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

    python3 chip_smoke.py --diff-march [--tree DIR] [--check] [--steps]
        [--graph-repeats N] [--two-process N]

times only the diff march's kernels (``ops/csrc/diffmarch.cu``), and the
fold's where the tree has them, of the
package in ``--tree`` (default: this checkout) on phase 27's inputs, with
this file's helpers (``diff_march_main``).  Run it once a tree,
alternating (parent, change, change, parent), to compare two trees on one
card.
"""

from __future__ import annotations

import contextlib
import json
import os
import runpy
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
# float32 operations per valid sample of raymarch.cu's loop, counted by hand
# (an FMA counts 2, a compare 1): both distances, the tested and the sampled
# position, the box test, the cell index (subtract, divide, floor, clamp)
# and the fold
RAY_SAMPLE_FLOPS = 48
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


def three_level_levels():
    """bench.py:70-93: 64^3 base, 2x refinement over the central half and
    another over the central quarter: (levels, level geometries, ratios)."""
    from amrvolumerenderer_torch.api import LevelBox, LevelGeometry

    n = 64
    levels = [
        [LevelBox(radial_field(n, 0.0, 1.0), np.zeros(3, dtype=int))],
        [LevelBox(radial_field(n, 0.25, 0.75), np.full(3, 32, dtype=int))],
        [LevelBox(radial_field(n, 0.375, 0.625), np.full(3, 96, dtype=int))],
    ]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / (s * n))) for s in (1, 2, 4)]
    return levels, geoms, [(2, 2, 2), (2, 2, 2)]


def three_level_geometry():
    """bench.py's 3-level scene through the port's ingestion."""
    from amrvolumerenderer_torch import api

    levels, geoms, ratios = three_level_levels()
    data = api.AmrData(level_data=levels, level_geometry=geoms,
                       refinement_ratios=ratios)
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


def event_ms(torch, fn) -> float:
    """Device ms of ``fn``'s launches by CUDA events, a ~10 ms spin kernel
    queued first so the host's work stays outside the window."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


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
    from amrvolumerenderer_torch.ops import diffmarch as dmk
    from amrvolumerenderer_torch.ops import numerics as nm
    from amrvolumerenderer_torch.ops import raymarch as rm
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
    libraries = ("tilemarch", "slicemarch", "composite", "raymarch", "diffmarch",
                 "numerics")
    counters = {"tilemarch": tm.tilemarch_render,
                "slicemarch": sm.slicemarch_render_worklist_raw,
                "composite": comp.composite_tiles,  # tile mode
                "composite_pixels": comp.composite_pixels}  # the sharded folds
    batch_fn = tm.tilemarch_render_batch  # its launches count both batch entries
    dense_fn = sm.slicemarch_render  # kernel 4, in the slicemarch library
    runs_fn = comp.composite_runs  # the run pre-blend, in the composite library
    ray_fn = rm.render_bucket_into  # the raymarch oracle's march
    # the differentiable path's march: forward, backward and tangent
    diff_fns = {"diffmarch_forward": dmk.diffmarch_forward,
                "diffmarch_backward": dmk.diffmarch_backward,
                "diffmarch_tangent": dmk.diffmarch_tangent,
                "diffmarch_pairs": dmk.diffmarch_pairs,  # the kernels' pair list
                # the differentiable fold (a forward and a backward launch a call)
                "fold_diff_forward": comp.fold_diff_forward,
                "fold_diff_backward": comp.fold_diff_backward,
                # the pair path: a view's pair build, the pair fold
                "diffpairs_build": dmk.diffpairs_build,
                "diffpairs_fold_forward": comp.diffpairs_fold_forward,
                "diffpairs_fold_backward": comp.diffpairs_fold_backward}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        batch_fn.launches = 0
        dense_fn.launches = 0
        runs_fn.launches = 0
        ray_fn.launches = 0
        for fn in diff_fns.values():
            fn.launches = 0
        nm.fma.launches = 0

    def diff_counts():
        return {name: fn.launches for name, fn in diff_fns.items()}

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

    def all_counts():
        return {**counts(), "tilemarch_batch": batch_fn.launches,
                "slicemarch_dense": dense_fn.launches, "composite_runs": runs_fn.launches,
                "raymarch": ray_fn.launches}

    # ---- phase 1: build the six libraries, one nvcc each, in parallel -----
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
    # the diff march's stack frames and its atomics, by opcode
    for line in ptxas_lines(_build.build_log.get("diffmarch", "")):
        log(f"phase 1: ptxas diffmarch: {line}")
    atomics = sass_atomics(_build._nvcc(), _build.NVCC_FLAGS, _build._CSRC, "diffmarch",
                           SCRATCH)
    log("phase 1: SASS atomics of ops/csrc/diffmarch.cu (cuobjdump -sass): "
        + "; ".join(f"{k}: {v}" for k, v in atomics.items()))
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
    library_ms = {}  # one PyTorch call that computes a kernel's function, where there is one
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
    # at 128^2: the CPU's frames at 512^2 took 110-150 s each on the host of
    # an H100 machine with the once-rounding plain FMA
    upd = {"cuda": FastSceneRenderer(geometry, RenderParameters(width=128, height=128),
                                     device=dev)}
    upd["cpu"] = FastSceneRenderer(geometry, RenderParameters(width=128, height=128),
                                   device="cpu")
    ucam = auto_orbit_camera(upd["cuda"].bounds)
    base = [torch.from_numpy(np.asarray(b.data, np.float32)).to(dev)
            for b in geometry.bricks]
    for kind in ("tensor", "numpy"):
        for step in range(1, 3):  # the CPU render of each step dominates the phase
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
        frame = ds.paste_tiles(ds.paste_rect(ds.gather_frame(mesh, out).cpu().numpy(), rect,
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

    # ---- phases 21-23: the persistent multi-device renderer -----------------
    from amrvolumerenderer_torch.parallel import persistent as pp
    from amrvolumerenderer_torch.parallel.persistent import MultiChipSceneRenderer

    def dense_plain(*args, **kw):
        return sm.untile(*sm.slicemarch_dense_reference(*args, **kw), kw["width"],
                         kw["height"])

    @contextlib.contextmanager
    def patched(holder, attr, **fns):
        """Replace functions of module ``holder.<attr>`` inside the block."""
        module = getattr(holder, attr)

        class Proxy:
            def __getattr__(self, name):
                return getattr(module, name)

        proxy = Proxy()
        for name, fn in fns.items():
            setattr(proxy, name, fn)
        setattr(holder, attr, proxy)
        try:
            yield
        finally:
            setattr(holder, attr, module)

    def same_inputs(a, b) -> bool:
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                    and a.shape == b.shape and a.dtype == b.dtype
                    and bool(torch.equal(a, b)))
        if isinstance(a, (tuple, list)):
            return (isinstance(b, (tuple, list)) and len(a) == len(b)
                    and all(same_inputs(x, y) for x, y in zip(a, b)))
        if isinstance(a, dict):
            return (isinstance(b, dict) and a.keys() == b.keys()
                    and all(same_inputs(a[k], b[k]) for k in a))
        return a == b

    @contextlib.contextmanager
    def checked_launches(label, memo=None):
        """Hold every kernel-4, runs-mode and pixel-mode launch of the
        persistent renderer inside the block against its plain version on
        the same inputs, right after the launch (a run buffer the launch
        writes in place is copied first), at max |diff| 0.  The plain
        versions count no launch.  With ``memo`` (a list kept across
        blocks) a kernel-4 launch whose inputs equal those of a launch held
        before reuses that launch's plain output.  Yields {name: launches
        held}."""
        held = {"slicemarch_dense": 0, "composite_runs": 0, "composite_pixels": 0}
        diffs = {name: [] for name in held}
        reused = [0]

        def memo_plain(*args, **kw):
            for m_args, m_kw, m_out in memo:
                if same_inputs(m_kw, kw) and same_inputs(m_args, args):
                    reused[0] += 1
                    return m_out
            out = dense_plain(*args, **kw)
            memo.append((args, kw, out))
            return out

        def diff(got, ref):
            """max_diff on the card: (same non-finite pattern, max |diff|)."""
            fin = torch.isfinite(ref)
            same = bool(torch.equal(torch.isfinite(got), fin))
            return same, float(torch.where(fin, (got - ref).abs(),
                                           torch.zeros_like(ref)).max())

        def wrap(name, fn, plain, in_place=False):
            def call(*args, **kw):
                before = kw.get("out")
                before = before.clone() if in_place and before is not None else None
                got = fn(*args, **kw)
                ref = plain(*args, **(dict(kw, out=before) if in_place else kw))
                for k, p in (zip(got, ref) if isinstance(got, tuple) else [(got, ref)]):
                    diffs[name].append(diff(k, p))
                held[name] += 1
                return got
            return call

        runs = wrap("composite_runs", runs_fn, comp.composite_runs_reference, True)
        with patched(pp, "sm", slicemarch_render=wrap(
                "slicemarch_dense", dense_fn,
                dense_plain if memo is None else memo_plain)), \
                patched(pp, "comp", composite_runs=runs), \
                patched(ds, "comp", composite_runs=runs, composite_pixels=wrap(
                    "composite_pixels", comp.composite_pixels,
                    comp.composite_pixels_reference)):
            yield held
        torch.cuda.synchronize()
        for name, found in diffs.items():
            if found:
                worst[name] = max(worst.get(name, 0.0), max(d for _, d in found))
        log(f"{label}: launches held against the plain version: " + ", ".join(
            f"{name} {held[name]} (max |diff| "
            f"{max((d for _, d in diffs[name]), default=0.0):.3g}, non-finite "
            f"pattern same {all(s for s, _ in diffs[name])})" for name in held)
            + (f"; {reused[0]} kernel-4 launches on inputs equal to an earlier "
               "launch's, held against its plain output" if reused[0] else ""))
        assert all(s and d == 0.0 for v in diffs.values() for s, d in v), label

    def persistent_counts():
        got = counts()
        return {"slicemarch_dense": dense_fn.launches,
                "composite_runs": runs_fn.launches,
                "composite_pixels": got.pop("composite_pixels"), "other": got}

    # phase 21: the golden rows persistent-8dev-* on the card
    for row, force in (("persistent-8dev-preblend", True),
                       ("persistent-8dev-plain", False)):
        r = MultiChipSceneRenderer(r2_geometry, RenderParameters(width=48, height=48),
                                   num_devices=8, device=dev)
        r._use_preblend = lambda rmax, _f=force: _f
        reset_counts()
        with checked_launches(f"phase 21: {row}"):
            frame = r.render(auto_orbit_camera(r.bounds), overlay=False)
        got = persistent_counts()
        same, diff = max_diff(frame, golden[row])
        log(f"phase 21: MultiChipSceneRenderer(devices=8) vs {row}: non-finite "
            f"pattern same {same}, max |diff| {diff:.3g}; launches {got}")
        assert same and diff == 0.0, row
        assert got == {"slicemarch_dense": 8, "composite_runs": 8 if force else 0,
                       "composite_pixels": 8, "other": {
                           "tilemarch": 0, "slicemarch": 0, "composite": 0}}, got

    # phase 22: full width over 8 shards of the card, both transports: the
    # 3-level scene (2 pieces a shard: stack mode) and the 512-brick
    # plotfile (64 pieces a shard: scan mode)
    p22 = RenderParameters(width=1024, height=1024)
    for label, geom in (("3-level", geometry3), ("512-brick plotfile", geometry)):
        # both transports give kernel 4 the same inputs: the plain march of
        # the first is reused for the second (same_inputs checks each)
        memo = []
        cam = auto_orbit_camera(compute_global_bounds(geom), p22.camera_seed,
                                p22.camera_up)
        orbit = orbit_camera_sequence(cam, 8, 360.0)
        for transport in ("float32", "ubyte"):
            tag = f"phase 22: {label} 1024x1024, {transport}"
            r = MultiChipSceneRenderer(geom, p22, num_devices=8, transport=transport,
                                       device=dev)
            scan = r._scan_pieces()
            lmax = len(r._slot_to_idx) // 8
            chunks = -(-lmax // r.scan_piece_threshold) if scan else 1
            reset_counts()
            t0 = time.perf_counter()
            with checked_launches(tag, memo):
                frame = r.render(cam, overlay=False)
            wall = time.perf_counter() - t0
            got = persistent_counts()
            covered = float((frame[:, 3] > 0).mean())
            log(f"{tag}: {lmax} pieces a shard, scan mode {scan}, render() "
                f"{wall:.3f} s with every launch held; launches {got}; alpha > 0 "
                f"on {covered:.4f}")
            pre = scan or transport == "ubyte"
            assert got == {"slicemarch_dense": 8 * chunks,
                           "composite_runs": 8 * chunks if pre else 0,
                           "composite_pixels": 8, "other": {
                               "tilemarch": 0, "slicemarch": 0, "composite": 0}}, got
            assert np.isfinite(frame[:, :4]).all()
            assert ALPHA_FRACTION[0] <= covered <= ALPHA_FRACTION[1], covered
            # the same frame from the other mode and, in float32, with the
            # pre-blend forced on and off
            variants = {}
            r.scan_piece_threshold = 10 ** 9  # stack mode
            if transport == "float32":
                for force in (True, False):
                    r._use_preblend = lambda rmax, _f=force: _f
                    variants[f"stack, pre-blend forced {'on' if force else 'off'}"] = \
                        r.render(cam, overlay=False)
                del r._use_preblend
            elif scan:
                variants["stack"] = r.render(cam, overlay=False)
            if not scan:
                r.scan_piece_threshold = 1
                variants["scan, one piece a chunk"] = r.render(cam, overlay=False)
            r.scan_piece_threshold = 16
            for name, v in variants.items():
                assert np.array_equal(v, frame), (tag, name)
            log(f"{tag}: equal bit for bit to the default frame: "
                + ", ".join(variants))
            del variants
            t0 = time.perf_counter()
            batch = r.render_batch(orbit, overlay=False)
            wall = time.perf_counter() - t0
            stats = r.last_batch_stats
            for i, c in enumerate(orbit):
                assert np.array_equal(batch[i], r.render(c, overlay=False)), (tag, i)
            log(f"{tag}: render_batch(8-camera orbit) == render bit for bit; "
                f"{wall:.3f} s, {stats['dispatch_count']} chunks")
            del r, batch
        del memo

    # the orbit entry points over 8 shards: render(plotfile, devices=8,
    # orbit_frames=4) is this slice's counted run
    reset_counts()
    t0 = time.perf_counter()
    rc = amrvolumerenderer_torch.render(
        plotfile, width=1024, height=1024, devices=8, orbit_frames=4,
        output=os.path.join(SCRATCH, "api_orbit8.png"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = persistent_counts()
    launches["composite_runs"] = got["composite_runs"]
    log(f"phase 22: render(plotfile, devices=8, orbit_frames=4) at 1024^2: rc {rc}, "
        f"{wall:.3f} s wall (scene build included), launches {got}")
    assert rc == 0 and got["other"] == {"tilemarch": 0, "slicemarch": 0,
                                        "composite": 0}
    assert min(got["slicemarch_dense"], got["composite_runs"],
               got["composite_pixels"]) > 0, got
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "amrvolumerenderer_torch.driver", "--width", "1024",
         "--height", "1024", "--devices", "8", "--orbit-frames", "8", "--output",
         os.path.join(SCRATCH, "cli_orbit8.png"), plotfile],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    log(f"phase 22: CLI --devices 8 --orbit-frames 8 rc {cli.returncode} in "
        f"{time.perf_counter() - t0:.3f} s")
    assert cli.returncode == 0, cli.stderr[-4000:]
    base = auto_orbit_camera(compute_global_bounds(geometry), p22.camera_seed,
                             p22.camera_up)
    r = MultiChipSceneRenderer(geometry, p22, num_devices=8, device=dev)
    for count, stem in ((4, "api_orbit8"), (8, "cli_orbit8")):
        frames = r.render_batch(orbit_camera_sequence(base, count, 360.0))
        for i in range(count):
            png = read_png_rgb(os.path.join(SCRATCH, f"{stem}_{i:04d}.png"))
            assert np.array_equal(png, png_bytes(frames[i])), (stem, i)
    log("phase 22: every frame of render(orbit_frames=4) and of the CLI's orbit "
        "equals the in-process render_batch frame")
    del r, frames

    # phase 23: timing.  (a) The runs mode per launch against its byte bound
    # (each of its L layers read once, its rmax slots written once), and the
    # route of one pixel-mode launch per run, on the 3-level scene
    log(f"phase 23: {smi}")
    r = MultiChipSceneRenderer(geometry3, p22, num_devices=8, device=dev)
    r._use_preblend = lambda rmax: True
    with recorded(ds, "comp", "composite_runs") as rec:
        frame = r.render(cams[0], overlay=False)
    torch.cuda.synchronize()
    rows = []
    for args, kw in rec:
        layers, order, slots, rmax = args
        n_l, n_p = layers.shape[:2]
        runs_fn(*args, **kw)  # warm-up
        ms = min(event_ms(lambda: runs_fn(*args, **kw)) for _ in range(3))
        plain = event_ms(lambda: comp.composite_runs_reference(*args, **kw))
        # one pixel-mode launch per run, its steps' layers one group
        slots_h = slots.cpu().numpy()
        groups = [(s, order[torch.from_numpy(np.flatnonzero(slots_h == s)).to(dev)])
                  for s in range(rmax)]
        groups = [(s, o, torch.zeros(len(o), dtype=torch.int32, device=dev))
                  for s, o in groups if len(o)]

        def per_run(layers=layers, groups=groups, rmax=rmax, n_p=n_p):
            out = torch.zeros((rmax, n_p, 5), dtype=torch.float32, device=dev)
            out[..., 4] = float("inf")
            for s, o, w in groups:
                out[s] = comp.composite_pixels(layers, o, w)
            return out

        assert torch.equal(per_run(), runs_fn(*args, **kw))
        alt = min(event_ms(per_run) for _ in range(3))
        rows.append((n_l, n_p, rmax, ms, plain, alt, (n_l + rmax) * n_p * 20,
                     n_l * n_p * BLEND_FLOPS))
    times["composite_runs"] = (sum(x[3] for x in rows), sum(x[4] for x in rows))
    bounds_ms["composite_runs"] = bound(sum(x[6] for x in rows),
                                        sum(x[7] for x in rows))
    log(f"phase 23: {smi}: runs mode, 3-level 1024x1024 over 8 shards (pre-blend "
        "forced on), each launch timed alone (layers x pixels, rmax: kernel ms, "
        "plain ms, one pixel-mode launch per run ms, byte bound ms, share of the "
        "bound): " + "; ".join(
            f"{n_l}x{n_p}, {rmax}: {ms:.4f}, {plain:.4f}, {alt:.4f}, "
            f"{bound(nb, nf)[0]:.5f}, {bound(nb, nf)[0] / ms:.3f}"
            for n_l, n_p, rmax, ms, plain, alt, nb, nf in rows))
    log(f"phase 23: runs mode per D=8 frame: {len(rows)} launches, "
        f"{times['composite_runs'][0]:.4f} ms (one pixel-mode launch per run "
        f"{sum(x[5] for x in rows):.4f} ms), bound "
        f"{bounds_ms['composite_runs'][0]:.5f} ms ({bounds_ms['composite_runs'][1]}), "
        f"kernel at {bounds_ms['composite_runs'][0] / times['composite_runs'][0]:.4f} "
        "of its bound")
    del rec

    # (b) the persistent frame's host wall split, beside the one-shot call
    def persistent_split(r, camera, preblend):
        """Host wall of one frame, synchronised after each stage: prep (host
        state, run plan, per-frame uploads), render (kernel 4 + layer
        clear), pre-blend, exchange, fold, readback (gather, crop, copy)."""
        sync = torch.cuda.synchronize
        t = [time.perf_counter()]
        axis, cam, slot_hints, slot_valid = r._frame_state(camera)
        plan = (ds.preblend_plan(r._effective_hints(slot_hints, slot_valid))
                if preblend else None)
        hints = np.where(slot_valid, slot_hints, np.float32(np.inf))
        shards = r._shard_inputs(axis, cam, slot_valid, hints)
        sync(); t.append(time.perf_counter())
        layers, lh = r._render_layers(shards)
        sync(); t.append(time.perf_counter())
        if plan is not None:
            lo, rs, perm, rmax = plan
            layers = [ds._preblend_runs(layers[i], lo[i], rs[i], rmax)
                      for i in range(r.num_devices)]
        sync(); t.append(time.perf_counter())
        received = ds._exchange(r.mesh, layers, r.transport)
        gathered = None if plan is not None else ds.all_gather(r.mesh, lh)
        sync(); t.append(time.perf_counter())
        out = (ds._fold_runs(r.mesh, received, perm) if plan is not None
               else ds._fold_layers(r.mesh, received, gathered))
        sync(); t.append(time.perf_counter())
        frame = r._assemble_shards(out).cpu().numpy()
        t.append(time.perf_counter())
        return np.diff(t) * 1e3, frame

    stages = ("prep", "render", "pre-blend", "exchange", "fold", "readback")
    for preblend in (False, True):
        r = MultiChipSceneRenderer(geometry3, p22, num_devices=8, device=dev)
        r._use_preblend = lambda rmax, _f=preblend: _f
        _, frame = persistent_split(r, cams[0], preblend)  # warm-up
        assert np.array_equal(frame, r.render(cams[0], overlay=False))
        split = np.mean([persistent_split(r, c, preblend)[0] for c in cams], axis=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in cams:
            r.render(c, overlay=False)
        total = (time.perf_counter() - t0) * 1e3 / len(cams)
        r.render_batch(cams, overlay=False, bytes_out=True)  # warm-up
        t0 = time.perf_counter()
        r.render_batch(cams, overlay=False, bytes_out=True)
        batch = (time.perf_counter() - t0) * 1e3 / len(cams)
        st = r.last_batch_stats
        log(f"phase 23: {smi}: persistent render D=8 "
            f"{'pre-blend' if preblend else 'plain'}, 3-level 1024x1024, host wall "
            "per frame (8 orbit cameras): " + ", ".join(
                f"{s} {v:.3f} ms" for s, v in zip(stages, split))
            + f"; sum {split.sum():.3f} ms; render() {total:.3f} ms; "
            f"render_batch(bytes_out=True) {batch:.3f} ms/frame (host prep "
            f"{st['host_prep_ms'] / 8:.3f}, dispatch {st['dispatch_ms'] / 8:.3f}, "
            f"readback {st['readback_ms'] / 8:.3f} ms/frame, "
            f"{st['dispatch_count']} chunks)")
        del r
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in cams:
        rf.render_composited_sharded(geometry3, p22, c, srange3, rsd3, 1024, 1024,
                                     None, 8, pipeline="layered", device=dev)
    layered = (time.perf_counter() - t0) * 1e3 / len(cams)
    t0 = time.perf_counter()
    for c in cams:
        rf.render_composited_sharded(geometry3, p22, c, srange3, rsd3, 1024, 1024,
                                     None, 8, pipeline="depth", device=dev)
    depth = (time.perf_counter() - t0) * 1e3 / len(cams)
    log(f"phase 23: {smi}: beside it, the one-shot render_composited_sharded D=8 "
        f"in the same call: layered {layered:.3f} ms, depth {depth:.3f} ms per frame")

    # (c) the pre-blend step against the plain step, device time (render,
    # pre-blend, exchange and fold; inputs uploaded first), on the 3-level
    # scene and the 64-brick Morton column, in alternating turns.  Their
    # differences give the cost model's ratio R (_use_preblend):
    # t_plain - t_pre = (lmax - rmax) c_x - (lmax + rmax) c_f, R = c_x / c_f
    b, nb = 8, 64
    cx = (np.arange(nb * b) + 0.5) / (nb * b)
    cy = (np.arange(b) + 0.5) / b
    fcol = np.exp(-((cx[:, None, None] - 0.5) ** 2 + (cy[None, :, None] - 0.5) ** 2
                    + (cy[None, None, :] - 0.5) ** 2) / 0.05)
    column = api.load_amr_geometry(api.AmrData(
        level_data=[[LevelBox(fcol[i * b:(i + 1) * b], np.array([i * b, 0, 0]))
                     for i in range(nb)]],
        level_geometry=[LevelGeometry(np.zeros(3), np.array(
            [1.0 / (nb * b), 1.0 / b, 1.0 / b]))]), 0, -1, 0, False, True,
        verbose=False)
    fits = []
    for label, geom in (("3-level", geometry3), ("Morton column", column)):
        r = MultiChipSceneRenderer(geom, p22, num_devices=8, device=dev)
        cam = auto_orbit_camera(r.bounds)
        axis, cpack, slot_hints, slot_valid = r._frame_state(cam)
        lo, rs, perm, rmax = ds.preblend_plan(r._effective_hints(slot_hints, slot_valid))
        hints = np.where(slot_valid, slot_hints, np.float32(np.inf))
        shards = r._shard_inputs(axis, cpack, slot_valid, hints)
        lo_t, rs_t, perm_t = (torch.from_numpy(a).to(dev) for a in (lo, rs, perm))
        lmax = len(r._slot_to_idx) // 8

        def step_pre():
            layers, _ = r._render_layers(shards)
            return ds._compose_shards_preblend(r.mesh, layers, lo_t, rs_t, perm_t, rmax)

        def step_plain():
            return ds._compose_shards(r.mesh, *r._render_layers(shards))

        a, c_ = step_pre(), step_plain()
        assert all(torch.equal(x, y) for x, y in zip(a, c_)), label
        t_pre, t_plain = [], []
        for first, second in ((step_plain, step_pre), (step_pre, step_plain)) * 3:
            for fn in (first, second):
                (t_pre if fn is step_pre else t_plain).append(event_ms(fn))
        depth = int((rs.max(axis=1) + 1).max())  # the deepest shard's runs
        fits.append((lmax, rmax, min(t_plain), min(t_pre)))
        default_ratio = r.preblend_link_ratio
        log(f"phase 23: {smi}: D=8 step, {label} 1024x1024 ({lmax} layers a shard, "
            f"run depth {depth}, rmax {rmax}): plain {min(t_plain):.4f} ms (runs "
            f"{', '.join(f'{v:.4f}' for v in t_plain)}), pre-blend {min(t_pre):.4f} "
            f"ms (runs {', '.join(f'{v:.4f}' for v in t_pre)}); the cost model "
            + (f"pre-blends iff R > {(lmax + rmax) / (lmax - rmax):.3f}"
               if lmax > rmax else "never pre-blends (rmax >= lmax)"))
        del r, shards
    (l1, r1, p1, q1), (l2, r2_, p2, q2) = fits
    det = (l1 - r1) * -(l2 + r2_) - (l2 - r2_) * -(l1 + r1)
    c_x = ((p1 - q1) * -(l2 + r2_) - (p2 - q2) * -(l1 + r1)) / det if det else float("nan")
    c_f = ((l1 - r1) * (p2 - q2) - (l2 - r2_) * (p1 - q1)) / det if det else float("nan")
    log(f"phase 23: {smi}: fitted per-layer costs c_x {c_x:.6f} ms (exchange and "
        f"final fold), c_f {c_f:.6f} ms (local fold): R = c_x / c_f = "
        f"{c_x / c_f if c_f else float('nan'):.4f}; the default "
        f"preblend_link_ratio is {default_ratio}")

    # ---- phases 24-26: ingestion, histograms and the raymarch oracle --------
    from amrvolumerenderer_torch import device_scene as dsc
    from amrvolumerenderer_torch import renderer as rnd
    from amrvolumerenderer_torch.camera import compute_box_depth_hint
    from amrvolumerenderer_torch.colormap import build_color_table
    from amrvolumerenderer_torch.image import ImageBuffer, ImageKind
    from amrvolumerenderer_torch.scene import assign_owners, build_brick_buckets

    cpu = torch.device("cpu")
    side, bs = field.shape[0], 32  # phase 4's field and brick edge
    n_bricks, full, small = (side // bs) ** 3, 1024, 96
    per_shard = n_bricks // 8

    def synced_ms(fn):
        """Host wall ms of ``fn`` ending in a device synchronise, and its
        result."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    # phase 24: the 256^3 field of phase 4 as 512 tensors on the card,
    # ingested by prepare_device_amr; the 3-level scene by
    # prepare_device_scene; each against the same call on the CPU
    geom_field = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / side))]

    def field_tensors(where):
        return [[(torch.from_numpy(np.ascontiguousarray(
            field[i:i + bs, j:j + bs, k:k + bs])).to(where), np.array([i, j, k]))
            for i in range(0, side, bs) for j in range(0, side, bs)
            for k in range(0, side, bs)]]

    p24 = RenderParameters(width=full, height=full)
    on_card, on_cpu = field_tensors(dev), field_tensors(cpu)
    ingest_ms, r24 = synced_ms(lambda: dsc.prepare_device_amr(
        on_card, geom_field, parameters=p24, device=dev))
    r24_cpu = dsc.prepare_device_amr(on_cpu, geom_field, parameters=p24, device=cpu)
    card_bricks = [t for t, _ in on_card[0]]
    stats_ms, stats = synced_ms(lambda: dsc.device_scalar_stats(card_bricks))
    same_table = torch.equal(r24.canonical.cpu(), r24_cpu.canonical)
    log(f"phase 24: {smi}: prepare_device_amr of {n_bricks} CUDA tensors ({side}^3): "
        f"{ingest_ms:.3f} ms (statistics alone {stats_ms:.3f} ms); canonical "
        f"{tuple(r24.canonical.shape)} equal to the CPU call's {same_table}, "
        f"stats {stats}, scalar range {r24.scalar_range}")
    assert same_table and r24.canonical.device == dev
    assert stats == dsc.device_scalar_stats([t for t, _ in on_cpu[0]])
    for name in ("original_scalar_range", "processed_scalar_range", "scalar_range"):
        assert getattr(r24.geometry, name) == getattr(r24_cpu.geometry, name), name
    assert r24.scalar_range == r24_cpu.scalar_range
    np.testing.assert_array_equal(r24.visible, r24_cpu.visible)
    cam24 = auto_orbit_camera(r24.bounds)
    reset_counts()  # counted run: a device-ingested scene's frame
    with recorded(fast_scene, "tm", "tilemarch_render") as tile_rec:
        frame_ms, frame24 = synced_ms(lambda: r24.render(cam24))
    got = counts()
    covered = float((frame24[:, 3] > 0).mean())
    log(f"phase 24: FastSceneRenderer.render of the ingested scene {full}x{full}: "
        f"{frame_ms:.3f} ms wall, launches {got}, alpha > 0 on {covered:.4f}")
    assert got == {"tilemarch": 1, "slicemarch": 0, "composite": 0,
                   "composite_pixels": 0}, got
    assert ALPHA_FRACTION[0] <= covered <= ALPHA_FRACTION[1], covered
    hold_calls("tilemarch", tm.tilemarch_render, tm.tilemarch_reference,
               "phase 24: the ingested frame's tile-march launch replayed",
               tile_rec)
    del tile_rec
    # the frame against the CPU renderer's, at 96^2 (the CPU tile march of
    # 512 pieces at 1024^2 takes minutes)
    p_small = RenderParameters(width=small, height=small)
    s_card = dsc.prepare_device_amr(on_card, geom_field, parameters=p_small, device=dev)
    s_cpu = dsc.prepare_device_amr(on_cpu, geom_field, parameters=p_small, device=cpu)
    same, d = max_diff(s_card.render(cam24), s_cpu.render(cam24))
    log(f"phase 24: {n_bricks}-tensor scene at {small}x{small}, card vs CPU: max |diff| {d:.3g}, "
        f"non-finite pattern same {same}")
    assert same and d == 0.0
    # the 3-level scene through prepare_device_scene, nearest and trilinear
    bricks3 = [(torch.from_numpy(np.ascontiguousarray(b.data, np.float32)),
                b.min_corner, b.max_corner) for b in geometry3.bricks]
    for sampling in ("nearest", "trilinear"):
        params = RenderParameters(width=full, height=full, sampling=sampling)
        ms3, r3 = synced_ms(lambda p=params: dsc.prepare_device_scene(
            [(t.to(dev), lo, hi) for t, lo, hi in bricks3], p, device=dev))
        r3_cpu = dsc.prepare_device_scene(bricks3, params, device=cpu)
        assert torch.equal(r3.canonical.cpu(), r3_cpu.canonical), sampling
        assert r3.scalar_range == r3_cpu.scalar_range
        cam3 = auto_orbit_camera(r3.bounds)
        with recorded(fast_scene, "tm", "tilemarch_render") as tile_rec:
            frame3 = r3.render(cam3)
        hold_calls("tilemarch", tm.tilemarch_render, tm.tilemarch_reference,
                   f"phase 24: prepare_device_scene 3-level {sampling} "
                   f"({r3.canonical.shape[0]} pieces, {ms3:.3f} ms to ingest, "
                   "canonical equal to the CPU call's): tile-march launch replayed",
                   tile_rec)
        small3 = RenderParameters(width=small, height=small, sampling=sampling)
        same, d = max_diff(
            dsc.prepare_device_scene([(t.to(dev), lo, hi) for t, lo, hi in bricks3],
                                     small3, device=dev).render(cam3),
            dsc.prepare_device_scene(bricks3, small3, device=cpu).render(cam3))
        log(f"phase 24: 3-level {sampling} at {small}x{small}, card vs CPU: max |diff| "
            f"{d:.3g}, non-finite pattern same {same}")
        assert same and d == 0.0 and np.isfinite(frame3[:, :4]).all()
        del tile_rec, r3, r3_cpu
    # histograms: the 512 tensors on the card against the CPU tensor route,
    # and the plotfile's (binned on the card by default) against the CPU
    # call's and the card's binning of the same bricks
    t24 = r24.geometry.scalar_transform
    srange24 = r24.geometry.scalar_range
    hist_ms, (counts24, total24) = synced_ms(lambda: dsc.device_histogram(
        card_bricks, t24, 256, srange24))
    cpu_counts, cpu_total = dsc.device_histogram(
        [t for t, _ in on_cpu[0]], t24, 256, srange24)
    log(f"phase 24: {smi}: device_histogram of the {n_bricks} CUDA tensors, 256 bins: "
        f"{hist_ms:.3f} ms, {total24} samples, equal to the CPU tensor route "
        f"{bool(np.array_equal(counts24, cpu_counts))}")
    assert np.array_equal(counts24, cpu_counts) and total24 == cpu_total == side ** 3
    card_ms, hist_dict = synced_ms(
        lambda: amrvolumerenderer_torch.compute_histogram(plotfile, bins=256))
    cpu_ms, cpu_dict = synced_ms(lambda: amrvolumerenderer_torch.compute_histogram(
        plotfile, bins=256, device="cpu"))
    pgeom = load_plotfile_geometry(plotfile, "", 0, -1, False, verbose=False)
    card_counts, card_total = dsc.device_histogram(
        [torch.from_numpy(np.asarray(b.data)).to(dev) for b in pgeom.bricks],
        pgeom.scalar_transform, 256, pgeom.scalar_range)
    log(f"phase 24: {smi}: compute_histogram(plotfile): {card_ms:.3f} ms (default, "
        f"the card), {cpu_ms:.3f} ms with device='cpu', {hist_dict['samples']} "
        f"samples; equal to the CPU call {hist_dict == cpu_dict} and to the "
        f"card's device_histogram {hist_dict['counts'] == card_counts.tolist()}")
    assert hist_dict == cpu_dict and hist_dict["counts"] == card_counts.tolist()
    assert hist_dict["samples"] == card_total == side ** 3
    del on_card, on_cpu, card_bricks, r24, r24_cpu, s_card, s_cpu
    torch.cuda.empty_cache()

    # phase 25: the raymarch oracle.  Every march (``render_bucket_into``:
    # one launch of the march kernel a bucket) is recorded, less the stack
    # it writes into, and replayed into fresh rows against the plain
    # version on the card.
    @contextlib.contextmanager
    def recorded_marches(holder, attr):
        """The arguments of every march ``holder`` makes through
        ``holder.<attr>``, less the stack (which stays free to go)."""
        with recorded(holder, attr, "render_bucket_into") as seen:
            marches = []
            yield marches
        marches += [(args[1:], kw) for args, kw in seen]

    def device_diff(a, b, chunk=16):
        """max_diff on the card, a chunk of rows at a time: (same
        non-finite pattern, max |diff| of the finite entries)."""
        same, worst_d = True, 0.0
        for i in range(0, a.shape[0], chunk):
            x, y = a[i:i + chunk], b[i:i + chunk]
            fx, fy = torch.isfinite(x), torch.isfinite(y)
            same = same and torch.equal(fx, fy)
            both = fx & fy
            if bool(both.any()):
                worst_d = max(worst_d, float((x - y).abs()[both].max()))
        return same, worst_d

    def replay_marches(label, marches, timed=False):
        """Each recorded march again into fresh rows: the kernel (through
        the counted wrapper) against the plain version, max |diff| 0.
        Returns, per march, (the kernel's launch inputs and stack, the
        plain version's valid samples, its wall ms); ``timed`` keeps the
        kernel's stack for timing."""
        out = []
        for args, kw in marches:
            rows = torch.arange(len(args[0]))
            shape = (len(rows), kw["width"] * kw["height"], 5)
            k_rows, p_rows = (torch.full(shape, float("nan"), device=dev)
                              for _ in range(2))
            launched, inner = [], rm.march_bucket
            rm.march_bucket = lambda *a: (launched.append(a), inner(*a))[1]
            try:
                rm.render_bucket_into(k_rows, rows, *args[1:], **kw)
            finally:
                rm.march_bucket = inner
            # an untimed run counts the valid samples of the bound and warms
            # the allocator; the timed run then rewrites the same rows
            samples = rm.render_bucket_into_reference(p_rows, rows, *args[1:],
                                                      count_samples=True, **kw)
            plain_ms, _ = synced_ms(lambda: rm.render_bucket_into_reference(
                p_rows, rows, *args[1:], **kw))
            same, d = device_diff(k_rows, p_rows)
            worst["raymarch"] = max(worst.get("raymarch", 0.0), d)
            log(f"{label}: {shape[0]} bricks x {shape[1]} pixels, {kw['num_steps']} "
                f"steps, {int(samples)} valid samples: kernel vs plain max |diff| "
                f"{d:.3g}, non-finite pattern same {same}; plain {plain_ms:.3f} ms")
            assert same and d == 0.0, label
            assert len(launched) == 1, len(launched)
            del p_rows
            out.append((launched[0] if timed else None, int(samples), plain_ms))
            del launched, k_rows
        return out

    reset_counts()
    with recorded_marches(rnd, "raymarch") as march_rec:
        image, _ = api.render(r2, api.RenderOptions(
            width=48, height=48, render_method="raymarch", device="cuda",
            output_filename=os.path.join(SCRATCH, "golden-raymarch.ppm")),
            verbose=False)
    same, diff = max_diff(image.pixels, golden["raymarch-1dev"])
    log(f"phase 25: raymarch vs raymarch-1dev: non-finite pattern same {same}, "
        f"max |diff| {diff:.3g} (atol {ATOL:g}); launches {counts()}, march "
        f"{ray_fn.launches}")
    assert counts()["composite_pixels"] == 1 and same and diff <= ATOL
    assert ray_fn.launches == len(march_rec) == 1, (ray_fn.launches, len(march_rec))
    replay_marches("phase 25: raymarch-1dev's march replayed", march_rec)
    # the 3-level scene, card against CPU (the CPU march at 1024^2 takes
    # about 15 s)
    p25 = RenderParameters(width=full, height=full)
    ray_fn.launches = 0
    with recorded_marches(rnd, "raymarch") as march_rec:
        ms_card, (img_card, _) = synced_ms(lambda: render_scene(
            "", p25, geometry3, verbose=False, method="raymarch", device=dev))
    assert ray_fn.launches == len(march_rec) == len(
        build_brick_buckets(geometry3.bricks)), ray_fn.launches
    t0 = time.perf_counter()
    img_cpu, _ = render_scene("", p25, geometry3, verbose=False, method="raymarch",
                              device=cpu)
    same, d = max_diff(img_card.pixels, img_cpu.pixels)
    log(f"phase 25: render_scene(method='raymarch') 3-level {full}x{full} "
        f"({len(geometry3.bricks)} bricks, {len(march_rec)} march launches): card "
        f"{ms_card:.3f} ms wall, CPU {time.perf_counter() - t0:.3f} s; max |diff| "
        f"{d:.3g}, non-finite pattern same {same}")
    assert same and d == 0.0
    replay_marches("phase 25: the 3-level frame's march replayed", march_rec)
    # the 512-brick plotfile at 1024^2 through render() and the CLI
    png_ray = os.path.join(SCRATCH, "radial_raymarch.png")
    png_ray_cli = os.path.join(SCRATCH, "radial_raymarch_cli.png")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30  # what earlier phases hold
    reset_counts()  # counted run: the raymarch route's main path
    with recorded_folds() as fold_rec, recorded_marches(rnd, "raymarch") as march_rec, \
            recorded_fmas(nm) as ray_fmas:
        wall_ms, rc = synced_ms(lambda: amrvolumerenderer_torch.render(
            plotfile, width=full, height=full, output=png_ray,
            render_method="raymarch"))
    got = counts()
    assert nm.fma.launches == len(ray_fmas) > 0, (nm.fma.launches, len(ray_fmas))
    log(f"phase 25: {smi}: the raymarch frame's {len(ray_fmas)} numerics.fma launches "
        "(its ray set-up) by launch shape (CUDA events, best of 3): "
        + fma_times_line(fma_launch_times(torch, nm, ray_fmas)))
    del ray_fmas
    launches["raymarch"] = ray_fn.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches["composite_pixels_raymarch"] = got["composite_pixels"]
    log(f"phase 25: {smi}: render(plotfile, render_method='raymarch') {n_bricks} bricks "
        f"at {full}x{full}: rc {rc}, {wall_ms:.3f} ms wall (scene build included), "
        f"launches {got}, march {ray_fn.launches}, peak device memory {peak:.3f} GiB, "
        f"{peak - held:.3f} GiB above the {held:.3f} GiB earlier phases hold")
    assert rc == 0 and got == {"tilemarch": 0, "slicemarch": 0, "composite": 0,
                               "composite_pixels": 1}, got
    assert ray_fn.launches == len(march_rec) == 1, ray_fn.launches
    cli = subprocess.run(
        [sys.executable, "-m", "amrvolumerenderer_torch.driver", "--width", str(full),
         "--height", str(full), "--render-method", "raymarch", "--output",
         png_ray_cli, plotfile], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert cli.returncode == 0, cli.stderr[-4000:]
    ray_api, ray_cli = read_png_rgb(png_ray), read_png_rgb(png_ray_cli)
    log(f"phase 25: the CLI's --render-method raymarch PNG equals render()'s "
        f"{bool(np.array_equal(ray_api, ray_cli))}")
    assert np.array_equal(ray_api, ray_cli)
    # the counted run's march replayed against the plain version, then the
    # kernel timed on its own launch inputs, against its bound
    torch.cuda.empty_cache()
    ((launch, samples, plain_ms),) = replay_marches(
        f"phase 25: the {n_bricks}-brick frame's march replayed", march_rec,
        timed=True)
    k_out, k_bucket, k_index, k_steps = launch
    kernel_ms = min(event_ms(lambda: rm.march_bucket(*launch)) for _ in range(3))
    num_b, num_p = k_index.shape[0], k_bucket.directions.shape[0]
    nbytes = (num_b * num_p * 20 + k_index.numel() * 4 + k_bucket.luts.numel() * 4
              + num_p * 12)
    times["raymarch"] = (kernel_ms, plain_ms)
    bounds_ms["raymarch"] = bound(nbytes, samples * RAY_SAMPLE_FLOPS)
    b_ms, by = bounds_ms["raymarch"]
    log(f"phase 25: {smi}: the march kernel, {num_b} bricks x {num_p} pixels, "
        f"{k_steps} steps, {samples} valid samples: {kernel_ms:.4f} ms "
        f"(CUDA events, best of 3), plain {plain_ms:.3f} ms; bound {b_ms:.5f} ms "
        f"({by}: {nbytes} B, "
        f"{samples * RAY_SAMPLE_FLOPS} operations), kernel at {b_ms / kernel_ms:.4f} "
        "of its bound")
    # the stack clear the kernel made unnecessary, timed on the same rows
    old_clear_ms = event_ms(lambda: (k_out.zero_(), k_out[..., 4].fill_(float("inf"))))
    del launch, k_out, k_bucket, k_index, march_rec
    torch.cuda.empty_cache()
    # the wall split of one frame: march (bucket build, upload, set-up and
    # classification, kernel, order keys), fold, readback
    bounds_p = compute_global_bounds(pgeom)
    srange_p = pgeom.scalar_range
    rsd_p = compute_reference_sample_distance(pgeom, bounds_p)
    cam_p = auto_orbit_camera(bounds_p)
    with recorded_marches(rnd, "raymarch") as march_rec:
        march_ms, (layers, hints, owners, local) = synced_ms(
            lambda: rnd._render_layers_raymarch(pgeom, p25, cam_p, bounds_p, srange_p,
                                                rsd_p, full, full, None, dev))
    fold_ms, folded = synced_ms(lambda: compositor.composite_layers_device(
        layers, hints, owners, local))
    read_ms, frame_p = synced_ms(lambda: folded.cpu().numpy())
    covered = float((frame_p[:, 3] > 0).mean())
    (args_p, kw_p), = march_rec
    build_ms, (bucket_p,) = synced_ms(lambda: build_brick_buckets(pgeom.bricks))
    upload_ms, data_p = synced_ms(lambda: torch.from_numpy(bucket_p.data).to(dev))
    alloc_ms, _ = synced_ms(lambda: torch.empty(layers.shape, device=dev))
    wrapper_ms, _ = synced_ms(lambda: rm.render_bucket_into(
        layers, args_p[0], data_p, *args_p[2:], **kw_p))
    log(f"phase 25: {smi}: one {n_bricks}-brick raymarch frame at {full}x{full}: march "
        f"{march_ms:.3f} ms, fold {fold_ms:.3f} ms, readback "
        f"{read_ms:.3f} ms (wall, synchronised); stack {tuple(layers.shape)} "
        f"({layers.numel() * 4 / 2 ** 30:.3f} GiB), alpha > 0 on {covered:.4f}")
    log(f"phase 25: {smi}: the march stage split: bucket build (host) {build_ms:.3f} "
        f"ms, upload of the bucket ({bucket_p.data.nbytes} B, pageable) "
        f"{upload_ms:.3f} ms, stack allocation {alloc_ms:.3f} ms (torch.empty "
        f"from an emptied cache, and no clear: the kernel writes every row; the "
        f"zeros + inf clear it replaced: {old_clear_ms:.3f} ms), set-up + "
        "classification + kernel "
        f"{wrapper_ms:.3f} ms of which the kernel {kernel_ms:.4f} ms")
    del data_p, bucket_p, march_rec, args_p
    assert np.isfinite(frame_p[:, :4]).all()
    assert ALPHA_FRACTION[0] <= covered <= ALPHA_FRACTION[1], covered
    # the frame with the bounds wireframe drawn over it, byte coded, is the
    # PNG that render() wrote
    shown = ImageBuffer(ImageKind.RGBA_F32_DEPTH_SORT, full, full, frame_p.copy())
    rnd.render_bounding_box_overlay(rnd.compute_tight_bounds(pgeom, bounds_p),
                                    cam_p, 1, shown)
    expect = np.clip((shown.pixels[:, :3] * np.float32(256.0)).astype(np.int32),
                     0, 255)
    expect = expect.astype(np.uint8).reshape(full, full, 3)[::-1]
    assert np.array_equal(ray_api, expect), "the raymarch PNG differs from the frame"
    hold_calls("composite_pixels_raymarch", lambda *a: [comp.composite_pixels(*a)],
               lambda *a: [comp.composite_pixels_reference(*a)],
               f"phase 25: the raymarch fold launch replayed "
               f"({[tuple(a[0].shape[:2]) for a, _ in fold_rec]} layers x pixels)",
               fold_rec, atol=0.0)
    (fold_args, _), = fold_rec
    n_l, n_p = fold_args[0].shape[:2]
    fold_kernel_ms = min(event_ms(lambda: comp.composite_pixels(*fold_args))
                         for _ in range(3))
    fold_plain_ms = event_ms(lambda: comp.composite_pixels_reference(*fold_args))
    nbytes, nflops = (n_l + 1) * n_p * 20, n_l * n_p * BLEND_FLOPS
    times["composite_pixels_raymarch"] = (fold_kernel_ms, fold_plain_ms)
    bounds_ms["composite_pixels_raymarch"] = bound(nbytes, nflops)
    log(f"phase 25: {smi}: the {n_l}-layer fold ({n_l} x {n_p}): kernel "
        f"{fold_kernel_ms:.4f} ms, plain {fold_plain_ms:.4f} ms, byte bound "
        f"(L + 1) x P x 20 B = {bound(nbytes, nflops)[0]:.5f} ms "
        f"({bound(nbytes, nflops)[1]}), kernel at "
        f"{bound(nbytes, nflops)[0] / fold_kernel_ms:.4f} of its bound")
    del fold_rec, fold_args, folded
    one_layers = layers
    del layers
    torch.cuda.empty_cache()

    # phase 26: the raymarch sharded frame, D = 8 on one card, both
    # transports, against the one-device layers folded in the same order
    assign_owners(pgeom, 8)
    (bucket,) = build_brick_buckets(pgeom.bricks)
    order = np.argsort(bucket.owners, kind="stable")  # shard-major slots
    steps = np.array([max(pgeom.bricks[i].min_spacing() * 0.5, 1e-5)
                      for i in bucket.brick_indices[order]], np.float32)
    luts = np.stack([build_color_table(1.0, s / rsd_p, srange_p, None)
                     for s in steps])
    hints26 = np.array([compute_box_depth_hint(pgeom.bricks[i].min_corner,
                                               pgeom.bricks[i].max_corner, cam_p)
                        for i in bucket.brick_indices[order]], np.float32)
    tables = (torch.from_numpy(bucket.data[order]).to(dev),
              bucket.min_corner[order], bucket.max_corner[order],
              bucket.cell_dims[order], luts, steps, np.ones(n_bricks, bool), hints26)
    forward, right, up = camera_basis(cam_p)
    t_p = pgeom.scalar_transform
    args26 = ([np.asarray(v, np.float32) for v in (cam_p.eye, forward, right, up)],
              cam_p.fov_y_degrees, srange_p[0], 1.0 / (srange_p[1] - srange_p[0]),
              (t_p.positive_floor, t_p.normalization_min,
               t_p.inverse_normalization_span))
    kw26 = dict(width=full, height=full,
                num_steps=rm.max_steps_for_bucket(tables[1], tables[2], steps),
                log_scale=t_p.log_scale_input, normalize=t_p.normalize_to_unit_range,
                clip_start=float(np.clip(srange_p[1], 0.0, 1.0)), apply_clip=False)
    # the shards' (hint, owner, local slot) keys of each brick, in brick
    # order: the one-device stack folded in the sharded frame's order
    slot_bricks = bucket.brick_indices[order]
    hint_b, owner_b, local_b = (np.empty(n_bricks, np.float32),
                                np.empty(n_bricks, np.int32),
                                np.empty(n_bricks, np.int32))
    hint_b[slot_bricks] = hints26
    owner_b[slot_bricks] = np.repeat(np.arange(8, dtype=np.int32), per_shard)
    local_b[slot_bricks] = np.tile(np.arange(per_shard, dtype=np.int32), 8)
    one26 = compositor.composite_layers_device(
        one_layers, hint_b, owner_b, local_b).cpu().numpy()
    del one_layers
    torch.cuda.empty_cache()
    mesh8 = ds.make_mesh(8, dev)

    @contextlib.contextmanager
    def unfolded_raymarch():
        """The sharded raymarch with the camera rounded as the one-device
        program rounds it (``fold_camera=False``)."""
        class Unfolded:
            def __getattr__(self, name):
                return getattr(rm, name)

            @staticmethod
            def render_bucket_into(*a, **k):
                return rm.render_bucket_into(*a, **dict(k, fold_camera=False))

        ds.rm = Unfolded()
        try:
            yield
        finally:
            ds.rm = rm

    frames26 = {}
    for transport in ("float32", "ubyte"):
        reset_counts()
        with recorded_folds() as fold_rec, recorded_marches(ds, "rm") as march_rec:
            ms26, shards = synced_ms(lambda tr=transport: ds.render_and_composite_sharded(
                mesh8, *tables, *args26, transport=tr, **kw26))
        got = counts()
        marched = ray_fn.launches
        frame26 = frames26[transport] = torch.cat(shards).cpu().numpy()
        same, d = max_diff(frame26, one26)
        with np.errstate(invalid="ignore"):  # inf - inf where both are +inf
            diff = np.where(np.isfinite(one26), np.abs(frame26 - one26),
                            0.0).max(axis=1)
        beyond = int((diff > 1e-5).sum())
        log(f"phase 26: {smi}: render_and_composite_sharded D=8 {transport}, "
            f"{n_bricks} bricks at {full}x{full}: {ms26:.3f} ms wall, launches "
            f"{got}, march {marched}; vs the one-device layers folded in the same "
            f"order: max |diff| {d:.3g}, {beyond} of {len(diff)} pixels beyond 1e-5, "
            f"non-finite pattern same {same}")
        assert got["composite_pixels"] == 8 and got["tilemarch"] == 0, got
        assert marched == len(march_rec) == 8, marched  # one march a shard
        assert same
        if transport == "float32":
            # JAX's program folds the camera: an ulp of ray direction flips
            # a nearest-cell sample on a few pixels; unfolded, the frame is
            # the one-device fold's
            assert beyond <= 1e-3 * len(diff), beyond
            with unfolded_raymarch():
                plain = torch.cat(ds.render_and_composite_sharded(
                    mesh8, *tables, *args26, **kw26)).cpu().numpy()
            same_p, d_p = max_diff(plain, one26)
            log(f"phase 26: float32 with the camera unfolded: max |diff| "
                f"{d_p:.3g} (limit 1e-5), non-finite pattern same {same_p}")
            assert same_p and d_p <= 1e-5
        else:
            # the byte colours against the float32 exchange of the same
            # sharded frame: the codec's quantisation alone
            same_b, d_b = max_diff(frame26, frames26["float32"])
            log(f"phase 26: ubyte vs float32 exchange: max |diff| {d_b:.3g} "
                f"(limit 0.02), non-finite pattern same {same_b}")
            assert same_b and d_b < 0.02, d_b
        hold_calls("composite_pixels", lambda *a: [comp.composite_pixels(*a)],
                   lambda *a: [comp.composite_pixels_reference(*a)],
                   f"phase 26: {transport}: {len(fold_rec)} fold launches replayed",
                   fold_rec, atol=0.0)
        del fold_rec, shards
        replay_marches(f"phase 26: {transport}: a shard's march replayed", march_rec)
        del march_rec
    del tables
    torch.cuda.empty_cache()

    def take(records):
        """Enter a diff phase's kernel records in the ``kernels`` line."""
        for name, rec in records.items():
            launches[name], worst[name] = rec["launches"], rec["max_abs_err"]
            times[name] = (rec["ms"], rec["plain_ms"])
            bounds_ms[name] = (rec["bound_ms"], rec["bound_by"])
            library_ms[name] = rec.get("library_ms")

    # ---- phase 27: the differentiable path ---------------------------------
    diff_records = diff_phase(torch, dev, smi, reset_counts, counts, diff_counts)
    for name, rec in fold_phase(torch, dev, smi).items():  # the fold's unit timings
        worst_fold = max(diff_records[name]["max_abs_err"], rec.pop("max_abs_err"))
        diff_records[name].update(rec, max_abs_err=worst_fold)
    take(diff_records)
    take(pair_phase(torch, dev, smi, reset_counts, counts, diff_counts))

    # ---- phase 28: the one-shot tile-march route; two processes ------------
    # (i) renderer_fast.render_composited_tilemarch (JAX's route: the
    # slice-march prep, parent-hint fallback, visibility owner keys) on the
    # 3-level scene with the graph on and off at 1024^2, its one kernel-1
    # launch replayed against the plain version; the same route at 256^2
    # on the card against the CPU (the CPU's frame at 1024^2 took 138-149 s
    # on the host of an H100 machine with the once-rounding plain FMA)
    for graph in (True, False):
        params = RenderParameters(width=1024, height=1024, use_visibility_graph=graph)
        camera = auto_orbit_camera(bounds3, params.camera_seed, params.camera_up)
        route = (geometry3, params, camera, srange3, rsd3, 1024, 1024, None)
        reset_counts()
        with recorded(rf, "tm", "tilemarch_render") as tile_rec:
            route_ms, frame = synced_ms(
                lambda: rf.render_composited_tilemarch(*route, device=dev))
        got = counts()
        small = (geometry3, RenderParameters(width=256, height=256,
                                             use_visibility_graph=graph),
                 camera, srange3, rsd3, 256, 256, None)
        t0 = time.perf_counter()
        cpu_frame = rf.render_composited_tilemarch(*small, device="cpu")
        cpu_s = time.perf_counter() - t0
        same, d = max_diff(rf.render_composited_tilemarch(*small, device=dev), cpu_frame)
        covered = float((frame[:, 3] > 0).mean())
        log(f"phase 28: {smi}: render_composited_tilemarch 3-level 1024x1024, "
            f"visibility graph {'on' if graph else 'off'}: {route_ms:.3f} ms wall, "
            f"launches {got}; at 256x256 the CPU's frame ({cpu_s:.3f} s) against the "
            f"card's: max |diff| {d:.3g}, non-finite pattern same {same}; alpha > 0 on "
            f"{covered:.4f}")
        assert got == {"tilemarch": 1, "slicemarch": 0, "composite": 0,
                       "composite_pixels": 0}, got
        assert same and d == 0.0
        assert ALPHA_FRACTION[0] <= covered <= ALPHA_FRACTION[1], covered
        hold_calls("tilemarch", tm.tilemarch_render, tm.tilemarch_reference,
                   f"phase 28: the route's kernel-1 launch (graph "
                   f"{'on' if graph else 'off'}) replayed", tile_rec, atol=0.0)
        del tile_rec, frame, cpu_frame
    two_process_phase(torch, smi)

    # ---- phase 29: the sharded gradient; the two benchmark examples --------
    take(diff_sharded_phase(torch, dev, smi, reset_counts, all_counts, diff_counts))
    # (d) in this process: kernel 1 on the examples' own inputs at their
    # defaults against its plain version (the subprocesses above only run
    # them): bench_scaling's tables, one bench_orbit frame and a 2-frame
    # render_batch chunk of its orbit
    scaling = runpy.run_path(os.path.join(ROOT, "examples", "bench_scaling_torch.py"))
    scene29 = scaling["build_scene"](128, 1024, 1024)
    tables = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in scene29["tables"]]
    t0 = time.perf_counter()
    hold_calls("tilemarch", tm.tilemarch_render, tm.tilemarch_reference,
               f"phase 29: (d) bench_scaling's scene ({scene29['num_bricks']} bricks, "
               f"{tables[6].shape[0]} work items, 1024x1024, max_slices 32): kernel 1",
               [(tables, dict(width=1024, height=1024, max_slices=scaling["BOX"]))],
               atol=0.0)
    log(f"phase 29: (d) bench_scaling's kernel vs plain: "
        f"{time.perf_counter() - t0:.3f} s")
    orbit = runpy.run_path(os.path.join(ROOT, "examples", "bench_orbit_torch.py"))
    fast29 = orbit["prepare_renderer"](128, 2048, 2048, 4, dev)
    cams29 = orbit["orbit_cameras"](12)
    with recorded(fast_scene, "tm", "tilemarch_render") as tile_rec:
        frame29 = fast29.render(cams29[0])
    with recorded(fast_scene, "tm", "tilemarch_render_batch") as batch_rec:
        fast29.render_batch(cams29[:2], overlay=False, bytes_out=True)
    assert len(tile_rec) == 1 and len(batch_rec) == 1, (len(tile_rec), len(batch_rec))
    assert frame29[:, 3].max() > 0.0
    t0 = time.perf_counter()
    hold_calls("tilemarch", tm.tilemarch_render, tm.tilemarch_reference,
               f"phase 29: (d) bench_orbit's first frame ({fast29.canonical.shape[0]} "
               f"pieces, 2048x2048 AA=4, a {fast29.pad_w}x{fast29.pad_h} buffer): "
               "kernel 1", tile_rec, atol=0.0)
    hold_calls("tilemarch_batch", tm.tilemarch_render_batch,
               tm.tilemarch_batch_reference,
               "phase 29: (d) bench_orbit --batch, its first two frames as one "
               "chunk: the batched kernel 1", batch_rec, atol=0.0)
    log(f"phase 29: (d) bench_orbit's kernel vs plain: {time.perf_counter() - t0:.3f} s")
    del tables, fast29, tile_rec, batch_rec, frame29
    torch.cuda.empty_cache()

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
        "composite_runs": ("ops/csrc/composite.cu",
                           "amrvolumerenderer_tpu/parallel/directsend.py:300"),
        "composite_pixels_raymarch": ("ops/csrc/composite.cu",
                                      "amrvolumerenderer_tpu/compositor.py:81"),
        "raymarch": ("ops/csrc/raymarch.cu",
                     "amrvolumerenderer_tpu/ops/raymarch.py:78"),
        "diffmarch_forward": ("ops/csrc/diffmarch.cu",
                              "amrvolumerenderer_tpu/diff.py:113"),
        "diffmarch_backward": ("ops/csrc/diffmarch.cu",
                               "amrvolumerenderer_tpu/diff.py:113"),
        "diffmarch_tangent": ("ops/csrc/diffmarch.cu",
                              "amrvolumerenderer_tpu/diff.py:113"),
        "diffmarch_pairs": ("ops/csrc/diffmarch.cu",
                            "amrvolumerenderer_tpu/diff.py:113"),
        "fma": ("ops/csrc/numerics.cu",
                "none: XLA's contracted a * b + c (the FMA sites of the plain "
                "versions and of diff.py's eager ray set-up)"),
        "fold_diff_forward": ("ops/csrc/composite.cu",
                              "none: amrvolumerenderer_tpu/diff.py's fold, "
                              "differentiated by XLA"),
        "fold_diff_backward": ("ops/csrc/composite.cu",
                               "none: amrvolumerenderer_tpu/diff.py's fold, "
                               "differentiated by XLA"),
        "diffpairs_build": ("ops/csrc/diffmarch.cu",
                            "amrvolumerenderer_tpu/diff.py:113 (the slab test and "
                            "first distance of render_layers_diff, as a pair list)"),
        "diffpairs_fold_forward": ("ops/csrc/composite.cu",
                                   "none: amrvolumerenderer_tpu/diff.py's fold over "
                                   "a view's hit pairs"),
        "diffpairs_fold_backward": ("ops/csrc/composite.cu",
                                    "none: amrvolumerenderer_tpu/diff.py's fold over "
                                    "a view's hit pairs, differentiated"),
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
        "library_ms": library_ms.get(name),
    } for name in sources]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# phase 28 (ii): one process of the CLI path over several configurations
# (``python -c RANK_RUN ROOT CONFIGS``), the JAX-style launch variables
# from the environment; one line per configuration with its wall time and
# the kernel launch counts of this process
RANK_RUN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from amrvolumerenderer_torch import driver
from amrvolumerenderer_torch.device import process_index
from amrvolumerenderer_torch.ops import composite as comp
from amrvolumerenderer_torch.ops import slicemarch as sm
from amrvolumerenderer_torch.ops import tilemarch as tm

counted = {"slicemarch_dense": sm.slicemarch_render,
           "composite_pixels": comp.composite_pixels,
           "composite_runs": comp.composite_runs,
           "tilemarch": tm.tilemarch_render,
           "slicemarch": sm.slicemarch_render_worklist_raw,
           "composite": comp.composite_tiles}
distributed = driver.maybe_initialize_distributed(sys.argv[3])
sync = torch.cuda.synchronize if sys.argv[3] != "cpu" else (lambda: None)
for name, transport, argv in json.loads(sys.argv[2]):
    for attempt in range(2):
        options = driver.parse_options(argv)
        options.parameters.multichip_transport = transport
        for fn in counted.values():
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        rc = driver.run_options(options, verbose=False)
        sync()
        print("RANK_RUN " + json.dumps({
            "config": name, "attempt": attempt, "rank": process_index(),
            "rc": rc, "wall_s": time.perf_counter() - t0,
            "launches": {k: f.launches for k, f in counted.items()}}), flush=True)
        assert rc == 0, (name, rc)
if distributed:
    torch.distributed.destroy_process_group()
"""


def two_process_phase(torch, smi: str, device: str = "cuda", size: int = 1024) -> None:
    """Phase 28 (ii): the port's CLI path (``driver.parse_options`` and
    ``run_options`` after ``maybe_initialize_distributed``) in two
    processes on ``cuda:0``, joined by the JAX-style variables through a
    free localhost port, with ``LOCAL_WORLD_SIZE=2`` (both on this host);
    one card, so the backend is gloo through pinned
    host memory (``device="cpu"``: gloo on the CPU, to try the phase off
    the card).  The 3-level scene as a plotfile at ``size``^2 over 8 shards
    (4 a process): the one-shot slice-march pipeline in float32 and ubyte
    transport, and the persistent renderer's 4-frame orbit.  Rank 0's
    images must equal a one-process run's byte for byte, rank 1 saves
    nothing, and on both ranks kernel 4 and the pixel or runs mode of the
    composite kernel launch.  Any failing process fails the phase."""
    import socket

    from amrvolumerenderer_torch.driver import write_plotfile

    import shutil

    base = os.path.join(SCRATCH, "two_process")
    shutil.rmtree(base, ignore_errors=True)
    plotfile = os.path.join(base, "plt_3level")
    levels, geoms, _ = three_level_levels()
    write_plotfile(plotfile, levels, geoms, ref_ratios=[2, 2])
    flags = [plotfile, "--width", str(size), "--height", str(size), "--devices", "8",
             "--render-method", "slicemarch", "--device", device]
    configs = [
        ("oneshot-float32", "float32", flags + ["--output", "f32.ppm"]),
        ("oneshot-ubyte", "ubyte", flags + ["--output", "u8.ppm"]),
        ("orbit-4", "float32", flags + ["--orbit-frames", "4", "--output", "orbit.ppm"]),
    ]
    outputs = {"oneshot-float32": ["f32.ppm"], "oneshot-ubyte": ["u8.ppm"],
               "orbit-4": [f"orbit_{i:04d}.ppm" for i in range(4)]}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    def start(tag, env_extra):
        cwd = os.path.join(base, tag)
        os.makedirs(cwd)
        env = dict(os.environ, PYTHONPATH=ROOT)
        for key in ("AVR_DISTRIBUTED", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            env.pop(key, None)
        env.update(env_extra)
        return cwd, subprocess.Popen(
            [sys.executable, "-c", RANK_RUN, ROOT, json.dumps(configs), device], cwd=cwd,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(runs):
        """Wait for every process; fail on any non-zero exit.  Returns each
        run's (cwd, {(config, attempt): record}, stdout)."""
        done = []
        for cwd, proc in runs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{cwd}: rc {proc.returncode}\n{err[-4000:]}"
            records = {}
            for line in out.splitlines():
                if line.startswith("RANK_RUN "):
                    rec = json.loads(line[len("RANK_RUN "):])
                    records[(rec["config"], rec["attempt"])] = rec
            done.append((cwd, records, out))
        return done

    t0 = time.perf_counter()
    ranks = finish([start(f"rank{r}", dict(
        JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
        JAX_PROCESS_ID=str(r), LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(r)))
        for r in (0, 1)])
    pair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (single,) = finish([start("single", {})])
    single_s = time.perf_counter() - t0
    up = [line for line in ranks[0][2].splitlines() if "distributed runtime up" in line]
    log(f"phase 28: two processes on {device}: {up[0] if up else 'no runtime line'}; "
        f"{pair_s:.3f} s wall for the pair, {single_s:.3f} s for one process "
        "(process start, CUDA context and scene load included)")
    shared = 2 if device == "cpu" else 1
    assert up and f"2 host(s), {shared} device(s), backend gloo" in up[0], up
    for name, _, _ in configs:
        for attempt in (0, 1):
            recs = [r[1][(name, attempt)] for r in ranks]
            one = single[1][(name, attempt)]
            log(f"phase 28: {smi}: {name} (run {attempt + 1}): wall rank 0 "
                f"{recs[0]['wall_s'] * 1e3:.3f} ms, rank 1 {recs[1]['wall_s'] * 1e3:.3f} ms, "
                f"one process {one['wall_s'] * 1e3:.3f} ms")
            for rec in recs + [one]:
                log(f"phase 28: {name} (run {attempt + 1}) "
                    f"{'rank ' + str(rec['rank']) if rec in recs else 'one process'} "
                    f"launches {json.dumps(rec['launches'])}")
            for rec in recs if device != "cpu" else []:  # plain versions count none
                launched = rec["launches"]
                assert launched["slicemarch_dense"] > 0, (name, rec)
                assert launched["composite_pixels"] + launched["composite_runs"] > 0, \
                    (name, rec)
        for fname in outputs[name]:
            got = open(os.path.join(ranks[0][0], fname), "rb").read()
            want = open(os.path.join(single[0], fname), "rb").read()
            assert got == want, f"{name}: rank 0's {fname} differs from one process"
    assert os.listdir(ranks[1][0]) == [], os.listdir(ranks[1][0])
    log("phase 28: rank 0's images equal the one-process images byte for byte "
        f"({sum(len(v) for v in outputs.values())} files); rank 1 saved nothing")


# phase 27: the differentiable path's gradient tolerance against the CPU
# (tests/test_torch_cuda.py test_diff_matches_cpu): the card's backward adds
# its scatter-adds and pixel sums in another order
DIFF_GRAD_REL = 1e-4
DIFF_EXAMPLES = ("fit_transfer_function_torch.py", "fit_volume_torch.py")


def diff_scenes(torch):
    """Phase 27 (a)'s scenes as (name, NumPy args, static): the 6^3 scene
    of tests/test_diff.py at 12x12 and 64 steps with its smooth LUT, and
    the golden manifest's r^2 scene through ``diff.prepare_geometry``."""
    from amrvolumerenderer_torch import api, diff
    from amrvolumerenderer_torch.camera import camera_basis
    from amrvolumerenderer_torch.types import CameraParameters

    rng = np.random.default_rng(11)
    data = rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32)
    t = np.linspace(0.0, 1.0, 256)
    lut = np.stack([t, np.full_like(t, 0.4), 1.0 - t, 0.3 * t], 1).astype(np.float32)
    camera = CameraParameters(eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.5),
                              up=(0.0, 1.0, 0.0), fov_y_degrees=45.0)
    f32 = np.float32
    basis = [np.asarray(v, f32) for v in (camera.eye, *camera_basis(camera))]
    static = dict(width=12, height=12, num_steps=64, log_scale=False,
                  normalize=False, clip_start=1.0, apply_clip=False)
    scenes = []
    for name, table in (("test_diff 6^3", lut),):
        scenes.append((name, (data[None], np.zeros((1, 3), f32), np.ones((1, 3), f32),
                              np.full((1, 3), 6, np.int32), table[None],
                              np.full(1, 1.0 / 12, f32), *basis,
                              f32(camera.fov_y_degrees), f32(0.0), f32(1.0), f32(0.0),
                              f32(0.0), f32(1.0)), static))
    levels, geoms = r2_scene_data(16, 8)
    geometry = api.load_amr_geometry(api.AmrData(level_data=levels,
                                                 level_geometry=geoms),
                                     0, -1, 0, False, True, verbose=False)
    args, r2_static = diff.prepare_geometry(
        geometry, CameraParameters(eye=(1.6, 1.3, 2.4), look_at=(0.5, 0.5, 0.5),
                                   up=(0.0, 1.0, 0.0)),
        width=48, height=40, device="cpu")
    scenes.append(("golden r^2 16^3", tuple(a.numpy() for a in args), r2_static))
    return scenes


def diff_sample_flops(cfg) -> int:
    """float32 operations of one valid sample of diffmarch.cu's forward,
    counted by hand (an FMA counts 2, a compare 1): the distance, the
    position and the gate (16), per axis the cell coordinate, its clips,
    floor and weight (36), the seven lerps (28), the finite test (1), the
    range, the LUT coordinate and its weight (11), the LUT lerp (13) and
    the over step (9); the normalisation adds 4, XLA's log 30 and the soft
    tail 13."""
    flops = 114 + (4 if cfg.normalize else 0) + (30 if cfg.log_scale else 0)
    return flops + (13 if cfg.apply_clip else 0)


# the tangent kernel's groups of differentiable fields (csrc/diffmarch.cu
# kTanData, kTanLut, kTanGeometry, kTanScalars), by MarchInputs field
TANGENT_GROUPS = {"data": "data", "luts": "lut", "d0": "geometry",
                  "directions": "geometry", "eye": "geometry", "steps": "geometry",
                  "bmin": "geometry", "cell": "geometry", "scalars": "scalars"}
ALL_TANGENT_GROUPS = frozenset(TANGENT_GROUPS.values())


def tangent_groups(dm, tangents) -> frozenset:
    """The groups of the fields that carry a tangent (not None)."""
    return frozenset(TANGENT_GROUPS[f] for f, t in zip(dm.MarchInputs._fields, tangents)
                     if t is not None)


def diff_tangent_flops(cfg, groups=ALL_TANGENT_GROUPS) -> int:
    """float32 operations of one valid sample of diffmarch.cu's tangent
    instantiation for ``groups``: the forward's sample
    (``diff_sample_flops``) and the tangent terms those groups need,
    counted by hand (an FMA counts 2, a compare 1): the dual over step
    (17) always; the LUT rows' lerp (14) with the LUT; the scalar's chain
    where the data, the geometry or the scalars carry a tangent (the LUT
    coordinate and weight with their clip rules 26, the value's part of the
    LUT lerp 14, the range 5; the normalisation 13, the log 8 and the soft
    tail 18 where the march applies them); the three lerps after the first
    four (21) with the data or the geometry; the first four lerps' data
    terms (16) with the data; the distance (2), per axis the position, the
    cell coordinate and the weight with its two clip rules (78) and the
    first four lerps' weight terms (12) with the geometry.  All four groups
    give 205 beyond the sample and the transform's terms."""
    flops = diff_sample_flops(cfg) + 17
    if "lut" in groups:
        flops += 14
    if groups & {"data", "geometry", "scalars"}:
        flops += 45 + (13 if cfg.normalize else 0) + (8 if cfg.log_scale else 0)
        flops += 18 if cfg.apply_clip else 0
    if groups & {"data", "geometry"}:
        flops += 21
    if "data" in groups:
        flops += 16
    if "geometry" in groups:
        flops += 92
    return flops


@contextlib.contextmanager
def recorded_tangents(dm):
    """``[(m, cfg, tangents, out)]`` of every ``diffmarch_tangent`` call
    inside the block (the march's ``jvp`` calls it through the module).
    The wrapper counts its launches on the module's own name, so that name
    is the wrapper again while each call runs."""
    inner, seen = dm.diffmarch_tangent, []

    def record(m, cfg, tangents):
        dm.diffmarch_tangent = inner
        try:
            out = inner(m, cfg, tangents)
        finally:
            dm.diffmarch_tangent = record
        seen.append((m, cfg, tangents, out))
        return out

    dm.diffmarch_tangent = record
    try:
        yield seen
    finally:
        dm.diffmarch_tangent = inner


@contextlib.contextmanager
def recorded_fmas(nm):
    """The operands of every ``numerics.fma`` kernel launch inside the
    block (``nm._fma_launch``), in order; the launches still go through the
    counted wrapper."""
    inner, seen = nm._fma_launch, []

    def record(*ops):
        seen.append(ops)
        return inner(*ops)

    nm._fma_launch = record
    try:
        yield seen
    finally:
        nm._fma_launch = inner


def fma_launch_times(torch, nm, launches, reps: int = 3) -> list:
    """Each distinct ``numerics.fma`` launch of ``launches`` (operand
    shapes, strides and numbers): its count, the kernel's device ms and one
    ``torch.addcmul``'s on the same operands (numbers as 0-d tensors; it
    need not round once), both by CUDA events, best of ``reps``, and its
    byte bound (each tensor operand's elements read once, the output written
    once)."""
    shapes = {}
    for ops in launches:
        key = tuple((tuple(v.shape), v.stride()) if isinstance(v, torch.Tensor) else "number"
                    for v in ops)
        shapes.setdefault(key, [ops, 0])[1] += 1
    rows = []
    best = lambda fn: min(event_ms(torch, fn) for _ in range(reps))  # noqa: E731
    for key, (ops, count) in shapes.items():
        dev = next(v.device for v in ops if isinstance(v, torch.Tensor))
        lib = [v if isinstance(v, torch.Tensor) else torch.tensor(v, device=dev) for v in ops]
        with torch.no_grad():
            out = nm.fma(*ops)
            ms = best(lambda: nm.fma(*ops))
            lib_ms = best(lambda: torch.addcmul(lib[2], lib[0], lib[1]))
        nbytes = sum(v.numel() * 4 for v in ops if isinstance(v, torch.Tensor))
        b_ms, _ = bound(nbytes + out.numel() * 4, 2 * out.numel())
        rows.append(dict(out=tuple(out.shape), ops=[k if k == "number" else list(k[0])
                                                   for k in key],
                         count=count, ms=ms, addcmul_ms=lib_ms, bound_ms=b_ms))
    return rows


def fma_times_line(rows) -> str:
    """``fma_launch_times``' rows as one log line, with the sum a call."""
    total = sum(r["count"] * r["ms"] for r in rows)
    lib = sum(r["count"] * r["addcmul_ms"] for r in rows)
    return ("; ".join(f"{r['out']} from {' x '.join(str(o) for o in r['ops'][:2])} + "
                      f"{r['ops'][2]} x{r['count']}: {r['ms']:.4f} ms, addcmul "
                      f"{r['addcmul_ms']:.4f}, bound {r['bound_ms']:.5f} (at "
                      f"{r['bound_ms'] / r['ms']:.4f})" for r in rows)
            + f"; sum a call {total:.4f} ms (addcmul {lib:.4f}) over "
            f"{sum(r['count'] for r in rows)} launches")


# the backward's adjoint of one valid sample beyond the forward sample it
# differentiates, counted by hand: the over step's
# adjoint (15), the LUT lerp's with its eight shared adds (18), the LUT
# weight (12), the clips and scalars (24), the trilinear weights and
# corners with their eight adds (52), the cell coordinates and the position
# (54) and the distance (3).  The backward's bound counts one forward sample
# and this adjoint a valid sample: the kernel's two recomputes of the sample
# (the segment's replay and the walk back) are the overhead of its design,
# not work the function needs
DIFF_ADJOINT_FLOPS = 178


def diff_contention_scene(torch, dev, size: int = 64):
    """(MarchInputs, MarchConfig) of the diff march's worst contention
    (tests/test_torch_cuda.py's "contention" scene): one brick of 2^3 cells
    seen face on at ``size``^2, so that every sample reads the same eight
    cells and falls into the same LUT bin, and every backward step adds
    into the same eight data-gradient cells and the same two LUT rows."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm
    from amrvolumerenderer_torch.types import CameraParameters

    # 0.6 to 0.6035: one LUT bin, and a gradient along every axis
    cells = (0.6 + 0.0005 * np.fromfunction(lambda x, y, z: x + 2 * y + 4 * z, (2, 2, 2)))
    bricks = [(cells.astype(np.float32), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))]
    camera = CameraParameters(eye=(0.5, 0.5, 2.5), look_at=(0.5, 0.5, 0.5),
                              up=(0.0, 1.0, 0.0), fov_y_degrees=20.0)
    args, static = diff.prepare_scene(bricks, camera, width=size, height=size,
                                      device=dev)
    seen, inner = [], dm.march
    dm.march = lambda m, cfg: (seen.append((m, cfg)), inner(m, cfg))[1]
    try:
        with torch.no_grad():
            diff.render_layers_diff(*args, **static)
    finally:
        dm.march = inner
    (case,) = seen
    return case


# the backward's breakdown: which gradients the kernel forms, by ``needs``
# of (data, LUT); the other inputs' gradients are always formed
DIFF_NEEDS = {"both": (True, True), "no_lut": (True, False), "no_data": (False, True),
              "neither": (False, False)}


# numerics.fma launches of one call of the diff path on the 3-level scene,
# with or without the gradient: the eager ray set-up's FMA sites (the march
# and the 13-layer fold have their own kernels)
DIFF_FMA_LAUNCHES = 17


class HeldLaunch:
    """A stand-in for a counted kernel wrapper under its module name: calls
    the wrapper, then ``check(result, *args, **kwargs)``.  The wrapper
    counts its launch under its module name, which is this stand-in, so
    ``launches`` reads and writes the wrapper's own counter."""

    def __init__(self, inner, check):
        self.inner, self.check = inner, check

    def __call__(self, *args, **kwargs):
        out = self.inner(*args, **kwargs)
        self.check(out, *args, **kwargs)
        return out

    @property
    def launches(self):
        return self.inner.launches

    @launches.setter
    def launches(self, n):
        self.inner.launches = n


def fold_phase(torch, dev, smi: str, pixels: int = 512 * 512, num_layers: int = 8,
               reps: int = 5) -> dict:
    """Phase 27 (d): the differentiable fold's two kernels
    (``ops.composite.fold_diff``) at ``pixels`` pixels of ``num_layers``
    seeded layers (in a tenth of the pixels one layer opaque, so the alpha
    reaches the clip's tie at 1; a permuted order) and the cotangent of
    ``sum(image * w)``, w seeded: each kernel (the forward with and
    without its kept outputs) against its plain version on the card at max
    |diff| 0, and the image and the layers' gradient against the eager
    loop it replaces (``diff._fold_layer_loop``: an ``fma`` launch a layer,
    then ``_Fma``'s float64 backward), bit for bit (no gradient value may
    differ); device ms by CUDA
    events (best of ``reps``) of each kernel beside its byte bound and of
    the eager loop's forward and backward, the yardstick.  Bytes: the
    forward reads the layers and writes t ([B, P]), the unclipped and the
    clipped image; the backward reads the image's gradient, the unclipped
    image, t and the B - 1 layers behind the first, and writes the layers'
    gradient.  Returns the kernels' times and max |diff| for the
    ``kernels`` line, whose launch counts are the main path's (phase 27
    (b))."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import composite as comp

    rng = np.random.default_rng(21)
    host = rng.uniform(0.0, 0.4, size=(num_layers, pixels, 4)).astype(np.float32)
    opaque = np.flatnonzero(rng.random(pixels) < 0.1)
    host[rng.integers(0, num_layers, opaque.size), opaque, 3] = 1.0
    colors = torch.from_numpy(host).to(dev)
    order = torch.from_numpy(rng.permutation(num_layers)).to(dev)
    g = torch.from_numpy(rng.uniform(-1, 1, (pixels, 4)).astype(np.float32)).to(dev)

    def run(fold):
        layers = colors.clone().requires_grad_(True)
        image = fold(layers, order)
        image.backward(g)
        return image.detach(), layers.grad

    comp.fold_diff_forward.launches = comp.fold_diff_backward.launches = 0
    image, grad = run(comp.fold_diff)
    torch.cuda.synchronize()
    launches = (comp.fold_diff_forward.launches, comp.fold_diff_backward.launches)
    assert launches == (1, 1), launches
    want_image, want_grad = run(diff._fold_layer_loop)
    assert torch.equal(image.view(torch.int32), want_image.view(torch.int32))
    assert float(want_image[:, 3].max()) == 1.0
    differ = int((grad.view(torch.int32) != want_grad.view(torch.int32)).sum())
    grad_d = float((grad - want_grad).abs().max())
    log(f"phase 27: (d) the fold against the eager loop on the card: image bit for bit; "
        f"layers' gradient: {differ} values differ, max |diff| {grad_d:.3g}")
    assert differ == 0, (differ, grad_d)
    with torch.no_grad():
        out = comp.fold_diff_forward(colors, order, keep=True)
        ref = comp.fold_diff_forward_reference(colors, order, keep=True)
        fwd_d = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        (bare, *none), (bare_ref, *_) = (comp.fold_diff_forward(colors, order),
                                         comp.fold_diff_forward_reference(colors, order))
        assert none == [None, None]
        fwd_d = max(fwd_d, float((bare - bare_ref).abs().max()))
        bwd_d = float((comp.fold_diff_backward(g, colors, order, *out[1:])
                       - comp.fold_diff_backward_reference(g, colors, order, *ref[1:]))
                      .abs().max())
    assert fwd_d == 0.0 and bwd_d == 0.0, (fwd_d, bwd_d)

    def best(fn):
        fn()
        return min(event_ms(torch, fn) for _ in range(reps))

    def best_backward(fold):
        times = []
        for _ in range(reps + 1):
            layers = colors.clone().requires_grad_(True)
            image = fold(layers, order)
            times.append(event_ms(torch, lambda: image.backward(g)))
        return min(times[1:])

    with torch.no_grad():
        fwd_ms = best(lambda: comp.fold_diff_forward(colors, order, keep=True))
        bwd_ms = best(lambda: comp.fold_diff_backward(g, colors, order, *out[1:]))
    leaf = colors.detach().requires_grad_(True)  # the loop records its graph
    loop_fwd_ms = best(lambda: diff._fold_layer_loop(leaf, order))
    loop_bwd_ms = best_backward(diff._fold_layer_loop)
    layer, plane = pixels * 16, pixels * 4
    fwd_bytes = num_layers * layer + num_layers * plane + 2 * layer
    bwd_bytes = 2 * layer + num_layers * plane + (num_layers - 1) * layer + num_layers * layer
    records = {}
    for name, ms, loop_ms, nbytes, d in (
            ("fold_diff_forward", fwd_ms, loop_fwd_ms, fwd_bytes, fwd_d),
            ("fold_diff_backward", bwd_ms, loop_bwd_ms, bwd_bytes, bwd_d)):
        b_ms, by = bound(nbytes, 0)
        records[name] = dict(max_abs_err=d, ms=ms, plain_ms=loop_ms, bound_ms=b_ms,
                             bound_by=by)
        log(f"phase 27: {smi}: (d) {name}, {num_layers} layers x {pixels} pixels: "
            f"{ms:.4f} ms (CUDA events, best of {reps}), vs its plain version max "
            f"|diff| {d:.3g}; the eager loop {loop_ms:.4f} ms; bound {b_ms:.5f} ms "
            f"({by}: {nbytes} B), at {b_ms / ms:.4f} of it")
    return records


def diff_needs(dm, which: str):
    return DIFF_NEEDS[which] + (True,) * (dm.DIFFERENTIABLE - 2)


def diff_backward_breakdown(torch, dm, m, cfg, grad, ckpt, best) -> dict:
    """The backward kernel's device ms under each ``DIFF_NEEDS`` entry,
    ``best(fn)`` timing each: with both gradients, without the LUT's,
    without the data's, and with neither (the replay and the adjoint's
    arithmetic, with the per-pair and per-block sums)."""
    return {f"backward_{which}": best(lambda w=which: dm.diffmarch_backward(
        m, cfg, grad, ckpt, diff_needs(dm, w))) for which in DIFF_NEEDS}


def diff_backward_vs_plain(torch, dm, m, cfg, grad, ckpt):
    """[(which, max over the formed gradients of max |kernel - plain| over
    max |plain|)] of the backward kernel against its plain version on the
    same device, under each ``DIFF_NEEDS`` entry."""
    out = []
    for which in DIFF_NEEDS:
        needs = diff_needs(dm, which)
        got = dm.diffmarch_backward(m, cfg, grad, ckpt, needs)
        want = dm.march_backward_reference(m, cfg, grad, needs)
        rel = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            if i >= 2 or needs[i]:
                err = float((g - w).abs().max()) if g.numel() else 0.0
                scale = float(w.abs().max()) if w.numel() else 0.0
                rel = max(rel, err / scale if scale else err)
            else:
                assert float(g.abs().max()) == 0.0 if g.numel() else True, which
        out.append((which, rel))
    return out


def diff_active_steps(torch, dm, m, cfg) -> dict:
    """From a plain run of the march (untimed): the active steps a hit
    (brick, pixel) pair, their quantiles over the pairs with any, and the
    share of lanes busy in 32-pixel warps of one brick while the warp's
    longest lane works, for the active steps and for the steps marched
    (a step before the box exit with the opacity below 1)."""
    num_bricks, num_pixels = m.d0.shape
    acc = torch.zeros_like(m.d0)
    count = torch.zeros(m.d0.shape, dtype=torch.int32, device=m.d0.device)
    marched = torch.zeros_like(count)
    with torch.no_grad():
        for k in range(cfg.num_steps):
            st = dm._step(m, cfg, float(k))
            live = m.hit & (acc < 1.0)
            marched += (live & (st.dist < m.tmax)).int()
            active = st.gate & live
            count += active.int()
            acc = acc + torch.where(active, st.s[..., 3] * (1.0 - acc), 0.0)
            del st
    busy = count[count > 0].float()
    q = torch.quantile(busy[:2 ** 24], torch.tensor([0.5, 0.9, 0.99], device=busy.device))

    def lanes(c):
        if num_pixels % 32:
            return float("nan")
        w = c.reshape(num_bricks, -1, 32)
        top = w.max(-1).values
        return float(w.sum()) / max(float(top.sum()) * 32, 1.0)

    return {"pairs": num_bricks * num_pixels, "hit_pairs": int(m.hit.sum()),
            "pairs_with_samples": int((count > 0).sum()),
            "samples": int(count.sum()),
            "steps_marched": int(marched.sum()),
            "active_steps_p50_p90_p99_max": [float(v) for v in q] + [float(busy.max())],
            "active_mean_per_hit_pair": float(count.sum()) / max(int(m.hit.sum()), 1),
            "warp_lane_share_active": lanes(count),
            "warp_lane_share_marched": lanes(marched)}


def diff_graph_spread(torch, diff, repeats: int) -> dict:
    """``repeats`` runs of the transfer-function fitting step of
    tests/test_torch_cuda.py::test_diff_fitting_step_replays_as_cuda_graph
    on the 6^3 scene: five eager steps, and two warm-up steps on a side
    stream, then one captured and replayed three times; returns the
    largest relative difference, graph against eager, of the losses and
    of the LUT, and across repeats of the eager losses."""
    name, args, static = diff_scenes(torch)[0]
    dev = torch.device("cuda")
    targs = list(diff.args_from_arrays(args, dev))
    targs[10] = float(args[10])
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

    loss_rel, lut_rel, eager_runs = 0.0, 0.0, []
    for _ in range(repeats):
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
        with torch.cuda.graph(graph):
            loss = step_g()
        for _ in range(3):
            graph.replay()
            graphed.append(float(loss))
        loss_rel = max(loss_rel, max(abs(g - e) / abs(e) for g, e in zip(graphed, eager)))
        lut_rel = max(lut_rel, float((lut_g - lut_e).abs().max())
                      / float(lut_e.abs().max()))
        eager_runs.append(eager)
    runs = np.asarray(eager_runs)
    return {"repeats": repeats, "loss_rel_graph_vs_eager": loss_rel,
            "lut_rel_graph_vs_eager": lut_rel,
            "eager_loss_rel_spread": float((np.abs(runs - runs[0]) / np.abs(runs[0])).max()),
            "within_1e-5": bool(loss_rel <= 1e-5 and lut_rel <= 1e-5)}


def diff_phase(torch, dev, smi: str, reset_counts, counts, diff_counts,
               full: int = 1024, grad_size: int = 512, example_args=()) -> dict:
    """Phase 27, the differentiable path (``amrvolumerenderer_torch.diff``:
    the ray set-up in PyTorch, the march one autograd node whose forward,
    backward and tangent are ``ops/csrc/diffmarch.cu`` on the card).
    (a) each scene of ``diff_scenes`` on the card against the CPU, and its
    march's three kernels against their plain versions on the card and on
    the CPU: forward at max |diff| 0 with the same non-finite pattern,
    backward and tangent at DIFF_GRAD_REL of each output's scale; (b)
    bench.py's 3-level scene through ``diff.prepare_geometry`` (13 bricks
    padded to 64^3, 224 steps), the forward at ``full``^2 under
    ``no_grad`` and ``loss.backward()`` with respect to data and LUT at
    ``grad_size``^2 with ``remat=True``, each timed with its peak memory,
    driven with the launch counts set to 0 just before and read just after
    (one forward launch a call, one backward launch with the gradient, one
    pair list, as many fold launches, DIFF_FMA_LAUNCHES fma launches, no
    other kernel); each march
    launch of those runs held once against its plain version (untimed, with
    the valid-sample count), each fma and fold launch of a checked rerun of
    each call held as it returns against its plain version, then the kernels
    timed by CUDA events and the plain versions by wall clock, beside
    their bounds; (c) both fitting examples, run together with their
    defaults.  Returns the kernels' records for the ``kernels`` line.
    Every check asserts."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm
    from amrvolumerenderer_torch.renderer import auto_orbit_camera, compute_global_bounds

    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    from amrvolumerenderer_torch.ops import numerics as nm

    records = {name: dict(launches=0, max_abs_err=0.0)
               for name in ("diffmarch_forward", "diffmarch_backward", "diffmarch_pairs",
                            "fma", "fold_diff_forward", "fold_diff_backward")}

    def run(args, static, weights, argnums, device):
        targs = list(diff.args_from_arrays(args, device))
        for i in argnums:
            targs[i].requires_grad_(True)
        image = diff.render_image_diff(*targs, **static)
        (image * torch.from_numpy(weights).to(device)).sum().backward()
        with torch.no_grad():
            _, depth = diff.render_layers_diff(*targs, **static)
        return (image.detach().cpu().numpy(), depth.cpu().numpy(),
                [targs[i].grad.cpu().numpy() for i in argnums])

    def camera_terms(args, static, weights, argnum):
        """Per component of camera argument ``argnum``: the sum over pixels
        of |weights * d image / d component| (forward mode on the CPU),
        the scale a reordered sum of the gradient's terms rounds against."""
        import torch.autograd.forward_ad as fwAD

        targs = list(diff.args_from_arrays(args, cpu))
        base, terms = targs[argnum], []
        for c in range(base.numel()):
            tangent = torch.zeros(base.numel())
            tangent[c] = 1.0
            with fwAD.dual_level():
                full = list(targs)
                full[argnum] = fwAD.make_dual(base, tangent.reshape(base.shape))
                column = fwAD.unpack_dual(diff.render_image_diff(
                    *full, remat=False, **static)).tangent
            terms.append(float((column * torch.from_numpy(weights)).abs().sum()))
        return np.asarray(terms).reshape(base.shape)

    @contextlib.contextmanager
    def recorded_marches():
        """``[m, cfg, cotangent]`` of every march the diff path makes inside
        the block (``diff.py`` looks ``dm.march`` up when it calls it); the
        cotangent is what the march's output receives backward, or None."""
        inner, seen = dm.march, []

        def record(m, cfg):
            out = inner(m, cfg)
            entry = [m, cfg, None]
            seen.append(entry)
            if out.requires_grad:
                out.register_hook(lambda g: entry.__setitem__(2, g))
            return out

        dm.march = record
        try:
            yield seen
        finally:
            dm.march = inner

    def device_diff(a, b):
        """(same non-finite pattern, max |diff| of the finite entries)."""
        fa, fb = torch.isfinite(a), torch.isfinite(b.to(a.device))
        both = fa & fb
        d = float((a - b.to(a.device)).abs()[both].max()) if bool(both.any()) else 0.0
        return bool(torch.equal(fa, fb)), d

    @contextlib.contextmanager
    def checked_fmas():
        """``[(shape, same non-finite pattern, max |diff|)]`` of every
        ``numerics.fma`` kernel launch inside the block, each held as it
        returns against ``fma_reference`` on the same card operands; the
        calls still go through the counted wrapper."""
        inner, seen = nm._fma_launch, []

        def check(*ops):
            out = inner(*ops)
            same, d = device_diff(out, nm.fma_reference(*ops))
            seen.append((tuple(out.shape), same, d))
            return out

        nm._fma_launch = check
        try:
            yield seen
        finally:
            nm._fma_launch = inner

    def hold_fmas(label, fmas):
        """The launches ``checked_fmas`` saw, as many as the counter says
        and DIFF_FMA_LAUNCHES on the card, each at max |diff| 0."""
        worst = max((d for _, _, d in fmas), default=0.0)
        off = [f for f in fmas if not (f[1] and f[2] == 0.0)]
        log(f"{label}: {len(fmas)} numerics.fma launches ({nm.fma.launches} counted), "
            f"each against fma_reference on the same operands: max |diff| {worst:.3g}, "
            f"{len(off)} off; shapes {sorted(set(f[0] for f in fmas))}")
        assert len(fmas) == nm.fma.launches == (DIFF_FMA_LAUNCHES if on_card else 0), \
            (label, len(fmas), nm.fma.launches)
        assert not off, (label, off)
        records["fma"]["max_abs_err"] = max(records["fma"]["max_abs_err"], worst)

    @contextlib.contextmanager
    def checked_folds():
        """``{name: [(keep, same non-finite pattern, max |diff|)]}`` of every
        launch of the fold's two kernels inside the block, each held as it
        returns against its plain version on the same card operands (the
        forward's kept t and unclipped image too); the calls still go
        through the counted wrappers, which ``fold_diff`` looks up when it
        calls them."""
        from amrvolumerenderer_torch.ops import composite as comp

        inner_f, inner_b = comp.fold_diff_forward, comp.fold_diff_backward
        seen = {"fold_diff_forward": [], "fold_diff_backward": []}

        def forward(out, colors, order, keep=False):
            with torch.no_grad():
                ref = comp.fold_diff_forward_reference(colors, order, keep)
                held = [device_diff(a, b) for a, b in zip(out, ref) if a is not None]
            assert (out[1] is None) == (ref[1] is None) == (not keep)
            seen["fold_diff_forward"].append(
                (keep, all(h[0] for h in held), max(h[1] for h in held)))

        def backward(out, grad_image, colors, order, trans, pre):
            with torch.no_grad():
                same, d = device_diff(out, comp.fold_diff_backward_reference(
                    grad_image, colors, order, trans, pre))
            seen["fold_diff_backward"].append((True, same, d))

        comp.fold_diff_forward = HeldLaunch(inner_f, forward)
        comp.fold_diff_backward = HeldLaunch(inner_b, backward)
        try:
            yield seen
        finally:
            comp.fold_diff_forward, comp.fold_diff_backward = inner_f, inner_b

    def hold_folds(label, folds, got):
        """The fold launches ``checked_folds`` saw, as many as the counters
        in ``got`` say, the forward's with ``keep`` (its kept outputs) only
        with the gradient, each at max |diff| 0."""
        for name, seen in folds.items():
            worst = max((d for _, _, d in seen), default=0.0)
            off = [f for f in seen if not (f[1] and f[2] == 0.0)]
            log(f"{label}: {len(seen)} {name} launches ({got[name]} counted, keep "
                f"{[f[0] for f in seen]}), each against its plain version on the same "
                f"operands: max |diff| {worst:.3g}, {len(off)} off")
            assert len(seen) == got[name] and not off, (label, name, seen, got)
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], worst)
        assert [f[0] for f in folds["fold_diff_forward"]] == (
            [bool(got["fold_diff_backward"])] * got["fold_diff_forward"]), (label, folds)

    def rel_errors(got, want):
        """Per output, max |got - want| over max |want| (0 where both are
        0), and the largest max |got - want|."""
        rel, worst_abs = [], 0.0
        for g, w in zip(got, want):
            err = float((g - w.to(g.device)).abs().max()) if g.numel() else 0.0
            scale = float(w.abs().max()) if w.numel() else 0.0
            rel.append(err / scale if scale else err)
            worst_abs = max(worst_abs, err)
        return rel, worst_abs

    @torch.no_grad()
    def hold_forward(label, m, cfg, plain_cpu=True):
        """The forward kernel (this call's launch) against the plain
        version on the card (and on the CPU): max |diff| 0, same non-finite
        pattern.  Returns (kernel output, checkpoints, valid samples)."""
        out, ckpt = dm.diffmarch_forward(m, cfg, keep=True)
        plain, samples = dm.march_forward_reference(m, cfg, count_samples=True)
        same, d = device_diff(out, plain)
        msg = f"{label}: forward kernel vs plain on {dev}: max |diff| {d:.3g}, " \
              f"non-finite pattern same {same}"
        checks, d_c = [same and d == 0.0], 0.0
        if plain_cpu:
            same_c, d_c = device_diff(out, dm.march_forward_reference(
                dm.MarchInputs(*(t.detach().cpu() for t in m)), cfg))
            msg += f"; vs plain on the CPU: max |diff| {d_c:.3g}, same {same_c}"
            checks.append(same_c and d_c == 0.0)
        log(msg + f"; {int(samples)} valid samples")
        records["diffmarch_forward"]["max_abs_err"] = max(
            records["diffmarch_forward"]["max_abs_err"], d, d_c)
        assert all(checks), label
        return out, ckpt, int(samples)

    @torch.no_grad()
    def hold_backward(label, m, cfg, grad, ckpt, needs=(True,) * dm.DIFFERENTIABLE,
                      plain_cpu=True):
        """The backward kernel against the plain version on the card (and
        on the CPU) at DIFF_GRAD_REL of each gradient's scale."""
        got = dm.diffmarch_backward(m, cfg, grad, ckpt, needs)
        fields = [f for f, n in zip(dm.MarchInputs._fields, needs) if n]
        got = [g for g, n in zip(got, needs) if n]
        want = [g for g, n in zip(dm.march_backward_reference(m, cfg, grad, needs), needs)
                if n]
        rel, worst_abs = rel_errors(got, want)
        msg = (f"{label}: backward kernel vs plain on {dev}, max |diff| over max |g| ("
               + ", ".join(f"{f} {r:.3g}" for f, r in zip(fields, rel)) + ")")
        if plain_cpu:
            mc = dm.MarchInputs(*(t.detach().cpu() for t in m))
            want_c = [g for g, n in zip(dm.march_backward_reference(
                mc, cfg, grad.cpu(), needs), needs) if n]
            rel_c, abs_c = rel_errors([g.cpu() for g in got], want_c)
            msg += ", vs plain on the CPU (" + ", ".join(f"{r:.3g}" for r in rel_c) + ")"
            rel, worst_abs = rel + rel_c, max(worst_abs, abs_c)
        log(msg)
        records["diffmarch_backward"]["max_abs_err"] = max(
            records["diffmarch_backward"]["max_abs_err"], worst_abs)
        assert max(rel) <= DIFF_GRAD_REL, (label, rel)
        return got

    @torch.no_grad()
    def hold_tangent(label, m, cfg):
        """The tangent kernel against the plain version on the card and on
        the CPU at DIFF_GRAD_REL of the tangent's scale; seeded tangents in
        every differentiable input."""
        rng = np.random.default_rng(23)
        tangents = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
            np.float32)).to(t.device) for t in m[:dm.DIFFERENTIABLE]]
        got = dm.diffmarch_tangent(m, cfg, tangents)
        (rel,), _ = rel_errors([got], [dm.march_tangent_reference(m, cfg, tangents)])
        (rel_c,), _ = rel_errors([got.cpu()], [dm.march_tangent_reference(
            dm.MarchInputs(*(t.detach().cpu() for t in m)), cfg,
            [t.cpu() for t in tangents])])
        log(f"{label}: tangent kernel vs plain, max |diff| over max |t|: on {dev} "
            f"{rel:.3g}, on the CPU {rel_c:.3g}")
        assert max(rel, rel_c) <= DIFF_GRAD_REL, (label, rel, rel_c)

    def hold_march(label, m, cfg):
        """A march's three kernels against their plain versions: the
        forward, the backward under each ``DIFF_NEEDS`` entry and the
        tangent."""
        _, ckpt, _ = hold_forward(label, m, cfg)
        grad = torch.from_numpy(np.random.default_rng(3).uniform(
            -1, 1, size=(*m.d0.shape, 4)).astype(np.float32)).to(dev)
        for which in DIFF_NEEDS:
            hold_backward(f"{label}, gradients {which}", m, cfg, grad, ckpt,
                          diff_needs(dm, which))
        hold_tangent(label, m, cfg)

    def expect(label, forward, backward):
        got, others = diff_counts(), counts()
        want = {"diffmarch_forward": forward if on_card else 0,
                "diffmarch_backward": backward if on_card else 0,
                "diffmarch_tangent": 0,
                "diffmarch_pairs": forward if on_card else 0,
                "fold_diff_forward": forward if on_card else 0,
                "fold_diff_backward": backward if on_card else 0,
                "diffpairs_build": 0, "diffpairs_fold_forward": 0,
                "diffpairs_fold_backward": 0}
        log(f"{label}: launches {got}, other kernels {others}")
        assert got == want and not any(others.values()), (label, got, others)
        return got

    # (a) card against CPU: the image at ATOL, data and LUT gradients at
    # DIFF_GRAD_REL of the largest, and each camera gradient (a sum over
    # the frame whose terms cancel) at DIFF_GRAD_REL of its terms' sum; the
    # march's kernels against their plain versions on the scene's inputs
    for name, args, static in diff_scenes(torch):
        n = static["width"] * static["height"]
        w = np.random.default_rng(7).uniform(0, 1, size=(n, 4)).astype(np.float32)
        argnums = (0, 4, 6, 7, 8, 9, 10)  # data, LUT, eye, forward, right, up, fov
        with recorded_marches() as marches:
            image, depth, grads = run(args, static, w, argnums, dev)
        image_c, depth_c, grads_c = run(args, static, w, argnums, cpu)
        same, d = max_diff(image, image_c)
        same_d, d_d = max_diff(depth, depth_c)
        rel = [float(np.abs(g - r).max() / np.abs(r).max())
               for g, r in zip(grads[:2], grads_c[:2])]
        for i, g, r in zip(argnums[2:], grads[2:], grads_c[2:]):
            terms = camera_terms(args, static, w, i)
            assert np.all(terms > 0.0), (i, terms)
            rel.append(float((np.abs(g - r) / terms).max()))
        log(f"phase 27: {name} {static['width']}x{static['height']}, card vs CPU: "
            f"image max |diff| {d:.3g}, depth max |diff| {d_d:.3g}, non-finite "
            f"patterns same {same and same_d}; gradient max |diff| over max |g| "
            f"(data, LUT) and over the sum of the terms (eye, forward, right, up, "
            f"fov): {', '.join(f'{r:.3g}' for r in rel)}; alpha max "
            f"{image_c[:, 3].max():.9g}")
        assert same and same_d and d <= ATOL and d_d <= ATOL, (d, d_d)
        assert image_c[:, 3].max() > 0.0
        assert max(rel) <= DIFF_GRAD_REL, rel
        m, cfg, _ = marches[0]
        hold_march(f"phase 27: {name}", m, cfg)
        del marches, m
    # the worst contention: every sample in one LUT bin and on the same cells
    hold_march("phase 27: the contention scene, 2^3 cells at 64x64",
               *diff_contention_scene(torch, dev))

    # (b) full size, through the dense layers (render_layers_diff and the
    # fold: on the card the route of the sharded path and of forward mode;
    # the card's main path is the pair path, phase 27 (d))
    def dense(*a, **kw):
        colors, _ = diff.render_layers_diff(*a, **kw)
        return diff.composite_layers_diff(colors, diff.default_order(a[1], a[2], a[6], a[7]))

    geometry = three_level_geometry()
    camera = auto_orbit_camera(compute_global_bounds(geometry))
    args, static = diff.prepare_geometry(geometry, camera, width=full, height=full,
                                         device=dev)
    log(f"phase 27: prepare_geometry 3-level: data {tuple(args[0].shape)}, "
        f"{static['num_steps']} march steps")
    for attempt in range(2):
        reset_counts()  # counted run: the forward at full size
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30 if on_card else float("nan")
        with recorded_marches() as forwards:
            t0 = time.perf_counter()
            with torch.no_grad():
                image = dense(*args, **static)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
        covered = float((image[:, 3] > 0).float().mean())
        log(f"phase 27: {smi}: the dense layers, 3-level {full}x{full} under "
            f"no_grad (run {attempt + 1}): {ms:.3f} ms wall, peak device memory "
            f"{peak:.3f} GiB, {peak - held:.3f} GiB above the {held:.3f} GiB held "
            f"before it; covered share {covered:.4f}; fma launches {nm.fma.launches}")
        expect(f"phase 27: the {full}x{full} forward (run {attempt + 1})", 1, 0)
        assert nm.fma.launches == (DIFF_FMA_LAUNCHES if on_card else 0), nm.fma.launches
    assert image.shape == (full * full, 4) and bool(torch.isfinite(image).all())
    assert ALPHA_FRACTION[0] < covered < ALPHA_FRACTION[1], covered
    del image
    (m_full, cfg, _), = forwards
    reset_counts()  # checked run: each fma and fold launch of the same call held at once
    with checked_fmas() as fmas, recorded_fmas(nm) as fma_ops, checked_folds() as folds, \
            torch.no_grad():
        dense(*args, **static)
    sync()
    got = expect(f"phase 27: the {full}x{full} forward (checked run)", 1, 0)
    hold_fmas(f"phase 27: the {full}x{full} forward (checked run)", fmas)
    hold_folds(f"phase 27: the {full}x{full} forward (checked run)", folds, got)
    assert len(fma_ops) == len(fmas), (len(fma_ops), len(fmas))
    _, _, samples_full = hold_forward(f"phase 27: the {full}x{full} frame's march",
                                      m_full, cfg, plain_cpu=False)
    small = dict(static, width=grad_size, height=grad_size)
    for attempt in range(2):
        data = args[0].clone().requires_grad_(True)
        table = args[4].clone().requires_grad_(True)
        reset_counts()  # counted run: the gradient, the main path
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30 if on_card else float("nan")
        with recorded_marches() as marches:
            t0 = time.perf_counter()
            image = dense(data, *args[1:4], table, *args[5:],
                                           remat=True, **small)
            loss = (image * image).mean()
            sync()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            loss.backward()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
        log(f"phase 27: {smi}: loss.backward() w.r.t. data and LUT, 3-level "
            f"{grad_size}x{grad_size}, remat=True (run {attempt + 1}): forward "
            f"{fwd_ms:.3f} ms + backward {ms - fwd_ms:.3f} ms = {ms:.3f} ms wall, "
            f"peak device memory {peak:.3f} GiB, {peak - held:.3f} GiB above the "
            f"{held:.3f} GiB held before it")
        got = expect(f"phase 27: the {grad_size}x{grad_size} gradient (run "
                     f"{attempt + 1})", 1, 1)
        # numerics.fma: the eager ray set-up's FMA sites
        got["fma"] = nm.fma.launches
        log(f"phase 27: the {grad_size}x{grad_size} gradient (run {attempt + 1}): "
            f"fma launches {got['fma']}")
        assert got["fma"] == (DIFF_FMA_LAUNCHES if on_card else 0), got
    for name in records:
        records[name]["launches"] = got[name]
    for g in (data.grad, table.grad):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
    del data, table, image, loss
    (m_grad, cfg_grad, g_out), = marches
    data = args[0].clone().requires_grad_(True)
    table = args[4].clone().requires_grad_(True)
    reset_counts()  # checked run: each fma and fold launch of the same call held at once
    with checked_fmas() as fmas, checked_folds() as folds:
        image = dense(data, *args[1:4], table, *args[5:], remat=True,
                                       **small)
        (image * image).mean().backward()
    sync()
    got = expect(f"phase 27: the {grad_size}x{grad_size} gradient (checked run)", 1, 1)
    hold_fmas(f"phase 27: the {grad_size}x{grad_size} gradient (checked run)", fmas)
    hold_folds(f"phase 27: the {grad_size}x{grad_size} gradient (checked run)", folds, got)
    del data, table, image, fmas, folds
    needs = tuple(t.requires_grad for t in m_grad[:dm.DIFFERENTIABLE])
    # the forward is deterministic: its rerun keeps the same checkpoints
    _, ckpt, samples_grad = hold_forward(f"phase 27: the {grad_size}x{grad_size} "
                                         "gradient's march", m_grad, cfg_grad,
                                         plain_cpu=False)
    hold_backward(f"phase 27: the {grad_size}x{grad_size} gradient's backward "
                  "launch replayed", m_grad, cfg_grad, g_out, ckpt, needs,
                  plain_cpu=False)
    if on_card:
        for name, m, c, samples, fn, plain, nbytes, flops in (
                ("diffmarch_forward", m_full, cfg, samples_full,
                 lambda: dm.diffmarch_forward(m_full, cfg),
                 lambda: dm.march_forward_reference(m_full, cfg),
                 sum(t.numel() * t.element_size() for t in m_full)
                 + m_full.d0.numel() * 16, samples_full * diff_sample_flops(cfg)),
                ("diffmarch_backward", m_grad, cfg_grad, samples_grad,
                 lambda: dm.diffmarch_backward(m_grad, cfg_grad, g_out, ckpt, needs),
                 lambda: dm.march_backward_reference(m_grad, cfg_grad, g_out, needs),
                 sum(t.numel() * t.element_size()
                     for t in (*m_grad, g_out, ckpt.checkpoints, ckpt.counts))
                 + 4 * int(ckpt.counts.sum())  # the hit pairs of the forward's list
                 + m_grad.data.numel() * 4 + m_grad.luts.numel() * 8
                 + m_grad.d0.numel() * 4 + m_grad.directions.numel() * 4,
                 samples_grad * (diff_sample_flops(cfg_grad) + DIFF_ADJOINT_FLOPS))):
            with torch.no_grad():  # the recorded inputs include leaves that require grad
                kernel_ms = min(event_ms(torch, fn) for _ in range(3))
                t0 = time.perf_counter()
                plain()
                sync()
                plain_ms = (time.perf_counter() - t0) * 1e3
            b_ms, by = bound(nbytes, flops)
            records[name].update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=by)
            log(f"phase 27: {smi}: {name}, {m.d0.shape[0]} bricks x {m.d0.shape[1]} "
                f"pixels, {c.num_steps} steps, {samples} valid samples: "
                f"{kernel_ms:.4f} ms (CUDA events, best of 3), plain {plain_ms:.3f} ms "
                f"(wall); bound {b_ms:.5f} ms ({by}: {nbytes} B, {flops} operations), "
                f"kernel at {b_ms / kernel_ms:.4f} of its bound")
        # the backward's breakdown by the gradients it forms, the forward's
        # floor (every pair a miss: the list and the zero rows) and the pair
        # list alone, as the forward launches it
        best = lambda fn: min(event_ms(torch, fn) for _ in range(3))  # noqa: E731
        with torch.no_grad():
            split = diff_backward_breakdown(torch, dm, m_grad, cfg_grad, g_out, ckpt, best)
            miss = m_full._replace(hit=torch.zeros_like(m_full.hit))
            floor_ms = best(lambda: dm.diffmarch_forward(miss, cfg))
            rows = torch.empty((*m_full.d0.shape, 4), dtype=torch.float32, device=dev)
            pairs_ms = best(lambda: dm.diffmarch_pairs(m_full.hit, rows))
            t0 = time.perf_counter()
            want_pixels, want_counts = dm.hit_pairs_reference(m_full.hit)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            pixels, got_counts = dm.diffmarch_pairs(m_full.hit)
        assert torch.equal(got_counts, want_counts)
        index = torch.arange(pixels.shape[1], device=dev)
        listed = torch.where(index < got_counts[:, None], pixels, -1)
        # each kernel block's hits in pixel order, the blocks in any order
        wrong = int((torch.sort(torch.where(listed < 0, pixels.shape[1], listed)).values
                     != torch.where(want_pixels < 0, pixels.shape[1], want_pixels)).sum())
        assert wrong == 0, wrong
        hits = int(want_counts.sum())
        nbytes = m_full.hit.numel() * (1 + 16) - 12 * hits + 4 * len(want_counts)
        b_ms, by = bound(nbytes, 0)
        records["diffmarch_pairs"].update(ms=pairs_ms, plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by=by)
        # numerics.fma on the depth's FMA site, the entry points of every
        # (brick, pixel) pair at 1024^2, against its plain version and one
        # torch.addcmul (which need not round once)
        ops = (m_full.directions, m_full.d0[..., None], m_full.eye)
        with torch.no_grad():
            got_f = nm.fma(*ops)
            want_f = nm.fma_reference(*ops)
            fma_ms = best(lambda: nm.fma(*ops))
            lib_ms = best(lambda: torch.addcmul(ops[2], ops[0], ops[1]))
            sync()
            t0 = time.perf_counter()
            nm.fma_reference(*ops)
            sync()
            fma_plain_ms = (time.perf_counter() - t0) * 1e3
        same, d = device_diff(got_f, want_f)
        assert same and d == 0.0, d
        f_bytes = sum(t.numel() * 4 for t in ops) + got_f.numel() * 4
        f_ms, f_by = bound(f_bytes, 2 * got_f.numel())
        records["fma"].update(max_abs_err=d, ms=fma_ms, plain_ms=fma_plain_ms,
                              bound_ms=f_ms, bound_by=f_by, library_ms=lib_ms)
        log(f"phase 27: {smi}: numerics.fma, {tuple(got_f.shape)} from "
            f"{tuple(ops[0].shape)} x {tuple(ops[1].shape)} + {tuple(ops[2].shape)}: "
            f"{fma_ms:.4f} ms (CUDA events, best of 3), vs its plain version max |diff| "
            f"{d:.3g}, plain {fma_plain_ms:.3f} ms (wall), torch.addcmul {lib_ms:.4f} ms; "
            f"bound {f_ms:.5f} ms ({f_by}: {f_bytes} B), at {f_ms / fma_ms:.4f} of it")
        # every distinct fma launch of the full-size call, each against its
        # byte bound and one torch.addcmul on the same operands
        log(f"phase 27: {smi}: the {len(fma_ops)} numerics.fma launches of the "
            f"{full}x{full} call by launch shape (CUDA events, best of 3): "
            + fma_times_line(fma_launch_times(torch, nm, fma_ops)))
        del ops, got_f, want_f
        log(f"phase 27: {smi}: the backward at {grad_size}x{grad_size} by the gradients "
            f"it forms (CUDA events, best of 3, ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"; the forward at {full}x{full} with every pair a miss (its floor) "
            f"{floor_ms:.4f} ms; diffmarch_pairs alone {pairs_ms:.4f} ms ({hits} hit "
            f"pairs of {m_full.hit.numel()}, {wrong} listed wrong), plain {plain_ms:.3f} "
            f"ms; bound {b_ms:.5f} ms ({by}: {nbytes} B), at {b_ms / pairs_ms:.4f} of it")
    del fma_ops
    del args, m_full, m_grad, g_out, ckpt, forwards, marches
    if on_card:
        torch.cuda.empty_cache()

    # (c) the examples, both at once (each is bound by its host thread)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", ex),
                               *example_args], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for ex in DIFF_EXAMPLES]
    outs = [p.communicate(timeout=600) for p in procs]
    wall = time.perf_counter() - t0
    for ex, proc, (out, err) in zip(DIFF_EXAMPLES, procs, outs):
        summary = [line for line in out.splitlines() if line.startswith("loss: ")]
        log(f"phase 27: examples/{ex} rc {proc.returncode}: "
            f"{summary[-1] if summary else err[-2000:]}")
        assert proc.returncode == 0 and len(summary) == 1, err[-2000:]
        first, final = (float(v) for v in
                        summary[0][6:].split(";")[0].split(" (")[0].split(" -> "))
        assert final < 0.5 * first, summary
    log(f"phase 27: {smi}: both examples with their defaults, run together: "
        f"{wall:.3f} s wall")
    return records


def pair_phase(torch, dev, smi: str, reset_counts, counts, diff_counts,
               full: int = 1024, grad_size: int = 512) -> dict:
    """Phase 27 (d), the card's main path of the differentiable renderer:
    ``render_image_diff`` over a view's hit (brick, pixel) pairs
    (``diff.render_image_pairs``), on bench.py's 3-level scene (13 bricks;
    the forward at ``full``^2 under ``no_grad``, the gradient with respect
    to data and LUT at ``grad_size``^2) and on the fitting cell's view of
    the turbulence field at 192^3 in 216 bricks of 32^3 (both at
    ``grad_size``^2).  Each call driven with the launch counts set to 0
    just before: one pair build, one march forward (and backward), one pair
    fold forward (and backward), no dense pair list, no dense fold, no
    other kernel; its wall time and peak memory beside the dense layers'
    (phase 27 (b)'s route); the image equal to the dense layers' bit for
    bit, the gradients at DIFF_GRAD_REL of their scale.  The pair build
    against its plain version (the same pairs, each pair's d0 and tmax bit
    for bit); the pair fold's kernels against their plain versions at max
    |diff| 0; each timed alone by CUDA events against
    ``portbench/pairs.py``'s bound.  Returns the three kernels' records
    for the ``kernels`` line.  Every check asserts."""
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import composite as comp
    from amrvolumerenderer_torch.ops import diffmarch as dm
    from amrvolumerenderer_torch.renderer import auto_orbit_camera, compute_global_bounds
    from amrvolumerenderer_torch.types import CameraParameters
    from portbench import pairs as bench_pairs
    from portbench import scenes as bench_scenes

    sync = torch.cuda.synchronize
    names = ("diffpairs_build", "diffpairs_fold_forward", "diffpairs_fold_backward")
    records = {n: dict(launches=0, max_abs_err=0.0) for n in names}
    best = lambda fn: min(event_ms(torch, fn) for _ in range(3))  # noqa: E731

    def bits(a, b):
        return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                       b.view(torch.int32)))

    def dense(*a, **kw):
        colors, _ = diff.render_layers_diff(*a, **kw)
        return diff.composite_layers_diff(colors, diff.default_order(a[1], a[2], a[6], a[7]))

    def want(forward, backward):
        return {"diffmarch_forward": forward, "diffmarch_backward": backward,
                "diffmarch_tangent": 0, "diffmarch_pairs": 0, "fold_diff_forward": 0,
                "fold_diff_backward": 0, "diffpairs_build": forward,
                "diffpairs_fold_forward": forward, "diffpairs_fold_backward": backward}

    def measured(label, fn, forward, backward):
        """``fn()`` with the counts from 0, timed (host clock, synchronised)
        with its peak memory; its launches held to ``want``."""
        reset_counts()
        sync()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        got, others = diff_counts(), counts()
        log(f"phase 27: (d) {smi}: {label}: {ms:.3f} ms wall, peak device memory "
            f"{peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held; launches {got}")
        if forward is not None:
            assert got == want(forward, backward) and not any(others.values()), (
                label, got, others)
        return out, ms, peak

    def gradient(fn, args, static):
        data = args[0].clone().requires_grad_(True)
        table = args[4].clone().requires_grad_(True)
        image = fn(data, *args[1:4], table, *args[5:], **static)
        (image * image).mean().backward()
        return image.detach(), [data.grad, table.grad]

    geometry = three_level_geometry()
    camera3 = auto_orbit_camera(compute_global_bounds(geometry))
    boxes = bench_scenes.turbulence_scene({"domain": 192, "brick": 32}, 11, dev).boxes
    host = [(b.data.cpu().numpy(), b.min_corner, b.max_corner) for b in boxes]
    view = bench_scenes.fit_views({"views": 36, "radius": 2.5, "fov_y_degrees": 45.0}, 11)[0]
    camera_t = CameraParameters(eye=view.eye, look_at=view.look_at, up=view.up,
                                fov_y_degrees=view.fov_y_degrees)
    cases = (
        ("3-level, 13 bricks", full,
         lambda size: diff.prepare_geometry(geometry, camera3, width=size, height=size,
                                            device=dev)),
        ("turbulence 192^3 in 216 bricks", grad_size,
         lambda size: diff.prepare_scene(host, camera_t, width=size, height=size,
                                         device=dev)))
    for label, size, prepare in cases:
        args, static = prepare(size)
        with torch.no_grad():
            diff.render_image_diff(*args, **static)  # sizes the pair list for these sizes
        seen, inner = [], dm.diffpairs_build
        dm.diffpairs_build = lambda *a: seen.append((inner(*a), a)) or seen[-1][0]
        try:
            with torch.no_grad():
                image, ms, peak = measured(f"{label}, {size}x{size} forward under no_grad",
                                           lambda: diff.render_image_diff(*args, **static),
                                           1, 0)
        finally:
            dm.diffpairs_build = inner
        with torch.no_grad():
            ref_image, dense_ms, dense_peak = measured(
                f"{label}, {size}x{size}, the dense layers", lambda: dense(*args, **static),
                None, None)
        log(f"phase 27: (d) {label}: the pair path's image == the dense layers' "
            f"{bits(image, ref_image)}; {ms:.3f} ms and {peak:.3f} GiB against "
            f"{dense_ms:.3f} ms and {dense_peak:.3f} GiB")
        assert bits(image, ref_image) and float(image[:, 3].max()) > 0.0
        del ref_image
        ((pairs, inputs),) = seen
        num_bricks, num_pixels = inputs[2].shape[0], inputs[1].shape[0]
        total = int(pairs.total)
        # the build against its plain version: the same pairs, d0, tmax
        ref = dm.diffpairs_build_reference(*inputs)
        keyed = []
        for lst in (pairs, ref):
            n = int(lst.total)
            key = lst.brick[:n].long() * num_pixels + lst.pixel[:n].long()
            at = torch.argsort(key)
            keyed.append((key[at], lst.d0[:n][at], lst.tmax[:n][at]))
        same_build = (int(ref.total) == total and bool(torch.equal(keyed[0][0], keyed[1][0]))
                      and bits(keyed[0][1], keyed[1][1]) and bits(keyed[0][2], keyed[1][2])
                      and bool(torch.equal(pairs.pixel_count, ref.pixel_count))
                      and bool(torch.equal(pairs.run_cnt, ref.run_cnt)))
        # the pair fold's kernels on these rows against their plain versions
        g = torch.Generator(device=dev).manual_seed(5)
        raw = torch.rand((pairs.brick.shape[0], 4), generator=g, device=dev) * 1.4 - 0.2
        grad_image = torch.rand((num_pixels, 4), generator=g, device=dev) * 2.0 - 1.0
        fold = (raw, pairs.fold_index, pairs.pixel_start, pairs.pixel_count)
        with torch.no_grad():
            out = comp.diffpairs_fold_forward(*fold, keep=True)
            out_ref = comp.diffpairs_fold_forward_reference(*fold, keep=True)
            back = comp.diffpairs_fold_backward(grad_image, *fold, *out[1:])
            back_ref = comp.diffpairs_fold_backward_reference(grad_image, *fold, *out_ref[1:])
        rows = torch.zeros(pairs.brick.shape[0], dtype=torch.bool, device=dev)
        rows[pairs.fold_index[:total].long()] = True
        # the slots and rows of a pair (a list's capacity holds more)
        kept = (out[0], out[1][:total], out[2]), (out_ref[0], out_ref[1][:total], out_ref[2])
        d_f = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(*kept))
        d_b = float((back[rows] - back_ref[rows]).abs().max()) if total else 0.0
        same_fold = all(bits(a, b) for a, b in zip(*kept)) and bits(back[rows], back_ref[rows])
        bounds = bench_pairs.view_bounds_s(num_bricks, num_pixels, total)
        times = {"diffpairs_build": best(lambda: dm._build_launch(*inputs, pairs.brick.shape[0])),
                 "diffpairs_fold_forward": best(lambda: comp.diffpairs_fold_forward(
                     *fold, keep=True)),
                 "diffpairs_fold_backward": best(lambda: comp.diffpairs_fold_backward(
                     grad_image, *fold, *out[1:]))}
        plain = {}
        for name, fn in (("diffpairs_build", lambda: dm.diffpairs_build_reference(*inputs)),
                         ("diffpairs_fold_forward",
                          lambda: comp.diffpairs_fold_forward_reference(*fold, keep=True)),
                         ("diffpairs_fold_backward",
                          lambda: comp.diffpairs_fold_backward_reference(
                              grad_image, *fold, *out_ref[1:]))):
            sync()
            t0 = time.perf_counter()
            with torch.no_grad():
                fn()
            sync()
            plain[name] = (time.perf_counter() - t0) * 1e3
        log(f"phase 27: (d) {smi}: {label}, {num_bricks} bricks x {num_pixels} pixels, "
            f"{total} hit pairs ({total / (num_bricks * num_pixels):.4f} of them): the "
            f"build vs plain the same {same_build}; the fold vs plain forward max |diff| "
            f"{d_f:.3g}, backward {d_b:.3g}, bits equal {same_fold}; "
            + "; ".join(f"{n} {times[n]:.4f} ms (CUDA events, best of 3), plain "
                        f"{plain[n]:.3f} ms (wall), bound {bounds[k] * 1e3:.5f} ms, at "
                        f"{bounds[k] * 1e3 / times[n]:.4f} of it"
                        for n, k in zip(names, ("build", "fold", "fold_backward"))))
        assert same_build and same_fold, (label, same_build, d_f, d_b)
        for n, k in zip(names, ("build", "fold", "fold_backward")):
            records[n].update(ms=times[n], plain_ms=plain[n], bound_ms=bounds[k] * 1e3,
                              bound_by="operations" if n == "diffpairs_build" else "bytes")
        del pairs, inputs, ref, raw, out, out_ref, back, back_ref, seen, image
        # the gradient at grad_size^2, pair path against the dense layers
        small = dict(static, width=grad_size, height=grad_size)
        if size != grad_size:
            args, static = prepare(grad_size)
            small = static
            with torch.no_grad():
                diff.render_image_diff(*args, **small)
        (image, grads), ms, peak = measured(
            f"{label}, {grad_size}x{grad_size} forward + backward() w.r.t. data and LUT",
            lambda: gradient(diff.render_image_diff, args, small), 1, 1)
        (want_image, want_grads), dense_ms, dense_peak = measured(
            f"{label}, {grad_size}x{grad_size} gradient, the dense layers",
            lambda: gradient(dense, args, small), None, None)
        rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads, want_grads)]
        log(f"phase 27: (d) {label}, {grad_size}x{grad_size} gradient: image == the dense "
            f"layers' {bits(image, want_image)}; data and LUT gradients max |diff| over "
            f"max |g| {rel[0]:.3g}, {rel[1]:.3g}; {ms:.3f} ms, {peak:.3f} GiB against "
            f"{dense_ms:.3f} ms, {dense_peak:.3f} GiB")
        assert bits(image, want_image) and max(rel) <= DIFF_GRAD_REL, (label, rel)
        for n in names:
            records[n]["launches"] = 1
        del args, image, grads, want_image, want_grads
        torch.cuda.empty_cache()
    return records


# phase 29: the differentiable path over a sharded brick axis
# (``diff.render_image_diff(mesh=...)``) and the two benchmark examples.
# One rank of (c): the scene from (b)'s .npz, this process's 4 shards of
# the data, LUT and eye whole; its frame and gradients saved beside a
# line with its wall time, peak memory and kernel launch counts
DIFF_RANK_RUN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from amrvolumerenderer_torch import diff, driver
from amrvolumerenderer_torch.ops import composite as comp
from amrvolumerenderer_torch.ops import diffmarch as dmk
from amrvolumerenderer_torch.ops import slicemarch as sm
from amrvolumerenderer_torch.ops import tilemarch as tm
from amrvolumerenderer_torch.parallel import directsend as ds

counted = (sm.slicemarch_render, comp.composite_pixels, comp.composite_runs,
           tm.tilemarch_render, tm.tilemarch_render_batch,
           sm.slicemarch_render_worklist_raw, comp.composite_tiles)
device = sys.argv[4]
cuda = device == "cuda"
assert driver.maybe_initialize_distributed(device)
scene = np.load(sys.argv[2])
static = json.loads(sys.argv[3])
rank = torch.distributed.get_rank()
args = list(diff.args_from_arrays([scene[f"a{i}"] for i in range(16)], device))
mesh = ds.make_mesh(8, device)
for i in (4, 6):
    args[i].requires_grad_(True)
(data,) = ds.shard_leading(mesh, args[0])
data = [None if d is None else d.clone().requires_grad_(True) for d in data]
march = (dmk.diffmarch_forward, dmk.diffmarch_backward, dmk.diffmarch_pairs,
         comp.fold_diff_forward, comp.fold_diff_backward)
for fn in counted + march:
    fn.launches = 0
if cuda:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
image = diff.render_image_diff(data, *args[1:], mesh=mesh, remat=True, **static)
image.mean().backward()
if cuda:
    torch.cuda.synchronize()
wall = time.perf_counter() - t0
np.savez(f"rank{rank}.npz", local=np.asarray(mesh.local),
         image=image.detach().cpu().numpy(),
         data=torch.cat([data[r].grad for r in mesh.local]).cpu().numpy(),
         lut=args[4].grad.cpu().numpy(), eye=args[6].grad.cpu().numpy())
print("RANK_DIFF " + json.dumps({
    "rank": rank, "wall_s": wall,
    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
    "launches": sum(fn.launches for fn in counted),
    "march": [fn.launches for fn in march]}), flush=True)
torch.distributed.destroy_process_group()
"""

# (d): an example script run as ``__main__`` (``python -c EXAMPLE_RUN ROOT
# SCRIPT ARGS...``), then the tile-march kernel's launch counts
EXAMPLE_RUN = r"""
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
from amrvolumerenderer_torch.ops import tilemarch as tm
sys.argv = sys.argv[2:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as stop:
    assert stop.code in (None, 0), stop.code
print("LAUNCHES " + json.dumps({"tilemarch": tm.tilemarch_render.launches,
                                "tilemarch_batch": tm.tilemarch_render_batch.launches}))
"""


BENCH_EXAMPLES = (("bench_scaling_torch.py", []), ("bench_orbit_torch.py", []),
                  ("bench_orbit_torch.py", ["--batch"]))


def diff_sharded_phase(torch, dev, smi: str, reset_counts, all_counts, diff_counts,
                       size: int = 512, domain: int = 64,
                       examples=BENCH_EXAMPLES) -> None:
    """Phase 29.  (a) tests/test_diff.py's sharded scene (8 bricks of 4^3,
    seed 13, 8x8, eye (0.5, 0.5, 20): its frame is empty, so its
    gradients are 0) and the same bricks seen obliquely (every brick
    drawn, tests/test_torch_diff_sharded.py), through
    ``render_image_diff(mesh=make_mesh(8, "cuda"))`` against the single
    call on the card and the 8-shard CPU mesh: frames equal, the data
    gradient at rtol 1e-6 / atol 1e-9 of the card's single call and at
    DIFF_GRAD_REL of max |g| of the CPU's, LUT at DIFF_GRAD_REL of max |g|
    and eye at DIFF_GRAD_REL of its terms' sum of both.  (b) bench_orbit's
    field at ``domain`` as 8 bricks of 32^3 (``diff.prepare_scene``) at
    ``size``^2: forward and ``backward()`` with ``remat=True`` with respect
    to data, LUT and eye, single call and D=8 in this process, wall and
    peak memory, one forward and one backward launch of the march a call
    or a shard and no other kernel, each forward launch held once against
    the plain version at max |diff| 0; frames equal, gradients as (a); the
    eye's forward-mode terms through the tangent kernel, one launch a
    component, each held against the plain version at DIFF_GRAD_REL of its
    scale (these terms scale the eye's tolerance) and the first timed
    beside its bound.  (c) the same in two processes on this card (gloo through
    pinned host memory), 4 shards each, four forward and four backward
    launches a rank: each rank's rows of the data gradient at rtol 1e-6 of
    (b)'s single call, eye and LUT equal on both ranks and within
    tolerance of one process.  (d) both benchmark examples with their
    defaults as subprocesses: rc 0, their ms/frame, kernel 1 launched.
    ``dev`` = the CPU, a smaller ``size`` and ``examples`` with ``--device
    cpu`` try the phase on a machine without a card.  Returns the tangent
    kernel's record for the ``kernels`` line."""
    import shutil
    import socket

    import torch.autograd.forward_ad as fwAD

    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm
    from amrvolumerenderer_torch.parallel import directsend as ds
    from amrvolumerenderer_torch.types import CameraParameters

    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def run(args, static, device, mesh, **kw):
        """Frame and gradients of mean(frame) w.r.t. data, LUT and eye."""
        targs = list(diff.args_from_arrays(args, device))
        for i in (0, 4, 6):
            targs[i].requires_grad_(True)
        image = diff.render_image_diff(*targs, mesh=mesh, **static, **kw)
        image.mean().backward()
        return (image.detach().cpu().numpy(),
                [targs[i].grad.cpu().numpy() for i in (0, 4, 6)])

    def eye_terms(args, static, device):
        """Per eye component, the sum over the frame of |d mean(frame) /
        d eye|'s terms (forward mode, no graph kept)."""
        targs = list(diff.args_from_arrays(args, device))
        terms = []
        with torch.no_grad():
            for c in range(3):
                with fwAD.dual_level():
                    full = list(targs)
                    full[6] = fwAD.make_dual(targs[6], torch.eye(3, device=device)[c])
                    column = fwAD.unpack_dual(diff.render_image_diff(
                        *full, remat=False, **static)).tangent
                terms.append(float(column.abs().sum()) / column.numel())
        return np.asarray(terms)

    def rel(got, want):
        """max |got - want| over max |want| (0 where both are 0)."""
        scale = float(np.abs(want).max())
        return float(np.abs(got - want).max()) / scale if scale else 0.0

    def rtol_excess(got, want):
        """The largest |got - want| / (1e-9 + 1e-6 |want|): at most 1
        where rtol 1e-6 / atol 1e-9 holds."""
        return float((np.abs(got - want) / (1e-9 + 1e-6 * np.abs(want))).max())

    def hold(tag, got, want, terms, data_rtol=True):
        """Assert the sharded tolerances and log the measured errors."""
        excess = rtol_excess(got[0], want[0])
        lut, eye = rel(got[1], want[1]), float((np.abs(got[2] - want[2]) / terms).max())
        data = rel(got[0], want[0])
        log(f"phase 29: {tag}: data gradient max |diff| over max |g| {data:.3g} "
            f"(rtol 1e-6 / atol 1e-9 excess {excess:.3g}, <= 1 holds), LUT "
            f"{lut:.3g}, eye over its terms' sum {eye:.3g}")
        assert excess <= 1.0 if data_rtol else data <= DIFF_GRAD_REL, (tag, excess, data)
        assert lut <= DIFF_GRAD_REL and eye <= DIFF_GRAD_REL, (tag, lut, eye)

    # (a) tests/test_diff.py's scene and its oblique view at 8x8
    rng = np.random.default_rng(13)
    bricks = [(rng.uniform(0.1, 0.9, size=(4, 4, 4)).astype(np.float32),
               (0.0, 0.0, float(b)), (1.0, 1.0, float(b) + 1.0)) for b in range(8)]
    views = {"test_diff": dict(eye=(0.5, 0.5, 20.0), look_at=(0.5, 0.5, 4.0)),
             "oblique": dict(eye=(2.0, 1.5, 14.0), look_at=(0.5, 0.5, 4.0),
                             fov_y_degrees=12.0)}
    mesh_card, mesh_cpu = ds.make_mesh(8, dev), ds.make_mesh(8, "cpu")
    assert mesh_card.devices == (dev,) * 8, mesh_card.devices
    for name, view in views.items():
        targs, static = diff.prepare_scene(
            bricks, CameraParameters(up=(0.0, 1.0, 0.0), **view), width=8, height=8,
            device="cpu")
        args = tuple(a.numpy() for a in targs)
        image, got = run(args, static, dev, mesh_card)
        single_image, single = run(args, static, dev, None)
        again_image, again = run(args, static, dev, None)
        cpu_image, cpu_got = run(args, static, cpu, mesh_cpu)
        terms = np.maximum(eye_terms(args, static, cpu), 1e-30)
        covered = float(single_image[:, 3].max())
        log(f"phase 29: (a) {name} 8 bricks of 4^3 at 8x8: alpha max {covered:.9g}; "
            f"frame over 8 card shards == single call {np.array_equal(image, single_image)}, "
            f"== 8 CPU shards {np.array_equal(image, cpu_image)}; the single call "
            f"twice: data gradient rtol excess {rtol_excess(again[0], single[0]):.3g}")
        assert np.array_equal(image, single_image) and np.array_equal(image, cpu_image)
        assert np.array_equal(again_image, single_image)
        assert (covered > 0.0) == (name == "oblique"), covered
        hold(f"(a) {name}, 8 card shards vs the card's single call", got, single, terms)
        hold(f"(a) {name}, 8 card shards vs 8 CPU shards", got, cpu_got, terms,
             data_rtol=False)

    # (b) full width: bench_orbit's field, 8 bricks of 32^3, at size^2
    box = 32
    bricks, camera = bench_orbit_scene(ROOT, domain, box)
    targs, static = diff.prepare_scene(bricks, camera, width=size, height=size,
                                       device="cpu")
    args = tuple(a.numpy() for a in targs)
    num = len(bricks)
    ckpts = -(-static["num_steps"] // 16)
    log(f"phase 29: (b) bench_orbit's field at --domain {domain}: {num} bricks of "
        f"{box}^3 at {size}x{size}, {static['num_steps']} march steps; the march "
        f"keeps one [{num}, {size * size}, 4] accumulator and {ckpts} [{num}, "
        f"{size * size}] opacity checkpoints = "
        f"{(4 + ckpts) * num * size * size * 4 / 1e9:.3f} GB")
    results, marches = {}, {}
    for mode, mesh in (("single call", None), ("8 shards, one process", mesh_card)):
        reset_counts()  # counted run: the gradient at full width, one call or 8 shards
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated() if on_card else 0
        inner, marches[mode] = dm.march, []
        dm.march = lambda m, cfg: (marches[mode].append((m, cfg)), inner(m, cfg))[1]
        try:
            t0 = time.perf_counter()
            results[mode] = run(args, static, dev, mesh, remat=True)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            dm.march = inner
        peak = ((torch.cuda.max_memory_allocated() - held_before) / 2 ** 30
                if on_card else float("nan"))
        log(f"phase 29: {smi}: (b) forward + backward() w.r.t. data, LUT and eye, "
            f"{size}x{size}, remat=True, {mode}: {wall:.3f} ms wall (host clock, "
            f"synchronised; includes the readback of the frame and gradients), "
            f"peak device memory {peak:.3f} GiB above the "
            f"{held_before / 2 ** 30:.3f} GiB earlier phases still hold")
        results[mode + " wall"] = wall
        got, march = all_counts(), diff_counts()
        calls = 1 if mesh is None else mesh.size
        log(f"phase 29: (b) {mode}: launches of the march {march}, of the other "
            f"kernels {got}")
        assert not any(got.values()), got
        # the single call takes the pair path on the card (one pair build, the
        # pair fold), the shards the dense rows (a dense pair list, the fold)
        dense_rows, pair_rows = (0, 1) if mesh is None else (calls, 0)
        assert march == {"diffmarch_forward": calls if on_card else 0,
                         "diffmarch_backward": calls if on_card else 0,
                         "diffmarch_tangent": 0,
                         "diffmarch_pairs": dense_rows if on_card else 0,
                         "fold_diff_forward": dense_rows if on_card else 0,
                         "fold_diff_backward": dense_rows if on_card else 0,
                         "diffpairs_build": pair_rows if on_card else 0,
                         "diffpairs_fold_forward": pair_rows if on_card else 0,
                         "diffpairs_fold_backward": pair_rows if on_card else 0}, march
    # each march launch of (b), the single call's and each shard's, held
    # once against the plain version
    for mode, seen in marches.items():
        worst_d, same = 0.0, True
        for m, cfg in seen:
            with torch.no_grad():
                out, _ = dm.diffmarch_forward(m, cfg)
                plain = dm.march_forward_reference(m, cfg)
            fk, fp = torch.isfinite(out), torch.isfinite(plain)
            same = same and bool(torch.equal(fk, fp))
            worst_d = max(worst_d, float((out - plain).abs()[fk & fp].max()))
        log(f"phase 29: (b) {mode}: each of its {len(seen)} forward launches vs plain "
            f"on {dev}: max |diff| {worst_d:.3g}, non-finite pattern same {same}")
        assert same and worst_d == 0.0, mode
    del marches
    (image, sharded), (single_image, single) = (results["8 shards, one process"],
                                                results["single call"])
    covered = float((single_image[:, 3] > 0).mean())
    log(f"phase 29: (b) frame over 8 shards == single call "
        f"{np.array_equal(image, single_image)}, max |diff| "
        f"{float(np.abs(image - single_image).max()):.3g}; covered share {covered:.4f}")
    assert np.array_equal(image, single_image)
    assert ALPHA_FRACTION[0] < covered < ALPHA_FRACTION[1], covered
    reset_counts()  # counted run: forward mode, one tangent launch an eye component
    # the march's tangent calls recorded around it
    with recorded_tangents(dm) as seen:
        t0 = time.perf_counter()
        terms = eye_terms(args, static, dev)
        sync()
        march = diff_counts()
    tangent_calls = [(dm.MarchInputs(*(t.detach() for t in m)), cfg,
                      [None if t is None else t.detach().clone() for t in tangents],
                      out.detach().clone()) for m, cfg, tangents, out in seen]
    del seen
    log(f"phase 29: (b) eye terms' sums {terms} (forward mode on {dev}, "
        f"{time.perf_counter() - t0:.3f} s; march launches {march})")
    assert np.all(terms > 0.0), terms
    assert march["diffmarch_tangent"] == (3 if on_card else 0), march
    # each forward-mode pass: the forward and its tangent, a pair list each
    assert march["diffmarch_pairs"] == (6 if on_card else 0), march
    assert len(tangent_calls) == 3, len(tangent_calls)
    # each tangent launch (whose output gave ``terms``) against the plain
    # version on the same inputs, the same fields given, at DIFF_GRAD_REL of
    # the tangent's scale; the eye's terms carry the geometry's tangents
    # alone (the first distance and the eye)
    record = dict(launches=march["diffmarch_tangent"], max_abs_err=0.0)
    for c, (m, cfg, tangents, got) in enumerate(tangent_calls):
        carried = [f for f, t in zip(dm.MarchInputs._fields, tangents) if t is not None]
        assert carried == ["d0", "eye"], carried
        sync()
        t0 = time.perf_counter()
        want = dm.march_tangent_reference(m, cfg, tangents)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        log(f"phase 29: (b) eye component {c}'s tangent launch (fields {carried}) vs "
            f"plain on {dev}: max |diff| {err:.3g}, over max |t| {err / scale:.3g}; plain "
            f"{plain_ms:.3f} ms (wall)")
        assert scale > 0.0 and err <= DIFF_GRAD_REL * scale, (c, err, scale)
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record.setdefault("plain_ms", plain_ms)
    if on_card:
        # the first launch's inputs: the eye's tangent, every field's seeded
        # tangent (held against the plain version too) and the forward alone
        m, cfg, tangents, _ = tangent_calls[0]
        rng = np.random.default_rng(23)
        every = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(
            dev) for t in m[:dm.DIFFERENTIABLE]]
        with torch.no_grad():
            _, samples = dm.march_forward_reference(m, cfg, count_samples=True)
            got = dm.diffmarch_tangent(m, cfg, every)
            want = dm.march_tangent_reference(m, cfg, every)
            best = lambda fn: min(event_ms(torch, fn) for _ in range(3))  # noqa: E731
            times = {"eye": best(lambda: dm.diffmarch_tangent(m, cfg, tangents)),
                     "every field": best(lambda: dm.diffmarch_tangent(m, cfg, every)),
                     "forward": best(lambda: dm.diffmarch_forward(m, cfg))}
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        assert scale > 0.0 and err <= DIFF_GRAD_REL * scale, (err, scale)
        bounds = {}
        for label, given in (("eye", tangents), ("every field", every)):
            groups = tangent_groups(dm, given)
            nbytes = (sum(t.numel() * t.element_size() for t in m)
                      + sum(t.numel() * 4 for t in given if t is not None) + m.d0.numel() * 16)
            flops = int(samples) * diff_tangent_flops(cfg, groups)
            bounds[label] = bound(nbytes, flops) + (nbytes, flops, sorted(groups))
        b_ms, by = bounds["eye"][:2]
        record.update(ms=times["eye"], bound_ms=b_ms, bound_by=by)
        log(f"phase 29: {smi}: diffmarch_tangent, {m.d0.shape[0]} bricks x "
            f"{m.d0.shape[1]} pixels, {cfg.num_steps} steps, {int(samples)} valid "
            f"samples (CUDA events, best of 3): the eye's tangent {times['eye']:.4f} ms, "
            f"every field's seeded tangent {times['every field']:.4f} ms (vs plain max "
            f"|diff| over max |t| {err / scale:.3g}), the forward alone on the same inputs "
            f"{times['forward']:.4f} ms; plain {record['plain_ms']:.3f} ms (wall); "
            + "; ".join(f"{label}: groups {g}, bound {bm:.5f} ms ({bb}: {nb} B, {fl} "
                        f"operations), kernel at {bm / times[label]:.4f} of it"
                        for label, (bm, bb, nb, fl, g) in bounds.items()))
        del every, got, want
    del tangent_calls
    assert all(np.abs(g).max() > 0.0 for g in single)
    hold("(b) 8 shards vs the single call", sharded, single, terms)
    if on_card:
        torch.cuda.empty_cache()

    # (c) two processes on this card, 4 shards each
    base = os.path.join(SCRATCH, "two_process_diff")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    scene = os.path.join(base, "scene.npz")
    np.savez(scene, **{f"a{i}": a for i, a in enumerate(args)})
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    for r in (0, 1):
        cwd = os.path.join(base, f"rank{r}")
        os.makedirs(cwd)
        env = dict(os.environ, PYTHONPATH=ROOT, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r), LOCAL_WORLD_SIZE="2",
                   LOCAL_RANK=str(r))
        env.pop("AVR_DISTRIBUTED", None)
        procs.append((cwd, subprocess.Popen(
            [sys.executable, "-c", DIFF_RANK_RUN, ROOT, scene, json.dumps(static),
             dev.type],
            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ranks = []
    for cwd, proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{cwd}: rc {proc.returncode}\n{err[-4000:]}"
        (line,) = [x for x in out.splitlines() if x.startswith("RANK_DIFF ")]
        ranks.append((json.loads(line[len("RANK_DIFF "):]),
                      np.load(os.path.join(cwd, f"rank{len(ranks)}.npz"))))
    pair_s = time.perf_counter() - t0
    for rec, saved in ranks:
        r = rec["rank"]
        rows = slice(4 * r, 4 * r + 4)
        log(f"phase 29: {smi}: (c) rank {r} of two processes on {dev} (gloo), "
            f"shards {saved['local'].tolist()}: forward + backward() "
            f"{rec['wall_s'] * 1e3:.3f} ms wall, peak device memory "
            f"{rec['peak_gib']} GiB, other kernels' launches {rec['launches']}, the "
            f"march's (forward, backward, pair list) and the fold's (forward, "
            f"backward) {rec['march']}")
        assert list(saved["local"]) == list(range(4 * r, 4 * r + 4))
        assert rec["launches"] == 0, rec
        assert rec["march"] == ([4] * 5 if on_card else [0] * 5), rec
        assert np.array_equal(saved["image"], single_image), r
        hold(f"(c) rank {r}'s rows vs (b)'s single call",
             [saved["data"], saved["lut"], saved["eye"]],
             [single[0][rows], single[1], single[2]], terms)
    for key in ("lut", "eye"):
        assert np.array_equal(ranks[0][1][key], ranks[1][1][key]), key
    log(f"phase 29: (c) eye and LUT gradients equal on both ranks; eye "
        f"{ranks[0][1]['eye']} against one process's {single[2]}; {pair_s:.3f} s "
        "wall for the pair (process start, CUDA context, gloo rendezvous included)")

    # (d) the two benchmark examples with their defaults
    env = dict(os.environ, PYTHONPATH=ROOT)
    for script, argv in examples:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXAMPLE_RUN, ROOT,
             os.path.join(ROOT, "examples", script), *argv],
            cwd=SCRATCH, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        launched = [json.loads(x[len("LAUNCHES "):]) for x in lines
                    if x.startswith("LAUNCHES ")]
        printed = [x for x in lines if not x.startswith("LAUNCHES ")]
        log(f"phase 29: {smi}: (d) examples/{script} {' '.join(argv) or '(defaults)'} "
            f"rc {proc.returncode} in {wall:.3f} s: {' | '.join(printed)}; kernel 1 "
            f"launches {launched}")
        assert proc.returncode == 0 and launched, proc.stderr[-3000:]
        kind = "tilemarch_batch" if "--batch" in argv else "tilemarch"
        assert launched[0][kind] > 0 or not on_card, launched
        assert any("ms/frame" in x for x in printed), printed
    return {"diffmarch_tangent": record}


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


def ptxas_lines(build_log: str):
    """['kernel: N registers, F bytes stack frame, S bytes spill stores, L
    bytes spill loads'] of every entry function in an ``nvcc -Xptxas -v``
    log."""
    import re

    rows, name, frame = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, frame = m.group(1), ""
        m = re.search(r"(\d+ bytes stack frame.*)", line)
        if m and name:
            frame = m.group(1).strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{demangle(name)}: {m.group(1)} registers, {frame}")
            name = None
    return rows


def sass_atomics(nvcc: str, flags, csrc: str, name: str, out_dir: str) -> dict:
    """{kernel: {opcode: count}} of the atomic instructions (ATOMS, ATOMG,
    ATOM, RED, and compare-and-swap loops, whose opcodes hold CAS) in the
    SASS of ``csrc/<name>.cu`` built as a cubin with ``flags``
    (``cuobjdump -sass``)."""
    import re

    os.makedirs(out_dir, exist_ok=True)
    cubin = os.path.join(out_dir, f"{name}_atomics.cubin")
    flags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, os.path.join(csrc, f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                           cubin], check=True, capture_output=True, text=True).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        ops = {}
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", chunk):
            words = op.split()
            code = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
            if code.startswith(("ATOM", "RED")) or "CAS" in code:
                ops[code] = ops.get(code, 0) + 1
        out[demangle(chunk.split()[0])] = ops
    return out


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



def bench_orbit_scene(tree: str, domain: int = 64, box: int = 32):
    """``(bricks, camera)`` of phase 29 (b): the field of ``tree``'s
    examples/bench_orbit_torch.py at ``--domain`` as bricks of ``box``^3,
    seen from its orbit's first camera."""
    bench = runpy.run_path(os.path.join(tree, "examples", "bench_orbit_torch.py"))
    field = bench["turbulence_field"](domain)
    bricks = [(field[i:i + box, j:j + box, k:k + box], np.array([i, j, k]) / domain,
               np.array([i + box, j + box, k + box]) / domain)
              for i in range(0, domain, box) for j in range(0, domain, box)
              for k in range(0, domain, box)]
    return bricks, bench["orbit_cameras"](12)[0]


def diff_two_process(tree: str, repeats: int) -> list:
    """[[rank 0 s, rank 1 s], ...]: ``repeats`` runs of phase 29 (c) from
    ``tree`` (its ``chip_smoke.py``'s ``DIFF_RANK_RUN``: two processes on
    this card over gloo, 4 shards each, one forward + ``backward()`` of
    bench_orbit's field at 512^2 in a fresh process), each rank's wall."""
    import importlib.util
    import shutil
    import socket

    from amrvolumerenderer_torch import diff

    spec = importlib.util.spec_from_file_location("tree_smoke",
                                                  os.path.join(tree, "chip_smoke.py"))
    tree_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tree_smoke)
    targs, static = diff.prepare_scene(*bench_orbit_scene(tree), width=512, height=512,
                                       device="cpu")
    base = os.path.join(tree, "build", "two_process_ab")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    scene = os.path.join(base, "scene.npz")
    np.savez(scene, **{f"a{i}": a.numpy() for i, a in enumerate(targs)})
    walls = []
    for rep in range(repeats):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = []
        for r in (0, 1):
            cwd = os.path.join(base, f"run{rep}_rank{r}")
            os.makedirs(cwd)
            env = dict(os.environ, PYTHONPATH=tree,
                       JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                       JAX_PROCESS_ID=str(r), LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(r))
            env.pop("AVR_DISTRIBUTED", None)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", tree_smoke.DIFF_RANK_RUN, tree, scene,
                 json.dumps(static), "cuda"], cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        row = []
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            (line,) = [x for x in out.splitlines() if x.startswith("RANK_DIFF ")]
            row.append(json.loads(line[len("RANK_DIFF "):])["wall_s"])
        walls.append(row)
    return walls


def diff_tangent_case(torch, tree: str, dev):
    """``(m, cfg, tangents)`` of phase 29 (b)'s first tangent launch, as the
    package in ``tree`` makes it: the forward mode of the eye's first
    component through ``render_image_diff`` on bench_orbit's field at
    ``--domain 64`` (8 bricks of 32^3) at 512^2."""
    import torch.autograd.forward_ad as fwAD

    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import diffmarch as dm

    targs, static = diff.prepare_scene(*bench_orbit_scene(tree), width=512, height=512,
                                       device=dev)
    with recorded_tangents(dm) as seen, torch.no_grad(), fwAD.dual_level():
        full = list(targs)
        full[6] = fwAD.make_dual(targs[6], torch.eye(3, device=dev)[0])
        diff.render_image_diff(*full, remat=False, **static)
    (m, cfg, tangents, _), = seen
    return (dm.MarchInputs(*(t.detach() for t in m)), cfg,
            [None if t is None else t.detach() for t in tangents])


def diff_march_main(argv) -> int:
    """``--diff-march``: the diff march's kernels of one tree on phase 27's
    inputs (bench.py's 3-level scene through ``diff.prepare_geometry``).
    Prints the build's ptxas lines and the SASS atomics of each kernel;
    device ms by CUDA events, best of five: the forward at 1024^2 under
    ``no_grad``, the same with every ``hit`` false (its floor), the pair
    list alone, the forward at 512^2 keeping its checkpoints, the backward
    at 512^2 (the cotangent of ``mean(image^2)``) under each
    ``DIFF_NEEDS`` entry, and the tangent on phase 29 (b)'s first launch
    (``diff_tangent_case``: the eye's fields, then every field's seeded
    tangent) beside the forward on the same inputs; best of three, every
    distinct ``numerics.fma`` launch of the 1024^2 call and of a raymarch
    frame of the same scene at 1024^2 (``fma_launch_times``); with
    ``--check`` each kernel against its plain version on the card (the
    forward at max |diff| 0, the backward and the tangent at DIFF_GRAD_REL
    of each output's scale, the contention scene too);
    ``--steps`` the active steps a hit pair (``diff_active_steps``);
    ``--two-process N`` ``diff_two_process``; ``--graph-repeats N``
    ``diff_graph_spread``.  The last line is one JSON object of the
    figures."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --diff-march")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--graph-repeats", type=int, default=0)
    ap.add_argument("--two-process", type=int, default=0)
    opts = ap.parse_args(argv)
    tree = os.path.abspath(opts.tree)
    if not os.path.isdir(os.path.join(tree, "amrvolumerenderer_torch")):
        print(f"{tree} holds no amrvolumerenderer_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this mode needs a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"{tree}: {smi}", flush=True)
    from amrvolumerenderer_torch import diff
    from amrvolumerenderer_torch.ops import _build
    from amrvolumerenderer_torch.ops import composite as comp
    from amrvolumerenderer_torch.ops import diffmarch as dm
    from amrvolumerenderer_torch.ops import numerics as nm
    from amrvolumerenderer_torch.renderer import (auto_orbit_camera, compute_global_bounds,
                                                  render_scene)
    from amrvolumerenderer_torch.types import RenderParameters

    assert "jax" not in sys.modules and "amrvolumerenderer_tpu" not in sys.modules
    dev = torch.device("cuda", 0)
    result = {"tree": tree, "device": smi}
    _build.build_all(["diffmarch", "numerics", "raymarch", "composite"])
    for line in ptxas_lines(_build.build_log.get("numerics", "")):
        print("  ptxas", line)
    result["ptxas"] = ptxas_lines(_build.build_log.get("diffmarch", ""))
    result["sass_atomics"] = sass_atomics(_build._nvcc(), _build.NVCC_FLAGS, _build._CSRC,
                                          "diffmarch", os.path.join(tree, "build"))
    for line in result["ptxas"]:
        print("  ptxas", line)
    for kernel, ops in result["sass_atomics"].items():
        print(f"  SASS {kernel}: {ops}")

    @contextlib.contextmanager
    def recorded():
        inner, seen = dm.march, []

        def record(m, cfg):
            out = inner(m, cfg)
            entry = [m, cfg, None]
            seen.append(entry)
            if out.requires_grad:
                out.register_hook(lambda g: entry.__setitem__(2, g))
            return out

        dm.march = record
        try:
            yield seen
        finally:
            dm.march = inner

    geometry = three_level_geometry()
    camera = auto_orbit_camera(compute_global_bounds(geometry))
    args, static = diff.prepare_geometry(geometry, camera, width=1024, height=1024,
                                         device=dev)
    with recorded() as seen, recorded_fmas(nm) as fma_ops, torch.no_grad():
        diff.render_image_diff(*args, **static)
    (m_full, cfg, _), = seen
    with recorded_fmas(nm) as ray_fmas:
        render_scene("", RenderParameters(width=1024, height=1024), geometry, verbose=False,
                     method="raymarch", device=dev)
    data = args[0].clone().requires_grad_(True)
    table = args[4].clone().requires_grad_(True)
    with recorded() as seen:
        image = diff.render_image_diff(data, *args[1:4], table, *args[5:], remat=True,
                                       **dict(static, width=512, height=512))
        (image * image).mean().backward()
    (m_grad, cfg_grad, g_out), = seen
    m_grad = dm.MarchInputs(*(t.detach() for t in m_grad))
    del data, table, image
    torch.cuda.synchronize()

    def best(fn, reps=5):
        with torch.no_grad():
            fn()
            return min(event_ms(torch, fn) for _ in range(reps))

    times = {"forward_1024": best(lambda: dm.diffmarch_forward(m_full, cfg))}
    miss = m_full._replace(hit=torch.zeros_like(m_full.hit))
    times["forward_1024_all_miss"] = best(lambda: dm.diffmarch_forward(miss, cfg))
    if hasattr(dm, "diffmarch_pairs"):  # a tree with the pair list
        times["pairs_1024"] = best(lambda: dm.diffmarch_pairs(m_full.hit))
    times["forward_512_keep"] = best(lambda: dm.diffmarch_forward(m_grad, cfg_grad,
                                                                  keep=True))
    _, ckpt = dm.diffmarch_forward(m_grad, cfg_grad, keep=True)
    times.update(diff_backward_breakdown(torch, dm, m_grad, cfg_grad, g_out, ckpt, best))
    m_t, cfg_t, eye_t = diff_tangent_case(torch, tree, dev)
    rng = np.random.default_rng(23)
    every = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(dev)
             for t in m_t[:dm.DIFFERENTIABLE]]
    times["tangent_eye_512"] = best(lambda: dm.diffmarch_tangent(m_t, cfg_t, eye_t))
    times["tangent_every_512"] = best(lambda: dm.diffmarch_tangent(m_t, cfg_t, every))
    times["forward_tangent_inputs_512"] = best(lambda: dm.diffmarch_forward(m_t, cfg_t))
    if hasattr(comp, "fold_diff"):  # a tree with the fold kernels
        result["fold"] = fold_phase(torch, dev, smi)
    result["ms"] = times
    for k, v in times.items():
        print(f"  {k}: {v:.4f} ms", flush=True)
    for key, launches in (("fma_1024", fma_ops), ("fma_raymarch_1024", ray_fmas)):
        result[key] = fma_launch_times(torch, nm, launches)
        print(f"  {key}: " + fma_times_line(result[key]), flush=True)
    del fma_ops, ray_fmas
    if opts.check:
        checks = {}
        with torch.no_grad():
            for tag, m, c in (("1024", m_full, cfg), ("512", m_grad, cfg_grad)):
                out, _ = dm.diffmarch_forward(m, c, keep=True)
                plain = dm.march_forward_reference(m, c)
                same = bool(torch.equal(torch.isfinite(out), torch.isfinite(plain)))
                fin = torch.isfinite(plain)
                d = float((out - plain)[fin].abs().max())
                checks[f"forward_{tag}"] = (d, same)
                assert same and d == 0.0, (tag, d, same)
            for needs, rel in diff_backward_vs_plain(torch, dm, m_grad, cfg_grad, g_out,
                                                     ckpt):
                checks[f"backward_{needs}"] = rel
            m_c, cfg_c = diff_contention_scene(torch, dev)
            _, ckpt_c = dm.diffmarch_forward(m_c, cfg_c, keep=True)
            g_c = torch.from_numpy(np.random.default_rng(3).uniform(
                -1, 1, size=(*m_c.d0.shape, 4)).astype(np.float32)).to(dev)
            for needs, rel in diff_backward_vs_plain(torch, dm, m_c, cfg_c, g_c, ckpt_c):
                checks[f"contention_backward_{needs}"] = rel
            for tag, given in (("eye", eye_t), ("every", every)):
                got = dm.diffmarch_tangent(m_t, cfg_t, given)
                want = dm.march_tangent_reference(m_t, cfg_t, given)
                checks[f"tangent_{tag}"] = float((got - want).abs().max()) / float(
                    want.abs().max())
        result["checks"] = checks
        for k, v in checks.items():
            print(f"  check {k}: {v}", flush=True)
        assert all(v <= DIFF_GRAD_REL for k, v in checks.items()
                   if "backward" in k or "tangent" in k), checks
    if opts.steps:
        result["steps"] = diff_active_steps(torch, dm, m_full, cfg)
        print("  active steps a hit pair (1024^2, plain):", result["steps"], flush=True)
    if opts.two_process:
        result["two_process_s"] = diff_two_process(tree, opts.two_process)
        print("  two processes, each rank's wall (s):", result["two_process_s"], flush=True)
    if opts.graph_repeats:
        result["graph"] = diff_graph_spread(torch, diff, opts.graph_repeats)
        print("  graph vs eager:", result["graph"], flush=True)
        assert result["graph"]["within_1e-5"], result["graph"]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(diff_march_main(sys.argv[2:]) if sys.argv[1:2] == ["--diff-march"]
             else main())
