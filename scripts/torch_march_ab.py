#!/usr/bin/env python3
"""Device time of the PyTorch port's march kernels on one NVIDIA GPU, for
comparing source trees within one run.

    python3 scripts/torch_march_ab.py [--tree DIR] [--label TEXT]

imports ``amrvolumerenderer_torch`` and ``chip_smoke`` (for its scene
helpers) from ``--tree`` (default: this checkout) and times, on bench.py's
3-level scene at 1024x1024 (nearest/post/256) over 8 orbit cameras: the
tile-march kernel (one frame), the work-list slice-march kernel, the
batched tile-march kernel at F = 2 and 8 (float32 and bfloat16 volumes)
and the dense slice-march kernel over 8 shards.  Each time is device time
by CUDA events after a ~10 ms spin kernel, the best of three passes, in ms
per frame.  Each kernel is then held against its plain version on the
first camera's inputs (max |diff|), the host wall time per frame of the
entry points around the kernels is taken (median of three synchronised
passes: the slice-march and tile-march routes, ``render_batch`` with
bytes out, the 8-shard frame on both pipelines), and the build's ptxas
registers and spills are read off its log.  Run it once per tree (each
tree builds its own kernels), alternating, e.g. parent, change, change,
parent, to compare two trees on one card.  Prints the card's name and
power limit, then one JSON line of times, diffs and ptxas figures.  It
imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

SPIN_CYCLES = 20_000_000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from amrvolumerenderer_torch.api import RenderParameters
    from amrvolumerenderer_torch.camera import orbit_camera_sequence
    from amrvolumerenderer_torch.compositor import sort_layers
    from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
    from amrvolumerenderer_torch.ops import _build
    from amrvolumerenderer_torch.ops import slicemarch as sm
    from amrvolumerenderer_torch.ops import tilemarch as tm
    from amrvolumerenderer_torch.parallel import directsend as ds
    from amrvolumerenderer_torch import renderer_fast as rf
    from amrvolumerenderer_torch.renderer import (
        auto_orbit_camera,
        compute_global_bounds,
        compute_global_scalar_range,
        compute_reference_sample_distance,
    )

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)

    def event_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def best(thunks, frames) -> float:
        for t in thunks:  # warm-up
            t()
        return min(sum(event_ms(t) for t in thunks) / frames for _ in range(3))

    geometry = cs.three_level_geometry()
    params = RenderParameters(width=1024, height=1024)
    fsr = {p: FastSceneRenderer(geometry, params, device=dev, precision=p)
           for p in ("float32", "bfloat16")}
    center = 0.5 * (fsr["float32"].bounds.min_corner + fsr["float32"].bounds.max_corner)
    cams = cs.orbit_cameras(center, auto_orbit_camera(fsr["float32"].bounds).eye, 8)
    r = fsr["float32"]
    kw = dict(width=r.pad_w, height=r.pad_h, max_slices=r.cube,
              logical_width=r.render_width, logical_height=r.render_height)
    times = {}
    tile_args = []
    for c in cams:
        f = r.frame_inputs(c)
        tile_args.append((r._packed_vol, f["meta"], f["dims"], r.lut, f["cam"],
                          f["offsets"], f["bricks"], f["owners"],
                          f["item_bounds"], f["tile_ids"]))
    times["tilemarch"] = best([lambda a=a: tm.tilemarch_render(*a, **kw)
                               for a in tile_args], 8)
    # chip_smoke.py phase 13's orbit: 8 frames 1 degree apart, one march axis
    one_axis = orbit_camera_sequence(auto_orbit_camera(r.bounds), 8, 8.0)
    for prec, rr in fsr.items():
        for frames in (2, 8):
            groups = [cs.batch_case(torch, rr, one_axis[j:j + frames])[:2]
                      for j in range(0, 8, frames)]
            times[f"tilemarch_batch_{prec}_F{frames}"] = best(
                [lambda g=g: tm.tilemarch_render_batch(*g[0], **g[1])
                 for g in groups], 8)

    bounds = compute_global_bounds(geometry)
    srange = compute_global_scalar_range(geometry)
    rsd = compute_reference_sample_distance(geometry, bounds)
    slice_calls = []
    for c in cams:
        prep = rf.prepare_slicemarch_scene(geometry, params, c, srange, rsd,
                                           1024, 1024, None)
        inp = rf.slicemarch_device_inputs(prep, dev)
        args = tuple(inp[k] for k in ("vol", "meta", "dims", "luts", "cam",
                                      "wb", "wt", "wbounds"))
        skw = dict(width=prep["pad_w"], height=prep["pad_h"],
                   max_slices=prep["s_max"], logical_width=1024,
                   logical_height=1024, sampling="nearest", ghost=prep["ghost"],
                   classification="post")
        slice_calls.append((args, skw))
    times["slicemarch"] = best(
        [lambda a=a, k=k: sm.slicemarch_render_worklist_raw(*a, **k)
         for a, k in slice_calls], 8)

    prep = rf.prepare_slicemarch_scene(geometry, params, cams[0], srange, rsd,
                                       1024, 1024, None)
    order = sort_layers(prep["depth_hints"], prep["owners"], prep["local_indices"])
    packed, valid, hints = ds.pack_depth_contiguous(
        prep["depth_hints"][order], np.arange(len(order), dtype=np.int32), 8,
        *(prep[k][order] for k in ("vol", "meta", "dims", "luts")))
    tables = ds.shard_leading(ds.make_mesh(8, dev), *packed, valid, hints)
    cam = ds._constant_camera(prep["cam"]).to(dev)
    dkw = dict(width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
               logical_width=1024, logical_height=1024)
    shards = [tuple(t[i] for t in tables[:4]) + (cam,) for i in range(8)]
    times["slicemarch_dense_8_shards"] = best(
        [lambda: [sm.slicemarch_render(*a, **dkw) for a in shards]], 1)

    # each kernel against its plain version on the first camera's inputs
    def diff(got, ref) -> float:
        out = 0.0
        for g, r_ in zip(got, ref):
            g, r_ = g.cpu(), r_.cpu()
            fin = torch.isfinite(r_)
            assert torch.equal(torch.isfinite(g), fin)
            out = max(out, float((g[fin] - r_[fin]).abs().max()))
        return out

    a, k = slice_calls[0]
    cov = rf.slicemarch_device_inputs(rf.prepare_slicemarch_scene(
        geometry, params, cams[0], srange, rsd, 1024, 1024, None), dev)["coverage"]
    g = cs.batch_case(torch, fsr["bfloat16"], one_axis[:2])[:2]
    diffs = {
        "tilemarch": diff(tm.tilemarch_render(*tile_args[0], **kw),
                          tm.tilemarch_reference(*tile_args[0], **kw)),
        "slicemarch": diff([x[cov] for x in sm.slicemarch_render_worklist_raw(*a, **k)],
                           [x[cov] for x in sm.slicemarch_reference(*a, **k)]),
        "tilemarch_batch_bfloat16_F2": diff(
            tm.tilemarch_render_batch(*g[0], **g[1]),
            tm.tilemarch_batch_reference(*g[0], **g[1])),
        "slicemarch_dense_8_shards": max(
            diff(sm.slicemarch_render(*sa, **dkw),
                 sm.untile(*sm.slicemarch_dense_reference(*sa, **dkw),
                           dkw["width"], dkw["height"])) for sa in shards),
    }
    # host wall per frame of the entry points around the kernels, median of
    # three synchronised passes over the 8 cameras after a warm-up pass
    def wall_ms(fn, frames=8) -> float:
        fn()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / frames)
        return float(np.median(runs))

    walls = {
        "render_composited_slicemarch": wall_ms(lambda: [
            rf.render_composited_slicemarch(geometry, params, c, srange, rsd, 1024,
                                            1024, None, device=dev) for c in cams]),
        "fast_scene_render": wall_ms(lambda: [r.render(c, overlay=False)
                                              for c in cams]),
        "render_batch_bytes": wall_ms(lambda: r.render_batch(
            cams, overlay=False, bytes_out=True)),
    }
    for pipeline in ("depth", "layered"):
        walls[f"render_composited_sharded_D8_{pipeline}"] = wall_ms(lambda: [
            rf.render_composited_sharded(geometry, params, c, srange, rsd, 1024,
                                         1024, None, 8, pipeline=pipeline,
                                         device=dev) for c in cams])
    ptxas = {}
    for name, text in _build.build_log.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", text))
        ptxas[name] = {"max_registers": max(regs, default=0), "spill_store_bytes": spill}
    print(json.dumps({"tree": tree, "label": opts.label,
                      "ms_per_frame": times, "wall_ms_per_frame": walls,
                      "max_abs_diff_vs_plain": diffs,
                      "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
