#!/usr/bin/env python3
"""Device time of the PyTorch port's kernels on one NVIDIA GPU, for
comparing source trees within one run.

    python3 scripts/torch_march_ab.py [--tree DIR] [--label TEXT] [--composite-only]

imports ``amrvolumerenderer_torch`` and ``chip_smoke`` (for its scene
helpers) from ``--tree`` (default: this checkout) and times, on bench.py's
3-level scene at 1024x1024 (nearest/post/256) over 8 orbit cameras: the
tile-march kernel (one frame), the work-list slice-march kernel, the
batched tile-march kernel at F = 2 and 8 (float32 and bfloat16 volumes)
and the dense slice-march kernel over 8 shards (all skipped with
``--composite-only``); the tile composite on the slice-march route's
layers and on 128 seeded layers x 1024 tiles (``chip_smoke.py`` phase 6's
inputs); and the fold stages of the sharded frame for D = 2 and 8 (the
depth pipeline's local fold and fold of the exchanged partials, the
layered pipeline's fold), through ``parallel/directsend.py``'s own stage
functions, so trees whose folds differ compare on the same inputs.  Each
kernel time is device time by CUDA events after a ~10 ms spin kernel, the
best of three passes, in ms per frame; each fold stage is timed that way
and as host wall time (median of five synchronised calls), and each of
its pixel-mode composite launches alone against its byte bound.  Each
kernel is then held against its plain version on the first camera's
inputs (max |diff|), the host wall time per frame of the entry points
around the kernels is taken (median of three synchronised passes: the
slice-march and tile-march routes, ``render_batch`` with bytes out, the
8-shard frame on both pipelines), and the build's ptxas registers and
spills are read off its log.  Run it once per tree (each tree builds its own kernels),
alternating, e.g. parent, change, change, parent, to compare two trees on
one card.  Prints the card's name and power limit, then one JSON line of
times, diffs and ptxas figures.  It imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SPIN_CYCLES = 20_000_000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--composite-only", action="store_true",
                    help="skip the march kernels' times and diffs")
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
    from amrvolumerenderer_torch.ops import composite as comp
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
    times, diffs = {}, {}

    # each kernel against its plain version on the first camera's inputs
    def diff(got, ref) -> float:
        out = 0.0
        for g, r_ in zip(got, ref):
            g, r_ = g.cpu(), r_.cpu()
            fin = torch.isfinite(r_)
            assert torch.equal(torch.isfinite(g), fin)
            out = max(out, float((g[fin] - r_[fin]).abs().max()))
        return out

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
        order = sort_layers(prep["depth_hints"], prep["owners"], prep["local_indices"])
        comp_args = (torch.from_numpy(order).to(dev),
                     torch.from_numpy(np.ascontiguousarray(prep["owners"][order])).to(dev),
                     inp["coverage"])
        slice_calls.append((args, skw, comp_args))

    if not opts.composite_only:
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
        times["slicemarch"] = best(
            [lambda a=a, k=k: sm.slicemarch_render_worklist_raw(*a, **k)
             for a, k, _ in slice_calls], 8)

        prep = rf.prepare_slicemarch_scene(geometry, params, cams[0], srange, rsd,
                                           1024, 1024, None)
        order = sort_layers(prep["depth_hints"], prep["owners"], prep["local_indices"])
        packed, valid, hints = ds.pack_depth_contiguous(
            prep["depth_hints"][order], np.arange(len(order), dtype=np.int32), 8,
            *(prep[k][order] for k in ("vol", "meta", "dims", "luts")))
        tables = ds.shard_leading(ds.make_mesh(8, dev), *packed, valid, hints)
        cam = ds._constant_camera(prep["cam"]).to(dev)
        dkw = dict(width=prep["pad_w"], height=prep["pad_h"],
                   max_slices=prep["s_max"], logical_width=1024, logical_height=1024)
        shards = [tuple(t[i] for t in tables[:4]) + (cam,) for i in range(8)]
        times["slicemarch_dense_8_shards"] = best(
            [lambda: [sm.slicemarch_render(*a, **dkw) for a in shards]], 1)

        a, k, comp_args = slice_calls[0]
        cov = comp_args[2]
        g = cs.batch_case(torch, fsr["bfloat16"], one_axis[:2])[:2]
        diffs.update({
            "tilemarch": diff(tm.tilemarch_render(*tile_args[0], **kw),
                              tm.tilemarch_reference(*tile_args[0], **kw)),
            "slicemarch": diff(
                [x[cov] for x in sm.slicemarch_render_worklist_raw(*a, **k)],
                [x[cov] for x in sm.slicemarch_reference(*a, **k)]),
            "tilemarch_batch_bfloat16_F2": diff(
                tm.tilemarch_render_batch(*g[0], **g[1]),
                tm.tilemarch_batch_reference(*g[0], **g[1])),
            "slicemarch_dense_8_shards": max(
                diff(sm.slicemarch_render(*sa, **dkw),
                     sm.untile(*sm.slicemarch_dense_reference(*sa, **dkw),
                               dkw["width"], dkw["height"])) for sa in shards),
        })

    # the tile composite on the slice-march route's layers (the main path)
    # and on chip_smoke.py phase 6's 128 seeded layers x 1024 tiles
    layer_bufs = [sm.slicemarch_render_worklist_raw(*a, **k) for a, k, _ in slice_calls]
    times["composite"] = best(
        [lambda b=b, c=c: comp.composite_tiles(*b, *c[2])
         for b, c in zip(layer_bufs, slice_calls)], 8)
    diffs["composite"] = diff(comp.composite_tiles(*layer_bufs[0], *slice_calls[0][2]),
                              comp.composite_reference(*layer_bufs[0],
                                                       *slice_calls[0][2]))
    rng = np.random.default_rng(6)
    alpha = torch.from_numpy(rng.uniform(0, 1, (128, 1024, 1, 8, 128))
                             .astype(np.float32)).to(dev)
    colors = torch.cat([torch.rand((128, 1024, 3, 8, 128), device=dev,
                                   generator=torch.Generator(dev).manual_seed(6))
                        * alpha, alpha], dim=2)
    depths = torch.from_numpy(rng.choice(np.array([0.5, 1.0, 2.0, np.inf], np.float32),
                                         (128, 1024, 8, 128))).to(dev)
    cover = torch.from_numpy(rng.uniform(0, 1, (128, 1024)) < 0.7).to(dev)
    colors[~cover] = float("nan")
    depths[~cover] = float("nan")
    owners = np.sort(rng.integers(0, 48, 128))
    order = sort_layers(rng.choice(np.array([0.1, 0.2], np.float32), 128),
                        owners, np.arange(128))
    args128 = (colors, depths, torch.from_numpy(order).to(dev),
               torch.from_numpy(owners[order].astype(np.int32)).to(dev), cover)
    times["composite_128_layers"] = best([lambda: comp.composite_tiles(*args128)], 1)
    diffs["composite_128_layers"] = diff(comp.composite_tiles(*args128),
                                         comp.composite_reference(*args128))
    del colors, depths, alpha, args128, layer_bufs

    # the sharded frame's fold stages (chip_smoke.py phase 19's split), on
    # the layers of the first camera's frame, through directsend's stage
    # functions: device ms (spin first) and host wall ms (synchronised)
    def wall_median(fn, runs=5) -> float:
        fn()
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    def fold_launches(fn):
        """Each pixel-mode composite launch ``fn`` makes (a tree that has
        the entry), timed alone: [[layers, pixels, ms, byte bound ms]]."""
        real = getattr(comp, "composite_pixels", None)
        if real is None:
            return []
        calls = []

        def record(*a):
            calls.append(a)
            return real(*a)

        record.launches = 0  # the wrapper counts through its module's name
        comp.composite_pixels = record
        try:
            fn()
        finally:
            comp.composite_pixels = real
        rows = []
        for a in calls:
            n_l, n_p = a[0].shape[:2]
            ms = best([lambda a=a: real(*a)], 1)
            rows.append([n_l, n_p, ms, (n_l + 1) * n_p * 20 / 3.35e12 * 1e3])
        return rows

    fold_stages = {}
    prep = rf.prepare_slicemarch_scene(geometry, params, cams[0], srange, rsd,
                                       1024, 1024, None)
    for num in (2, 8):
        rect, tiles = ds.select_compaction(prep["coverage"], prep["pad_w"],
                                           prep["pad_h"], 32, 32, num)
        mesh = ds.make_mesh(num, dev)
        skw = dict(max_slices=prep["s_max"], logical_width=1024,
                   logical_height=1024, ghost=prep["ghost"])
        for pipeline in ("depth", "layered"):
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
            tables = ds.shard_leading(mesh, *packed, valid, hints)
            layers, hints = ds._render_shards(mesh, tables, prep["cam"], rect, tiles,
                                              prep["pad_w"], prep["pad_h"], **skw)
            if pipeline == "layered":
                received = ds._exchange(mesh, layers)
                gathered = ds.all_gather(mesh, hints)
                stages = {"fold": lambda: ds._fold_layers(mesh, received, gathered)}
            else:
                partials = ds._local_precomposite(mesh, layers, hints)
                received = ds._exchange(mesh, partials)
                stages = {"local fold": lambda: ds._local_precomposite(mesh, layers,
                                                                       hints),
                          "fold": lambda: ds._fold_partials(mesh, received)}
            for stage, fn in stages.items():
                fold_stages[f"D{num}_{pipeline}_{stage}"] = {
                    "device_ms": best([fn], 1), "wall_ms": wall_median(fn),
                    "launches": fold_launches(fn)}
    torch.cuda.synchronize()

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
    }
    if not opts.composite_only:
        walls["fast_scene_render"] = wall_ms(lambda: [r.render(c, overlay=False)
                                                      for c in cams])
        walls["render_batch_bytes"] = wall_ms(lambda: r.render_batch(
            cams, overlay=False, bytes_out=True))
    for pipeline in ("depth", "layered"):
        walls[f"render_composited_sharded_D8_{pipeline}"] = wall_ms(lambda: [
            rf.render_composited_sharded(geometry, params, c, srange, rsd, 1024,
                                         1024, None, 8, pipeline=pipeline,
                                         device=dev) for c in cams])
    # per entry function: [registers, shared memory bytes, spill bytes]
    ptxas = {fn: [regs, smem, stores + loads]
             for text in _build.build_log.values()
             for fn, regs, smem, stores, loads in cs.ptxas_report(text)}
    print(json.dumps({"tree": tree, "label": opts.label,
                      "ms_per_frame": times, "fold_stages_ms": fold_stages,
                      "wall_ms_per_frame": walls,
                      "max_abs_diff_vs_plain": diffs,
                      "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
