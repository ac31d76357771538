"""The pair-list kernels' share of their roofline, %: the yardstick's bound
for the traced steps (``portbench/pairs.py``: each view's build, fold
forward and fold backward, from its bricks, its pixels and its hit pairs)
over the device time of the kernels with ``diffpairs_`` in their names.

The pair counts are the benchmark's own: the hit pairs that
``reference/raymarch.py::valid_samples`` counts, from its rays and its slab
test but without its samples (``hit_pairs``), for the bricks and views the
run's ``--workload`` and ``--seed`` make (``run.load_cell``,
``scenes.make_scene``, ``scenes.fit_views``).  None where the program
launches no such kernel, where the command line names no cell, or where
the cell is no fit."""

import argparse
import sys

import numpy as np
import torch

from portbench import pairs, roofline, run, scenes
from portbench.reference import raymarch as ref_ray


def _cell():
    """``(workload, seed)`` of the command line, or None."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int)
    try:
        args, _ = parser.parse_known_args(sys.argv[1:])
    except SystemExit:
        return None
    if args.workload is None or args.seed is None:
        return None
    return args.workload, args.seed


def hit_pairs(bricks: ref_ray.Bricks, cam, width: int, height: int) -> int:
    """The (brick, pixel) pairs of a view whose ray meets the brick's box,
    as ``valid_samples`` counts them, without marching their samples."""
    dev = bricks.device
    d, _ = ref_ray.rays(cam, width, height, dev, torch.float32)
    eye = torch.as_tensor(np.asarray(cam.eye, np.float32), device=dev)
    lo, hi = (torch.as_tensor(v, device=dev) for v in (bricks.bmin, bricks.bmax))
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(len(bricks.dims)):
        tmin, tmax = ref_ray._slab(eye, d, lo[b], hi[b])
        count += (tmax >= tmin).sum()
    return int(count)


def read(ctx):
    t = ctx.trace
    if t is None or not t.units:
        return None
    seconds = t.device_seconds("diffpairs_")
    cell = _cell()
    if seconds <= 0.0 or cell is None:
        return None
    try:
        spec = run.load_cell(cell[0])
    except SystemExit:
        return None
    traffic = spec["traffic"]
    if traffic["kind"] != "fit":
        return None
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    boxes = scenes.make_scene(spec["config"], cell[1], device).boxes
    bricks = ref_ray.Bricks(boxes, device, torch.float32, spec["config"]["lut_size"])
    width, height = traffic["width"], traffic["height"]
    bound = 0.0
    for cam in scenes.fit_views(traffic, cell[1]):
        bound += pairs.view_bound_s(len(boxes), width * height,
                                    hit_pairs(bricks, cam, width, height))
    return roofline.share(bound * t.units, seconds)
