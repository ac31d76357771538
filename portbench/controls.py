"""Readings that set a cell's limits: sound runs, the lower-precision
control and the planted faults, each on several seeds.

    python3 -m portbench.controls --workload <name> --mode <mode> --seeds 1,2,3 [--seconds s]

Modes:

* ``sound``: the numbers of ordinary runs (a short window each), the
  lower reading;
* ``control``: the cell's control, computed in the precision below the
  configuration's float32: for a render cell the program's own bfloat16
  path (``precision="bfloat16"``), for the fit the plain reference
  computed in bfloat16 in the program's place;
* ``half`` (fit): the program's images of the second half of the views
  are their targets and those of the first half weigh double, so the
  loss is the mean over the first half alone; (render) each call's second
  half of frames are copies of its first half's;
* ``stale`` (render): every call returns the frames of the call before
  (the first call's own), a step that returns its state unchanged; (fit)
  Adam's step does nothing;
* ``altered`` (render): a 64 x 64 block at the centre of every frame is
  cleared, an answer altered where it is produced.

Each seed prints one line ``reading <mode> <seed> {numbers}``.  These
runs are not the benchmark's: its own runs never plant a control.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from . import run as bench


def _render_fault(mode: str):
    """Wrap ``FastSceneRenderer.render_batch`` with a fault; returns an undo."""
    from amrvolumerenderer_torch.fast_scene import FastSceneRenderer

    original = FastSceneRenderer.render_batch
    previous = {}

    def faulty(self, cameras, *args, **kwargs):
        frames = original(self, cameras, *args, **kwargs)
        if mode == "stale":
            out = previous.get("frames", frames)
            previous["frames"] = frames.copy()
            return out
        if mode == "half":
            half = len(frames) // 2
            frames[len(frames) - half:] = frames[:half]
        if mode == "altered":
            width, height = self.parameters.width, self.parameters.height
            view = frames.reshape(len(frames), height, width, -1)
            view[:, height // 2 - 32: height // 2 + 32, width // 2 - 32: width // 2 + 32] = 0
        return frames

    FastSceneRenderer.render_batch = faulty
    return lambda: setattr(FastSceneRenderer, "render_batch", original)


def _fit_fault(mode: str):
    """Wrap ``diff.render_image_diff`` (``half``) or Adam's step
    (``stale``) with a fault; returns an undo."""
    import torch

    if mode == "stale":
        original = torch.optim.Adam.step
        torch.optim.Adam.step = lambda self, closure=None: None
        return lambda: setattr(torch.optim.Adam, "step", original)
    from amrvolumerenderer_torch import diff

    original = diff.render_image_diff
    targets, calls = [], [0]

    def faulty(*args, **kwargs):
        image = original(*args, **kwargs)
        if not torch.is_grad_enabled():  # set-up renders the targets, view by view
            targets.append(image)
            return image
        k = calls[0] % len(targets)  # the loss renders the views in the same order
        calls[0] += 1
        target = targets[k]
        if k < len(targets) // 2:
            return target + math.sqrt(2.0) * (image - target)
        return target + 0.0 * image

    diff.render_image_diff = faulty
    return lambda: setattr(diff, "render_image_diff", original)


def reading(workload: str, mode: str, seed: int, seconds: float, device: str = "cuda",
            spec: dict = None) -> dict:
    """The numbers compared in one run of ``mode``."""
    spec = spec or bench.load_cell(workload)
    render = spec["traffic"]["kind"] == "render_batch"
    if mode == "control" and not render:
        import torch

        from . import cells
        from .trace import Tracer

        fit = cells.Fit(spec["config"], spec["traffic"], seed, device, Tracer(False))
        fit.inputs()
        numbers = fit.gaps(fit.readings(torch.bfloat16), fit.readings())
        limits = spec["limits"]
        return {**numbers, "correct": all(numbers[k] <= limits[k] for k in limits)}
    if mode == "control":
        spec = dict(spec, config=dict(spec["config"], precision="bfloat16"))
    plant = _render_fault if render else _fit_fault
    undo = plant(mode) if mode in ("stale", "half", "altered") else (lambda: None)
    try:
        out, _ = bench.run(workload, seed, seconds, False, device=device, cell_override=spec)
    finally:
        undo()
    return {**{k: c["value"] for k, c in out["checks"].items()}, "correct": out["correct"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", required=True,
                        choices=("sound", "control", "half", "stale", "altered"))
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = reading(args.workload, args.mode, seed, args.seconds)
        print(f"reading {args.mode} {seed} {json.dumps(r)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
