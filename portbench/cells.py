"""The two kinds of traffic the benchmark drives, each set up from a
configuration file and a traffic file, then run for a window, then
checked against the plain reference.

* ``render_batch``: a closed loop of one client calling
  ``FastSceneRenderer.render_batch(cameras, overlay=False,
  bytes_out=True)`` back to back on a never-repeating orbit.
* ``fit``: multi-view volume reconstruction; the whole optimiser step
  (forward, backward, Adam, clamp) captured as one CUDA graph on the card
  and replayed back to back, one loss read a step.

Each exposes ``setup``, ``window`` (returns a ``Window``), ``release``
(drops the program's state), ``check`` (the numbers compared, each beside
its limit) and ``layer_context`` (what the per-layer readers read).
"""

from __future__ import annotations

import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import log, roofline, scenes
from .reference import raymarch as ref_ray
from .reference import slicemarch as ref_slice
from .reference import transfer
from .trace import Trace, Tracer, span

MAX_PIECE = 32  # cells an edge of the pieces a slice march takes one at a time


@dataclass
class Window:
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    durations: List[float] = field(default_factory=list)  # per call, s
    calls: List[dict] = field(default_factory=list)  # the program's counters a call


@dataclass
class LayerContext:
    """What a per-layer reader reads: the window's counters summed, the
    trace of its steady stretch and the yardstick's bounds for that
    stretch."""
    stats: Dict[str, float]
    trace: Optional[Trace]
    bounds: Dict[str, float] = field(default_factory=dict)  # kernel group -> s
    flops: float = 0.0  # operations of the traced stretch


def program_camera(cam: scenes.Camera):
    from amrvolumerenderer_torch.types import CameraParameters

    return CameraParameters(eye=cam.eye, look_at=cam.look_at, up=cam.up,
                            fov_y_degrees=cam.fov_y_degrees, near_plane=cam.near_plane,
                            far_plane=cam.far_plane)


def _normalizer(boxes, normalize: bool):
    """The scene's scalar transform to [0, 1] by its data range (float64),
    as a function of a brick's values; identity without ``normalize``."""
    if not normalize:
        return lambda v: v.float()
    lo = min(float(b.data.double().min()) for b in boxes)
    hi = max(float(b.data.double().max()) for b in boxes)
    inv = 1.0 / (hi - lo) if hi > lo else 1.0
    return lambda v: ((v.double() - lo) * inv).clamp(0.0, 1.0).float()


class RenderBatch:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tracer: Tracer):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.tracer = tracer
        self.batch = traffic["batch"]
        self.sqrt_aa = int(round(math.sqrt(traffic["antialiasing"])))
        self.kept: Dict[int, np.ndarray] = {}
        self.traced_cams: List[scenes.Camera] = []

    def setup(self) -> None:
        from amrvolumerenderer_torch import api
        from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
        from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry
        from amrvolumerenderer_torch.types import RenderParameters

        cfg, t = self.cfg, self.traffic
        self.scene = scenes.make_scene(cfg, self.seed, self.device)
        with span("scene"):
            levels = [[LevelBox(b.data.cpu().numpy(), np.array(b.lo)) for b in level]
                      for level in self.scene.levels]
            data = api.AmrData(
                level_data=levels,
                level_geometry=[LevelGeometry(np.zeros(3), np.full(3, h))
                                for h in self.scene.cell_sizes],
                refinement_ratios=[(2, 2, 2)] * (len(levels) - 1))
            geometry = api.load_amr_geometry(data, 0, -1, 0, False, cfg["normalize"],
                                             verbose=False)
            params = RenderParameters(
                width=t["width"], height=t["height"], antialiasing=t["antialiasing"],
                box_transparency=cfg["box_transparency"],
                use_visibility_graph=cfg["use_visibility_graph"],
                sampling=cfg["sampling"], classification=cfg["classification"],
                lut_size=cfg["lut_size"])
            self.renderer = FastSceneRenderer(geometry, params, device=self.device,
                                              precision=cfg["precision"])
        log("scene prepared")
        self.orbit = scenes.Orbit(t, self.seed)
        g = scenes.rng(self.seed, "check")
        self.sample = set(int(i) for i in g.choice(t["check_within"], t["check_frames"],
                                                   replace=False))
        for b in range(t["warmup_batches"]):  # revolution -1: never in the window
            self.call(self.orbit.cameras(-(b + 1) * self.batch, self.batch))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def call(self, cams):
        with span("render_batch"):
            return self.renderer.render_batch([program_camera(c) for c in cams],
                                              overlay=False, bytes_out=True)

    def window(self, seconds: float) -> Window:
        w = Window()
        index, calls, last = 0, 0, None
        traced_from = None
        t0 = time.perf_counter()
        while True:
            cams = self.orbit.cameras(index, self.batch)
            if calls == self.traffic["trace_after_calls"]:
                self.tracer.start()
                if self.tracer.active:
                    traced_from = len(self.traced_cams)
            c0 = time.perf_counter()
            try:
                frames = self.call(cams)
            except Exception:  # a failed call fails every frame it carried
                traceback.print_exc(file=sys.stderr)
                frames = None
                w.failed += len(cams)
            now = time.perf_counter()
            w.durations.append(now - c0)
            w.attempted += len(cams)
            if frames is not None:
                w.calls.append(self.renderer.last_batch_stats)
                for j in range(len(cams)):
                    if index + j in self.sample:
                        self.kept[index + j] = frames[j].copy()
                last = (index + len(cams) - 1, frames[-1])  # a fresh array each call
            if self.tracer.active:
                self.traced_cams.extend(cams)
                if now - self.tracer.t0 >= self.traffic["trace_seconds"]:
                    self.tracer.stop(units=len(self.traced_cams) - traced_from)
            index += len(cams)
            calls += 1
            if now - t0 >= seconds:
                break
        self.tracer.stop(units=len(self.traced_cams) - (traced_from or 0))
        w.seconds = now - t0
        if last is not None:
            self.kept[last[0]] = last[1].copy()
        return w

    def release(self) -> None:
        self.renderer = None

    def _pieces(self):
        boxes = scenes.split(self.scene.boxes, MAX_PIECE)
        return ref_slice.pieces_of(boxes, _normalizer(boxes, self.cfg["normalize"]))

    def check(self) -> Dict[str, float]:
        """Worst over the kept frames: the mean byte gap and the share of
        bytes that differ from the reference."""
        t, cfg = self.traffic, self.cfg
        if not self.kept:
            return {"frames_compared": 0.0}
        rgba = transfer.table(cfg["lut_size"], 0.0, 1.0, 1.0 - cfg["box_transparency"])
        lut = torch.as_tensor(rgba, device=self.device)
        log_t = torch.as_tensor(transfer.log_transmittance(rgba), device=self.device)
        pieces = self._pieces()
        # half the coarsest cell: the step the transfer function's opacity is for
        ref_distance = max(0.5 * max(self.scene.cell_sizes), 1e-5)
        mean_gap = changed = 0.0
        for index in sorted(self.kept):
            want, _ = ref_slice.render(
                pieces, self.orbit.camera(index), width=t["width"], height=t["height"],
                sqrt_aa=self.sqrt_aa, lut_rgba=lut, log_t=log_t, ref_distance=ref_distance,
                range_min=0.0, inv_range=1.0)
            got = torch.as_tensor(self.kept[index], device=self.device)
            gap = (got.int() - want.int()).abs()
            mean_gap = max(mean_gap, float(gap.float().mean()))
            changed = max(changed, float((gap > 0).float().mean()))
        return {"frames_compared": float(len(self.kept)), "mean_byte_gap": mean_gap,
                "changed_bytes": changed}

    def layer_context(self, w: Window, trace: Optional[Trace]) -> LayerContext:
        counters = ("host_prep_ms", "readback_ms", "dispatch_ms", "frames")
        ctx = LayerContext(stats={k: sum(c[k] for c in w.calls) for k in counters},
                           trace=trace)
        if trace is None or not self.traced_cams:
            return ctx
        t, cfg = self.traffic, self.cfg
        pieces = self._pieces()
        flops_per = roofline.SLICE_SAMPLE_FLOPS[(cfg["sampling"], cfg["classification"])]
        cells = sum(int(p[0].numel()) for p in pieces)
        buffer_px = t["width"] * t["height"] * self.sqrt_aa ** 2
        bound = 0.0
        for cam in self.traced_cams[:trace.units]:
            samples = ref_slice.count_samples(pieces, cam, width=t["width"], height=t["height"],
                                              sqrt_aa=self.sqrt_aa, device=self.device)
            flops = samples * flops_per
            ctx.flops += flops
            # the bricks' values read, the buffer's colour and depth written
            bound += roofline.bound_s(flops, 4 * cells + 20 * buffer_px)
        ctx.bounds["tilemarch"] = bound
        return ctx


class Fit:
    WARMUP = 3  # eager steps before the step is captured, as the example runs them
    FIRST = 3  # steps the reference follows

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tracer: Tracer):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.tracer = tracer
        self.traced_from = None

    def inputs(self) -> None:
        """The bricks and views from the seed."""
        self.scene = scenes.make_scene(self.cfg, self.seed, self.device)
        self.boxes = self.scene.boxes
        self.cams = scenes.fit_views(self.traffic, self.seed)

    def setup(self) -> None:
        from amrvolumerenderer_torch import diff

        cfg, t = self.cfg, self.traffic
        self.inputs()
        log("inputs")
        host = [(b.data.cpu().numpy(), b.min_corner, b.max_corner) for b in self.boxes]
        views = []
        with span("prepare"):
            for cam in self.cams:
                args, static = diff.prepare_scene(
                    host, program_camera(cam), width=t["width"], height=t["height"],
                    scalar_range=(0.0, 1.0), lut_size=cfg["lut_size"],
                    box_transparency=cfg["box_transparency"], device=self.device)
                # the field of view as a number: a render then reads nothing
                # back from the card, so the step can be captured as a graph
                args = (*args[:10], float(cam.fov_y_degrees), *args[11:])
                with torch.no_grad():
                    target = diff.render_image_diff(*args, **static)
                views.append((args, static, target))
        self.static = views[0][1]
        log("views prepared, targets rendered")

        def loss_fn(volume):
            total = 0.0
            for args, static, target in views:
                image = diff.render_image_diff(volume, *args[1:], remat=False, **static)
                total = total + torch.mean((image - target) ** 2)
            return total / len(views)

        init = t["init"]
        self.param = torch.full(views[0][0][0].shape, init, dtype=torch.float32,
                                device=self.device, requires_grad=True)
        cuda = self.device.type == "cuda"
        self.opt = torch.optim.Adam([self.param], lr=t["lr"], capturable=cuda)
        param, opt = self.param, self.opt

        def step():
            loss = loss_fn(param)
            loss.backward()
            opt.step()
            with torch.no_grad():
                param.clamp_(0.0, 1.0)
            return loss.detach()

        if cuda:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    opt.zero_grad(set_to_none=True)
                    step()
            torch.cuda.current_stream().wait_stream(side)
            log("eager warm-up steps")
            graph = torch.cuda.CUDAGraph()
            opt.zero_grad(set_to_none=True)
            with torch.cuda.graph(graph):
                loss = step()
            log("captured")
            # back to the start: the first steps below are the graph's own
            with torch.no_grad():
                param.fill_(init)
                for state in opt.state.values():
                    for v in state.values():
                        v.zero_()

            def run():
                graph.replay()
                return float(loss)
        else:
            def run():
                opt.zero_grad(set_to_none=True)
                return float(step())
        self.run = run
        self.first_losses, self.first_grad_norm = [], None
        with span("first_steps"):
            for k in range(self.FIRST):
                self.first_losses.append(self.run())
                if k == 0:  # the gradient Adam took: its first moment / (1 - beta1)
                    b1 = opt.param_groups[0]["betas"][0]
                    avg = opt.state[param].get("exp_avg")
                    self.first_grad_norm = 0.0 if avg is None else float(avg.norm()) / (1.0 - b1)
        with torch.no_grad():
            self.change_norm = float((param - init).norm())
        if cuda:
            torch.cuda.synchronize()
        log("first steps")

    def window(self, seconds: float) -> Window:
        w = Window()
        t = self.traffic
        t0 = prev = time.perf_counter()
        steps = 0
        while True:
            if steps == t["trace_after_calls"]:
                self.tracer.start()
                if self.tracer.active:
                    self.traced_from = steps
            try:
                with span("step"):
                    loss = self.run()
                ok = math.isfinite(loss)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                ok = False
            now = time.perf_counter()
            w.durations.append(now - prev)
            prev = now
            w.attempted += 1
            w.failed += 0 if ok else 1
            steps += 1
            if self.tracer.active and now - self.tracer.t0 >= t["trace_seconds"]:
                self.tracer.stop(units=steps - self.traced_from)
            if now - t0 >= seconds:
                break
        self.tracer.stop(units=steps - (self.traced_from or 0))
        w.seconds = now - t0
        return w

    def release(self) -> None:
        self.run = None
        self.opt = None
        self.param = None

    def reference(self, dtype=torch.float32):
        t = self.traffic
        bricks = ref_ray.Bricks(self.boxes, self.device, dtype, self.cfg["lut_size"])
        truth = bricks.tensor([b.data for b in self.boxes])
        return ref_ray.Fit(bricks, truth, self.cams, t["width"], t["height"], t["init"], t["lr"])

    def readings(self, dtype=torch.float32):
        """The reference's ``(losses, first gradient's norm, change's
        norm)`` over the first steps, computed in ``dtype``."""
        fit = self.reference(dtype)
        losses, grad_norm = [], None
        for k in range(self.FIRST):
            loss, grad = fit.step()
            losses.append(loss)
            if k == 0:
                grad_norm = float(grad.float().norm())
        return losses, grad_norm, float((fit.param.float() - self.traffic["init"]).norm())

    @staticmethod
    def gaps(got, want) -> Dict[str, float]:
        """Relative gaps of ``got`` to ``want`` (each as ``readings``):
        the worst step's loss, the first gradient's norm, the change's."""
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got[0], want[0])),
                "grad_norm_gap": abs(got[1] - want[1]) / want[1],
                "change_norm_gap": abs(got[2] - want[2]) / want[2]}

    def check(self) -> Dict[str, float]:
        """The program's first steps (its losses, the first gradient's
        norm from Adam's first moment, the change of the parameters after
        them) against the reference's."""
        got = (self.first_losses, self.first_grad_norm, self.change_norm)
        return self.gaps(got, self.readings())

    def layer_context(self, w: Window, trace: Optional[Trace]) -> LayerContext:
        ctx = LayerContext(stats={}, trace=trace)
        if trace is None or not trace.units:
            return ctx
        t, st = self.traffic, self.static
        bricks = ref_ray.Bricks(self.boxes, self.device, torch.float32, self.cfg["lut_size"])
        per = roofline.diff_sample_flops(st["normalize"], st["log_scale"], st["apply_clip"])
        count, px = len(self.boxes), t["width"] * t["height"]
        data_bytes = 4 * count * int(np.prod(bricks.pad))
        lut_bytes = 16 * count * self.cfg["lut_size"]
        bound = flops = 0.0
        for cam in self.cams:
            samples, pairs = ref_ray.valid_samples(bricks, cam, t["width"], t["height"])
            # per pair: d0, exit, the hit flag; per pixel: its direction
            rays = count * px * 9 + px * 12
            bound += roofline.bound_s(0.0, count * px + 4 * pairs + 16 * (count * px - pairs))
            fwd = samples * per
            bound += roofline.bound_s(fwd, data_bytes + lut_bytes + rays + 4 * pairs + 16 * pairs)
            bwd = samples * (per + roofline.DIFF_ADJOINT_FLOPS)
            bound += roofline.bound_s(bwd, 2 * (data_bytes + lut_bytes) + rays + 20 * pairs)
            flops += fwd + bwd
        ctx.bounds["diffmarch"] = bound * trace.units
        ctx.flops = flops * trace.units
        return ctx


KINDS = {"render_batch": RenderBatch, "fit": Fit}
