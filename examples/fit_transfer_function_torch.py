#!/usr/bin/env python3
"""Gradient-based transfer-function fitting on the PyTorch port.

The port's copy of ``fit_transfer_function.py``: it renders a target
image with a known transfer function, then recovers that transfer
function from a flat initial guess by Adam (``torch.optim.Adam``, the JAX
example's learning rate) through the differentiable renderer
(``amrvolumerenderer_torch.diff``).  Runs on the GPU unless ``--device
cpu`` is given; there each step is replayed as a CUDA graph.  Exits 0
when the loss falls below a tenth of its first value.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from amrvolumerenderer_torch import diff
from amrvolumerenderer_torch.camera import camera_basis
from amrvolumerenderer_torch.types import CameraParameters


def build_scene(size: int, image_size: int, device):
    """One random ``size``^3 brick in the unit cube seen from +z; the LUT
    slot (argument 4) is left out and filled per call."""
    rng = np.random.default_rng(17)
    data = rng.uniform(0.1, 0.9, size=(size, size, size)).astype(np.float32)
    camera = CameraParameters(
        eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.5), up=(0.0, 1.0, 0.0)
    )
    forward, right, up = camera_basis(camera)
    step = 0.5 / size
    f32 = np.float32
    args = diff.args_from_arrays((
        data[None], np.zeros((1, 3), f32), np.ones((1, 3), f32),
        np.full((1, 3), size, np.int32), np.asarray([step], f32),
        np.asarray(camera.eye, f32), np.asarray(forward, f32),
        np.asarray(right, f32), np.asarray(up, f32),
        f32(camera.fov_y_degrees), f32(0.0), f32(1.0),
    ), device)
    # the field of view as a number: a render then reads no value back
    # from the card, so its step can be captured as a CUDA graph
    args = (*args[:9], float(camera.fov_y_degrees), *args[10:])
    static = dict(width=image_size, height=image_size, num_steps=4 * size)
    return args, static


def ramp_lut(size: int, peak_alpha: float) -> np.ndarray:
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)
    return np.stack([t, 0.4 * np.ones_like(t), 1.0 - t, peak_alpha * t], axis=1)


WARMUP = 3  # steps run as they come before the step is captured on the card


def fit(loss_fn, param, lr: float, steps: int, report) -> None:
    """``steps`` Adam steps on ``param``, each followed by the projection
    into [0, 1] (clipping inside the loss would zero the gradient of any
    out-of-range entry and freeze it there); ``report(step, loss)`` after
    each.  On the card, after WARMUP steps on a side stream, the whole
    step (forward, backward, Adam, projection) is captured once as a CUDA
    graph and replayed: the counterpart of the JAX example's ``jax.jit``,
    since the step's launches are too small for the host to keep the card
    busy."""
    cuda = param.device.type == "cuda"
    optimizer = torch.optim.Adam([param], lr=lr, capturable=cuda)

    def step():
        loss = loss_fn(param)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            param.clamp_(0.0, 1.0)
        return loss.detach()

    if not cuda:
        for k in range(steps):
            optimizer.zero_grad(set_to_none=True)
            report(k, float(step()))
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for k in range(min(WARMUP, steps)):
            optimizer.zero_grad(set_to_none=True)
            report(k, float(step()))
    torch.cuda.current_stream().wait_stream(side)
    if steps <= WARMUP:
        return
    graph = torch.cuda.CUDAGraph()
    optimizer.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph):
        loss = step()
    for k in range(WARMUP, steps):
        graph.replay()
        report(k, float(loss))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--volume-size", type=int, default=8)
    parser.add_argument("--image-size", type=int, default=24)
    parser.add_argument("--lut-size", type=int, default=32)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args_ns = parser.parse_args(argv)

    scene_args, static = build_scene(args_ns.volume_size, args_ns.image_size,
                                     args_ns.device)
    dev = scene_args[0].device

    # remat=False: at this size every step's activations fit, and
    # checkpointing each step would cost host time in every launch
    def render(lut):
        return diff.render_image_diff(*scene_args[:4], lut, *scene_args[4:],
                                      remat=False, **static)

    with torch.no_grad():
        target = render(torch.from_numpy(ramp_lut(args_ns.lut_size, 0.5))[None].to(dev))

    def loss_fn(lut):
        return torch.mean((render(lut) - target) ** 2)

    lut = torch.from_numpy(ramp_lut(args_ns.lut_size, 0.1))[None].to(dev)
    lut.requires_grad_(True)
    losses = []

    def report(step, val):
        losses.append(val)
        if step % 10 == 0 or step == args_ns.steps - 1:
            print(f"step {step:4d}  loss {val:.6g}")

    fit(loss_fn, lut, 3e-2, args_ns.steps, report)
    initial = losses[0]
    with torch.no_grad():
        final = float(loss_fn(lut))
    print(f"loss: {initial:.6g} -> {final:.6g} "
          f"({initial / max(final, 1e-30):.1f}x reduction)")
    return 0 if final < 0.1 * initial else 1


if __name__ == "__main__":
    raise SystemExit(main())
