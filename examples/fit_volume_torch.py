#!/usr/bin/env python3
"""Multi-view volume reconstruction on the PyTorch port.

The port's copy of ``fit_volume.py``: it renders a target volume from
several orbit cameras, then recovers the volume from a uniform initial
guess by Adam (``torch.optim.Adam``, the JAX example's learning rate)
through the differentiable renderer (``amrvolumerenderer_torch.diff``):
gradients with respect to the data.  Runs on the GPU unless ``--device
cpu`` is given; there each step is replayed as a CUDA graph.  Exits 0
when the loss falls below a tenth of its first value and the recovered
volume correlates with the truth above 0.6.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np
import torch

from amrvolumerenderer_torch import diff
from amrvolumerenderer_torch.types import CameraParameters


def orbit_cameras(n_views: int, radius: float = 2.5):
    center = (0.5, 0.5, 0.5)
    cams = []
    for i in range(n_views):
        theta = 2.0 * math.pi * i / n_views
        eye = (
            0.5 + radius * math.cos(theta),
            0.5 + 0.4 * math.sin(2 * theta),
            0.5 + radius * math.sin(theta),
        )
        cams.append(CameraParameters(eye=eye, look_at=center, up=(0.0, 1.0, 0.0)))
    return cams


def target_volume(size: int) -> np.ndarray:
    c = (np.arange(size) + 0.5) / size
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
    blob = np.exp(-r2 / 0.06)
    lobe = 0.5 * np.exp(-((x - 0.7) ** 2 + (y - 0.3) ** 2 + (z - 0.6) ** 2) / 0.02)
    return np.clip(blob + lobe, 0.0, 1.0).astype(np.float32)


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
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--volume-size", type=int, default=8)
    parser.add_argument("--image-size", type=int, default=20)
    parser.add_argument("--views", type=int, default=6)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args_ns = parser.parse_args(argv)

    truth = target_volume(args_ns.volume_size)
    bricks = [(truth, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))]
    views = []
    for cam in orbit_cameras(args_ns.views):
        scene_args, static = diff.prepare_scene(
            bricks, cam, width=args_ns.image_size, height=args_ns.image_size,
            device=args_ns.device,
        )
        # the field of view as a number: a render then reads no value back
        # from the card, so its step can be captured as a CUDA graph
        scene_args = (*scene_args[:10], float(cam.fov_y_degrees), *scene_args[11:])
        with torch.no_grad():
            target = diff.render_image_diff(*scene_args, **static)
        views.append((scene_args, static, target))

    def loss_fn(volume):
        total = 0.0
        for scene_args, static, target in views:
            # remat=False: at this size every step's activations fit,
            # and checkpointing each step would cost host time
            image = diff.render_image_diff(volume[None], *scene_args[1:],
                                           remat=False, **static)
            total = total + torch.mean((image - target) ** 2)
        return total / len(views)

    volume = torch.full(truth.shape, 0.3, dtype=torch.float32,
                        device=views[0][0][0].device, requires_grad=True)
    losses = []

    def report(step, val):
        losses.append(val)
        if step % 25 == 0 or step == args_ns.steps - 1:
            print(f"step {step:4d}  loss {val:.6g}")

    fit(loss_fn, volume, 5e-2, args_ns.steps, report)
    initial = losses[0]
    with torch.no_grad():
        final = float(loss_fn(volume))
    recovered = volume.detach().cpu().numpy()
    corr = float(np.corrcoef(recovered.ravel(), truth.ravel())[0, 1])
    print(f"loss: {initial:.6g} -> {final:.6g}; "
          f"volume correlation with truth: {corr:.3f}")
    return 0 if final < 0.1 * initial and corr > 0.6 else 1


if __name__ == "__main__":
    raise SystemExit(main())
