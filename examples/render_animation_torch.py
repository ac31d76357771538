#!/usr/bin/env python3
"""Animation / in-situ workflow on the PyTorch port's persistent renderer.

The port's copy of ``render_animation.py``.  It shows the animation
surface (the reference re-prepares MPI + scene state per frame; see
miniapps/renderVolumeRotate.cpp and renderVolumeTime.cpp):

  * ``FastSceneRenderer`` keeps the scene resident on the device and
    repacks it for a new camera axis there;
  * ``set_transfer_function`` swaps the colormap / box transparency per
    frame (a LUT upload, no brick repacking);
  * ``update_data`` ingests a new timestep's values from tensors on the
    device (fixed grid hierarchy and scalar range).

Renders on the GPU unless ``--device cpu`` is given.

Usage:
    python examples/render_animation_torch.py output_dir [--frames N] [--size W]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("output_dir")
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    import torch

    from amrvolumerenderer_torch import api
    from amrvolumerenderer_torch.device import resolve_device
    from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
    from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry
    from amrvolumerenderer_torch.types import (
        CameraParameters,
        RenderParameters,
        color_map_from_tuples,
    )

    device = resolve_device(args.device)
    # a simple oscillating shell field
    n = 32
    coords = (np.arange(n) + 0.5) / n
    r2 = (
        (coords[:, None, None] - 0.5) ** 2
        + (coords[None, :, None] - 0.5) ** 2
        + (coords[None, None, :] - 0.5) ** 2
    )

    def timestep(t: float) -> np.ndarray:
        radius = 0.25 + 0.1 * math.sin(t)
        return np.exp(-((np.sqrt(r2) - radius) ** 2) / 0.005).astype(
            np.float32
        )

    data = api.AmrData(
        level_data=[[LevelBox(timestep(0.0), np.zeros(3, dtype=int))]],
        level_geometry=[LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))],
    )
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    geometry.scalar_range = (0.0, 1.0)
    geometry.has_scalar_range = True

    params = RenderParameters(width=args.size, height=args.size)
    renderer = FastSceneRenderer(geometry, params, device=device)

    warm = color_map_from_tuples([
        (0.0, 0.0, 0.0, 0.0, 0.0),
        (0.4, 0.8, 0.2, 0.1, 0.0),
        (1.0, 1.0, 0.9, 0.3, 0.6),
    ])

    for frame in range(args.frames):
        t = frame / max(args.frames - 1, 1)
        # orbit the camera, evolve the field, swap the map halfway through
        angle = 2.0 * math.pi * t
        eye = (
            0.5 + 2.2 * math.cos(angle),
            0.9 + 0.6 * math.sin(2 * angle),
            0.5 + 2.2 * math.sin(angle),
        )
        camera = CameraParameters(
            eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)
        )
        renderer.update_data([torch.from_numpy(timestep(4.0 * t)).to(device)])
        if frame == args.frames // 2:
            renderer.set_transfer_function(color_map=warm)
        out = os.path.join(args.output_dir, f"frame{frame:04d}.png")
        renderer.render(camera, output_filename=out)
        print(f"wrote {out}")

    # pure camera orbit at the final timestep: render_batch renders the
    # sweep in chunks of frames, one kernel launch and one readback each
    orbit = []
    for frame in range(args.frames):
        angle = 2.0 * math.pi * frame / max(args.frames, 1)
        orbit.append(CameraParameters(
            eye=(0.5 + 2.2 * math.cos(angle), 0.9,
                 0.5 + 2.2 * math.sin(angle)),
            look_at=(0.5, 0.5, 0.5), up=(0, 1, 0),
        ))
    pattern = os.path.join(args.output_dir, "orbit{:04d}.png")
    renderer.render_batch(orbit, output_pattern=pattern)
    print(f"wrote {args.frames} batched orbit frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
