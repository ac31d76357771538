#!/usr/bin/env python3
"""Orbit animation batch benchmark on the PyTorch port (BASELINE.md config 5).

The port's copy of ``bench_orbit.py``.  Prepares a turbulence-like AMR
scene once with ``FastSceneRenderer`` and renders a camera orbit: the
production animation/serving loop.  The brick data stays on the device;
each frame costs one tile-march kernel launch plus a little host-side work
list math, and ``--batch`` renders the orbit through ``render_batch`` (one
launch per chunk of frames, byte-coded readback).  Times are host clock
after ``torch.cuda.synchronize()``.

Renders on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np


def turbulence_field(n: int) -> np.ndarray:
    """The synthetic multi-scale field on an ``n``^3 grid: a sum of
    sinusoids in [0, 1]."""
    coords = np.arange(n) / n
    x = coords[:, None, None]
    y = coords[None, :, None]
    z = coords[None, None, :]
    return (
        0.5
        + 0.25 * np.sin(2 * np.pi * 3 * x) * np.cos(2 * np.pi * 5 * y)
        + 0.15 * np.sin(2 * np.pi * 9 * z + 1.0)
        + 0.10 * np.sin(2 * np.pi * 17 * (x + y + z))
    ).astype(np.float32)


def orbit_cameras(frames: int):
    """The orbit: ``frames`` eyes on a circle of radius 2.6 around the
    domain's centre, 1.2 above it."""
    from amrvolumerenderer_torch.types import CameraParameters

    look = np.array([0.5, 0.5, 0.5])
    radius, height_off = 2.6, 1.2
    cams = []
    for frame_idx in range(frames):
        angle = math.tau * frame_idx / frames
        cams.append(CameraParameters(
            eye=(look[0] + radius * math.cos(angle),
                 look[1] + height_off,
                 look[2] + radius * math.sin(angle)),
            look_at=look, up=(0, 1, 0),
            fov_y_degrees=45.0, near_plane=0.1, far_plane=20.0,
        ))
    return cams


def prepare_renderer(n: int, width: int, height: int, antialiasing: int,
                     device):
    """The turbulence field on an ``n``^3 grid in 32^3 boxes, prepared once
    as a ``FastSceneRenderer`` on ``device``."""
    from amrvolumerenderer_torch import api
    from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
    from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry
    from amrvolumerenderer_torch.types import RenderParameters

    field = turbulence_field(n)
    boxes = [
        LevelBox(field[i:i + 32, j:j + 32, k:k + 32], np.array([i, j, k]))
        for i in range(0, n, 32)
        for j in range(0, n, 32)
        for k in range(0, n, 32)
    ]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))]
    data = api.AmrData(level_data=[boxes], level_geometry=geoms)
    geometry = api.load_amr_geometry(data, 0, -1, 0, False, True, verbose=False)
    params = RenderParameters(width=width, height=height,
                              antialiasing=antialiasing)
    return FastSceneRenderer(geometry, params, device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--domain", type=int, default=128)
    parser.add_argument("--width", type=int, default=2048)
    parser.add_argument("--height", type=int, default=2048)
    parser.add_argument("--antialiasing", type=int, default=4)
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--save-first", default=None,
                        help="save the first frame to this PNG")
    parser.add_argument("--batch", action="store_true",
                        help="render the orbit through render_batch "
                             "(one launch per chunk, byte-coded readback)")
    parser.add_argument("--rgb", action="store_true",
                        help="with --batch: drop the alpha byte on device "
                             "(bytes_out='rgb'; ~25%% less readback)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from amrvolumerenderer_torch.device import resolve_device

    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    fast = prepare_renderer(args.domain, args.width, args.height,
                            args.antialiasing, device)
    sync()
    print(f"scene prepared ({fast.canonical.shape[0]} pieces) "
          f"in {time.perf_counter() - t0:.2f} s")
    cams = orbit_cameras(args.frames)

    if args.batch:
        mode = "rgb" if args.rgb else True
        frames = fast.render_batch(cams, overlay=False, bytes_out=mode)  # warm
        sync()
        t0 = time.perf_counter()
        frames = fast.render_batch(cams, overlay=False, bytes_out=mode)
        sync()
        dt = time.perf_counter() - t0
        assert frames[:, :, :3].max() > 0
        if args.save_first:
            from amrvolumerenderer_torch.image import ImageBuffer, ImageKind
            from amrvolumerenderer_torch.io import save_image

            first = frames[0]
            if args.rgb:
                first = np.concatenate(
                    [first, np.full((first.shape[0], 1), 255, np.uint8)],
                    axis=1,
                )
            save_image(
                ImageBuffer(ImageKind.RGBA_U8, args.width, args.height,
                            first),
                args.save_first,
            )
        print(
            f"orbit (batched): {args.frames} frames at "
            f"{args.width}x{args.height} AA={args.antialiasing}; "
            f"{dt * 1e3 / args.frames:.1f} ms/frame "
            f"({args.frames / dt:.1f} fps)"
        )
        return 0

    times = []
    for frame_idx, cam in enumerate(cams):
        sync()
        t0 = time.perf_counter()
        frame = fast.render(
            cam,
            output_filename=(args.save_first if frame_idx == 0 else None),
        )
        sync()
        times.append(time.perf_counter() - t0)
        assert frame[:, 3].max() > 0.0

    warm = times[2:] if len(times) > 3 else times
    print(
        f"orbit: {len(times)} frames at {args.width}x{args.height} "
        f"AA={args.antialiasing}; first {times[0] * 1e3:.0f} ms (compile), "
        f"steady {min(warm) * 1e3:.1f} ms/frame "
        f"({1.0 / min(warm):.1f} fps)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
