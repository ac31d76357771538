#!/usr/bin/env python3
"""Camera-orbit animation on the PyTorch port: N frames circling the
look-at point.

The port's copy of ``render_volume_rotate.py``
(python/examples/render_volume_rotate.py): a fixed scalar range keeps the
colour mapping stable across frames, and the runtime is pinned with
initialize_runtime/finalize_runtime around the batch.  Renders on the GPU
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import amrvolumerenderer_torch as avr


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("plotfile")
    parser.add_argument("--frames", type=int, default=36)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--variable", default=None)
    parser.add_argument("--antialiasing", type=int, default=1)
    parser.add_argument("--log-scale", action="store_true")
    parser.add_argument("--box-transparency", type=float, default=0.0)
    parser.add_argument("--scalar-range", type=float, nargs=2, default=None)
    parser.add_argument("--camera-eye", type=float, nargs=3, default=(2.0, 1.5, 2.0))
    parser.add_argument(
        "--camera-look-at", type=float, nargs=3, default=(0.5, 0.5, 0.5)
    )
    parser.add_argument("--fov-y", type=float, default=45.0)
    parser.add_argument("--near", type=float, default=0.1)
    parser.add_argument("--far", type=float, default=10.0)
    parser.add_argument("--output-dir", type=Path, default=Path("orbit_frames"))
    parser.add_argument("--output-prefix", default="frame")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.frames <= 0:
        raise ValueError("--frames must be a positive integer")
    args.output_dir.mkdir(parents=True, exist_ok=True)

    look = args.camera_look_at
    rel = [args.camera_eye[i] - look[i] for i in range(3)]
    horizontal_radius = math.hypot(rel[0], rel[2])
    if not math.isfinite(horizontal_radius) or horizontal_radius <= 0.0:
        raise ValueError(
            "camera-eye must have non-zero horizontal distance from the "
            "look-at point"
        )
    eye_height = rel[1]
    initial_angle = math.atan2(rel[2], rel[0])

    avr.initialize_runtime(args.device)
    try:
        for frame in range(args.frames):
            angle = initial_angle + math.tau * frame / args.frames
            eye = (
                horizontal_radius * math.cos(angle) + look[0],
                eye_height + look[1],
                horizontal_radius * math.sin(angle) + look[2],
            )
            out = args.output_dir / f"{args.output_prefix}_{frame:04d}.png"
            avr.render(
                plotfile=args.plotfile,
                width=args.width,
                height=args.height,
                variable=args.variable,
                output=str(out),
                antialiasing=args.antialiasing,
                log_scale=args.log_scale,
                box_transparency=args.box_transparency,
                scalar_range=tuple(args.scalar_range) if args.scalar_range else None,
                camera_eye=eye,
                camera_look_at=tuple(look),
                camera_up=(0.0, 1.0, 0.0),
                camera_fov_y=args.fov_y,
                camera_near=args.near,
                camera_far=args.far,
                device=args.device,
            )
            print(f"wrote {out}")
    finally:
        avr.finalize_runtime()


if __name__ == "__main__":
    main()
