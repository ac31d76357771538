#!/usr/bin/env python3
"""Time-series rendering on the PyTorch port: render every plt* snapshot
with an orbiting camera.

The port's copy of ``render_volume_time.py``
(python/examples/render_volume_time.py): glob a directory of plotfiles,
advance the camera a step per snapshot, hold the scalar range and a
physical-units colormap fixed so frames are comparable.  Renders on the
GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import math
import os
from pathlib import Path

import amrvolumerenderer_torch as avr

# A 12-point physical-units colormap (value in field units, r, g, b, a)
DEFAULT_COLOR_MAP = [
    (1.0e-4, 0.00, 0.00, 0.05, 0.00),
    (3.0e-4, 0.02, 0.01, 0.15, 0.02),
    (1.0e-3, 0.05, 0.03, 0.35, 0.05),
    (3.0e-3, 0.10, 0.07, 0.55, 0.10),
    (1.0e-2, 0.20, 0.15, 0.75, 0.16),
    (3.0e-2, 0.30, 0.30, 0.85, 0.24),
    (1.0e-1, 0.45, 0.55, 0.90, 0.34),
    (3.0e-1, 0.65, 0.75, 0.95, 0.46),
    (1.0e0, 0.85, 0.90, 0.98, 0.60),
    (3.0e0, 0.95, 0.95, 0.90, 0.75),
    (1.0e1, 1.00, 0.97, 0.70, 0.88),
    (3.0e1, 1.00, 1.00, 1.00, 1.00),
]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("pattern", help="Glob pattern for plotfiles, e.g. 'run/plt*'")
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--variable", default=None)
    parser.add_argument("--antialiasing", type=int, default=1)
    parser.add_argument("--log-scale", action="store_true")
    parser.add_argument("--box-transparency", type=float, default=0.0)
    parser.add_argument("--scalar-range", type=float, nargs=2, default=None)
    parser.add_argument("--orbit-degrees-per-frame", type=float, default=1.0)
    parser.add_argument("--camera-eye", type=float, nargs=3, default=(2.0, 1.5, 2.0))
    parser.add_argument(
        "--camera-look-at", type=float, nargs=3, default=(0.5, 0.5, 0.5)
    )
    parser.add_argument("--use-default-colormap", action="store_true")
    parser.add_argument("--output-dir", type=Path, default=Path("time_frames"))
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    plotfiles = sorted(
        p for p in glob.glob(args.pattern) if os.path.isdir(p)
    )
    if not plotfiles:
        raise SystemExit(f"no plotfiles match '{args.pattern}'")
    args.output_dir.mkdir(parents=True, exist_ok=True)

    look = args.camera_look_at
    rel = [args.camera_eye[i] - look[i] for i in range(3)]
    radius = math.hypot(rel[0], rel[2])
    height = rel[1]
    angle0 = math.atan2(rel[2], rel[0])

    avr.initialize_runtime(args.device)
    try:
        for index, plotfile in enumerate(plotfiles):
            angle = angle0 + math.radians(args.orbit_degrees_per_frame) * index
            eye = (
                radius * math.cos(angle) + look[0],
                height + look[1],
                radius * math.sin(angle) + look[2],
            )
            name = Path(plotfile).name
            out = args.output_dir / f"{name}.png"
            avr.render(
                plotfile=plotfile,
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
                color_map=DEFAULT_COLOR_MAP if args.use_default_colormap else None,
                device=args.device,
            )
            print(f"[{index + 1}/{len(plotfiles)}] wrote {out}")
    finally:
        avr.finalize_runtime()


if __name__ == "__main__":
    main()
