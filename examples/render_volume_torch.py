#!/usr/bin/env python3
"""Render a plotfile from the command line on the PyTorch port.

The port's copy of ``render_volume.py`` (the reference driver script,
python/examples/render_volume.py): an argparse CLI mirroring the
volume_renderer binary's flags, calling the package-level ``render``.
Renders on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from amrvolumerenderer_torch import render


def parse_arguments(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Render a plotfile with amrvolumerenderer_torch."
    )
    parser.add_argument("plotfile", type=Path, help="Path to the AMReX plotfile")
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument(
        "--box-transparency", type=float, default=0.0,
        help="Transparency factor applied per AMR box in [0, 1]",
    )
    parser.add_argument(
        "--antialiasing", type=int, default=1,
        help="Supersampling factor (must be a perfect square)",
    )
    parser.add_argument(
        "--no-visibility-graph", dest="visibility_graph", action="store_false",
        help="Disable the visibility graph for ordering",
    )
    parser.add_argument("--write-visibility-graph", action="store_true")
    parser.add_argument(
        "--variable", type=str, default=None,
        help="Scalar variable to render (default: first variable in plotfile)",
    )
    parser.add_argument("--min-level", type=int, default=0)
    parser.add_argument("--max-level", type=int, default=-1)
    parser.add_argument("--log-scale", action="store_true")
    parser.add_argument(
        "--up-vector", type=float, nargs=3, metavar=("X", "Y", "Z"), default=None
    )
    parser.add_argument("--output", type=Path, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_arguments(argv)
    render(
        plotfile=str(args.plotfile),
        width=args.width,
        height=args.height,
        box_transparency=args.box_transparency,
        antialiasing=args.antialiasing,
        visibility_graph=args.visibility_graph,
        write_visibility_graph=args.write_visibility_graph,
        variable=args.variable,
        min_level=args.min_level,
        max_level=args.max_level,
        log_scale=args.log_scale,
        up_vector=tuple(args.up_vector) if args.up_vector else None,
        output=str(args.output) if args.output is not None else None,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
