#!/usr/bin/env python3
"""Galaxy-simulation render preset on the PyTorch port.

The port's copy of ``render_galaxy.py`` (python/examples/render_galaxy.py):
deep-AMR render keeping only fine levels (min_level), log-scaled density
with a physical colormap in g/cm^3 and heavy per-box transparency.
Renders on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import amrvolumerenderer_torch as avr

# density colormap in physical units (g/cm^3)
GALAXY_COLOR_MAP = [
    (1.0e-28, 0.00, 0.00, 0.02, 0.00),
    (1.0e-27, 0.01, 0.01, 0.10, 0.02),
    (1.0e-26, 0.05, 0.03, 0.30, 0.06),
    (1.0e-25, 0.12, 0.10, 0.55, 0.12),
    (1.0e-24, 0.30, 0.25, 0.80, 0.25),
    (1.0e-23, 0.60, 0.55, 0.92, 0.45),
    (1.0e-22, 0.90, 0.85, 0.98, 0.70),
    (1.0e-21, 1.00, 1.00, 1.00, 1.00),
]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("plotfile")
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--variable", default="density")
    parser.add_argument("--min-level", type=int, default=8)
    parser.add_argument("--box-transparency", type=float, default=0.985)
    parser.add_argument("--output", default="galaxy.png")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    avr.render(
        plotfile=args.plotfile,
        width=args.width,
        height=args.height,
        variable=args.variable,
        min_level=args.min_level,
        log_scale=True,
        box_transparency=args.box_transparency,
        color_map=GALAXY_COLOR_MAP,
        output=args.output,
        device=args.device,
    )
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
