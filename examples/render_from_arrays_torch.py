#!/usr/bin/env python3
"""In-situ rendering from in-memory arrays on the PyTorch port.

The port's copy of ``render_from_arrays.py`` (the reference
``insitu_example`` binary, VolumeRenderer/Examples/RenderFromMultiFab.cpp):
build a 32^3 domain on [0,1]^3 split into 16^3 boxes, fill it with the
radius-squared field x^2 + y^2 + z^2, and render a 512^2 PNG through the
in-situ API.  Renders on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from amrvolumerenderer_torch import api
from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--output", default="multifab-render.png")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    n_cells, box_size = 32, 16
    coords = np.arange(n_cells) / (n_cells - 1)
    field = (
        coords[:, None, None] ** 2
        + coords[None, :, None] ** 2
        + coords[None, None, :] ** 2
    )
    boxes = []
    for i0 in range(0, n_cells, box_size):
        for j0 in range(0, n_cells, box_size):
            for k0 in range(0, n_cells, box_size):
                boxes.append(
                    LevelBox(
                        data=field[
                            i0 : i0 + box_size,
                            j0 : j0 + box_size,
                            k0 : k0 + box_size,
                        ],
                        lo=np.array([i0, j0, k0]),
                    )
                )
    geometry = LevelGeometry(prob_lo=np.zeros(3), cell_size=np.full(3, 1.0 / n_cells))
    data = api.AmrData(level_data=[boxes], level_geometry=[geometry])

    options = api.RenderOptions(
        width=args.width, height=args.height, output_filename=args.output,
        device=args.device,
    )
    api.render(data, options)


if __name__ == "__main__":
    main()
