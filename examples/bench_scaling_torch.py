#!/usr/bin/env python3
"""Scaling benchmark on the PyTorch port: a many-brick deep-AMR scene
through the tile-march kernel.

The port's copy of ``bench_scaling.py``.  Renders a turbulence-like scene
split into (domain / 32)^3 bricks at 1024^2 through one tile-march launch
a frame (``ops/tilemarch.py``, ``ops/csrc/tilemarch.cu``), the path whose
device memory is independent of brick count (BASELINE.md config 5
territory).  The kernel is timed with CUDA events around ``--frames``
launches after a warm-up, best of three; ``--device cpu`` runs the plain
version, timed with the host clock.

Renders on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

BOX = 32


def build_scene(n: int, width: int, height: int) -> dict:
    """The tile-march inputs for the turbulence field on an ``n``^3 grid in
    ``BOX``^3 bricks, seen by the auto-orbit camera at ``width`` x
    ``height``: the NumPy tables ``tilemarch_render`` takes, in its
    argument order, under ``"tables"``, and the brick count."""
    from amrvolumerenderer_torch.camera import (
        auto_orbit_camera,
        camera_basis,
        compute_box_depth_hint,
    )
    from amrvolumerenderer_torch.colormap import build_color_table
    from amrvolumerenderer_torch.ops import slicemarch as sm
    from amrvolumerenderer_torch.ops import worklist as wl
    from amrvolumerenderer_torch.types import VolumeBounds

    # synthetic multi-scale "turbulence": sum of sinusoids
    coords = np.arange(n) / n
    x = coords[:, None, None]
    y = coords[None, :, None]
    z = coords[None, None, :]
    field = (
        0.5
        + 0.25 * np.sin(2 * np.pi * 3 * x) * np.cos(2 * np.pi * 5 * y)
        + 0.15 * np.sin(2 * np.pi * 9 * z + 1.0)
        + 0.10 * np.sin(2 * np.pi * 17 * (x + y + z))
    ).astype(np.float32)
    field = np.clip(field, 0.0, 1.0)

    camera = auto_orbit_camera(VolumeBounds((-0.05,) * 3, (1.05,) * 3))
    forward, right, up = camera_basis(camera)
    axis = wl.choose_march_axis(forward)
    axes = [axis] + [a for a in range(3) if a != axis]

    vols, metas, dims_l, hints, bmins, bmaxs = [], [], [], [], [], []
    for i0 in range(0, n, BOX):
        for j0 in range(0, n, BOX):
            for k0 in range(0, n, BOX):
                d = field[i0:i0 + BOX, j0:j0 + BOX, k0:k0 + BOX]
                mn = np.array([i0, j0, k0]) / n
                mx = np.array([i0 + BOX, j0 + BOX, k0 + BOX]) / n
                vol, (ns, nu, nv) = sm.pack_slice_volume(d, axis)
                pmin, pmax = mn[axes], mx[axes]
                m = np.zeros(12, np.float32)
                m[0:3], m[3:6] = pmin, pmax
                m[6:9] = (pmax - pmin) / np.array([ns, nu, nv])
                dd = np.zeros(8, np.int32)
                dd[:3] = (ns, nu, nv)
                dd[3:6] = axes
                vols.append(vol)
                metas.append(m)
                dims_l.append(dd)
                hints.append(compute_box_depth_hint(mn, mx, camera))
                bmins.append(mn)
                bmaxs.append(mx)

    num_bricks = len(vols)
    owners = np.arange(num_bricks, dtype=np.int32)
    lut = wl.build_log_lut(build_color_table(1.0, 1.0, (0.0, 1.0), None))
    cam = wl.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        width / height, 0.0, 1.0, 0.5 / n,
    )
    offsets, tbricks, towners = wl.build_tile_worklist(
        np.stack(bmins), np.stack(bmaxs), np.asarray(hints, np.float32), owners,
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        width, height,
    )
    tables = (np.stack(vols), np.stack(metas), np.stack(dims_l), lut, cam,
              offsets, tbricks, towners)
    return {"tables": tables, "num_bricks": num_bricks}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--domain", type=int, default=128,
                        help="cells per axis (bricks = (domain/32)^3)")
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from amrvolumerenderer_torch.device import resolve_device
    from amrvolumerenderer_torch.ops import tilemarch as tm

    device = resolve_device(args.device)
    width, height = args.width, args.height
    scene = build_scene(args.domain, width, height)
    num_bricks = scene["num_bricks"]
    tbricks = scene["tables"][6]
    print(
        f"{num_bricks} bricks, {len(tbricks)} tile-work items "
        f"(avg {len(tbricks) / (width * height / 1024):.1f} bricks/tile)"
    )
    tables = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in scene["tables"]]

    def frame():
        return tm.tilemarch_render(*tables, width=width, height=height,
                                   max_slices=BOX)

    c, _ = frame()  # warm-up: the first launch builds or loads the kernel
    checksum = float(c[::8].sum())
    assert np.isfinite(checksum) and checksum > 0.0
    print("checksum (one frame):", checksum)

    k = max(1, args.frames)
    times = []
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                frame()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / k)
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                frame()
            times.append((time.perf_counter() - t0) * 1e3 / k)
    print(f"{min(times):.2f} ms/frame at {width}x{height} with {num_bricks} bricks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
