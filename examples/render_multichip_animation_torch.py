"""Persistent multi-device animation on the PyTorch port: bricks resident
on the shards of a mesh.

The port's copy of ``render_multichip_animation.py``.  The one-shot
``devices=N`` option (render_volume_torch.py, api.render) matches the
reference's per-render ``mpirun`` flow: brick tables re-pack and re-upload
every call.  For animation and in-situ serving, ``MultiChipSceneRenderer``
keeps the scene sharded for the whole run: per frame only the 20-float
camera pack, per-piece ordering keys and the validity mask move to the
shards, which render, exchange and fold.  The orbit renders through
``render_batch``: consecutive same-march-axis frames form one chunk with
one readback.

The shards go round-robin over the visible cards (``--devices``, default
one per card), or on the CPU with ``--device cpu``.  Under a several-process
launch (``AVR_DISTRIBUTED=1`` with torchrun, or the JAX package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``)
the shards spread over the processes and process 0 saves the frames.
(Beyond reference: the reference has no persistent-scene API.)
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from amrvolumerenderer_torch import api  # noqa: E402
from amrvolumerenderer_torch.camera import auto_orbit_camera  # noqa: E402
from amrvolumerenderer_torch.driver import maybe_initialize_distributed  # noqa: E402
from amrvolumerenderer_torch.parallel.persistent import (  # noqa: E402
    MultiChipSceneRenderer,
)
from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry  # noqa: E402
from amrvolumerenderer_torch.types import (  # noqa: E402
    CameraParameters,
    RenderParameters,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=256, help="frame edge pixels")
    p.add_argument("--frames", type=int, default=8, help="orbit frame count")
    p.add_argument("--output-dir", default=".", help="where the PPMs go")
    p.add_argument("--devices", type=int, default=None,
                   help="shard count (default: one per visible device)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    distributed = maybe_initialize_distributed(args.device)

    n = 32
    c = (np.arange(n) + 0.5) / n
    field = (
        c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    )
    data = api.AmrData(
        level_data=[[LevelBox(field, np.zeros(3, dtype=int))]],
        level_geometry=[LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))],
    )
    geometry = api.load_amr_geometry(
        data, 0, -1, 0, False, True, verbose=False
    )

    renderer = MultiChipSceneRenderer(
        geometry, RenderParameters(width=args.size, height=args.size),
        num_devices=args.devices, device=args.device,
    )
    devices = renderer.num_devices
    print(f"scene resident on {devices} shard(s); rendering orbit ...")

    base = auto_orbit_camera(renderer.bounds)
    center = 0.5 * (renderer.bounds.min_corner + renderer.bounds.max_corner)
    offset = np.asarray(base.eye) - center
    cams = []
    for k in range(args.frames):
        ang = 2.0 * np.pi * k / 32.0
        cs, sn = np.cos(ang), np.sin(ang)
        eye = center + np.array([
            cs * offset[0] + sn * offset[2],
            offset[1],
            -sn * offset[0] + cs * offset[2],
        ])
        cams.append(CameraParameters(
            eye=tuple(eye), look_at=tuple(center), up=(0, 1, 0)
        ))
    os.makedirs(args.output_dir, exist_ok=True)
    pattern = os.path.join(args.output_dir, "multichip_{:02d}.ppm")
    # batched: consecutive same-march-axis frames form one chunk
    # (render(cam, output_filename=...) serves the per-frame case)
    renderer.render_batch(cams, output_pattern=pattern)
    stats = renderer.last_batch_stats
    print(f"  {args.frames} frames in {stats['dispatch_count']} chunk(s): "
          f"{pattern.format(0)} ..")
    print("done; the scene stayed resident on the shards for every frame")
    if distributed:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
