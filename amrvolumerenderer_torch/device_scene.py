"""Scene data that stays on the device.

The part of the JAX package's ``device_scene.py`` that the in-situ
``FastSceneRenderer.update_data`` path needs: the scalar pre-transform
of a brick held as a tensor, run where the tensor lies.  Device-resident
scene preparation (``prepare_device_scene``), device statistics and the
device histogram are not ported yet (ROADMAP.md module item 7).
"""

from __future__ import annotations

import torch

from .transforms import apply_scalar_transform, saturate_soft_tail, transform_arrays


def _pretransform_device(
    data: torch.Tensor, transform, clip_start: float, apply_clip: bool
) -> torch.Tensor:
    """Tensor version of ``renderer_fast._pretransform``
    (VolumeTypes.hpp:53-67 + VolumePainter.cpp:75-105), in float32 on
    ``data``'s device; rounds as the JAX package's
    ``device_scene._pretransform_device`` does (``transforms``)."""
    v = apply_scalar_transform(data.to(torch.float32), **transform_arrays(transform))
    if apply_clip:
        v = saturate_soft_tail(v, clip_start, 1.0)
    return v
