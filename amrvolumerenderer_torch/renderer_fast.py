"""Fused single-device frame: scene renderer + tile-march kernel.

``_pretransform`` applies the scalar transform and soft tail clip to a
brick once on the host; ``_device_downsample`` is the AA box filter on
the device; ``render_composited_tilemarch`` renders one composited frame
through ``fast_scene.FastSceneRenderer`` (the JAX package routes scenes of
96 pieces or fewer through its slice-march + composite kernels instead;
both routes give the same frame within 1.2e-7, see the golden rows
``slicemarch-1dev`` and ``tilemarch-1dev``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from amrvolumerenderer_tpu.colormap import saturate_soft_tail_np
from amrvolumerenderer_tpu.types import (
    CameraParameters,
    ColorMap,
    RenderParameters,
    SceneGeometry,
)

from .device import DEFAULT_DEVICE, Device


def _pretransform(
    data: np.ndarray, transform, clip_start: float, apply_clip: bool
) -> np.ndarray:
    """Apply the scalar transform (VolumeTypes.hpp:53-67) and the optional
    soft tail clip to a whole brick; returns float32."""
    data = np.asarray(data)
    if (
        data.dtype == np.float32
        and not transform.log_scale_input
        and not transform.normalize_to_unit_range
    ):
        # identity transform on f32 input: the f64 round trip is exact
        v = np.where(np.isfinite(data), data, np.float32(0.0))
        if apply_clip:
            v = saturate_soft_tail_np(v, clip_start, 1.0).astype(np.float32)
        return v
    v = np.asarray(data, dtype=np.float64)
    v = np.where(np.isfinite(v), v, 0.0)
    if transform.log_scale_input:
        v = np.where(v > 0.0, np.maximum(v, transform.positive_floor),
                     transform.positive_floor)
        v = np.log(v)
    if transform.normalize_to_unit_range:
        v = np.clip(
            (v - transform.normalization_min) * transform.inverse_normalization_span,
            0.0, 1.0,
        )
    v = v.astype(np.float32)
    if apply_clip:
        v = saturate_soft_tail_np(v, clip_start, 1.0).astype(np.float32)
    return v


def _device_downsample(
    frame: torch.Tensor, width: int, height: int, block: int
) -> torch.Tensor:
    """Box-average AA downsample of a [width*height, 5] frame on its device
    (VolumeRenderer.cpp:479-528: average RGBA, depth reset to +inf)."""
    tw, th = width // block, height // block
    c = frame[:, :4].reshape(th, block, tw, block, 4).mean(dim=(1, 3))
    d = torch.full((tw * th, 1), float("inf"), dtype=frame.dtype,
                   device=frame.device)
    return torch.cat([c.reshape(tw * th, 4), d], dim=-1)


def render_composited_tilemarch(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    color_map: Optional[ColorMap],
    device: Device = DEFAULT_DEVICE,
) -> np.ndarray:
    """The output-resolution [width*height, 5] composited frame (before the
    wireframe overlay).  The scene renderer derives the scalar range and
    reference sample distance from ``geometry`` as ``render_scene`` does."""
    from .fast_scene import FastSceneRenderer

    if not geometry.bricks:
        out = np.zeros((parameters.width * parameters.height, 5), np.float32)
        out[:, 4] = np.inf
        return out
    renderer = FastSceneRenderer(geometry, parameters, color_map, device=device)
    return renderer.render(camera, overlay=False)
