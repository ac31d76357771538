"""Scalar sample transforms on tensors, on any device.

The port of the JAX package's ``transforms.py``: the reference's scalar
pipeline (``Common/VolumeTypes.hpp:33-67``: non-finite samples map to
zero, optional natural-log scaling with a positive floor, optional
normalisation to [0, 1]) and the soft tail clip
(``Common/VolumePainter.cpp:75-105``), in float32.

Every operation rounds as the JAX package's eager device path does under
XLA:CPU: one float32 operation at a time (Python constants rounded to
float32 first), with XLA's own ``log`` (``ops/numerics.log``), and
subnormal inputs and results flushed to zero as XLA:CPU flushes them.  The
same code runs on the CPU and on the card, so both give the same bits.
"""

from __future__ import annotations

import torch

from .colormap import SOFT_CLIP_TOLERANCE
from .ops.march import f32
from .ops.numerics import MIN_NORMAL, log
from .types import ScalarTransform

Tensor = torch.Tensor


def _flush(v: Tensor) -> Tensor:
    """Subnormal values to zero (XLA:CPU's flush-to-zero)."""
    return torch.where(torch.abs(v) < MIN_NORMAL, 0.0, v)


def transform_arrays(transform: ScalarTransform) -> dict:
    """A ScalarTransform as the keyword arguments of
    ``apply_scalar_transform``."""
    return dict(
        log_scale=bool(transform.log_scale_input),
        normalize=bool(transform.normalize_to_unit_range),
        positive_floor=float(transform.positive_floor),
        normalization_min=float(transform.normalization_min),
        inverse_normalization_span=float(transform.inverse_normalization_span),
    )


def apply_scalar_transform(
    raw: Tensor,
    *,
    log_scale: bool,
    normalize: bool,
    positive_floor: float,
    normalization_min: float,
    inverse_normalization_span: float,
) -> Tensor:
    """``applyScalarTransform`` (VolumeTypes.hpp:53-67) on a float32
    tensor."""
    value = _flush(torch.where(torch.isfinite(raw), raw, 0.0))
    if log_scale:
        floor = f32(positive_floor)
        value = torch.where(value > 0.0, torch.clamp(value, min=floor), floor)
        value = log(value)
    if normalize:
        value = (value - f32(normalization_min)) * f32(inverse_normalization_span)
        value = torch.clamp(value, 0.0, 1.0)
    return _flush(value)


def saturate_soft_tail(value: Tensor, clip_start: float, rolloff_end: float) -> Tensor:
    """Soft clip of the scalar tail (VolumePainter.cpp:75-105)."""
    clamped_end = max(clip_start, rolloff_end)
    clamped = torch.clamp(_flush(value), 0.0, f32(clamped_end))
    if not (clamped_end > clip_start + SOFT_CLIP_TOLERANCE):
        return clamped
    start, span = f32(clip_start), f32(clamped_end - clip_start)
    normalized = (clamped - start) / span
    smooth = (normalized + normalized * normalized) - normalized * (normalized * normalized)
    soft = start + span * smooth
    inside = (clamped > start) & (clamped < f32(clamped_end))
    return _flush(torch.where(inside, soft, clamped))
