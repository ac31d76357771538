"""The default transfer function, worked out again from its definition.

The reference renderer's built-in map (VolumePainter.cpp:442-516): seven
jet colour nodes on [0, 1] and a six-node opacity ramp placed on the
scalar range, the union of both node sets then stretched onto the scalar
range; colour and opacity are piecewise linear between nodes and held
beyond the ends.  Entry ``i`` of a table of ``size`` maps the scalar
``lo + (hi - lo) * i / (size - 1)``.  Each opacity node is first scaled
to a step ``ratio`` times the reference step: ``1 - (1 - a)^ratio``.
"""

from __future__ import annotations

import numpy as np

JET = np.array([
    (0.0, 0.0, 0.0, 0.5625),
    (0.111111, 0.0, 0.0, 1.0),
    (0.3650795, 0.0, 1.0, 1.0),
    (0.4920635, 0.5, 1.0, 0.5),
    (0.6190475, 1.0, 1.0, 0.0),
    (0.873016, 1.0, 0.0, 0.0),
    (1.0, 0.5, 0.0, 0.0),
])
RAMP_AT = np.array([0.0, 0.15, 0.35, 0.6, 0.85, 1.0])
RAMP_ALPHA = np.array([0.05, 0.15, 0.22, 0.3, 0.38, 0.5])


def table(size: int, lo: float, hi: float, alpha_scale: float = 1.0,
          ratio: float = 1.0) -> np.ndarray:
    """The ``(size, 4)`` float32 RGBA table."""
    span = hi - lo
    colour_at = JET[:, 0].copy()
    ramp_at = RAMP_AT * span + lo
    every = np.concatenate([colour_at, ramp_at])
    old_lo, old_span = every.min(), every.max() - every.min()
    if old_span > 0.0 and span > 0.0:
        colour_at = lo + span * (colour_at - old_lo) / old_span
        ramp_at = lo + span * (ramp_at - old_lo) / old_span
    base = np.clip(RAMP_ALPHA * alpha_scale, 0.0, 1.0)
    alpha_nodes = np.where(base >= 1.0, 1.0, 1.0 - (1.0 - base) ** ratio)
    alpha_nodes = np.where((base <= 0.0) | (ratio <= 0.0), 0.0, alpha_nodes)
    values = lo + span * np.arange(size, dtype=np.float64) / (size - 1)
    rgb = np.stack([np.interp(values, colour_at, JET[:, 1 + c]) for c in range(3)], 1)
    alpha = np.interp(values, ramp_at, alpha_nodes)
    return np.concatenate([rgb, alpha[:, None]], 1).astype(np.float32)


def log_transmittance(rgba: np.ndarray) -> np.ndarray:
    """``log(1 - alpha)`` of each entry (-inf where opaque), float32."""
    with np.errstate(divide="ignore"):
        return np.log1p(-np.clip(rgba[:, 3].astype(np.float64), 0.0, 1.0)).astype(np.float32)
