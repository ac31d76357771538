"""Scene construction: AMR level data -> brick table + scalar transform.

Re-implements the reference SceneBuilder pipeline
(``VolumeRenderer/SceneBuilder.cpp:113-443``) in the single-controller JAX
model: because the host sees the whole scene, the reference's MPI_Allreduce
choreography collapses into plain global reductions; the distribution over
"ranks" becomes an owner assignment over mesh devices done at partition time.

The port's copy of ``amrvolumerenderer_tpu/scene.py``, host part only: the
device statistics and the scene histogram stay in the JAX package
(ROADMAP.md module item 7), and so does the raymarch brick bucketing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

from .types import (
    Brick,
    SceneGeometry,
    VolumeBounds,
    vec3,
)


@dataclasses.dataclass
class LevelGeometry:
    """Per-level grid geometry (SceneBuilder.hpp LevelGridGeometry)."""

    prob_lo: np.ndarray  # (3,) domain lower corner
    cell_size: np.ndarray  # (3,) cell size at this level

    def __post_init__(self):
        self.prob_lo = vec3(self.prob_lo)
        self.cell_size = vec3(self.cell_size)


@dataclasses.dataclass
class LevelBox:
    """One box of cell-centered data within a level's index space."""

    data: np.ndarray  # (nx, ny, nz) scalar values
    lo: np.ndarray  # (3,) integer lower cell index in the level index space

    def __post_init__(self):
        self.lo = np.asarray(self.lo, dtype=np.int64)
        # 3D scalar data, or 4D with a trailing component axis (MultiFab ncomp)
        assert self.data.ndim in (3, 4)


@dataclasses.dataclass
class SceneBuildOptions:
    min_level: int = 0
    max_level: int = 0
    log_scale_input: bool = False
    normalize_to_data_range: bool = True
    no_data_error: str = "Failed to locate any volumetric data."
    invalid_scalar_error: str = "Failed to compute a valid scalar range."


def _scalar_stats_numpy(arrays: Sequence[np.ndarray]):
    """min / max / min-positive / finite-count over all samples
    (SceneBuilder.cpp:53-101) — host float64 oracle path."""
    min_v, max_v, min_pos, count = math.inf, -math.inf, math.inf, 0
    for a in arrays:
        a = np.asarray(a, dtype=np.float64)
        finite = np.isfinite(a)
        n = int(finite.sum())
        if n == 0:
            continue
        vals = a[finite]
        min_v = min(min_v, float(vals.min()))
        max_v = max(max_v, float(vals.max()))
        pos = vals[vals > 0.0]
        if pos.size:
            min_pos = min(min_pos, float(pos.min()))
        count += n
    return min_v, max_v, min_pos, count


def _scalar_stats(arrays: Sequence[np.ndarray]):
    """Scalar statistics of host arrays (SceneBuilder.cpp:53-94): the
    threaded native single pass (``native.scalar_stats``), falling back to
    the NumPy float64 oracle; ``AVR_SCALAR_STATS=numpy|native`` forces a
    path.  Min and max are exact in both, so they agree."""
    import os

    policy = os.environ.get("AVR_SCALAR_STATS", "auto")
    arrays = list(arrays)
    if policy in ("auto", "native"):
        from . import native

        stats = native.scalar_stats(arrays)
        if stats is not None:
            return stats
        if policy == "native":
            raise RuntimeError("native scalar stats unavailable")
    return _scalar_stats_numpy(arrays)


def _make_scalar_range(min_v: float, max_v: float) -> Tuple[float, float]:
    if min_v == max_v:
        max_v = min_v + 1.0
    return float(np.float32(min_v)), float(np.float32(max_v))


def set_scene_normalization_range(
    scene: SceneGeometry, normalization_min: float, normalization_max: float
) -> None:
    """Switch the transform to normalize-to-[0,1] mode
    (SceneBuilder.cpp:427-443)."""
    span = normalization_max - normalization_min
    if not (span > 0.0) or not math.isfinite(span):
        raise RuntimeError(
            "Failed to establish a finite scalar range for color mapping."
        )
    t = scene.scalar_transform
    t.normalize_to_unit_range = True
    t.normalization_min = normalization_min
    t.normalization_max = normalization_max
    t.inverse_normalization_span = 1.0 / span
    scene.scalar_range = (0.0, 1.0)
    scene.has_scalar_range = True


def build_scene_geometry(
    levels: Sequence[Sequence[LevelBox]],
    level_geometry: Sequence[LevelGeometry],
    options: SceneBuildOptions,
) -> SceneGeometry:
    """Build a SceneGeometry from per-level box lists.

    Semantics follow SceneBuilder.cpp:113-425: world corners from
    probLo + index * cellSize; a global rescale so the smallest domain axis
    extent becomes 1; explicit bounds padded by 5% of the largest extent;
    scalar stats feeding the log/normalize transform.
    """
    if len(levels) != len(level_geometry):
        raise ValueError("levels and level_geometry must have matching sizes")

    scene = SceneGeometry()
    data_arrays: List[np.ndarray] = []

    for level in range(options.min_level, options.max_level + 1):
        if level < 0 or level >= len(levels):
            continue
        geom = level_geometry[level]
        for box in levels[level]:
            nx, ny, nz = box.data.shape
            if nx <= 0 or ny <= 0 or nz <= 0:
                continue
            lo = box.lo
            hi = lo + np.array([nx, ny, nz], dtype=np.int64)
            min_corner = geom.prob_lo + lo.astype(np.float64) * geom.cell_size
            max_corner = geom.prob_lo + hi.astype(np.float64) * geom.cell_size
            scene.bricks.append(
                Brick(
                    data=np.ascontiguousarray(box.data, dtype=np.float32),
                    min_corner=min_corner,
                    max_corner=max_corner,
                    level=level,
                )
            )
            data_arrays.append(box.data)

    # global original bounds -> rescale so the smallest axis extent is 1
    # (SceneBuilder.cpp:229-254)
    if scene.bricks:
        g_min = np.min([b.min_corner for b in scene.bricks], axis=0)
        g_max = np.max([b.max_corner for b in scene.bricks], axis=0)
        extent = np.abs(g_max - g_min)
        positive = extent[(extent > 0.0) & np.isfinite(extent)]
        scale = 1.0
        if positive.size:
            min_extent = float(positive.min())
            if min_extent > 0.0 and math.isfinite(min_extent):
                scale = 1.0 / min_extent
        if not math.isfinite(scale) or not (scale > 0.0):
            scale = 1.0
        if scale != 1.0:
            for b in scene.bricks:
                b.min_corner = b.min_corner * scale
                b.max_corner = b.max_corner * scale

    # explicit bounds: tight global + 5% padding (SceneBuilder.cpp:296-313)
    if not scene.bricks:
        raise RuntimeError(options.no_data_error)
    g_min = np.min([b.min_corner for b in scene.bricks], axis=0)
    g_max = np.max([b.max_corner for b in scene.bricks], axis=0)
    extent = g_max - g_min
    max_extent = float(extent.max())
    padding = max_extent * 0.05 if max_extent > 0.0 else 1.0
    scene.explicit_bounds = VolumeBounds(g_min - padding, g_max + padding)

    # scalar stats -> original range (SceneBuilder.cpp:316-352)
    min_v, max_v, min_pos, finite_count = _scalar_stats(data_arrays)
    if finite_count > 0 and math.isfinite(min_v) and math.isfinite(max_v):
        scene.original_scalar_range = _make_scalar_range(min_v, max_v)
        scene.has_original_scalar_range = True

    processed_min, processed_max = min_v, max_v
    t = scene.scalar_transform
    t.log_scale_input = options.log_scale_input
    t.normalize_to_unit_range = False
    t.positive_floor = 0.0

    if options.log_scale_input:
        if not (min_pos > 0.0) or not math.isfinite(min_pos):
            raise RuntimeError(
                "Log scaling requested but no positive scalar values were found."
            )
        t.positive_floor = min_pos
        processed_min = math.log(min_pos)
        processed_max = math.log(max(max_v, min_pos))

    if not math.isfinite(processed_min) or not math.isfinite(processed_max):
        raise RuntimeError(options.invalid_scalar_error)
    if processed_min == processed_max:
        processed_max = processed_min + 1.0

    scene.processed_scalar_range = _make_scalar_range(processed_min, processed_max)
    scene.has_processed_scalar_range = True
    t.processed_min = processed_min
    t.processed_max = processed_max
    t.inverse_processed_span = 1.0 / (processed_max - processed_min)
    t.normalization_min = processed_min
    t.normalization_max = processed_max
    t.inverse_normalization_span = t.inverse_processed_span

    scene.scalar_range = scene.processed_scalar_range
    scene.has_scalar_range = True
    if options.normalize_to_data_range:
        set_scene_normalization_range(scene, processed_min, processed_max)
    return scene
