"""Device-resident in-situ ingestion: render tensors without host copies.

The port of the JAX package's ``device_scene.py``.  The reference's in-situ
API consumes GPU-resident MultiFabs directly (VolumeRendererApi.cpp:44-148:
statistics by a GPU ParReduce, data kept on the device).  Here a
simulation's fields arrive as tensors, and the scalar statistics, the
scene transform, the pre-transform, the cube split and the canonical
packing run on the tensors' device; only O(bricks) metadata and a few
scalars reach the host.

Entry points: ``prepare_device_scene`` (bricks with world corners) and
``prepare_device_amr`` (an AMR hierarchy of boxes), each returning a
``FastSceneRenderer`` whose canonical piece table was assembled on the
device; ``device_scalar_stats`` and ``device_histogram`` are the
reductions.

Rounding follows the JAX package's device route as XLA:CPU runs it: float32
throughout, XLA's ``log`` (``ops/numerics``) and subnormals flushed where
its jitted code flushes them (``transforms``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .device import DEFAULT_DEVICE, Device, resolve_device
from .ops.numerics import MIN_NORMAL
from .scene import _make_scalar_range
from .transforms import apply_scalar_transform, saturate_soft_tail, transform_arrays
from .types import (
    Brick,
    ColorMap,
    RenderParameters,
    SceneGeometry,
    VolumeBounds,
)

Tensor = torch.Tensor


def _stats_reduce(flat: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(min, max, min-positive, finite-count) of one sample tensor, as
    float32 0-d tensors (the count as float64) on its device.

    As the JAX package's jitted reduction runs on XLA:CPU: the samples are
    cast to float32, a positive subnormal counts as positive, but every
    subnormal enters the min and max reductions as a zero of its sign
    (the CPU's denormals-are-zero mode), so a brick holding a positive
    subnormal has a min-positive of 0."""
    v = flat.reshape(-1).to(torch.float32)
    inf = float("inf")
    if v.numel() == 0:
        empty = torch.tensor(inf, device=v.device)
        return empty, -empty, empty, torch.zeros((), dtype=torch.float64,
                                                 device=v.device)
    finite = torch.isfinite(v)
    flushed = torch.where(torch.abs(v) < MIN_NORMAL, v * 0.0, v)
    return (
        torch.where(finite, flushed, inf).amin(),
        torch.where(finite, flushed, -inf).amax(),
        torch.where(finite & (v > 0.0), flushed, inf).amin(),
        finite.sum(dtype=torch.float64),
    )


# samples per concatenated chunk of the reductions (256 MiB of float32)
_CHUNK_SAMPLES = 1 << 26


def _flat_chunks(arrays: Sequence):
    """The arrays as flat float32 tensors where they lie (NumPy arrays on
    the CPU), consecutive ones on one device concatenated up to
    ``_CHUNK_SAMPLES`` samples: a few launches for a scene of thousands of
    small bricks.  Minima, maxima, counts and bins do not depend on the
    grouping."""
    group, size = [], 0
    for a in arrays:
        t = torch.as_tensor(a).reshape(-1).to(torch.float32)
        if group and (t.device != group[0].device
                      or size + t.numel() > _CHUNK_SAMPLES):
            yield torch.cat(group)
            group, size = [], 0
        group.append(t)
        size += t.numel()
    if group:
        yield torch.cat(group)


def _stats_reduce_list(arrays: Sequence) -> Tensor:
    """The four statistics of a list of tensors as one float64 [4] tensor
    on the first one's device: each chunk (``_flat_chunks``) reduces on
    its own device and the per-chunk results meet there."""
    parts = [_stats_reduce(t) for t in _flat_chunks(arrays)]
    dev = parts[0][0].device
    mins, maxs, pos, counts = (
        torch.stack([p[i].to(dev) for p in parts]) for i in range(4))
    return torch.stack([mins.amin().double(), maxs.amax().double(),
                        pos.amin().double(), counts.sum()])


def device_scalar_stats(arrays: Sequence):
    """min / max / min-positive / finite-count of a list of tensors (the
    counterpart of SceneBuilder.cpp:53-101), with a single 4-scalar
    readback however many bricks the scene has."""
    if not arrays:
        return math.inf, -math.inf, math.inf, 0
    min_v, max_v, min_pos, count = _stats_reduce_list(arrays).cpu().tolist()
    return float(min_v), float(max_v), float(min_pos), int(count)


def _pretransform_device(
    data: Tensor, transform, clip_start: float, apply_clip: bool
) -> Tensor:
    """Tensor version of ``renderer_fast._pretransform``
    (VolumeTypes.hpp:53-67 + VolumePainter.cpp:75-105), in float32 on
    ``data``'s device; rounds as the JAX package's
    ``device_scene._pretransform_device`` does (``transforms``)."""
    v = apply_scalar_transform(data.to(torch.float32), **transform_arrays(transform))
    if apply_clip:
        v = saturate_soft_tail(v, clip_start, 1.0)
    return v


def build_device_scene_geometry(
    bricks: Sequence[Tuple[Tensor, Sequence[float], Sequence[float]]],
    log_scale_input: bool = False,
    normalize_to_data_range: bool = True,
) -> SceneGeometry:
    """SceneGeometry from tensors: the semantics of
    ``scene.build_scene_geometry`` (global rescale, padded bounds, scalar
    transform) with the statistics reduced where the tensors lie.

    ``bricks`` is a list of (data [nx, ny, nz] tensor, min_corner,
    max_corner) in world coordinates; each ``Brick.data`` keeps its
    tensor."""
    scene = SceneGeometry()
    arrays = []
    for data, mn, mx in bricks:
        scene.bricks.append(
            Brick(data=data, min_corner=np.asarray(mn, float),
                  max_corner=np.asarray(mx, float))
        )
        arrays.append(data)
    if not scene.bricks:
        raise RuntimeError("Failed to locate any volumetric data.")

    # global rescale: smallest axis extent -> 1 (SceneBuilder.cpp:229-254)
    g_min = np.min([b.min_corner for b in scene.bricks], axis=0)
    g_max = np.max([b.max_corner for b in scene.bricks], axis=0)
    extent = np.abs(g_max - g_min)
    positive = extent[(extent > 0.0) & np.isfinite(extent)]
    scale = 1.0 / positive.min() if positive.size else 1.0
    if not math.isfinite(scale) or not (scale > 0.0):
        scale = 1.0
    if scale != 1.0:
        for b in scene.bricks:
            b.min_corner = b.min_corner * scale
            b.max_corner = b.max_corner * scale

    g_min = np.min([b.min_corner for b in scene.bricks], axis=0)
    g_max = np.max([b.max_corner for b in scene.bricks], axis=0)
    max_extent = float((g_max - g_min).max())
    padding = max_extent * 0.05 if max_extent > 0.0 else 1.0
    scene.explicit_bounds = VolumeBounds(g_min - padding, g_max + padding)

    min_v, max_v, min_pos, finite_count = device_scalar_stats(arrays)
    if finite_count > 0 and math.isfinite(min_v) and math.isfinite(max_v):
        scene.original_scalar_range = _make_scalar_range(min_v, max_v)
        scene.has_original_scalar_range = True

    processed_min, processed_max = min_v, max_v
    t = scene.scalar_transform
    t.log_scale_input = log_scale_input
    if log_scale_input:
        if not (min_pos > 0.0) or not math.isfinite(min_pos):
            raise RuntimeError(
                "Log scaling requested but no positive scalar values were found."
            )
        t.positive_floor = min_pos
        processed_min = math.log(min_pos)
        processed_max = math.log(max(max_v, min_pos))
    if not math.isfinite(processed_min) or not math.isfinite(processed_max):
        raise RuntimeError("Failed to compute a valid scalar range.")
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
    if normalize_to_data_range:
        from .scene import set_scene_normalization_range

        set_scene_normalization_range(scene, processed_min, processed_max)
    return scene


def prepare_device_scene(
    bricks: Sequence[Tuple[Tensor, Sequence[float], Sequence[float]]],
    parameters: RenderParameters,
    color_map: Optional[ColorMap] = None,
    log_scale_input: bool = False,
    precision: str = "float32",
    device: Device = DEFAULT_DEVICE,
):
    """Tensors -> a ready ``FastSceneRenderer`` on ``device``.

    Each brick's data is moved there with ``.to(device)`` (a no-op for a
    tensor already on it); statistics, pre-transform, ghost fill, cube
    split, padding and stacking of the canonical <= 32^3 piece table run
    there, so brick values never cross to the host."""
    from .fast_scene import FastSceneRenderer, _piece_table, _soft_clip

    dev = resolve_device(device)
    bricks = [(torch.as_tensor(data).to(dev), mn, mx) for data, mn, mx in bricks]
    scene = build_device_scene_geometry(bricks, log_scale_input)
    clip_start, apply_clip = _soft_clip(scene.scalar_range)
    # trilinear: ghost rings for seam-free cube splits (fast_scene)
    ghost = 1 if parameters.sampling == "trilinear" else 0
    datas = [
        _pretransform_device(b.data, scene.scalar_transform, clip_start, apply_clip)
        for b in scene.bricks
    ]
    canonical, piece_meta, piece_ranges = _piece_table(datas, scene.bricks, ghost)
    renderer = FastSceneRenderer.__new__(FastSceneRenderer)
    nn.Module.__init__(renderer)
    renderer._init_from_canonical(
        scene, parameters, color_map, canonical, piece_meta, piece_ranges,
        ghost=ghost, precision=precision, device=dev,
    )
    return renderer


def prepare_device_amr(
    level_data: Sequence[Sequence],  # per level: LevelBox or (data, lo) tuples
    level_geometry: Sequence,  # per level: scene.LevelGeometry
    refinement_ratios: Sequence[Sequence[int]] = (),
    parameters: Optional[RenderParameters] = None,
    color_map: Optional[ColorMap] = None,
    min_level: int = 0,
    max_level: int = -1,
    component: int = 0,
    log_scale_input: bool = False,
    precision: str = "float32",
    device: Device = DEFAULT_DEVICE,
):
    """Multi-level in-situ ingestion from tensors: the device counterpart
    of ``api.load_amr_geometry`` + ``FastSceneRenderer``
    (VolumeRendererApi.cpp:44-148).  ``convexify`` runs on the boxes'
    metadata (host integers) while every chopped piece stays a slice of
    its level tensor, so brick values never visit the host.  Returns a
    ready ``FastSceneRenderer`` on ``device``."""
    from .amr import convexify
    from .scene import LevelBox

    if not level_data:
        raise ValueError("levelData must not be empty")
    if len(level_geometry) < len(level_data):
        raise ValueError("levelGeometry must cover every level")
    finest = len(level_data) - 1
    lo_level = max(0, min(min_level, finest))
    hi_level = max_level
    if hi_level < 0 or hi_level > finest:
        hi_level = finest
    if lo_level > hi_level:
        raise RuntimeError("minLevel must not exceed maxLevel")
    if hi_level > 0 and len(refinement_ratios) < hi_level:
        raise ValueError(
            "refinementRatios must provide ratios for each level transition"
        )

    dev = resolve_device(device)
    levels = []
    for boxes in level_data[: hi_level + 1]:
        row = []
        for b in boxes:
            data, lo = (b.data, b.lo) if isinstance(b, LevelBox) else b
            data = torch.as_tensor(data).to(dev)
            if data.ndim == 4:
                data = data[..., component]
            row.append(LevelBox(data, np.asarray(lo)))
        levels.append(row)
    ratios = [tuple(int(v) for v in r) for r in refinement_ratios[:hi_level]]
    flattened = convexify(levels, ratios, materialize=lambda d: d)

    bricks: List = []
    for level in range(lo_level, hi_level + 1):
        geom = level_geometry[level]
        for b in flattened[level]:
            mn = np.asarray(geom.prob_lo) + b.lo * np.asarray(geom.cell_size)
            mx = mn + np.asarray(b.data.shape) * np.asarray(geom.cell_size)
            bricks.append((b.data, mn, mx))
    return prepare_device_scene(
        bricks, parameters or RenderParameters(), color_map,
        log_scale_input=log_scale_input, precision=precision, device=dev,
    )


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------


def _histogram_block_numpy(raw: np.ndarray, bin_count: int, log_scale: bool,
                           normalize: bool, params) -> np.ndarray:
    """The JAX package's ``_histogram_block`` with ``xp=np``: the binning
    of a host brick in NumPy float32 (NumPy's ``log``, no flush)."""
    positive_floor, norm_min, inv_span, range_min, range_width = params
    v = raw.astype(np.float32).ravel()
    v = np.where(np.isfinite(v), v, np.float32(0.0))
    if log_scale:
        v = np.log(np.where(v > 0.0, np.maximum(v, positive_floor),
                            positive_floor))
    if normalize:
        v = np.clip((v - norm_min) * inv_span, 0.0, 1.0)
    v = np.clip(v, range_min, range_min + range_width)
    normalized = np.clip((v - range_min) / range_width, 0.0, 1.0)
    idx = np.clip((normalized * bin_count).astype(np.int32), 0, bin_count - 1)
    return np.bincount(idx, minlength=bin_count)


def _histogram_block(raw: Tensor, bin_count: int, log_scale: bool,
                     normalize: bool, params) -> Tensor:
    """The same binning on a tensor's device, rounding as the JAX
    package's jitted block does on XLA:CPU (``transforms``: XLA's ``log``,
    subnormals flushed).  Returns int64 counts there."""
    positive_floor, norm_min, inv_span, range_min, range_width = (
        float(p) for p in params)
    v = apply_scalar_transform(
        raw.reshape(-1).to(torch.float32), log_scale=log_scale,
        normalize=normalize, positive_floor=positive_floor,
        normalization_min=norm_min, inverse_normalization_span=inv_span)
    hi = float(np.float32(range_min) + np.float32(range_width))
    v = torch.clamp(v, range_min, hi)
    normalized = torch.clamp((v - range_min) / range_width, 0.0, 1.0)
    idx = torch.clamp((normalized * float(bin_count)).to(torch.int64), 0,
                      bin_count - 1)
    return torch.bincount(idx, minlength=bin_count)


def device_histogram(
    arrays: Sequence,
    transform,
    bin_count: int,
    normalized_range: Tuple[float, float],
):
    """Histogram of transformed scalars (the counterpart of
    ``scene.compute_scene_histogram``, SceneBuilder.cpp:445-577).  A NumPy
    brick is binned on the host in NumPy; a tensor brick is binned on its
    own device, and only the ``bin_count`` totals cross to the host.
    Returns ``(counts uint64 [bin_count], total samples)``."""
    if bin_count <= 0:
        raise ValueError("binCount must be positive")
    range_min, range_max = float(normalized_range[0]), float(normalized_range[1])
    range_width = range_max - range_min
    counts = np.zeros(bin_count, dtype=np.uint64)
    total = 0
    if not (range_width > 0.0) or not math.isfinite(range_width):
        return counts, total
    params = tuple(
        np.float32(p) for p in (
            transform.positive_floor, transform.normalization_min,
            transform.inverse_normalization_span, range_min, range_width,
        )
    )
    kw = dict(
        bin_count=bin_count,
        log_scale=bool(transform.log_scale_input),
        normalize=bool(transform.normalize_to_unit_range),
    )
    tensors = []
    for a in arrays:
        if isinstance(a, np.ndarray):
            counts += np.asarray(_histogram_block_numpy(a, params=params, **kw),
                                 dtype=np.uint64)
        else:
            tensors.append(a)
        total += int(np.prod(np.shape(a)))
    device_counts = [_histogram_block(t, params=params, **kw)
                     for t in _flat_chunks(tensors)]
    if device_counts:
        dev = device_counts[0].device
        summed = torch.stack([c.to(dev) for c in device_counts]).sum(dim=0)
        counts += summed.cpu().numpy().astype(np.uint64)
    return counts, total
