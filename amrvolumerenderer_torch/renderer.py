"""Render pipeline orchestration: the ``VolumeRenderer`` equivalent.

Mirrors the JAX package's ``renderer.py`` (and VolumeRenderer.cpp's
renderScene / renderSingleTrial flow, cpp:947-1339): bounds and scalar
range, visibility order, the frame on the device (the fused slice-march +
tile composite or tile-march frame, or the raymarch oracle's per-brick
layers folded by ``compositor.composite_layers_device``), the AA
downsample, the bounds wireframe overlay and PPM/PNG output;
``render_orbit`` renders a camera orbit through the batched tile-march
path.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import io as image_io
from . import native
from .camera import auto_orbit_camera, camera_basis, safe_normalize
from .colormap import SOFT_CLIP_TOLERANCE, build_color_table
from .device import DEFAULT_DEVICE, Device, process_index, resolve_device
from .image import ImageBuffer, ImageKind
from .ops import raymarch
from .scene import _scalar_stats, build_brick_buckets
from .types import (
    CameraParameters,
    ColorMap,
    RenderParameters,
    SceneGeometry,
    VolumeBounds,
)
from .visibility import build_visibility_order

K_PI = 3.14159265358979323846


def validate_render_parameters(parameters: RenderParameters) -> None:
    """Parameter validation (VolumeRenderer.cpp:562-579)."""
    if parameters.width <= 0 or parameters.height <= 0:
        raise ValueError("image dimensions must be positive")
    if not (0.0 <= parameters.box_transparency <= 1.0):
        raise ValueError("box transparency must be between 0 and 1")
    if parameters.antialiasing <= 0:
        raise ValueError("antialiasing must be positive")
    sqrt_aa = int(round(math.sqrt(parameters.antialiasing)))
    if sqrt_aa * sqrt_aa != parameters.antialiasing:
        raise ValueError("antialiasing must be a perfect square (1, 4, 9, ...)")
    if parameters.sampling not in ("nearest", "trilinear"):
        raise ValueError("sampling must be \"nearest\" or \"trilinear\"")
    if parameters.render_method not in (
        "auto", "raymarch", "slicemarch", "tilemarch"
    ):
        raise ValueError(
            "render method must be one of auto, raymarch, slicemarch, "
            "tilemarch"
        )
    if parameters.multichip_pipeline not in ("auto", "depth", "layered"):
        raise ValueError(
            "multichip pipeline must be one of auto, depth, layered"
        )
    if parameters.multichip_transport not in ("float32", "ubyte"):
        raise ValueError("multichip transport must be float32 or ubyte")
    if parameters.devices is not None and parameters.devices < 1:
        raise ValueError("devices must be a positive device count")
    if parameters.classification not in ("post", "pre"):
        raise ValueError("classification must be \"post\" or \"pre\"")
    if parameters.lut_size <= 0 or parameters.lut_size % 128 != 0:
        raise ValueError(
            "lut_size must be a positive multiple of 128 (e.g. 128, 256)"
        )
    if (
        parameters.classification == "pre"
        and parameters.sampling == "nearest"
    ):
        raise ValueError(
            "classification=\"pre\" requires sampling=\"trilinear\" "
            "(nearest sampling has no interpolation to reorder)"
        )


def compute_global_bounds(geometry: SceneGeometry) -> VolumeBounds:
    """Global bounds with 5% padding, or the explicit bounds
    (VolumeRenderer.cpp:716-789)."""
    if geometry.has_explicit_bounds:
        return geometry.explicit_bounds
    if not geometry.bricks:
        return VolumeBounds((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    g_min = np.min([b.min_corner for b in geometry.bricks], axis=0)
    g_max = np.max([b.max_corner for b in geometry.bricks], axis=0)
    max_extent = float((g_max - g_min).max())
    padding = max_extent * 0.05 if max_extent > 0.0 else 0.5
    return VolumeBounds(g_min - padding, g_max + padding)


def compute_tight_bounds(
    geometry: SceneGeometry, fallback: VolumeBounds
) -> VolumeBounds:
    """Unpadded global bounds (VolumeRenderer.cpp:791-849)."""
    if not geometry.bricks:
        return fallback
    g_min = np.min([b.min_corner for b in geometry.bricks], axis=0)
    g_max = np.max([b.max_corner for b in geometry.bricks], axis=0)
    return VolumeBounds(g_min, g_max)


def _transformed_range_numpy(geometry: SceneGeometry) -> Tuple[float, float]:
    """The transformed min/max over every sample in float64, brick by
    brick: the oracle ``compute_global_scalar_range`` is held to."""
    t = geometry.scalar_transform
    lo, hi = math.inf, -math.inf
    for brick in geometry.bricks:
        v = np.asarray(brick.data).astype(np.float64)
        v = np.where(np.isfinite(v), v, 0.0)
        if t.log_scale_input:
            v = np.where(v > 0.0, np.maximum(v, t.positive_floor), t.positive_floor)
            v = np.log(v)
        if t.normalize_to_unit_range:
            v = np.clip((v - t.normalization_min) * t.inverse_normalization_span, 0, 1)
        lo = min(lo, float(v.min()))
        hi = max(hi, float(v.max()))
    return lo, hi


def _apply_transform_scalar(v: float, t) -> float:
    """The scalar transform (VolumeTypes.hpp:53-67) on one float64 value."""
    if t.log_scale_input:
        v = max(v, t.positive_floor) if v > 0.0 else t.positive_floor
        v = math.log(v)
    if t.normalize_to_unit_range:
        v = min(max((v - t.normalization_min) * t.inverse_normalization_span,
                    0.0), 1.0)
    return v


def compute_global_scalar_range(geometry: SceneGeometry) -> Tuple[float, float]:
    """Transformed scalar min/max over all bricks (VolumeRenderer.cpp:
    851-878): the transform is monotone, so it is applied to the raw range.
    Non-finite samples count as 0.0."""
    if not geometry.bricks:
        return 0.0, 1.0
    min_v, max_v, _min_pos, count = _scalar_stats(
        [np.asarray(b.data) for b in geometry.bricks]
    )
    total = sum(int(np.prod(np.shape(b.data))) for b in geometry.bricks)
    if count == 0:
        min_v = max_v = 0.0
    elif count < total:
        min_v = min(min_v, 0.0)
        max_v = max(max_v, 0.0)
    t = geometry.scalar_transform
    lo = _apply_transform_scalar(float(min_v), t)
    hi = _apply_transform_scalar(float(max_v), t)
    if not (math.isfinite(lo) and math.isfinite(hi)):
        lo = hi = 0.0
    if lo == hi:
        hi = lo + 1.0
    return lo, hi


def compute_reference_sample_distance(
    geometry: SceneGeometry, bounds: VolumeBounds
) -> float:
    """Half of the coarsest brick's minimum spacing, with degenerate
    fallbacks (VolumeRenderer.cpp:1138-1190)."""
    coarsest = 0.0
    for brick in geometry.bricks:
        ms = brick.min_spacing()
        if ms > 0.0 and math.isfinite(ms):
            coarsest = max(coarsest, ms)
    if not (coarsest > 0.0 and math.isfinite(coarsest)):
        span = bounds.max_corner - bounds.min_corner
        positive = span[(span > 0.0) & np.isfinite(span)]
        fallback = float(positive.min()) if positive.size else 1.0
        coarsest = max(1e-4, fallback * 0.01)
    return max(coarsest * 0.5, 1e-5)


def render_bounding_box_overlay(
    bounds: VolumeBounds,
    camera: CameraParameters,
    sqrt_antialiasing: int,
    layer: ImageBuffer,
) -> None:
    """Antialiased white wireframe of the bounds, blended over the image
    (VolumeRenderer.cpp:139-335).  Mutates ``layer`` in place."""
    width, height = layer.width, layer.height
    if width <= 0 or height <= 0:
        return
    aspect = width / max(height, 1)
    forward = safe_normalize(camera.look_at - camera.eye)
    right = np.cross(forward, camera.up)
    right_len = float(np.linalg.norm(right))
    if right_len > 0 and math.isfinite(right_len):
        right = right / right_len
    else:
        right = np.array([1.0, 0.0, 0.0])
    up_ortho = np.cross(right, forward)
    tan_half_fov = math.tan(camera.fov_y_degrees * 0.5 * K_PI / 180.0)
    width_scale = float(width - 1) if width > 1 else 0.0
    height_scale = float(height - 1) if height > 1 else 0.0

    corners = []
    for idx in range(8):
        corner = np.array([
            bounds.max_corner[0] if idx & 1 else bounds.min_corner[0],
            bounds.max_corner[1] if idx & 2 else bounds.min_corner[1],
            bounds.max_corner[2] if idx & 4 else bounds.min_corner[2],
        ])
        rel = corner - camera.eye
        depth = float(np.dot(rel, forward))
        entry = dict(x=0.0, y=0.0, valid=False)
        if depth > 0.0 and math.isfinite(depth):
            ndc_x = float(np.dot(rel, right)) / (depth * tan_half_fov * aspect)
            ndc_y = float(np.dot(rel, up_ortho)) / (depth * tan_half_fov)
            if math.isfinite(ndc_x) and math.isfinite(ndc_y):
                entry.update(
                    x=(ndc_x * 0.5 + 0.5) * width_scale,
                    y=(ndc_y * 0.5 + 0.5) * height_scale,
                    valid=True,
                )
        corners.append(entry)

    edges = [
        (0, 1), (1, 3), (3, 2), (2, 0),
        (4, 5), (5, 7), (7, 6), (6, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    pixel_radius = 0.5 * max(sqrt_antialiasing, 1)
    influence_radius = pixel_radius + 0.5
    coverage_scale = 0.6
    overlay_depth = np.finfo(np.float32).min
    pixels = layer.pixels  # [H*W, 5] view

    for e0, e1 in edges:
        start, end = corners[e0], corners[e1]
        if not (start["valid"] and end["valid"]):
            continue
        x_begin = max(0, int(math.floor(min(start["x"], end["x"]) - influence_radius)))
        x_end = min(width - 1, int(math.ceil(max(start["x"], end["x"]) + influence_radius)))
        y_begin = max(0, int(math.floor(min(start["y"], end["y"]) - influence_radius)))
        y_end = min(height - 1, int(math.ceil(max(start["y"], end["y"]) + influence_radius)))
        if x_end < x_begin or y_end < y_begin:
            continue
        edge_dx = end["x"] - start["x"]
        edge_dy = end["y"] - start["y"]
        edge_len_sq = edge_dx * edge_dx + edge_dy * edge_dy
        if edge_len_sq <= 0.0:
            # degenerate edge: one full-coverage pixel at the start corner
            px = int(round(start["x"]))
            py = int(round(start["y"]))
            if 0 <= px < width and 0 <= py < height:
                idx = py * width + px
                src_a = 1.0
                pixels[idx, :3] = 1.0 * src_a + pixels[idx, :3] * (1.0 - src_a)
                pixels[idx, 3] = src_a + pixels[idx, 3] * (1.0 - src_a)
                pixels[idx, 4] = overlay_depth
            continue
        xs = np.arange(x_begin, x_end + 1)
        ys = np.arange(y_begin, y_end + 1)
        sample_x = xs[None, :] + 0.5
        sample_y = ys[:, None] + 0.5
        t = np.clip(
            ((sample_x - start["x"]) * edge_dx + (sample_y - start["y"]) * edge_dy)
            / edge_len_sq, 0.0, 1.0,
        )
        dist = np.sqrt(
            (sample_x - (start["x"] + edge_dx * t)) ** 2
            + (sample_y - (start["y"] + edge_dy * t)) ** 2
        )
        coverage = np.clip((pixel_radius + 0.5 - dist) * coverage_scale, 0.0, 1.0)
        mask = coverage > 0.0
        if not np.any(mask):
            continue
        yy, xx = np.nonzero(mask)
        flat = (ys[yy] * width + xs[xx]).astype(np.int64)
        src_a = coverage[yy, xx].astype(np.float32)
        one_minus = 1.0 - src_a
        for ch in range(4):
            pixels[flat, ch] = src_a + pixels[flat, ch] * one_minus
        pixels[flat, 4] = overlay_depth


def downsample_image(
    source: ImageBuffer, target_width: int, target_height: int, sqrt_aa: int
) -> ImageBuffer:
    """Supersample box-average downsample (VolumeRenderer.cpp:479-528)."""
    block = max(sqrt_aa, 1)
    if block <= 1:
        raise ValueError("downsample expects sqrtAA > 1")
    out = ImageBuffer.create(
        ImageKind.RGBA_F32_DEPTH_SORT, target_width, target_height
    )
    avg = native.downsample_box(
        np.asarray(source.pixels, dtype=np.float32),
        target_width, target_height, block,
    )
    if avg is None:
        src = source.pixels[:, :4].reshape(
            target_height, block, target_width, block, 4
        )
        avg = src.mean(axis=(1, 3)).astype(np.float32).reshape(-1, 4)
    out.pixels[:, :4] = avg
    out.pixels[:, 4] = np.inf
    return out


@dataclasses.dataclass
class RenderTiming:
    render_seconds: float = 0.0
    visibility_seconds: float = 0.0
    composite_seconds: float = 0.0


def _build_camera_arrays(camera: CameraParameters, device: Device = DEFAULT_DEVICE):
    """(eye, forward, right, up) of ``camera`` as float32 [3] tensors on
    ``device``."""
    forward, right, up = camera_basis(camera)
    dev = resolve_device(device)
    return tuple(
        torch.tensor(np.asarray(v, np.float32), device=dev)
        for v in (camera.eye, forward, right, up)
    )


def resolve_render_method(method: str, sampling: str = "nearest") -> str:
    """The kernel route for ``method``: ``"slicemarch"`` (and ``"auto"``,
    since the port's accelerator is the card; the JAX package resolves
    ``auto`` to the raymarch oracle off the TPU) is the one-shot
    slice-march + tile composite route, which hands scenes of more than 96
    pieces to the tile-march kernel; ``"tilemarch"`` is the tile-march
    route; ``"raymarch"`` is the oracle with exact reference semantics
    (``ops.raymarch``), nearest sampling only."""
    if method in ("auto", "slicemarch"):
        return "slicemarch"
    if method not in ("raymarch", "tilemarch"):
        raise ValueError(f"unknown render method '{method}'")
    if method == "raymarch" and sampling == "trilinear":
        raise ValueError("sampling=\"trilinear\" requires the slicemarch "
                         "or tilemarch method")
    return method


def _render_layers_raymarch(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    bounds: VolumeBounds,
    scalar_range: Tuple[float, float],
    reference_sample_distance: float,
    render_width: int,
    render_height: int,
    color_map: Optional[ColorMap],
    device: torch.device,
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, np.ndarray]:
    """The raymarch oracle's layers: every brick marched into a
    full-frame RGBA + depth layer of a ``[L, P, 5]`` stack on ``device``
    (one ``ops.raymarch`` call per bucket of same-shape bricks), with the
    layer order keys, owners and local indices on the host.  Every brick
    lies in one bucket and each call writes its bricks' rows whole, so the
    stack needs no clear."""
    from .visibility import order_keys_or_hints

    bricks = geometry.bricks
    num_bricks = len(bricks)
    layers = torch.empty((num_bricks, render_width * render_height, 5),
                         dtype=torch.float32, device=device)

    alpha_scale = float(np.clip(1.0 - parameters.box_transparency, 0.0, 1.0))
    clip_start = float(np.clip(scalar_range[1], 0.0, 1.0))
    apply_clip = 1.0 > clip_start + SOFT_CLIP_TOLERANCE
    t = geometry.scalar_transform
    eye, fwd, right, up = _build_camera_arrays(camera, device)

    # fallback spacing when a brick has no positive spacing
    # (VolumePainter.cpp:593-597)
    span = bounds.max_corner - bounds.min_corner
    fallback_spacing = max(1e-4, float(min(span)) * 0.01)
    range_span = scalar_range[1] - scalar_range[0]
    inverse_range = float(np.float32(1.0 / range_span if range_span != 0.0 else 1.0))
    lut_cache: Dict[float, np.ndarray] = {}
    for bucket in build_brick_buckets(bricks):
        n = len(bucket.brick_indices)
        sample_distances = np.zeros(n, dtype=np.float32)
        luts = np.zeros((n, parameters.lut_size, 4), dtype=np.float32)
        for slot, idx in enumerate(bucket.brick_indices):
            ms = bricks[int(idx)].min_spacing()
            if not (ms > 0.0 and math.isfinite(ms)):
                ms = fallback_spacing
            sample_distance = max(ms * 0.5, 1e-5)
            sample_distances[slot] = sample_distance
            ref = reference_sample_distance
            if not (ref > 0.0 and math.isfinite(ref)):
                ref = sample_distance
            normalization_factor = sample_distance / ref
            if not math.isfinite(normalization_factor):
                normalization_factor = 1.0
            normalization_factor = max(normalization_factor, 0.0)
            key = round(normalization_factor, 12)
            if key not in lut_cache:
                lut_cache[key] = build_color_table(
                    alpha_scale, normalization_factor, scalar_range, color_map,
                    size=parameters.lut_size,
                )
            luts[slot] = lut_cache[key]
        raymarch.render_bucket_into(
            layers, bucket.brick_indices.astype(np.int64), bucket.data,
            bucket.min_corner, bucket.max_corner, bucket.cell_dims, luts,
            sample_distances, eye, fwd, right, up, camera.fov_y_degrees,
            float(np.float32(scalar_range[0])), inverse_range,
            float(np.float32(t.positive_floor)),
            float(np.float32(t.normalization_min)),
            float(np.float32(t.inverse_normalization_span)),
            width=render_width, height=render_height,
            num_steps=raymarch.max_steps_for_bucket(
                bucket.min_corner, bucket.max_corner, sample_distances),
            log_scale=bool(t.log_scale_input),
            normalize=bool(t.normalize_to_unit_range),
            clip_start=clip_start, apply_clip=bool(apply_clip),
        )

    # layer order keys: brick-level visibility-graph positions, or the
    # nearest-corner depth hints (visibility.order_keys_or_hints)
    depth_hints = order_keys_or_hints(
        camera, render_width / max(render_height, 1),
        np.array([b.min_corner for b in bricks]),
        np.array([b.max_corner for b in bricks]),
        use_graph=parameters.use_visibility_graph,
    )
    owners = np.array([b.owner for b in bricks], dtype=np.int32)
    # local index = position within the owner's local brick list
    local_indices = np.zeros(num_bricks, dtype=np.int32)
    counters: Dict[int, int] = {}
    for i, b in enumerate(bricks):
        local_indices[i] = counters.get(b.owner, 0)
        counters[b.owner] = local_indices[i] + 1
    return layers, depth_hints, owners, local_indices


def render_layers(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    bounds: VolumeBounds,
    scalar_range: Tuple[float, float],
    reference_sample_distance: float,
    render_width: int,
    render_height: int,
    color_map: Optional[ColorMap],
    method: str = "auto",
    device: Device = DEFAULT_DEVICE,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Every piece rendered into a full-frame RGBA+depth layer on
    ``device``: (layers [L, P, 5], depth_hints [L], owners [L],
    local_indices [L]) on the host.  ``"raymarch"`` marches every brick
    (the oracle; L = bricks), the slice-march route every split piece
    (``renderer_fast.render_layers_slicemarch``).  ``"tilemarch"`` has no
    layered route."""
    resolved = resolve_render_method(method, parameters.sampling)
    dev = resolve_device(device)
    if resolved == "raymarch":
        layers, hints, owners, local = _render_layers_raymarch(
            geometry, parameters, camera, bounds, scalar_range,
            reference_sample_distance, render_width, render_height, color_map,
            dev)
        return layers.cpu().numpy(), hints, owners, local
    if resolved != "slicemarch":
        raise ValueError(
            f"render method '{method}' has no layered route; use raymarch "
            "or slicemarch"
        )
    from .renderer_fast import render_layers_slicemarch

    return render_layers_slicemarch(
        geometry, parameters, camera, bounds, scalar_range,
        reference_sample_distance, render_width, render_height, color_map,
        device=dev,
    )


def render_single_trial(
    output_filename: str,
    parameters: RenderParameters,
    geometry: SceneGeometry,
    bounds: VolumeBounds,
    scalar_range: Tuple[float, float],
    camera: CameraParameters,
    color_map: Optional[ColorMap],
    num_ranks: int = 1,
    verbose: bool = True,
    method: str = "auto",
    device: Device = DEFAULT_DEVICE,
) -> Tuple[ImageBuffer, RenderTiming]:
    """One full render: visibility order, the frame on ``device`` (the
    fused render + composite + AA downsample, over ``parameters.devices``
    shards when more than one; or for ``"raymarch"`` the oracle's layers
    folded on the device, read back and downsampled on the host), overlay,
    save (VolumeRenderer.cpp:1103-1339).  ``scalar_range`` must be the one
    ``render_scene`` derives from ``geometry``."""
    from .compositor import composite_layers_device
    from .renderer_fast import (
        render_composited_sharded,
        render_composited_slicemarch,
        render_composited_tilemarch,
        visibility_owner_keys,
    )

    dev = resolve_device(device)
    num_devices = parameters.devices or 1
    if num_devices < 1:
        raise ValueError("devices must be a positive device count")
    resolved = resolve_render_method(method, parameters.sampling)
    if num_devices > 1 and method not in ("auto", "slicemarch"):
        # the sharded pipelines are slice-march based; overriding an
        # explicitly requested kernel would hand back other pixels unasked
        raise ValueError(
            f"render method '{method}' is single-device; multi-device "
            "rendering uses the slicemarch pipeline (use 'auto' or "
            "'slicemarch' with devices > 1)"
        )
    timing = RenderTiming()
    sqrt_aa = max(int(round(math.sqrt(parameters.antialiasing))), 1)
    render_width = parameters.width * sqrt_aa
    render_height = parameters.height * sqrt_aa
    reference_sample_distance = compute_reference_sample_distance(geometry, bounds)
    tight_bounds = compute_tight_bounds(geometry, bounds)

    # visibility ordering first: its rank permutation breaks depth-hint ties
    # between owners in the composite (and feeds the DOT export)
    t0 = time.perf_counter()
    if geometry.bricks:
        box_min = np.stack([b.min_corner for b in geometry.bricks])
        box_max = np.stack([b.max_corner for b in geometry.bricks])
    else:
        box_min = box_max = np.zeros((0, 3))
    rank_order = build_visibility_order(
        camera,
        parameters.width / parameters.height,
        box_min,
        box_max,
        np.array([b.owner for b in geometry.bricks], dtype=np.int32),
        num_ranks,
        parameters.use_visibility_graph,
        parameters.write_visibility_graph,
        log=verbose,
    )
    timing.visibility_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    if num_devices > 1:
        # the shards of one process over the visible cards (round-robin);
        # the reference's mpirun distribution (VolumeRenderer.cpp:1201-1249)
        composited = render_composited_sharded(
            geometry, parameters, camera, scalar_range,
            reference_sample_distance, render_width, render_height,
            color_map, num_devices, downsample_block=sqrt_aa,
            pipeline=parameters.multichip_pipeline,
            transport=parameters.multichip_transport,
            rank_order=rank_order, device=dev,
        )
    elif resolved == "raymarch":
        layers, depth_hints, owners, local_indices = _render_layers_raymarch(
            geometry, parameters, camera, bounds, scalar_range,
            reference_sample_distance, render_width, render_height, color_map,
            dev,
        )
    elif resolved == "tilemarch":
        composited = render_composited_tilemarch(
            geometry, parameters, camera, scalar_range,
            reference_sample_distance, render_width, render_height,
            color_map, downsample_block=sqrt_aa, rank_order=rank_order,
            device=dev,
        )
    else:
        composited = render_composited_slicemarch(
            geometry, parameters, camera, scalar_range,
            reference_sample_distance, render_width, render_height,
            color_map, downsample_block=sqrt_aa, rank_order=rank_order,
            device=dev,
        )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timing.render_seconds = time.perf_counter() - t0
    if verbose:
        print(f"Render: per-box rendering took {timing.render_seconds:.4f} s")
        print(
            "Render: visibility graph computation took "
            f"{timing.visibility_seconds:.4f} s"
        )
    if resolved == "raymarch":
        # the layered fold on the device (composeLayered), then the frame
        # crosses to the host for the AA downsample
        t0 = time.perf_counter()
        composited = composite_layers_device(
            layers, depth_hints, visibility_owner_keys(owners, rank_order),
            local_indices,
        ).cpu().numpy()
        del layers
        timing.composite_seconds = time.perf_counter() - t0
        full = ImageBuffer(ImageKind.RGBA_F32_DEPTH_SORT, render_width,
                           render_height, composited)
        output_image = (
            downsample_image(full, parameters.width, parameters.height, sqrt_aa)
            if sqrt_aa > 1 else full
        )
    else:
        output_image = ImageBuffer(
            ImageKind.RGBA_F32_DEPTH_SORT, parameters.width, parameters.height,
            composited,
        )
    if verbose:
        print(f"Render: compositing took {timing.composite_seconds:.4f} s")
        print(
            f"Render: composed {render_width * render_height}"
            " pixels on rank 0"
        )
    render_bounding_box_overlay(tight_bounds, camera, 1, output_image)

    if output_filename and process_index() == 0:
        lower = output_filename.lower()
        ext = lower[lower.rfind("."):] if "." in lower else ""
        if ext and ext not in (".ppm", ".png") and verbose:
            print(
                f"Render: unrecognized image extension '{ext}', "
                "defaulting to PPM output."
            )
        saved = image_io.save_image(output_image, output_filename)
        if verbose:
            if saved:
                print(f"Saved volume composited image to '{output_filename}'")
            else:
                print(f"Failed to save composited image to '{output_filename}'")
    return output_image, timing


def render_scene(
    output_filename: str,
    parameters: RenderParameters,
    geometry: SceneGeometry,
    camera: Optional[CameraParameters] = None,
    color_map: Optional[ColorMap] = None,
    num_ranks: int = 1,
    verbose: bool = True,
    method: str = "auto",
    device: Device = DEFAULT_DEVICE,
) -> Tuple[ImageBuffer, RenderTiming]:
    """Render with an explicit camera, or the seeded auto-orbit camera
    (VolumeRenderer.cpp:947-1101)."""
    if method == "auto":
        method = parameters.render_method
    validate_render_parameters(parameters)
    dev = resolve_device(device)
    if verbose:
        name = (
            f"{dev} ({torch.cuda.get_device_name(dev)})"
            if dev.type == "cuda" else "cpu"
        )
        print(f"volume_renderer: Using PyTorch volume mapper on {name}")

    bounds = compute_global_bounds(geometry)
    scalar_range = (
        geometry.scalar_range
        if geometry.has_scalar_range
        else compute_global_scalar_range(geometry)
    )
    if camera is None:
        camera = auto_orbit_camera(
            bounds, parameters.camera_seed, parameters.camera_up
        )
        label = "automatic"
    else:
        label = "explicit"
    if parameters.print_camera and verbose:
        print(
            f"Camera parameters ({label}):\n"
            f"  eye      = ({camera.eye[0]:g}, {camera.eye[1]:g}, {camera.eye[2]:g})\n"
            f"  look_at  = ({camera.look_at[0]:g}, {camera.look_at[1]:g}, "
            f"{camera.look_at[2]:g})\n"
            f"  up       = ({camera.up[0]:g}, {camera.up[1]:g}, {camera.up[2]:g})\n"
            f"  fov_y    = {camera.fov_y_degrees:g} degrees\n"
            f"  near     = {camera.near_plane:g}\n"
            f"  far      = {camera.far_plane:g}"
        )
    return render_single_trial(
        output_filename, parameters, geometry, bounds, scalar_range, camera,
        color_map, num_ranks=num_ranks, verbose=verbose, method=method,
        device=dev,
    )


def render_orbit(
    output_pattern: str,
    parameters: RenderParameters,
    geometry: SceneGeometry,
    frames: int,
    camera: Optional[CameraParameters] = None,
    color_map: Optional[ColorMap] = None,
    total_degrees: float = 360.0,
    verbose: bool = True,
    device: Device = DEFAULT_DEVICE,
) -> None:
    """Render a ``frames``-frame orbit animation through the persistent
    batched renderer: the scene is prepared once
    (``fast_scene.FastSceneRenderer``, or over ``parameters.devices``
    shards ``parallel.persistent.MultiChipSceneRenderer``) and consecutive
    frames render in batched chunks (``render_batch``).  The base camera
    (explicit, or the seeded auto-orbit of VolumeRenderer.cpp:974-1023) is
    frame 0 exactly; later frames rotate it about the up axis
    (``camera.orbit_camera_sequence``).  Beyond reference as a product
    surface: the reference's rotation miniapp re-runs the whole pipeline
    per frame (python/examples/render_volume_rotate.py).

    ``output_pattern`` must contain a ``{}``-style field for the frame
    index (e.g. ``"frame_{:04d}.png"``)."""
    from .camera import orbit_camera_sequence
    from .fast_scene import FastSceneRenderer

    validate_render_parameters(parameters)
    if frames <= 0:
        raise ValueError("orbit frames must be positive")
    if parameters.render_method not in ("auto", "slicemarch", "tilemarch"):
        raise ValueError(
            "orbit rendering runs on the fast kernel family; "
            "render_method must be auto, slicemarch, or tilemarch "
            f"(got {parameters.render_method!r})"
        )
    try:
        output_pattern.format(0)
    except (IndexError, KeyError, ValueError) as error:
        raise ValueError(
            f"orbit output pattern {output_pattern!r} must format a frame "
            "index (e.g. 'frame_{:04d}.png')"
        ) from error
    dev = resolve_device(device)
    if verbose:
        name = (
            f"{dev} ({torch.cuda.get_device_name(dev)})"
            if dev.type == "cuda" else "cpu"
        )
        print(f"volume_renderer: Using PyTorch volume mapper on {name}")
    bounds = compute_global_bounds(geometry)
    if camera is None:
        camera = auto_orbit_camera(
            bounds, parameters.camera_seed, parameters.camera_up
        )
    cameras = orbit_camera_sequence(camera, frames, total_degrees)
    devices = parameters.devices or 1
    if devices > 1:
        from .parallel.persistent import MultiChipSceneRenderer

        renderer = MultiChipSceneRenderer(
            geometry, parameters, num_devices=devices, color_map=color_map,
            transport=parameters.multichip_transport, device=dev,
        )
    else:
        renderer = FastSceneRenderer(geometry, parameters, color_map, device=dev)
    start = time.perf_counter()
    renderer.render_batch(cameras, output_pattern=output_pattern)
    if verbose:
        elapsed = time.perf_counter() - start
        print(
            f"Render: {frames} orbit frame(s) took {elapsed:.4f} s "
            f"({elapsed / frames * 1e3:.2f} ms/frame incl. host prep)"
        )
        if process_index() == 0:
            print(f"Saved orbit frames to '{output_pattern}'")
