"""In-situ rendering API: the ``amrVolumeRenderer::api`` equivalent.

The port of the JAX package's ``api.py`` (VolumeRendererApi.cpp:257-412):
render in-memory AMR data, or histogram its scalars, with the same
validation, level clamping, convexify step and colormap physical ->
processed -> normalized conversion, plus the ``device`` option (default
``"cuda"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .amr import convexify
from .camera import safe_normalize
from .device import DEFAULT_DEVICE, Device
from .image import ImageBuffer
from .renderer import RenderTiming, render_scene, validate_render_parameters
from .scene import (
    LevelBox,
    LevelGeometry,
    SceneBuildOptions,
    build_scene_geometry,
    compute_scene_histogram,
    set_scene_normalization_range,
)
from .types import (
    CameraParameters,
    ColorMap,
    ColorMapControlPoint,
    RenderParameters,
    ScalarHistogram,
    SceneGeometry,
    vec3,
)


@dataclasses.dataclass
class AmrData:
    """In-memory AMR hierarchy (VolumeRendererApi.hpp:22-26).  A
    multi-component box is a 4D ``(nx, ny, nz, ncomp)`` array."""

    level_data: List[List[LevelBox]]
    level_geometry: List[LevelGeometry]
    refinement_ratios: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list
    )


@dataclasses.dataclass
class RenderOptions:
    """VolumeRendererApi.hpp:28-44, with the JAX package's extensions and
    ``device``."""

    width: int = 512
    height: int = 512
    box_transparency: float = 0.0
    antialiasing: int = 1
    visibility_graph: bool = True
    write_visibility_graph: bool = False
    min_level: int = 0
    max_level: int = -1
    log_scale_input: bool = False
    component: int = 0
    output_filename: str = "volume-renderer.ppm"
    up_vector: Optional[Sequence[float]] = None
    scalar_range: Optional[Tuple[float, float]] = None
    camera: Optional[CameraParameters] = None
    color_map: Optional[ColorMap] = None
    sampling: str = "nearest"  # or "trilinear"
    classification: str = "post"  # or "pre" (trilinear only)
    lut_size: int = 256  # transfer-function LUT entries (multiple of 128)
    devices: Optional[int] = None  # shards of one frame, round-robin over the cards
    render_method: str = "auto"  # auto (= slicemarch), slicemarch, tilemarch, raymarch
    multichip_pipeline: str = "auto"
    multichip_transport: str = "float32"
    device: Device = DEFAULT_DEVICE


@dataclasses.dataclass
class HistogramOptions:
    """VolumeRendererApi.hpp:46-52, with ``device``."""

    min_level: int = 0
    max_level: int = -1
    log_scale_input: bool = False
    bin_count: int = 256
    component: int = 0
    device: Device = DEFAULT_DEVICE


def validate_scalar_range(scalar_range) -> None:
    if scalar_range is None:
        return
    lo, hi = float(scalar_range[0]), float(scalar_range[1])
    if not (math.isfinite(lo) and math.isfinite(hi) and lo < hi):
        raise ValueError(
            "scalar_range must contain two finite values with min < max"
        )


def validate_color_map(color_map: Optional[ColorMap]) -> None:
    """VolumeRendererApi.cpp:163-196."""
    if color_map is None:
        return
    if len(color_map) < 2:
        raise ValueError("color map must provide at least two control points")
    previous = -math.inf
    for p in color_map:
        if not math.isfinite(p.value):
            raise ValueError("color map control point values must be finite")
        if p.value <= previous:
            raise ValueError(
                "color map control point values must be strictly increasing"
            )
        previous = p.value
        for name, c in (("red", p.red), ("green", p.green), ("blue", p.blue),
                        ("alpha", p.alpha)):
            if not math.isfinite(c) or c < 0.0 or c > 1.0:
                raise ValueError(
                    f"color map {name} components must be finite and within [0, 1]"
                )


def validate_camera(camera: Optional[CameraParameters]) -> None:
    """VolumeRendererApi.cpp:198-243."""
    if camera is None:
        return
    for v in (camera.eye, camera.look_at, camera.up):
        if not np.all(np.isfinite(v)):
            raise ValueError("camera vectors must have finite components")
    forward = camera.look_at - camera.eye
    forward_len = float(np.linalg.norm(forward))
    if not (forward_len > 0.0 and math.isfinite(forward_len)):
        raise ValueError("camera eye and look-at must be distinct")
    up_len = float(np.linalg.norm(camera.up))
    if not (up_len > 0.0 and math.isfinite(up_len)):
        raise ValueError("camera up vector must be non-zero")
    if not (float(np.linalg.norm(np.cross(forward, camera.up))) > 1e-6):
        raise ValueError(
            "camera up vector must not be parallel to the view direction"
        )
    if not (math.isfinite(camera.fov_y_degrees) and 0.0 < camera.fov_y_degrees < 180.0):
        raise ValueError("camera fov must be in (0, 180) degrees")
    if not (math.isfinite(camera.near_plane) and camera.near_plane > 0.0):
        raise ValueError("camera near plane must be > 0")
    if not (math.isfinite(camera.far_plane) and camera.far_plane > camera.near_plane):
        raise ValueError("camera far plane must exceed the near plane")


def _select_component(levels: List[List[LevelBox]], component: int) -> List[List[LevelBox]]:
    out: List[List[LevelBox]] = []
    for level in levels:
        boxes = []
        for b in level:
            data = b.data
            if data.ndim == 4:
                if not (0 <= component < data.shape[3]):
                    raise ValueError("component index is out of bounds")
                data = data[..., component]
            elif component != 0:
                raise ValueError("component index is out of bounds")
            boxes.append(LevelBox(np.ascontiguousarray(data), b.lo))
        out.append(boxes)
    return out


def load_amr_geometry(
    data: AmrData,
    requested_min_level: int,
    requested_max_level: int,
    component: int,
    log_scale_input: bool,
    normalize_to_data_range: bool,
    verbose: bool = True,
) -> SceneGeometry:
    """Level clamping + convexify + scene build (VolumeRendererApi.cpp:44-148)."""
    if not data.level_data:
        raise ValueError("levelData must not be empty")
    if len(data.level_geometry) < len(data.level_data):
        raise ValueError("levelGeometry must cover every level")
    finest = len(data.level_data) - 1
    min_level = max(0, min(requested_min_level, finest))
    max_level = requested_max_level
    if max_level < 0 or max_level > finest:
        max_level = finest
    if min_level > max_level:
        raise RuntimeError("minLevel must not exceed maxLevel")
    if max_level > 0 and len(data.refinement_ratios) < max_level:
        raise ValueError(
            "refinementRatios must provide ratios for each level transition"
        )
    levels = _select_component(data.level_data[: max_level + 1], component)
    ratios = [tuple(int(v) for v in r) for r in data.refinement_ratios[:max_level]]
    scene = build_scene_geometry(
        convexify(levels, ratios),
        data.level_geometry[: max_level + 1],
        SceneBuildOptions(
            min_level=min_level,
            max_level=max_level,
            log_scale_input=log_scale_input,
            normalize_to_data_range=normalize_to_data_range,
            no_data_error="Failed to locate any volumetric data within the AMR inputs.",
            invalid_scalar_error="Failed to compute a valid scalar range from the AMR inputs.",
        ),
    )
    if verbose:
        msg = (
            f"Loaded AMR data component {component} across "
            f"{max_level - min_level + 1} level(s)"
        )
        if min_level > 0 or max_level < finest:
            msg += f" (levels {min_level}-{max_level})"
        if normalize_to_data_range:
            msg += "; normalized scalar range [0, 1]"
        else:
            msg += (
                f"; scalar range [{scene.processed_scalar_range[0]:g}, "
                f"{scene.processed_scalar_range[1]:g}]"
            )
        if log_scale_input:
            msg += " (log scaled)"
        print(msg)
    return scene


def apply_scalar_override_and_colormap(
    geometry: SceneGeometry,
    scalar_range: Optional[Tuple[float, float]],
    color_map: Optional[ColorMap],
    log_scale_input: bool,
) -> Optional[ColorMap]:
    """Physical -> processed -> normalized conversion of the scalar override
    and colormap control points (VolumeRenderer.cpp:1478-1556).  Mutates
    ``geometry`` (normalization range); returns the normalized colormap."""
    if not geometry.has_processed_scalar_range:
        raise RuntimeError(
            "Internal error: processed scalar range unavailable for color mapping."
        )
    processed_min, processed_max = geometry.processed_scalar_range
    span = processed_max - processed_min
    if not (span > 0.0 and math.isfinite(span)):
        raise RuntimeError(
            "Failed to establish a finite scalar range for color mapping."
        )

    def to_processed(physical: float) -> float:
        if not math.isfinite(physical):
            raise ValueError("color_map scalar values must be finite.")
        if log_scale_input:
            if not (physical > 0.0):
                raise ValueError(
                    "color_map scalar values must be positive when log scaling "
                    "is enabled."
                )
            return math.log(physical)
        return physical

    normalization_min, normalization_max = processed_min, processed_max
    if scalar_range is not None:
        o_min = to_processed(float(scalar_range[0]))
        o_max = to_processed(float(scalar_range[1]))
        if not (o_min < o_max):
            raise ValueError("scalar_range must contain two values with min < max.")
        normalization_min, normalization_max = o_min, o_max
    normalization_span = normalization_max - normalization_min
    if not (normalization_span > 0.0 and math.isfinite(normalization_span)):
        raise RuntimeError(
            "Failed to establish a finite scalar range for color mapping."
        )
    if scalar_range is not None:
        set_scene_normalization_range(geometry, normalization_min, normalization_max)
    if color_map is None:
        return None
    normalized: ColorMap = []
    for p in color_map:
        value = (to_processed(p.value) - normalization_min) / normalization_span
        if not math.isfinite(value):
            raise ValueError(
                "color_map produced a non-finite normalized scalar value."
            )
        normalized.append(
            ColorMapControlPoint(
                float(np.clip(value, 0.0, 1.0)), p.red, p.green, p.blue, p.alpha
            )
        )
    return normalized


def render(
    data: AmrData, options: RenderOptions, verbose: bool = True
) -> Tuple[ImageBuffer, RenderTiming]:
    """In-situ render entry point (VolumeRendererApi.cpp:257-395) on
    ``options.device``."""
    if not options.output_filename:
        raise ValueError("output filename must not be empty")
    parameters = RenderParameters(
        width=options.width,
        height=options.height,
        box_transparency=options.box_transparency,
        antialiasing=options.antialiasing,
        use_visibility_graph=options.visibility_graph,
        write_visibility_graph=options.write_visibility_graph,
        sampling=options.sampling,
        classification=options.classification,
        lut_size=options.lut_size,
        devices=options.devices,
        render_method=options.render_method,
        multichip_pipeline=options.multichip_pipeline,
        multichip_transport=options.multichip_transport,
    )
    validate_render_parameters(parameters)
    validate_scalar_range(options.scalar_range)
    validate_color_map(options.color_map)
    validate_camera(options.camera)
    if options.up_vector is not None:
        up = vec3(options.up_vector)
        length = float(np.linalg.norm(up))
        if not (length > 0.0 and math.isfinite(length)):
            raise ValueError("up_vector must be non-zero and finite")
        parameters.camera_up = up / length

    geometry = load_amr_geometry(
        data, options.min_level, options.max_level, options.component,
        options.log_scale_input,
        normalize_to_data_range=options.scalar_range is None,
        verbose=verbose,
    )
    normalized_color_map = apply_scalar_override_and_colormap(
        geometry, options.scalar_range, options.color_map, options.log_scale_input
    )
    camera = options.camera
    if camera is not None:
        camera = CameraParameters(
            eye=camera.eye,
            look_at=camera.look_at,
            up=safe_normalize(camera.up),
            fov_y_degrees=camera.fov_y_degrees,
            near_plane=camera.near_plane,
            far_plane=camera.far_plane,
        )
    return render_scene(
        options.output_filename, parameters, geometry, camera=camera,
        color_map=normalized_color_map, verbose=verbose, device=options.device,
    )


def compute_histogram(
    data: AmrData, options: HistogramOptions, verbose: bool = False
) -> ScalarHistogram:
    """In-situ histogram entry point (VolumeRendererApi.cpp:397-412).  The
    bricks are uploaded to ``options.device`` and binned there
    (``device_scene.device_histogram``)."""
    if options.bin_count <= 0:
        raise ValueError("binCount must be positive")
    geometry = load_amr_geometry(
        data,
        options.min_level,
        options.max_level,
        options.component,
        options.log_scale_input,
        normalize_to_data_range=True,
        verbose=verbose,
    )
    return compute_scene_histogram(geometry, options.bin_count,
                                   device=options.device)
