"""amrvolumerenderer_torch: the AMR volume renderer on PyTorch and CUDA.

A port of ``amrvolumerenderer_tpu`` (JAX/Pallas on a TPU) for one NVIDIA
Hopper GPU: the render path, from plotfile, CLI and API down to
hand-written CUDA kernels (``ops/csrc/``): the slice-march and tile
composite kernels of the one-shot route, the tile-march kernel for
scenes of more than 96 pieces and for the animation path
(``FastSceneRenderer.render_batch``, orbits, in-situ ``update_data``), and
the one-shot multi-device render (``devices=N``: the dense slice-march
kernel per shard and the direct-send exchange, ``parallel/``, over the
processes of a ``torch.distributed`` launch too).  It imports neither jax nor the JAX
package: the host modules (types, scene, amr, plotfile, camera, colormap,
visibility, native) are its own copies.

Public surface: ``render``, ``compute_histogram``, ``initialize_runtime``,
``finalize_runtime``, the in-situ API under ``amrvolumerenderer_torch.api``,
``FastSceneRenderer`` and ``prepare_device_scene`` (in-situ ingestion of
tensors, ``device_scene``).  Every entry that renders takes a ``device``
(default ``"cuda"``, which raises when no GPU is available; ``"cpu"`` runs
the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

from typing import Optional

_manual_ref_count = 0


def initialize_runtime(device: str = "cuda") -> None:
    """Pin runtime initialization across render() calls (the reference's
    refcounted MPI+AMReX lifetime, module.cpp:22-119): resolves the device
    (initialising CUDA) and counts the pin."""
    global _manual_ref_count
    from .device import resolve_device

    resolve_device(device)
    _manual_ref_count += 1


def finalize_runtime() -> None:
    global _manual_ref_count
    if _manual_ref_count == 0:
        raise RuntimeError(
            "amrvolumerenderer_torch.finalize_runtime requires a matching "
            "initialize_runtime call"
        )
    _manual_ref_count -= 1


def render(
    plotfile: str,
    width: int = 512,
    height: int = 512,
    box_transparency: float = 0.0,
    antialiasing: int = 1,
    visibility_graph: bool = True,
    write_visibility_graph: bool = False,
    variable: Optional[str] = None,
    min_level: int = 0,
    max_level: int = -1,
    log_scale: bool = False,
    up_vector=None,
    output: Optional[str] = None,
    scalar_range=None,
    camera_eye=None,
    camera_look_at=None,
    camera_up=None,
    camera_fov_y: Optional[float] = None,
    camera_near: Optional[float] = None,
    camera_far: Optional[float] = None,
    color_map=None,
    devices: Optional[int] = None,
    sampling: str = "nearest",
    classification: str = "post",
    lut_size: int = 256,
    orbit_frames: int = 0,
    orbit_degrees: float = 360.0,
    render_method: str = "auto",
    device: str = "cuda",
) -> int:
    """Render a plotfile: the JAX package's kwarg surface (the reference
    binding, module.cpp:276-303) plus ``device``.  ``orbit_frames`` /
    ``orbit_degrees`` render an N-frame orbit animation through the batched
    renderer (frame index appended to ``output``, as the CLI's
    ``--orbit-frames``).  ``devices=N`` renders one frame over N shards
(placed round-robin over the visible cards; the CPU with
``device="cpu"``); with ``orbit_frames`` too, the orbit renders over N
shards through the persistent multi-device renderer.  ``render_method``
(the CLI's ``--render-method``: auto, slicemarch, tilemarch or raymarch)
selects the kernel route."""
    import math

    import numpy as np
    from .types import CameraParameters, color_map_from_tuples

    from .driver import RunOptions, run_options

    options = RunOptions(
        plotfile_path=plotfile,
        variable_name=variable or "",
        min_level=min_level,
        max_level=max_level,
        log_scale_input=log_scale,
        device=device,
    )
    p = options.parameters
    p.width = width
    p.height = height
    p.box_transparency = box_transparency
    p.antialiasing = antialiasing
    p.use_visibility_graph = visibility_graph
    p.write_visibility_graph = write_visibility_graph
    p.sampling = sampling
    p.classification = classification
    p.lut_size = int(lut_size)
    p.render_method = render_method
    if orbit_frames:
        if int(orbit_frames) <= 0:
            raise ValueError("orbit_frames must be positive")
        options.orbit_frames = int(orbit_frames)
        options.orbit_degrees = float(orbit_degrees)
    if devices is not None:
        if int(devices) <= 0:
            raise ValueError("devices must be a positive device count")
        p.devices = int(devices)
    if output is not None:
        if not output:
            raise ValueError("output filename must not be empty")
        options.output_filename = output
    if up_vector is not None:
        up = np.asarray(up_vector, dtype=np.float64)
        length = float(np.linalg.norm(up))
        if not (length > 0.0) or not np.isfinite(length):
            raise ValueError("up_vector must contain finite, non-zero components")
        p.camera_up = up / length
    if scalar_range is not None:
        lo, hi = float(scalar_range[0]), float(scalar_range[1])
        if not (math.isfinite(lo) and math.isfinite(hi) and lo < hi):
            raise ValueError(
                "scalar_range must contain two finite values with min < max"
            )
        options.scalar_range = (lo, hi)
    if any(v is not None for v in (camera_eye, camera_look_at, camera_up,
                                   camera_fov_y, camera_near, camera_far)):
        if camera_eye is None or camera_look_at is None:
            raise ValueError(
                "camera_eye and camera_look_at must be provided when "
                "specifying a camera"
            )
        up = np.asarray(
            camera_up if camera_up is not None else (0.0, 1.0, 0.0),
            dtype=np.float64,
        )
        up_len = float(np.linalg.norm(up))
        if not (up_len > 0.0) or not math.isfinite(up_len):
            raise ValueError("camera_up must contain finite, non-zero components")
        options.camera = CameraParameters(
            eye=camera_eye,
            look_at=camera_look_at,
            up=up / up_len,
            fov_y_degrees=camera_fov_y if camera_fov_y is not None else 45.0,
            near_plane=camera_near if camera_near is not None else 0.1,
            far_plane=camera_far if camera_far is not None else 1000.0,
        )
    if color_map is not None:
        options.color_map = color_map_from_tuples(color_map)
    return run_options(options)


def compute_histogram(
    plotfile: str,
    variable: Optional[str] = None,
    min_level: int = 0,
    max_level: int = -1,
    log_scale: bool = False,
    bins: int = 256,
    device: str = "cuda",
) -> dict:
    """Histogram of the normalized scalar values used during rendering;
    the reference binding's return dict (module.cpp:304-356).  The
    plotfile's bricks are binned on ``device`` ("cuda" or "cpu")."""
    from .driver import compute_scalar_histogram

    hist = compute_scalar_histogram(
        plotfile, variable or "", min_level, max_level, log_scale, bins,
        device=device,
    )
    return {
        "counts": hist.bin_counts.tolist(),
        "normalized_range": list(hist.normalized_range),
        "processed_range": (
            list(hist.processed_range) if hist.has_processed_range else None
        ),
        "original_range": (
            list(hist.original_range) if hist.has_original_range else None
        ),
        "samples": int(hist.sample_count),
    }


def __getattr__(name):
    # lazy re-exports of the extended (beyond-reference) API surface
    if name == "FastSceneRenderer":
        from .fast_scene import FastSceneRenderer

        return FastSceneRenderer
    if name == "prepare_device_scene":
        from .device_scene import prepare_device_scene

        return prepare_device_scene
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "render",
    "compute_histogram",
    "initialize_runtime",
    "finalize_runtime",
    "FastSceneRenderer",
    "prepare_device_scene",
]
