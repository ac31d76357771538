"""Plotfile-driven rendering: RunOptions, CLI parsing and the run pipeline.

The port of the JAX package's ``driver.py`` (the reference driver,
VolumeRenderer.cpp:339-477 and main.cpp): the same flag surface plus
``--device`` (default ``cuda``).  Run it as
``python -m amrvolumerenderer_torch.driver [options] plotfile``, once per
process under a several-process launch (``maybe_initialize_distributed``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from .amr import convexify
from .api import apply_scalar_override_and_colormap, validate_camera
from .camera import safe_normalize
from .device import DEFAULT_DEVICE, process_index
from .plotfile import (
    read_plotfile_header,
    write_plotfile,  # noqa: F401 - re-exported for scripts that make plotfiles
)
from .renderer import render_orbit, render_scene, validate_render_parameters
from .scene import SceneBuildOptions, build_scene_geometry, compute_scene_histogram
from .types import (
    CameraParameters,
    ColorMap,
    RenderParameters,
    ScalarHistogram,
    SceneGeometry,
)
from .utils.timers import device_trace

USAGE = """Usage: volume_renderer [options] plotfile
  --width W        Image width (default: 512)
  --height H       Image height (default: 512)
  --antialiasing A Supersampling factor (positive integer square, default: 1)
  --box-transparency T  Transparency factor per box in [0,1] (default: 0)
  --visibility-graph  Enable topological ordering using a visibility graph (default)
  --no-visibility-graph  Disable topological ordering using a visibility graph
  --write-visibility-graph  Export visibility graph DOT files (default: disabled)
  --variable NAME  Scalar variable to render (default: first variable in plotfile)
  --max-level L    Finest AMR level to include (default: plotfile finest level)
  --min-level L    Coarsest AMR level to include (default: 0)
  --up-vector X Y Z  Camera up vector components (default: 0 1 0)
  --print-camera   Emit the camera parameters selected automatically
  --log-scale      Apply natural log scaling before normalizing the input field
  --output FILE    Output filename (supports .ppm or .png; default: volume-renderer.ppm)
  --device D       Torch device to render on: cuda (default) or cpu (the plain
                   PyTorch path); cuda fails when no GPU is available
  --devices N      Render over N shards (default 1), placed round-robin
                   over the visible cards (or on the CPU with --device cpu);
                   with --orbit-frames the orbit renders over N shards with
                   the bricks resident (the persistent multi-device renderer);
                   under a several-process launch (AVR_DISTRIBUTED=1 with
                   torchrun, or JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES
                   and JAX_PROCESS_ID) the N shards spread over the processes
  --render-method M  Kernel route: auto (= slicemarch), slicemarch (march +
                   tile composite kernels; scenes of more than 96 pieces go
                   to tile-march), tilemarch, or raymarch (the per-pixel
                   oracle with exact reference semantics; nearest sampling,
                   one device)
  --trace-dir DIR  Write a torch.profiler Chrome trace of the render into DIR
  --classification MODE  Transfer-function classification for trilinear
                   sampling: post (default) or pre
  --sampling MODE  Scalar sampling: nearest (reference semantics, default)
                   or trilinear
  --lut-size N     Transfer-function LUT resolution: 256 (default) or 128
  --orbit-frames N Render an N-frame orbit animation instead of one frame:
                   the camera circles the look-at point about the up axis,
                   scene prepared once and frames batched per kernel
                   launch; frame index is appended to --output
                   (frame.png -> frame_0000.png; beyond reference)
  --orbit-degrees D  Total orbit sweep in degrees (default: 360)
  -h, --help       Show this help message
"""


@dataclasses.dataclass
class RunOptions:
    """VolumeRenderer.hpp:60-72, plus the device."""

    parameters: RenderParameters = dataclasses.field(default_factory=RenderParameters)
    output_filename: str = "volume-renderer.ppm"
    plotfile_path: str = ""
    variable_name: str = ""
    min_level: int = 0
    max_level: int = -1
    log_scale_input: bool = False
    exit_early: bool = False
    camera: Optional[CameraParameters] = None
    scalar_range: Optional[Tuple[float, float]] = None
    color_map: Optional[ColorMap] = None
    trace_dir: str = ""
    orbit_frames: int = 0
    orbit_degrees: float = 360.0
    device: str = DEFAULT_DEVICE


def parse_options(argv: List[str]) -> RunOptions:
    """CLI flag parsing with the reference's surface and validation
    (VolumeRenderer.cpp:368-477)."""
    parsed = RunOptions()
    p = parsed.parameters
    i = 0
    while i < len(argv):
        arg = argv[i]

        def value() -> str:
            nonlocal i
            if i + 1 >= len(argv):
                raise RuntimeError(f"missing value for {arg}")
            i += 1
            return argv[i]

        if arg == "--width":
            p.width = int(value())
            if p.width <= 0:
                raise RuntimeError("image width must be positive")
        elif arg == "--height":
            p.height = int(value())
            if p.height <= 0:
                raise RuntimeError("image height must be positive")
        elif arg == "--box-transparency":
            p.box_transparency = float(value())
            if not (0.0 <= p.box_transparency <= 1.0):
                raise RuntimeError("box transparency must be between 0 and 1")
        elif arg == "--antialiasing":
            p.antialiasing = int(value())
            if p.antialiasing <= 0:
                raise RuntimeError("antialiasing must be positive")
        elif arg == "--visibility-graph":
            p.use_visibility_graph = True
        elif arg == "--no-visibility-graph":
            p.use_visibility_graph = False
        elif arg == "--write-visibility-graph":
            p.write_visibility_graph = True
        elif arg == "--output":
            parsed.output_filename = value()
            if not parsed.output_filename:
                raise RuntimeError("output filename must not be empty")
        elif arg == "--variable":
            parsed.variable_name = value()
            if not parsed.variable_name:
                raise RuntimeError("variable name must not be empty")
        elif arg == "--min-level":
            parsed.min_level = int(value())
            if parsed.min_level < 0:
                raise RuntimeError("min level must be non-negative")
        elif arg == "--max-level":
            parsed.max_level = int(value())
            if parsed.max_level < 0:
                raise RuntimeError("max level must be non-negative")
        elif arg == "--log-scale":
            parsed.log_scale_input = True
        elif arg == "--up-vector":
            if i + 3 >= len(argv):
                raise RuntimeError("--up-vector requires three components")
            up = np.array([float(argv[i + 1]), float(argv[i + 2]), float(argv[i + 3])])
            i += 3
            length = float(np.linalg.norm(up))
            if not (length > 0.0) or not math.isfinite(length):
                raise RuntimeError("--up-vector must be non-zero and finite")
            p.camera_up = up / length
        elif arg == "--print-camera":
            p.print_camera = True
        elif arg == "--device":
            parsed.device = value()
            if parsed.device.split(":")[0] not in ("cuda", "cpu"):
                raise RuntimeError("device must be cuda, cuda:N or cpu")
        elif arg == "--devices":
            p.devices = int(value())
            if p.devices <= 0:
                raise RuntimeError("device count must be positive")
        elif arg == "--orbit-frames":
            parsed.orbit_frames = int(value())
            if parsed.orbit_frames <= 0:
                raise RuntimeError("orbit frame count must be positive")
        elif arg == "--orbit-degrees":
            parsed.orbit_degrees = float(value())
            if not math.isfinite(parsed.orbit_degrees):
                raise RuntimeError("orbit degrees must be finite")
        elif arg == "--render-method":
            p.render_method = value()
            if p.render_method not in ("auto", "raymarch", "slicemarch", "tilemarch"):
                raise RuntimeError(
                    "render method must be one of auto, raymarch, "
                    "slicemarch, tilemarch"
                )
        elif arg == "--sampling":
            p.sampling = value()
            if p.sampling not in ("nearest", "trilinear"):
                raise RuntimeError("sampling must be one of nearest, trilinear")
        elif arg == "--classification":
            p.classification = value()
            if p.classification not in ("post", "pre"):
                raise RuntimeError("classification must be one of post, pre")
        elif arg == "--lut-size":
            try:
                p.lut_size = int(value())
            except ValueError:
                raise RuntimeError("lut-size must be an integer")
            if p.lut_size <= 0 or p.lut_size % 128 != 0:
                raise RuntimeError("lut-size must be a positive multiple of 128")
        elif arg == "--trace-dir":
            parsed.trace_dir = value()
        elif arg == "--plotfile":
            parsed.plotfile_path = value()
        elif arg in ("--help", "-h"):
            print(USAGE, end="")
            parsed.exit_early = True
            return parsed
        else:
            if arg.startswith("-"):
                raise RuntimeError(f"unknown option '{arg}'")
            if parsed.plotfile_path:
                raise RuntimeError(
                    f"multiple plot files specified ('{parsed.plotfile_path}' "
                    f"and '{arg}')"
                )
            parsed.plotfile_path = arg
        i += 1

    if not parsed.plotfile_path:
        raise RuntimeError("plotfile path is required")
    if parsed.max_level >= 0 and parsed.min_level > parsed.max_level:
        raise RuntimeError("min level must not exceed max level")
    return parsed


def load_plotfile_geometry(
    plotfile_path: str,
    variable_name: str,
    requested_min_level: int,
    requested_max_level: int,
    log_scale_input: bool,
    normalize_to_data_range: bool = True,
    verbose: bool = True,
) -> SceneGeometry:
    """Plotfile -> SceneGeometry (VolumeRenderer.cpp:588-714): variable
    selection, level clamping, convexify, scene build."""
    if not plotfile_path:
        raise ValueError("Plotfile path must not be empty.")
    plotfile = read_plotfile_header(plotfile_path)
    if not plotfile.var_names:
        raise RuntimeError("Plotfile contains no cell variables to render.")
    component_name = variable_name or plotfile.var_names[0]
    if component_name not in plotfile.var_names:
        raise RuntimeError(
            f"Variable '{component_name}' not found in plotfile "
            f"'{plotfile_path}'."
        )
    finest = plotfile.finest_level
    min_level = max(0, min(requested_min_level, finest))
    max_level = requested_max_level
    if max_level < 0 or max_level > finest:
        max_level = finest
    if min_level > max_level:
        raise RuntimeError(
            f"Minimum AMR level {min_level} exceeds available maximum level "
            f"{max_level}."
        )
    levels = [
        plotfile.get_level_boxes(level, component_name)
        for level in range(max_level + 1)
    ]
    ratios = [(r, r, r) for r in plotfile.ref_ratios[:max_level]]
    scene = build_scene_geometry(
        convexify(levels, ratios),
        plotfile.level_geometry(max_level),
        SceneBuildOptions(
            min_level=min_level,
            max_level=max_level,
            log_scale_input=log_scale_input,
            normalize_to_data_range=normalize_to_data_range,
            no_data_error="Failed to locate any volumetric data within the plotfile.",
            invalid_scalar_error="Failed to compute a valid scalar range from the plotfile.",
        ),
    )
    if verbose:
        msg = (
            f"Loaded plotfile '{plotfile_path}' with variable "
            f"'{component_name}' across {max_level - min_level + 1} level(s)"
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


def run_options(options: RunOptions, verbose: bool = True) -> int:
    """VolumeRenderer::run(RunOptions) (cpp:1341-1576) on ``options.device``."""
    validate_render_parameters(options.parameters)
    if not options.output_filename:
        raise ValueError("output filename must not be empty")
    if not options.plotfile_path:
        raise RuntimeError("plotfile path is required")
    if options.min_level < 0:
        raise ValueError("min level must be non-negative")
    if options.max_level < -1:
        raise ValueError("max level must be non-negative or -1 for all levels")
    if options.max_level >= 0 and options.min_level > options.max_level:
        raise RuntimeError("min level must not exceed max level")
    if options.scalar_range is not None:
        lo, hi = options.scalar_range
        if not (math.isfinite(lo) and math.isfinite(hi) and lo < hi):
            raise ValueError(
                "scalar range must contain two finite values with min < max"
            )
    if options.color_map is not None:
        from .api import validate_color_map

        validate_color_map(options.color_map)
    validate_camera(options.camera)
    if not os.path.exists(options.plotfile_path):
        raise RuntimeError(
            f"plotfile path '{options.plotfile_path}' does not exist"
        )
    geometry = load_plotfile_geometry(
        options.plotfile_path,
        options.variable_name,
        options.min_level,
        options.max_level,
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
    with device_trace(options.trace_dir):
        if options.orbit_frames > 0:
            name = options.output_filename
            if "{" in name:
                pattern = name  # already a format pattern
            else:
                stem, dot, ext = name.rpartition(".")
                pattern = f"{stem}_{{:04d}}.{ext}" if dot else f"{name}_{{:04d}}"
            render_orbit(
                pattern,
                options.parameters,
                geometry,
                options.orbit_frames,
                camera=camera,
                color_map=normalized_color_map,
                total_degrees=options.orbit_degrees,
                verbose=verbose,
                device=options.device,
            )
        else:
            render_scene(
                options.output_filename,
                options.parameters,
                geometry,
                camera=camera,
                color_map=normalized_color_map,
                verbose=verbose,
                device=options.device,
            )
    return 0


def compute_scalar_histogram(
    plotfile_path: str,
    variable_name: str,
    requested_min_level: int,
    requested_max_level: int,
    log_scale_input: bool,
    bin_count: int,
    verbose: bool = False,
    device: str = DEFAULT_DEVICE,
) -> ScalarHistogram:
    """VolumeRenderer::computeScalarHistogram (cpp:880-897): the plotfile's
    bricks are uploaded to ``device`` and binned there
    (``device_scene.device_histogram``)."""
    if bin_count <= 0:
        raise ValueError("binCount must be positive")
    geometry = load_plotfile_geometry(
        plotfile_path,
        variable_name,
        requested_min_level,
        requested_max_level,
        log_scale_input,
        verbose=verbose,
    )
    return compute_scene_histogram(geometry, bin_count, device=device)


def _distributed_env():
    """(init_method, world size, rank, local rank, local world size) from
    the environment, or None for a one-process run.  The JAX package's
    explicit coordinator (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) takes precedence, so one
    launch line drives both packages; ``AVR_DISTRIBUTED=1`` reads
    torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``.  The local rank and local world size are torchrun's
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; the local world size is None
    where it is not set, and the local rank then falls back to the rank
    (modulo the local world size where that is set)."""
    env = os.environ
    addr = env.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        world, rank = int(env["JAX_NUM_PROCESSES"]), int(env["JAX_PROCESS_ID"])
        init_method = f"tcp://{addr}"
    elif env.get("AVR_DISTRIBUTED", "0") not in ("", "0"):
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    else:
        return None
    local_world = int(env["LOCAL_WORLD_SIZE"]) if env.get("LOCAL_WORLD_SIZE") else None
    local_rank = int(env.get("LOCAL_RANK", rank % (local_world or world)))
    return init_method, world, rank, local_rank, local_world


def maybe_initialize_distributed(device: str = DEFAULT_DEVICE,
                                 verbose: bool = True) -> bool:
    """The several-process launch (the reference's ``mpirun``,
    main.cpp:19-36): one process per rank joined by
    ``torch.distributed.init_process_group``, after which ``--devices N``
    spreads its N shards over every process (``parallel.directsend.
    make_mesh``), every process assembles the whole frame and process 0
    saves it.  Started by the variables of ``_distributed_env``.

    The backend is chosen before the process group starts, from the device
    and the card count, and printed: ``gloo`` for ``--device cpu``;
    ``nccl`` when each process on this host has a card of its own (local
    rank r renders on ``cuda:r``); ``gloo`` when the processes share the
    cards, since NCCL refuses two ranks on one device, with the device
    tensors copied through pinned host memory around each collective.
    Without ``LOCAL_WORLD_SIZE`` the processes of a host cannot be told
    from those of the others, so a CUDA launch of more processes than this
    host has cards raises rather than guess that they share the cards.
    Each process takes its share of the host's cores for PyTorch's CPU
    threads unless ``OMP_NUM_THREADS`` is set (torchrun sets it), since
    every process otherwise spins a thread per core.
    Returns True when the process group was started."""
    spec = _distributed_env()
    if spec is None:
        return False
    import torch
    import torch.distributed as dist

    init_method, world, rank, local_rank, local_world = spec
    if "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (local_world or world)))
    note = ""
    devices = world
    if device.split(":")[0] == "cpu":
        backend = "gloo"
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "a CUDA launch needs a card: torch.cuda.device_count() is 0 "
                "(pass --device cpu to run on the CPU)")
        if local_world is None:
            if world > count:
                raise RuntimeError(
                    f"{world} processes and {count} card(s) on this host: set "
                    "LOCAL_WORLD_SIZE to the number of processes on each host "
                    "(and LOCAL_RANK to each one's index there)")
            local_world = world
        if count >= local_world:
            if not dist.is_nccl_available():
                raise RuntimeError("this PyTorch build has no NCCL backend")
            backend = "nccl"
        else:
            backend = "gloo"
            devices = (world // local_world) * count
            note = (f", {local_world} processes share {count} card(s): "
                    "collectives through pinned host memory")
        torch.cuda.set_device(local_rank % count)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    if verbose and rank == 0:
        print(f"volume_renderer: distributed runtime up — {world} host(s), "
              f"{devices} device(s), backend {backend}{note}")
    return True


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point (main.cpp + VolumeRenderer::run(argc, argv))."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        options = parse_options(argv)
    except Exception as error:  # noqa: BLE001 - mirror reference behavior
        print(f"Error parsing options: {error}", file=sys.stderr)
        print("Use --help to list available options.", file=sys.stderr)
        return 1
    if options.exit_early:
        return 0
    try:
        distributed = maybe_initialize_distributed(options.device)
    except Exception as error:  # noqa: BLE001 - mirror MPI_Init failure
        print(f"Error initializing distributed runtime: {error}",
              file=sys.stderr)
        return 1
    try:
        return run_options(options)
    except Exception as error:  # noqa: BLE001 - main.cpp:27-33 catches all
        print(f"Error on rank {process_index()}: {error}", file=sys.stderr)
        return 1
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
