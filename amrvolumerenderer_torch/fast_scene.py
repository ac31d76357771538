"""Persistent scene renderer: prepare once, render any camera, or a
camera sequence.

The port of the JAX package's ``fast_scene.FastSceneRenderer``.
Construction does all data-dependent work once: bricks are
pre-transformed, given 1-cell ghost rings for trilinear sampling, split
into <= 32-cell cubes and kept on the device as a canonical
``[L, 32, 32, 32]`` table (a registered buffer, float32 or bfloat16).  Per
frame, the table is repacked to the camera's march axis (cached per axis),
the host builds the tile work list, and the tile-march kernel marches and
composites the frame: ``render`` launches ``ops.tilemarch.tilemarch_render``
for one frame, ``render_batch`` launches ``tilemarch_render_batch`` once per
chunk of consecutive same-axis frames (animation orbits), assembling the
frames on the device (as bytes when asked) and reading each chunk back
once.  ``set_transfer_function`` swaps the colour map without touching the
bricks; ``update_data`` swaps in a new time step's values, from NumPy
arrays or from tensors.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from .camera import camera_basis
from .colormap import SOFT_CLIP_TOLERANCE, build_color_table
from .device import DEFAULT_DEVICE, Device, process_index, resolve_device
from .ghost import edge_pad
from .image import color_to_byte_device
from .ops import tilemarch as tm
from .ops import worklist as wl
from .renderer import (
    compute_global_bounds,
    compute_global_scalar_range,
    compute_reference_sample_distance,
    compute_tight_bounds,
    render_bounding_box_overlay,
    validate_render_parameters,
)
from .renderer_fast import _device_downsample, _pretransform
from .types import (
    CameraParameters,
    ColorMap,
    RenderParameters,
    SceneGeometry,
)
from .visibility import OrderKeyCache, order_keys_or_hints

MAX_CUBE = 32  # largest stored piece edge (32 * 32 = one 1024-cell slice)


def _split_to_cubes(data, min_corner, max_corner, cube, ghost=0, padded=None):
    """Split a brick into <= cube^3 CORE pieces.

    ``data`` is an array or a tensor.  Returns [(block, mn, mx, core_dims),
    ...]; with ``ghost > 0`` each
    block carries a ``ghost``-cell ring on every axis (neighbour data of
    the same brick at split boundaries, ``padded``'s ring at true brick
    faces, edge replication by default) while ``mn``/``mx`` bound the core."""
    shape = data.shape
    spans = [
        (max_corner[d] - min_corner[d]) / shape[d] if shape[d] else 1.0
        for d in range(3)
    ]
    if padded is None:
        padded = edge_pad(data, ghost) if ghost else data
    pieces = []
    g2 = 2 * ghost
    for i0 in range(0, shape[0], cube):
        for j0 in range(0, shape[1], cube):
            for k0 in range(0, shape[2], cube):
                lo = np.array([i0, j0, k0])
                hi = np.minimum(lo + cube, shape)
                mn = np.asarray(min_corner) + lo * spans
                mx = np.asarray(min_corner) + hi * spans
                block = padded[
                    lo[0]: hi[0] + g2, lo[1]: hi[1] + g2, lo[2]: hi[2] + g2
                ]
                pieces.append((block, mn, mx, hi - lo))
    return pieces


def _piece_table(datas, bricks, ghost: int):
    """The canonical piece table of pre-transformed bricks (the JAX
    package's ``fast_scene._ghost_fill_bricks`` and the split loop of
    ``FastSceneRenderer.__init__`` / ``update_data`` /
    ``device_scene.prepare_device_scene``): with ``ghost`` (trilinear)
    cross-brick ghost rings (``ghost.ghost_fill``), then each brick split
    into <= (32 - 2 ghost)^3 cores and zero padded to 32^3.

    ``datas`` are all NumPy arrays (the table is assembled on the host and
    returned as one array) or all tensors on one device (padded and
    stacked there; only the per-piece value ranges are read back).
    Returns ``(canonical [L, 32, 32, 32], piece_meta [(min, max, dims,
    parent)], piece_ranges [(vmin, vmax)])``."""
    core = MAX_CUBE - 2 * ghost
    padded_list = [None] * len(datas)
    if ghost and len(datas) > 1:
        from .ghost import ghost_fill

        padded_list = ghost_fill(
            datas, [(b.min_corner, b.max_corner) for b in bricks], ghost
        )
    host = all(isinstance(d, np.ndarray) for d in datas)
    c = MAX_CUBE
    blocks, piece_meta, ranges = [], [], []
    for parent, brick in enumerate(bricks):
        for block, mn, mx, dims in _split_to_cubes(
            datas[parent], brick.min_corner, brick.max_corner, core,
            ghost=ghost, padded=padded_list[parent],
        ):
            piece_meta.append((mn, mx, dims, parent))
            if host:
                ranges.append((float(np.min(block)), float(np.max(block))))
                blocks.append(block)
            else:
                ranges.append(torch.stack([block.amin(), block.amax()]))
                d0, d1, d2 = block.shape
                blocks.append(torch.nn.functional.pad(
                    block, (0, c - d2, 0, c - d1, 0, c - d0)))
    if not blocks:
        raise ValueError("scene contains no bricks")
    if host:
        canonical = np.zeros((len(blocks), c, c, c), np.float32)
        for i, d in enumerate(blocks):
            canonical[i, : d.shape[0], : d.shape[1], : d.shape[2]] = d
    else:
        canonical = torch.stack(blocks)
        ranges = [tuple(r) for r in torch.stack(ranges).cpu().tolist()]
    return canonical, piece_meta, ranges


def _repack_for_axis(canonical: torch.Tensor, axis: int, cube: int) -> torch.Tensor:
    """[L, c, c, c] canonical table -> [L, c, 8, 128] slices for the march
    axis (slice-major, row stride c, zero padded to 1024 cells)."""
    axes = [axis] + [a for a in range(3) if a != axis]
    vol = canonical.permute(0, 1 + axes[0], 1 + axes[1], 1 + axes[2])
    num = vol.shape[0]
    flat = vol.reshape(num, cube, cube * cube)
    pad = wl.SLICE_CELLS - cube * cube
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(num, cube, wl.SUBLANES, wl.LANES).contiguous()


def _range_visible(vmin, vmax, scalar_range, lut_alpha) -> bool:
    """Does any LUT entry within the value range have alpha > 0?"""
    lo, hi = scalar_range
    span = hi - lo if hi != lo else 1.0
    table_max = len(lut_alpha) - 1
    i0 = int(np.clip((vmin - lo) / span * table_max, 0, table_max))
    i1 = int(np.clip((vmax - lo) / span * table_max, 0, table_max))
    return bool(lut_alpha[i0: i1 + 1].max() > 0.0)


PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _storage_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unsupported precision {precision!r}")
    return PRECISIONS[precision]


def _soft_clip(scalar_range):
    """(clip_start, apply_clip) of the soft tail clip for a scalar range."""
    clip_start = float(np.clip(scalar_range[1], 0.0, 1.0))
    return clip_start, 1.0 > clip_start + SOFT_CLIP_TOLERANCE


BATCH_TABLES = ("cam", "offsets", "bricks", "owners", "item_bounds", "tile_ids")


def _pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def pack_batch_tables(frames, num_tiles: int, w_pad: Optional[int] = None) -> dict:
    """Stack per-frame ``frame_inputs(as_numpy=True)`` dicts into the
    batched kernel's ``[F, ...]`` tables (keys ``BATCH_TABLES``): step lists
    padded to the widest frame's with sentinel tiles (``num_tiles``, empty
    work lists), work rows zero-padded to ``w_pad`` (default: the widest
    row rounded up to a power of two)."""
    count = len(frames)
    if w_pad is None:
        w_pad = _pow2(max(len(f["bricks"]) for f in frames))
    s_steps = max(len(f["tile_ids"]) for f in frames)
    out = dict(
        cam=np.stack([f["cam"] for f in frames]).astype(np.float32),
        offsets=np.zeros((count, s_steps + 1), np.int32),
        bricks=np.zeros((count, w_pad), np.int32),
        owners=np.zeros((count, w_pad), np.int32),
        item_bounds=np.zeros((count, w_pad), np.int32),
        tile_ids=np.full((count, s_steps), num_tiles, np.int32),
    )
    for row, f in enumerate(frames):
        w = len(f["bricks"])
        for key in ("bricks", "owners", "item_bounds"):
            out[key][row, :w] = f[key]
        o = f["offsets"]
        out["offsets"][row, : len(o)] = o
        out["offsets"][row, len(o):] = o[-1]
        out["tile_ids"][row, : len(f["tile_ids"])] = f["tile_ids"]
    return out


class FastSceneRenderer(nn.Module):
    """Device-resident scene prepared once; per-camera frames on demand.

    ``FastSceneRenderer(geometry, parameters, color_map, device,
    precision)`` prepares from a scene; ``from_tables`` (used by
    ``state.renderer_from_state``) from an already packed piece table.
    Buffers: ``canonical`` ``[L, 32, 32, 32]`` pieces (float32, or bfloat16
    with ``precision="bfloat16"``: half the device bytes, each cell widened
    to float32 exactly in the kernel) and ``lut`` ``[4, size // 128, 128]``.

    The scalar range and brick layout are fixed at construction;
    ``set_transfer_function`` swaps the colormap / box transparency between
    frames and ``update_data`` ingests new time-step values in place (the
    reference re-prepares the whole pipeline per run,
    miniapps/renderVolume*.cpp)."""

    def __init__(
        self,
        geometry: SceneGeometry,
        parameters: RenderParameters,
        color_map: Optional[ColorMap] = None,
        device: Device = DEFAULT_DEVICE,
        precision: str = "float32",
    ):
        super().__init__()
        validate_render_parameters(parameters)
        _storage_dtype(precision)
        scalar_range = (
            geometry.scalar_range
            if geometry.has_scalar_range
            else compute_global_scalar_range(geometry)
        )
        clip_start, apply_clip = _soft_clip(scalar_range)
        t = geometry.scalar_transform
        # trilinear: 1-cell ghost rings make cube splits seam-free (the
        # core shrinks to MAX_CUBE - 2 so the stored block still fits)
        ghost = 1 if parameters.sampling == "trilinear" else 0
        datas = [
            _pretransform(b.data, t, clip_start, apply_clip)
            for b in geometry.bricks
        ]
        canonical, piece_meta, piece_ranges = _piece_table(
            datas, geometry.bricks, ghost)
        self._init_from_canonical(
            geometry, parameters, color_map, canonical, piece_meta,
            piece_ranges, ghost=ghost, precision=precision, device=device,
        )

    def _init_from_canonical(
        self, geometry: SceneGeometry, parameters: RenderParameters,
        color_map: Optional[ColorMap], canonical, piece_meta, piece_ranges,
        ghost: int, precision: str, device: Device,
    ) -> None:
        """Everything but the piece table: bounds, scalar range, LUT and
        per-piece metadata from ``geometry`` (``_piece_table``'s outputs
        describe ``canonical``)."""
        validate_render_parameters(parameters)
        scalar_range = (
            geometry.scalar_range
            if geometry.has_scalar_range
            else compute_global_scalar_range(geometry)
        )
        bounds = compute_global_bounds(geometry)
        alpha_scale = float(np.clip(1.0 - parameters.box_transparency, 0, 1))
        table = build_color_table(
            alpha_scale, 1.0, scalar_range, color_map, size=parameters.lut_size
        )
        lut_alpha = table[:, 3].copy()
        self._setup(
            parameters,
            canonical=canonical,
            box_min=np.array([m[0] for m in piece_meta], np.float64),
            box_max=np.array([m[1] for m in piece_meta], np.float64),
            dims_world=np.array([m[2] for m in piece_meta], np.int32),
            parents=np.array([m[3] for m in piece_meta], np.int32),
            owners=np.array(
                [geometry.bricks[m[3]].owner for m in piece_meta], np.int32
            ),
            parent_min=np.array([b.min_corner for b in geometry.bricks]),
            parent_max=np.array([b.max_corner for b in geometry.bricks]),
            lut=wl.build_log_lut(table),
            lut_alpha=lut_alpha,
            scalar_range=scalar_range,
            reference_sample_distance=compute_reference_sample_distance(
                geometry, bounds
            ),
            ghost=ghost,
            bounds=bounds,
            tight_bounds=compute_tight_bounds(geometry, bounds),
            visible=None,
            piece_ranges=piece_ranges,
            precision=precision,
            device=device,
        )
        self.geometry = geometry

    @classmethod
    def from_tables(cls, parameters: RenderParameters, device: Device = DEFAULT_DEVICE,
                    **tables) -> "FastSceneRenderer":
        """A renderer over an already packed scene (``state.py`` lists the
        tables).  ``visible`` defaults to the mask that ``piece_ranges``
        give under the LUT, else to every piece; ``precision`` defaults to
        the canonical table's."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        validate_render_parameters(parameters)
        tables.setdefault("visible", None)
        tables.setdefault("piece_ranges", None)
        tables.setdefault("precision", None)
        self._setup(parameters, device=device, **tables)
        self.geometry = None
        return self

    def _setup(
        self, parameters, *, canonical, box_min, box_max, dims_world, parents,
        owners, parent_min, parent_max, lut, lut_alpha, scalar_range,
        reference_sample_distance, ghost, bounds, tight_bounds, visible,
        piece_ranges, precision, device,
    ):
        dev = resolve_device(device)
        self.device = dev
        self.parameters = parameters
        self.bounds = bounds
        self.tight_bounds = tight_bounds
        self.scalar_range = (float(scalar_range[0]), float(scalar_range[1]))
        self.reference_sample_distance = float(reference_sample_distance)
        sqrt_aa = int(round(math.sqrt(parameters.antialiasing)))
        self.sqrt_aa = max(sqrt_aa, 1)
        self.render_width = parameters.width * self.sqrt_aa
        self.render_height = parameters.height * self.sqrt_aa
        self.pad_w = -(-self.render_width // wl.TILE_W) * wl.TILE_W
        self.pad_h = -(-self.render_height // wl.TILE_H) * wl.TILE_H
        self.cube = MAX_CUBE  # stored edge = row stride = max_slices
        self.ghost = int(ghost)
        self.core = MAX_CUBE - 2 * self.ghost  # largest piece core edge
        self.box_min = np.asarray(box_min, np.float64)
        self.box_max = np.asarray(box_max, np.float64)
        self.dims_world = np.asarray(dims_world, np.int32)
        self.parents = np.asarray(parents, np.int32)
        self.owners = np.asarray(owners, np.int32)
        self._parent_min = np.asarray(parent_min, np.float64)
        self._parent_max = np.asarray(parent_max, np.float64)
        self._lut = np.asarray(lut, np.float32)
        self._lut_alpha = np.asarray(lut_alpha)
        self.register_buffer("lut", torch.tensor(self._lut, device=dev))
        if not isinstance(canonical, torch.Tensor):
            canonical = torch.from_numpy(np.ascontiguousarray(canonical, np.float32))
        if precision is None:
            precision = "bfloat16" if canonical.dtype == torch.bfloat16 else "float32"
        self.precision = precision
        # bfloat16 storage: cast after the float32 pre-transform and ghost
        # fill, on the device (round to nearest even, as XLA casts)
        self.register_buffer(
            "canonical", canonical.to(dev).to(_storage_dtype(precision))
        )
        # space skipping: pieces whose value range maps to zero opacity
        # under the transfer function are culled; kept as a mask that
        # set_transfer_function re-derives from ``piece_ranges``
        self.piece_ranges = (
            None if piece_ranges is None
            else [tuple(map(float, r)) for r in np.asarray(piece_ranges)]
        )
        if visible is None:
            visible = self._visible_mask()
        self.visible = np.asarray(visible, bool)
        # per-octant ordering-key memo (visibility.OrderKeyCache)
        self._order_cache = OrderKeyCache(
            self.box_min, self.box_max, self._parent_min, self._parent_max
        )
        # render_batch's readback: a side stream and two pinned staging
        # buffers (slot -> uint8 tensor, one per chunk in flight), made at
        # first use
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._staging: dict = {}
        self._set_canonical()

    def _visible_mask(self) -> np.ndarray:
        """Per piece: does its value range reach a LUT entry with alpha >
        0?  Every piece when the ranges are unknown."""
        if self.piece_ranges is None:
            return np.ones(self.canonical.shape[0], dtype=bool)
        return np.array(
            [_range_visible(lo, hi, self.scalar_range, self._lut_alpha)
             for lo, hi in self.piece_ranges],
            dtype=bool,
        )

    def _set_canonical(self) -> None:
        """Per-axis value extrema of the piece table, reduced on the device
        from the stored values (bfloat16-rounded under that precision, then
        widened): per slice (occupied-slice bounds) and per 8 x 8 stored
        (u, v) block of each slice (per-item slice bands).  Core slice k is
        stored at k + ghost; the in-plane ring joins the extrema (bilinear
        samples it), which only widens the ranges."""
        g = self.ghost
        canonical = self.canonical
        self._slice_minmax = {}
        self._slice_quad_minmax = {}
        self._occ_bits_cache = {}  # axis -> [L, S] u64 (per LUT)
        nq = 8 if self.cube % 8 == 0 else 4
        self._quad_blocks = nq
        self._quad_split = self.cube // nq
        for a in range(3):
            v = torch.movedim(canonical, 1 + a, 1)
            if g:
                v = v[:, g: v.shape[1] - g]
            num, s_cap, c, _ = v.shape
            blocks = v.reshape(num, s_cap, nq, c // nq, nq, c // nq)
            self._slice_minmax[a] = (
                v.amin(dim=(2, 3)).float().cpu().numpy(),
                v.amax(dim=(2, 3)).float().cpu().numpy(),
            )
            quads = torch.stack(
                [blocks.amin(dim=(3, 5)), blocks.amax(dim=(3, 5))]
            ).float().cpu().numpy()
            self._slice_quad_minmax[a] = (quads[0], quads[1])
        self._packed_axis: Optional[int] = None
        self._packed_vol: Optional[torch.Tensor] = None
        self._axis_meta_cache: dict = {}
        self._packed_cache: dict = {}  # axis -> repacked table (<= 3 copies)

    def set_transfer_function(
        self,
        color_map: Optional[ColorMap] = None,
        box_transparency: Optional[float] = None,
    ) -> None:
        """Swap the colormap / per-box transparency without repacking bricks.

        Only the LUT, the piece-visibility mask and the LUT-dependent
        occupancy caches change (the scalar range and soft clip are baked
        into the brick data at prepare time, exactly as the reference fixes
        them per run)."""
        if box_transparency is not None:
            self.parameters.box_transparency = box_transparency
        alpha_scale = float(
            np.clip(1.0 - self.parameters.box_transparency, 0.0, 1.0)
        )
        table = build_color_table(
            alpha_scale, 1.0, self.scalar_range, color_map,
            size=self.parameters.lut_size,
        )
        self._lut = wl.build_log_lut(table)
        self._lut_alpha = table[:, 3].copy()
        self.lut = torch.tensor(self._lut, device=self.device)
        self._occ_bits_cache = {}  # block occupancy depends on the LUT
        self._axis_meta_cache = {}  # dims[:, 7] depends on the LUT
        if self.piece_ranges is not None:
            self.visible = self._visible_mask()

    def update_data(self, brick_arrays) -> None:
        """Per-timestep in-situ update: new scalar values, same brick layout.

        The time-series workload (the reference's renderVolumeTime miniapp,
        miniapps/renderVolumeTime.cpp) re-renders a fixed grid hierarchy as
        values evolve under a fixed scalar range and transfer function.
        This swaps the device piece table in place.  Tensor inputs (any
        tensor among them) are pre-transformed, ghost-filled, split and
        reduced on this renderer's device (``device_scene``): the values
        never visit the host.  NumPy inputs (the plotfile-driven time
        series) are pre-transformed in float64 on the host like the
        constructor's, and the whole piece table ships as ONE upload.
        Camera metadata, owners, order keys and the LUT are untouched.
        ``brick_arrays`` must match ``geometry.bricks`` in order and shape.
        """
        if self.geometry is None:
            raise ValueError(
                "update_data needs a renderer built from a SceneGeometry"
            )
        bricks = self.geometry.bricks
        if len(brick_arrays) != len(bricks):
            raise ValueError(
                f"expected {len(bricks)} brick arrays, got {len(brick_arrays)}"
            )
        t = self.geometry.scalar_transform
        clip_start, apply_clip = _soft_clip(self.scalar_range)
        all_host = all(isinstance(a, np.ndarray) for a in brick_arrays)
        datas = []
        for brick, arr in zip(bricks, brick_arrays):
            if tuple(arr.shape) != tuple(np.shape(brick.data)):
                raise ValueError(
                    f"brick shape changed: {tuple(arr.shape)} vs "
                    f"{tuple(np.shape(brick.data))}"
                )
            if all_host:
                datas.append(_pretransform(arr, t, clip_start, apply_clip))
            else:
                from .device_scene import _pretransform_device

                datas.append(_pretransform_device(
                    torch.as_tensor(arr).to(self.device), t, clip_start,
                    apply_clip,
                ))
        canonical, _meta, ranges = _piece_table(datas, bricks, self.ghost)
        if isinstance(canonical, np.ndarray):
            canonical = torch.from_numpy(canonical).to(self.device)
        canonical = canonical.to(self.canonical.dtype)
        if canonical.shape != self.canonical.shape:
            raise ValueError(
                "piece table shape changed; construct a new renderer for a "
                "regridded hierarchy"
            )
        self.canonical = canonical
        self._set_canonical()
        self.piece_ranges = ranges
        self.visible = self._visible_mask()

    def _axis_metadata(self, axis: int):
        """Per-axis piece tables in the kernel's permuted layout: (meta
        [L, 12] f32, dims [L, 8] i32) with the occupied-slice range in
        dims[:, 7]."""
        axes = [axis] + [a for a in range(3) if a != axis]
        num = self.canonical.shape[0]
        meta = np.zeros((num, 12), np.float32)
        dims = np.zeros((num, 8), np.int32)
        meta[:, 0:3] = self.box_min[:, axes]
        meta[:, 3:6] = self.box_max[:, axes]
        dw = self.dims_world[:, axes].astype(np.float64)
        meta[:, 6:9] = (self.box_max[:, axes] - self.box_min[:, axes]) / dw
        dims[:, 0:3] = self.dims_world[:, axes]
        dims[:, 3:6] = axes
        dims[:, 6] = self.cube
        range_min = self.scalar_range[0]
        span = self.scalar_range[1] - range_min
        smin, smax = self._slice_minmax[axis]
        dims[:, 7] = wl.compute_slice_bounds_batch(
            smin, smax, self._lut_alpha, range_min,
            1.0 / span if span != 0.0 else 1.0, dims[:, 0],
        )
        return meta, dims

    def _pack_cam(self, camera: CameraParameters, forward, right, up):
        """The 20-float camera pack (worklist.pack_camera layout)."""
        range_span = self.scalar_range[1] - self.scalar_range[0]
        return wl.pack_camera(
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees,
            self.render_width / max(self.render_height, 1),
            self.scalar_range[0],
            1.0 / range_span if range_span != 0.0 else 1.0,
            self.reference_sample_distance,
        )

    def frame_inputs(self, camera: CameraParameters, as_numpy: bool = False):
        """Per-frame preparation for one camera: march-axis repack (device,
        cached per axis), piece tables and occupied-slice bounds, the camera
        pack and the compacted CSR tile work list.  Returns a dict of
        tile-march arguments (NumPy with ``as_numpy``, else tensors on the
        device), or None when every work item was culled."""
        forward, right, up = camera_basis(camera)
        axis = wl.choose_march_axis(forward)
        axes = [axis] + [a for a in range(3) if a != axis]
        if self._packed_axis != axis:
            vol = self._packed_cache.get(axis)
            if vol is None:
                vol = _repack_for_axis(self.canonical, axis, self.cube)
                self._packed_cache[axis] = vol
            self._packed_vol = vol
            self._packed_axis = axis

        cached = self._axis_meta_cache.get(axis)
        if cached is None:
            meta, dims = self._axis_metadata(axis)
            cached = (
                meta, dims, torch.from_numpy(meta).to(self.device),
                torch.from_numpy(dims).to(self.device),
            )
            self._axis_meta_cache[axis] = cached
        meta, dims, meta_dev, dims_dev = cached
        cam = self._pack_cam(camera, forward, right, up)
        hints = order_keys_or_hints(
            camera, self.render_width / max(self.render_height, 1),
            self.box_min, self.box_max,
            use_graph=self.parameters.use_visibility_graph,
            parents=self.parents,
            parent_min=self._parent_min,
            parent_max=self._parent_max,
            cache=self._order_cache,
        )
        offsets, tbricks, towners = wl.build_tile_worklist(
            self.box_min, self.box_max, hints, self.owners,
            np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
            self.pad_w, self.pad_h,
            logical_width=self.render_width,
            logical_height=self.render_height,
        )
        num_tiles = len(offsets) - 1
        wt = np.repeat(np.arange(num_tiles), np.diff(offsets))
        if not self.visible.all():
            keep = self.visible[tbricks]
            wt, tbricks, towners = wt[keep], tbricks[keep], towners[keep]
        if len(tbricks) == 0:
            return None
        # per-(tile, piece) slice bands: tighten each item's march range to
        # its tile's footprint, split two-sided chords into two bands
        occ_bits = self._occ_bits_cache.get(axis)
        if occ_bits is None:
            range_min = self.scalar_range[0]
            span = self.scalar_range[1] - range_min
            qmin, qmax = self._slice_quad_minmax[axis]
            occ_bits = wl.block_occupancy_bits(
                qmin, qmax, self._lut_alpha, range_min,
                1.0 / span if span != 0.0 else 1.0,
            )
            self._occ_bits_cache[axis] = occ_bits
        band1, band2, march_forward = wl.compute_item_bands(
            meta, dims[:, 7], wt, tbricks,
            np.asarray(camera.eye), forward, right, up,
            camera.fov_y_degrees, axes, self.pad_w, self.pad_h,
            self.render_width, self.render_height,
            occ_bits, self._quad_blocks, self._quad_split,
            ghost=self.ghost, seg_len=2,
            margin=wl.footprint_margin(self.ghost, self.parameters.sampling),
        )
        wt, tbricks, towners, item_bounds = wl.expand_bands(
            wt, tbricks, towners, band1, band2, march_forward,
        )
        # drop items whose tightened range is empty
        nonempty = (item_bounds >> 16) < (item_bounds & 0xFFFF)
        wt, tbricks, towners, item_bounds = (
            wt[nonempty], tbricks[nonempty], towners[nonempty],
            item_bounds[nonempty],
        )
        if len(tbricks) == 0:
            return None
        # compacted grid: one step per covered tile, bucketed so an orbit
        # sees few step counts; pad steps carry the sentinel tile id
        counts = np.bincount(wt, minlength=num_tiles)
        covered = np.flatnonzero(counts > 0).astype(np.int32)
        active = len(covered)
        gran = max(128, num_tiles // 8)
        padded_steps = min(num_tiles, -(-active // gran) * gran)
        tile_ids = np.full(padded_steps, num_tiles, np.int32)
        tile_ids[:active] = covered
        offsets = np.zeros(padded_steps + 1, np.int32)
        offsets[1: active + 1] = np.cumsum(counts[covered])
        offsets[active + 1:] = offsets[active]
        host = dict(
            cam=cam, offsets=offsets, bricks=tbricks.astype(np.int32),
            owners=towners.astype(np.int32),
            item_bounds=item_bounds.astype(np.int32), tile_ids=tile_ids,
        )
        if as_numpy:
            return dict(meta=meta, dims=dims, **host)
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in host.items()}
        return dict(meta=meta_dev, dims=dims_dev, **dev)

    def _kernel_kw(self) -> dict:
        return dict(
            width=self.pad_w, height=self.pad_h, max_slices=self.cube,
            logical_width=self.render_width, logical_height=self.render_height,
            sampling=self.parameters.sampling, ghost=self.ghost,
            classification=self.parameters.classification,
        )

    def _assemble(self, out_c, out_d, tile_ids, bytes_out=False) -> torch.Tensor:
        """One frame's compacted kernel output ``[S, 4, 8, 128]`` /
        ``[S, 8, 128]`` (``out_c`` None: every item culled) -> the
        output-resolution frame on the device: ``[W*H, 5]`` float32, or
        with ``bytes_out`` ``[W*H, 4]`` (``"rgb"``: ``[W*H, 3]``) uint8 by
        the Mesa byte codec.  Byte-first when there is no AA: the compact
        output is encoded, then scattered and untiled as bytes (a quarter
        of the float bytes to move, alpha dropped before the scatter for
        ``"rgb"``); with AA the float frame is downsampled, then encoded."""
        tiles_x = self.pad_w // wl.TILE_W
        tiles_y = self.pad_h // wl.TILE_H
        num_tiles = tiles_x * tiles_y
        h, w = self.render_height, self.render_width
        if out_c is not None and bytes_out and self.sqrt_aa == 1:
            enc = color_to_byte_device(out_c)
            if bytes_out == "rgb":
                enc = enc[:, :3]
            nch = enc.shape[1]
            keep = tile_ids.long() < num_tiles
            full = torch.zeros((num_tiles,) + tuple(enc.shape[1:]),
                               dtype=torch.uint8, device=enc.device)
            full[tile_ids.long()[keep]] = enc[keep]
            c = full.reshape(tiles_y, tiles_x, nch, wl.TILE_H, wl.TILE_W)
            c = c.permute(0, 3, 1, 4, 2).reshape(self.pad_h, self.pad_w, nch)
            return c[:h, :w].reshape(-1, nch)
        if out_c is None:
            frame = torch.zeros((h * w, 5), dtype=torch.float32, device=self.device)
            frame[:, 4] = float("inf")
        else:
            out_c, out_d = tm.scatter_tiles(out_c, out_d, tile_ids, num_tiles)
            c = out_c.reshape(tiles_y, tiles_x, 4, wl.TILE_H, wl.TILE_W)
            c = c.permute(0, 3, 1, 4, 2).reshape(self.pad_h, self.pad_w, 4)
            d = out_d.reshape(tiles_y, tiles_x, wl.TILE_H, wl.TILE_W)
            d = d.permute(0, 2, 1, 3).reshape(self.pad_h, self.pad_w)
            frame = torch.cat([c, d[..., None]], dim=-1)
            frame = frame[:h, :w].reshape(-1, 5)
        if self.sqrt_aa > 1:
            frame = _device_downsample(frame, w, h, self.sqrt_aa)
        if bytes_out:
            frame = color_to_byte_device(frame[:, :4])
            if bytes_out == "rgb":
                frame = frame[:, :3]
        return frame

    def render_frame(self, camera: CameraParameters) -> torch.Tensor:
        """The output-resolution [width*height, 5] frame on the device:
        one kernel launch, scatter of the compacted grid, untile, crop, AA
        downsample."""
        inputs = self.frame_inputs(camera)
        if inputs is None:
            return self._assemble(None, None, None)
        out_c, out_d = tm.tilemarch_render(
            self._packed_vol, inputs["meta"], inputs["dims"], self.lut,
            inputs["cam"], inputs["offsets"], inputs["bricks"],
            inputs["owners"], inputs["item_bounds"], inputs["tile_ids"],
            **self._kernel_kw(),
        )
        return self._assemble(out_c, out_d, inputs["tile_ids"])

    def render(
        self,
        camera: CameraParameters,
        output_filename: Optional[str] = None,
        overlay: bool = True,
    ) -> np.ndarray:
        """Render one frame; returns the output-resolution [W*H, 5] image.
        ``overlay`` draws the tight-bounds wireframe (the reference always
        does, VolumeRenderer.cpp:1311-1314); ``output_filename`` saves a
        PPM/PNG."""
        pixels = self.render_frame(camera).cpu().numpy()
        return self._finish_frame(pixels, camera, output_filename, overlay)

    def _finish_frame(self, pixels: np.ndarray, camera: CameraParameters,
                      output_filename: Optional[str], overlay: bool) -> np.ndarray:
        """The shared ``render`` tail: wireframe overlay and save."""
        if overlay or output_filename:
            from .image import ImageBuffer, ImageKind

            image = ImageBuffer(
                ImageKind.RGBA_F32_DEPTH_SORT, self.parameters.width,
                self.parameters.height, pixels.copy(),
            )
            if overlay:
                render_bounding_box_overlay(self.tight_bounds, camera, 1, image)
            if output_filename and process_index() == 0:
                from . import io as image_io

                image_io.save_image(image, output_filename)
            return image.pixels
        return pixels

    def render_batch(
        self,
        cameras,
        overlay: bool = True,
        output_pattern: Optional[str] = None,
        max_chunk_bytes: int = 64 << 20,
        bytes_out=False,
    ) -> np.ndarray:
        """Render a camera sequence with ONE kernel launch per chunk.

        The animation workloads (orbits, time series: the reference's
        render_volume_rotate.py / render_volume_time.py drive one blocking
        render() per frame) pay a launch and a readback per frame.  This
        groups consecutive same-march-axis frames (the volume and piece
        tables are axis-fixed; only the 20-float camera pack and the CSR
        work list vary per frame), pads their work rows to a power-of-two
        width, and renders power-of-two chunks of at most 16 frames, and at
        most ``max_chunk_bytes`` of output frames, through
        ``ops.tilemarch.tilemarch_render_batch``.  Each chunk's frames are
        assembled on the device and copied to the host once, on a side
        stream into pinned memory, while the next chunk renders (a
        one-deep pipeline).  Frames whose work list culls away entirely
        come back as cleared frames, like ``render``.

        Returns [len(cameras), width*height, 5] float32 frames in input
        order; ``output_pattern`` (e.g. "frame_{:04d}.ppm") saves each.
        With ``bytes_out=True`` frames come back as [B, width*height, 4]
        RGBA uint8 (the Mesa byte codec applied on the device: a fifth of
        the float bytes to read back), with ``bytes_out="rgb"`` as
        [B, width*height, 3] (alpha dropped on the device; PPM/PNG never
        read it).  ``overlay`` requires float frames.  ``last_batch_stats``
        splits the wall time: host prep, dispatch, readback.
        Beyond reference: the reference has no batched render entry."""
        cameras = list(cameras)
        if bytes_out and overlay:
            raise ValueError("bytes_out requires overlay=False (the "
                             "wireframe overlay blends float pixels)")
        num_out = self.parameters.width * self.parameters.height
        chans = (3 if bytes_out == "rgb" else 4) if bytes_out else 5
        frame_bytes = num_out * (chans if bytes_out else 5 * 4)
        num_tiles = (self.pad_w // wl.TILE_W) * (self.pad_h // wl.TILE_H)

        def prep(i, camera):
            inputs = self.frame_inputs(camera, as_numpy=True)
            if inputs is None:  # every item culled: a cleared frame
                return None, self._assemble(None, None, None, bytes_out).cpu().numpy()
            return self._packed_axis, (i, inputs, self._packed_vol)

        def begin_group(axis, group):
            _meta, _dims, meta, dims = self._axis_meta_cache[axis]
            w_pad = _pow2(max(len(inp["bricks"]) for _, inp, _ in group))
            return group[0][2], meta, dims, w_pad

        def pack(part, ctx):
            return pack_batch_tables([inp for _, inp, _ in part], num_tiles, ctx[3])

        def dispatch(tables, ctx):
            vol, meta, dims, _w_pad = ctx
            cams, offs, brs, ows, ibs, tids = (
                torch.from_numpy(tables[k]).to(self.device) for k in BATCH_TABLES
            )
            out_c, out_d = tm.tilemarch_render_batch(
                vol, meta, dims, self.lut, cams, offs, brs, ows, ibs, tids,
                **self._kernel_kw(),
            )
            return torch.stack([
                self._assemble(out_c[f], out_d[f], tids[f], bytes_out)
                for f in range(len(tids))
            ])

        return self._run_chunked_batch(
            cameras, num_out=num_out, chans=chans, bytes_out=bytes_out,
            overlay=overlay, output_pattern=output_pattern, prep=prep,
            begin_group=begin_group, max_frames=max_chunk_bytes // frame_bytes,
            pack=pack, dispatch=dispatch,
        )

    def _run_chunked_batch(
        self, cameras, *, num_out, chans, bytes_out, overlay, output_pattern,
        prep, begin_group, max_frames, pack, dispatch, window: int = 16,
    ) -> np.ndarray:
        """The chunked-batch driver that ``render_batch`` of this renderer
        and of the multi-device one share: group consecutive frames with
        equal group keys, render power-of-two sub-chunks of at most 16 and
        at most ``max_frames`` frames (at least one), read each chunk back
        through a one-deep pipeline (a side-stream copy into pinned memory
        while the next chunk renders), and return the frames in input order.
        It keeps ``last_batch_stats`` and the overlay / save tail.

        Callbacks: ``prep(i, camera) -> (group_key, item)``, or ``(None,
        pixels)`` for a frame resolved on the host (every item culled), with
        ``item[0]`` the frame's index; ``begin_group(group_key, group) ->
        ctx`` (the group's device tables); ``pack(part, ctx) -> packed``
        host packing (charged to ``host_prep_ms``); ``dispatch(packed,
        ctx)`` the device work, returning the chunk's ``[F, num_out,
        chans]`` frames on the device (charged to ``dispatch_ms``, with the
        start of the copy).
        A group is flushed at a key change and at ``window`` frames, so the
        host preps the next window while the card renders this one."""
        out = np.empty((len(cameras), num_out, chans),
                       np.uint8 if bytes_out else np.float32)
        cap = max(1, min(16, int(max_frames)))
        cap = 1 << (cap.bit_length() - 1)  # pow2: few distinct shapes
        stats = {
            "frames": len(cameras), "dispatch_count": 0,
            "host_prep_ms": 0.0, "dispatch_ms": 0.0,
            "readback_ms": 0.0, "readback_mb": 0.0,
        }
        batch_t0 = time.perf_counter()
        pending = []  # one-deep pipeline: [(frame indices, readback handle)]

        def drain():
            # the previous chunk: its copy ran beside this chunk's launches
            while pending:
                idx, handle = pending.pop()
                t0 = time.perf_counter()
                host = self._finish_readback(handle)
                out[idx] = host
                stats["readback_mb"] += host.nbytes / 1e6
                stats["readback_ms"] += (time.perf_counter() - t0) * 1e3

        def flush(group, key):
            if not group:
                return
            ctx = begin_group(key, group)
            c0 = 0
            while c0 < len(group):
                # largest power-of-two sub-chunk that fits
                size = min(cap, 1 << ((len(group) - c0).bit_length() - 1))
                part = group[c0: c0 + size]
                c0 += size
                t0 = time.perf_counter()
                packed = pack(part, ctx)
                stats["host_prep_ms"] += (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                frames = dispatch(packed, ctx)
                handle = self._start_readback(frames, stats["dispatch_count"] % 2)
                stats["dispatch_ms"] += (time.perf_counter() - t0) * 1e3
                stats["dispatch_count"] += 1
                drain()
                pending.append(([item[0] for item in part], handle))

        group: List = []
        group_key = None
        for i, camera in enumerate(cameras):
            t0 = time.perf_counter()
            key, item = prep(i, camera)
            stats["host_prep_ms"] += (time.perf_counter() - t0) * 1e3
            if key is None:  # resolved on the host
                out[i] = item
                continue
            if group and key != group_key:
                flush(group, group_key)
                group = []
            group_key = key
            group.append(item)
            # flush full windows eagerly, so the host preps the next
            # window's frames while the card renders this one
            if len(group) >= window:
                flush(group, group_key)
                group = []
        flush(group, group_key)
        drain()

        stats["total_ms"] = (time.perf_counter() - batch_t0) * 1e3
        # ordering-key memo effectiveness over the whole renderer life
        stats["order_cache_hits"] = self._order_cache.hits
        stats["order_cache_misses"] = self._order_cache.misses
        self.last_batch_stats = stats
        return self._batch_outputs(out, cameras, overlay, output_pattern, bytes_out)

    def _start_readback(self, frames: torch.Tensor, slot: int):
        """Start copying one chunk's device frames to the host: on the side
        stream, into pinned staging buffer ``slot``, behind an event
        recorded after the frames' assembly, so that the copy runs beside
        the launches queued next.  Returns what ``_finish_readback``
        takes.  Frames on the CPU are already on the host."""
        if frames.device.type != "cuda":
            return frames, None
        nbytes = frames.numel() * frames.element_size()
        staging = self._staging.get(slot)
        if staging is None or staging.numel() < nbytes:
            staging = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._staging[slot] = staging
        host = staging[:nbytes].view(frames.dtype).view(frames.shape)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(frames.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(frames.device))
        done = torch.cuda.Event()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            host.copy_(frames, non_blocking=True)
            done.record(self._copy_stream)
        # ``frames`` stays referenced until the copy is done, so the
        # allocator cannot hand its memory to a later launch
        return host, (done, frames)

    @staticmethod
    def _finish_readback(handle) -> np.ndarray:
        """Wait for the chunk's copy; its frames as a host array (a view
        of the staging buffer, valid until the slot's next use)."""
        host, copying = handle
        if copying is not None:
            copying[0].synchronize()
        return host.numpy()

    def _batch_outputs(
        self, out, cameras, overlay, output_pattern, bytes_out
    ) -> np.ndarray:
        """render_batch's tail: wireframe overlays + per-frame saves."""
        if overlay or output_pattern:
            from .image import ImageBuffer, ImageKind

            kind = (
                ImageKind.RGBA_U8 if bytes_out
                else ImageKind.RGBA_F32_DEPTH_SORT
            )
            for i, camera in enumerate(cameras):
                px = out[i]
                if bytes_out == "rgb":
                    # the save path's u8 kind carries alpha; re-attach an
                    # opaque byte on the host (the readback stays 3-channel)
                    px = np.concatenate(
                        [px, np.full((px.shape[0], 1), 255, np.uint8)],
                        axis=1,
                    )
                image = ImageBuffer(
                    kind, self.parameters.width, self.parameters.height, px,
                )
                if overlay:
                    render_bounding_box_overlay(
                        self.tight_bounds, camera, 1, image
                    )
                if output_pattern and process_index() == 0:
                    from . import io as image_io

                    image_io.save_image(image, output_pattern.format(i))
        return out
