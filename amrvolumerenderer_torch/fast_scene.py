"""Persistent scene renderer: prepare once, render any camera.

The port of the JAX package's ``fast_scene.FastSceneRenderer`` for one
frame at a time.  Construction does all data-dependent work once: bricks
are pre-transformed, given 1-cell ghost rings for trilinear sampling, split
into <= 32-cell cubes and kept on the device as a canonical
``[L, 32, 32, 32]`` table (a registered buffer).  Per frame, the table is
repacked to the camera's march axis (cached per axis), the host builds the
tile work list, and ``ops.tilemarch.tilemarch_render`` marches and
composites the whole frame in one kernel launch.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .camera import camera_basis
from .colormap import SOFT_CLIP_TOLERANCE, build_color_table
from .device import DEFAULT_DEVICE, Device, resolve_device
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

    Returns [(block, mn, mx, core_dims), ...]; with ``ghost > 0`` each
    block carries a ``ghost``-cell ring on every axis (neighbour data of
    the same brick at split boundaries, ``padded``'s ring at true brick
    faces, edge replication by default) while ``mn``/``mx`` bound the core."""
    shape = data.shape
    spans = [
        (max_corner[d] - min_corner[d]) / shape[d] if shape[d] else 1.0
        for d in range(3)
    ]
    if padded is None:
        padded = np.pad(data, ghost, mode="edge") if ghost else data
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


class FastSceneRenderer(nn.Module):
    """Device-resident scene prepared once; frames per camera on demand.

    ``FastSceneRenderer(geometry, parameters, color_map, device)`` prepares
    from a scene; ``from_tables`` (used by ``state.renderer_from_state``)
    from an already packed piece table.  Buffers: ``canonical``
    ``[L, 32, 32, 32]`` f32 pieces and ``lut`` ``[4, size // 128, 128]``."""

    def __init__(
        self,
        geometry: SceneGeometry,
        parameters: RenderParameters,
        color_map: Optional[ColorMap] = None,
        device: Device = DEFAULT_DEVICE,
    ):
        super().__init__()
        validate_render_parameters(parameters)
        scalar_range = (
            geometry.scalar_range
            if geometry.has_scalar_range
            else compute_global_scalar_range(geometry)
        )
        clip_start = float(np.clip(scalar_range[1], 0.0, 1.0))
        apply_clip = 1.0 > clip_start + SOFT_CLIP_TOLERANCE
        t = geometry.scalar_transform
        # trilinear: 1-cell ghost rings make cube splits seam-free (the
        # core shrinks to MAX_CUBE - 2 so the stored block still fits)
        ghost = 1 if parameters.sampling == "trilinear" else 0
        core = MAX_CUBE - 2 * ghost
        datas = [
            _pretransform(b.data, t, clip_start, apply_clip)
            for b in geometry.bricks
        ]
        padded_list = [None] * len(datas)
        if ghost and len(datas) > 1:
            from .ghost import ghost_fill

            padded_list = ghost_fill(
                datas, [(b.min_corner, b.max_corner) for b in geometry.bricks],
                ghost,
            )
        pieces, piece_meta, piece_ranges = [], [], []
        for parent, brick in enumerate(geometry.bricks):
            for d, mn, mx, dims in _split_to_cubes(
                datas[parent], brick.min_corner, brick.max_corner, core,
                ghost=ghost, padded=padded_list[parent],
            ):
                pieces.append(d)
                piece_meta.append((mn, mx, dims, parent))
                piece_ranges.append((float(np.min(d)), float(np.max(d))))
        num = len(pieces)
        if num == 0:
            raise ValueError("scene contains no bricks")
        canonical = np.zeros((num, MAX_CUBE, MAX_CUBE, MAX_CUBE), np.float32)
        for i, d in enumerate(pieces):
            canonical[i, : d.shape[0], : d.shape[1], : d.shape[2]] = d

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
            visible=np.array(
                [_range_visible(lo, hi, scalar_range, lut_alpha)
                 for lo, hi in piece_ranges],
                dtype=bool,
            ),
            device=device,
        )

    @classmethod
    def from_tables(cls, parameters: RenderParameters, device: Device = DEFAULT_DEVICE,
                    **tables) -> "FastSceneRenderer":
        """A renderer over an already packed scene (``state.py`` lists the
        tables); every piece counts as visible."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        validate_render_parameters(parameters)
        tables.setdefault(
            "visible", np.ones(len(tables["canonical"]), dtype=bool)
        )
        self._setup(parameters, device=device, **tables)
        return self

    def _setup(
        self, parameters, *, canonical, box_min, box_max, dims_world, parents,
        owners, parent_min, parent_max, lut, lut_alpha, scalar_range,
        reference_sample_distance, ghost, bounds, tight_bounds, visible,
        device,
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
        self.box_min = np.asarray(box_min, np.float64)
        self.box_max = np.asarray(box_max, np.float64)
        self.dims_world = np.asarray(dims_world, np.int32)
        self.parents = np.asarray(parents, np.int32)
        self.owners = np.asarray(owners, np.int32)
        self._parent_min = np.asarray(parent_min, np.float64)
        self._parent_max = np.asarray(parent_max, np.float64)
        self._lut = np.asarray(lut, np.float32)
        self._lut_alpha = np.asarray(lut_alpha)
        self.visible = np.asarray(visible, bool)
        self.register_buffer("lut", torch.tensor(self._lut, device=dev))
        self.register_buffer(
            "canonical",
            torch.tensor(np.asarray(canonical), dtype=torch.float32, device=dev),
        )
        # per-octant ordering-key memo (visibility.OrderKeyCache)
        self._order_cache = OrderKeyCache(
            self.box_min, self.box_max, self._parent_min, self._parent_max
        )
        self._set_canonical()

    def _set_canonical(self) -> None:
        """Per-axis value extrema of the piece table, reduced on the device:
        per slice (occupied-slice bounds) and per 8 x 8 stored (u, v) block
        of each slice (per-item slice bands).  Core slice k is stored at
        k + ghost; the in-plane ring joins the extrema (bilinear samples
        it), which only widens the ranges."""
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
                v.amin(dim=(2, 3)).cpu().numpy(), v.amax(dim=(2, 3)).cpu().numpy()
            )
            quads = torch.stack(
                [blocks.amin(dim=(3, 5)), blocks.amax(dim=(3, 5))]
            ).cpu().numpy()
            self._slice_quad_minmax[a] = (quads[0], quads[1])
        self._packed_axis: Optional[int] = None
        self._packed_vol: Optional[torch.Tensor] = None
        self._axis_meta_cache: dict = {}
        self._packed_cache: dict = {}  # axis -> repacked table (<= 3 copies)

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

    def render_frame(self, camera: CameraParameters) -> torch.Tensor:
        """The output-resolution [width*height, 5] frame on the device:
        one kernel launch, scatter of the compacted grid, untile, crop, AA
        downsample."""
        inputs = self.frame_inputs(camera)
        if inputs is None:
            frame = torch.zeros(
                (self.render_height * self.render_width, 5),
                dtype=torch.float32, device=self.device,
            )
            frame[:, 4] = float("inf")
        else:
            out_c, out_d = tm.tilemarch_render(
                self._packed_vol, inputs["meta"], inputs["dims"], self.lut,
                inputs["cam"], inputs["offsets"], inputs["bricks"],
                inputs["owners"], inputs["item_bounds"], inputs["tile_ids"],
                width=self.pad_w, height=self.pad_h, max_slices=self.cube,
                logical_width=self.render_width,
                logical_height=self.render_height,
                sampling=self.parameters.sampling, ghost=self.ghost,
                classification=self.parameters.classification,
            )
            tiles_x = self.pad_w // wl.TILE_W
            tiles_y = self.pad_h // wl.TILE_H
            out_c, out_d = tm.scatter_tiles(
                out_c, out_d, inputs["tile_ids"], tiles_x * tiles_y
            )
            c = out_c.reshape(tiles_y, tiles_x, 4, wl.TILE_H, wl.TILE_W)
            c = c.permute(0, 3, 1, 4, 2).reshape(self.pad_h, self.pad_w, 4)
            d = out_d.reshape(tiles_y, tiles_x, wl.TILE_H, wl.TILE_W)
            d = d.permute(0, 2, 1, 3).reshape(self.pad_h, self.pad_w)
            frame = torch.cat([c, d[..., None]], dim=-1)
            frame = frame[: self.render_height, : self.render_width].reshape(-1, 5)
        if self.sqrt_aa > 1:
            frame = _device_downsample(
                frame, self.render_width, self.render_height, self.sqrt_aa
            )
        return frame

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
        if overlay or output_filename:
            from .image import ImageBuffer, ImageKind

            image = ImageBuffer(
                ImageKind.RGBA_F32_DEPTH_SORT, self.parameters.width,
                self.parameters.height, pixels.copy(),
            )
            if overlay:
                render_bounding_box_overlay(self.tight_bounds, camera, 1, image)
            if output_filename:
                from . import io as image_io

                image_io.save_image(image, output_filename)
            return image.pixels
        return pixels

