"""Fused single-device frame: the one-shot slice-march route and the
tile-march route.

The port of the JAX package's ``renderer_fast.py`` for one device.
``prepare_slicemarch_scene`` packs the scene once per march axis (scalar
pre-transform, soft tail clip, slices split to fit 1024 cells, a shared
log-LUT; cached on the geometry) and builds the per-frame (piece, tile)
work list.  ``render_composited_slicemarch`` renders a frame through the
work-list march kernel and the tile composite kernel (``composited_frame``)
for scenes of at most ``TILEMARCH_PIECE_THRESHOLD`` pieces, and hands
larger scenes to ``render_composited_tilemarch``, one launch of the fused
march + composite kernel on the same prep, whose memory does not grow with
the piece count.  ``render_layers_slicemarch`` returns the
per-piece layers instead (the layered path).  ``render_composited_sharded``
renders a frame over several shards (``parallel.directsend``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import native
from .camera import camera_basis
from .colormap import SOFT_CLIP_TOLERANCE, build_color_table, saturate_soft_tail_np
from .device import DEFAULT_DEVICE, Device, resolve_device
from .ops import tilemarch as tm
from .ops import worklist as wl
from .ops.composite import composite_tiles
from .ops.slicemarch import (
    pack_slice_volume,
    slicemarch_render_worklist,
    slicemarch_render_worklist_raw,
    split_brick_for_slices,
    untile,
)
from .types import (
    CameraParameters,
    ColorMap,
    RenderParameters,
    SceneGeometry,
    VolumeBounds,
)
from .visibility import OrderKeyCache, order_keys_or_hints

# above this piece count the one-shot route's per-piece layer buffers
# ([B, T, 4, 1024] f32) dominate and the frame goes to the tile-march
# kernel, whose memory is independent of the piece count
TILEMARCH_PIECE_THRESHOLD = 96


def _pretransform(
    data: np.ndarray, transform, clip_start: float, apply_clip: bool
) -> np.ndarray:
    """Apply the scalar transform (VolumeTypes.hpp:53-67) and the optional
    soft tail clip to a whole brick; returns float32."""
    data = np.asarray(data)
    if (
        data.dtype == np.float32
        and not transform.log_scale_input
        and not transform.normalize_to_unit_range
    ):
        # identity transform on f32 input: the f64 round trip is exact
        v = np.where(np.isfinite(data), data, np.float32(0.0))
        if apply_clip:
            v = saturate_soft_tail_np(v, clip_start, 1.0).astype(np.float32)
        return v
    v = np.asarray(data, dtype=np.float64)
    v = np.where(np.isfinite(v), v, 0.0)
    if transform.log_scale_input:
        v = np.where(v > 0.0, np.maximum(v, transform.positive_floor),
                     transform.positive_floor)
        v = np.log(v)
    if transform.normalize_to_unit_range:
        v = np.clip(
            (v - transform.normalization_min) * transform.inverse_normalization_span,
            0.0, 1.0,
        )
    v = v.astype(np.float32)
    if apply_clip:
        v = saturate_soft_tail_np(v, clip_start, 1.0).astype(np.float32)
    return v


def _quad_extrema(stored: np.ndarray, nq: int = 4):
    """Per-slice nq x nq block extrema of one piece's stored slices via two
    ``reduceat`` passes.  Blocks past the stored extent stay (+inf, -inf)."""
    ns, su, sv = stored.shape
    bu = -(-su // nq)
    bv = -(-sv // nq)
    nu_b = -(-su // bu)
    nv_b = -(-sv // bv)
    u_idx = np.arange(nu_b) * bu
    v_idx = np.arange(nv_b) * bv
    qmin = np.full((ns, nq, nq), np.inf, np.float32)
    qmax = np.full((ns, nq, nq), -np.inf, np.float32)
    mn = np.minimum.reduceat(stored, u_idx, axis=1)
    qmin[:, :nu_b, :nv_b] = np.minimum.reduceat(mn, v_idx, axis=2)
    mx = np.maximum.reduceat(stored, u_idx, axis=1)
    qmax[:, :nu_b, :nv_b] = np.maximum.reduceat(mx, v_idx, axis=2)
    return qmin, qmax, bu, bv


def _grouped_cumcount(owners: np.ndarray) -> np.ndarray:
    """local_indices[i] = #earlier layers with the same owner."""
    n = len(owners)
    out = np.zeros(n, dtype=np.int32)
    if n == 0:
        return out
    order = np.argsort(owners, kind="stable")
    sorted_owners = owners[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_owners)) + 1]
    group = np.repeat(np.arange(len(starts)), np.diff(np.r_[starts, n]))
    out[order] = np.arange(n, dtype=np.int32) - starts[group].astype(np.int32)
    return out


def _transform_key(t) -> tuple:
    return (
        bool(t.log_scale_input), float(t.positive_floor),
        bool(t.normalize_to_unit_range), float(t.normalization_min),
        float(t.inverse_normalization_span),
    )


def _geometry_pack_batched(
    bricks, t, clip_start: float, apply_clip: bool, axis: int, axes,
    ghost: int, nq: int,
):
    """One-shot batched packing for uniform brick tables: when every brick
    has the same shape and dtype, needs no transverse split and carries no
    ghost ring, the whole table packs with a few stacked array ops (or one
    native pass).  Byte-identical to the per-piece loop of
    ``_geometry_pack``; None when the preconditions fail."""
    n = len(bricks)
    if n == 0 or ghost != 0:
        return None
    shape = np.asarray(bricks[0].data).shape
    dtype = np.asarray(bricks[0].data).dtype
    if len(shape) != 3:
        return None
    nu_st, nv_st = shape[axes[1]], shape[axes[2]]
    if nu_st * nv_st > wl.SLICE_CELLS:
        return None  # transverse split required -> loop path
    if min(shape) == 0:
        return None
    for b in bricks:
        d = np.asarray(b.data)
        if d.shape != shape or d.dtype != dtype:
            return None

    # native single pass (pretransform, slice packing, block and slice
    # extrema) when the transform allows it
    native_out = None
    if not apply_clip:
        native_out = native.pack_slice_volumes(
            [np.asarray(b.data) for b in bricks], axes, t, nq, wl.SLICE_CELLS,
        )
    if native_out is not None:
        flat, quad_min, quad_max, slice_min, slice_max = native_out
        ns = flat.shape[1]
        vol = flat.reshape(n, ns, wl.SUBLANES, wl.LANES)
    else:
        slice_min = slice_max = None
        stack = np.stack([np.asarray(b.data) for b in bricks])
        stack = _pretransform(stack, t, clip_start, apply_clip)
        vol_t = np.transpose(stack, [0] + [1 + a for a in axes])
        ns = vol_t.shape[1]
        flat = np.zeros((n, ns, wl.SLICE_CELLS), np.float32)
        flat[:, :, : nu_st * nv_st] = vol_t.reshape(n, ns, nu_st * nv_st)
        vol = flat.reshape(n, ns, wl.SUBLANES, wl.LANES)

    # piece corners exactly as split_brick_for_slices derives them for the
    # unsplit case: mx = mn0 + shape * spans (byte parity with the loop)
    mn0 = np.stack([np.asarray(b.min_corner, float) for b in bricks])
    mx0 = np.stack([np.asarray(b.max_corner, float) for b in bricks])
    shp = np.asarray(shape, int)
    spans = (mx0 - mn0) / np.maximum(shp, 1)
    box_min = mn0
    box_max = mn0 + shp * spans
    pmin = box_min[:, axes]
    pmax = box_max[:, axes]
    cell = (pmax - pmin) / np.array([ns, nu_st, nv_st])
    meta = np.zeros((n, 12), np.float32)
    meta[:, 0:3], meta[:, 3:6], meta[:, 6:9] = pmin, pmax, cell
    dims = np.zeros((n, 8), np.int32)
    dims[:, 0:3] = (ns, nu_st, nv_st)
    dims[:, 3:6] = axes
    dims[:, 6] = nv_st  # stored row stride (ghost == 0)
    parents = np.arange(n, dtype=np.int32)

    bu = -(-nu_st // nq)
    bv = -(-nv_st // nq)
    if native_out is None:
        stored = vol_t  # ghost == 0: stored extent == core extent
        nu_b = -(-nu_st // bu)
        nv_b = -(-nv_st // bv)
        quad_min = np.full((n, ns, nq, nq), np.inf, np.float32)
        quad_max = np.full((n, ns, nq, nq), -np.inf, np.float32)
        u_idx = np.arange(nu_b) * bu
        v_idx = np.arange(nv_b) * bv
        mn = np.minimum.reduceat(stored, u_idx, axis=2)
        quad_min[:, :, :nu_b, :nv_b] = np.minimum.reduceat(mn, v_idx, axis=3)
        mx = np.maximum.reduceat(stored, u_idx, axis=2)
        quad_max[:, :, :nu_b, :nv_b] = np.maximum.reduceat(mx, v_idx, axis=3)
    split_u = np.full(n, float(bu))
    split_v = np.full(n, float(bv))
    return (
        vol, meta, dims, box_min, box_max, parents, quad_min, quad_max,
        split_u, split_v, ns, slice_min, slice_max,
    )


def _geometry_pack(
    geometry: SceneGeometry, axis: int, ghost: int,
    clip_start: float, apply_clip: bool,
):
    """Camera- and transfer-function-independent piece packing, cached on
    the geometry object per march axis.  The key holds the brick data
    identities and the scalar transform, and the entry pins the data
    objects, so a replaced array always repacks (in-place mutation is not
    tracked).  Returns None when the scene packs to zero pieces."""
    bricks = geometry.bricks
    key = (
        axis, ghost, float(clip_start), bool(apply_clip),
        _transform_key(geometry.scalar_transform),
        tuple(id(b.data) for b in bricks),
    )
    cache = geometry.__dict__.setdefault("_slicemarch_packs", {})
    refs = geometry.__dict__.setdefault("_slicemarch_pack_refs", [])
    if key in cache:
        return cache[key]
    if len(cache) >= 4:  # bound the retained host tables
        cache.clear()
        refs.clear()
    refs.append([b.data for b in bricks])

    t = geometry.scalar_transform
    axes = [axis] + [a for a in range(3) if a != axis]
    nq = 8
    batched = _geometry_pack_batched(
        bricks, t, clip_start, apply_clip, axis, axes, ghost, nq
    )
    if batched is not None:
        (vol, meta, dims, box_min, box_max, parents, quad_min, quad_max,
         split_u, split_v, s_max_all, slice_min, slice_max) = batched
        num_layers = len(meta)
    else:
        slice_min = slice_max = None
        datas = [
            _pretransform(brick.data, t, clip_start, apply_clip)
            for brick in bricks
        ]
        # cross-BRICK ghost fill: rings at true brick faces take neighbour
        # values so abutting bricks interpolate seam-free
        padded_list = [None] * len(bricks)
        if ghost and len(bricks) > 1:
            from .ghost import ghost_fill

            padded_list = ghost_fill(
                datas, [(b.min_corner, b.max_corner) for b in bricks], ghost
            )

        pieces = []
        for parent, brick in enumerate(bricks):
            for d, mn, mx in split_brick_for_slices(
                datas[parent], brick.min_corner, brick.max_corner, axis,
                ghost=ghost, padded=padded_list[parent],
            ):
                vol, (ns, nu, nv) = pack_slice_volume(d, axis, ghost=ghost)
                pmin = np.asarray(mn, float)[axes]
                pmax = np.asarray(mx, float)[axes]
                cell = (pmax - pmin) / np.array([ns, nu, nv])
                meta = np.zeros(12, np.float32)
                meta[0:3], meta[3:6], meta[6:9] = pmin, pmax, cell
                dims4 = np.zeros(8, np.int32)
                dims4[:3] = (ns, nu, nv)
                dims4[3:6] = axes
                dims4[6] = nv + 2 * ghost  # stored row stride
                pieces.append(
                    (vol, meta, dims4, parent, np.asarray(mn), np.asarray(mx))
                )

        num_layers = len(pieces)
        if num_layers == 0:
            cache[key] = None
            return None

        s_max_all = max(p[0].shape[0] for p in pieces)
        vol = np.zeros(
            (num_layers, s_max_all, wl.SUBLANES, wl.LANES), np.float32
        )
        meta = np.zeros((num_layers, 12), np.float32)
        dims = np.zeros((num_layers, 8), np.int32)
        box_min = np.zeros((num_layers, 3))
        box_max = np.zeros((num_layers, 3))
        parents = np.zeros(num_layers, np.int32)
        # per-slice 8x8 stored-(u, v) block extrema for the per-item slice
        # bands; padding slices are (+inf, -inf) = never occupied
        quad_min = np.full((num_layers, s_max_all, nq, nq), np.inf, np.float32)
        quad_max = np.full((num_layers, s_max_all, nq, nq), -np.inf, np.float32)
        split_u = np.zeros(num_layers, np.float64)
        split_v = np.zeros(num_layers, np.float64)
        for i, (v, m, dd, parent, mn, mx) in enumerate(pieces):
            vol[i, : v.shape[0]] = v
            meta[i] = m
            dims[i] = dd
            box_min[i] = mn
            box_max[i] = mx
            parents[i] = parent
            ns, nu, nv = int(dd[0]), int(dd[1]), int(dd[2])
            su_ext, sv_ext = nu + 2 * ghost, nv + 2 * ghost
            stored = v.reshape(v.shape[0], -1)[:, : su_ext * sv_ext].reshape(
                v.shape[0], su_ext, sv_ext
            )[ghost: ghost + ns]  # core slices, full stored (u, v)
            qmn, qmx, bu, bv = _quad_extrema(stored, nq)
            quad_min[i, :ns] = qmn
            quad_max[i, :ns] = qmx
            split_u[i], split_v[i] = bu, bv
    # per-slice extrema of the PACKED slices (padding zeros included) for
    # the per-LUT occupied-slice bounds
    if slice_min is None:
        cap = s_max_all - 2 * ghost if ghost else s_max_all
        core = vol[:, ghost: ghost + cap] if ghost else vol
        slice_min = core.reshape(num_layers, cap, -1).min(axis=2)
        slice_max = core.reshape(num_layers, cap, -1).max(axis=2)

    gp = dict(
        vol=vol, meta=meta, dims=dims, box_min=box_min, box_max=box_max,
        parents=parents, quad_min=quad_min, quad_max=quad_max,
        split_u=split_u, split_v=split_v, nq=nq, s_max=s_max_all,
        slice_min=slice_min, slice_max=slice_max, ghost=ghost, axis=axis,
        lut_packs={},
        parent_min=np.array([b.min_corner for b in bricks]),
        parent_max=np.array([b.max_corner for b in bricks]),
    )
    cache[key] = gp
    return gp


def _lut_pack(gp: dict, lut: np.ndarray, scalar_range: Tuple[float, float]):
    """Transfer-function-dependent tables (occupied-slice bounds, block
    occupancy bits, per-piece log-LUT), cached per LUT on the pack."""
    range_span = scalar_range[1] - scalar_range[0]
    inv_range = 1.0 / range_span if range_span != 0.0 else 1.0
    key = (hash(lut.tobytes()), float(scalar_range[0]), float(inv_range))
    cache = gp["lut_packs"]
    if key in cache:
        return cache[key]
    if len(cache) >= 4:
        cache.clear()
    dims7 = wl.compute_slice_bounds_batch(
        gp["slice_min"], gp["slice_max"], lut[:, 3], scalar_range[0],
        inv_range, gp["dims"][:, 0],
    )
    occ_bits = wl.block_occupancy_bits(
        gp["quad_min"], gp["quad_max"], lut[:, 3], scalar_range[0], inv_range
    )
    packed_lut = wl.build_log_lut(lut)
    luts = np.ascontiguousarray(
        np.broadcast_to(
            packed_lut[None], (gp["dims"].shape[0],) + packed_lut.shape
        )
    )
    lp = dict(dims7=dims7, occ_bits=occ_bits, luts=luts)
    cache[key] = lp
    return lp


def _cached_color_table(
    geometry: SceneGeometry, alpha_scale: float,
    scalar_range: Tuple[float, float], color_map: Optional[ColorMap],
    lut_size: int,
) -> np.ndarray:
    """Content-keyed memo of ``build_color_table`` on the geometry object
    (control points keyed by value, so an equal colormap still hits)."""
    cm_key = (
        None if not color_map else tuple(
            (p.value, p.red, p.green, p.blue, p.alpha) for p in color_map
        )
    )
    key = (
        float(alpha_scale), float(scalar_range[0]), float(scalar_range[1]),
        int(lut_size), cm_key,
    )
    cache = geometry.__dict__.setdefault("_color_table_cache", {})
    lut = cache.get(key)
    if lut is None:
        if len(cache) >= 8:
            cache.clear()
        lut = build_color_table(
            alpha_scale, 1.0, scalar_range, color_map, size=lut_size
        )
        cache[key] = lut
    return lut


def prepare_slicemarch_scene(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    scalar_range: Tuple[float, float],
    reference_sample_distance: float,
    render_width: int,
    render_height: int,
    color_map: Optional[ColorMap],
):
    """All host inputs of the slice-march route for one camera: the packed
    piece arrays, camera pack, coverage-culled (piece, tile) work list with
    per-item slice bounds, padded frame dims and the piece-level
    hint/owner/local arrays.  Byte-identical to the JAX package's dict.
    None when the scene packs to nothing or every item is empty."""
    alpha_scale = float(np.clip(1.0 - parameters.box_transparency, 0.0, 1.0))
    clip_start = float(np.clip(scalar_range[1], 0.0, 1.0))
    apply_clip = 1.0 > clip_start + SOFT_CLIP_TOLERANCE

    forward, right, up = camera_basis(camera)
    axis = wl.choose_march_axis(forward)

    pad_w = ((render_width + wl.TILE_W - 1) // wl.TILE_W) * wl.TILE_W
    pad_h = ((render_height + wl.TILE_H - 1) // wl.TILE_H) * wl.TILE_H

    # trilinear packs carry a 1-cell ghost ring (seam-free interpolation)
    ghost = 1 if parameters.sampling == "trilinear" else 0

    gp = _geometry_pack(geometry, axis, ghost, clip_start, apply_clip)
    if gp is None:
        return None
    lut = _cached_color_table(
        geometry, alpha_scale, scalar_range, color_map, parameters.lut_size
    )
    lp = _lut_pack(gp, lut, scalar_range)
    # empty-space skipping: march only transfer-function-occupied slices
    dims = gp["dims"].copy()
    dims[:, 7] = lp["dims7"]
    meta = gp["meta"]

    range_span = scalar_range[1] - scalar_range[0]
    inv_range = 1.0 / range_span if range_span != 0.0 else 1.0
    cam = wl.pack_camera(
        np.asarray(camera.eye), forward, right, up, camera.fov_y_degrees,
        render_width / max(render_height, 1),
        scalar_range[0], inv_range,
        reference_sample_distance,
    )

    wb, wt, coverage = wl.compute_worklist(
        gp["box_min"], gp["box_max"], np.asarray(camera.eye), forward, right,
        up, camera.fov_y_degrees, pad_w, pad_h,
        logical_width=render_width, logical_height=render_height,
    )
    # min_gap sentinel disables band splitting: items map 1:1 to
    # (piece, tile) coverage, so each keeps its full occupied range
    wbounds, _, _ = wl.compute_item_bands(
        meta, dims[:, 7], wt, wb, np.asarray(camera.eye), forward, right,
        up, camera.fov_y_degrees, [axis] + [a for a in range(3) if a != axis],
        pad_w, pad_h, render_width, render_height,
        lp["occ_bits"], gp["nq"], gp["split_u"], gp["split_v"], ghost=ghost,
        min_gap=1 << 30,
        seg_len=2,
        margin=wl.footprint_margin(ghost, parameters.sampling),
    )
    # cull fully-empty (piece, tile) items and clear their coverage bit, so
    # the composite treats the unwritten block as background
    nonempty = (wbounds >> 16) < (wbounds & 0xFFFF)
    if not nonempty.all():
        if not nonempty.any():
            return None
        wb2, wt2, wbounds2 = wb[nonempty], wt[nonempty], wbounds[nonempty]
        coverage = coverage.copy()
        coverage[wb[~nonempty], wt[~nonempty]] = False
        # re-pad to the original length by repeating the last item (a
        # duplicate rewrites its block with the same values)
        pad = len(wb) - len(wb2)
        wb = np.concatenate([wb2, np.full(pad, wb2[-1], wb2.dtype)])
        wt = np.concatenate([wt2, np.full(pad, wt2[-1], wt2.dtype)])
        wbounds = np.concatenate(
            [wbounds2, np.full(pad, wbounds2[-1], wbounds2.dtype)]
        )

    # piece-level visibility order keys, memoised per view octant; the
    # parent box's depth hint where the graph is off or fails
    order_cache = gp.get("order_cache")
    if order_cache is None:
        order_cache = gp["order_cache"] = OrderKeyCache(
            gp["box_min"], gp["box_max"], gp["parent_min"], gp["parent_max"]
        )
    depth_hints = order_keys_or_hints(
        camera, render_width / max(render_height, 1),
        gp["box_min"], gp["box_max"],
        use_graph=parameters.use_visibility_graph,
        parents=gp["parents"],
        parent_min=gp["parent_min"], parent_max=gp["parent_max"],
        cache=order_cache, parent_hint_fallback=True,
    )
    brick_owners = np.fromiter(
        (b.owner for b in geometry.bricks), dtype=np.int32,
        count=len(geometry.bricks),
    )
    owners = brick_owners[gp["parents"]]
    local_indices = _grouped_cumcount(owners)

    return dict(
        vol=gp["vol"], meta=meta, dims=dims, luts=lp["luts"], cam=cam,
        wb=wb, wt=wt, coverage=coverage, wbounds=wbounds, s_max=gp["s_max"],
        pad_w=pad_w, pad_h=pad_h, ghost=ghost,
        depth_hints=depth_hints, owners=owners, local_indices=local_indices,
        occ_bits=lp["occ_bits"], nq=gp["nq"],
        split_u=gp["split_u"], split_v=gp["split_v"],
    )


def _device_downsample(
    frame: torch.Tensor, width: int, height: int, block: int
) -> torch.Tensor:
    """Box-average AA downsample of a [width*height, 5] frame on its device
    (VolumeRenderer.cpp:479-528: average RGBA, depth reset to +inf)."""
    tw, th = width // block, height // block
    c = frame[:, :4].reshape(th, block, tw, block, 4).mean(dim=(1, 3))
    d = torch.full((tw * th, 1), float("inf"), dtype=frame.dtype,
                   device=frame.device)
    return torch.cat([c.reshape(tw * th, 4), d], dim=-1)


def _background(num_pixels: int) -> np.ndarray:
    out = np.zeros((num_pixels, 5), np.float32)
    out[:, 4] = np.inf
    return out


def visibility_owner_keys(
    owners: np.ndarray, rank_order: Optional[np.ndarray]
) -> np.ndarray:
    """Map layer owners to their position in the visibility rank order, so
    depth-hint ties between owners break in visibility-graph order rather
    than rank order (the reference uses rank, DirectSendBase.cpp:378-388).
    Identity when no order is supplied or an owner falls outside it."""
    owners = np.asarray(owners, dtype=np.int32)
    if rank_order is None or len(rank_order) <= 1:
        return owners
    num_ranks = len(rank_order)
    position = np.empty(num_ranks, dtype=np.int32)
    position[np.asarray(rank_order, dtype=np.int32)] = np.arange(
        num_ranks, dtype=np.int32
    )
    keys = owners.copy()
    in_range = (owners >= 0) & (owners < num_ranks)
    keys[in_range] = position[owners[in_range]]
    return keys


def slicemarch_device_inputs(prep: dict, dev: torch.device) -> dict:
    """The prepared arrays the kernels read, as tensors on ``dev``."""
    keys = ("vol", "meta", "dims", "luts", "cam", "wb", "wt", "wbounds",
            "coverage")
    return {k: torch.from_numpy(np.ascontiguousarray(prep[k])).to(dev)
            for k in keys}


def composited_frame(
    vol, meta, dims, lut, cam, work_bricks, work_tiles, coverage,
    order, owners_sorted, work_bounds=None, *, width, height, max_slices,
    logical_width=None, logical_height=None, sampling="nearest", ghost=0,
    classification="post",
) -> torch.Tensor:
    """Work-list march -> tile composite -> one untile: the composited
    row-major [width * height, 5] frame on the inputs' device.  Every
    layer's pixels are written once and read once; the [B, T, 4, 1024]
    layer buffers are allocated once per frame."""
    colors, depths = slicemarch_render_worklist_raw(
        vol, meta, dims, lut, cam, work_bricks, work_tiles, work_bounds,
        width=width, height=height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification,
    )
    out_c, out_d = composite_tiles(colors, depths, order, owners_sorted, coverage)
    c, d = untile(out_c[None], out_d[None], width, height)
    return torch.cat([c[0], d[0, :, None]], dim=-1)


def render_composited_slicemarch(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    scalar_range: Tuple[float, float],
    reference_sample_distance: float,
    render_width: int,
    render_height: int,
    color_map: Optional[ColorMap],
    downsample_block: int = 1,
    rank_order: Optional[np.ndarray] = None,
    device: Device = DEFAULT_DEVICE,
) -> np.ndarray:
    """The composited frame, [(render_width / block) * (render_height /
    block), 5] on the host.  Render, composite and AA downsample stay on
    ``device``; only the final frame crosses to the host.  Scenes of more
    than ``TILEMARCH_PIECE_THRESHOLD`` pieces go to the tile-march route."""
    from .compositor import sort_layers

    dev = resolve_device(device)
    prep = prepare_slicemarch_scene(
        geometry, parameters, camera, scalar_range, reference_sample_distance,
        render_width, render_height, color_map,
    )
    block = max(downsample_block, 1)
    if prep is None:
        return _background((render_width // block) * (render_height // block))
    if prep["vol"].shape[0] > TILEMARCH_PIECE_THRESHOLD:
        return _tilemarch_frame(prep, parameters, camera, render_width,
                                render_height, block, rank_order, dev)

    owner_keys = visibility_owner_keys(prep["owners"], rank_order)
    order = sort_layers(prep["depth_hints"], owner_keys, prep["local_indices"])
    inp = slicemarch_device_inputs(prep, dev)
    frame = composited_frame(
        inp["vol"], inp["meta"], inp["dims"], inp["luts"], inp["cam"],
        inp["wb"], inp["wt"], inp["coverage"],
        torch.from_numpy(order).to(dev),
        torch.from_numpy(np.ascontiguousarray(owner_keys[order])).to(dev),
        inp["wbounds"],
        width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
        logical_width=render_width, logical_height=render_height,
        sampling=parameters.sampling, ghost=prep["ghost"],
        classification=parameters.classification,
    )
    frame = frame.reshape(prep["pad_h"], prep["pad_w"], 5)
    frame = frame[:render_height, :render_width].reshape(-1, 5)
    if block > 1:
        frame = _device_downsample(frame, render_width, render_height, block)
    return frame.cpu().numpy()


def render_composited_sharded(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    scalar_range: Tuple[float, float],
    reference_sample_distance: float,
    render_width: int,
    render_height: int,
    color_map: Optional[ColorMap],
    num_devices: int,
    downsample_block: int = 1,
    pipeline: str = "auto",
    transport: str = "float32",
    rank_order: Optional[np.ndarray] = None,
    device: Device = DEFAULT_DEVICE,
) -> np.ndarray:
    """The composited frame over ``num_devices`` shards (the reference's
    ``mpirun`` distribution, VolumeRenderer/main.cpp:19-36): pieces are
    placed on the shards of a ``parallel.directsend.Mesh`` per frame,
    rendered, exchanged and folded there, and the pixel shards are
    gathered to the host.

    ``pipeline`` picks the exchange: ``"depth"`` (and ``"auto"``) gives
    each shard a contiguous run of the global depth order and exchanges D
    partial frames (the dense slice-march kernel per shard, or the
    tile-march kernel above ``TILEMARCH_PIECE_THRESHOLD`` pieces);
    ``"layered"`` places pieces in (owner, local) order and exchanges
    every layer.  Returns the [(render_width / block) * (render_height /
    block), 5] frame."""
    from .compositor import sort_layers
    from .parallel.directsend import (
        gather_frame,
        make_mesh,
        pack_contiguous,
        pack_depth_contiguous,
        paste_rect,
        paste_tiles,
        render_and_composite_sharded_slicemarch,
        render_depth_contiguous_slicemarch,
        render_depth_contiguous_tilemarch,
        select_compaction,
    )

    if pipeline not in ("auto", "depth", "layered"):
        raise ValueError(f"unknown multichip pipeline '{pipeline}'")
    mesh = make_mesh(num_devices, device)
    prep = prepare_slicemarch_scene(
        geometry, parameters, camera, scalar_range, reference_sample_distance,
        render_width, render_height, color_map,
    )
    num_pixels = render_width * render_height
    block = max(downsample_block, 1)
    if prep is None:
        return _background((render_width // block) * (render_height // block))
    pad_pixels = prep["pad_w"] * prep["pad_h"]
    if pad_pixels % num_devices:
        raise ValueError(
            f"padded frame ({prep['pad_w']}x{prep['pad_h']}) is not divisible "
            f"by the device count {num_devices}"
        )

    owner_keys = visibility_owner_keys(prep["owners"], rank_order)
    # coverage-compacted exchange: only covered pixels cross between shards
    rect, tiles = select_compaction(
        prep["coverage"], prep["pad_w"], prep["pad_h"], wl.TILE_W, wl.TILE_H,
        num_devices,
    )
    kw = dict(
        width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
        logical_width=render_width, logical_height=render_height,
        sampling=parameters.sampling, ghost=prep["ghost"], transport=transport,
        rect=rect, tiles=tiles, classification=parameters.classification,
    )
    if pipeline == "layered":
        # static placement in global (owner, local) order, so the shards'
        # stable depth argsort reproduces the reference layer order
        key_order = np.lexsort((prep["local_indices"], owner_keys))
        (p_vol, p_meta, p_dims, p_luts), valid, p_hints = pack_contiguous(
            num_devices, prep["depth_hints"][key_order],
            prep["vol"][key_order], prep["meta"][key_order],
            prep["dims"][key_order], prep["luts"][key_order],
        )
        frame = render_and_composite_sharded_slicemarch(
            mesh, p_vol, p_meta, p_dims, p_luts, prep["cam"], valid, p_hints,
            **kw)
    else:
        # per-frame depth-contiguous placement in the single-device fold's
        # (hint, owner, local) order
        key_order = sort_layers(
            prep["depth_hints"], owner_keys, prep["local_indices"]
        )
        tables = (prep["vol"][key_order], prep["meta"][key_order],
                  prep["dims"][key_order])
        ties = np.arange(len(key_order), dtype=np.int32)
        hints = prep["depth_hints"][key_order]
        if prep["vol"].shape[0] > TILEMARCH_PIECE_THRESHOLD:
            # deep-AMR scenes: each shard renders and pre-composites its
            # run in the tile-march kernel, O(pixels) memory per shard
            (p_vol, p_meta, p_dims), _valid, _hints = pack_depth_contiguous(
                hints, ties, num_devices, *tables)
            num_tiles = (prep["pad_w"] // wl.TILE_W) * (prep["pad_h"] // wl.TILE_H)
            worklists = _depth_contiguous_tile_worklists(
                prep["wb"], prep["wt"], prep["wbounds"], key_order,
                num_devices, num_tiles,
            )
            frame = render_depth_contiguous_tilemarch(
                mesh, p_vol, p_meta, p_dims,
                np.ascontiguousarray(prep["luts"][0]), prep["cam"],
                *worklists, **kw)
        else:
            (p_vol, p_meta, p_dims, p_luts), valid, p_hints = (
                pack_depth_contiguous(hints, ties, num_devices, *tables,
                                      prep["luts"][key_order]))
            frame = render_depth_contiguous_slicemarch(
                mesh, p_vol, p_meta, p_dims, p_luts, prep["cam"], valid,
                p_hints, **kw)

    # every process assembles the whole frame, as JAX's
    # process_allgather(frame, tiled=True) does
    frame = paste_rect(gather_frame(mesh, frame).cpu().numpy(), rect,
                       prep["pad_w"], prep["pad_h"])
    frame = paste_tiles(frame, tiles, prep["pad_w"], prep["pad_h"])
    frame = frame.reshape(prep["pad_h"], prep["pad_w"], 5)
    frame = frame[:render_height, :render_width].reshape(num_pixels, 5)
    if block > 1:
        tw, th = render_width // block, render_height // block
        c = frame[:, :4].reshape(th, block, tw, block, 4).mean(axis=(1, 3))
        out = np.empty((tw * th, 5), np.float32)
        out[:, :4] = c.reshape(tw * th, 4)
        out[:, 4] = np.inf
        return out
    return frame


def _depth_contiguous_tile_worklists(
    wb: np.ndarray,
    wt: np.ndarray,
    wbounds: np.ndarray,
    key_order: np.ndarray,
    num_devices: int,
    num_tiles: int,
):
    """Per-shard CSR tile work lists for the tile-march pipeline.

    ``key_order`` is the global depth sort of the pieces;
    ``pack_depth_contiguous`` gives shard d the d-th contiguous chunk, slot
    order = depth order.  Work items (from the global culled work list)
    are deduplicated (the list pads by repeating its last item, which
    would composite twice in a CSR fold), split by shard, ordered per tile
    by global depth position and re-indexed to local slots.  Run keys are
    the slot index: every piece is its own run.

    Returns (offsets [D, T+1] i32, bricks [D, Wmax] i32, owners [D, Wmax]
    i32, ibounds [D, Wmax] i32)."""
    from .parallel.directsend import _contiguous_chunk_counts

    n = len(key_order)
    counts = _contiguous_chunk_counts(n, num_devices)
    pos_of_piece = np.empty(n, np.int64)
    pos_of_piece[np.asarray(key_order)] = np.arange(n)
    starts = np.r_[0, np.cumsum(counts)]
    device_of_pos = np.repeat(np.arange(num_devices), counts)
    slot_of_pos = np.arange(n) - starts[device_of_pos]

    # dedup (piece, tile) pairs keeping the first occurrence's bounds
    pairs = np.asarray(wb, np.int64) * num_tiles + np.asarray(wt, np.int64)
    _, first = np.unique(pairs, return_index=True)
    wb_u = np.asarray(wb)[first]
    wt_u = np.asarray(wt)[first]
    bounds_u = np.asarray(wbounds)[first]

    pos = pos_of_piece[wb_u]
    dev = device_of_pos[pos]
    slot = slot_of_pos[pos]

    offsets = np.zeros((num_devices, num_tiles + 1), np.int32)
    w_per_dev = np.bincount(dev, minlength=num_devices)
    wmax = max(int(w_per_dev.max()) if len(w_per_dev) else 0, 1)
    bricks = np.zeros((num_devices, wmax), np.int32)
    owners = np.zeros((num_devices, wmax), np.int32)
    ibounds = np.zeros((num_devices, wmax), np.int32)
    for d in range(num_devices):
        sel = dev == d
        order = np.lexsort((pos[sel], wt_u[sel]))
        t_d = wt_u[sel][order]
        s_d = slot[sel][order]
        b_d = bounds_u[sel][order]
        w = len(t_d)
        tile_counts = np.bincount(t_d, minlength=num_tiles)
        offsets[d, 1:] = np.cumsum(tile_counts).astype(np.int32)
        bricks[d, :w] = s_d
        owners[d, :w] = s_d  # run key = slot: one run per piece
        ibounds[d, :w] = b_d
    return offsets, bricks, owners, ibounds


def render_layers_slicemarch(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    bounds: VolumeBounds,
    scalar_range: Tuple[float, float],
    reference_sample_distance: float,
    render_width: int,
    render_height: int,
    color_map: Optional[ColorMap],
    device: Device = DEFAULT_DEVICE,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-piece layers on the host: (layers [L, P, 5], depth_hints [L],
    owners [L], local_indices [L]), with L the split pieces and P the
    render pixels.  ``bounds`` is unused (the JAX signature keeps it)."""
    dev = resolve_device(device)
    prep = prepare_slicemarch_scene(
        geometry, parameters, camera, scalar_range, reference_sample_distance,
        render_width, render_height, color_map,
    )
    num_pixels = render_width * render_height
    if prep is None:
        empty = np.zeros(0)
        return (np.zeros((0, num_pixels, 5), dtype=np.float32),
                empty.astype(np.float32), empty.astype(np.int32),
                empty.astype(np.int32))
    inp = slicemarch_device_inputs(prep, dev)
    colors, depths = slicemarch_render_worklist(
        inp["vol"], inp["meta"], inp["dims"], inp["luts"], inp["cam"],
        inp["wb"], inp["wt"], inp["coverage"], inp["wbounds"],
        width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
        logical_width=render_width, logical_height=render_height,
        sampling=parameters.sampling, ghost=prep["ghost"],
        classification=parameters.classification,
    )
    num_layers = colors.shape[0]
    colors = colors.reshape(num_layers, prep["pad_h"], prep["pad_w"], 4)
    depths = depths.reshape(num_layers, prep["pad_h"], prep["pad_w"], 1)
    layers = torch.cat([colors, depths], dim=-1)[:, :render_height, :render_width]
    return (layers.reshape(num_layers, num_pixels, 5).cpu().numpy(),
            prep["depth_hints"], prep["owners"], prep["local_indices"])


def render_composited_tilemarch(
    geometry: SceneGeometry,
    parameters: RenderParameters,
    camera: CameraParameters,
    scalar_range: Tuple[float, float],
    reference_sample_distance: float,
    render_width: int,
    render_height: int,
    color_map: Optional[ColorMap],
    downsample_block: int = 1,
    rank_order: Optional[np.ndarray] = None,
    device: Device = DEFAULT_DEVICE,
) -> np.ndarray:
    """The composited frame through the tile-march kernel (one launch over
    every tile), [(render_width / block) * (render_height / block), 5] on
    the host.  It works on ``prepare_slicemarch_scene``'s prep, so split
    pieces fall back to their parent's depth hint where the visibility
    graph is off, and owners break hint ties in ``rank_order``; its memory
    does not grow with the piece count (deep-AMR scenes)."""
    prep = prepare_slicemarch_scene(
        geometry, parameters, camera, scalar_range, reference_sample_distance,
        render_width, render_height, color_map,
    )
    if prep is None:
        block = max(downsample_block, 1)
        return _background((render_width // block) * (render_height // block))
    return _tilemarch_frame(prep, parameters, camera, render_width,
                            render_height, downsample_block, rank_order,
                            resolve_device(device))


def _tilemarch_frame(prep: dict, parameters: RenderParameters,
                     camera: CameraParameters, render_width: int,
                     render_height: int, downsample_block: int,
                     rank_order: Optional[np.ndarray],
                     dev: torch.device) -> np.ndarray:
    """``render_composited_tilemarch`` on a prep already made."""
    forward, right, up = camera_basis(camera)
    eye = np.asarray(camera.eye)
    # piece boxes in world axis order (the prep's meta is march-permuted)
    inv = np.argsort(prep["dims"][:, 3:6], axis=1)
    box_min = np.take_along_axis(prep["meta"][:, 0:3], inv, axis=1).astype(np.float64)
    box_max = np.take_along_axis(prep["meta"][:, 3:6], inv, axis=1).astype(np.float64)
    offsets, tbricks, towners = wl.build_tile_worklist(
        box_min, box_max, prep["depth_hints"],
        visibility_owner_keys(prep["owners"], rank_order),
        eye, forward, right, up, camera.fov_y_degrees,
        prep["pad_w"], prep["pad_h"],
        logical_width=render_width, logical_height=render_height,
    )
    # per-(tile, piece) slice bands, two-sided band splitting and empty-item
    # culling, as the animation path does (FastSceneRenderer.frame_inputs)
    wt = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    band1, band2, march_fwd = wl.compute_item_bands(
        prep["meta"], prep["dims"][:, 7], wt, tbricks,
        eye, forward, right, up, camera.fov_y_degrees,
        list(prep["dims"][0, 3:6]), prep["pad_w"], prep["pad_h"],
        render_width, render_height,
        prep["occ_bits"], prep["nq"], prep["split_u"], prep["split_v"],
        ghost=prep["ghost"], seg_len=2,
        margin=wl.footprint_margin(prep["ghost"], parameters.sampling),
    )
    wt, tbricks, towners, ibounds = wl.expand_bands(
        wt, tbricks, towners, band1, band2, march_fwd
    )
    nonempty = (ibounds >> 16) < (ibounds & 0xFFFF)
    wt, tbricks, towners, ibounds = (
        wt[nonempty], tbricks[nonempty], towners[nonempty], ibounds[nonempty]
    )
    num_tiles = (prep["pad_w"] // wl.TILE_W) * (prep["pad_h"] // wl.TILE_H)
    offsets = np.zeros(num_tiles + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(np.bincount(wt, minlength=num_tiles))

    def on_dev(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a).to(dev)

    out_c, out_d = tm.tilemarch_render(
        on_dev(prep["vol"]), on_dev(prep["meta"]), on_dev(prep["dims"]),
        on_dev(prep["luts"][0]), on_dev(prep["cam"]), on_dev(offsets),
        on_dev(tbricks, np.int32), on_dev(towners, np.int32),
        on_dev(ibounds, np.int32),
        width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
        logical_width=render_width, logical_height=render_height,
        sampling=parameters.sampling, ghost=prep["ghost"],
        classification=parameters.classification,
    )
    c, d = untile(out_c[None], out_d[None], prep["pad_w"], prep["pad_h"])
    frame = torch.cat([c[0], d[0, :, None]], dim=-1)
    frame = frame.reshape(prep["pad_h"], prep["pad_w"], 5)
    frame = frame[:render_height, :render_width].reshape(-1, 5)
    if downsample_block > 1:
        frame = _device_downsample(frame, render_width, render_height,
                                   downsample_block)
    return frame.cpu().numpy()
