"""Host work-list builders for the tile-march kernel (NumPy + native).

Carried over from the JAX package (``ops/slicemarch.py`` and
``ops/tilemarch.py``) so the port builds the same per-frame inputs without
importing those modules: screen-bbox work lists, the march axis, the
occupied-slice bounds, the log-LUT, the camera pack and the per-tile CSR
lists with tightened per-item slice bands.  Where the originals call the
native library they call it the same way, so the inputs are byte-identical
to the JAX package's (tests/test_torch_worklist.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import native

LANES = 128
SUBLANES = 8
TILE_P = LANES * SUBLANES  # pixels per 32x32 tile
SLICE_CELLS = LANES * SUBLANES  # max stored cells per brick slice
TILE_W = 32
TILE_H = 32


def project_screen_bboxes(
    box_min: np.ndarray,
    box_max: np.ndarray,
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    logical_width: int,
    logical_height: int,
):
    """Vectorized conservative screen bounding boxes of brick AABBs.

    Returns (lo_x, hi_x, lo_y, hi_y, behind) arrays [B]; ``behind`` marks
    bricks with a corner at/behind the eye plane (treated as full frame).
    """
    box_min = np.asarray(box_min, float)
    box_max = np.asarray(box_max, float)
    num = len(box_min)
    thf = math.tan(fov_y_degrees * 0.5 * math.pi / 180.0)
    aspect = logical_width / max(logical_height, 1)

    # [B, 8, 3] corners
    sel = np.array(
        [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], bool
    )
    corners = np.where(sel[None], box_max[:, None, :], box_min[:, None, :])
    rel = corners - np.asarray(eye)[None, None, :]
    depth = rel @ np.asarray(forward)
    behind = (depth <= 1e-9).any(axis=1)
    safe_depth = np.where(depth > 1e-9, depth, 1.0)
    ndc_x = (rel @ np.asarray(right)) / (safe_depth * thf * aspect)
    ndc_y = (rel @ np.asarray(up)) / (safe_depth * thf)
    sx = (ndc_x * 0.5 + 0.5) * logical_width
    sy = (ndc_y * 0.5 + 0.5) * logical_height
    return (
        sx.min(axis=1), sx.max(axis=1), sy.min(axis=1), sy.max(axis=1), behind
    )


def compute_worklist(
    box_min: np.ndarray,  # [B, 3] world corners (unpermuted)
    box_max: np.ndarray,  # [B, 3]
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    width: int,
    height: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    pad_to: int = 256,
    with_coverage: bool = True,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Screen-bbox tile work list: one (brick, tile) item per 2D tile whose
    pixel block intersects the brick's projected bounding box.

    Conservative: bricks with any corner at or behind the eye plane cover
    the whole frame.  Returns (work_bricks, work_tiles, coverage[B, T]);
    the work list is padded to a multiple of ``pad_to`` by repeating the
    last item (harmless re-render of a covered tile).  The list is built
    directly from each brick's tile rectangle — O(items), never the
    O(bricks x tiles) boolean matrix; ``with_coverage=False`` callers
    (the persistent path, which only needs the CSR list) skip
    materializing ``coverage`` entirely (returned as None).
    """
    tiles_x = width // TILE_W
    tiles_y = height // TILE_H
    num_tiles = tiles_x * tiles_y
    lw = logical_width or width
    lh = logical_height or height
    num_bricks = len(box_min)

    if num_bricks:
        lo_x, hi_x, lo_y, hi_y, behind = project_screen_bboxes(
            box_min, box_max, eye, forward, right, up, fov_y_degrees, lw, lh
        )
        tx0 = np.clip(((lo_x - 1).astype(np.int64)) // TILE_W, 0, tiles_x - 1)
        tx1 = np.clip(((hi_x + 1).astype(np.int64)) // TILE_W, 0, tiles_x - 1)
        ty0 = np.clip(((lo_y - 1).astype(np.int64)) // TILE_H, 0, tiles_y - 1)
        ty1 = np.clip(((hi_y + 1).astype(np.int64)) // TILE_H, 0, tiles_y - 1)
        tx0 = np.where(behind, 0, tx0)
        tx1 = np.where(behind, tiles_x - 1, tx1)
        ty0 = np.where(behind, 0, ty0)
        ty1 = np.where(behind, tiles_y - 1, ty1)
        offscreen = (~behind) & ((hi_x < 0) | (lo_x > lw) | (hi_y < 0) | (lo_y > lh))

        # expand each brick's [tx0, tx1] x [ty0, ty1] tile rect into
        # (brick, tile) items in brick-major, ascending-tile order (the
        # order np.nonzero on the coverage matrix would produce)
        nx = tx1 - tx0 + 1
        cnt = np.where(offscreen, 0, nx * (ty1 - ty0 + 1))
        total = int(cnt.sum())
        wb = np.repeat(np.arange(num_bricks, dtype=np.int64), cnt)
        starts = np.cumsum(cnt) - cnt
        j = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
        nxr = np.repeat(nx, cnt)
        ty = np.repeat(ty0, cnt) + j // nxr
        tx = np.repeat(tx0, cnt) + j % nxr
        wt = ty * tiles_x + tx
    else:
        wb = np.zeros(0, np.int64)
        wt = np.zeros(0, np.int64)

    wb = wb.astype(np.int32)
    wt = wt.astype(np.int32)
    coverage = None
    if with_coverage:
        coverage = np.zeros((num_bricks, num_tiles), dtype=bool)
        coverage[wb, wt] = True
    if len(wb) == 0:
        wb = np.array([0], np.int32)
        wt = np.array([0], np.int32)
        if with_coverage:
            coverage[0 if num_bricks else slice(0, 0), 0] = True

    # pad by repeating the final item so compiled shapes bucket coarsely
    target = ((len(wb) + pad_to - 1) // pad_to) * pad_to
    if target > len(wb):
        pad = target - len(wb)
        wb = np.concatenate([wb, np.full(pad, wb[-1], np.int32)])
        wt = np.concatenate([wt, np.full(pad, wt[-1], np.int32)])
    return wb, wt, coverage


def choose_march_axis(view_dir: np.ndarray) -> int:
    """Dominant world axis of the view direction (global per frame)."""
    return int(np.argmax(np.abs(view_dir)))


def compute_slice_bounds_batch(
    slice_min: np.ndarray,  # [L, S] per-slice minima along the march axis
    slice_max: np.ndarray,  # [L, S] per-slice maxima
    lut_alpha: np.ndarray,  # [size]
    range_min: float,
    inverse_range: float,
    n_slices: np.ndarray,  # [L] actual slice counts (<= S; rest is padding)
) -> np.ndarray:
    """Vectorized ``compute_slice_bounds`` over a piece table.

    Returns packed ``(s_lo << 16) | s_hi`` int32 [L] for ``dims[:, 7]``.
    Slices at or past ``n_slices`` are padding and never count as occupied.
    """
    num, cap = slice_min.shape
    nz = np.asarray(lut_alpha) > 0.0
    table_max = len(nz) - 1  # table size follows the LUT argument
    prefix = np.concatenate([[0], np.cumsum(nz)])
    n0 = np.clip((slice_min - range_min) * inverse_range, 0.0, 1.0)
    n1 = np.clip((slice_max - range_min) * inverse_range, 0.0, 1.0)
    i0 = np.clip((n0 * table_max).astype(np.int64), 0, table_max)
    i1 = np.clip((n1 * table_max).astype(np.int64), 0, table_max)
    occupied = (prefix[i1 + 1] - prefix[i0]) > 0
    occupied &= np.arange(cap)[None, :] < np.asarray(n_slices)[:, None]
    any_occ = occupied.any(axis=1)
    s_lo = np.argmax(occupied, axis=1)
    s_hi = cap - np.argmax(occupied[:, ::-1], axis=1)
    ns = np.asarray(n_slices, np.int64)
    packed = np.where(any_occ, (s_lo << 16) | s_hi, (ns << 16) | ns)
    return packed.astype(np.int32)


def build_log_lut(color_table: np.ndarray) -> np.ndarray:
    """Convert an (S, 4) rgba LUT (alpha at the reference step, i.e.
    normalization factor 1) into the kernel's [4, S // 128, 128] layout with
    channel 3 = log(1 - alpha).  S must be a positive multiple of 128
    (256 = the reference table; 128 = the half-resolution fast mode)."""
    size = color_table.shape[0]
    if size <= 0 or size % LANES != 0:
        raise ValueError(
            f"LUT size must be a positive multiple of {LANES}, got {size}"
        )
    rgb = color_table[:, :3]
    alpha = np.clip(color_table[:, 3], 0.0, 1.0)
    with np.errstate(divide="ignore"):
        log_term = np.log1p(-alpha)  # -inf at alpha == 1 (=> opaque)
    packed = np.stack(
        [rgb[:, 0], rgb[:, 1], rgb[:, 2], log_term], axis=0
    ).astype(np.float32)
    return packed.reshape(4, size // LANES, LANES)


def pack_camera(
    eye, forward, right, up, fov_y_degrees, aspect, range_min, inverse_range,
    ref_distance,
) -> np.ndarray:
    cam = np.zeros(20, dtype=np.float32)
    cam[0:3] = eye
    cam[3:6] = forward
    cam[6:9] = right
    cam[9:12] = up
    cam[12] = math.tan(fov_y_degrees * 0.5 * math.pi / 180.0)
    cam[13] = aspect
    cam[14] = range_min
    cam[15] = inverse_range
    cam[16] = ref_distance
    return cam


def block_occupancy_bits(
    quad_min: np.ndarray,  # [L, S, Q, Q] per-slice block minima
    quad_max: np.ndarray,  # [L, S, Q, Q] per-slice block maxima
    lut_alpha: np.ndarray,  # [size]
    range_min: float,
    inverse_range: float,
) -> np.ndarray:
    """[L, S] uint64 bitmask: bit (qu * Q + qv) set when block (qu, qv) of
    the slice can map to nonzero alpha under the current transfer function.
    Depends only on (piece table, LUT) — cache per (axis, LUT), NOT per
    frame (compute_item_slice_bounds consumes it every frame)."""
    if quad_min.shape[2] > 8 or quad_min.shape[3] > 8:
        # the packed masks are uint64: nq > 8 would silently drop high
        # bits and non-conservatively skip occupied slices
        raise ValueError("block occupancy masks support at most 8x8 blocks")
    native_out = native.block_occupancy_bits(
        quad_min, quad_max, lut_alpha, range_min, inverse_range
    )
    if native_out is not None:
        return native_out
    nz = np.asarray(lut_alpha) > 0.0
    table_max = len(nz) - 1  # table size follows the LUT argument
    prefix = np.concatenate([[0], np.cumsum(nz)])
    n0 = np.clip((quad_min - range_min) * inverse_range, 0.0, 1.0)
    n1 = np.clip((quad_max - range_min) * inverse_range, 0.0, 1.0)
    i0 = np.clip((n0 * table_max).astype(np.int64), 0, table_max)
    i1 = np.clip((n1 * table_max).astype(np.int64), 0, table_max)
    occ = (prefix[i1 + 1] - prefix[i0]) > 0  # [L, S, Q, Q]
    num, cap, nq, _ = occ.shape
    bit = (np.arange(nq)[:, None] * nq + np.arange(nq)[None, :]).astype(
        np.uint64
    )
    return (
        occ.astype(np.uint64) << bit[None, None]
    ).reshape(num, cap, nq * nq).sum(axis=2, dtype=np.uint64)


def compute_item_slice_bounds(
    meta: np.ndarray,  # [L, 12] f32 permuted pmin/pmax/cell (march axis 1st)
    brick_bounds: np.ndarray,  # [L] i32 per-brick packed (lo<<16)|hi
    wt: np.ndarray,  # [W] tile index per work item
    wb: np.ndarray,  # [W] brick index per work item
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    axes: Sequence[int],  # march-axis permutation (dims[:, 3:6])
    width: int,
    height: int,
    logical_width: int,
    logical_height: int,
    occ_bits: np.ndarray,  # [L, S] uint64 from block_occupancy_bits
    nq: int,  # blocks per axis (Q)
    split,  # stored-coordinate block edge stride (stored_u_extent / Q);
    #         scalar (uniform pieces, the canonical-cube path) or [L]
    split_v=None,  # v-axis stride when it differs from ``split`` ([L] or
    #                scalar; defaults to ``split``)
    ghost: int = 0,
    return_mask: bool = False,
    seg_len: int = 4,
    margin: Optional[float] = None,
) -> np.ndarray:
    """Per-(tile, brick) occupied-slice bounds: tighten each work item's
    march range to the slices whose values can be non-transparent WITHIN
    the tile's footprint on the brick.

    The per-brick range (slicemarch.compute_slice_bounds) is global over
    the whole slice, so a thin curved feature (a shell, a front) occupies
    some (u, v) of nearly every slice and defeats range skipping; per-tile
    footprints restore the sparsity.  Conservative by construction:

      * a ray's in-plane position at slice z is ``eye_u + (z-eye_a) *
        d_u/d_a`` — LINEAR in z, and a Mobius function of the pixel
        coordinates (monotone in each while ``d_a`` keeps one sign across
        the tile), so the 4 corner rays evaluated at slice-SEGMENT
        boundary planes bound each segment's footprint exactly; sign
        changes / behind-eye planes fall back to the brick bounds;
      * slices are grouped into segments of ``seg_len`` so oblique rays'
        transverse drift (up to one cell per slice at 45 degrees) widens
        only the segment's footprint, not the whole brick's (hull over
        the two endpoint planes bounds every interior slice exactly —
        u(z) is linear along each ray — so finer segments only tighten);
      * the footprint hull is padded by ``margin`` cells.  The default
        ``ghost + 2`` is safe for every sampling mode; the exact
        requirement is the sampling stencil's reach from the continuous
        cell coordinate ``cu``: nearest touches floor(cu) in (cu-1, cu],
        trilinear/pre touch floor(cu-0.5)+{0,1} in (cu-1.5, cu+0.5] —
        ``footprint_margin`` returns the tight value per mode;
      * occupancy is tested per stored-(u, v) BLOCK of each slice
        (Q x Q equal blocks of edge ``split``; extrema include slice
        padding zeros, widening ranges only).

    Returns [W] i32 packed ``(s_lo << 16) | s_hi``; items whose footprint
    maths cannot be trusted keep their brick's bounds.  (Beyond reference:
    the reference marches every step of every box, VolumePainter.cpp:
    837-900.)"""
    if nq > 8:
        raise ValueError("block occupancy masks support at most 8x8 blocks")
    if seg_len < 1:
        raise ValueError("seg_len must be >= 1")
    wb = np.asarray(wb, np.int64)
    wt = np.asarray(wt, np.int64)
    bb = np.asarray(brick_bounds, np.int64)[wb]
    blo = bb >> 16
    bhi = bb & 0xFFFF

    tiles_x = width // TILE_W
    tx = wt % tiles_x
    ty = wt // tiles_x
    # extreme pixel centers of the tile (the kernel samples px + 0.5)
    px = np.stack([tx * TILE_W + 0.5, tx * TILE_W + TILE_W - 0.5], -1)
    py = np.stack([ty * TILE_H + 0.5, ty * TILE_H + TILE_H - 0.5], -1)
    tan_half = math.tan(math.radians(fov_y_degrees) * 0.5)
    aspect = logical_width / max(logical_height, 1)
    plane_x = (px * (2.0 / logical_width) - 1.0) * tan_half * aspect
    plane_y = (py * (2.0 / logical_height) - 1.0) * tan_half
    # 4 corner rays, world dirs (unnormalized — ratios cancel below)
    cx = plane_x[:, [0, 0, 1, 1]]
    cy = plane_y[:, [0, 1, 0, 1]]
    dirs = (
        np.asarray(forward, np.float64)[None, None, :]
        + cx[:, :, None] * np.asarray(right, np.float64)
        + cy[:, :, None] * np.asarray(up, np.float64)
    )  # [W, 4, 3]
    axes = list(axes)
    dp = dirs[:, :, axes]
    eye_p = np.asarray(eye, np.float64)[axes]
    pmin = np.asarray(meta, np.float64)[wb][:, 0:3]
    cell = np.asarray(meta, np.float64)[wb][:, 6:9]

    d_a = dp[:, :, 0]
    sign_ok = (np.abs(d_a) > 1e-8).all(1) & (
        (d_a > 0).all(1) | (d_a < 0).all(1)
    )
    cap = occ_bits.shape[1]
    n_seg = (cap + seg_len - 1) // seg_len
    # segment boundary slice centers: 0, L, 2L, ..., then cap-1
    ks = np.minimum(np.arange(n_seg + 1) * seg_len, cap - 1)  # [G+1]
    z = pmin[:, 0:1] + (ks[None, :] + 0.5) * cell[:, 0:1]  # [W, G+1]
    with np.errstate(divide="ignore", invalid="ignore"):
        # reciprocal form, matching the native C++ pass bit-for-bit
        # (avr_native.cpp item_bands_range hoists these loop-invariant
        # divisions out of its per-segment loop)
        inv_da = 1.0 / d_a  # [W, 4]
        t = (z[:, None, :] - eye_p[0]) * inv_da[:, :, None]  # [W, 4, G+1]
        ok = sign_ok & (t > 0).all(axis=(1, 2))
        u_pts = eye_p[1] + t * dp[:, :, 1:2]  # [W, 4, G+1]
        v_pts = eye_p[2] + t * dp[:, :, 2:3]
        cu = (u_pts - pmin[:, 1:2, None]) * (1.0 / cell[:, 1:2, None]) + ghost
        cv = (v_pts - pmin[:, 2:3, None]) * (1.0 / cell[:, 2:3, None]) + ghost
    if margin is None:
        margin = ghost + 2.0
    # segment g's footprint = hull of the 4 corners at boundaries g, g+1
    # (reduce over corners first, then over the two endpoints)
    cu_min = cu.min(axis=1)  # [W, G+1]
    cu_max = cu.max(axis=1)
    cv_min = cv.min(axis=1)
    cv_max = cv.max(axis=1)
    cu_lo = np.minimum(cu_min[:, :-1], cu_min[:, 1:]) - margin  # [W, G]
    cu_hi = np.maximum(cu_max[:, :-1], cu_max[:, 1:]) + margin
    cv_lo = np.minimum(cv_min[:, :-1], cv_min[:, 1:]) - margin
    cv_hi = np.maximum(cv_max[:, :-1], cv_max[:, 1:]) + margin
    # block q covers stored [q*split, (q+1)*split); splits may vary per
    # piece (work-list path) — broadcast [W, 1, Q] against [W, G, 1]
    if split_v is None:
        split_v = split
    su = (np.asarray(split)[wb] if np.ndim(split) else
          np.float64(split))
    sv = (np.asarray(split_v)[wb] if np.ndim(split_v) else
          np.float64(split_v))
    qrange = np.arange(nq)
    eu_lo = (np.multiply.outer(su, qrange))[:, None, :] \
        if np.ndim(su) else (su * qrange)[None, None, :]
    ev_lo = (np.multiply.outer(sv, qrange))[:, None, :] \
        if np.ndim(sv) else (sv * qrange)[None, None, :]
    eu_hi = eu_lo + (su[:, None, None] if np.ndim(su) else su)
    ev_hi = ev_lo + (sv[:, None, None] if np.ndim(sv) else sv)
    qu = (cu_lo[..., None] < eu_hi) & (cu_hi[..., None] > eu_lo)
    qv = (cv_lo[..., None] < ev_hi) & (cv_hi[..., None] > ev_lo)
    # footprint bitmask per segment: bit (a*Q+b) = u-block a AND v-block b
    shift_u = (np.arange(nq, dtype=np.uint64) * np.uint64(nq))
    fu = (qu.astype(np.uint64) << shift_u).sum(axis=2, dtype=np.uint64)
    fv = (qv.astype(np.uint64) << np.arange(nq, dtype=np.uint64)).sum(
        axis=2, dtype=np.uint64
    )
    # (Σ_a qu_a 2^(aQ)) * (Σ_b qv_b 2^b) = Σ_{a,b} qu_a qv_b 2^(aQ+b):
    # the products never carry because each partial bit is distinct
    fmask = fu * fv  # [W, G] uint64
    # expand to per-slice and AND against the cached block occupancy
    seg_of_slice = np.minimum(np.arange(cap) // seg_len, n_seg - 1)
    sel = (fmask[:, seg_of_slice] & occ_bits[wb]) != 0  # [W, S]
    cap = sel.shape[1]
    s_idx = np.arange(cap)[None, :]
    sel &= (s_idx >= blo[:, None]) & (s_idx < bhi[:, None])
    any_occ = sel.any(1)
    lo = np.argmax(sel, 1)
    hi = cap - np.argmax(sel[:, ::-1], 1)
    packed = np.where(any_occ, (lo << 16) | hi, (bhi << 16) | bhi)
    out = np.where(ok & (bhi > blo), packed, bb)
    if return_mask:
        # diagnostics/band splitting: the per-slice occupancy before range
        # collapse, the trust flag, and the tile's march direction
        # (d_a > 0 for all corners; only meaningful where ok)
        forward = (d_a > 0).all(1)
        return out.astype(np.int32), sel, ok, forward
    return out.astype(np.int32)


def footprint_margin(ghost: int, sampling: str) -> float:
    """Tight conservative footprint pad (cells) for a sampling mode.

    The per-item bounds hull the tile's corner rays in continuous cell
    coordinates ``cu``; the pad must cover every CELL INDEX the kernel's
    stencil can touch from a position inside the hull:

      * nearest: index = floor(cu) in (cu - 1, cu]  -> pad 1
      * trilinear / pre-classified: stored indices floor(cu - 0.5) + {0, 1}
        in (cu - 1.5, cu + 0.5]  -> pad 1.5

    plus 0.01 cells of slack for the f32-kernel vs f64-host position
    rounding (the kernel's positions differ from the host hull by at most
    a few ULPs of the cell coordinate, orders of magnitude below 0.01;
    grazing rays with large amplification have correspondingly huge hulls
    that swallow the slack).  Measured on the bench thin shell this pad
    (vs the legacy ghost + 2) cuts marched slice-iterations ~12%
    (scripts/bounds_variant_sweep.py)."""
    return ghost + (1.01 if sampling == "nearest" else 1.51)


def find_second_bands(
    sel: np.ndarray,  # [W, S] per-slice occupancy (compute_item_slice_bounds)
    item_bounds: np.ndarray,  # [W] packed (lo<<16)|hi (tightened)
    ok: np.ndarray,  # [W] footprint maths trusted (incl. uniform d_a sign)
    min_gap: int = 6,
) -> Tuple[np.ndarray, np.ndarray]:
    """Locate each item's largest internal empty gap (vectorized).

    Returns (band1, band2), both [W] i32 packed ``(lo<<16)|hi``: where a
    gap of >= ``min_gap`` empty slices splits the occupied range, band1 /
    band2 are the two covering sub-ranges in slice order; elsewhere band1
    is the input bounds and band2 is 0 (unsplit)."""
    ib = np.asarray(item_bounds).astype(np.int64)
    lo = ib >> 16
    hi = ib & 0xFFFF
    W, S = np.asarray(sel).shape
    s_idx = np.arange(S, dtype=np.int64)[None, :]
    occ = np.asarray(sel) & (s_idx >= lo[:, None]) & (s_idx < hi[:, None])
    # prev_occ[j] = index of the last occupied slice STRICTLY before j
    prev = np.maximum.accumulate(np.where(occ, s_idx, -1), axis=1)
    prev_sh = np.concatenate(
        [np.full((W, 1), -1, np.int64), prev[:, :-1]], axis=1
    )
    # gap ending at occupied slice j = run of empties since the previous
    # occupied slice; -1 where not an (internal) gap end
    gap = np.where(occ & (prev_sh >= 0), s_idx - prev_sh - 1, -1)
    rows = np.arange(W)
    g_end = gap.argmax(axis=1)  # first maximal gap's closing occupied slice
    g_len = gap[rows, g_end]
    g_prev = prev_sh[rows, g_end]  # occupied slice opening the gap
    split = np.asarray(ok, bool) & (g_len >= min_gap) & (hi > lo)
    band1 = np.where(split, (lo << 16) | (g_prev + 1), ib)
    band2 = np.where(split, (g_end << 16) | hi, 0)
    return band1.astype(np.int32), band2.astype(np.int32)


def expand_bands(
    wt: np.ndarray,  # [W] tile per item (tile-sorted CSR order)
    wb: np.ndarray,  # [W] brick per item
    owners: np.ndarray,  # [W] run key per item
    band1: np.ndarray,  # [W] packed first band (== bounds when unsplit)
    band2: np.ndarray,  # [W] packed second band, 0 = unsplit
    forward: np.ndarray,  # [W] tile march direction (d_a > 0)
):
    """Expand split items into TWO adjacent work items.

    A chord through a hollow feature (a shell, a bubble wall) enters and
    exits the occupied region with an empty middle; the contiguous
    [lo, hi) range marches the gap for nothing.  Split items emit their
    two bands ordered in the tile's MARCH direction so the kernel's run
    blend (depth tie -> earlier item stays in front) composites them
    front-to-back for every ray in the tile — valid exactly where the
    footprint maths is trusted (compute_item_bands only emits band2 where
    ``ok``, which requires a uniform d_a sign across the tile's corner
    rays).  Conservative: the two bands cover every occupied slice.

    Returns (wt, wb, owners, item_bounds) with split items expanded in
    place (CSR tile order preserved).  Beyond reference: the reference
    marches every step of every box (VolumePainter.cpp:837-900)."""
    wt = np.asarray(wt)
    band1 = np.asarray(band1, np.int32)
    band2 = np.asarray(band2, np.int32)
    has2 = band2 != 0
    if not has2.any():
        return wt, np.asarray(wb), np.asarray(owners), band1
    fwd = np.asarray(forward, bool)
    first = np.where(has2 & ~fwd, band2, band1)
    second = np.where(fwd, band2, band1)
    reps = np.where(has2, 2, 1).astype(np.int64)
    wt2 = np.repeat(wt, reps)
    wb2 = np.repeat(np.asarray(wb), reps)
    ow2 = np.repeat(np.asarray(owners), reps)
    ib2 = np.repeat(first, reps)
    starts = np.cumsum(reps) - 1  # row of each item's LAST emitted slot
    ib2[starts[has2]] = second[has2]
    return wt2, wb2, ow2, ib2


def compute_item_bands(
    meta, brick_bounds, wt, wb, eye, forward, right, up, fov_y_degrees,
    axes, width, height, logical_width, logical_height,
    occ_bits, nq, split, split_v=None, ghost: int = 0, min_gap: int = 6,
    seg_len: int = 4, margin: Optional[float] = None,
):
    """Per-item occupied-slice bounds + second-band split, native-first.

    Same geometry contract as ``compute_item_slice_bounds`` (the NumPy
    oracle); returns (band1, band2, march_forward) for ``expand_bands``.
    The native path (native.item_bands, avr_native.cpp) fuses the
    footprint maths, occupancy AND, and gap scan into one C++ pass —
    this is per-frame host work on the product path, so it follows the
    reference's native-host-layer design (SceneBuilder.cpp:113-189).

    ``seg_len``/``margin`` tune the footprint granularity/pad (see
    ``compute_item_slice_bounds``; ``footprint_margin`` gives the tight
    pad per sampling mode)."""
    res = native.item_bands(
        meta, brick_bounds, wt, wb, eye, forward, right, up,
        fov_y_degrees, axes, width, logical_width, logical_height,
        occ_bits, nq, split, split_v, ghost, min_gap,
        seg_len=seg_len, margin=margin,
    )
    if res is not None:
        return res
    bounds, sel, ok, fwd = compute_item_slice_bounds(
        meta, brick_bounds, wt, wb, eye, forward, right, up,
        fov_y_degrees, axes, width, height, logical_width, logical_height,
        occ_bits, nq, split, split_v, ghost=ghost, return_mask=True,
        seg_len=seg_len, margin=margin,
    )
    band1, band2 = find_second_bands(sel, bounds, ok, min_gap=min_gap)
    return band1, band2, fwd


def build_tile_worklist(
    box_min: np.ndarray,
    box_max: np.ndarray,
    depth_hints: np.ndarray,
    owners: np.ndarray,
    eye: np.ndarray,
    forward: np.ndarray,
    right: np.ndarray,
    up: np.ndarray,
    fov_y_degrees: float,
    width: int,
    height: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR per-tile brick lists, front-to-back by (hint, owner, index).

    Returns (offsets [T+1], bricks [W], work_owners [W])."""
    owners = np.asarray(owners)
    if len(owners) and (owners.min() < 0 or owners.max() > 0x7FFF):
        # the kernel's packed work table carries the owner in the high 16
        # bits and compares runs via an arithmetic shift: ids outside
        # int16 would alias modulo 65536 and silently merge per-owner
        # runs (wrong compositing order) — enforce the assumption here,
        # the single host choke point where user-supplied owner/rank ids
        # enter the work list
        raise ValueError(
            f"owner ids must be in [0, 32767] for the packed work table "
            f"(got range [{owners.min()}, {owners.max()}])"
        )
    wb, wt, _ = compute_worklist(
        box_min, box_max, eye, forward, right, up, fov_y_degrees,
        width, height, logical_width=logical_width,
        logical_height=logical_height, pad_to=1, with_coverage=False,
    )
    num_tiles = (width // TILE_W) * (height // TILE_H)
    # order per tile by (hint, owner, brick index)
    order = np.lexsort((wb, owners[wb], depth_hints[wb], wt))
    wt_sorted = wt[order]
    wb_sorted = wb[order]
    counts = np.bincount(wt_sorted, minlength=num_tiles)
    offsets = np.zeros(num_tiles + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return (
        offsets,
        wb_sorted.astype(np.int32),
        owners[wb_sorted].astype(np.int32),
    )
