"""Slice-march render: one layer per piece, over a (piece, tile) work list
or densely over every (piece, tile) pair.

The port of the JAX package's ``ops/slicemarch.py`` kernels and the host
helpers the one-shot route needs.  Each work item ``w`` marches
piece ``work_bricks[w]`` over the 32x32 pixel tile ``work_tiles[w]`` and
writes that piece's colour and entry depth for the tile, so the outputs are
per-piece layers in tile order: ``[B, T, 4, 8, 128]`` colour and
``[B, T, 8, 128]`` depth.  Blocks that no item writes are undefined.

``slicemarch_render_worklist_raw`` is the entry the composited frame
calls; ``slicemarch_render_worklist`` masks by coverage and untiles to
row-major ``[B, H*W, 4]`` / ``[B, H*W]`` (the layered path).
``slicemarch_render``, the dense entry the multi-device pipelines run on
each shard, runs the same kernel over the full list of (piece, tile)
pairs (``dense_worklist``), each piece within its band ``dims[b, 7]``, and
returns the same row-major layers with every block defined.  On a CUDA
tensor the entries launch the hand-written kernel (``csrc/slicemarch.cu``);
on a CPU tensor they run ``slicemarch_reference``, the same function in
plain PyTorch.
Rounding follows the JAX kernel as XLA compiles it for the CPU in
interpret mode with the rolled march loop (``numerics``); the TPU's
``unroll`` tree combine is a latency device that the port leaves out.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .march import check_args, f32, march_pieces, require, seed_table, tile_rays
from .worklist import LANES, SLICE_CELLS, SUBLANES, TILE_H, TILE_W

Tensor = torch.Tensor


def split_brick_for_slices(
    data: np.ndarray, min_corner: np.ndarray, max_corner: np.ndarray,
    axis: int, ghost: int = 0, padded: Optional[np.ndarray] = None,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Split a brick along the non-march axes until a slice fits 1024
    cells.

    Returns [(data, min_corner, max_corner), ...].  With ``ghost == 0``
    pieces are views into the original array.  With ``ghost > 0`` each
    returned array carries a ``ghost``-cell ring on every axis (neighbour
    data of the same brick at split boundaries, ``padded``'s ring or edge
    replication at true brick faces) while the corners bound the core."""
    axes = [axis] + [a for a in range(3) if a != axis]
    nu_axis, nv_axis = axes[1], axes[2]
    shape = np.asarray(data.shape, int)
    mn0 = np.asarray(min_corner, float)
    mx0 = np.asarray(max_corner, float)
    spans = np.where(shape > 0, (mx0 - mn0) / np.maximum(shape, 1), 1.0)
    boxes = [(np.zeros(3, int), shape.copy())]  # core cell-index ranges
    # split the larger transverse axis in half until the (ghosted) slice fits
    while True:
        next_boxes = []
        done = True
        for lo, hi in boxes:
            nu = hi[nu_axis] - lo[nu_axis]
            nv = hi[nv_axis] - lo[nv_axis]
            if (nu + 2 * ghost) * (nv + 2 * ghost) <= SLICE_CELLS:
                next_boxes.append((lo, hi))
                continue
            done = False
            split_axis = nu_axis if nu >= nv else nv_axis
            mid = lo[split_axis] + (hi[split_axis] - lo[split_axis]) // 2
            hi_lo, lo_hi = hi.copy(), lo.copy()
            hi_lo[split_axis] = mid
            lo_hi[split_axis] = mid
            next_boxes.append((lo, hi_lo))
            next_boxes.append((lo_hi, hi))
        boxes = next_boxes
        if done:
            break
    if padded is None:
        padded = np.pad(data, ghost, mode="edge") if ghost else data
    else:
        assert ghost and padded.shape == tuple(shape + 2 * ghost)
    pieces = []
    for lo, hi in boxes:
        mn = mn0 + lo * spans
        mx = mn0 + hi * spans
        # core cell i sits at padded index i + ghost
        block = padded[
            lo[0]: hi[0] + 2 * ghost,
            lo[1]: hi[1] + 2 * ghost,
            lo[2]: hi[2] + 2 * ghost,
        ]
        pieces.append((block, mn, mx))
    return pieces


def pack_slice_volume(
    data: np.ndarray, axis: int, ghost: int = 0
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Permute so the march axis is first and flatten each slice into an
    [8, 128] block (row-major over (u, v), zero padded).  Returns the
    packed [S, 8, 128] array and the CORE slice/row/column counts; the
    stored row stride is nv + 2 * ghost."""
    axes = [axis] + [a for a in range(3) if a != axis]
    vol = np.transpose(np.asarray(data, np.float32), axes)
    ns_st, nu_st, nv_st = vol.shape
    assert nu_st * nv_st <= SLICE_CELLS, (nu_st, nv_st)
    flat = np.zeros((ns_st, SLICE_CELLS), dtype=np.float32)
    flat[:, : nu_st * nv_st] = vol.reshape(ns_st, nu_st * nv_st)
    core = (ns_st - 2 * ghost, nu_st - 2 * ghost, nv_st - 2 * ghost)
    return flat.reshape(ns_st, SUBLANES, LANES), core


def compute_slice_bounds(
    vol: np.ndarray,  # [ns, 8, 128] packed slices (padding zeros ok)
    lut_alpha: np.ndarray,  # [size] transfer-function alpha
    range_min: float = 0.0,
    inverse_range: float = 1.0,
) -> int:
    """The occupied slice range of a packed piece, ``(s_lo << 16) | s_hi``:
    slices whose value range maps to some LUT entry with nonzero alpha
    (padding zeros widen the range, never shrink it).  An all-transparent
    piece gives ``(ns << 16) | ns``, a zero-trip march."""
    ns = vol.shape[0]
    nz = np.asarray(lut_alpha) > 0.0
    table_max = len(nz) - 1
    prefix = np.concatenate([[0], np.cumsum(nz)])
    flat = vol.reshape(ns, -1)
    n0 = np.clip((flat.min(axis=1) - range_min) * inverse_range, 0.0, 1.0)
    n1 = np.clip((flat.max(axis=1) - range_min) * inverse_range, 0.0, 1.0)
    i0 = np.clip((n0 * table_max).astype(np.int64), 0, table_max)
    i1 = np.clip((n1 * table_max).astype(np.int64), 0, table_max)
    occupied = (prefix[i1 + 1] - prefix[i0]) > 0
    if not occupied.any():
        return int((ns << 16) | ns)
    s_lo = int(np.argmax(occupied))
    s_hi = ns - int(np.argmax(occupied[::-1]))
    return int((s_lo << 16) | s_hi)


def untile(colors: Tensor, depths: Tensor, width: int, height: int,
           tile_w: int = TILE_W, tile_h: int = TILE_H) -> Tuple[Tensor, Tensor]:
    """[B, T, 4, 8, 128] / [B, T, 8, 128] tile buffers -> row-major
    [B, H*W, 4] / [B, H*W]."""
    num = colors.shape[0]
    tiles_x = width // tile_w
    tiles_y = height // tile_h
    c = colors.reshape(num, tiles_y, tiles_x, 4, tile_h, tile_w)
    c = c.permute(0, 1, 4, 2, 5, 3).reshape(num, height * width, 4)
    d = depths.reshape(num, tiles_y, tiles_x, tile_h, tile_w)
    d = d.permute(0, 1, 3, 2, 4).reshape(num, height * width)
    return c, d


def slicemarch_reference(
    vol: Tensor,  # [B, S, 8, 128] f32 packed slices
    meta: Tensor,  # [B, 12] f32 pmin(3) pmax(3) cell(3) pad(3), permuted
    dims: Tensor,  # [B, 8] i32 n_slices nu nv perm(3) nv_stride bounds
    lut: Tensor,  # [B, 4, size // 128, 128] f32 per-piece log-LUT
    cam: Tensor,  # [20] f32 camera pack (worklist.pack_camera)
    work_bricks: Tensor,  # [W] i32 piece per work item
    work_tiles: Tensor,  # [W] i32 frame tile per work item
    work_bounds: Optional[Tensor] = None,  # [W] i32 (lo<<16)|hi, 0 = full
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    sampling: str = "nearest",
    ghost: int = 0,
    classification: str = "post",
) -> Tuple[Tensor, Tensor]:
    """The work-list slice-march kernel in plain PyTorch, vectorised over
    work items x 1024 pixels; the Python loop runs over the slices of the
    longest item, folding samples strictly in order.  Returns
    ``([B, T, 4, 8, 128], [B, T, 8, 128])``; unscheduled blocks are
    undefined (``torch.empty``)."""
    check_args(width, height, sampling, classification)
    dev = vol.device
    num_bricks = vol.shape[0]
    num_tiles = (width // TILE_W) * (height // TILE_H)
    if work_bounds is None:
        work_bounds = dims[work_bricks.long(), 7]
    colors = torch.empty((num_bricks, num_tiles, 4, SUBLANES, LANES),
                         dtype=torch.float32, device=dev)
    depths = torch.empty((num_bricks, num_tiles, SUBLANES, LANES),
                         dtype=torch.float32, device=dev)
    items = work_bricks.shape[0]
    if items == 0:
        return colors, depths
    dirs, fwd_dot = tile_rays(work_tiles, cam, width, logical_width or width,
                              logical_height or height)
    c, d = march_pieces(
        vol, meta, dims, lut.reshape(num_bricks, 4, -1), work_bricks, cam,
        work_bricks, work_bounds, dirs, fwd_dot, max_slices=max_slices,
        sampling=sampling, ghost=ghost, classification=classification,
        rolled=True,
    )
    b, t = work_bricks.long(), work_tiles.long()
    colors[b, t] = torch.stack(c, dim=1).reshape(items, 4, SUBLANES, LANES)
    depths[b, t] = d.reshape(items, SUBLANES, LANES)
    return colors, depths


def _check_tables(vol, meta, dims, lut, cam, max_slices) -> None:
    """Raise unless the piece tables are what the CUDA kernels take."""
    dev, i32, f32_ = vol.device, torch.int32, torch.float32
    num_bricks, stored = vol.shape[0], vol.shape[1]
    require(vol, "vol", f32_, (num_bricks, stored, SUBLANES, LANES), dev)
    require(meta, "meta", f32_, (num_bricks, 12), dev)
    require(dims, "dims", i32, (num_bricks, 8), dev)
    if lut.dim() != 4 or lut.shape[:2] != (num_bricks, 4) or lut.shape[3] != LANES:
        raise ValueError(
            f"lut has shape {tuple(lut.shape)}, expected [{num_bricks}, 4, n, 128]"
        )
    require(lut, "lut", f32_, tuple(lut.shape), dev)
    require(cam, "cam", f32_, (20,), dev)
    if not 0 < max_slices <= stored:
        raise ValueError(f"max_slices {max_slices} outside (0, {stored}]")


def _launch(vol, meta, dims, lut, cam, work_bricks, work_tiles, work_bounds,
            *, width, height, max_slices, logical_width, logical_height,
            sampling, ghost, classification) -> Tuple[Tensor, Tensor, bool]:
    """Launch ``csrc/slicemarch.cu`` on the current stream over a work
    list of CUDA tensors (a failed build or launch raises); returns the
    tile-ordered layers and whether a kernel was launched."""
    if vol.device.type != "cuda":
        raise ValueError(f"slicemarch has no kernel for {vol.device}")
    check_args(width, height, sampling, classification)
    if work_bounds is None:
        work_bounds = dims[work_bricks.long(), 7].contiguous()
    dev = vol.device
    i32, f32_ = torch.int32, torch.float32
    num_bricks, stored = vol.shape[0], vol.shape[1]
    items = work_bricks.shape[0]
    num_tiles = (width // TILE_W) * (height // TILE_H)
    _check_tables(vol, meta, dims, lut, cam, max_slices)
    require(work_bricks, "work_bricks", i32, (items,), dev)
    require(work_tiles, "work_tiles", i32, (items,), dev)
    require(work_bounds, "work_bounds", i32, (items,), dev)

    colors = torch.empty((num_bricks, num_tiles, 4, SUBLANES, LANES),
                         dtype=f32_, device=dev)
    depths = torch.empty((num_bricks, num_tiles, SUBLANES, LANES),
                         dtype=f32_, device=dev)
    if items == 0:
        return colors, depths, False
    from . import _build

    lib = _build.load("slicemarch")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.avr_slicemarch_launch(
        vol.data_ptr(), meta.data_ptr(), dims.data_ptr(), lut.data_ptr(),
        cam.data_ptr(), work_bricks.data_ptr(), work_tiles.data_ptr(),
        work_bounds.data_ptr(), seed_table(dev).data_ptr(),
        colors.data_ptr(), depths.data_ptr(),
        items, num_tiles, stored, lut.shape[2] * LANES, width // TILE_W,
        max_slices, ghost, f32(2.0 / (logical_width or width)),
        f32(2.0 / (logical_height or height)),
        int(sampling == "trilinear"), int(classification == "pre"), stream,
    )
    if rc != 0:
        raise RuntimeError(f"slicemarch kernel launch failed: CUDA error {rc}")
    return colors, depths, True


def slicemarch_render_worklist_raw(
    vol: Tensor,
    meta: Tensor,
    dims: Tensor,
    lut: Tensor,
    cam: Tensor,
    work_bricks: Tensor,
    work_tiles: Tensor,
    work_bounds: Optional[Tensor] = None,
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    sampling: str = "nearest",
    ghost: int = 0,
    classification: str = "post",
) -> Tuple[Tensor, Tensor]:
    """Tile-ordered, unmasked per-piece layers; arguments as
    ``slicemarch_reference``.

    A CUDA ``vol`` launches the CUDA kernel on the current stream (a failed
    build or launch raises); a CPU ``vol`` runs the plain version.
    ``slicemarch_render_worklist_raw.launches`` counts kernel launches."""
    kw = dict(
        width=width, height=height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification,
    )
    args = (vol, meta, dims, lut, cam, work_bricks, work_tiles, work_bounds)
    if vol.device.type == "cpu":
        return slicemarch_reference(*args, **kw)
    colors, depths, launched = _launch(*args, **kw)
    slicemarch_render_worklist_raw.launches += int(launched)
    return colors, depths


slicemarch_render_worklist_raw.launches = 0


def dense_worklist(num_bricks: int, num_tiles: int,
                   device) -> Tuple[Tensor, Tensor]:
    """Every (piece, tile) pair, piece-major: ``(work_bricks,
    work_tiles)`` of the dense render, which so names every block."""
    bricks = torch.arange(num_bricks, dtype=torch.int32, device=device)
    tiles = torch.arange(num_tiles, dtype=torch.int32, device=device)
    return bricks.repeat_interleave(num_tiles), tiles.repeat(num_bricks)


def slicemarch_dense_reference(
    vol: Tensor, meta: Tensor, dims: Tensor, lut: Tensor, cam: Tensor, **kw,
) -> Tuple[Tensor, Tensor]:
    """The dense render's plain version: ``slicemarch_reference`` over
    ``dense_worklist``, every piece within its band ``dims[b, 7]``.
    Returns tile-ordered ``([B, T, 4, 8, 128], [B, T, 8, 128])`` with every
    block defined (a tile the piece misses is colour 0, depth +inf)."""
    num_tiles = (kw["width"] // TILE_W) * (kw["height"] // TILE_H)
    return slicemarch_reference(
        vol, meta, dims, lut, cam,
        *dense_worklist(vol.shape[0], num_tiles, vol.device), **kw)


def slicemarch_render(
    vol: Tensor,
    meta: Tensor,
    dims: Tensor,
    lut: Tensor,
    cam: Tensor,
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    sampling: str = "nearest",
    ghost: int = 0,
    classification: str = "post",
) -> Tuple[Tensor, Tensor]:
    """Dense render, every piece against every tile: row-major
    ``([B, H*W, 4], [B, H*W])``, the untiled outputs of
    ``slicemarch_dense_reference`` (same arguments).

    A CUDA ``vol`` launches the slice-march kernel over ``dense_worklist``
    on the current stream (a failed build or launch raises); a CPU ``vol``
    runs the plain version.  ``slicemarch_render.launches`` counts kernel
    launches."""
    kw = dict(
        width=width, height=height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification,
    )
    if vol.device.type == "cpu":
        colors, depths = slicemarch_dense_reference(vol, meta, dims, lut, cam, **kw)
        return untile(colors, depths, width, height)
    num_tiles = (width // TILE_W) * (height // TILE_H)
    colors, depths, launched = _launch(
        vol, meta, dims, lut, cam,
        *dense_worklist(vol.shape[0], num_tiles, vol.device), None, **kw)
    slicemarch_render.launches += int(launched)
    return untile(colors, depths, width, height)


slicemarch_render.launches = 0


def slicemarch_render_worklist(
    vol: Tensor,
    meta: Tensor,
    dims: Tensor,
    lut: Tensor,
    cam: Tensor,
    work_bricks: Tensor,
    work_tiles: Tensor,
    coverage: Tensor,  # [B, T] bool: which (piece, tile) blocks were scheduled
    work_bounds: Optional[Tensor] = None,
    *,
    width: int,
    height: int,
    **kw,
) -> Tuple[Tensor, Tensor]:
    """Per-piece layers in row-major order, ``([B, H*W, 4], [B, H*W])``:
    the raw render with unscheduled blocks masked to background (colour 0,
    depth +inf), then untiled."""
    colors, depths = slicemarch_render_worklist_raw(
        vol, meta, dims, lut, cam, work_bricks, work_tiles, work_bounds,
        width=width, height=height, **kw,
    )
    cov = coverage.to(device=colors.device, dtype=torch.bool)
    colors = torch.where(cov[:, :, None, None, None], colors, 0.0)
    depths = torch.where(cov[:, :, None, None], depths, float("inf"))
    return untile(colors, depths, width, height)
