"""Tile-march render: slice march + per-owner run composite in one pass.

``tilemarch_render`` (one frame) and ``tilemarch_render_batch`` (F frames
in one launch) are the entries the renderer calls.  On a CUDA tensor they
launch the hand-written kernel (``csrc/tilemarch.cu``; a single frame is
F = 1 of the same launch); on a CPU tensor they run ``tilemarch_reference``
/ ``tilemarch_batch_reference``, the same function in plain PyTorch.  They
take the JAX package's ``ops/tilemarch.py::tilemarch_render`` /
``tilemarch_render_batch`` arguments (full-brick gather) on a float32 or a
bfloat16 volume, and return its outputs: ``([G, 4, 8, 128], [G, 8, 128])``
tile-space colour and depth, one row per grid step (``[F, S, ...]`` for a
batch), where step ``g`` renders frame tile ``tile_ids[g]`` and a sentinel
step (``tile_ids == num_tiles``, empty work list) comes back as background.
A bfloat16 volume widens to float32 exactly before any arithmetic, as the
TPU kernel upcasts each slice.

Rounding follows the JAX reference as XLA compiles it for the CPU, op
for op (``numerics``): fused multiply-adds where XLA contracts, XLA's
float32 ``exp`` and ``rsqrt``.  The CUDA kernel spells out the same
operations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .march import (
    blend,
    check_args,
    f32,
    march_pieces,
    require,
    seed_table,
    tile_rays,
)
from .worklist import LANES, SUBLANES, TILE_H, TILE_P, TILE_W

Tensor = torch.Tensor


def _defaults(dims, tile_bricks, item_bounds, tile_ids, width, height):
    if item_bounds is None:
        item_bounds = dims[tile_bricks.long(), 7]
    if tile_ids is None:
        num_tiles = (width // TILE_W) * (height // TILE_H)
        tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dims.device)
    return item_bounds, tile_ids


def tilemarch_reference(
    vol: Tensor,  # [B, S, 8, 128] f32 or bf16 packed slice bricks
    meta: Tensor,  # [B, 12] f32 pmin(3) pmax(3) cell(3) pad(3), permuted
    dims: Tensor,  # [B, 8] i32 n_slices nu nv perm(3) nv_stride bounds
    lut: Tensor,  # [4, size // 128, 128] f32 (r, g, b, log(1 - alpha))
    cam: Tensor,  # [20] f32 camera pack (worklist.pack_camera)
    tile_offsets: Tensor,  # [G + 1] i32 CSR offsets per grid step
    tile_bricks: Tensor,  # [W] i32 brick per work item, front to back
    tile_owners: Tensor,  # [W] i32 owner per work item
    item_bounds: Optional[Tensor] = None,  # [W] i32 (lo<<16)|hi, 0 = full
    tile_ids: Optional[Tensor] = None,  # [G] i32 frame tile per step
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
    """The tile-march kernel in plain PyTorch, vectorised over every grid
    step x 1024 pixels.  Python loops run over the item rank within a tile
    (up to the longest CSR list) and over the slices of that rank's items,
    folding samples strictly in order as the kernel does."""
    check_args(width, height, sampling, classification)
    item_bounds, tile_ids = _defaults(
        dims, tile_bricks, item_bounds, tile_ids, width, height
    )
    dev = vol.device
    steps = tile_ids.shape[0]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    dirs, fwd_dot = tile_rays(tile_ids, cam, width, logical_width or width,
                              logical_height or height)
    lut_one = lut.reshape(1, 4, -1)  # one table for every piece
    lut_rows = torch.zeros(steps, dtype=torch.long, device=dev)

    zero = torch.zeros((steps, TILE_P), dtype=torch.float32, device=dev)
    run_c = [zero] * 4
    run_d = zero + inf
    tot_c = [zero] * 4
    tot_d = zero + inf
    have_tot = torch.zeros((steps, 1), dtype=torch.bool, device=dev)

    def sel(pred, a, b):
        return [torch.where(pred, x, y) for x, y in zip(a, b)]

    offsets = tile_offsets.long()
    begin = offsets[:-1]
    counts = offsets[1:] - begin
    num_items = tile_bricks.shape[0]
    max_rank = int(counts.max()) if steps and num_items else 0
    owners_l = tile_owners.long()

    for rank in range(max_rank):
        active = (rank < counts)[:, None]  # [G, 1]
        widx = (begin + rank).clamp(0, num_items - 1)
        c, dd = march_pieces(
            vol, meta, dims, lut_one, lut_rows, cam, tile_bricks[widx],
            item_bounds[widx], dirs, fwd_dot, active, max_slices=max_slices,
            sampling=sampling, ghost=ghost, classification=classification,
            rolled=False,
        )

        # per-owner run fold (ties keep the earlier item in front)
        prev = (begin + rank - 1).clamp(0, num_items - 1)
        same_owner = (owners_l[widx] == owners_l[prev])[:, None] & (rank > 0)
        closed_c, closed_d = blend(tot_c, tot_d, run_c, run_d)
        closed_c = sel(have_tot, closed_c, run_c)
        closed_d = torch.where(have_tot, closed_d, run_d)
        new_tot_c = sel(same_owner, tot_c, closed_c)
        new_tot_d = torch.where(same_owner, tot_d, closed_d)
        new_have = torch.where(same_owner, have_tot, have_tot | (rank > 0))
        ext_c, ext_d = blend(run_c, run_d, c, dd)
        new_run_c = sel(same_owner, ext_c, c)
        new_run_d = torch.where(same_owner, ext_d, dd)
        tot_c = sel(active, new_tot_c, tot_c)
        tot_d = torch.where(active, new_tot_d, tot_d)
        have_tot = torch.where(active, new_have, have_tot)
        run_c = sel(active, new_run_c, run_c)
        run_d = torch.where(active, new_run_d, run_d)

    fin_c, fin_d = blend(tot_c, tot_d, run_c, run_d)
    out_c = torch.stack(sel(have_tot, fin_c, run_c), dim=1)  # [G, 4, 1024]
    out_d = torch.where(have_tot, fin_d, run_d)
    return (
        out_c.reshape(steps, 4, SUBLANES, LANES),
        out_d.reshape(steps, SUBLANES, LANES),
    )


def tilemarch_batch_reference(
    vol: Tensor,
    meta: Tensor,
    dims: Tensor,
    lut: Tensor,
    cams: Tensor,  # [F, 20] per-frame camera packs
    tile_offsets: Tensor,  # [F, S + 1]
    tile_bricks: Tensor,  # [F, W]
    tile_owners: Tensor,  # [F, W]
    item_bounds: Tensor,  # [F, W]
    tile_ids: Tensor,  # [F, S]
    **kw,
) -> Tuple[Tensor, Tensor]:
    """The batched kernel in plain PyTorch: ``tilemarch_reference`` frame
    by frame.  Returns ``([F, S, 4, 8, 128], [F, S, 8, 128])``."""
    outs = [
        tilemarch_reference(vol, meta, dims, lut, cams[f], tile_offsets[f],
                            tile_bricks[f], tile_owners[f], item_bounds[f],
                            tile_ids[f], **kw)
        for f in range(tile_ids.shape[0])
    ]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _launch(vol, meta, dims, lut, cams, tile_offsets, tile_bricks, tile_owners,
            item_bounds, tile_ids, frames, steps, items, *, width, height,
            max_slices, logical_width, logical_height, sampling, ghost,
            classification) -> Tuple[Tensor, Tensor]:
    """Check every argument against what the CUDA kernel takes and launch
    it on the current stream for ``frames`` frames of ``steps`` grid steps
    and ``items``-long work rows.  Returns the flat ``[F * S, ...]``
    outputs.  A failed build or launch raises."""
    check_args(width, height, sampling, classification)
    dev = vol.device
    i32, f32_ = torch.int32, torch.float32
    num_bricks, stored = vol.shape[0], vol.shape[1]
    if vol.dtype not in (f32_, torch.bfloat16):
        raise TypeError(f"vol has dtype {vol.dtype}, expected float32 or bfloat16")
    require(vol, "vol", vol.dtype, (num_bricks, stored, SUBLANES, LANES), dev)
    require(meta, "meta", f32_, (num_bricks, 12), dev)
    require(dims, "dims", i32, (num_bricks, 8), dev)
    if lut.dim() != 3 or lut.shape[0] != 4 or lut.shape[2] != LANES:
        raise ValueError(f"lut has shape {tuple(lut.shape)}, expected [4, n, 128]")
    require(lut, "lut", f32_, tuple(lut.shape), dev)
    lead = (frames,) if cams.dim() == 2 else ()
    require(cams, "cam", f32_, lead + (20,), dev)
    require(tile_offsets, "tile_offsets", i32, lead + (steps + 1,), dev)
    require(tile_bricks, "tile_bricks", i32, lead + (items,), dev)
    require(tile_owners, "tile_owners", i32, lead + (items,), dev)
    require(item_bounds, "item_bounds", i32, lead + (items,), dev)
    require(tile_ids, "tile_ids", i32, lead + (steps,), dev)
    if not 0 < max_slices <= stored:
        raise ValueError(f"max_slices {max_slices} outside (0, {stored}]")

    out_c = torch.empty((frames * steps, 4, SUBLANES, LANES), dtype=f32_, device=dev)
    out_d = torch.empty((frames * steps, SUBLANES, LANES), dtype=f32_, device=dev)
    if frames * steps == 0:
        return out_c, out_d
    from . import _build

    lib = _build.load("tilemarch")
    seed = seed_table(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.avr_tilemarch_launch(
        vol.data_ptr(), meta.data_ptr(), dims.data_ptr(), lut.data_ptr(),
        cams.data_ptr(), tile_offsets.data_ptr(), tile_bricks.data_ptr(),
        tile_owners.data_ptr(), item_bounds.data_ptr(), tile_ids.data_ptr(),
        seed.data_ptr(), out_c.data_ptr(), out_d.data_ptr(),
        frames, steps, items, stored, lut.shape[1] * LANES, width // TILE_W,
        max_slices, ghost, f32(2.0 / (logical_width or width)),
        f32(2.0 / (logical_height or height)),
        int(sampling == "trilinear"), int(classification == "pre"),
        int(vol.dtype == torch.bfloat16), stream,
    )
    if rc != 0:
        raise RuntimeError(f"tilemarch kernel launch failed: CUDA error {rc}")
    return out_c, out_d


def tilemarch_render(
    vol: Tensor,
    meta: Tensor,
    dims: Tensor,
    lut: Tensor,
    cam: Tensor,
    tile_offsets: Tensor,
    tile_bricks: Tensor,
    tile_owners: Tensor,
    item_bounds: Optional[Tensor] = None,
    tile_ids: Optional[Tensor] = None,
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
    """Render + composite one frame; arguments as ``tilemarch_reference``.

    A CUDA ``vol`` launches the CUDA kernel (one frame) on the current
    stream (a failed build or launch raises); a CPU ``vol`` runs the plain
    version.  ``tilemarch_render.launches`` counts kernel launches."""
    kw = dict(
        width=width, height=height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification,
    )
    args = (vol, meta, dims, lut, cam, tile_offsets, tile_bricks, tile_owners)
    if vol.device.type == "cpu":
        return tilemarch_reference(*args, item_bounds, tile_ids, **kw)
    if vol.device.type != "cuda":
        raise ValueError(f"tilemarch_render has no kernel for {vol.device}")
    item_bounds, tile_ids = _defaults(
        dims, tile_bricks, item_bounds, tile_ids, width, height
    )
    out = _launch(*args, item_bounds, tile_ids, 1, tile_ids.shape[0],
                  tile_bricks.shape[0], **kw)
    if tile_ids.shape[0]:
        tilemarch_render.launches += 1
    return out


tilemarch_render.launches = 0


def tilemarch_render_batch(
    vol: Tensor,
    meta: Tensor,
    dims: Tensor,
    lut: Tensor,
    cams: Tensor,  # [F, 20] per-frame camera packs
    tile_offsets: Tensor,  # [F, S + 1] i32 CSR offsets per frame
    tile_bricks: Tensor,  # [F, W] i32 brick per work item
    tile_owners: Tensor,  # [F, W] i32 owner per work item
    item_bounds: Tensor,  # [F, W] i32 packed slice band per work item
    tile_ids: Tensor,  # [F, S] i32 frame tile per grid step
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
    """F frames in ONE launch (grid = F * S steps): the JAX package's
    ``tilemarch_render_batch``.  The volume and piece tables are shared;
    each frame has its camera pack and CSR work row (offsets index into
    the frame's own row).  Returns ``([F, S, 4, 8, 128], [F, S, 8, 128])``.

    A CUDA ``vol`` launches the CUDA kernel on the current stream; a CPU
    ``vol`` runs ``tilemarch_batch_reference``.
    ``tilemarch_render_batch.launches`` counts kernel launches."""
    kw = dict(
        width=width, height=height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification,
    )
    args = (vol, meta, dims, lut, cams, tile_offsets, tile_bricks, tile_owners,
            item_bounds, tile_ids)
    if vol.device.type == "cpu":
        return tilemarch_batch_reference(*args, **kw)
    if vol.device.type != "cuda":
        raise ValueError(f"tilemarch_render_batch has no kernel for {vol.device}")
    if tile_ids.dim() != 2 or tile_bricks.dim() != 2:
        raise ValueError("tile_ids and tile_bricks must be [F, S] and [F, W]")
    frames, steps = tile_ids.shape
    out_c, out_d = _launch(*args, frames, steps, tile_bricks.shape[1], **kw)
    if frames * steps:
        tilemarch_render_batch.launches += 1
    return (out_c.reshape(frames, steps, 4, SUBLANES, LANES),
            out_d.reshape(frames, steps, SUBLANES, LANES))


tilemarch_render_batch.launches = 0


def scatter_tiles(
    out_c: Tensor,  # [G, 4, 8, 128] compacted kernel output
    out_d: Tensor,  # [G, 8, 128]
    tile_ids: Tensor,  # [G] frame tile per grid step (tail may pad)
    num_tiles: int,
) -> Tuple[Tensor, Tensor]:
    """Compacted grid output -> full tile-space frame; uncovered tiles are
    background (colour 0, depth +inf).  Pad steps carry the out-of-range
    sentinel ``tile_ids == num_tiles`` and are dropped here explicitly
    (torch indexing would raise on them, where JAX's scatter drops them)."""
    keep = tile_ids.long() < num_tiles
    ids = tile_ids.long()[keep]
    full_c = torch.zeros(
        (num_tiles,) + tuple(out_c.shape[1:]), dtype=out_c.dtype,
        device=out_c.device,
    )
    full_d = torch.full(
        (num_tiles,) + tuple(out_d.shape[1:]), float("inf"), dtype=out_d.dtype,
        device=out_d.device,
    )
    full_c[ids] = out_c[keep]
    full_d[ids] = out_d[keep]
    return full_c, full_d
