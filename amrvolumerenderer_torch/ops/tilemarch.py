"""Tile-march render: slice march + per-owner run composite in one pass.

``tilemarch_render`` is the entry the renderer calls.  On a CUDA tensor it
launches the hand-written kernel (``csrc/tilemarch.cu``); on a CPU tensor
it runs ``tilemarch_reference``, the same function in plain PyTorch.  Both
take the JAX package's ``ops/tilemarch.py::tilemarch_render`` arguments
(single frame, float32 volume, full-brick gather) and return its outputs:
``([G, 4, 8, 128], [G, 8, 128])`` tile-space colour and depth, one row per
grid step, where step ``g`` renders frame tile ``tile_ids[g]`` and a
sentinel step (``tile_ids == num_tiles``, empty work list) comes back as
background.

Rounding follows the JAX reference as XLA compiles it for the CPU, op
for op (``numerics``): fused multiply-adds where XLA contracts, XLA's
float32 ``exp`` and ``rsqrt``.  The CUDA kernel spells out the same
operations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .numerics import RSQRT_SEED, exp as _exp, fma as _fma, rsqrt as _rsqrt
from .worklist import LANES, SUBLANES, TILE_H, TILE_P, TILE_W

Tensor = torch.Tensor

def _f32(v: float) -> float:
    """``v`` rounded to float32, as JAX rounds a Python constant."""
    return float(torch.tensor(v, dtype=torch.float32))


def _check_args(width, height, sampling, classification):
    if width % TILE_W or height % TILE_H:
        raise ValueError(f"frame {width}x{height} is not a multiple of the tile")
    if sampling not in ("nearest", "trilinear"):
        raise ValueError(f"unknown sampling {sampling!r}")
    if classification not in ("post", "pre"):
        raise ValueError(f"unknown classification {classification!r}")


def _defaults(dims, tile_bricks, item_bounds, tile_ids, width, height):
    if item_bounds is None:
        item_bounds = dims[tile_bricks.long(), 7]
    if tile_ids is None:
        num_tiles = (width // TILE_W) * (height // TILE_H)
        tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dims.device)
    return item_bounds, tile_ids


def tilemarch_reference(
    vol: Tensor,  # [B, S, 8, 128] f32 packed slice bricks
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
    _check_args(width, height, sampling, classification)
    item_bounds, tile_ids = _defaults(
        dims, tile_bricks, item_bounds, tile_ids, width, height
    )
    dev = vol.device
    f32 = torch.float32
    lw = logical_width or width
    lh = logical_height or height
    num_bricks, stored = vol.shape[0], vol.shape[1]
    vol_flat = vol.reshape(-1).to(f32)
    lut2 = lut.reshape(4, -1).to(f32)
    table_max = lut2.shape[1] - 1
    steps = tile_ids.shape[0]
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)

    cam = cam.to(f32)
    eye_w = [cam[i] for i in range(3)]
    fwd = [cam[3 + i] for i in range(3)]
    right = [cam[6 + i] for i in range(3)]
    up = [cam[9 + i] for i in range(3)]
    tan_half_fov, aspect = cam[12], cam[13]
    range_min, inverse_range, ref_distance = cam[14], cam[15], cam[16]

    # ---- per-step rays: [G, 1024], pixel p of the tile at (p % 32, p // 32)
    tiles_x = width // TILE_W
    flat = torch.arange(TILE_P, device=dev)
    t = tile_ids.long()[:, None]
    px = ((t % tiles_x) * TILE_W + flat % TILE_W).to(f32)
    py = ((t // tiles_x) * TILE_H + flat // TILE_W).to(f32)
    ndc_x = _fma(px + 0.5, _f32(2.0 / lw), -1.0)
    ndc_y = _fma(py + 0.5, _f32(2.0 / lh), -1.0)
    plane_x = ndc_x * tan_half_fov * aspect
    plane_y = ndc_y * tan_half_fov
    d_w = [
        _fma(up[i], plane_y, _fma(right[i], plane_x, fwd[i]))
        for i in range(3)
    ]
    len_sq = _fma(d_w[2], d_w[2], _fma(d_w[0], d_w[0], d_w[1] * d_w[1]))
    inv_len = torch.where(len_sq > 0.0, _rsqrt(len_sq), 0.0)
    d_w = [di * inv_len for di in d_w]
    ray_fwd_dot = _fma(d_w[2], fwd[2], _fma(d_w[0], fwd[0], d_w[1] * fwd[1]))
    eye_stack = torch.stack(eye_w)  # [3]
    d_stack = torch.stack(d_w)  # [3, G, 1024]

    zero = torch.zeros((steps, TILE_P), dtype=f32, device=dev)
    run_c = [zero] * 4
    run_d = zero + inf
    tot_c = [zero] * 4
    tot_d = zero + inf
    have_tot = torch.zeros((steps, 1), dtype=torch.bool, device=dev)

    def blend(top_c, top_d, bot_c, bot_d):
        top_front = top_d <= bot_d
        one_minus = 1.0 - torch.where(top_front, top_c[3], bot_c[3])
        out_c = [
            _fma(
                torch.where(top_front, bot_c[ch], top_c[ch]), one_minus,
                torch.where(top_front, top_c[ch], bot_c[ch]),
            )
            for ch in range(4)
        ]
        return out_c, torch.minimum(top_d, bot_d)

    def sel(pred, a, b):
        return [torch.where(pred, x, y) for x, y in zip(a, b)]

    offsets = tile_offsets.long()
    begin = offsets[:-1]
    counts = offsets[1:] - begin
    num_items = tile_bricks.shape[0]
    max_rank = int(counts.max()) if steps and num_items else 0
    bricks_l = tile_bricks.long()
    owners_l = tile_owners.long()
    bounds_l = item_bounds.long()
    meta = meta.to(f32)
    dims_l = dims.long()
    steps_idx = torch.arange(steps, device=dev)

    for rank in range(max_rank):
        active = (rank < counts)[:, None]  # [G, 1]
        widx = (begin + rank).clamp(0, num_items - 1)
        b = bricks_l[widx]  # [G]
        m = meta[b]  # [G, 12]
        dm = dims_l[b]  # [G, 8]
        pmin = [m[:, i, None] for i in range(3)]
        pmax = [m[:, 3 + i, None] for i in range(3)]
        cell = [m[:, 6 + i, None] for i in range(3)]
        n_slices = dm[:, 0, None]
        nu = dm[:, 1, None]
        nv = dm[:, 2, None]
        perm = [dm[:, 3 + i] for i in range(3)]
        nv_stride = torch.where(dm[:, 6] > 0, dm[:, 6], dm[:, 2])[:, None]
        sb = bounds_l[widx]
        s_lo = torch.where(sb > 0, sb >> 16, 0)[:, None]
        s_hi = torch.where(sb > 0, sb & 0xFFFF, dm[:, 0])[:, None]

        def pick(p, world):
            idx = torch.where((p == 0) | (p == 1), p, 2)
            if world.dim() == 1:
                return world[idx][:, None]
            return world[idx, steps_idx]  # [G, 1024]

        eye = [pick(perm[i], eye_stack) for i in range(3)]
        d = [pick(perm[i], d_stack) for i in range(3)]

        tmin = zero - inf
        tmax = zero + inf
        for axis in range(3):
            parallel = torch.abs(d[axis]) < 1e-8
            inv = 1.0 / torch.where(parallel, 1.0, d[axis])
            t1 = (pmin[axis] - eye[axis]) * inv
            t2 = (pmax[axis] - eye[axis]) * inv
            lo = torch.minimum(t1, t2)
            hi = torch.maximum(t1, t2)
            inside = (eye[axis] >= pmin[axis]) & (eye[axis] <= pmax[axis])
            lo = torch.where(parallel, torch.where(inside, -inf, inf), lo)
            hi = torch.where(parallel, torch.where(inside, inf, -inf), hi)
            tmin = torch.maximum(tmin, lo)
            tmax = torch.minimum(tmax, hi)
        hit = (tmax >= tmin) & (tmax > 0.0)
        d_a = d[0]
        marchable = torch.abs(d_a) > 1e-8
        inv_da = 1.0 / torch.where(marchable, d_a, 1.0)
        backward = d_a < 0.0
        dt = cell[0] * torch.abs(inv_da)
        t_lo = torch.clamp(tmin, min=0.0)
        t_hi = tmax
        hi_k = torch.clamp(s_hi, max=max_slices)
        lim = torch.minimum(s_hi, n_slices)
        live = hit & marchable & active
        trips = int((hi_k - s_lo)[active].max()) if bool(active.any()) else 0

        acc = [zero] * 4
        for kk in range(max(trips, 0)):
            k = s_lo + kk  # [G, 1]
            k_eff = torch.where(backward, s_lo + s_hi - 1 - k, k)
            z_k = _fma(k_eff.to(f32) + 0.5, cell[0], pmin[0])
            t_k = (z_k - eye[0]) * inv_da
            pos_u = _fma(d[1], t_k, eye[1])
            pos_v = _fma(d[2], t_k, eye[2])
            w = torch.clamp(
                torch.minimum(t_k + 0.5 * dt, t_hi)
                - torch.maximum(t_k - 0.5 * dt, t_lo),
                min=0.0,
            )
            valid = live & (k < hi_k) & (k < lim) & (w > 0.0)
            k_load = torch.minimum(k, torch.clamp(s_hi - 1, min=0))
            k_rev_load = torch.clamp(
                s_lo + s_hi - 1 - k_load, 0, max_slices - 1 - ghost
            )
            slice_ = torch.where(backward, k_rev_load, k_load) + ghost
            base = (b[:, None] * stored + slice_.clamp(0, stored - 1)) * TILE_P

            def gather(iu_, iv_):
                cell_idx = (iu_ + ghost) * nv_stride + (iv_ + ghost)
                return vol_flat[base + cell_idx.clamp(0, TILE_P - 1)]

            def classify(scalar):
                normalized = torch.clamp(
                    (scalar - range_min) * inverse_range, 0.0, 1.0
                )
                idx = torch.clamp(
                    (normalized * table_max).to(torch.int64), 0, table_max
                )
                return [lut2[ch][idx] for ch in range(4)]

            if sampling == "nearest":
                # clamp in float first: float->int of an out-of-range value
                # is undefined on the CPU, and the result clips anyway
                fu = torch.floor((pos_u - pmin[1]) / cell[1])
                fv = torch.floor((pos_v - pmin[2]) / cell[2])
                iu = torch.minimum(
                    torch.clamp(fu, -1.0, 1e9).to(torch.int64), nu - 1
                ).clamp(min=0)
                iv = torch.minimum(
                    torch.clamp(fv, -1.0, 1e9).to(torch.int64), nv - 1
                ).clamp(min=0)
                s_r, s_g, s_b, s_l = classify(gather(iu, iv))
            else:
                g = float(ghost)
                pu = (pos_u - pmin[1]) / cell[1] - 0.5
                pv = (pos_v - pmin[2]) / cell[2] - 0.5
                pu = torch.minimum(torch.clamp(pu, min=-g), (nu - 1).to(f32) + g)
                pv = torch.minimum(torch.clamp(pv, min=-g), (nv - 1).to(f32) + g)
                fu0 = torch.floor(pu)
                fv0 = torch.floor(pv)
                wu = torch.clamp(pu - fu0, 0.0, 1.0)
                wv = torch.clamp(pv - fv0, 0.0, 1.0)
                iu0 = fu0.to(torch.int64)
                iu1 = torch.minimum(iu0 + 1, nu - 1 + ghost)
                iv0 = fv0.to(torch.int64)
                iv1 = torch.minimum(iv0 + 1, nv - 1 + ghost)
                corners = (
                    gather(iu0, iv0), gather(iu1, iv0),
                    gather(iu0, iv1), gather(iu1, iv1),
                )
                if classification == "pre":
                    wts = (
                        (1.0 - wu) * (1.0 - wv), wu * (1.0 - wv),
                        (1.0 - wu) * wv, wu * wv,
                    )
                    cls = [classify(v_c) for v_c in corners]
                    for c_ in cls:
                        c_[3] = torch.clamp(c_[3], min=-1e4)
                    # c0*w0 + c1*w1 contracts its first product
                    s_r, s_g, s_b, s_l = [
                        _fma(cls[0][ch], wts[0], cls[1][ch] * wts[1])
                        for ch in range(4)
                    ]
                    for c_, wgt in zip(cls[2:], wts[2:]):
                        s_r, s_g, s_b, s_l = [
                            _fma(c_[ch], wgt, acc_)
                            for ch, acc_ in enumerate((s_r, s_g, s_b, s_l))
                        ]
                else:
                    v0 = _fma(corners[0], 1.0 - wu, corners[1] * wu)
                    v1 = _fma(corners[2], 1.0 - wu, corners[3] * wu)
                    s_r, s_g, s_b, s_l = classify(
                        _fma(v0, 1.0 - wv, v1 * wv)
                    )

            q_k = w / ref_distance
            a = torch.where(valid, 1.0 - _exp(q_k * s_l), 0.0)
            one_m = 1.0 - acc[3]
            acc = [
                _fma(s_r * a, one_m, acc[0]),
                _fma(s_g * a, one_m, acc[1]),
                _fma(s_b * a, one_m, acc[2]),
                _fma(a, one_m, acc[3]),
            ]

        c = [torch.clamp(x, 0.0, 1.0) for x in acc]
        entry_depth = tmin * ray_fwd_dot
        dd = torch.where(
            hit & (c[3] > 0.0) & torch.isfinite(entry_depth), entry_depth, inf
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


_seed_tables: dict = {}  # device -> RSQRT_SEED on that device


def _seed_table(dev: torch.device) -> Tensor:
    table = _seed_tables.get(dev)
    if table is None:
        table = torch.from_numpy(RSQRT_SEED).to(dev).contiguous()
        _seed_tables[dev] = table
    return table


def _require(t: Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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

    A CUDA ``vol`` launches the CUDA kernel on the current stream (a failed
    build or launch raises); a CPU ``vol`` runs the plain version.
    ``tilemarch_render.launches`` counts kernel launches."""
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
    _check_args(width, height, sampling, classification)
    item_bounds, tile_ids = _defaults(
        dims, tile_bricks, item_bounds, tile_ids, width, height
    )
    dev = vol.device
    i32, f32 = torch.int32, torch.float32
    num_bricks, stored = vol.shape[0], vol.shape[1]
    steps = tile_ids.shape[0]
    items = tile_bricks.shape[0]
    _require(vol, "vol", f32, (num_bricks, stored, SUBLANES, LANES), dev)
    _require(meta, "meta", f32, (num_bricks, 12), dev)
    _require(dims, "dims", i32, (num_bricks, 8), dev)
    if lut.dim() != 3 or lut.shape[0] != 4 or lut.shape[2] != LANES:
        raise ValueError(f"lut has shape {tuple(lut.shape)}, expected [4, n, 128]")
    _require(lut, "lut", f32, tuple(lut.shape), dev)
    _require(cam, "cam", f32, (20,), dev)
    _require(tile_offsets, "tile_offsets", i32, (steps + 1,), dev)
    _require(tile_bricks, "tile_bricks", i32, (items,), dev)
    _require(tile_owners, "tile_owners", i32, (items,), dev)
    _require(item_bounds, "item_bounds", i32, (items,), dev)
    _require(tile_ids, "tile_ids", i32, (steps,), dev)
    if not 0 < max_slices <= stored:
        raise ValueError(f"max_slices {max_slices} outside (0, {stored}]")

    out_c = torch.empty((steps, 4, SUBLANES, LANES), dtype=f32, device=dev)
    out_d = torch.empty((steps, SUBLANES, LANES), dtype=f32, device=dev)
    if steps == 0:
        return out_c, out_d
    from . import _build

    lib = _build.load("tilemarch")
    seed = _seed_table(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.avr_tilemarch_launch(
        vol.data_ptr(), meta.data_ptr(), dims.data_ptr(), lut.data_ptr(),
        cam.data_ptr(), tile_offsets.data_ptr(), tile_bricks.data_ptr(),
        tile_owners.data_ptr(), item_bounds.data_ptr(), tile_ids.data_ptr(),
        seed.data_ptr(), out_c.data_ptr(), out_d.data_ptr(),
        steps, stored, lut.shape[1] * LANES, width // TILE_W, max_slices,
        ghost, _f32(2.0 / (logical_width or width)),
        _f32(2.0 / (logical_height or height)),
        int(sampling == "trilinear"), int(classification == "pre"), stream,
    )
    if rc != 0:
        raise RuntimeError(f"tilemarch kernel launch failed: CUDA error {rc}")
    tilemarch_render.launches += 1
    return out_c, out_d


tilemarch_render.launches = 0


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
