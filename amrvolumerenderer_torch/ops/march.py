"""The per-ray slice march in plain PyTorch, shared by the plain versions of
the tile-march and slice-march kernels (the twin of ``csrc/march.cuh``),
and the argument checks their wrappers share.

``tile_rays`` builds one ray per pixel of each given 32x32 tile;
``blend`` is the depth-sorted over blend of the run folds;
``march_pieces`` marches row ``i``'s piece ``bricks[i]`` over its slice
band ``bounds[i]`` for the rays of row ``i`` and returns the piece's layer
(clamped colour planes and entry depth).  Rounding follows the JAX kernels
as XLA compiles them for the CPU (``numerics``); ``rolled`` selects the
slice-march kernel's rolled-loop fold over the tile-march kernel's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .numerics import exp as _exp, fma as _fma, rsqrt as _rsqrt, seed_table
from .worklist import TILE_H, TILE_P, TILE_W

Tensor = torch.Tensor


def f32(v: float) -> float:
    """``v`` rounded to float32, as JAX rounds a Python constant."""
    return float(torch.tensor(v, dtype=torch.float32))


def check_args(width, height, sampling, classification) -> None:
    if width % TILE_W or height % TILE_H:
        raise ValueError(f"frame {width}x{height} is not a multiple of the tile")
    if sampling not in ("nearest", "trilinear"):
        raise ValueError(f"unknown sampling {sampling!r}")
    if classification not in ("post", "pre"):
        raise ValueError(f"unknown classification {classification!r}")


def require(t: Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def blend(top_c, top_d, bot_c, bot_d):
    """Depth-sorted over blend of two layers (ImageRGBAFloatColorDepthSort.
    hpp:13-27), colour as four planes; ties keep ``top`` in front."""
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


def tile_rays(
    tiles: Tensor,  # [N] frame tile per row
    cam: Tensor,  # [20] f32 camera pack
    width: int,  # padded frame width
    logical_width: int,
    logical_height: int,
) -> Tuple[Tensor, Tensor]:
    """World ray directions ``[3, N, 1024]`` of each row's tile (pixel p at
    (p % 32, p // 32)) and their dot with the forward axis ``[N, 1024]``."""
    f32_ = torch.float32
    cam = cam.to(f32_)
    fwd = [cam[3 + i] for i in range(3)]
    right = [cam[6 + i] for i in range(3)]
    up = [cam[9 + i] for i in range(3)]
    tiles_x = width // TILE_W
    flat = torch.arange(TILE_P, device=cam.device)
    t = tiles.long()[:, None]
    px = ((t % tiles_x) * TILE_W + flat % TILE_W).to(f32_)
    py = ((t // tiles_x) * TILE_H + flat // TILE_W).to(f32_)
    ndc_x = _fma(px + 0.5, f32(2.0 / logical_width), -1.0)
    ndc_y = _fma(py + 0.5, f32(2.0 / logical_height), -1.0)
    plane_x = ndc_x * cam[12] * cam[13]
    plane_y = ndc_y * cam[12]
    d_w = [
        _fma(up[i], plane_y, _fma(right[i], plane_x, fwd[i]))
        for i in range(3)
    ]
    len_sq = _fma(d_w[2], d_w[2], _fma(d_w[0], d_w[0], d_w[1] * d_w[1]))
    inv_len = torch.where(len_sq > 0.0, _rsqrt(len_sq), 0.0)
    d_w = [di * inv_len for di in d_w]
    fwd_dot = _fma(d_w[2], fwd[2], _fma(d_w[0], fwd[0], d_w[1] * fwd[1]))
    return torch.stack(d_w), fwd_dot


def march_pieces(
    vol: Tensor,  # [B, S, 8, 128] packed slices
    meta: Tensor,  # [B, 12] f32 pmin(3) pmax(3) cell(3) pad(3), permuted
    dims: Tensor,  # [B, 8] i32 n_slices nu nv perm(3) nv_stride bounds
    lut: Tensor,  # [P, 4, E] log-LUT tables
    lut_rows: Tensor,  # [N] table of each row's piece in ``lut``
    cam: Tensor,  # [20] f32 camera pack
    bricks: Tensor,  # [N] piece per row
    bounds: Tensor,  # [N] packed (lo<<16)|hi slice band, 0 = full
    dirs: Tensor,  # [3, N, 1024] world ray directions (``tile_rays``)
    fwd_dot: Tensor,  # [N, 1024]
    active: Optional[Tensor] = None,  # [N, 1] bool: rows that march
    *,
    max_slices: int,
    sampling: str,
    ghost: int,
    classification: str,
    rolled: bool,
) -> Tuple[List[Tensor], Tensor]:
    """Each row's piece layer for the row's rays: ([r, g, b, a] clamped,
    depth), each [N, 1024].  Samples fold strictly in slice order; the
    Python loop runs over the slices of the longest active band."""
    f32_ = torch.float32
    dev = vol.device
    rows = bricks.shape[0]
    stored = vol.shape[1]
    vol_flat = vol.reshape(-1).to(f32_)
    entries = lut.shape[-1]
    lut_flat = lut.reshape(-1).to(f32_)
    table_max = entries - 1
    inf = torch.tensor(float("inf"), dtype=f32_, device=dev)
    cam = cam.to(f32_)
    range_min, inverse_range, ref_distance = cam[14], cam[15], cam[16]
    if active is None:
        active = torch.ones((rows, 1), dtype=torch.bool, device=dev)

    b = bricks.long()
    m = meta.to(f32_)[b]  # [N, 12]
    dm = dims.long()[b]  # [N, 8]
    pmin = [m[:, i, None] for i in range(3)]
    pmax = [m[:, 3 + i, None] for i in range(3)]
    cell = [m[:, 6 + i, None] for i in range(3)]
    n_slices = dm[:, 0, None]
    nu = dm[:, 1, None]
    nv = dm[:, 2, None]
    nv_stride = torch.where(dm[:, 6] > 0, dm[:, 6], dm[:, 2])[:, None]
    sb = bounds.long()
    s_lo = torch.where(sb > 0, sb >> 16, 0)[:, None]
    s_hi = torch.where(sb > 0, sb & 0xFFFF, dm[:, 0])[:, None]

    # permute the ray into the piece's axis order (march axis first)
    perm = [torch.where((dm[:, 3 + i] == 0) | (dm[:, 3 + i] == 1),
                        dm[:, 3 + i], 2) for i in range(3)]
    row_idx = torch.arange(rows, device=dev)
    eye = [cam[p][:, None] for p in perm]
    d = [dirs[p, row_idx] for p in perm]

    # slab test against the piece's core box
    zero = torch.zeros((rows, TILE_P), dtype=f32_, device=dev)
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
    lut_base = lut_rows.long()[:, None] * (4 * entries)

    def gather(base, iu_, iv_):
        cell_idx = (iu_ + ghost) * nv_stride + (iv_ + ghost)
        return vol_flat[base + cell_idx.clamp(0, TILE_P - 1)]

    def classify(scalar):
        normalized = torch.clamp((scalar - range_min) * inverse_range, 0.0, 1.0)
        idx = torch.clamp((normalized * table_max).to(torch.int64), 0, table_max)
        return [lut_flat[lut_base + ch * entries + idx] for ch in range(4)]

    acc = [zero] * 4
    for kk in range(max(trips, 0)):
        k = s_lo + kk  # [N, 1]
        # backward rays mirror within the occupied range
        k_eff = torch.where(backward, s_lo + s_hi - 1 - k, k)
        z_k = _fma(k_eff.to(f32_) + 0.5, cell[0], pmin[0])
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

        if sampling == "nearest":
            # clamp in float first: float->int of an out-of-range value is
            # undefined on the CPU, and the result clips anyway
            fu = torch.floor((pos_u - pmin[1]) / cell[1])
            fv = torch.floor((pos_v - pmin[2]) / cell[2])
            iu = torch.minimum(
                torch.clamp(fu, -1.0, 1e9).to(torch.int64), nu - 1
            ).clamp(min=0)
            iv = torch.minimum(
                torch.clamp(fv, -1.0, 1e9).to(torch.int64), nv - 1
            ).clamp(min=0)
            s_r, s_g, s_b, s_l = classify(gather(base, iu, iv))
        else:
            g = float(ghost)
            pu = (pos_u - pmin[1]) / cell[1] - 0.5
            pv = (pos_v - pmin[2]) / cell[2] - 0.5
            pu = torch.minimum(torch.clamp(pu, min=-g), (nu - 1).to(f32_) + g)
            pv = torch.minimum(torch.clamp(pv, min=-g), (nv - 1).to(f32_) + g)
            fu0 = torch.floor(pu)
            fv0 = torch.floor(pv)
            wu = torch.clamp(pu - fu0, 0.0, 1.0)
            wv = torch.clamp(pv - fv0, 0.0, 1.0)
            iu0 = fu0.to(torch.int64)
            iu1 = torch.minimum(iu0 + 1, nu - 1 + ghost)
            iv0 = fv0.to(torch.int64)
            iv1 = torch.minimum(iv0 + 1, nv - 1 + ghost)
            corners = (
                gather(base, iu0, iv0), gather(base, iu1, iv0),
                gather(base, iu0, iv1), gather(base, iu1, iv1),
            )
            if classification == "pre":
                wts = (
                    (1.0 - wu) * (1.0 - wv), wu * (1.0 - wv),
                    (1.0 - wu) * wv, wu * wv,
                )
                cls = [classify(v_c) for v_c in corners]
                for c_ in cls:
                    # opaque entries store L = -inf: clamp before weighting
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
                s_r, s_g, s_b, s_l = classify(_fma(v0, 1.0 - wv, v1 * wv))

        # step-normalised opacity: 1 - (1 - a_ref)^(w / ref)
        q_k = w / ref_distance
        a = torch.where(valid, 1.0 - _exp(q_k * s_l), 0.0)
        one_m = 1.0 - acc[3]
        if rolled:
            # the slice-march kernel's rolled loop, as XLA contracts it:
            # alpha = a * (1 - acc_a) is rounded before the colour FMAs
            alpha = a * one_m
            colour = [_fma(s, alpha, c) for s, c in zip((s_r, s_g, s_b), acc)]
        else:
            colour = [_fma(s * a, one_m, c) for s, c in zip((s_r, s_g, s_b), acc)]
        acc = colour + [_fma(a, one_m, acc[3])]

    c = [torch.clamp(x, 0.0, 1.0) for x in acc]
    entry_depth = tmin * fwd_dot
    depth = torch.where(
        hit & (c[3] > 0.0) & torch.isfinite(entry_depth), entry_depth, inf
    )
    return c, depth
