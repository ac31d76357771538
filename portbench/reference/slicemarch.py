"""A plain slice-march renderer: the pixels of a frame, worked out again
from the bricks, the camera and the transfer function.

Semantics (ROADMAP "Semantics to keep"): each brick is marched along the
frame's dominant view axis, one sample per cell slice, the sample's
weight the length of the ray inside both the brick and the slice's
half-cell window on either side of its centre plane; nearest cell in the
slice plane; the scalar indexes the transfer function, whose opacity
enters as log transmittance, ``alpha = 1 - exp(w / ref * log(1 - a))``;
the brick's layer folds its samples front to back.  The layers of a pixel
fold front to back by their entry depth (the depth-sorted over blend),
the render buffer is box-averaged ``sqrt_aa`` x ``sqrt_aa`` and coded to
bytes as ``clamp(int(256 c), 0, 255)``.

Plain PyTorch, one brick at a time over the pixels its box can cover;
the slices of a brick are one tensor axis and its fold a cumulative
product.  It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def basis(eye, look_at, up):
    """Forward, right and up of a pinhole camera (float64)."""
    eye, look_at, up = (np.asarray(v, np.float64) for v in (eye, look_at, up))
    fwd = look_at - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    return fwd, right, np.cross(right, fwd)


def pixel_rays(fwd, right, up, tan, aspect, px: Tensor, py: Tensor, width, height):
    """Unit ray directions ``[3, N]`` through pixel centres (``px``,
    ``py``) of a ``width`` x ``height`` buffer, pixel (0, 0) at the
    bottom left, and their dot with ``fwd``."""
    ndc_x = (px.to(fwd.dtype) + 0.5) * (2.0 / width) - 1.0
    ndc_y = (py.to(fwd.dtype) + 0.5) * (2.0 / height) - 1.0
    plane_x = ndc_x * tan * aspect
    plane_y = ndc_y * tan
    d = fwd[:, None] + right[:, None] * plane_x + up[:, None] * plane_y
    d = d / torch.sqrt((d * d).sum(0))
    return d, (d * fwd[:, None]).sum(0)


def _pixel_rect(lo, hi, eye, fwd, right, up, tan, aspect, width, height):
    """The pixel rectangle ``(x0, x1, y0, y1)`` that the box's projection
    covers, two pixels wider on each side; the whole buffer where a
    corner lies behind the eye; None where it is off the buffer."""
    corners = np.array([[(lo, hi)[(c >> a) & 1][a] for a in range(3)] for c in range(8)])
    rel = corners - eye
    z = rel @ fwd
    if (z <= 1e-6).any():
        return 0, width, 0, height
    x = (rel @ right) / (z * tan * aspect)
    y = (rel @ up) / (z * tan)
    fx = (x + 1.0) * 0.5 * width - 0.5
    fy = (y + 1.0) * 0.5 * height - 0.5
    x0, x1 = max(int(math.floor(fx.min())) - 2, 0), min(int(math.ceil(fx.max())) + 3, width)
    y0, y1 = max(int(math.floor(fy.min())) - 2, 0), min(int(math.ceil(fy.max())) + 3, height)
    if x0 >= x1 or y0 >= y1:
        return None
    return x0, x1, y0, y1


def march_layers(pieces, camera, *, width: int, height: int, lut_rgba: Tensor,
                 log_t: Tensor, ref_distance: float, range_min: float,
                 inv_range: float, dtype=torch.float32, count_only: bool = False):
    """Every brick's layer over the pixels it covers: ``(pixel [M] int64,
    depth [M], rgba [M, 4])`` for the (brick, pixel) pairs whose layer is
    not empty, and the number of valid samples (window weight above 0);
    with ``count_only`` the layers are left empty."""
    dev = lut_rgba.device
    fwd64, right64, up64 = basis(camera.eye, camera.look_at, camera.up)
    eye64 = np.asarray(camera.eye, np.float64)
    tan64 = math.tan(math.radians(camera.fov_y_degrees) * 0.5)
    aspect64 = width / height
    as_t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev).to(dtype)  # noqa: E731
    fwd, right, up, eye = as_t(fwd64), as_t(right64), as_t(up64), as_t(eye64)
    tan, aspect = float(np.float32(tan64)), float(np.float32(aspect64))
    axis = int(np.argmax(np.abs(fwd64)))
    axes = [axis] + [a for a in range(3) if a != axis]
    table_max = lut_rgba.shape[0] - 1
    rgb_t, logt = lut_rgba[:, :3].to(dtype), log_t.to(dtype)
    inf = float("inf")
    pix_out, depth_out, rgba_out = [], [], []
    samples = 0
    for values, lo, hi in pieces:
        rect = _pixel_rect(np.asarray(lo, np.float64), np.asarray(hi, np.float64), eye64,
                           fwd64, right64, up64, tan64, aspect64, width, height)
        if rect is None:
            continue
        x0, x1, y0, y1 = rect
        py, px = torch.meshgrid(torch.arange(y0, y1, device=dev),
                                torch.arange(x0, x1, device=dev), indexing="ij")
        px, py = px.reshape(-1), py.reshape(-1)
        d, fwd_dot = pixel_rays(fwd, right, up, tan, aspect, px, py, width, height)
        shape = values.shape
        pmin = [float(np.float32(lo[a])) for a in axes]
        pmax = [float(np.float32(hi[a])) for a in axes]
        cell = [float(np.float32((hi[a] - lo[a]) / shape[a])) for a in axes]
        dims = [shape[a] for a in axes]
        dp = [d[a] for a in axes]
        ep = [float(eye[a]) for a in axes]
        tmin = torch.full_like(dp[0], -inf)
        tmax = torch.full_like(dp[0], inf)
        for a in range(3):
            par = dp[a].abs() < 1e-8
            inv = 1.0 / torch.where(par, torch.ones_like(dp[a]), dp[a])
            t1, t2 = (pmin[a] - ep[a]) * inv, (pmax[a] - ep[a]) * inv
            inside = pmin[a] <= ep[a] <= pmax[a]
            lo_t = torch.where(par, -inf if inside else inf, torch.minimum(t1, t2))
            hi_t = torch.where(par, inf if inside else -inf, torch.maximum(t1, t2))
            tmin, tmax = torch.maximum(tmin, lo_t), torch.minimum(tmax, hi_t)
        live = (tmax >= tmin) & (tmax > 0) & (dp[0].abs() > 1e-8)
        if not bool(live.any()):
            continue
        keep = live.nonzero().squeeze(1)
        px, py, fwd_dot, tmin, tmax = px[keep], py[keep], fwd_dot[keep], tmin[keep], tmax[keep]
        dp = [v[keep] for v in dp]
        inv_a = 1.0 / dp[0]
        dt = cell[0] * inv_a.abs()
        k = torch.arange(dims[0], device=dev)[None, :]
        k_eff = torch.where((dp[0] < 0)[:, None], dims[0] - 1 - k, k)  # front first
        z = pmin[0] + (k_eff.to(dtype) + 0.5) * cell[0]
        t = (z - ep[0]) * inv_a[:, None]
        w = (torch.minimum(t + 0.5 * dt[:, None], tmax[:, None])
             - torch.maximum(t - 0.5 * dt[:, None], tmin.clamp(min=0.0)[:, None])).clamp(min=0.0)
        valid = w > 0.0
        samples += int(valid.sum())
        if count_only:
            continue
        idx = [k_eff]
        for a in (1, 2):
            pos = ep[a] + dp[a][:, None] * t
            f = torch.floor((pos - pmin[a]) / cell[a]).clamp(-1.0, 1e9)
            idx.append(f.long().clamp(0, dims[a] - 1))
        world = [None] * 3
        for a, i in zip(axes, idx):
            world[a] = i
        flat = (world[0] * shape[1] + world[1]) * shape[2] + world[2]
        scalar = values.reshape(-1).to(dtype)[flat]
        n = ((scalar - range_min) * inv_range).clamp(0.0, 1.0)
        j = (n * table_max).long().clamp(0, table_max)
        a_k = torch.where(valid, 1.0 - torch.exp(w / ref_distance * logt[j]),
                          torch.zeros((), dtype=dtype, device=dev))
        trans = torch.cumprod(1.0 - a_k, dim=1)
        before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
        weight = a_k * before
        rgba = torch.cat([(rgb_t[j] * weight[..., None]).sum(1), weight.sum(1)[:, None]], 1)
        rgba = rgba.clamp(0.0, 1.0)
        depth = tmin * fwd_dot
        full = (rgba[:, 3] > 0) & torch.isfinite(depth)
        pix_out.append((py * width + px)[full])
        depth_out.append(depth[full])
        rgba_out.append(rgba[full])
    if not pix_out:
        return (torch.zeros(0, dtype=torch.long, device=dev),
                torch.zeros(0, dtype=dtype, device=dev),
                torch.zeros((0, 4), dtype=dtype, device=dev), samples)
    return torch.cat(pix_out), torch.cat(depth_out), torch.cat(rgba_out), samples


def fold(pixels: Tensor, depth: Tensor, rgba: Tensor, count: int) -> Tensor:
    """Front-to-back over blend of each pixel's layers by entry depth
    (ties: earlier brick in front): ``[count, 4]``."""
    out = torch.zeros((count, 4), dtype=rgba.dtype, device=rgba.device)
    if pixels.numel() == 0:
        return out
    order = torch.sort(depth, stable=True).indices
    order = order[torch.sort(pixels[order], stable=True).indices]
    pixels, rgba = pixels[order], rgba[order]
    first = torch.ones_like(pixels, dtype=torch.bool)
    first[1:] = pixels[1:] != pixels[:-1]
    pos = torch.arange(len(pixels), device=pixels.device)
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    rank = pos - start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        p = pixels[sel]
        out[p] = out[p] + rgba[sel] * (1.0 - out[p, 3:4])
    return out


def to_bytes(colour: Tensor) -> Tensor:
    """The byte codec: ``clamp(int(256 c), 0, 255)``, NaN as 0."""
    scaled = torch.nan_to_num(colour.float() * 256.0, nan=0.0).clamp(-1.0, 256.0)
    return scaled.to(torch.int32).clamp(0, 255).to(torch.uint8)


def render(pieces: Sequence, camera, *, width: int, height: int, sqrt_aa: int,
           lut_rgba: Tensor, log_t: Tensor, ref_distance: float, range_min: float,
           inv_range: float, dtype=torch.float32):
    """The output frame as bytes ``[height * width, 4]`` (row-major from
    the bottom row) and the valid samples its render buffer needed."""
    bw, bh = width * sqrt_aa, height * sqrt_aa
    pixels, depth, rgba, samples = march_layers(
        pieces, camera, width=bw, height=bh, lut_rgba=lut_rgba, log_t=log_t,
        ref_distance=ref_distance, range_min=range_min, inv_range=inv_range, dtype=dtype)
    frame = fold(pixels, depth, rgba, bw * bh).float()
    frame = frame.reshape(height, sqrt_aa, width, sqrt_aa, 4).mean(dim=(1, 3))
    return to_bytes(frame.reshape(-1, 4)), samples


def count_samples(pieces: Sequence, camera, *, width: int, height: int, sqrt_aa: int,
                  device) -> int:
    """The valid samples of one frame's render buffer: the slice march's
    work, whatever implements it."""
    dummy = torch.zeros((2, 4), device=device)
    return march_layers(pieces, camera, width=width * sqrt_aa, height=height * sqrt_aa,
                        lut_rgba=dummy, log_t=dummy[:, 3], ref_distance=1.0, range_min=0.0,
                        inv_range=1.0, count_only=True)[3]


def pieces_of(boxes: List, transform) -> list:
    """``(values, min_corner, max_corner)`` of each brick, its values put
    through ``transform``."""
    return [(transform(b.data), b.min_corner, b.max_corner) for b in boxes]
