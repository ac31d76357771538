"""The raymarch oracle: the reference's per-pixel ray cast in PyTorch.

The port of the JAX package's ``ops/raymarch.py``, an XLA program (not a
Pallas kernel) that re-implements ``Common/VolumePainter.cpp:735-922``:
per-pixel rays from the camera basis, the slab entry and exit of each
brick's box, a fixed-step front-to-back march with nearest-cell samples
classified through the transfer-function LUT, and the box-entry depth.
It is plain PyTorch on the tensors' device; no hand kernel replaces it.

The JAX program marches every (brick, pixel) pair of a bucket for a fixed
trip count under an activity mask.  Pixels are independent and a ray
that misses a brick's box accumulates nothing, so the port marches only
the pairs whose ray meets the box (the rest are background by
construction), at most ``PAIR_BUDGET`` pairs at a time, and stops a batch
once no ray of it can sample again: a ray whose distance has passed its
box exit, or whose opacity has reached 1, stays inactive for good.  None
of this changes a pixel.

Rounding follows the JAX program as XLA:CPU compiles it (read off its
optimised HLO and object code; ``numerics``):

* constants fold: ``fov * 0.5 * pi / 180`` is ``fov * f32(f32(pi / 2) *
  f32(1 / 180))``, ``/ width * 2`` is ``* 2 f32(1 / width)``, and the soft
  clip's division by its span is a multiply by the span's float32
  reciprocal;
* ``tan`` is the C library's ``tanf`` (``numerics.tanf``) and ``rsqrt``
  XLA's estimate plus two Newton steps (``numerics.rsqrt``);
* FMA sites: the pixel's NDC coordinate, both image-plane terms of the
  ray, the squared length, each sample position, the distance of the
  sample whose cell is read (but not of the one tested against the box),
  the soft clip's cubic and its rescale, each colour accumulation and the
  depth dot product.  Each ``fma`` call below names one.

``render_bucket_impl`` returns every brick's full-frame colours and
depths like the JAX function; ``render_bucket_into`` writes them into
rows of a layer stack instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..colormap import SOFT_CLIP_TOLERANCE
from ..transforms import _flush, apply_scalar_transform
from .march import f32
from .numerics import fma, rsqrt, tanf

Tensor = torch.Tensor

# (brick, pixel) pairs marched at once.  The march holds about 60 bytes of
# state and 200 bytes of temporaries per pair (float32 and int64), so a
# batch stays under about 2 GiB; the slab test's [bricks, pixels, 3]
# temporaries are cut to the same count.
PAIR_BUDGET = 1 << 23

# steps between two tests for rays that are done for good
_CHECK_EVERY = 8

# XLA folds ``fov * 0.5 * pi / 180`` into one multiply by this constant
_HALF_FOV_SCALE = f32(f32(0.5 * f32(math.pi)) * f32(f32(1.0) / f32(180.0)))


def half_fov_tan(fov_y_degrees: float) -> float:
    """``tan(fov / 2)`` of the vertical field of view in degrees, rounded
    as the JAX program computes it from a float32 argument."""
    return tanf(f32(f32(fov_y_degrees) * _HALF_FOV_SCALE))


def _ray_directions(width: int, height: int, tan_half_fov: float, aspect: float,
                    basis: Sequence[Tensor], fold_aspect: bool = False) -> Tensor:
    """Per-pixel normalised ray directions (VolumePainter.cpp:741-766),
    ``[H*W, 3]`` float32 on the basis' device.

    Pixel (0, 0) is the bottom-left of the image (the PPM/PNG writers emit
    rows bottom to top, SavePPM.cpp:25).  ``fold_aspect`` rounds the
    image-plane x term as ``ndc * (tan * aspect)``, the association XLA
    makes when the camera is a compile-time constant; otherwise it is
    ``(ndc * tan) * aspect``.  ``tan_half_fov`` may be a float32 tensor
    that carries a gradient (``diff``)."""
    forward, right, up = basis
    dev = forward.device
    tan = tan_half_fov if isinstance(tan_half_fov, Tensor) else f32(tan_half_fov)
    px = fma(torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
             f32(2.0 * f32(1.0 / width)), -1.0)  # FMA: NDC x
    py = fma(torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
             f32(2.0 * f32(1.0 / height)), -1.0)  # FMA: NDC y
    if fold_aspect:
        plane_x = px * f32(tan * f32(aspect))
    else:
        plane_x = (px * tan) * f32(aspect)
    plane_y = py * tan
    # FMA: forward + plane_x * right, then + plane_y * up
    d = fma(plane_x[None, :, None], right, forward)
    d = fma(plane_y[:, None, None], up, d).reshape(-1, 3)
    len_sq = fma(d[:, 2], d[:, 2], fma(d[:, 1], d[:, 1], d[:, 0] * d[:, 0]))
    positive = len_sq > 0.0
    inv_len = torch.where(positive, rsqrt(torch.where(positive, len_sq, 1.0)), 0.0)
    return d * inv_len[:, None]


def _slab_intersect(origin: Tensor, directions: Tensor, min_corner: Tensor,
                    max_corner: Tensor) -> Tuple[Tensor, Tensor]:
    """Slab AABB test with the reference's parallel-ray guard
    (VolumePainter.cpp:775-809) for ``[B, 3]`` boxes and ``[N, 3]``
    directions.  Returns ``(tmin, tmax)``, each ``[B, N]``."""
    parallel = torch.abs(directions) < f32(1e-8)
    inv = 1.0 / torch.where(parallel, 1.0, directions)
    t1 = (min_corner - origin)[:, None, :] * inv
    t2 = (max_corner - origin)[:, None, :] * inv
    inside_axis = ((origin >= min_corner) & (origin <= max_corner))[:, None, :]
    inf = float("inf")
    lo = torch.where(parallel, torch.where(inside_axis, -inf, inf),
                     torch.minimum(t1, t2))
    hi = torch.where(parallel, torch.where(inside_axis, inf, -inf),
                     torch.maximum(t1, t2))
    return lo.amax(dim=-1), hi.amin(dim=-1)


def _soft_tail(value: Tensor, clip_start: float) -> Tensor:
    """``transforms.saturate_soft_tail(value, clip_start, 1)`` as XLA
    compiles it inside the march: the division by the span is a multiply
    by its float32 reciprocal, and the cubic and the rescale are FMAs."""
    end = max(clip_start, 1.0)
    clamped = torch.clamp(_flush(value), 0.0, f32(end))
    if not (end > clip_start + SOFT_CLIP_TOLERANCE):
        return clamped
    start, span = f32(clip_start), f32(end - clip_start)
    m = (clamped - start) * float(np.float32(1.0) / np.float32(span))
    m2 = m * m
    smooth = fma(-m, m2, m + m2)  # FMA: (m + m^2) - m * m^2
    soft = fma(smooth, span, start)  # FMA: start + span * smooth
    inside = (clamped > start) & (clamped < f32(end))
    return _flush(torch.where(inside, soft, clamped))


def _as(x, dtype, dev) -> Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, Tensor) else x,
                           dtype=dtype).to(dev)


def render_bucket_into(
    out: Tensor,  # [L, H*W, 5] f32 layer stack, background where not hit
    layer_ids,  # [B] int: the row of ``out`` each brick writes
    data,  # [B, nx, ny, nz] float32 padded raw values
    min_corner,  # [B, 3] float32 world lower corners
    max_corner,  # [B, 3] float32 world upper corners
    cell_dims,  # [B, 3] int32 actual cell counts
    color_table,  # [B, size, 4] float32 per-brick LUT
    sample_distance,  # [B] float32 per-brick step
    eye,  # [3] float32
    basis_forward,  # [3] float32
    basis_right,  # [3] float32
    basis_up,  # [3] float32
    fov_y_degrees: float,
    range_min: float,
    inverse_range: float,
    positive_floor: float,
    normalization_min: float,
    inverse_normalization_span: float,
    *,
    width: int,
    height: int,
    num_steps: int,
    log_scale: bool,
    normalize: bool,
    clip_start: float,
    apply_clip: bool,
    fold_camera: bool = False,
) -> None:
    """March every brick of a bucket and write its RGBA + depth layer into
    ``out[layer_ids[b]]`` at the pixels its box covers (the other pixels
    of that row must already hold background: colour 0, depth +inf).
    Runs on ``out``'s device.  ``fold_camera`` rounds the half-angle
    tangent and the image plane as XLA does when the camera is a constant
    of the jitted program (the JAX sharded pipeline)."""
    dev = out.device
    f = torch.float32
    data = _as(data, f, dev)
    bmin, bmax = _as(min_corner, f, dev), _as(max_corner, f, dev)
    dims = _as(cell_dims, torch.int64, dev)
    luts = _as(color_table, f, dev)
    steps = _as(sample_distance, f, dev)
    layer_ids = _as(layer_ids, torch.int64, dev)
    eye_t = _as(eye, f, dev)
    basis = tuple(_as(v, f, dev) for v in (basis_forward, basis_right, basis_up))
    num_bricks = data.shape[0]
    num_pixels = width * height
    if num_bricks == 0 or num_pixels == 0:
        return
    aspect = f32(f32(width) / f32(max(height, 1)))
    tan = (_folded_half_fov_tan if fold_camera else half_fov_tan)(fov_y_degrees)
    directions = _ray_directions(width, height, tan, aspect, basis,
                                 fold_aspect=fold_camera)

    extent = bmax - bmin
    extent_mag = torch.sqrt(fma(extent[:, 2], extent[:, 2], fma(
        extent[:, 1], extent[:, 1], extent[:, 0] * extent[:, 0])))
    mesh_eps = extent_mag * f32(1e-4)
    cell = torch.where(dims > 0, extent / torch.clamp(dims.to(f), min=1.0), 1.0)
    dmax = torch.clamp(dims - 1, min=0)

    # hit (brick, pixel) pairs, bricks cut so the slab test's
    # [bricks, pixels, 3] temporaries stay within the budget
    per = max(1, PAIR_BUDGET // (3 * num_pixels))
    pair_b, pair_n, pair_tmin, pair_tmax = [], [], [], []
    for b0 in range(0, num_bricks, per):
        tmin, tmax = _slab_intersect(eye_t, directions, bmin[b0:b0 + per],
                                     bmax[b0:b0 + per])
        hb, hn = torch.nonzero(tmax >= tmin, as_tuple=True)
        pair_b.append(hb + b0)
        pair_n.append(hn)
        pair_tmin.append(tmin[hb, hn])
        pair_tmax.append(tmax[hb, hn])
        del tmin, tmax
    pair_b, pair_n = torch.cat(pair_b), torch.cat(pair_n)
    pair_tmin, pair_tmax = torch.cat(pair_tmin), torch.cat(pair_tmax)

    flat_data = data.reshape(-1)
    flat_lut = luts.reshape(-1, 4)
    table_max = luts.shape[1] - 1
    pad = data.shape[1:]
    params = dict(log_scale=log_scale, normalize=normalize,
                  positive_floor=positive_floor, normalization_min=normalization_min,
                  inverse_normalization_span=inverse_normalization_span)
    rmin, rinv = f32(range_min), f32(inverse_range)
    fwd = basis[0]
    for p0 in range(0, pair_b.shape[0], PAIR_BUDGET):
        b = pair_b[p0:p0 + PAIR_BUDGET]
        n = pair_n[p0:p0 + PAIR_BUDGET]
        tmin = pair_tmin[p0:p0 + PAIR_BUDGET]
        d0 = tmin + mesh_eps[b]
        d0 = torch.where(d0 < 0.0, mesh_eps[b], d0)
        accum = _march(b, directions[n], d0, pair_tmax[p0:p0 + PAIR_BUDGET],
                       eye_t, bmin, bmax, cell, dmax, steps, flat_data, pad,
                       flat_lut, table_max, num_steps, params, rmin, rinv,
                       clip_start if apply_clip else None)
        accum = torch.clamp(accum, 0.0, 1.0)
        rel = fma(directions[n], tmin[:, None], eye_t) - eye_t  # FMA: entry
        depth = fma(rel[:, 2], fwd[2], fma(rel[:, 1], fwd[1], rel[:, 0] * fwd[0]))
        depth = torch.where((accum[:, 3] > 0.0) & torch.isfinite(depth), depth,
                            float("inf"))
        out[layer_ids[b], n] = torch.cat([accum, depth[:, None]], dim=1)


def _folded_half_fov_tan(fov_y_degrees: float) -> float:
    """``tan(fov / 2)`` as XLA's constant folder evaluates it for a
    constant ``fov``: ``fov * 0.5 * pi / 180`` in float32, operation by
    operation, and the float32 nearest to its ``tan`` (not the C
    library's ``tanf``)."""
    angle = f32(f32(f32(f32(fov_y_degrees) * 0.5) * f32(math.pi)) / f32(180.0))
    return f32(math.tan(angle))


def _march(b, dirs, d0, tmax, eye, bmin, bmax, cell, dmax, steps, flat_data,
           pad, flat_lut, table_max, num_steps, params, rmin, rinv, clip_start):
    """The masked fixed-trip march of one batch of (brick, pixel) pairs;
    returns the unclipped ``[M, 4]`` accumulations."""
    count = b.shape[0]
    accum = torch.zeros((count, 4), dtype=torch.float32, device=b.device)
    live = torch.arange(count, device=b.device)  # rows still marching
    step = steps[b]
    lo, hi, size, top = bmin[b], bmax[b], cell[b], dmax[b]
    acc = accum
    base = b * (pad[0] * pad[1] * pad[2])
    lut_base = b * (table_max + 1)
    for k in range(num_steps):
        kf = float(k)
        dist = d0 + step * kf
        pos = fma(dirs, dist[:, None], eye)  # FMA: position tested
        inside = ((pos >= lo) & (pos <= hi)).all(dim=1)
        active = (dist < tmax) & inside & (acc[:, 3] < 1.0)
        dist_cell = fma(step, kf, d0)  # FMA: the sampled cell's distance
        pos = fma(dirs, dist_cell[:, None], eye)  # FMA: sample position
        idx = torch.minimum(torch.clamp(torch.floor((pos - lo) / size), min=0.0),
                            top.to(torch.float32)).to(torch.int64)
        raw = flat_data[base + (idx[:, 0] * pad[1] + idx[:, 1]) * pad[2] + idx[:, 2]]
        scalar = apply_scalar_transform(raw, **params)
        if clip_start is not None:
            scalar = _soft_tail(scalar, clip_start)
        normalized = torch.clamp((scalar - rmin) * rinv, 0.0, 1.0)
        lut_idx = torch.clamp((normalized * float(table_max)).to(torch.int64),
                              0, table_max)
        sample = flat_lut[lut_base + lut_idx]
        alpha = torch.where(active, sample[:, 3] * (1.0 - acc[:, 3]), 0.0)
        acc = torch.cat([fma(sample[:, :3], alpha[:, None], acc[:, :3]),  # FMA
                         (acc[:, 3] + alpha)[:, None]], dim=1)
        if (k + 1) % _CHECK_EVERY == 0 and k + 1 < num_steps:
            going = (d0 + step * float(k + 1) < tmax) & (acc[:, 3] < 1.0)
            kept = int(going.sum())
            if kept == going.shape[0]:
                continue
            accum[live] = acc
            if kept == 0:
                return accum
            if 2 * kept <= going.shape[0]:
                sel = torch.nonzero(going, as_tuple=True)[0]
                live, acc = live[sel], acc[sel]
                b, dirs, d0, tmax, step = b[sel], dirs[sel], d0[sel], tmax[sel], step[sel]
                lo, hi, size, top = lo[sel], hi[sel], size[sel], top[sel]
                base, lut_base = base[sel], lut_base[sel]
    accum[live] = acc
    return accum


def render_bucket_impl(
    data, min_corner, max_corner, cell_dims, color_table, sample_distance,
    eye, basis_forward, basis_right, basis_up,
    fov_y_degrees: float, range_min: float, inverse_range: float,
    positive_floor: float, normalization_min: float,
    inverse_normalization_span: float,
    *,
    width: int,
    height: int,
    num_steps: int,
    log_scale: bool,
    normalize: bool,
    clip_start: float,
    apply_clip: bool,
    fold_camera: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Render every brick of a bucket into full-frame RGBA + depth layers
    (arguments as ``render_bucket_into``; arrays may be NumPy or tensors).

    Returns ``(colors [B, H*W, 4], depths [B, H*W])`` on ``data``'s device
    (the CPU for a NumPy array); depth is the view-space distance of the
    box entry point, +inf where nothing accumulated
    (VolumePainter.cpp:912-921)."""
    dev = data.device if isinstance(data, Tensor) else torch.device("cpu")
    num_bricks = int(np.shape(data)[0])
    out = torch.zeros((num_bricks, width * height, 5), dtype=torch.float32,
                      device=dev)
    out[..., 4] = float("inf")
    render_bucket_into(
        out, torch.arange(num_bricks), data, min_corner, max_corner, cell_dims,
        color_table, sample_distance, eye, basis_forward, basis_right, basis_up,
        fov_y_degrees, range_min, inverse_range, positive_floor,
        normalization_min, inverse_normalization_span, width=width,
        height=height, num_steps=num_steps, log_scale=log_scale,
        normalize=normalize, clip_start=clip_start, apply_clip=apply_clip,
        fold_camera=fold_camera)
    return out[..., :4], out[..., 4]


def max_steps_for_bucket(
    min_corners: np.ndarray, max_corners: np.ndarray, sample_distances: np.ndarray
) -> int:
    """Static trip-count bound: longest box diagonal over the smallest step.

    Any ray's sampled path through a box is at most the box diagonal, so
    ``ceil(diag / step) + 2`` steps cover the reference's while loop
    (VolumePainter.cpp:837-900) for every pixel."""
    diag = np.linalg.norm(
        np.asarray(max_corners, dtype=np.float64)
        - np.asarray(min_corners, dtype=np.float64),
        axis=-1,
    )
    steps = np.where(
        sample_distances > 0, np.ceil(diag / np.maximum(sample_distances, 1e-30)), 0
    )
    if steps.size == 0:
        return 1
    return int(steps.max()) + 2
