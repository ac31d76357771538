"""The raymarch oracle: the reference's per-pixel ray cast in PyTorch.

The port of the JAX package's ``ops/raymarch.py``, an XLA program (not a
Pallas kernel) that re-implements ``Common/VolumePainter.cpp:735-922``:
per-pixel rays from the camera basis, the slab entry and exit of each
brick's box, a fixed-step front-to-back march with nearest-cell samples
classified through the transfer-function LUT, and the box-entry depth.

The JAX program marches every (brick, pixel) pair of a bucket for a fixed
trip count under an activity mask.  On the card ``render_bucket_into``
sets up the rays in PyTorch, classifies every cell of the bucket once
(``classify_cells``; the classification is elementwise in the raw value)
and launches one hand-written kernel, ``csrc/raymarch.cu``, in which a
thread marches one pair in registers and stops at the first step that can
never be active again.  Its plain version, ``render_bucket_into_reference``
(the CPU's route), marches only the pairs whose ray meets the box (the
rest are background by construction), at most ``PAIR_BUDGET`` pairs at a
time, and stops a batch once no ray of it can sample again: a ray whose
distance has passed its box exit, or whose opacity has reached 1, stays
inactive for good.  None of this changes a pixel.

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
whole rows of a layer stack instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..colormap import SOFT_CLIP_TOLERANCE
from ..transforms import _flush, apply_scalar_transform
from .march import f32, require
from .numerics import fma, rsqrt, tanf

Tensor = torch.Tensor

# (brick, pixel) pairs the plain version marches at once.  Its march holds
# about 60 bytes of state and 200 bytes of temporaries per pair (float32 and
# int64), so a batch stays under about 2 GiB; the slab test's [bricks,
# pixels, 3] temporaries and the cells classified at once
# (``classify_cells``) are cut to the same count.
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


class Bucket(NamedTuple):
    """A bucket on the march's device with its rays set up: what the plain
    march and the kernel read (the kernel reads classified cells instead
    of ``data``)."""
    layer_ids: Tensor  # [B] int64 row of the stack each brick writes
    data: Tensor  # [B, nx, ny, nz] float32 padded raw values
    bmin: Tensor  # [B, 3] float32
    bmax: Tensor  # [B, 3] float32
    luts: Tensor  # [B, size, 4] float32
    steps: Tensor  # [B] float32
    eye: Tensor  # [3] float32
    forward: Tensor  # [3] float32
    directions: Tensor  # [H*W, 3] float32
    mesh_eps: Tensor  # [B] float32
    cell: Tensor  # [B, 3] float32 cell size
    top: Tensor  # [B, 3] int32 last cell index


def _bucket(dev, layer_ids, data, min_corner, max_corner, cell_dims, color_table,
            sample_distance, eye, basis, fov_y_degrees, width, height,
            fold_camera) -> Optional[Bucket]:
    """Upload a bucket to ``dev`` and set up its rays (None when there is
    no brick or no pixel)."""
    f = torch.float32
    data = _as(data, f, dev)
    if data.shape[0] == 0 or width * height == 0:
        return None
    bmin, bmax = _as(min_corner, f, dev), _as(max_corner, f, dev)
    dims = _as(cell_dims, torch.int64, dev)
    basis = tuple(_as(v, f, dev) for v in basis)
    aspect = f32(f32(width) / f32(max(height, 1)))
    tan = (_folded_half_fov_tan if fold_camera else half_fov_tan)(fov_y_degrees)
    extent = bmax - bmin
    extent_mag = torch.sqrt(fma(extent[:, 2], extent[:, 2], fma(
        extent[:, 1], extent[:, 1], extent[:, 0] * extent[:, 0])))
    return Bucket(
        layer_ids=_as(layer_ids, torch.int64, dev), data=data, bmin=bmin,
        bmax=bmax, luts=_as(color_table, f, dev), steps=_as(sample_distance, f, dev),
        eye=_as(eye, f, dev), forward=basis[0],
        directions=_ray_directions(width, height, tan, aspect, basis,
                                   fold_aspect=fold_camera),
        mesh_eps=extent_mag * f32(1e-4),
        cell=torch.where(dims > 0, extent / torch.clamp(dims.to(f), min=1.0), 1.0),
        top=torch.clamp(dims - 1, min=0).to(torch.int32))


def _classifier(table_max: int, range_min: float, inverse_range: float,
                positive_floor: float, normalization_min: float,
                inverse_normalization_span: float, log_scale: bool,
                normalize: bool, clip_start: Optional[float]):
    """The sample classification, raw cell values to LUT entries (int64):
    the scalar transform, the soft tail clip (``clip_start`` None: off),
    the range normalisation and the LUT index.  Elementwise in the raw
    value, so classifying every cell once and gathering the entries gives
    the bits of classifying every sample."""
    params = dict(log_scale=log_scale, normalize=normalize,
                  positive_floor=positive_floor, normalization_min=normalization_min,
                  inverse_normalization_span=inverse_normalization_span)
    rmin, rinv = f32(range_min), f32(inverse_range)

    def classify(raw: Tensor) -> Tensor:
        scalar = apply_scalar_transform(raw, **params)
        if clip_start is not None:
            scalar = _soft_tail(scalar, clip_start)
        normalized = torch.clamp((scalar - rmin) * rinv, 0.0, 1.0)
        return torch.clamp((normalized * float(table_max)).to(torch.int64),
                           0, table_max)

    return classify


def classify_cells(data: Tensor, classify) -> Tensor:
    """The LUT entry of every cell of ``data`` ([B, nx, ny, nz]) as int32,
    by ``classify``, bricks cut so the temporaries stay within
    ``PAIR_BUDGET`` cells."""
    out = torch.empty(data.shape, dtype=torch.int32, device=data.device)
    per = max(1, PAIR_BUDGET // max(1, data[0].numel()))
    for b0 in range(0, data.shape[0], per):
        out[b0:b0 + per] = classify(data[b0:b0 + per])
    return out


def march_bucket(out: Tensor, bucket: Bucket, lut_index: Tensor,
                 num_steps: int) -> None:
    """Launch the march kernel (``csrc/raymarch.cu``) on ``out``'s current
    stream: every (brick, pixel) pair of ``bucket`` into row
    ``layer_ids[b]`` of the ``[L, H*W, 5]`` stack, background included,
    its cells classified into ``lut_index`` ([B, nx, ny, nz] int32 LUT
    entries, ``classify_cells``).  A failed build or launch raises.
    Counted in ``render_bucket_into.launches``."""
    dev = out.device
    num_bricks, num_pixels = lut_index.shape[0], bucket.directions.shape[0]
    if (out.dtype != torch.float32 or out.dim() != 3 or out.shape[1:] != (num_pixels, 5)
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 [L, {num_pixels}, 5] "
                         f"tensor, got {out.dtype} {tuple(out.shape)}")
    pad = tuple(lut_index.shape[1:])
    require(lut_index, "lut_index", torch.int32, (num_bricks,) + pad, dev)
    size = bucket.luts.shape[1] if bucket.luts.dim() == 3 else -1
    for name, dtype, shape in (
            ("layer_ids", torch.int64, (num_bricks,)),
            ("luts", torch.float32, (num_bricks, size, 4)),
            ("directions", torch.float32, (num_pixels, 3)),
            ("eye", torch.float32, (3,)), ("forward", torch.float32, (3,)),
            ("bmin", torch.float32, (num_bricks, 3)),
            ("bmax", torch.float32, (num_bricks, 3)),
            ("cell", torch.float32, (num_bricks, 3)),
            ("top", torch.int32, (num_bricks, 3)),
            ("steps", torch.float32, (num_bricks,)),
            ("mesh_eps", torch.float32, (num_bricks,))):
        require(getattr(bucket, name), name, dtype, shape, dev)
    if bucket.luts.data_ptr() % 16:
        raise ValueError("luts must be 16-byte aligned (float4 reads)")
    if math.prod(pad) >= 2 ** 31:
        raise ValueError(f"a brick of {pad} cells needs 64-bit cell offsets")
    if num_bricks == 0 or num_pixels == 0:
        return
    from . import _build

    lib = _build.load("raymarch")
    rc = lib.avr_raymarch_launch(
        bucket.directions.data_ptr(), bucket.eye.data_ptr(),
        bucket.forward.data_ptr(), bucket.bmin.data_ptr(), bucket.bmax.data_ptr(),
        bucket.cell.data_ptr(), bucket.top.data_ptr(), bucket.steps.data_ptr(),
        bucket.mesh_eps.data_ptr(), lut_index.data_ptr(), bucket.luts.data_ptr(),
        bucket.layer_ids.data_ptr(), out.data_ptr(), num_bricks, num_pixels,
        *pad, size, num_steps, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"raymarch kernel launch failed: CUDA error {rc}")
    render_bucket_into.launches += 1


def render_bucket_into(
    out: Tensor,  # [L, H*W, 5] f32 layer stack
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
    row ``out[layer_ids[b]]``, every pixel of it (background, colour 0 and
    depth +inf, where the brick draws nothing).  ``fold_camera`` rounds
    the half-angle tangent and the image plane as XLA does when the camera
    is a constant of the jitted program (the JAX sharded pipeline).

    On a CUDA ``out`` the ray set-up and the cells' classification run in
    PyTorch and one launch of the march kernel does the rest
    (``march_bucket``; a failed build or launch raises); on a CPU ``out``
    the plain version runs (``render_bucket_into_reference``).
    ``render_bucket_into.launches`` counts kernel launches."""
    if out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"render_bucket_into has no kernel for {out.device}")
    bucket = _bucket(out.device, layer_ids, data, min_corner, max_corner,
                     cell_dims, color_table, sample_distance, eye,
                     (basis_forward, basis_right, basis_up), fov_y_degrees,
                     width, height, fold_camera)
    if bucket is None:
        return
    classify = _classifier(bucket.luts.shape[1] - 1, range_min, inverse_range,
                           positive_floor, normalization_min,
                           inverse_normalization_span, log_scale, normalize,
                           clip_start if apply_clip else None)
    if out.device.type == "cpu":
        _march_reference(out, bucket, classify, num_steps)
        return
    march_bucket(out, bucket, classify_cells(bucket.data, classify), num_steps)


render_bucket_into.launches = 0


def render_bucket_into_reference(
    out: Tensor, layer_ids, data, min_corner, max_corner, cell_dims,
    color_table, sample_distance, eye, basis_forward, basis_right, basis_up,
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
    count_samples: bool = False,
) -> Optional[Tensor]:
    """The march kernel's plain version, on ``out``'s device (arguments as
    ``render_bucket_into``): the rows first take background, then the
    (brick, pixel) pairs whose ray meets the box march in batches of at
    most ``PAIR_BUDGET``, each sample classified where it is read.  With
    ``count_samples`` it returns the number of valid (active) samples, a
    0-dim int64 tensor (one more reduction a step), else None."""
    bucket = _bucket(out.device, layer_ids, data, min_corner, max_corner,
                     cell_dims, color_table, sample_distance, eye,
                     (basis_forward, basis_right, basis_up), fov_y_degrees,
                     width, height, fold_camera)
    samples = (torch.zeros((), dtype=torch.int64, device=out.device)
               if count_samples else None)
    if bucket is None:
        return samples
    classify = _classifier(bucket.luts.shape[1] - 1, range_min, inverse_range,
                           positive_floor, normalization_min,
                           inverse_normalization_span, log_scale, normalize,
                           clip_start if apply_clip else None)
    _march_reference(out, bucket, classify, num_steps, samples)
    return samples


def _march_reference(out: Tensor, bk: Bucket, classify, num_steps: int,
                     samples: Optional[Tensor] = None) -> None:
    """The plain march of a bucket into its rows; adds its valid samples
    to ``samples`` where given."""
    out[bk.layer_ids] = torch.tensor([0.0, 0.0, 0.0, 0.0, float("inf")],
                                     device=out.device)
    num_bricks, num_pixels = bk.data.shape[0], bk.directions.shape[0]
    # hit (brick, pixel) pairs, bricks cut so the slab test's
    # [bricks, pixels, 3] temporaries stay within the budget
    per = max(1, PAIR_BUDGET // (3 * num_pixels))
    pair_b, pair_n, pair_tmin, pair_tmax = [], [], [], []
    for b0 in range(0, num_bricks, per):
        tmin, tmax = _slab_intersect(bk.eye, bk.directions, bk.bmin[b0:b0 + per],
                                     bk.bmax[b0:b0 + per])
        hb, hn = torch.nonzero(tmax >= tmin, as_tuple=True)
        pair_b.append(hb + b0)
        pair_n.append(hn)
        pair_tmin.append(tmin[hb, hn])
        pair_tmax.append(tmax[hb, hn])
        del tmin, tmax
    pair_b, pair_n = torch.cat(pair_b), torch.cat(pair_n)
    pair_tmin, pair_tmax = torch.cat(pair_tmin), torch.cat(pair_tmax)

    flat_data = bk.data.reshape(-1)
    flat_lut = bk.luts.reshape(-1, 4)
    table_max = bk.luts.shape[1] - 1
    pad = bk.data.shape[1:]
    fwd, eye_t, mesh_eps = bk.forward, bk.eye, bk.mesh_eps
    for p0 in range(0, pair_b.shape[0], PAIR_BUDGET):
        b = pair_b[p0:p0 + PAIR_BUDGET]
        n = pair_n[p0:p0 + PAIR_BUDGET]
        tmin = pair_tmin[p0:p0 + PAIR_BUDGET]
        d0 = tmin + mesh_eps[b]
        d0 = torch.where(d0 < 0.0, mesh_eps[b], d0)
        accum = _march(b, bk.directions[n], d0, pair_tmax[p0:p0 + PAIR_BUDGET],
                       eye_t, bk.bmin, bk.bmax, bk.cell, bk.top, bk.steps,
                       flat_data, pad, flat_lut, table_max, num_steps,
                       classify, samples)
        accum = torch.clamp(accum, 0.0, 1.0)
        rel = fma(bk.directions[n], tmin[:, None], eye_t) - eye_t  # FMA: entry
        depth = fma(rel[:, 2], fwd[2], fma(rel[:, 1], fwd[1], rel[:, 0] * fwd[0]))
        depth = torch.where((accum[:, 3] > 0.0) & torch.isfinite(depth), depth,
                            float("inf"))
        out[bk.layer_ids[b], n] = torch.cat([accum, depth[:, None]], dim=1)


def _folded_half_fov_tan(fov_y_degrees: float) -> float:
    """``tan(fov / 2)`` as XLA's constant folder evaluates it for a
    constant ``fov``: ``fov * 0.5 * pi / 180`` in float32, operation by
    operation, and the float32 nearest to its ``tan`` (not the C
    library's ``tanf``)."""
    angle = f32(f32(f32(f32(fov_y_degrees) * 0.5) * f32(math.pi)) / f32(180.0))
    return f32(math.tan(angle))


def _march(b, dirs, d0, tmax, eye, bmin, bmax, cell, dmax, steps, flat_data,
           pad, flat_lut, table_max, num_steps, classify, samples=None):
    """The masked fixed-trip march of one batch of (brick, pixel) pairs
    over raw cell values ``flat_data``, which ``classify`` turns into LUT
    entries.  Returns the unclipped ``[M, 4]`` accumulations; adds the
    count of active samples to ``samples`` where given."""
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
        if samples is not None:
            samples += active.sum()
        dist_cell = fma(step, kf, d0)  # FMA: the sampled cell's distance
        pos = fma(dirs, dist_cell[:, None], eye)  # FMA: sample position
        idx = torch.minimum(torch.clamp(torch.floor((pos - lo) / size), min=0.0),
                            top.to(torch.float32)).to(torch.int64)
        raw = flat_data[base + (idx[:, 0] * pad[1] + idx[:, 1]) * pad[2] + idx[:, 2]]
        sample = flat_lut[lut_base + classify(raw)]
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
    out = torch.empty((num_bricks, width * height, 5), dtype=torch.float32,
                      device=dev)
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
