"""The differentiable path's march: a forward, a backward and a tangent
kernel, and their plain PyTorch versions, behind one autograd Function.

The JAX package's ``diff.render_layers_diff`` (its ``lax.scan`` over a
``jax.checkpoint``ed step, vmapped over the bricks) is one XLA program that
``jax.grad`` and ``jax.jvp`` differentiate.  Here the ray set-up stays in
PyTorch under autograd (``diff.render_layers_diff``) and the march is
``march``: a ``torch.autograd.Function`` over the raw ``[B, P, 4]``
accumulator of every (brick, pixel) pair.

* On the card each kernel walks a list of the (brick, pixel) pairs whose
  ray meets the brick (``diffmarch_pairs``, a launch of its own that also
  writes the misses' zero rows; the backward walks the forward's list).  The forward is ``diffmarch_forward``
  (``csrc/diffmarch.cu``, one thread a hit pair, stopping at the first
  step that can never be active again), the backward ``diffmarch_backward``
  (the exact reverse mode of the march, replayed from opacity checkpoints
  the forward keeps every ``CHECKPOINT_EVERY`` steps) and the forward-mode
  rule ``diffmarch_tangent`` (the forward kernel carrying a tangent beside
  each value, instantiated for the groups of fields that carry one: ``march``
  reads them off the dual level on the host, and the others' terms do not
  exist, as jax.jvp's symbolic zeros).  A failed
  build or launch raises: no input routes the card to the plain versions.
* On the CPU the same Function runs ``march_forward_reference`` (the step
  the eager loop ran, op for op), ``march_backward_reference`` (the same
  reverse recurrence as the backward kernel, vectorised over the pairs,
  walking the steps backwards over a saved per-step opacity) and
  ``march_tangent_reference`` (torch's forward mode through the plain
  forward).

Both devices therefore keep one ``[B, P, 4]`` accumulator (and, on the
card, the checkpoints) whatever ``remat`` says: the step's activations are
recomputed in the backward, never stored.

``march_pairs`` is the same march over a view's pair list (``Pairs``, one
``diffpairs_build`` launch a view on the card: the slab test, each hit's
first and last distance and the list), its rows a pair each: the kernels
above walk the list's runs (``diffmarch_forward_pairs``,
``diffmarch_backward_pairs``), and the plain versions march a brick at a
time (``march_pairs_forward_reference``, ``march_pairs_backward_reference``).

The gradients follow JAX's rules: ``jnp.clip`` and ``jnp.maximum`` give
half a gradient at a tie (``_clip_grad``), ``log`` gives ``g / x``.  No
gradient flows through the gate (hit, distance below the box exit, inside
the box, opacity below 1), and the backward never divides by a
transmittance: it replays each step's opacity exactly, so every gate
decision is the forward's own.
"""

from __future__ import annotations

import contextlib
import functools
import math
from types import SimpleNamespace
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch.autograd.function import once_differentiable

from ..colormap import SOFT_CLIP_TOLERANCE
from .march import f32, require
from .numerics import fma, log

Tensor = torch.Tensor

# steps between two opacity checkpoints of the forward kernel (the backward
# kernel's kSegment)
CHECKPOINT_EVERY = 16
# per-block sums the backward kernel writes: the step, the trilinear origin
# (3), the cell size (3), the eye (3) and the five transform scalars
PARTIALS = 15
_BACK_THREADS = 128  # hit pairs a block of the backward kernel
_GRID_BLOCKS = 4096  # blocks a march launch aims at (csrc/diffmarch.cu kGridBlocks)
_SHARED_BYTES = 232448  # what one block may use on Hopper
# the backward's static shared memory: a segment's opacities a thread, the
# block's sums
_BACK_STATIC_BYTES = (CHECKPOINT_EVERY * _BACK_THREADS + PARTIALS * _BACK_THREADS // 32) * 4


def _clip(x: Tensor, lo, hi) -> Tensor:
    """``jnp.clip``: half the gradient goes to ``x`` at a tie with a bound,
    as ``torch.maximum`` and ``torch.minimum`` split it."""
    return torch.minimum(torch.maximum(x, _like(lo, x)), _like(hi, x))


def _like(v, x: Tensor) -> Tensor:
    """``v`` as a 0-d tensor of ``x``'s dtype on its device."""
    return v if isinstance(v, Tensor) else _constant(v, x.dtype, x.device)


@functools.lru_cache(maxsize=256)
def _constant(v, dtype, device) -> Tensor:
    """A 0-d constant, made once per (value, dtype, device): the march
    takes a dozen a step, and each would be a launch.  Never written; made
    outside inference mode, so a later call with autograd can save it."""
    with torch.inference_mode(False):
        return torch.full((), v, dtype=dtype, device=device)


def _lerp(a: Tensor, b: Tensor, w: Tensor) -> Tensor:
    """``a * (1 - w) + b * w``."""
    return fma(a, 1.0 - w, b * w)  # FMA


def _clip_grad(x: Tensor, lo, hi) -> Tensor:
    """d ``_clip(x, lo, hi)`` / dx under ``torch.maximum`` and
    ``torch.minimum``'s rules (``jnp.clip``'s): 1 inside, half at a tie
    with a bound, 0 beyond it (1 for NaN, as those rules give)."""
    lo_t, hi_t = _like(lo, x), _like(hi, x)
    up = torch.where(x < lo_t, 0.0, torch.where(x == lo_t, 0.5, 1.0))
    y = torch.maximum(x, lo_t)
    return up * torch.where(y > hi_t, 0.0, torch.where(y == hi_t, 0.5, 1.0))


class MarchInputs(NamedTuple):
    """What the march reads, on one device.  The first ``DIFFERENTIABLE``
    fields carry gradients; the rest are gates and integer tables."""
    data: Tensor  # [B, nx, ny, nz] float32 padded raw values
    luts: Tensor  # [B, size, 4] float32 per-brick transfer function
    d0: Tensor  # [B, P] float32 first sample distance
    directions: Tensor  # [P, 3] float32 unit ray directions
    eye: Tensor  # [3] float32
    steps: Tensor  # [B] float32 per-brick step
    bmin: Tensor  # [B, 3] float32 trilinear origin (and the box's low corner)
    cell: Tensor  # [B, 3] float32 cell size
    scalars: Tensor  # [5] float32 range_min, inverse_range, positive_floor,
    #                  normalization_min, inverse_normalization_span
    tmax: Tensor  # [B, P] float32 box exit distance
    hit: Tensor  # [B, P] bool: the ray meets the box
    bmax: Tensor  # [B, 3] float32 the box's high corner
    top: Tensor  # [B, 3] int32 last valid cell index, max(dims - 1, 0)
    low: Tensor  # [B, 3] int32 last lerp start, max(dims - 2, 0)


DIFFERENTIABLE = 9


class MarchConfig(NamedTuple):
    """The march's static arguments (``render_layers_diff``'s)."""
    num_steps: int
    log_scale: bool
    normalize: bool
    apply_clip: bool
    clip_start: float


class Kept(NamedTuple):
    """What the forward kernel keeps for the backward kernel: the opacity
    checkpoints and the pair list it walked (``diffmarch_pairs``)."""
    checkpoints: Tensor  # [C, B, P] float32, C = checkpoint_count(cfg)
    pixels: Tensor  # [B, P] int32
    counts: Tensor  # [B] int32


def _soft(clip_start: float):
    """The soft tail's float32 constants ``(start, span, 1 / span, end)``,
    or None where the tail is a plain clamp."""
    end = max(clip_start, 1.0)
    if not (end > clip_start + SOFT_CLIP_TOLERANCE):
        return None
    return (f32(clip_start), f32(end - clip_start),
            float(np.float32(1.0) / np.float32(f32(end - clip_start))), f32(end))


def trilinear_terms(data: Tensor, top: Tensor, low: Tensor, origin: Tensor,
                    cell: Tensor, pos: Tensor) -> SimpleNamespace:
    """``diff.trilinear_sample`` with its intermediates: ``data`` ``[...,
    nx, ny, nz]``; ``top`` and ``low`` (int64: the last cell index and the
    last lerp start), ``origin`` and ``cell`` ``[..., 1, 3]``; ``pos``
    ``[..., N, 3]``.  ``.raw`` is the sample."""
    t = SimpleNamespace(top_f=top.to(torch.float32))
    t.rel = pos - origin
    t.h = t.rel / cell - 0.5
    t.f = _clip(t.h, 0.0, t.top_f)
    t.i0 = _clip(torch.floor(t.f).long(), 0, low)
    t.w = _clip(t.f - t.i0.to(torch.float32), 0.0, 1.0)
    i1 = torch.minimum(t.i0 + 1, top)
    pad_ny, pad_nz = data.shape[-2], data.shape[-1]
    x0, y0, z0 = t.i0.unbind(-1)
    dx, dy, dz = (i1 - t.i0).unbind(-1)
    base = (x0 * pad_ny + y0) * pad_nz + z0
    zeros = torch.zeros_like(base)
    ox = torch.stack([zeros, dx * (pad_ny * pad_nz)], dim=-1)
    oy = torch.stack([zeros, dy * pad_nz], dim=-1)
    oz = torch.stack([zeros, dz], dim=-1)
    # the 8 corners in one gather, [..., N, z, y, x]
    t.offset = (base[..., None, None, None] + oz[..., :, None, None]
                + oy[..., None, :, None] + ox[..., None, None, :])
    flat = data.reshape(*data.shape[:-3], -1)
    t.corners = torch.gather(flat, -1, t.offset.flatten(-4)).reshape(t.offset.shape)
    wx, wy, wz = t.w.unbind(-1)
    t.cx = _lerp(t.corners[..., 0], t.corners[..., 1], wx[..., None, None])
    t.cy = _lerp(t.cx[..., 0], t.cx[..., 1], wy[..., None])
    t.raw = _lerp(t.cy[..., 0], t.cy[..., 1], wz)
    return t


def transform_terms(raw: Tensor, log_scale: bool, normalize: bool, positive_floor,
                    normalization_min, inverse_normalization_span) -> SimpleNamespace:
    """``diff._scalar_transform`` with its intermediates; ``.value`` is the
    transformed value."""
    t = SimpleNamespace(finite=torch.isfinite(raw))
    t.value0 = torch.where(t.finite, raw, 0.0)
    value = t.value0
    if log_scale:
        t.positive = t.value0 > 0.0
        t.v1 = torch.where(t.positive, torch.maximum(t.value0, positive_floor),
                           positive_floor)
        value = log(t.v1)
    t.lv = value
    if normalize:
        t.q2 = (value - normalization_min) * inverse_normalization_span
        value = _clip(t.q2, 0.0, 1.0)
    t.value = value
    return t


def soft_tail_terms(value: Tensor, clip_start: float) -> SimpleNamespace:
    """``diff._soft_tail`` with its intermediates: ``.soft`` the tail's
    constants (None: a plain clamp), ``.scalar`` the result."""
    t = SimpleNamespace(soft=_soft(clip_start))
    clamped = _clip(value, 0.0, f32(max(clip_start, 1.0)))
    t.scalar = clamped
    if t.soft is not None:
        start, span, rspan, end = t.soft
        t.m = (clamped - start) * rspan
        m2 = t.m * t.m
        smooth = fma(-t.m, m2, t.m + m2)  # FMA: (m + m^2) - m * m^2
        soft = fma(smooth, span, start)  # FMA: start + span * smooth
        t.ins = (clamped > start) & (clamped < end)
        t.scalar = torch.where(t.ins, soft, clamped)
    return t


def lut_terms(lut: Tensor, normalized: Tensor) -> SimpleNamespace:
    """``diff.lut_lookup_linear`` with its intermediates: ``lut`` ``[...,
    size, 4]``, ``normalized`` ``[..., N]``.  ``.s`` is the sample."""
    t = SimpleNamespace(table_max=lut.shape[-2] - 1)
    t.u = _clip(normalized, 0.0, 1.0) * float(t.table_max)
    t.j0 = _clip(torch.floor(t.u).long(), 0, max(t.table_max - 1, 0))
    t.wl = _clip(t.u - t.j0.to(torch.float32), 0.0, 1.0)
    t.j1 = torch.minimum(t.j0 + 1, _like(t.table_max, t.j0))
    t.row0, t.row1 = (torch.gather(lut, -2, j[..., None].expand(*j.shape, lut.shape[-1]))
                      for j in (t.j0, t.j1))
    t.s = _lerp(t.row0, t.row1, t.wl[..., None])
    return t


def _step(m: MarchInputs, cfg: MarchConfig, k: float) -> SimpleNamespace:
    """Step ``k`` at every (brick, pixel) pair: the sample and the gate
    (less the opacity test), with every intermediate its derivatives read
    (the fields of ``trilinear_terms``, ``transform_terms``,
    ``soft_tail_terms`` and ``lut_terms``)."""
    st = SimpleNamespace()
    st.dist = m.d0 + m.steps[:, None] * k
    st.pos = fma(m.directions, st.dist[..., None], m.eye)  # FMA: eye + direction * distance
    lo, hi = m.bmin[:, None, :], m.bmax[:, None, :]
    st.gate = m.hit & (st.dist < m.tmax) & ((st.pos >= lo) & (st.pos <= hi)).all(dim=-1)
    vars(st).update(vars(trilinear_terms(m.data, m.top.long()[:, None, :],
                                         m.low.long()[:, None, :], lo,
                                         m.cell[:, None, :], st.pos)))
    rmin, rinv, floor, nmin, ninv = m.scalars.unbind()
    vars(st).update(vars(transform_terms(st.raw, cfg.log_scale, cfg.normalize, floor,
                                         nmin, ninv)))
    st.scalar, st.soft = st.value, None
    if cfg.apply_clip:
        vars(st).update(vars(soft_tail_terms(st.value, cfg.clip_start)))
    st.q = (st.scalar - rmin) * rinv
    st.n = _clip(st.q, 0.0, 1.0)
    vars(st).update(vars(lut_terms(m.luts, st.n)))
    return st


def march_forward_reference(m: MarchInputs, cfg: MarchConfig, trace: bool = False,
                            count_samples: bool = False):
    """The plain march: every step at every pair, gated, front to back
    (VolumePainter.cpp:837-900).  Returns the raw accumulator ``[B, P,
    4]``; with ``trace`` also the opacity before each step (a list of
    ``[B, P]``), with ``count_samples`` also the number of active steps (a
    0-d tensor: the valid samples)."""
    accum = torch.zeros((*m.d0.shape, 4), dtype=torch.float32, device=m.d0.device)
    before, samples = [], torch.zeros((), dtype=torch.int64, device=m.d0.device)
    for k in range(cfg.num_steps):
        st = _step(m, cfg, float(k))
        if trace:
            before.append(accum[..., 3])
        active = st.gate & (accum[..., 3] < 1.0)
        if count_samples:
            samples += active.sum()
        alpha = torch.where(active, st.s[..., 3] * (1.0 - accum[..., 3]), 0.0)
        accum = torch.cat([fma(st.s[..., :3], alpha[..., None],  # FMA
                               accum[..., :3]),
                           (accum[..., 3] + alpha)[..., None]], dim=-1)
    out = (accum,) + ((before,) if trace else ()) + ((samples,) if count_samples else ())
    return out if len(out) > 1 else accum


def march_backward_reference(m: MarchInputs, cfg: MarchConfig, grad: Tensor,
                             needs: Sequence[bool] = (True,) * DIFFERENTIABLE
                             ) -> List[Tensor]:
    """The reverse mode of the march, as the backward kernel computes it:
    the cotangent ``grad`` of the raw accumulator walked back over the
    steps, each step's opacity read from a forward sweep.  Returns the
    gradients of ``MarchInputs``' differentiable fields, in order (the data
    and LUT ones zero unless ``needs`` asks for them).

    For an active step, ``alpha = s.a (1 - A.a)``, ``A'.rgb = s.rgb alpha
    + A.rgb`` and ``A'.a = A.a + alpha``: the colour cotangent stays
    ``grad.rgb`` along the ray, ``g_alpha = lam.rgb . s.rgb + lam.a``,
    ``lam.a -= s.a g_alpha``, ``g_s.rgb = lam.rgb alpha`` and ``g_s.a =
    g_alpha (1 - A.a)``; ``g_s`` then goes back through the LUT lerp, the
    clips, the transform, the trilinear weights and corners, the position
    and the distance.  Inactive steps add nothing."""
    f, f64 = torch.float32, torch.float64
    _, before = march_forward_reference(m, cfg, trace=True)
    num_bricks, num_pixels = m.d0.shape
    rmin, rinv, floor, nmin, ninv = m.scalars.unbind()
    lam_rgb, lam_a = grad[..., :3], grad[..., 3]
    # float64 totals: a LUT entry takes millions of float32 terms at full
    # size, beyond what a float32 sum holds to 1e-4
    g_data = torch.zeros((num_bricks, m.data[0].numel()), dtype=f64, device=m.d0.device)
    g_luts = torch.zeros(m.luts.shape, dtype=f64, device=m.d0.device)
    g_d0, g_dirs, g_eye, g_steps, g_bmin, g_cell = (
        torch.zeros(t.shape, dtype=f64, device=m.d0.device)
        for t in (m.d0, m.directions, m.eye, m.steps, m.bmin, m.cell))
    g_sc = [torch.zeros((), dtype=f64, device=m.d0.device) for _ in range(5)]
    cell = m.cell[:, None, :]
    for k in reversed(range(cfg.num_steps)):
        st = _step(m, cfg, float(k))
        one_minus = 1.0 - before[k]
        active = st.gate & (before[k] < 1.0)

        def msum(x):
            return torch.where(active, x, 0.0).sum(dtype=f64)

        s = st.s
        alpha = s[..., 3] * one_minus
        g_alpha = (lam_rgb * s[..., :3]).sum(-1) + lam_a
        g_s = torch.where(active[..., None], torch.cat(
            [lam_rgb * alpha[..., None], (g_alpha * one_minus)[..., None]], dim=-1), 0.0)
        lam_a = torch.where(active, lam_a - s[..., 3] * g_alpha, lam_a)
        # the LUT lerp
        wl = st.wl[..., None]
        if needs[1]:
            g_luts.scatter_add_(1, st.j0[..., None].expand(-1, -1, 4),
                                (g_s * (1.0 - wl)).double())
            g_luts.scatter_add_(1, st.j1[..., None].expand(-1, -1, 4), (g_s * wl).double())
        g = (g_s * (st.row1 - st.row0)).sum(-1)
        g = g * _clip_grad(st.u - st.j0.to(f), 0.0, 1.0)
        g = g * float(st.table_max) * _clip_grad(st.n, 0.0, 1.0)
        g = g * _clip_grad(st.q, 0.0, 1.0)  # d / d((scalar - rmin) * rinv)
        g_sc[0] += msum(-(g * rinv))
        g_sc[1] += msum(g * (st.scalar - rmin))
        g = g * rinv
        if st.soft is not None:
            _, span, rspan, _ = st.soft
            g_sm = g * span
            g_m = g_sm * (1.0 - st.m * st.m) + g_sm * (1.0 - st.m) * (2.0 * st.m)
            g = torch.where(st.ins, g_m * rspan, g)
        if cfg.apply_clip:
            g = g * _clip_grad(st.value, 0.0, f32(max(cfg.clip_start, 1.0)))
        if cfg.normalize:
            g = g * _clip_grad(st.q2, 0.0, 1.0)
            g_sc[3] += msum(-(g * ninv))
            g_sc[4] += msum(g * (st.lv - nmin))
            g = g * ninv
        if cfg.log_scale:
            g = g / st.v1  # log's rule
            share = torch.where(st.value0 < floor, 0.0,
                                torch.where(st.value0 == floor, 0.5, 1.0))
            g_sc[2] += msum(torch.where(st.positive, g * (1.0 - share), g))
            g = torch.where(st.positive, g * share, 0.0)
        g = torch.where(st.finite & active, g, 0.0)
        # the trilinear weights and corners
        wx, wy, wz = st.w.unbind(-1)
        g_cy = torch.stack([g * (1.0 - wz), g * wz], dim=-1)
        g_wz = g * (st.cy[..., 1] - st.cy[..., 0])
        g_cx = g_cy[..., None] * torch.stack([1.0 - wy, wy], dim=-1)[..., None, :]
        g_wy = (g_cy * (st.cx[..., 1] - st.cx[..., 0])).sum(-1)
        if needs[0]:
            g_corner = g_cx[..., None] * torch.stack([1.0 - wx, wx], dim=-1)[..., None, None, :]
            g_data.scatter_add_(1, st.offset.flatten(1), g_corner.flatten(1).double())
        g_wx = (g_cx * (st.corners[..., 1] - st.corners[..., 0])).sum((-2, -1))
        g_h = torch.stack([g_wx, g_wy, g_wz], dim=-1)
        g_h = g_h * _clip_grad(st.f - st.i0.to(f), 0.0, 1.0)
        g_h = torch.where(active[..., None], g_h * _clip_grad(st.h, 0.0, st.top_f), 0.0)
        # h = (pos - bmin) / cell - 0.5, pos = fma(direction, dist, eye)
        g_pos = g_h / cell
        g_cell += (-(g_h * (st.rel / cell)) / cell).sum(1)
        g_bmin -= g_pos.sum(1)
        g_eye += g_pos.sum((0, 1))
        g_dirs += (g_pos * st.dist[..., None]).sum(0)
        g_dist = (g_pos * m.directions).sum(-1)
        g_d0 += g_dist
        g_steps += (g_dist * float(k)).sum(1)
    return [g.to(f) for g in (g_data.reshape(m.data.shape), g_luts, g_d0, g_dirs, g_eye,
                              g_steps, g_bmin, g_cell, torch.stack(g_sc))]


def march_tangent_reference(m: MarchInputs, cfg: MarchConfig,
                            tangents: Sequence[Optional[Tensor]]) -> Tensor:
    """Forward mode of the march (``jax.jvp``'s counterpart): the tangent
    of the raw accumulator for ``tangents`` of ``MarchInputs``'
    differentiable fields (None: a field that carries none, whose terms do
    not exist, as jax.jvp's symbolic zeros), by torch's forward mode
    through ``march_forward_reference``.  Inside the Function's ``jvp`` a
    dual level is already open (with forward gradients off), and this one
    runs in it."""
    open_level = fwAD._current_level >= 0
    with (contextlib.nullcontext() if open_level else fwAD.dual_level()), \
            fwAD._set_fwd_grad_enabled(True):
        duals = [t.detach() if d is None else fwAD.make_dual(t.detach(), d.to(t.device, t.dtype))
                 for t, d in zip(m[:DIFFERENTIABLE], tangents)]
        out = march_forward_reference(MarchInputs(*duals, *m[DIFFERENTIABLE:]), cfg)
        tangent = fwAD.unpack_dual(out).tangent
    return torch.zeros_like(out) if tangent is None else tangent


# ---- the kernels -----------------------------------------------------------


def _check(m: MarchInputs, pairs: Optional["Pairs"] = None) -> None:
    """Raise unless ``m`` is what the kernels take: contiguous tensors of
    the right types and shapes on one CUDA device; with ``pairs``, ``d0``
    and ``tmax`` a row a pair of the list (and ``hit`` unread)."""
    dev = m.data.device
    if m.data.dim() != 4 or m.luts.dim() != 3:
        raise ValueError("data must be [B, nx, ny, nz] and luts [B, size, 4]")
    num_bricks, num_pixels = m.luts.shape[0], m.directions.shape[0]
    rows = ((num_bricks, num_pixels) if pairs is None else (pairs.brick.shape[0],))
    size = m.luts.shape[1]
    f, i = torch.float32, torch.int32
    for name, dtype, shape in (
            ("data", f, (num_bricks,) + tuple(m.data.shape[1:])),
            ("luts", f, (num_bricks, size, 4)), ("d0", f, rows),
            ("directions", f, (num_pixels, 3)), ("eye", f, (3,)),
            ("steps", f, (num_bricks,)), ("bmin", f, (num_bricks, 3)),
            ("cell", f, (num_bricks, 3)), ("scalars", f, (5,)),
            ("tmax", f, rows), ("bmax", f, (num_bricks, 3)), ("top", i, (num_bricks, 3)),
            ("low", i, (num_bricks, 3))) + (
            (("hit", torch.bool, (num_bricks, num_pixels)),) if pairs is None else ()):
        require(getattr(m, name), name, dtype, shape, dev)
    if pairs is not None:
        tiles = pairs.run_cnt.shape[1]
        for name, shape in (("brick", rows), ("pixel", rows), ("run_off", (num_bricks, tiles)),
                            ("run_cnt", (num_bricks, tiles)), ("brick_count", (num_bricks,))):
            require(getattr(pairs, name), name, i, shape, dev)
    if size < 1 or m.luts.data_ptr() % 16:
        raise ValueError("luts must hold an entry and be 16-byte aligned (float4 reads)")
    if math.prod(m.data.shape[1:]) >= 2 ** 31:
        raise ValueError(f"a brick of {tuple(m.data.shape[1:])} cells needs 64-bit "
                         "cell offsets")
    if num_bricks > 65535:
        raise ValueError(f"{num_bricks} bricks exceed the grid's 65535 rows")
    if size * 32 + _BACK_STATIC_BYTES > _SHARED_BYTES:  # the backward's float64 LUT sums
        raise ValueError(f"a {size}-entry LUT's gradient does not fit in shared memory")


def _launch_args(m: MarchInputs, cfg: MarchConfig) -> tuple:
    """The C entry points' common arguments after the pointers."""
    soft = _soft(cfg.clip_start) if cfg.apply_clip else None
    flags = (int(cfg.log_scale) | int(cfg.normalize) << 1 | int(cfg.apply_clip) << 2
             | int(soft is not None) << 3)
    start, span, rspan, _ = soft if soft is not None else (0.0, 1.0, 1.0, 0.0)
    end = f32(max(cfg.clip_start, 1.0))  # the clamp's bound, with or without the tail
    return (m.luts.shape[0], m.directions.shape[0], *m.data.shape[1:], m.luts.shape[1],
            cfg.num_steps, flags, start, span, rspan, end)


def _dense_walk(m: MarchInputs, pixels: Tensor, counts: Tensor) -> tuple:
    """The march kernels' walk over dense rows: the list, its counts, no
    pair rows, and the checkpoints' stride B * P."""
    return (pixels.data_ptr(), counts.data_ptr(), None, None, None, None, 0, m.hit.numel())


def _pair_walk(pairs: "Pairs") -> tuple:
    """The march kernels' walk over a pair list's rows."""
    return (None, None, pairs.run_off.data_ptr(), pairs.run_cnt.data_ptr(),
            pairs.brick_count.data_ptr(), pairs.pixel.data_ptr(), pairs.run_cnt.shape[1],
            pairs.brick.shape[0])


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(rc: int, which: str) -> None:
    if rc != 0:
        raise RuntimeError(f"diffmarch {which} kernel launch failed: CUDA error {rc}")


def checkpoint_count(cfg: MarchConfig) -> int:
    """Opacity checkpoints the forward kernel keeps a pair."""
    return -(-cfg.num_steps // CHECKPOINT_EVERY)


def hit_pairs_reference(hit: Tensor):
    """Each brick's hit pairs: ``(pixels [B, P] int32, counts [B] int32)``,
    brick b's hits the pixels ``pixels[b, :counts[b]]`` in pixel order (the
    rest of a row is -1)."""
    num_bricks, num_pixels = hit.shape
    counts = hit.sum(1, dtype=torch.int32)
    order = torch.argsort((~hit).to(torch.int8), dim=1, stable=True).to(torch.int32)
    index = torch.arange(num_pixels, device=hit.device)
    return torch.where(index < counts[:, None], order, -1), counts


def diffmarch_pairs(hit: Tensor, zero_rows: Optional[Tensor] = None):
    """Each brick's hit pairs, the list the march kernels walk: ``(pixels
    [B, P] int32, counts [B] int32)``, brick b's hits the pixels
    ``pixels[b, :counts[b]]``, and with ``zero_rows`` ([B, P, 4] float32)
    the zero row of every pair that misses written there.  A CUDA ``hit``
    launches the pair-list kernel (``csrc/diffmarch.cu``: each of its
    blocks' hits in pixel order, the blocks in the order they take their
    offsets; the rest of a row unwritten), counted in
    ``diffmarch_pairs.launches``, with no read of a device value; a CPU
    ``hit`` runs ``hit_pairs_reference``."""
    dev = hit.device
    if dev.type == "cpu":
        if zero_rows is not None:
            zero_rows.masked_fill_(~hit[..., None], 0.0)
        return hit_pairs_reference(hit)
    if dev.type != "cuda":
        raise ValueError(f"diffmarch_pairs has no kernel for {dev}")
    num_bricks, num_pixels = hit.shape
    require(hit, "hit", torch.bool, (num_bricks, num_pixels), dev)
    if zero_rows is not None:
        require(zero_rows, "zero_rows", torch.float32, (num_bricks, num_pixels, 4), dev)
    pixels = torch.empty((num_bricks, num_pixels), dtype=torch.int32, device=dev)
    counts = torch.zeros(num_bricks, dtype=torch.int32, device=dev)
    if pixels.numel() == 0:
        return pixels, counts
    from . import _build

    _raise(_build.load("diffmarch").avr_diffmarch_pairs_launch(
        hit.data_ptr(), pixels.data_ptr(), counts.data_ptr(),
        None if zero_rows is None else zero_rows.data_ptr(), num_bricks, num_pixels,
        _stream(dev)), "pair list")
    diffmarch_pairs.launches += 1
    return pixels, counts


diffmarch_pairs.launches = 0


def diffmarch_forward(m: MarchInputs, cfg: MarchConfig, keep: bool = False):
    """The raw accumulator ``[B, P, 4]`` of the march, and with ``keep``
    on the card what the backward kernel replays from (``Kept``: the
    opacity checkpoints ``[C, B, P]``, none for a pair that misses, and the
    pair list; None otherwise).  A CUDA
    ``m`` launches the pair list (``diffmarch_pairs``, which writes the
    misses' zero rows) and the forward kernel (``csrc/diffmarch.cu``, a
    thread a hit pair) on the current stream, counted in
    ``diffmarch_forward.launches``; a CPU ``m`` runs
    ``march_forward_reference``."""
    dev = m.data.device
    if dev.type == "cpu":
        return march_forward_reference(m, cfg), None
    if dev.type != "cuda":
        raise ValueError(f"diffmarch_forward has no kernel for {dev}")
    _check(m)
    num_bricks, num_pixels = m.d0.shape
    accum = torch.empty((num_bricks, num_pixels, 4), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((checkpoint_count(cfg), num_bricks, num_pixels),
                        dtype=torch.float32, device=dev) if keep else None)
    if accum.numel() == 0:  # an empty list, no launch
        return accum, None if ckpt is None else Kept(ckpt, *diffmarch_pairs(m.hit))
    from . import _build

    pixels, counts = diffmarch_pairs(m.hit, accum)
    lib = _build.load("diffmarch")
    _raise(lib.avr_diffmarch_forward_launch(
        *(t.data_ptr() for t in m), *_dense_walk(m, pixels, counts), accum.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(), *_launch_args(m, cfg), _stream(dev)),
        "forward")
    diffmarch_forward.launches += 1
    return accum, None if ckpt is None else Kept(ckpt, pixels, counts)


diffmarch_forward.launches = 0


def diffmarch_tangent(m: MarchInputs, cfg: MarchConfig,
                      tangents: Sequence[Optional[Tensor]]) -> Tensor:
    """The tangent ``[B, P, 4]`` of the raw accumulator for ``tangents``
    (one a differentiable field of ``MarchInputs``, None where the field
    carries none).  A CUDA ``m`` launches the pair list
    (``diffmarch_pairs``, the misses' zero rows) and the forward kernel's
    tangent instantiation for the groups of fields given (data, LUT, the
    ray and box geometry, the scalars), counted in
    ``diffmarch_tangent.launches``; with no field given the tangent is 0
    and nothing launches.  A CPU ``m`` runs ``march_tangent_reference``."""
    dev = m.data.device
    if dev.type == "cpu":
        return march_tangent_reference(m, cfg, tangents)
    if dev.type != "cuda":
        raise ValueError(f"diffmarch_tangent has no kernel for {dev}")
    _check(m)
    tangents = [None if t is None else t.to(dev, torch.float32).contiguous()
                for t in tangents]
    for name, t, ref in zip(MarchInputs._fields, tangents, m):
        if t is not None:
            require(t, f"{name} tangent", torch.float32, tuple(ref.shape), dev)
    if tangents[1] is not None and tangents[1].data_ptr() % 16:
        raise ValueError("the LUT tangent must be 16-byte aligned (float4 reads)")
    if all(t is None for t in tangents):
        return torch.zeros((*m.d0.shape, 4), dtype=torch.float32, device=dev)
    out_t = torch.empty((*m.d0.shape, 4), dtype=torch.float32, device=dev)
    if out_t.numel() == 0:
        return out_t
    from . import _build

    pixels, counts = diffmarch_pairs(m.hit, out_t)
    lib = _build.load("diffmarch")
    _raise(lib.avr_diffmarch_tangent_launch(
        *(t.data_ptr() for t in m), pixels.data_ptr(), counts.data_ptr(),
        *(None if t is None else t.data_ptr() for t in tangents), None, out_t.data_ptr(),
        *_launch_args(m, cfg), _stream(dev)), "tangent")
    diffmarch_tangent.launches += 1
    return out_t


diffmarch_tangent.launches = 0


def diffmarch_backward(m: MarchInputs, cfg: MarchConfig, grad: Tensor,
                       kept: Optional[Kept],
                       needs: Sequence[bool] = (True,) * DIFFERENTIABLE) -> List[Tensor]:
    """The gradients of ``MarchInputs``' differentiable fields for the
    cotangent ``grad`` ``[B, P, 4]`` of the raw accumulator (the data and
    LUT ones zero unless ``needs`` asks for them).  A CUDA ``m`` launches
    the backward kernel on the current stream over the forward's pair
    list, a warp's 32 hit pairs walked back in step from its checkpoints
    (``kept``), counted in ``diffmarch_backward.launches``:
    data and LUT gradients by atomic adds of each run of neighbouring lanes
    with one cell or one LUT row, each block's per-brick sums written apart
    and added here, allocations through the caching allocator and no read
    of a device value (a CUDA graph can capture it).
    A CPU ``m`` runs ``march_backward_reference``."""
    dev = m.data.device
    if dev.type == "cpu":
        return march_backward_reference(m, cfg, grad, needs)
    if dev.type != "cuda":
        raise ValueError(f"diffmarch_backward has no kernel for {dev}")
    _check(m)
    num_bricks, num_pixels = m.d0.shape
    grad = grad.to(dev, torch.float32).contiguous()
    require(grad, "grad", torch.float32, (num_bricks, num_pixels, 4), dev)
    if kept is None:
        raise ValueError("the backward kernel needs the forward's checkpoints and "
                         "pair list (diffmarch_forward(..., keep=True))")
    require(kept.checkpoints, "checkpoints", torch.float32,
            (checkpoint_count(cfg), num_bricks, num_pixels), dev)
    require(kept.pixels, "pixels", torch.int32, (num_bricks, num_pixels), dev)
    require(kept.counts, "counts", torch.int32, (num_bricks,), dev)
    f = torch.float32
    # a row of blocks a brick striding over its hit pairs, about
    # _GRID_BLOCKS in all; each block writes its sums apart
    blocks = max(1, min(-(-num_pixels // _BACK_THREADS), -(-_GRID_BLOCKS // num_bricks)))
    g_data = torch.zeros_like(m.data)
    g_luts = torch.zeros(m.luts.shape, dtype=torch.float64, device=dev)
    g_d0 = torch.zeros_like(m.d0)
    g_dirs = torch.zeros_like(m.directions)
    partial = torch.zeros((num_bricks, blocks, PARTIALS), dtype=f, device=dev)
    if g_d0.numel():
        from . import _build

        lib = _build.load("diffmarch")
        _raise(lib.avr_diffmarch_backward_launch(
            *(t.data_ptr() for t in m), *_dense_walk(m, kept.pixels, kept.counts),
            grad.data_ptr(), kept.checkpoints.data_ptr(),
            g_data.data_ptr() if needs[0] else None,
            g_luts.data_ptr() if needs[1] else None, g_d0.data_ptr(), g_dirs.data_ptr(),
            partial.data_ptr(), blocks, *_launch_args(m, cfg), _stream(dev)), "backward")
        diffmarch_backward.launches += 1
    part = partial.sum(1)
    return [g_data, g_luts.float(), g_d0, g_dirs, part[:, 7:10].sum(0), part[:, 0],
            part[:, 1:4], part[:, 4:7], part[:, 10:15].sum(0)]


diffmarch_backward.launches = 0


class _March(torch.autograd.Function):
    """The march as one autograd node: forward, backward and jvp each a
    kernel on the card and a plain version on the CPU."""

    @staticmethod
    def forward(ctx, cfg, keep, carried, *tensors):
        m = MarchInputs(*tensors)
        accum, kept = diffmarch_forward(m, cfg, keep)
        ctx.cfg, ctx.carried = cfg, carried
        ctx.save_for_backward(*m, *(() if kept is None else kept))
        ctx.save_for_forward(*m)
        return accum

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        n = len(MarchInputs._fields)
        kept = Kept(*saved[n:]) if len(saved) > n else None
        needs = ctx.needs_input_grad[3:3 + DIFFERENTIABLE]
        grads = diffmarch_backward(MarchInputs(*saved[:n]), ctx.cfg, grad, kept, needs)
        return (None, None, None, *(g if need else None for g, need in zip(grads, needs)),
                *(None,) * (len(MarchInputs._fields) - DIFFERENTIABLE))

    @staticmethod
    def jvp(ctx, _cfg, _keep, _carried, *tangents):
        # autograd hands zeros for a float input that carries no tangent:
        # those fields go as None, so their terms do not exist
        return diffmarch_tangent(MarchInputs(*ctx.saved_tensors), ctx.cfg,
                                 [t if c else None for t, c in zip(tangents, ctx.carried)])


def march(m: MarchInputs, cfg: MarchConfig) -> Tensor:
    """The raw accumulator ``[B, P, 4]`` of the march, differentiable in
    reverse and forward mode in ``m``'s first ``DIFFERENTIABLE`` fields.
    The forward keeps the backward kernel's checkpoints only when reverse
    mode will differentiate it; under forward mode the tangent takes only
    the fields that carry one at the current level.  Both are host facts:
    nothing reads the device."""
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in m[:DIFFERENTIABLE])
    carried = ((True,) * DIFFERENTIABLE if fwAD._current_level < 0 else
               tuple(fwAD.unpack_dual(t).tangent is not None for t in m[:DIFFERENTIABLE]))
    return _March.apply(cfg, keep, carried, *m)


# ---- the pair list: rows for the hit (brick, pixel) pairs alone -------------


class Pairs(NamedTuple):
    """One view's (brick, pixel) pairs whose ray meets the brick, as
    ``diffpairs_build`` lays them out: the rows of the march over pairs
    (``march_pairs``) and of the pair fold (``composite.fold_pairs``).  The
    buffers hold ``N`` pairs (the list's capacity); the first ``total`` of
    the indices ``run_off`` and ``fold_index`` name hold a pair each, the
    rest is never read.

    Pairs lie brick-major within each tile of ``tile_pixels(P)``
    neighbouring pixels: one run a brick the tile meets, in fold order,
    each run in pixel order (the tiles' own order is the order they
    finished).  Pixel p's pairs in fold order, front first, are
    ``fold_index[pixel_start[p] + s]`` for s below ``pixel_count[p]``."""
    brick: Tensor  # [N] int32
    pixel: Tensor  # [N] int32
    d0: Tensor  # [N] float32 first sample distance (no gradient)
    tmax: Tensor  # [N] float32 box exit distance
    fold_index: Tensor  # [N] int32 pairs by pixel, then fold order
    pixel_start: Tensor  # [P] int32
    pixel_count: Tensor  # [P] int32; -1 where the list overflowed its capacity
    run_off: Tensor  # [B, T] int32 first pair of brick b in tile t (0 for an empty run)
    run_cnt: Tensor  # [B, T] int32
    brick_count: Tensor  # [B] int32
    total: Tensor  # [1] int64 the view's pairs (more than N where the list overflowed)


_BUILD_THREADS = 256  # pixels a row of the build's tile (csrc/diffmarch.cu kBuildThreads)
_BUILD_ROWS = 4  # rows a tile at most (kBuildRows)
_MAX_TILES = 8192  # the march kernels scan a brick's runs in shared memory
# pairs the list of a (device, bricks, pixels) holds: the most a view has
# needed, so that a CUDA graph captured after eager calls fits every view
_capacity: dict = {}


def tile_pixels(num_pixels: int) -> int:
    """Pixels a tile of the pair list: rows of 256 neighbouring pixels, as
    few as keep the tiles at most ``_MAX_TILES``."""
    rows = max(1, -(-num_pixels // (_BUILD_THREADS * _MAX_TILES)))
    if rows > _BUILD_ROWS:
        raise ValueError(f"{num_pixels} pixels exceed the pair list's "
                         f"{_BUILD_THREADS * _BUILD_ROWS * _MAX_TILES}")
    return _BUILD_THREADS * rows


def _order_check(order: Tensor, num_bricks: int) -> None:
    if order.shape != (num_bricks,):
        raise ValueError(f"order has shape {tuple(order.shape)}, expected ({num_bricks},)")
    if sorted(order.tolist()) != list(range(num_bricks)):
        raise ValueError(f"order {order.tolist()} is not a permutation of the "
                         f"{num_bricks} bricks")


def diffpairs_build_reference(eye: Tensor, directions: Tensor, bmin: Tensor, bmax: Tensor,
                              eps: Tensor, order: Tensor) -> Pairs:
    """The pair list in plain PyTorch: ``raymarch._slab_intersect`` over
    every (brick, pixel) pair, the hits' first distance ``d0`` as
    ``diff.render_layers_diff`` forms it (``tmin + eps``, ``eps`` where
    that is negative), laid out as the kernel lays it out with the tiles in
    pixel order; the capacity is the pair count.  ``order`` [B] int64, a
    permutation (else ``ValueError``)."""
    from .raymarch import _slab_intersect

    num_bricks, num_pixels = bmin.shape[0], directions.shape[0]
    dev = directions.device
    order = order.to(dev).long()
    _order_check(order, num_bricks)
    tmin, tmax = _slab_intersect(eye, directions, bmin, bmax)
    hit = tmax >= tmin
    d0 = tmin + eps[:, None]
    d0 = torch.where(d0 < 0.0, eps[:, None], d0)
    tile = tile_pixels(num_pixels)
    tiles = -(-num_pixels // tile)
    ranks, pix = hit[order].nonzero(as_tuple=True)
    tile_of = pix // tile
    # brick-major within each tile, in fold order, each run in pixel order
    first = torch.argsort((tile_of * num_bricks + ranks) * num_pixels + pix)
    ranks, pix, tile_of = ranks[first], pix[first], tile_of[first]
    brick = order[ranks]
    i32 = torch.int32
    total = brick.shape[0]
    runs = torch.zeros((num_bricks, tiles), dtype=torch.int64, device=dev)
    runs.index_put_((brick, tile_of), torch.ones_like(brick), accumulate=True)
    run_off = torch.zeros((num_bricks * tiles,), dtype=torch.int64, device=dev)
    run_off.scatter_reduce_(0, brick * tiles + tile_of, torch.arange(total, device=dev),
                            "amin", include_self=False)
    counts = hit.sum(0)
    return Pairs(
        brick=brick.to(i32), pixel=pix.to(i32), d0=d0[brick, pix], tmax=tmax[brick, pix],
        fold_index=torch.argsort(pix * num_bricks + ranks).to(i32),
        pixel_start=(torch.cumsum(counts, 0) - counts).to(i32), pixel_count=counts.to(i32),
        run_off=run_off.reshape(num_bricks, tiles).to(i32), run_cnt=runs.to(i32),
        brick_count=torch.bincount(brick, minlength=num_bricks).to(i32),
        total=torch.full((1,), total, dtype=torch.int64, device=dev))


def _build_launch(eye, directions, bmin, bmax, eps, order, capacity: int) -> Pairs:
    from . import _build

    dev = directions.device
    num_bricks, num_pixels = bmin.shape[0], directions.shape[0]
    tile = tile_pixels(num_pixels)
    tiles = -(-num_pixels // tile)
    i32 = torch.int32
    n = max(capacity, 1)
    zeros = torch.zeros(2 + num_bricks, dtype=i32, device=dev)  # total (int64), brick counts
    pairs = Pairs(
        brick=torch.empty(n, dtype=i32, device=dev), pixel=torch.empty(n, dtype=i32, device=dev),
        d0=torch.empty(n, dtype=torch.float32, device=dev),
        tmax=torch.empty(n, dtype=torch.float32, device=dev),
        fold_index=torch.empty(n, dtype=i32, device=dev),
        pixel_start=torch.empty(num_pixels, dtype=i32, device=dev),
        pixel_count=torch.empty(num_pixels, dtype=i32, device=dev),
        run_off=torch.empty((num_bricks, tiles), dtype=i32, device=dev),
        run_cnt=torch.empty((num_bricks, tiles), dtype=i32, device=dev),
        brick_count=zeros[2:], total=zeros[:2].view(torch.int64))
    _raise(_build.load("diffmarch").avr_diffpairs_build_launch(
        eye.data_ptr(), directions.data_ptr(), bmin.data_ptr(), bmax.data_ptr(), eps.data_ptr(),
        order.data_ptr(), num_bricks, num_pixels, tile // _BUILD_THREADS, capacity,
        pairs.total.data_ptr(), pairs.brick_count.data_ptr(), pairs.brick.data_ptr(),
        pairs.pixel.data_ptr(), pairs.d0.data_ptr(), pairs.tmax.data_ptr(),
        pairs.fold_index.data_ptr(), pairs.pixel_start.data_ptr(), pairs.pixel_count.data_ptr(),
        pairs.run_off.data_ptr(), pairs.run_cnt.data_ptr(), _stream(dev)), "pair build")
    _BUILD_COUNTER.launches += 1
    return pairs


def diffpairs_build(eye: Tensor, directions: Tensor, bmin: Tensor, bmax: Tensor, eps: Tensor,
                    order: Tensor) -> Pairs:
    """One view's pair list (``Pairs``) for rays from ``eye`` [3] along
    ``directions`` [P, 3] through boxes ``bmin``/``bmax`` [B, 3] (float32),
    with the boxes' ``eps`` [B] (the first sample's nudge past the entry)
    and the fold's ``order`` [B] (int64, a permutation, front first).

    A CUDA ``eye`` launches ``diffpairs_build_kernel`` (csrc/diffmarch.cu:
    the slab test, the distances and the list in one launch, counted in
    ``diffpairs_build.launches``) into buffers of the capacity the most
    pairs a view of B bricks at P pixels has needed on this device.  Outside
    a CUDA graph capture the pair count is then read back, and a list that
    did not fit is built again larger (a view's first call, or a view with
    more pairs than any before it); inside one nothing is read: the pixels
    of a view that does not fit come out NaN (``pixel_count`` -1).  A view
    captured before any eager call of its sizes takes a capacity of B * P.
    A CPU ``eye`` runs ``diffpairs_build_reference``."""
    dev = directions.device
    if dev.type == "cpu":
        return diffpairs_build_reference(eye, directions, bmin, bmax, eps, order)
    if dev.type != "cuda":
        raise ValueError(f"diffpairs_build has no kernel for {dev}")
    num_bricks, num_pixels = bmin.shape[0], directions.shape[0]
    f = torch.float32
    for name, t, shape in (("eye", eye, (3,)), ("directions", directions, (num_pixels, 3)),
                           ("bmin", bmin, (num_bricks, 3)), ("bmax", bmax, (num_bricks, 3)),
                           ("eps", eps, (num_bricks,))):
        require(t, name, f, shape, dev)
    require(order, "order", torch.int64, (num_bricks,), dev)
    if num_bricks > 65535:
        raise ValueError(f"{num_bricks} bricks exceed the grid's 65535 rows")
    key = (str(dev), num_bricks, num_pixels)
    if torch.cuda.is_current_stream_capturing():
        return _build_launch(eye, directions, bmin, bmax, eps, order,
                             _capacity.get(key, num_bricks * num_pixels))
    known = _capacity.get(key)
    capacity = known if known is not None else min(num_bricks, 4) * num_pixels
    pairs = _build_launch(eye, directions, bmin, bmax, eps, order, capacity)
    need = int(pairs.total)  # a read of the device: eager calls only
    if need >= 2 ** 31:
        raise ValueError(f"a view of {need} pairs exceeds the list's 2^31")
    _capacity[key] = max(known or 0, -(-need // 1024) * 1024)
    if need > capacity:
        pairs = _build_launch(eye, directions, bmin, bmax, eps, order, _capacity[key])
    return pairs


diffpairs_build.launches = 0
_BUILD_COUNTER = diffpairs_build  # counted here, where a caller wraps the name


def _brick_rows(m: MarchInputs, pairs: Pairs, b: int, sel: Tensor) -> MarchInputs:
    """Brick ``b``'s pairs ``sel`` (indices into the list) as the dense
    rows of a one-brick march."""
    dev = m.data.device
    pix = pairs.pixel[sel].long()
    return MarchInputs(
        data=m.data[b:b + 1], luts=m.luts[b:b + 1], d0=m.d0[sel][None],
        directions=m.directions[pix], eye=m.eye, steps=m.steps[b:b + 1],
        bmin=m.bmin[b:b + 1], cell=m.cell[b:b + 1], scalars=m.scalars, tmax=m.tmax[sel][None],
        hit=torch.ones((1, sel.shape[0]), dtype=torch.bool, device=dev),
        bmax=m.bmax[b:b + 1], top=m.top[b:b + 1], low=m.low[b:b + 1])


def _brick_pairs(pairs: Pairs):
    """Each brick with pairs and its pairs' indices, in list order."""
    total = int(pairs.total)
    brick = pairs.brick[:total].long()
    for b in torch.unique(brick).tolist():
        yield b, (brick == b).nonzero()[:, 0]


def march_pairs_forward_reference(m: MarchInputs, pairs: Pairs, cfg: MarchConfig) -> Tensor:
    """The plain march over a pair list: ``march_forward_reference`` a
    brick over its pairs (each pair's arithmetic is the dense march's).
    Returns the raw accumulator ``[N, 4]``, zero in the rows of no pair."""
    out = torch.zeros((m.d0.shape[0], 4), dtype=torch.float32, device=m.data.device)
    for b, sel in _brick_pairs(pairs):
        out[sel] = march_forward_reference(_brick_rows(m, pairs, b, sel), cfg)[0]
    return out


def march_pairs_backward_reference(m: MarchInputs, pairs: Pairs, cfg: MarchConfig,
                                   grad: Tensor,
                                   needs: Sequence[bool] = (True,) * DIFFERENTIABLE
                                   ) -> List[Tensor]:
    """The reverse mode of the march over a pair list, in plain PyTorch:
    ``march_backward_reference`` a brick over its pairs; the gradients of
    ``MarchInputs``' differentiable fields, ``d0`` a row a pair."""
    dev = m.data.device
    grads = [torch.zeros(t.shape, dtype=torch.float32, device=dev) for t in m[:DIFFERENTIABLE]]
    g_data, g_luts, g_d0, g_dirs, g_eye, g_steps, g_bmin, g_cell, g_sc = grads
    for b, sel in _brick_pairs(pairs):
        rows = _brick_rows(m, pairs, b, sel)
        gb = march_backward_reference(rows, cfg, grad[sel][None], needs)
        g_data[b], g_luts[b], g_d0[sel] = gb[0][0], gb[1][0], gb[2][0]
        g_dirs.index_add_(0, pairs.pixel[sel].long(), gb[3])
        g_eye += gb[4]
        g_steps[b], g_bmin[b], g_cell[b] = gb[5][0], gb[6][0], gb[7][0]
        g_sc += gb[8]
    return grads


def diffmarch_forward_pairs(m: MarchInputs, pairs: Pairs, cfg: MarchConfig, keep: bool = False):
    """The raw accumulator ``[N, 4]`` of the march over a pair list (``m``'s
    ``d0`` and ``tmax`` a row a pair, ``hit`` unread), and with ``keep`` on
    the card the opacity checkpoints ``[C, N]`` the backward replays from
    (None otherwise).  A CUDA ``m`` launches ``diffmarch_forward_kernel``
    over the list's runs (a row of blocks a brick, as over dense rows),
    counted in ``diffmarch_forward.launches``; a CPU ``m`` runs
    ``march_pairs_forward_reference``."""
    dev = m.data.device
    if dev.type == "cpu":
        return march_pairs_forward_reference(m, pairs, cfg), None
    if dev.type != "cuda":
        raise ValueError(f"diffmarch_forward has no kernel for {dev}")
    _check(m, pairs)
    rows = pairs.brick.shape[0]
    accum = torch.empty((rows, 4), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((checkpoint_count(cfg), rows), dtype=torch.float32, device=dev)
            if keep else None)
    from . import _build

    _raise(_build.load("diffmarch").avr_diffmarch_forward_launch(
        *(t.data_ptr() for t in m), *_pair_walk(pairs), accum.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(), *_launch_args(m, cfg), _stream(dev)),
        "forward")
    diffmarch_forward.launches += 1
    return accum, ckpt


def diffmarch_backward_pairs(m: MarchInputs, pairs: Pairs, cfg: MarchConfig, grad: Tensor,
                             checkpoints: Optional[Tensor],
                             needs: Sequence[bool] = (True,) * DIFFERENTIABLE) -> List[Tensor]:
    """The gradients of ``MarchInputs``' differentiable fields for the
    cotangent ``grad`` ``[N, 4]`` of the raw accumulator over a pair list
    (the rows of no pair unread).  A CUDA ``m`` launches
    ``diffmarch_backward_kernel`` over the list's runs from the forward's
    ``checkpoints``, as ``diffmarch_backward`` does over dense rows; a CPU
    ``m`` runs ``march_pairs_backward_reference``."""
    dev = m.data.device
    if dev.type == "cpu":
        return march_pairs_backward_reference(m, pairs, cfg, grad, needs)
    if dev.type != "cuda":
        raise ValueError(f"diffmarch_backward has no kernel for {dev}")
    _check(m, pairs)
    rows = pairs.brick.shape[0]
    num_bricks, num_pixels = m.luts.shape[0], m.directions.shape[0]
    grad = grad.to(dev, torch.float32).contiguous()
    require(grad, "grad", torch.float32, (rows, 4), dev)
    if checkpoints is None:
        raise ValueError("the backward kernel needs the forward's checkpoints "
                         "(diffmarch_forward_pairs(..., keep=True))")
    require(checkpoints, "checkpoints", torch.float32, (checkpoint_count(cfg), rows), dev)
    blocks = max(1, min(-(-num_pixels // _BACK_THREADS), -(-_GRID_BLOCKS // num_bricks)))
    g_data = torch.zeros_like(m.data)
    g_luts = torch.zeros(m.luts.shape, dtype=torch.float64, device=dev)
    g_d0 = torch.zeros_like(m.d0)
    g_dirs = torch.zeros_like(m.directions)
    partial = torch.zeros((num_bricks, blocks, PARTIALS), dtype=torch.float32, device=dev)
    from . import _build

    _raise(_build.load("diffmarch").avr_diffmarch_backward_launch(
        *(t.data_ptr() for t in m), *_pair_walk(pairs), grad.data_ptr(),
        checkpoints.data_ptr(), g_data.data_ptr() if needs[0] else None,
        g_luts.data_ptr() if needs[1] else None, g_d0.data_ptr(), g_dirs.data_ptr(),
        partial.data_ptr(), blocks, *_launch_args(m, cfg), _stream(dev)), "backward")
    diffmarch_backward.launches += 1
    part = partial.sum(1)
    return [g_data, g_luts.float(), g_d0, g_dirs, part[:, 7:10].sum(0), part[:, 0],
            part[:, 1:4], part[:, 4:7], part[:, 10:15].sum(0)]


class _MarchPairs(torch.autograd.Function):
    """The march over a pair list as one autograd node (reverse mode)."""

    @staticmethod
    def forward(ctx, cfg, keep, pairs, *tensors):
        m = MarchInputs(*tensors)
        accum, ckpt = diffmarch_forward_pairs(m, pairs, cfg, keep)
        ctx.cfg, ctx.pairs = cfg, pairs
        ctx.save_for_backward(*m, *(() if ckpt is None else (ckpt,)))
        return accum

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        n = len(MarchInputs._fields)
        ckpt = saved[n] if len(saved) > n else None
        needs = ctx.needs_input_grad[3:3 + DIFFERENTIABLE]
        grads = diffmarch_backward_pairs(MarchInputs(*saved[:n]), ctx.pairs, ctx.cfg, grad,
                                         ckpt, needs)
        return (None, None, None, *(g if need else None for g, need in zip(grads, needs)),
                *(None,) * (n - DIFFERENTIABLE))


def march_pairs(m: MarchInputs, pairs: Pairs, cfg: MarchConfig) -> Tensor:
    """The raw accumulator ``[N, 4]`` of the march over a pair list,
    differentiable in reverse mode in ``m``'s first ``DIFFERENTIABLE``
    fields (``d0`` a row a pair).  The forward keeps the checkpoints only
    when reverse mode will differentiate it (a host fact)."""
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in m[:DIFFERENTIABLE])
    return _MarchPairs.apply(cfg, keep, pairs, *m)
