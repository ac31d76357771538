"""Differentiable volume rendering on tensors, with autograd.

The port of the JAX package's ``diff.py``: a smooth twin of the raymarch
oracle (``ops/raymarch.py``) whose gradients with respect to the volume
data, the transfer function and the camera come from autograd.  The
reference renderer (``Common/VolumePainter.cpp:735-922``) is forward-only;
the JAX module is one XLA program that ``jax.grad`` and ``jax.jvp``
differentiate.  Here the ray set-up and what follows the march are plain
PyTorch under autograd, and the march itself is one autograd node,
``ops.diffmarch.march``: on the card a hand-written forward kernel, a
backward kernel and a tangent kernel (``ops/csrc/diffmarch.cu``), on the
CPU their plain versions.  On the card ``render_image_diff`` keeps its
state a row a (brick, pixel) pair whose ray meets the brick
(``render_image_pairs``: one pair-list build a view, the march over the
list's rows, ``ops.composite.fold_pairs``); the dense layers of
``render_layers_diff`` serve the CPU, forward mode and the sharded path,
where the ordered fold is ``ops.composite.fold_diff`` on the card (a
forward and a backward kernel in ``ops/csrc/composite.cu``) and an eager
loop of ``fma`` elsewhere.

What makes it smooth, as in JAX:

  * trilinear cell-centre sampling, clamp to edge (``trilinear_sample``);
  * linear interpolation between transfer-function entries
    (``lut_lookup_linear``);
  * the opacity early-out (``accum.a < 1``) kept as a gate.

Volume data and transfer function are the finite-difference-checked
gradient surfaces.  Camera gradients (eye, basis, field of view) are
finite subgradients of the fixed-step quadrature's staircase.

What the port adds to keep JAX's gradients, not only its values:

  * ``_clip`` is ``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose
    gradient at a bound is half (``torch.clamp`` gives all of it).  A
    saturated pixel's colour sits exactly on 1.0, so the rule shows.  The
    march's hand-derived backward and tangent keep the same rule at every
    clip and at the positive floor's ``maximum``.
  * ``ops.numerics.rsqrt`` and ``log`` go through integer bit views to
    round as XLA:CPU does; they are autograd functions with JAX's
    derivative rules, and so is the field of view's ``tan`` here.
  * the forward follows the jitted JAX function's rounding on the CPU:
    the ray set-up is ``ops/raymarch.py``'s, with its FMA sites and folded
    constants, and each ``fma`` call in the march names a site XLA
    contracts.  XLA rounds the trilinear sample differently in different
    fusions, so frames agree within 2e-6, not bit for bit; on the card
    they equal the CPU's.

``remat`` is kept for JAX's signature and changes nothing: the march node
stores no step's activations on either device (its backward recomputes
them; on the card from opacity checkpoints every 16 steps), so gradient
memory and results are the same with it on or off.  The bricks render as
one batch, the counterpart of ``jax.vmap``.

With ``utils.timers.enable_spans`` on, each stage of a view is a span
(``utils.timers.SPANS``): the ray set-up, the pair build, the march, the
order and the fold forward, the fold's and the march's backward; the
sharded path's shards reuse the names.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .camera import camera_basis
from .colormap import SOFT_CLIP_TOLERANCE, build_color_table
from .device import DEFAULT_DEVICE, Device, resolve_device
from .ops import diffmarch as dm
from .ops.composite import fold_diff, fold_pairs
from .ops.diffmarch import _clip, _constant  # noqa: F401  (_constant: its cache)
from .ops.march import f32
from .ops.numerics import fma
from .ops.raymarch import (_HALF_FOV_SCALE, _ray_directions, _slab_intersect,
                           half_fov_tan, max_steps_for_bucket)
from .parallel import directsend as ds
from .types import ScalarTransform
from .utils import timers

Tensor = torch.Tensor


def _scalar(v, dev) -> Tensor:
    """A float32 scalar on ``dev``: tensors as they are (gradients kept),
    numbers rounded to float32."""
    if isinstance(v, Tensor):
        return v.to(device=dev, dtype=torch.float32)
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=dev)


def _carries_derivative(v: Tensor) -> bool:
    """Whether reverse or forward mode differentiates through ``v``."""
    return v.requires_grad or fwAD.unpack_dual(v).tangent is not None


class _HalfFovTan(torch.autograd.Function):
    """``tan(fov / 2)`` of a field of view in degrees, rounded as
    ``raymarch.half_fov_tan``; JAX's derivative ``g * (1 + t^2)`` times the
    folded ``0.5 * pi / 180``."""

    @staticmethod
    def forward(ctx, fov):
        t = torch.tensor(half_fov_tan(float(fov)), dtype=torch.float32,
                         device=fov.device)
        ctx.save_for_backward(t)
        ctx.save_for_forward(t)
        return t

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        return g * (1.0 + t * t) * _HALF_FOV_SCALE

    @staticmethod
    def jvp(ctx, g):
        (t,) = ctx.saved_tensors
        return g * (1.0 + t * t) * _HALF_FOV_SCALE


def _scalar_transform(raw: Tensor, log_scale: bool, normalize: bool,
                      positive_floor: Tensor, normalization_min: Tensor,
                      inverse_normalization_span: Tensor) -> Tensor:
    """``transforms.apply_scalar_transform`` with ``jnp.maximum`` and
    ``jnp.clip``'s gradients at ties."""
    return dm.transform_terms(raw, log_scale, normalize, positive_floor,
                              normalization_min, inverse_normalization_span).value


def _soft_tail(value: Tensor, clip_start: float) -> Tensor:
    """``transforms.saturate_soft_tail(value, clip_start, 1)`` rounded as
    ``raymarch._soft_tail`` (a multiply by the span's float32 reciprocal,
    two FMAs), with ``jnp.clip``'s gradient."""
    return dm.soft_tail_terms(value, clip_start).scalar


def trilinear_sample(
    brick: Tensor,  # [..., nx, ny, nz] padded values
    dims: Tensor,  # [..., 3] int valid cell counts
    bmin: Tensor,  # [..., 3] world lower corner
    cell_size: Tensor,  # [..., 3] world cell span
    pos: Tensor,  # [..., N, 3] world sample positions
) -> Tensor:
    """Clamp-to-edge trilinear interpolation of cell-centred values.

    Positions go to cell-centre coordinates ``f = (pos - bmin) / cell -
    0.5`` (the production kernels' convention) clamped into the valid
    range, so outside the last half-cell the face value holds.  Leading
    dimensions are a batch of bricks (none: JAX's signature).  Returns
    ``[..., N]`` float32, differentiable in ``brick`` (a gather through
    a flat index, whose backward is a scatter-add) and ``pos``."""
    dims = dims.long()
    zero = torch.zeros((), dtype=dims.dtype, device=dims.device)
    return dm.trilinear_terms(brick, torch.maximum(dims - 1, zero)[..., None, :],
                              torch.maximum(dims - 2, zero)[..., None, :],
                              bmin[..., None, :], cell_size[..., None, :], pos).raw


def lut_lookup_linear(lut: Tensor, normalized: Tensor) -> Tensor:
    """Continuous transfer-function lookup: lerp between adjacent entries.

    ``lut`` is ``[..., size, 4]`` and ``normalized`` ``[..., N]`` in [0, 1]
    (no leading dimensions: JAX's signature).  Within half a bin of the
    forward oracle's floored index (VolumePainter.cpp:858-866) and
    differentiable in both arguments."""
    return dm.lut_terms(lut, normalized).s


def _rays(data, min_corner, max_corner, cell_dims, color_table, sample_distance, eye,
          basis_forward, basis_right, basis_up, fov_y_degrees, range_min, inverse_range,
          positive_floor, normalization_min, inverse_normalization_span, width: int,
          height: int) -> SimpleNamespace:
    """The ray set-up both paths share, on ``data``'s device: the eye, the
    basis and the rays' directions ``[P, 3]``, the boxes and each box's
    first-sample nudge ``mesh_eps`` ``[B]``, and ``inputs``, the march's
    inputs but for the per-(brick, pixel) fields (``d0``, ``tmax`` and
    ``hit`` None)."""
    dev = data.device
    f = torch.float32
    bmin, bmax = min_corner.to(dev, f), max_corner.to(dev, f)
    dims = cell_dims.to(dev).long()
    eye = eye.to(dev, f)
    basis = tuple(v.to(dev, f) for v in (basis_forward, basis_right, basis_up))
    fov = _scalar(fov_y_degrees, dev)
    aspect = f32(f32(width) / f32(max(height, 1)))
    # a number reads no device value: a call with the field of view as a
    # number waits for nothing, so a CUDA graph can capture it
    tan = (_HalfFovTan.apply(fov) if _carries_derivative(fov)
           else half_fov_tan(float(fov_y_degrees)))
    directions = _ray_directions(width, height, tan, aspect, basis)  # [P, 3]
    extent = bmax - bmin
    extent_mag = torch.sqrt(fma(extent[:, 2], extent[:, 2], fma(
        extent[:, 1], extent[:, 1], extent[:, 0] * extent[:, 0])))  # FMA
    cell = torch.where(dims > 0, extent / torch.maximum(
        dims.to(f), torch.ones((), dtype=f, device=dev)), 1.0)
    scalars = torch.stack([_scalar(v, dev) for v in (
        range_min, inverse_range, positive_floor, normalization_min,
        inverse_normalization_span)])
    zero = torch.zeros((), dtype=dims.dtype, device=dev)
    inputs = dm.MarchInputs(
        data=data.to(f).contiguous(), luts=color_table.to(dev, f).contiguous(), d0=None,
        directions=directions.contiguous(), eye=eye,
        steps=sample_distance.to(dev, f).contiguous(), bmin=bmin.contiguous(),
        cell=cell.contiguous(), scalars=scalars, tmax=None, hit=None,
        bmax=bmax.detach().contiguous(),
        top=torch.maximum(dims - 1, zero).to(torch.int32).contiguous(),
        low=torch.maximum(dims - 2, zero).to(torch.int32).contiguous())
    return SimpleNamespace(eye=eye, basis=basis, directions=directions, bmin=bmin, bmax=bmax,
                           mesh_eps=extent_mag * f32(1e-4), inputs=inputs)


def render_layers_diff(
    data: Tensor,  # [B, nx, ny, nz] float32 padded raw values
    min_corner: Tensor,  # [B, 3] float32 world lower corners
    max_corner: Tensor,  # [B, 3] float32 world upper corners
    cell_dims: Tensor,  # [B, 3] int32 actual cell counts
    color_table: Tensor,  # [B, size, 4] float32 per-brick LUT
    sample_distance: Tensor,  # [B] float32 per-brick step
    eye: Tensor,  # [3] float32
    basis_forward: Tensor,  # [3]
    basis_right: Tensor,  # [3]
    basis_up: Tensor,  # [3]
    fov_y_degrees,  # scalar
    range_min,  # scalar
    inverse_range,  # scalar
    positive_floor=0.0,
    normalization_min=0.0,
    inverse_normalization_span=1.0,
    *,
    width: int,
    height: int,
    num_steps: int,
    log_scale: bool = False,
    normalize: bool = False,
    clip_start: float = 1.0,
    apply_clip: bool = False,
    remat: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Differentiable twin of ``ops.raymarch.render_bucket_impl``.

    The JAX function's argument layout; front-to-back over-compositing
    (VolumePainter.cpp:837-900) with trilinear samples and lerped LUT
    lookups.  Runs on ``data``'s device: the ray set-up here, the march
    through ``ops.diffmarch.march`` (one forward launch, and one backward
    launch under reverse mode, on the card).  Returns ``(colors [B, H*W,
    4], depths [B, H*W])``; the depths carry no gradient (they are
    box-entry hints for ordering).  ``remat`` changes nothing (JAX's
    argument: the march stores no step's activations either way)."""
    with timers.span("diff.rays", data):
        r = _rays(data, min_corner, max_corner, cell_dims, color_table, sample_distance, eye,
                  basis_forward, basis_right, basis_up, fov_y_degrees, range_min,
                  inverse_range, positive_floor, normalization_min,
                  inverse_normalization_span, width, height)
        eye, basis, directions = r.eye, r.basis, r.directions
        tmin, tmax = _slab_intersect(eye, directions, r.bmin, r.bmax)  # [B, N]
        hit = tmax >= tmin
        mesh_eps = r.mesh_eps[:, None]
        # miss rays: the slab guard leaves tmin = +inf on rays with a zero
        # direction component outside the box, and inf * 0 in the position
        # math would put NaNs into the cotangents, so misses take a finite
        # dummy distance before any arithmetic
        tmin_safe = torch.where(hit, tmin, 0.0)
        d0 = tmin_safe + mesh_eps
        d0 = torch.where(d0 < 0.0, mesh_eps, d0)
        inputs = r.inputs._replace(d0=d0.contiguous(), tmax=tmax.detach().contiguous(),
                                   hit=hit.contiguous())
    backward = timers.grad_span("diff.march.backward")
    with timers.span("diff.march", data):
        inputs = dm.MarchInputs(*backward.inputs(*inputs[:dm.DIFFERENTIABLE]),
                                *inputs[dm.DIFFERENTIABLE:])
        accum = dm.march(inputs, dm.MarchConfig(num_steps, log_scale, normalize,
                                                apply_clip, clip_start))
        accum = _clip(accum, 0.0, 1.0)

        with torch.no_grad():
            rel = fma(directions, tmin_safe[..., None], eye) - eye  # FMA: entry
            fwd = basis[0]
            depth = fma(rel[..., 2], fwd[2], fma(rel[..., 1], fwd[1],
                                                 rel[..., 0] * fwd[0]))  # FMA
            depth = torch.where(hit & (accum[..., 3] > 0.0) & torch.isfinite(depth),
                                depth, float("inf"))
        colors = torch.where(hit[..., None], accum, 0.0)
    return backward.output(colors), depth


def composite_layers_diff(
    colors: Tensor,  # [B, N, 4] premultiplied RGBA layers
    order,  # [B] front-to-back layer indices
) -> Tensor:
    """Ordered front-to-back over-composite of layers, differentiable in
    every layer (DirectSendBase.cpp:400-446's accumulation).  ``order`` is
    the visibility permutation, front first.  Returns ``[N, 4]``.

    On the card the fold is ``ops.composite.fold_diff``: a forward and a
    backward launch, with the eager loop's bits; its kernels stop on an
    ``order`` of the layers' length that repeats an index.  The eager loop
    of ``fma`` a layer serves CPU tensors, layers that carry a forward-mode
    tangent, and an ``order`` of another length than the layers'."""
    backward = timers.grad_span("diff.fold.backward")
    with timers.span("diff.fold", colors):
        (colors,) = backward.inputs(colors)
        order = torch.as_tensor(np.asarray(order) if not isinstance(order, Tensor)
                                else order, device=colors.device).long()
        if (colors.device.type == "cuda" and order.shape == colors.shape[:1]
                and fwAD.unpack_dual(colors).tangent is None):
            image = fold_diff(colors, order)
        else:
            image = _fold_layer_loop(colors, order)
    return backward.output(image)


def _fold_layer_loop(colors: Tensor, order: Tensor) -> Tensor:
    """``composite_layers_diff``'s eager fold: ``fma`` a layer, each
    differentiated by autograd (``order`` a device tensor of indices)."""
    accum = torch.zeros_like(colors[0])
    for layer in colors.index_select(0, order):
        accum = fma(layer, 1.0 - accum[:, 3:4], accum)  # FMA
    return _clip(accum, 0.0, 1.0)


@functools.lru_cache(maxsize=16)
def _corner_mask(device) -> Tensor:
    """[8, 3] bool: which coordinates of each box corner are the maximum
    ones; made once per device (a copy from the host waits for it)."""
    with torch.inference_mode(False):
        return torch.tensor([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
                            dtype=torch.bool, device=device)


def default_order(min_corner: Tensor, max_corner: Tensor, eye: Tensor,
                  basis_forward: Tensor) -> Tensor:
    """The forward pipeline's depth-hint order: bricks by the least view
    depth over their 8 corners (camera.compute_box_depth_hints,
    VolumeRenderer.cpp:541-553), nearest first; ties keep brick order,
    as ``jnp.argsort`` does."""
    with torch.no_grad(), timers.span("diff.order", min_corner):
        sel = _corner_mask(min_corner.device)
        corners = torch.where(sel[None], max_corner[:, None, :],
                              min_corner[:, None, :])  # [B, 8, 3]
        rel = corners - eye
        fwd = basis_forward
        key = fma(rel[..., 2], fwd[2], fma(rel[..., 1], fwd[1],
                                           rel[..., 0] * fwd[0]))  # FMA
        return torch.argsort(key.amin(dim=1), stable=True)


def render_image_diff(data, min_corner, max_corner, *args, order=None,
                      mesh=None, **kwargs) -> Tensor:
    """Render all bricks and composite them: the one-call differentiable
    pipeline (arguments as ``render_layers_diff``).  ``order`` defaults to
    ``default_order``, the product renderer's hint ordering; pass a
    visibility permutation for graph-exact order.  Returns ``[H*W, 4]``.

    On the card the call takes the pair path (``render_image_pairs``): its
    state and its layers are a row a (brick, pixel) pair whose ray meets
    the brick, not ``[B, H*W]``, with the dense fold's image bit for bit.
    CPU tensors, forward mode and an ``order`` of another length than the
    bricks' take the dense layers of ``render_layers_diff``.

    ``mesh`` (a ``parallel.directsend.Mesh`` from ``make_mesh``) shards
    the brick axis over its shards, the counterpart of calling the JAX
    function on brick-sharded data: the frame is the single call's bit for
    bit, and so is every gradient up to the order of its sums.  See
    ``_render_image_sharded``."""
    if mesh is not None:
        return _render_image_sharded(mesh, data, min_corner, max_corner, *args,
                                     order=order, **kwargs)
    if (data.device.type == "cuda" and fwAD._current_level < 0
            and (order is None or len(order) == min_corner.shape[0])):
        return render_image_pairs(data, min_corner, max_corner, *args, order=order, **kwargs)
    colors, _ = render_layers_diff(data, min_corner, max_corner, *args, **kwargs)
    if order is None:
        dev = colors.device
        order = default_order(min_corner.to(dev), max_corner.to(dev),
                              args[3].to(dev), args[4].to(dev))
    return composite_layers_diff(colors, order)


def render_image_pairs(
    data: Tensor,
    min_corner: Tensor,
    max_corner: Tensor,
    cell_dims: Tensor,
    color_table: Tensor,
    sample_distance: Tensor,
    eye: Tensor,
    basis_forward: Tensor,
    basis_right: Tensor,
    basis_up: Tensor,
    fov_y_degrees,
    range_min,
    inverse_range,
    positive_floor=0.0,
    normalization_min=0.0,
    inverse_normalization_span=1.0,
    *,
    width: int,
    height: int,
    num_steps: int,
    log_scale: bool = False,
    normalize: bool = False,
    clip_start: float = 1.0,
    apply_clip: bool = False,
    remat: bool = True,
    order=None,
) -> Tensor:
    """``render_image_diff`` over the view's hit pairs: the state of the
    march and the fold is a row a (brick, pixel) pair whose ray meets the
    brick (``ops.diffmarch.Pairs``), so it grows with the pairs a view
    has, not with bricks x pixels.  The image equals the dense path's bit
    for bit (a miss layer of the dense fold is exactly 0, which changes no
    sum), and so does the gradient of each pair's march inputs.

    The ray set-up as ``render_layers_diff``'s, per pixel and per brick;
    the fold's ``order`` (``default_order`` unless given: a permutation of
    the bricks); the pair list (``ops.diffmarch.diffpairs_build``: the slab
    test, the distances and the list, one launch on the card); the march
    over the list (``ops.diffmarch.march_pairs``) and the fold of its rows
    (``ops.composite.fold_pairs``, which takes the march's clip).  Where
    the eye, the ray directions or the boxes carry a gradient, the pairs'
    first distances are formed again under autograd from the list, with
    the same bits.  Reverse mode only; on the CPU the plain versions."""
    dev = data.device
    with timers.span("diff.rays", data):
        r = _rays(data, min_corner, max_corner, cell_dims, color_table, sample_distance, eye,
                  basis_forward, basis_right, basis_up, fov_y_degrees, range_min,
                  inverse_range, positive_floor, normalization_min,
                  inverse_normalization_span, width, height)
    if order is None:
        order = default_order(r.bmin.detach(), r.bmax.detach(), r.eye.detach(),
                              r.basis[0].detach())
    order = torch.as_tensor(np.asarray(order) if not isinstance(order, Tensor) else order,
                            device=dev).long()
    with timers.span("diff.pairs", data):
        geometry = (r.eye, r.directions, r.bmin, r.bmax, r.mesh_eps)
        pairs = dm.diffpairs_build(*(t.detach().contiguous() for t in geometry), order)
        d0 = pairs.d0
        if torch.is_grad_enabled() and any(t.requires_grad for t in geometry):
            d0 = _pair_d0(*geometry, pairs)
    backward = timers.grad_span("diff.march.backward")
    with timers.span("diff.march", data):
        inputs = r.inputs._replace(d0=d0, tmax=pairs.tmax,
                                   hit=torch.empty(0, dtype=torch.bool, device=dev))
        inputs = dm.MarchInputs(*backward.inputs(*inputs[:dm.DIFFERENTIABLE]),
                                *inputs[dm.DIFFERENTIABLE:])
        raw = backward.output(dm.march_pairs(inputs, pairs, dm.MarchConfig(
            num_steps, log_scale, normalize, apply_clip, clip_start)))
    fold_backward = timers.grad_span("diff.fold.backward")
    with timers.span("diff.fold", raw):
        (raw,) = fold_backward.inputs(raw)
        image = fold_pairs(raw, pairs)
    return fold_backward.output(image)


def _pair_d0(eye: Tensor, directions: Tensor, bmin: Tensor, bmax: Tensor,
             mesh_eps: Tensor, pairs) -> Tensor:
    """The pairs' first sample distance under autograd: ``_slab_intersect``'s
    entry distance and ``render_layers_diff``'s nudge for each pair of the
    list, op for op (so the bits of the list's own ``d0``), gathered from
    the pixel's direction and the brick's box (rows of no pair take pair
    0's operands, and no gradient reaches them)."""
    rows = pairs.brick.shape[0]
    valid = torch.arange(rows, device=eye.device) < pairs.total
    brick = torch.where(valid, pairs.brick, 0).long()
    d = directions[torch.where(valid, pairs.pixel, 0).long()]
    lo, hi = bmin[brick], bmax[brick]
    parallel = torch.abs(d) < f32(1e-8)
    inv = 1.0 / torch.where(parallel, 1.0, d)
    t1, t2 = (lo - eye) * inv, (hi - eye) * inv
    inside = (eye >= lo) & (eye <= hi)
    inf = float("inf")
    tmin = torch.where(parallel, torch.where(inside, -inf, inf),
                       torch.minimum(t1, t2)).amax(dim=-1)
    eps = mesh_eps[brick]
    d0 = tmin + eps
    return torch.where(d0 < 0.0, eps, d0).contiguous()


def _render_image_sharded(mesh, data, min_corner, max_corner, cell_dims,
                          color_table, sample_distance, *camera, order=None,
                          width: int, height: int, **kwargs) -> Tensor:
    """``render_image_diff`` over the mesh's shards: the brick axis in
    ``mesh.size`` contiguous blocks, shard r rendering bricks ``[r * B / D,
    (r + 1) * B / D)`` on its device.

    ``data`` is the whole ``[B, ...]`` tensor or ``Shards`` (one
    ``[B / D, ...]`` tensor per shard, None for another process's, as
    ``directsend.shard_leading`` makes them; each receives its own rows of
    the gradient).  The other per-brick tables and the camera come whole
    on every process and are sliced per shard; across processes the
    gradient of each whole input that requires one is summed over the
    processes (``directsend.replicated``), so every process holds all of
    it.  The frame follows the repo's DirectSend: each shard's ``[B / D,
    P, 4]`` layers are exchanged (``all_to_all_autograd``) so that each
    shard folds all B layers of its ``P / D`` pixels in ``default_order``
    (the same layers in the same order as the single call), and the pixel
    shards are gathered (``gather_frame_autograd``) into the whole ``[P,
    4]`` frame on every process, on the first local shard's device.  The
    pixel count is padded to a multiple of D with cleared pixels, cropped
    after the gather.  ``B % D != 0`` raises."""
    num = mesh.size
    bricks = min_corner.shape[0]
    if bricks % num:
        raise ValueError(f"brick count {bricks} is not divisible by the mesh "
                         f"size {num}")
    per = bricks // num
    sharded = isinstance(data, (list, tuple))
    if sharded and (len(data) != num or any(
            data[r] is None or data[r].shape[0] != per for r in mesh.local)):
        raise ValueError(f"data shards must be {num} blocks of {per} bricks "
                         "(directsend.shard_leading)")
    first = mesh.devices[mesh.local[0]]
    if order is None:
        order = default_order(min_corner.to(first), max_corner.to(first),
                              camera[0].to(first), camera[1].to(first))
    whole = ds.replicated(mesh, min_corner, max_corner, cell_dims, color_table,
                          sample_distance, *camera, *(() if sharded else (data,)))
    tables, camera = whole[:5], whole[5:5 + len(camera)]
    if not sharded:
        data = whole[-1]
    pixels = width * height
    chunk = -(-pixels // num)
    chunks: list = [None] * num
    for r in mesh.local:
        dev = mesh.devices[r]
        rows = slice(r * per, (r + 1) * per)
        block = data[r] if sharded else data[rows]
        colors, _ = render_layers_diff(
            block.to(dev), *(t[rows].to(dev) for t in tables), *camera,
            width=width, height=height, **kwargs)
        colors = torch.nn.functional.pad(colors, (0, 0, 0, chunk * num - pixels))
        # [B / D, P, 4] -> [D, B / D, P / D, 4]: block s goes to shard s
        chunks[r] = colors.reshape(per, num, chunk, 4).transpose(0, 1)
    received = ds.all_to_all_autograd(mesh, chunks)
    folded: list = [None] * num
    for r in mesh.local:
        # [D senders, B / D, ...] flattens to global brick order
        layers = received[r].reshape(bricks, chunk, 4)
        folded[r] = composite_layers_diff(layers, order)
    return ds.gather_frame_autograd(mesh, folded)[:pixels]


# The JAX package's jitted entry point.  PyTorch has no jit here: the name
# is the same eager function, so callers of the JAX name find it.
render_image_diff_jit = render_image_diff


def prepare_scene(
    bricks,
    camera,
    *,
    width: int,
    height: int,
    color_map=None,
    scalar_range: Tuple[float, float] = (0.0, 1.0),
    box_transparency: float = 0.0,
    lut_size: int = 256,
    transform=None,
    device: Device = DEFAULT_DEVICE,
):
    """Assemble ``render_*_diff`` arguments from user-level scene inputs.

    ``bricks`` is a sequence of ``(data [nx, ny, nz], min_corner,
    max_corner)`` triples (raw values, world corners); ``camera`` a
    ``types.CameraParameters``; ``transform`` a ``types.ScalarTransform``
    (default identity).  Bricks are padded to one shape and each gets the
    forward pipeline's step-normalised LUT (``1-(1-a)^(step/ref)``,
    VolumePainter.cpp:107-125, the reference step being the coarsest
    brick's).  Returns ``(args, static)`` with the tensors on ``device``
    (default ``cuda``; raises when no card is there), so that
    ``render_image_diff(*args, **static)`` renders the scene; replace
    ``args[0]`` (data) or ``args[4]`` (LUT stack) with tensors that
    require grad to differentiate through them."""
    t = transform if transform is not None else ScalarTransform()
    n = len(bricks)
    if n == 0:
        raise ValueError("prepare_scene needs at least one brick")
    datas = [np.asarray(b[0], dtype=np.float32) for b in bricks]
    mins = np.asarray([b[1] for b in bricks], dtype=np.float32)
    maxs = np.asarray([b[2] for b in bricks], dtype=np.float32)
    dims = np.asarray([d.shape for d in datas], dtype=np.int32)
    pad = dims.max(axis=0)
    packed = np.zeros((n, *pad), dtype=np.float32)
    for i, d in enumerate(datas):
        packed[i, : d.shape[0], : d.shape[1], : d.shape[2]] = d

    spacing = (maxs - mins) / np.maximum(dims, 1)
    sample_distances = np.maximum(spacing.min(axis=1) * 0.5, 1e-5).astype(
        np.float32)
    ref = float(sample_distances.max())
    alpha_scale = float(np.clip(1.0 - box_transparency, 0.0, 1.0))
    luts = np.stack([
        build_color_table(alpha_scale, float(s) / ref, scalar_range, color_map,
                          size=lut_size)
        for s in sample_distances
    ]).astype(np.float32)

    num_steps = max_steps_for_bucket(mins, maxs, sample_distances)
    forward, right, up = camera_basis(camera)
    span = scalar_range[1] - scalar_range[0]
    f32s = np.float32
    args = args_from_arrays((
        packed, mins, maxs, dims, luts, sample_distances,
        np.asarray(camera.eye, f32s), np.asarray(forward, f32s),
        np.asarray(right, f32s), np.asarray(up, f32s),
        f32s(camera.fov_y_degrees), f32s(scalar_range[0]),
        f32s(1.0 / span if span != 0.0 else 1.0), f32s(t.positive_floor),
        f32s(t.normalization_min), f32s(t.inverse_normalization_span),
    ), device)
    clip_start = float(np.clip(scalar_range[1], 0.0, 1.0))
    static = dict(
        width=width,
        height=height,
        num_steps=num_steps,
        log_scale=bool(t.log_scale_input),
        normalize=bool(t.normalize_to_unit_range),
        clip_start=clip_start,
        apply_clip=bool(1.0 > clip_start + SOFT_CLIP_TOLERANCE),
    )
    return args, static


def prepare_geometry(
    geometry,
    camera,
    *,
    width: int,
    height: int,
    color_map=None,
    box_transparency: float = 0.0,
    lut_size: int = 256,
    device: Device = DEFAULT_DEVICE,
):
    """``prepare_scene`` from a built ``SceneGeometry`` (a plotfile load or
    in-situ arrays), with the geometry's scalar transform and its range:
    the stored range when the scene carries one, else the computed global
    range, as the forward pipeline selects it (renderer.py render_scene)."""
    from .renderer import compute_global_scalar_range

    scalar_range = (
        geometry.scalar_range
        if geometry.has_scalar_range
        else compute_global_scalar_range(geometry)
    )
    return prepare_scene(
        [(np.asarray(b.data), b.min_corner, b.max_corner)
         for b in geometry.bricks],
        camera,
        width=width,
        height=height,
        color_map=color_map,
        scalar_range=scalar_range,
        box_transparency=box_transparency,
        lut_size=lut_size,
        transform=geometry.scalar_transform,
        device=device,
    )


def args_from_arrays(args: Sequence, device: Device = DEFAULT_DEVICE) -> tuple:
    """An argument tuple of NumPy arrays and scalars (the JAX package's
    ``prepare_scene`` output through ``np.asarray``) as tensors on
    ``device``, dtypes kept: int32 cell counts, float32 arrays and 0-d
    float32 scalars."""
    dev = resolve_device(device)
    out = []
    for a in args:
        a = np.array(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        elif a.dtype.kind in "iu":
            a = a.astype(np.int32)
        out.append(torch.from_numpy(a).to(dev))
    return tuple(out)
