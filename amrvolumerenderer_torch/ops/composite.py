"""Run-grouped compositor: fold every piece layer of a pixel in one pass.

The port of the JAX package's ``ops/composite.py`` kernels
(``composite_tiles`` and ``composite_tiles_hbm``) and of the fold of its
sharded pipelines (``compositor._composite_sorted_runs``).  For each pixel
it walks the layers in blend order (front first) and applies
composeLayered's same-owner run fold: runs of consecutive same-owner
layers blend first, then the runs (DirectSendBase.cpp:378-446).  Ties in
the depth-sort blend keep the top.

Two entries of one CUDA source, ``csrc/composite.cu``:

* ``composite_tiles`` (tile mode): layers in tile order, read only where
  ``coverage`` marks a (layer, tile) block scheduled (elsewhere the layer
  is background: colour 0, depth +inf, with no read, so an undefined block
  never reaches a pixel).  The kernel folds only the covered layers, which
  is exact under the precondition stated in the source.
  ``composite_reference`` is its plain twin, the full fold over all layers.
  The TPU needed a second, DMA-streamed kernel past 96 layers (its VMEM
  limit); the GPU kernel serves any layer count, so ``composite_tiles_hbm``
  is the same call.
* ``composite_pixels`` (pixel mode): pixel-major ``[L, P, 5]`` layers as
  the sharded pipelines hold them, any ``P``, visited through an ``order``
  index, every layer covered.  ``composite_pixels_reference`` is its plain
  twin.
* ``composite_runs`` (runs mode): the run pre-blend of the persistent
  multi-device renderer (the JAX package's XLA loop
  ``parallel/directsend.py::_preblend_runs_scan``).  It folds pixel-major
  layers in a step order into ``[rmax, P, 5]`` run buffers: a step whose
  run slot equals the previous step's extends the open run, any other
  closes it into its slot and starts a new one.
  ``composite_runs_reference`` is its plain twin.

* ``fold_diff`` (the differentiable fold of ``diff.composite_layers_diff``
  on the card): the front-to-back over-composite of ``[B, P, 4]`` layers
  in a visibility order, one ``torch.autograd.Function`` whose forward
  (``fold_diff_forward``) and backward (``fold_diff_backward``) are one
  launch each.  ``fold_diff_forward_reference`` and
  ``fold_diff_backward_reference`` are their plain twins, the arithmetic
  of the eager loop of ``numerics.fma`` and its autograd, op for op.
  These wrappers take CUDA tensors only: on the CPU the fold is
  ``diff.composite_layers_diff``'s eager loop, and the plain twins serve
  the tests.
* ``fold_pairs`` (the fold of ``diff.render_image_pairs``): the same
  fold over a view's pair list (``diffmarch.Pairs``: each pixel's hit
  pairs in fold order), each raw march row clipped first, one
  ``torch.autograd.Function`` over ``diffpairs_fold_forward`` and
  ``diffpairs_fold_backward`` (one launch each on the card);
  ``diffpairs_fold_*_reference`` are their plain twins, which the CPU runs.

Each other wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .diffmarch import _clip
from .march import blend, require
from .numerics import fma_reference
from .worklist import LANES, SUBLANES, TILE_P

Tensor = torch.Tensor


def composite_reference(
    colors: Tensor,  # [L, T, 4, 8, 128] per-piece layers in tile order
    depths: Tensor,  # [L, T, 8, 128]
    order: Tensor,  # [L] i32 blend order (front first)
    owners_sorted: Tensor,  # [L] i32 owner of sorted layer i
    coverage: Tensor,  # [L, T] bool: which (layer, tile) blocks are valid
) -> Tuple[Tensor, Tensor]:
    """The composite kernel in plain PyTorch, vectorised over tiles x
    pixels; the Python loop runs over the layers in order."""
    num_layers, num_tiles = colors.shape[0], colors.shape[1]
    dev = colors.device
    c = colors.reshape(num_layers, num_tiles, 4, TILE_P)
    d = depths.reshape(num_layers, num_tiles, TILE_P)
    cov = coverage.to(device=dev, dtype=torch.bool)
    zero = torch.zeros((num_tiles, TILE_P), dtype=torch.float32, device=dev)
    inf = zero + float("inf")
    run_c, run_d = [zero] * 4, inf
    tot_c, tot_d = [zero] * 4, inf
    have_tot = False
    order_l = order.tolist()
    owners_l = owners_sorted.tolist()
    for i, b in enumerate(order_l):
        mask = cov[b][:, None]
        lc = [torch.where(mask, c[b, :, ch], 0.0) for ch in range(4)]
        ld = torch.where(mask, d[b], float("inf"))
        if i > 0 and owners_l[i] == owners_l[i - 1]:
            run_c, run_d = blend(run_c, run_d, lc, ld)
        else:
            # close the previous owner's run into the running total
            if have_tot:
                tot_c, tot_d = blend(tot_c, tot_d, run_c, run_d)
            else:
                tot_c, tot_d = run_c, run_d
            have_tot = have_tot or i > 0
            run_c, run_d = lc, ld
    if have_tot:
        run_c, run_d = blend(tot_c, tot_d, run_c, run_d)
    return (
        torch.stack(run_c, dim=1).reshape(num_tiles, 4, SUBLANES, LANES),
        run_d.reshape(num_tiles, SUBLANES, LANES),
    )


def composite_tiles(
    colors: Tensor,
    depths: Tensor,
    order: Tensor,
    owners_sorted: Tensor,
    coverage: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Composite tile-ordered layers; returns ``([T, 4, 8, 128],
    [T, 8, 128])``.  Arguments as ``composite_reference``.

    A CUDA ``colors`` launches the CUDA kernel on the current stream (a
    failed build or launch raises); a CPU one runs the plain version.
    ``composite_tiles.launches`` counts kernel launches."""
    if colors.device.type == "cpu":
        return composite_reference(colors, depths, order, owners_sorted, coverage)
    if colors.device.type != "cuda":
        raise ValueError(f"composite_tiles has no kernel for {colors.device}")
    dev = colors.device
    num_layers, num_tiles = colors.shape[0], colors.shape[1]
    require(colors, "colors", torch.float32,
            (num_layers, num_tiles, 4, SUBLANES, LANES), dev)
    require(depths, "depths", torch.float32,
            (num_layers, num_tiles, SUBLANES, LANES), dev)
    require(order, "order", torch.int32, (num_layers,), dev)
    require(owners_sorted, "owners_sorted", torch.int32, (num_layers,), dev)
    require(coverage, "coverage", torch.bool, (num_layers, num_tiles), dev)
    for name, t in (("colors", colors), ("depths", depths)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte copies)")
    out_c = torch.empty((num_tiles, 4, SUBLANES, LANES), dtype=torch.float32,
                        device=dev)
    out_d = torch.empty((num_tiles, SUBLANES, LANES), dtype=torch.float32,
                        device=dev)
    if num_tiles == 0:
        return out_c, out_d
    from . import _build

    lib = _build.load("composite")
    rc = lib.avr_composite_launch(
        colors.data_ptr(), depths.data_ptr(), order.data_ptr(),
        owners_sorted.data_ptr(), coverage.data_ptr(), out_c.data_ptr(),
        out_d.data_ptr(), num_layers, num_tiles,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"composite kernel launch failed: CUDA error {rc}")
    composite_tiles.launches += 1
    return out_c, out_d


composite_tiles.launches = 0


def composite_tiles_hbm(
    colors: Tensor,
    depths: Tensor,
    order: Tensor,
    owners_sorted: Tensor,
    coverage: Tensor,
) -> Tuple[Tensor, Tensor]:
    """The JAX package's streamed variant for more than 96 layers; on the
    GPU the same kernel as ``composite_tiles``."""
    return composite_tiles(colors, depths, order, owners_sorted, coverage)


def composite_pixels_reference(
    layers: Tensor,  # [L, P, 5] f32 pixel-major layers (r, g, b, a, depth)
    order: Tensor,  # [K] int blend order (front first), an index into layers
    owners_sorted: Tensor,  # [K] owner of layers[order[i]]
) -> Tensor:
    """The pixel-mode fold in plain PyTorch, vectorised over pixels; the
    Python loop runs over the layers in order (``order`` may name a subset
    of the layers).  Returns ``[P, 5]``; no layer gives background (colour
    0, depth +inf)."""
    num_pixels = layers.shape[1]
    zero = torch.zeros(num_pixels, dtype=torch.float32, device=layers.device)
    run_c, run_d = [zero] * 4, zero + float("inf")
    tot_c, tot_d = run_c, run_d
    have_tot = False
    owners_l = owners_sorted.tolist()
    for i, b in enumerate(order.tolist()):
        lc = [layers[b, :, ch] for ch in range(4)]
        ld = layers[b, :, 4]
        if i > 0 and owners_l[i] == owners_l[i - 1]:
            run_c, run_d = blend(run_c, run_d, lc, ld)
        else:
            # close the previous owner's run into the running total
            if i > 0:
                if have_tot:
                    tot_c, tot_d = blend(tot_c, tot_d, run_c, run_d)
                else:
                    tot_c, tot_d = run_c, run_d
                have_tot = True
            run_c, run_d = lc, ld
    if have_tot:
        run_c, run_d = blend(tot_c, tot_d, run_c, run_d)
    return torch.stack(run_c + [run_d], dim=-1)


def composite_pixels(layers: Tensor, order: Tensor, owners_sorted: Tensor) -> Tensor:
    """Fold pixel-major layers; returns ``[P, 5]``.  Arguments as
    ``composite_pixels_reference``; on the card ``order`` and
    ``owners_sorted`` are int32.

    A CUDA ``layers`` launches the pixel mode of the CUDA kernel on the
    current stream (a failed build or launch raises); a CPU one runs the
    plain version.  ``composite_pixels.launches`` counts kernel launches."""
    if layers.device.type == "cpu":
        return composite_pixels_reference(layers, order, owners_sorted)
    if layers.device.type != "cuda":
        raise ValueError(f"composite_pixels has no kernel for {layers.device}")
    dev = layers.device
    num_pixels = layers.shape[1]
    # any stride between layers, so a sliced frame stack is read in place
    if (layers.dtype != torch.float32 or layers.dim() != 3
            or layers.shape[2] != 5 or layers.stride()[1:] != (5, 1)):
        raise ValueError("layers must be a float32 [L, P, 5] tensor whose "
                         f"layers are dense, got {layers.dtype} "
                         f"{tuple(layers.shape)} strides {layers.stride()}")
    num_steps = order.shape[0] if order.dim() == 1 else -1
    require(order, "order", torch.int32, (num_steps,), dev)
    require(owners_sorted, "owners_sorted", torch.int32, (num_steps,), dev)
    out = torch.empty((num_pixels, 5), dtype=torch.float32, device=dev)
    if num_pixels == 0:
        return out
    from . import _build

    lib = _build.load("composite")
    rc = lib.avr_composite_pixels_launch(
        layers.data_ptr(), order.data_ptr(), owners_sorted.data_ptr(),
        out.data_ptr(), num_steps, num_pixels,
        layers.stride(0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"composite_pixels kernel launch failed: CUDA error {rc}")
    composite_pixels.launches += 1
    return out


composite_pixels.launches = 0

# the runs mode marks its touched slots in shared memory, a byte a slot
MAX_RUN_SLOTS = 16384


def _identity_runs(rmax: int, num_pixels: int, device) -> Tensor:
    out = torch.zeros((rmax, num_pixels, 5), dtype=torch.float32, device=device)
    out[..., 4] = float("inf")
    return out


def composite_runs_reference(
    layers: Tensor,  # [L, P, 5] f32 pixel-major layers (r, g, b, a, depth)
    local_order: Tensor,  # [L] int: the layer each step folds
    run_slot: Tensor,  # [L] int in [0, rmax): the run buffer each step writes
    rmax: int,
    out: Optional[Tensor] = None,
    carry: bool = False,
) -> Tensor:
    """The runs-mode fold in plain PyTorch, written as the JAX loop is:
    step i takes layer ``local_order[i]``; when ``run_slot[i]`` equals the
    previous step's slot it blends onto the open run (the run on top),
    otherwise the open run is stored in its slot and the layer starts the
    next one.  The last run is stored at the end.

    ``out`` None starts from identity buffers (colour 0, depth +inf), which
    untouched slots keep; a given ``out`` is written in place.  ``carry``
    makes step 0 extend the run already stored in ``out[run_slot[0]]`` (a
    chunk that continues the previous chunk's run).  Returns ``out``."""
    num_pixels = layers.shape[1]
    if out is None:
        out = _identity_runs(rmax, num_pixels, layers.device)
    run_c = run_d = None
    prev = 0
    for i, (j, slot) in enumerate(zip(local_order.tolist(), run_slot.tolist())):
        lc = [layers[j, :, ch] for ch in range(4)]
        ld = layers[j, :, 4]
        if (i > 0 and slot == prev) or (i == 0 and carry):
            if i == 0:
                run_c = [out[slot, :, ch] for ch in range(4)]
                run_d = out[slot, :, 4]
            run_c, run_d = blend(run_c, run_d, lc, ld)
        else:
            if i > 0:
                out[prev] = torch.stack(run_c + [run_d], dim=-1)
            run_c, run_d = lc, ld
        prev = slot
    if run_c is not None:
        out[prev] = torch.stack(run_c + [run_d], dim=-1)
    return out


def composite_runs(
    layers: Tensor,
    local_order: Tensor,
    run_slot: Tensor,
    rmax: int,
    out: Optional[Tensor] = None,
    carry: bool = False,
) -> Tensor:
    """Fold pixel-major layers into ``[rmax, P, 5]`` run buffers; arguments
    and result as ``composite_runs_reference``.  On the card
    ``local_order`` and ``run_slot`` are int32 and ``out`` a contiguous
    float32 ``[rmax, P, 5]``.

    A CUDA ``layers`` launches the runs mode of the CUDA kernel on the
    current stream, one launch (a failed build or launch raises); a CPU one
    runs the plain version.  ``composite_runs.launches`` counts kernel
    launches."""
    if layers.device.type == "cpu":
        return composite_runs_reference(layers, local_order, run_slot, rmax,
                                        out, carry)
    if layers.device.type != "cuda":
        raise ValueError(f"composite_runs has no kernel for {layers.device}")
    dev = layers.device
    num_layers, num_pixels = layers.shape[0], layers.shape[1]
    if (layers.dtype != torch.float32 or layers.dim() != 3
            or layers.shape[2] != 5 or layers.stride()[1:] != (5, 1)):
        raise ValueError("layers must be a float32 [L, P, 5] tensor whose "
                         f"layers are dense, got {layers.dtype} "
                         f"{tuple(layers.shape)} strides {layers.stride()}")
    if not 0 < rmax <= MAX_RUN_SLOTS:
        raise ValueError(f"rmax {rmax} outside (0, {MAX_RUN_SLOTS}]")
    require(local_order, "local_order", torch.int32, (num_layers,), dev)
    require(run_slot, "run_slot", torch.int32, (num_layers,), dev)
    fill = out is None
    if fill:
        out = torch.empty((rmax, num_pixels, 5), dtype=torch.float32, device=dev)
    else:
        require(out, "out", torch.float32, (rmax, num_pixels, 5), dev)
    if num_pixels == 0:
        return out
    from . import _build

    lib = _build.load("composite")
    rc = lib.avr_composite_runs_launch(
        layers.data_ptr(), local_order.data_ptr(), run_slot.data_ptr(),
        out.data_ptr(), num_layers, num_pixels, rmax, layers.stride(0),
        int(carry), int(fill), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"composite_runs kernel launch failed: CUDA error {rc}")
    composite_runs.launches += 1
    return out


composite_runs.launches = 0


def fold_diff_forward_reference(
    colors: Tensor,  # [B, P, 4] f32 premultiplied RGBA layers
    order: Tensor,  # [B] int: layer k of the fold is colors[order[k]]
    keep: bool = False,
) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """The differentiable fold's forward in plain PyTorch, as the eager
    loop computes it: from a zero accumulator, layer by layer front to back,
    ``t_k = 1 - accum.a`` rounded, ``accum = fma(L_k, t_k, accum)`` rounded
    once, then the clip to [0, 1].  Returns ``(image [P, 4], t [B, P],
    unclipped image [P, 4])``, the last two None unless ``keep``.  An
    ``order`` that is not a permutation of the B layers raises, as the
    kernel stops on it."""
    _check_permutation(order, colors.shape[0])
    accum = torch.zeros_like(colors[0])
    trans = colors.new_empty(order.shape + colors.shape[1:2]) if keep else None
    for k, layer in enumerate(order.tolist()):
        t = 1.0 - accum[:, 3:4]
        if keep:
            trans[k] = t[:, 0]
        accum = fma_reference(colors[layer], t, accum)  # FMA
    return _clip(accum, 0.0, 1.0), trans, accum if keep else None


def _clip01_grad(g: Tensor, x: Tensor) -> Tensor:
    """``g`` through ``minimum(maximum(x, 0), 1)``'s backward by autograd's
    rules: ``minimum``'s, then ``maximum``'s (half at a tie, 0 beyond)."""
    y = torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
    g = torch.where(y == 1.0, g / 2, g).masked_fill(y > 1.0, 0.0)
    return torch.where(x == 0.0, g / 2, g).masked_fill(x < 0.0, 0.0)


def fold_diff_backward_reference(
    grad_image: Tensor,  # [P, 4] f32 the image's gradient
    colors: Tensor,
    order: Tensor,
    trans: Tensor,  # [B, P] f32 from the forward
    pre: Tensor,  # [P, 4] f32 the unclipped image
) -> Tensor:
    """The layers' gradient ``[B, P, 4]`` in plain PyTorch, the sweep that
    the backward kernel makes: the clip's gradient by autograd's rules
    (``minimum``'s, then ``maximum``'s), then back to front ``g_L_k = g *
    t_k + 0``, and for k > 0 ``g_t_k``, the float64 sum of the four exact
    products ``g_c * L_k,c`` as ``(p0 + p2) + (p1 + p3)`` (the order of
    PyTorch's CUDA reduction over a row of four) rounded once to float32,
    with ``g.rgb + 0`` and ``g.a - g_t_k``.  Each ``+ 0`` is a zero that
    autograd adds into on the eager path, so a -0.0 comes out +0.0 there
    too.  ``order`` must be a permutation of the B layers."""
    _check_permutation(order, colors.shape[0])
    g = _clip01_grad(grad_image, pre)
    grad = torch.empty_like(colors)
    layers = order.tolist()
    for k in range(len(layers) - 1, -1, -1):
        grad[layers[k]] = g * trans[k, :, None] + 0.0
        if k == 0:
            break
        prod = g.double() * colors[layers[k]].double()  # exact
        g_t = ((prod[:, 0] + prod[:, 2]) + (prod[:, 1] + prod[:, 3])).float()
        g = torch.cat([g[:, :3] + 0.0, g[:, 3:] - g_t[:, None]], dim=1)
    return grad


def _check_permutation(order: Tensor, num_layers: int) -> None:
    if sorted(order.tolist()) != list(range(num_layers)):
        raise ValueError(f"order {order.tolist()} is not a permutation of the "
                         f"{num_layers} layers")


def _fold_check(colors: Tensor, order: Tensor) -> None:
    dev = colors.device
    if dev.type != "cuda":
        raise ValueError("fold_diff's kernels take CUDA tensors; on the CPU "
                         "diff.composite_layers_diff folds with its eager loop")
    require(colors, "colors", torch.float32, (*colors.shape[:2], 4), dev)
    require(order, "order", torch.int64, colors.shape[:1], dev)


def fold_diff_forward(colors: Tensor, order: Tensor, keep: bool = False):
    """The fold's forward; arguments and result as
    ``fold_diff_forward_reference``.  ``colors`` contiguous float32 ``[B,
    P, 4]`` on the card, ``order`` int64 ``[B]`` on its device, a
    permutation that is never read on the host (each block of the kernel
    checks it, and stops on an index out of range or repeated).  One
    launch of ``fold_diff_forward_kernel`` on the current stream, counted
    in ``fold_diff_forward.launches``."""
    _fold_check(colors, order)
    num_layers, num_pixels = colors.shape[0], colors.shape[1]
    image = torch.empty_like(colors[0])
    trans, pre = ((colors.new_empty((num_layers, num_pixels)), torch.empty_like(image))
                  if keep else (None, None))
    from . import _build

    rc = _build.load("composite").avr_fold_diff_forward_launch(
        colors.data_ptr(), order.data_ptr(), image.data_ptr(),
        None if trans is None else trans.data_ptr(), None if pre is None else pre.data_ptr(),
        num_layers, num_pixels, torch.cuda.current_stream(colors.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fold_diff_forward kernel launch failed: CUDA error {rc}")
    fold_diff_forward.launches += 1
    return image, trans, pre


fold_diff_forward.launches = 0


def fold_diff_backward(grad_image: Tensor, colors: Tensor, order: Tensor,
                       trans: Tensor, pre: Tensor) -> Tensor:
    """The layers' gradient; arguments and result as
    ``fold_diff_backward_reference``, CUDA tensors.  One launch of
    ``fold_diff_backward_kernel``, counted in ``fold_diff_backward.launches``;
    it writes every layer's rows once, so ``order`` must be a permutation,
    which the kernel checks as the forward's does."""
    _fold_check(colors, order)
    num_layers, num_pixels = colors.shape[0], colors.shape[1]
    dev = colors.device
    grad_image = grad_image.contiguous()
    require(grad_image, "grad_image", torch.float32, (num_pixels, 4), dev)
    require(trans, "trans", torch.float32, (num_layers, num_pixels), dev)
    require(pre, "pre", torch.float32, (num_pixels, 4), dev)
    grad = torch.empty_like(colors)
    from . import _build

    rc = _build.load("composite").avr_fold_diff_backward_launch(
        grad_image.data_ptr(), colors.data_ptr(), order.data_ptr(), trans.data_ptr(),
        pre.data_ptr(), grad.data_ptr(), num_layers, num_pixels,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fold_diff_backward kernel launch failed: CUDA error {rc}")
    fold_diff_backward.launches += 1
    return grad


fold_diff_backward.launches = 0


class _FoldDiff(torch.autograd.Function):
    """``fold_diff`` under reverse mode: the forward keeps each layer's
    transmittance and the unclipped image for the backward's sweep.  No
    forward-mode rule: a caller with a tangent on the layers takes the
    eager loop (``diff.composite_layers_diff``)."""

    @staticmethod
    def forward(ctx, colors, order):
        image, trans, pre = fold_diff_forward(colors, order, keep=True)
        ctx.save_for_backward(colors, order, trans, pre)
        return image

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_image):
        return fold_diff_backward(grad_image, *ctx.saved_tensors), None


def fold_diff(colors: Tensor, order: Tensor) -> Tensor:
    """The front-to-back over-composite of ``colors`` ``[B, P, 4]`` in
    ``order`` (int64 ``[B]``, a permutation, front first), clipped to [0,
    1]: ``[P, 4]``, differentiable in ``colors`` (CUDA tensors).  One
    forward launch a call, and one backward launch under reverse mode;
    without a gradient to form, the forward keeps nothing."""
    colors = colors.contiguous()
    if torch.is_grad_enabled() and colors.requires_grad:
        return _FoldDiff.apply(colors, order)
    return fold_diff_forward(colors, order)[0]


# ---- the pair fold: the fold of a pair list's rows ---------------------------


def _dot4(g: Tensor, layer: Tensor) -> Tensor:
    """The float64 sum of the four exact products ``g_c * layer_c`` a row,
    rounded once: in the card's order ``(p0 + p2) + (p1 + p3)`` on a CUDA
    tensor (the kernels', and PyTorch's CUDA ``sum_to_size``), else by the
    sum the CPU's autograd of the eager loop forms."""
    prod = g.double() * layer.double()  # exact
    if g.device.type == "cuda":
        return ((prod[:, 0] + prod[:, 2]) + (prod[:, 1] + prod[:, 3])).float()[:, None]
    return prod.sum_to_size(prod.shape[0], 1).float()


def diffpairs_fold_forward_reference(
    raw: Tensor,  # [N, 4] f32 the march's raw rows, a row a pair
    fold_index: Tensor,  # [N] int32
    pixel_start: Tensor,  # [P] int32
    pixel_count: Tensor,  # [P] int32
    keep: bool = False,
) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """The pair fold's forward in plain PyTorch: each pixel's pairs in fold
    order (``diffmarch.Pairs``), each row clipped to [0, 1], then folded as
    ``fold_diff_forward_reference`` folds a layer; then the clip.  Returns
    ``(image [P, 4], t [N] a pair's transmittance, unclipped image)``, the
    last two None unless ``keep``; a pixel whose count is -1 is NaN."""
    counts = pixel_count.long()
    acc = torch.zeros((pixel_start.shape[0], 4), dtype=torch.float32, device=raw.device)
    trans = torch.zeros(fold_index.shape, dtype=torch.float32, device=raw.device) if keep else None
    for s in range(int(counts.max()) if counts.numel() else 0):
        at = (counts > s).nonzero()[:, 0]
        slot = pixel_start[at].long() + s
        layer = _clip(raw[fold_index[slot].long()], 0.0, 1.0)
        a = acc[at]
        t = 1.0 - a[:, 3:4]
        if keep:
            trans[slot] = t[:, 0]
        acc[at] = fma_reference(layer, t, a)  # FMA
    image = _clip(acc, 0.0, 1.0)
    image[counts < 0] = float("nan")
    if keep:
        acc[counts < 0] = float("nan")
    return image, trans, acc if keep else None


def diffpairs_fold_backward_reference(grad_image: Tensor, raw: Tensor, fold_index: Tensor,
                                      pixel_start: Tensor, pixel_count: Tensor,
                                      trans: Tensor, pre: Tensor) -> Tensor:
    """The raw rows' gradient ``[N, 4]`` in plain PyTorch, as the backward
    kernel sweeps it: the image clip's rule, then each pixel's pairs back
    to front, ``g * t + 0`` through the row's clip, and for every pair but
    the pixel's first ``g.rgb + 0``, ``g.a - g_t`` (``_dot4`` against the
    clipped row).  Rows of no pair are 0."""
    counts = pixel_count.long()
    g = _clip01_grad(grad_image, pre)
    grad = torch.zeros_like(raw)
    for s in range(int(counts.max()) - 1 if counts.numel() else -1, -1, -1):
        at = (counts > s).nonzero()[:, 0]
        slot = pixel_start[at].long() + s
        q = fold_index[slot].long()
        row = raw[q]
        gs = g[at]
        grad[q] = _clip01_grad(gs * trans[slot][:, None] + 0.0, row)
        if s > 0:
            g_t = _dot4(gs, _clip(row, 0.0, 1.0))
            g[at] = torch.cat([gs[:, :3] + 0.0, gs[:, 3:] - g_t], dim=1)
    return grad


def _pairs_fold_check(raw: Tensor, fold_index: Tensor, pixel_start: Tensor,
                      pixel_count: Tensor) -> None:
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError("the pair fold's kernels take CUDA tensors")
    rows, pixels = raw.shape[0], pixel_start.shape[0]
    require(raw, "raw", torch.float32, (rows, 4), dev)
    require(fold_index, "fold_index", torch.int32, (rows,), dev)
    require(pixel_start, "pixel_start", torch.int32, (pixels,), dev)
    require(pixel_count, "pixel_count", torch.int32, (pixels,), dev)


def diffpairs_fold_forward(raw: Tensor, fold_index: Tensor, pixel_start: Tensor,
                           pixel_count: Tensor, keep: bool = False):
    """The pair fold's forward; arguments and result as
    ``diffpairs_fold_forward_reference``, CUDA tensors.  One launch of
    ``diffpairs_fold_forward_kernel``, a thread a pixel, counted in
    ``diffpairs_fold_forward.launches``."""
    _pairs_fold_check(raw, fold_index, pixel_start, pixel_count)
    pixels = pixel_start.shape[0]
    image = torch.empty((pixels, 4), dtype=torch.float32, device=raw.device)
    trans, pre = ((torch.empty_like(fold_index, dtype=torch.float32), torch.empty_like(image))
                  if keep else (None, None))
    from . import _build

    rc = _build.load("composite").avr_diffpairs_fold_forward_launch(
        raw.data_ptr(), fold_index.data_ptr(), pixel_start.data_ptr(), pixel_count.data_ptr(),
        image.data_ptr(), None if trans is None else trans.data_ptr(),
        None if pre is None else pre.data_ptr(), pixels,
        torch.cuda.current_stream(raw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"diffpairs_fold_forward kernel launch failed: CUDA error {rc}")
    diffpairs_fold_forward.launches += 1
    return image, trans, pre


diffpairs_fold_forward.launches = 0


def diffpairs_fold_backward(grad_image: Tensor, raw: Tensor, fold_index: Tensor,
                            pixel_start: Tensor, pixel_count: Tensor, trans: Tensor,
                            pre: Tensor) -> Tensor:
    """The raw rows' gradient; arguments and result as
    ``diffpairs_fold_backward_reference``, CUDA tensors, the rows of no
    pair left unwritten.  One launch of ``diffpairs_fold_backward_kernel``,
    counted in ``diffpairs_fold_backward.launches``."""
    _pairs_fold_check(raw, fold_index, pixel_start, pixel_count)
    pixels = pixel_start.shape[0]
    dev = raw.device
    grad_image = grad_image.contiguous()
    require(grad_image, "grad_image", torch.float32, (pixels, 4), dev)
    require(trans, "trans", torch.float32, fold_index.shape, dev)
    require(pre, "pre", torch.float32, (pixels, 4), dev)
    grad = torch.empty_like(raw)
    from . import _build

    rc = _build.load("composite").avr_diffpairs_fold_backward_launch(
        grad_image.data_ptr(), raw.data_ptr(), fold_index.data_ptr(), pixel_start.data_ptr(),
        pixel_count.data_ptr(), trans.data_ptr(), pre.data_ptr(), grad.data_ptr(), pixels,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"diffpairs_fold_backward kernel launch failed: CUDA error {rc}")
    diffpairs_fold_backward.launches += 1
    return grad


diffpairs_fold_backward.launches = 0


class _FoldPairs(torch.autograd.Function):
    """``fold_pairs`` under reverse mode: the forward keeps each pair's
    transmittance and the unclipped image for the backward's sweep."""

    @staticmethod
    def forward(ctx, raw, fold_index, pixel_start, pixel_count):
        args = (raw, fold_index, pixel_start, pixel_count)
        if raw.device.type == "cuda":
            image, trans, pre = diffpairs_fold_forward(*args, keep=True)
        else:
            image, trans, pre = diffpairs_fold_forward_reference(*args, keep=True)
        ctx.save_for_backward(*args, trans, pre)
        return image

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_image):
        saved = ctx.saved_tensors
        fn = (diffpairs_fold_backward if grad_image.device.type == "cuda"
              else diffpairs_fold_backward_reference)
        return fn(grad_image, *saved), None, None, None


def fold_pairs(raw: Tensor, pairs) -> Tensor:
    """The front-to-back over-composite of a pair list's raw march rows
    ``raw`` ``[N, 4]`` (``diffmarch.Pairs``: each pixel's pairs in fold
    order), each row clipped to [0, 1] first, the image clipped after:
    ``[P, 4]``, differentiable in ``raw``; the dense fold's image bit for
    bit.  On the card one forward launch, and one backward launch under
    reverse mode; on the CPU the plain versions."""
    args = (raw.contiguous(), pairs.fold_index, pairs.pixel_start, pairs.pixel_count)
    if torch.is_grad_enabled() and raw.requires_grad:
        return _FoldPairs.apply(*args)
    if raw.device.type == "cuda":
        return diffpairs_fold_forward(*args)[0]
    return diffpairs_fold_forward_reference(*args)[0]
