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

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .march import blend, require
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
    order: Tensor,  # [L] int blend order (front first), an index into layers
    owners_sorted: Tensor,  # [L] owner of layers[order[i]]
) -> Tensor:
    """The pixel-mode fold in plain PyTorch, vectorised over pixels; the
    Python loop runs over the layers in order.  Returns ``[P, 5]``; no
    layer gives background (colour 0, depth +inf)."""
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
    num_layers, num_pixels = layers.shape[0], layers.shape[1]
    # any stride between layers, so a sliced frame stack is read in place
    if (layers.dtype != torch.float32 or layers.dim() != 3
            or layers.shape[2] != 5 or layers.stride()[1:] != (5, 1)):
        raise ValueError("layers must be a float32 [L, P, 5] tensor whose "
                         f"layers are dense, got {layers.dtype} "
                         f"{tuple(layers.shape)} strides {layers.stride()}")
    require(order, "order", torch.int32, (num_layers,), dev)
    require(owners_sorted, "owners_sorted", torch.int32, (num_layers,), dev)
    out = torch.empty((num_pixels, 5), dtype=torch.float32, device=dev)
    if num_pixels == 0:
        return out
    from . import _build

    lib = _build.load("composite")
    rc = lib.avr_composite_pixels_launch(
        layers.data_ptr(), order.data_ptr(), owners_sorted.data_ptr(),
        out.data_ptr(), num_layers, num_pixels,
        layers.stride(0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"composite_pixels kernel launch failed: CUDA error {rc}")
    composite_pixels.launches += 1
    return out


composite_pixels.launches = 0
