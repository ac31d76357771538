"""Tile-space compositor: fold every piece layer of a tile in one pass.

The port of the JAX package's ``ops/composite.py`` kernels
(``composite_tiles`` and ``composite_tiles_hbm``).  For each pixel it
walks the layers in blend order (front first), reads a layer's block only
where ``coverage`` marks it scheduled (elsewhere the layer is background:
colour 0, depth +inf, with no read, so an undefined block never reaches a
pixel) and applies composeLayered's same-owner run fold: runs of
consecutive same-owner layers blend first, then the runs
(DirectSendBase.cpp:378-446).  Ties in the depth-sort blend keep the top.

``composite_tiles`` launches ``csrc/composite.cu`` for CUDA tensors and
runs ``composite_reference``, the same fold in plain PyTorch, for CPU
tensors.  The TPU needed a second, DMA-streamed kernel past 96 layers
(its VMEM limit); a GPU thread keeps only its running sums in registers,
so one kernel serves any layer count and ``composite_tiles_hbm`` is the
same call.
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
