"""Sort-last compositing: the layer order, the run-grouped fold and its
host oracle.

The port's part of the JAX package's ``compositor.py``: the global layer
order of composeLayered (DirectSendBase.cpp:378-388), the reference-
faithful host fold that the tests hold the device composites against, and
``_composite_sorted_runs``, the run-grouped fold the multi-device
pipelines run on each shard, through the pixel mode of the
``ops/composite.py`` kernel on the layers' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .image import blend_depth_sort
from .ops import composite as comp


def sort_layers(
    depth_hints: np.ndarray, owners: np.ndarray, local_indices: np.ndarray
) -> np.ndarray:
    """Global layer order: (depth, owner, local index) lexicographic
    (DirectSendBase.cpp:378-388).  Returns the permutation."""
    return np.lexsort((local_indices, owners, depth_hints)).astype(np.int32)


def composite_layers_host(
    layers: np.ndarray,  # [L, P, 5]
    depth_hints: np.ndarray,  # [L]
    owners: np.ndarray,  # [L]
    local_indices: np.ndarray,  # [L]
) -> np.ndarray:
    """Reference-faithful host fold (oracle): per-owner runs are folded
    first, then the runs in order — the depth-sort blend is not
    associative in depth-tie cases, so the structure matters."""
    order = sort_layers(depth_hints, owners, local_indices)
    accumulated: Optional[np.ndarray] = None
    i = 0
    while i < len(order):
        owner = owners[order[i]]
        run = layers[order[i]]
        i += 1
        while i < len(order) and owners[order[i]] == owner:
            run = blend_depth_sort(run, layers[order[i]])
            i += 1
        accumulated = run if accumulated is None else blend_depth_sort(accumulated, run)
    if accumulated is None:
        return np.zeros((layers.shape[1], 5), dtype=np.float32)
    return accumulated


def _composite_sorted_runs(
    sorted_layers: torch.Tensor,  # [L, P, 5] already in blend order
    sorted_owners: torch.Tensor,  # [L] int32 on the layers' device
) -> torch.Tensor:
    """Run-grouped fold over pre-sorted layers (compositor.py:81-119 of
    the JAX package): consecutive same-owner layers fold into a run, each
    finished run into the total.  One ``ops.composite.composite_pixels``
    call with the identity order: a kernel launch on a CUDA tensor, its
    plain version on a CPU one.  Both round as XLA:CPU contracts the JAX
    loop: one FMA per colour channel per blend.  No layer gives
    background (colour 0, depth +inf)."""
    dev = sorted_layers.device
    return comp.composite_pixels(
        sorted_layers.contiguous(),
        torch.arange(sorted_layers.shape[0], dtype=torch.int32, device=dev),
        sorted_owners.to(torch.int32).contiguous())


def composite_layers_device(
    layers: torch.Tensor,  # [L, P, 5]
    depth_hints: np.ndarray,  # [L] (host)
    owners: np.ndarray,  # [L] (host)
    local_indices: np.ndarray,  # [L] (host)
) -> torch.Tensor:
    """Layered composite on the layers' device: host-side sort, device
    fold through the order index (no gathered copy).  Returns [P, 5]."""
    order = sort_layers(depth_hints, owners, local_indices)
    dev = layers.device
    sorted_owners = torch.from_numpy(
        np.asarray(owners)[order].astype(np.int32)).to(dev)
    return comp.composite_pixels(layers.contiguous(),
                                 torch.from_numpy(order).to(dev), sorted_owners)
