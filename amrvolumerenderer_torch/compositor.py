"""Sort-last compositing order and its host oracle.

The port's part of the JAX package's ``compositor.py``: the global layer
order of composeLayered (DirectSendBase.cpp:378-388) and the
reference-faithful host fold that the tests hold the device composite
against.  The device fold itself is ``ops/composite.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .image import blend_depth_sort


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
