"""Sort-last compositing: the layer order, the run-grouped fold, its
host oracle and the flat direct-send mode on the host.

The port of the JAX package's ``compositor.py``: the global layer order of
composeLayered (DirectSendBase.cpp:378-388), the reference-faithful host
fold that the tests hold the device composites against,
``_composite_sorted_runs``, the run-grouped fold the multi-device
pipelines run on each shard through the pixel mode of the
``ops/composite.py`` kernel on the layers' device, and the flat mode
(compose, DirectSendBase.cpp:257-314) over per-rank images on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .image import ImageBuffer, blend_depth_sort
from .ops import composite as comp


def piece_range(image_size: int, piece_index: int, num_pieces: int) -> Tuple[int, int]:
    """Contiguous pixel piece for one receiver (DirectSendBase.cpp:59-74):
    equal sizes, remainder to the last piece."""
    piece_size = image_size // num_pieces
    begin = piece_size * piece_index
    end = begin + piece_size if piece_index < num_pieces - 1 else image_size
    return begin, end


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


def compose_flat_host(
    rank_images: Sequence[ImageBuffer],
    group_order: np.ndarray,
    max_image_split: int = 1_000_000,
    compress: bool = False,
) -> List[ImageBuffer]:
    """Flat direct-send compose (DirectSendBase.cpp:257-314) on the host.

    ``rank_images[r]`` is rank r's full local image; ``group_order`` the
    visibility permutation (group index -> rank, earlier on top).  Returns
    one composited piece per receiver, covering ``piece_range(num_pixels,
    i, num_receivers)``.  With ``compress=True`` each sent piece travels
    and blends as a ``CompactImage`` and is uncompressed at the end, as
    the reference's image-compress mode does; pixels outside the valid
    viewport and background-classified depth pixels then come back as
    cleared background."""
    group_size = len(group_order)
    num_receivers = min(max_image_split, group_size)
    assert group_size >= 1
    image_size = rank_images[0].num_pixels
    pieces: List[ImageBuffer] = []
    for recv_idx in range(num_receivers):
        begin, end = piece_range(image_size, recv_idx, num_receivers)
        acc = None
        for send_idx in range(group_size):  # group order: first on top
            piece = rank_images[int(group_order[send_idx])].window(begin, end)
            if compress:
                piece = piece.compress()
            acc = piece.deep_copy() if acc is None else acc.blend(piece)
        pieces.append(acc.uncompress() if compress else acc)
    return pieces


def assemble_pieces(pieces: Sequence[ImageBuffer]) -> ImageBuffer:
    """Concatenate per-receiver pieces into a full-frame image (the
    reference's gather to rank 0, ImageColorOnly.hpp:220-270)."""
    assert pieces
    first = pieces[0]
    out = ImageBuffer.create(first.kind, first.width, first.height, 0,
                             first.width * first.height)
    for p in pieces:
        out.pixels[p.region_begin:p.region_end] = np.asarray(p.pixels)
    return out
