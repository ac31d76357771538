"""Cross-brick ghost rings for seam-free trilinear sampling (NumPy).

The tile-march kernel interpolates into a 1-cell ghost ring around every
piece.  Split boundaries inside a brick fill the ring from the same brick
(``fast_scene._split_to_cubes``); this module fills it at BRICK
boundaries: each ring cell whose centre lies inside another brick takes
that brick's nearest-cell value, so abutting bricks interpolate
seam-free.  Ring cells outside every brick stay edge-replicated.  The
port of the JAX package's ``ghost.ghost_fill``, on NumPy arrays or on
tensors (which stay on their device; the ring positions are host work).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def edge_pad(data, ghost: int):
    """``data`` padded by ``ghost`` cells on every side by edge
    replication (``np.pad(..., mode="edge")``), for an array or a float
    tensor."""
    if isinstance(data, np.ndarray):
        return np.pad(data, ghost, mode="edge")
    pad = (ghost,) * 6
    return torch.nn.functional.pad(data[None, None], pad, mode="replicate")[0, 0]


def _ring_slabs(shape: np.ndarray, ghost: int) -> List[Tuple[slice, ...]]:
    """Decompose the ghost ring of a padded [n + 2g]^3 array into 6 slabs
    covering every ring cell exactly once (corners/edges land in the
    lowest-axis slab that contains them)."""
    g = ghost
    n = shape
    full = [slice(0, int(n[d]) + 2 * g) for d in range(3)]
    core = [slice(g, int(n[d]) + g) for d in range(3)]
    slabs = []
    for d in range(3):
        lo = list(full)
        hi = list(full)
        for dd in range(d):
            lo[dd] = core[dd]
            hi[dd] = core[dd]
        lo[d] = slice(0, g)
        hi[d] = slice(int(n[d]) + g, int(n[d]) + 2 * g)
        slabs.append(tuple(lo))
        slabs.append(tuple(hi))
    return slabs


def ghost_fill(
    pre_bricks: Sequence,  # per brick: (nx, ny, nz) pre-transformed array/tensor
    boxes: Sequence[Tuple[np.ndarray, np.ndarray]],  # (min_corner, max_corner)
    ghost: int = 1,
) -> List[np.ndarray]:
    """Edge-pad every brick by ``ghost`` cells and fill ring cells covered
    by another brick with that brick's nearest-cell value.  Returns the
    padded arrays or tensors (shape + 2*ghost per axis)."""
    num = len(pre_bricks)
    mins = np.array([np.asarray(b[0], float) for b in boxes])
    maxs = np.array([np.asarray(b[1], float) for b in boxes])
    shapes = [np.asarray(pre_bricks[i].shape, int) for i in range(num)]
    spans = [
        np.where(shapes[i] > 0, (maxs[i] - mins[i]) / np.maximum(shapes[i], 1), 1.0)
        for i in range(num)
    ]
    # ring positions clamp into the domain box before the containment test,
    # so a ring cell outside the domain on some axis takes the neighbour's
    # edge value there (what edge padding of the union field would store);
    # the clamp epsilon stays well below the finest cell span
    dlo = mins.min(axis=0)
    dhi = maxs.max(axis=0)
    finest = np.stack(spans).min(axis=0)
    deps = np.minimum(
        1e-3 * np.maximum(finest, 1e-30),
        1e-6 * np.maximum(dhi - dlo, 1e-30),
    )

    # brick j is a candidate for brick i when j's box overlaps i's ghost shell
    span_arr = np.stack(spans)
    glo_all = mins - ghost * span_arr
    ghi_all = maxs + ghost * span_arr
    eps_all = 1e-9 * np.maximum(np.abs(ghi_all - glo_all), 1.0)
    overlap = np.all(
        (maxs[None, :, :] > (glo_all + eps_all)[:, None, :])
        & (mins[None, :, :] < (ghi_all - eps_all)[:, None, :]),
        axis=-1,
    )
    np.fill_diagonal(overlap, False)

    out = []
    for i in range(num):
        padded = edge_pad(pre_bricks[i], ghost)
        cand = np.nonzero(overlap[i])[0]
        for sl in _ring_slabs(shapes[i], ghost) if cand.size else ():
            axes_idx = [np.arange(s.start, s.stop) for s in sl]
            if any(a.size == 0 for a in axes_idx):
                continue
            idx = np.stack(np.meshgrid(*axes_idx, indexing="ij"), axis=-1)
            pos = mins[i] + (idx - ghost + 0.5) * spans[i]
            pos = np.clip(pos, dlo + deps, dhi - deps)
            for j in cand:
                inside = np.all((pos >= mins[j]) & (pos < maxs[j]), axis=-1)
                if not inside.any():
                    continue
                src = np.floor((pos - mins[j]) / spans[j]).astype(np.int64)
                src = np.clip(src, 0, shapes[j] - 1)
                src[~inside] = 0
                if isinstance(padded, torch.Tensor):
                    src = torch.from_numpy(src).to(padded.device)
                    inside = torch.from_numpy(inside).to(padded.device)
                vals = pre_bricks[j][src[..., 0], src[..., 1], src[..., 2]]
                region = padded[sl]  # a view: the assignment writes through
                region[inside] = vals[inside]
        out.append(padded)
    return out
