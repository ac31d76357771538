"""Multi-device sort-last compositing over a list of shard devices.

The port of the JAX package's ``parallel/directsend.py`` one-shot
pipelines: the reference's direct-send exchange
(``DirectSend/Base/DirectSendBase.cpp``) over D shards held by one
process, the counterpart of JAX's single-controller ``shard_map``.

* A ``Mesh`` is the list of shard devices.  ``device="cpu"`` gives D
  shards on the CPU; CUDA gives D shards placed round-robin over the
  visible cards, so one card may hold several shards (JAX instead raises
  when fewer devices are visible than asked for).
* Each shard owns a block of the brick table and renders its pieces into
  full-frame layers on its own device (``ops.slicemarch.slicemarch_render``
  or ``ops.tilemarch.tilemarch_render``), one launch per shard.
* ``all_to_all`` exchanges pixel chunks: on shard r, ``received[s]`` is
  shard s's chunk r (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``);
  ``all_gather`` stacks every shard's value on every shard.  Both are
  device-to-device copies (``Tensor.to``), which PyTorch orders after the
  producing device's current stream and before the consuming one's; on
  one card every copy is local and stays on that card's stream.
* Each shard folds the layers of its pixel shard in the global (depth,
  owner, local index) order with the pixel mode of the composite kernel
  (``ops.composite.composite_pixels``), one launch per fold, reading the
  layers through the sort's index.

Functions that take a shard's tensors take its device from the mesh;
none defaults to the CPU.  Results are lists of per-shard pixel shards
(shard r holds rows ``[r * P / D, (r + 1) * P / D)`` of the frame).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compositor import _composite_sorted_runs, sort_layers
from ..device import DEFAULT_DEVICE, Device, resolve_device
from ..image import byte_to_color_device, color_to_byte_device
from ..ops import composite as comp
from ..ops import slicemarch as sm
from ..ops import tilemarch as tm

Tensor = torch.Tensor
Shards = List[Tensor]  # one tensor per shard, on that shard's device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The compositing axis: one device per shard, in shard order."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _subset_devices(devices: Sequence[torch.device], num_devices: int):
    """``num_devices`` shard devices from the visible ``devices``: a
    prefix where there are enough (the JAX package's single-host policy),
    else round-robin over all of them."""
    return [devices[i % len(devices)] for i in range(num_devices)]


def make_mesh(num_devices: Optional[int] = None,
              device: Device = DEFAULT_DEVICE) -> Mesh:
    """A mesh of ``num_devices`` shards (default: one per visible device)
    on ``device``'s kind: the CPU, or the visible CUDA cards starting at
    ``device``'s index."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        visible = [dev]
    else:
        count = torch.cuda.device_count()
        visible = [torch.device("cuda", (dev.index + i) % count)
                   for i in range(count)]
    num = len(visible) if num_devices is None else int(num_devices)
    if num < 1:
        raise ValueError("devices must be a positive device count")
    return Mesh(tuple(_subset_devices(visible, num)))


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (kernels launch on it)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _as_tensor(a) -> Tensor:
    return a if isinstance(a, Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def _constant_camera(cam) -> Tensor:
    """The [20] camera pack as the JAX pipelines' programs see it.

    There the camera is a compile-time constant of the jitted shard
    program, and XLA:CPU re-associates the ray's image-plane terms
    ``((ndc * tan) * aspect) * right`` into ``ndc * ((tan * aspect) *
    right)`` (and ``(ndc * tan) * up`` into ``ndc * (tan * up)``), folding
    the constants in float32.  Passing the folded vectors with tan =
    aspect = 1 makes the kernels' ray (``march.cuh::make_ray``,
    ``ops.march.tile_rays``) round the same way; unfolded, the frames
    differ from the JAX pipelines' by up to 3.2e-6."""
    c = np.array(_as_tensor(cam).cpu().numpy(), dtype=np.float32)
    tan, aspect = c[12], c[13]
    c[6:9] = (tan * aspect) * c[6:9]
    c[9:12] = tan * c[9:12]
    c[12] = c[13] = np.float32(1.0)
    return torch.from_numpy(c)


def shard_leading(mesh: Mesh, *arrays) -> Tuple[Shards, ...]:
    """Split each array's leading axis into ``mesh.size`` equal blocks and
    place block r on shard r's device (NumPy arrays or tensors)."""
    out = []
    for a in arrays:
        t = _as_tensor(a)
        if t.shape[0] % mesh.size:
            raise ValueError(
                f"leading axis {t.shape[0]} is not divisible by the mesh "
                f"size {mesh.size}")
        n = t.shape[0] // mesh.size
        out.append([t[r * n:(r + 1) * n].to(dev).contiguous()
                    for r, dev in enumerate(mesh.devices)])
    return tuple(out)


def all_to_all(mesh: Mesh, chunks: Shards) -> Shards:
    """``chunks[s]`` is shard s's [D, ...] send buffer; returns
    ``received`` with ``received[r][s] = chunks[s][r]`` on shard r."""
    return [torch.stack([chunks[s][r].to(dev) for s in range(mesh.size)])
            for r, dev in enumerate(mesh.devices)]


def all_gather(mesh: Mesh, xs: Shards) -> Shards:
    """Every shard's value stacked [D, ...] on every shard."""
    return [torch.stack([x.to(dev) for x in xs]) for dev in mesh.devices]


def _exchange(mesh: Mesh, frames: Shards, transport: str = "float32") -> Shards:
    """The pixel-piece exchange (DirectSendBase.cpp:76-177): ``frames[s]``
    is shard s's [..., P, C] stack; returns, on shard r, [D, ..., P / D, C]
    with sender s's frames restricted to r's pixel shard.
    ``transport="ubyte"`` sends colours as bytes through the Mesa codec
    (the reference's colour-ubyte compositing axis, Common/Color.hpp;
    channel 4 stays float32)."""
    num = mesh.size

    def chunks(x):  # [..., P, C] -> [D, ..., P / D, C]
        lead = x.shape[:-2]
        y = x.reshape(lead + (num, x.shape[-2] // num, x.shape[-1]))
        return y.movedim(len(lead), 0)

    if transport == "ubyte":
        rc = all_to_all(mesh, [chunks(color_to_byte_device(f[..., :4]))
                               for f in frames])
        rd = all_to_all(mesh, [chunks(f[..., 4:]) for f in frames])
        return [torch.cat([byte_to_color_device(c), d], dim=-1)
                for c, d in zip(rc, rd)]
    if transport != "float32":
        raise ValueError(f"unknown transport {transport!r}")
    return all_to_all(mesh, [chunks(f) for f in frames])


def _fold_layers(mesh: Mesh, received: Shards, gathered: Shards) -> Shards:
    """Each shard's fold of the exchanged layers of its pixel shard in the
    global (depth, owner, local index) order.  ``received[r]`` is [D,
    Lmax, P / D, 5] and ``gathered[r]`` the [D, Lmax] hints: flattened,
    they are in (owner, local index) order, so a stable argsort by depth
    gives the exact lexicographic order (DirectSendBase.cpp:329-388);
    owner = shard index.  Returns each shard's [P / D, 5] pixels."""
    out = []
    for r, dev in enumerate(mesh.devices):
        with _on(dev):
            num, lmax = received[r].shape[:2]
            all_layers = received[r].reshape(num * lmax, -1, received[r].shape[-1])
            owners = torch.arange(num, dtype=torch.int32,
                                  device=dev).repeat_interleave(lmax)
            order = torch.argsort(gathered[r].reshape(-1), stable=True)
            out.append(comp.composite_pixels(all_layers, order.to(torch.int32),
                                             owners[order]))
    return out


def _compose_shards(mesh: Mesh, layers: Shards, hints: Shards,
                    transport: str = "float32") -> Shards:
    """Exchange pixel chunks and fold each pixel shard in global order.
    ``layers[r]`` is shard r's [Lmax, P, 5] (padding slots cleared),
    ``hints[r]`` its [Lmax] depth hints (+inf on padding)."""
    return _fold_layers(mesh, _exchange(mesh, layers, transport),
                        all_gather(mesh, hints))


def composite_layers_sharded(
    mesh: Mesh,
    layers,  # [D * Lmax, P, 5] global, split on axis 0
    hints,  # [D * Lmax]
    transport: str = "float32",
) -> Shards:
    """Composite pre-rendered layers across the mesh.  ``P`` must be a
    multiple of the mesh size; ``transport`` selects the exchange payload
    ("float32" exact, "ubyte" = the reference's byte-colour compositing).
    Returns the [P / D, 5] pixel shards."""
    layers_s, hints_s = shard_leading(mesh, layers, hints)
    if layers_s[0].shape[1] % mesh.size:
        raise ValueError("pixel count is not divisible by the mesh size")
    return _compose_shards(mesh, layers_s, hints_s, transport)


def compose_flat_sharded(
    mesh: Mesh,
    images,  # [D, P, C] one full premultiplied image per shard
    group_order: np.ndarray,  # [D] visibility permutation; first = on top
) -> Shards:
    """Flat direct-send compose (DirectSendBase.cpp:257-314): every
    shard's image is split into pixel pieces with one ``all_to_all`` and
    each shard folds its D pieces in group order (earlier member on top,
    Compositor.hpp:26-29).  Returns the [P / D, C] pixel shards."""
    (imgs,) = shard_leading(mesh, images)
    if imgs[0].shape[1] % mesh.size:
        raise ValueError("pixel count is not divisible by the mesh size")
    order = [int(g) for g in np.asarray(group_order)]
    out = []
    for r, recv in enumerate(_exchange(mesh, [img[0] for img in imgs])):
        with _on(mesh.devices[r]):
            acc = recv[order[0]]
            for g in order[1:]:
                # acc is on top of the next piece (group order = blend order)
                acc = acc + recv[g] * (1.0 - acc[:, 3:4])
            out.append(acc)
    return out


def _contiguous_chunk_counts(n: int, num_devices: int):
    """Nearly-equal contiguous chunk sizes (remainder spread over the
    first chunks): the one place the depth-contiguous split policy
    lives, shared by the packers and the tile work lists."""
    base, extra = n // num_devices, n % num_devices
    return [base + (1 if d < extra else 0) for d in range(num_devices)]


def _fold_partials(mesh: Mesh, received: Shards) -> Shards:
    """Each shard's fold of the D exchanged partials of its pixel shard
    ([D, P / D, 5]) in shard order, which is depth order (see
    ``composite_partials_sharded``): every partial its own run."""
    out = []
    for recv, dev in zip(received, mesh.devices):
        with _on(dev):
            keys = torch.arange(mesh.size, dtype=torch.int32, device=dev)
            out.append(_composite_sorted_runs(recv, keys))
    return out


def _exchange_fold_partials(mesh: Mesh, partials: Shards,
                            transport: str = "float32") -> Shards:
    """Exchange the D depth-contiguous partial frames (one [P, 5] per
    shard) and fold them."""
    return _fold_partials(mesh, _exchange(mesh, partials, transport))


def depth_contiguous_assignment(
    depth_hints: np.ndarray,
    owners_hint_ties: np.ndarray,
    num_devices: int,
) -> np.ndarray:
    """Shard of each brick for this frame: bricks sorted by (hint, tie)
    split into ``num_devices`` nearly equal contiguous chunks, so each
    shard owns a contiguous run of the global depth order and the
    cross-shard step folds D frames.  Returns device_of_brick [N]."""
    n = len(depth_hints)
    order = sort_layers(
        np.asarray(depth_hints), np.asarray(owners_hint_ties),
        np.arange(n, dtype=np.int32),
    )
    device_of_brick = np.zeros(n, dtype=np.int32)
    pos = 0
    for d, count in enumerate(_contiguous_chunk_counts(n, num_devices)):
        device_of_brick[order[pos: pos + count]] = d
        pos += count
    return device_of_brick


def composite_partials_sharded(
    mesh: Mesh,
    partials,  # [D, P, 5]: shard d's pre-composited frame, depth run d
    transport: str = "float32",
) -> Shards:
    """Fold depth-contiguous per-shard partial frames front to back: one
    all_to_all of D frames in place of the layered exchange.  Exact where
    each pixel's layer depths sort consistently with the run grouping
    (disjoint AMR bricks; the JAX package's docstring has the argument).
    Returns the [P / D, 5] pixel shards."""
    (parts,) = shard_leading(mesh, partials)
    if parts[0].shape[1] % mesh.size:
        raise ValueError("pixel count is not divisible by the mesh size")
    return _exchange_fold_partials(mesh, [p[0] for p in parts], transport)


def pack_depth_contiguous(
    depth_hints: np.ndarray,
    owners_hint_ties: np.ndarray,
    num_devices: int,
    *arrays: np.ndarray,
):
    """Per-frame host repack for the depth-contiguous pipeline: shard d
    receives the d-th contiguous chunk of the global depth order in slots
    ``[d * Bmax, (d + 1) * Bmax)``, padding slots cleared.  Returns
    ``(packed_arrays, valid, packed_hints)``."""
    n = len(depth_hints)
    order = sort_layers(
        np.asarray(depth_hints), np.asarray(owners_hint_ties),
        np.arange(n, dtype=np.int32),
    )
    return _pack_slots(order, np.asarray(depth_hints), num_devices, arrays)


def _pack_slots(order, depth_hints, num_devices, arrays):
    """Scatter bricks (taken in ``order``) into contiguous per-shard slot
    chunks padded to a common Bmax with zeros (a zero slot marches
    nothing): the shared body of the two packers."""
    n = len(order)
    counts = _contiguous_chunk_counts(n, num_devices)
    bmax = max(max(counts), 1)
    total = num_devices * bmax

    valid = np.zeros(total, dtype=bool)
    packed_hints = np.full(total, np.inf, dtype=np.float32)
    packed = [
        np.zeros((total,) + a.shape[1:], dtype=a.dtype) for a in arrays
    ]
    pos = 0
    for d in range(num_devices):
        for slot in range(counts[d]):
            src = int(order[pos])
            dst = d * bmax + slot
            valid[dst] = True
            packed_hints[dst] = depth_hints[src]
            for p, a in zip(packed, arrays):
                p[dst] = a[src]
            pos += 1
    return tuple(packed), valid, packed_hints


def pack_contiguous(num_devices: int, depth_hints: np.ndarray, *arrays: np.ndarray):
    """Host packer for the layered pipeline: brick arrays already in
    (owner, local index) order split into contiguous per-shard chunks, so
    the flattened [shard, slot] order is the global (owner, local) order
    and the stable depth argsort in the fold reproduces the reference's
    (depth, owner, local) order.  Returns ``(packed_arrays, valid,
    packed_hints)``."""
    n = len(depth_hints)
    return _pack_slots(
        np.arange(n, dtype=np.int32), np.asarray(depth_hints),
        num_devices, arrays,
    )


def coverage_rect(
    coverage: np.ndarray,  # [B, T] bool tile coverage
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    num_devices: int,
):
    """Union screen rectangle of the pieces' tile coverage, tile-aligned:
    pixels outside it are background on every shard and are not
    exchanged.  Returns ``(x0, y0, rw, rh)`` in pixels, or None when it is
    the full frame or its pixel count does not divide the mesh."""
    tiles_x = width // tile_w
    tiles_y = height // tile_h
    tiles = np.asarray(coverage).any(axis=0).reshape(tiles_y, tiles_x)
    ys, xs = np.nonzero(tiles)
    if len(xs) == 0:
        if (tile_w * tile_h) % num_devices:
            return None
        return (0, 0, tile_w, tile_h)
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    rw = (x1 - x0) * tile_w
    rh = (y1 - y0) * tile_h
    if rw * rh >= width * height or (rw * rh) % num_devices:
        return None
    return (x0 * tile_w, y0 * tile_h, rw, rh)


def _compact_pixels(rect, tiles, width: int, height: int) -> int:
    """Exchanged pixel count under the selected compaction."""
    if rect:
        return rect[2] * rect[3]
    if tiles:
        return len(tiles[0])
    return width * height


def coverage_tiles(
    coverage: np.ndarray,  # [B, T] bool tile coverage
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    num_devices: int,
):
    """Active-tile compaction: the pixels of every tile any piece covers
    (the static-shape counterpart of the reference's RLE transport,
    ImageSparse.hpp:17-150).  Returns ``(pix_idx, valid_pixels,
    fraction)``: ``pix_idx`` [P_pad] int32 row-major pixel ids, padded
    with pixel 0 to a multiple of the mesh size (read-only duplicates,
    dropped on paste)."""
    tiles_x = width // tile_w
    tiles_y = height // tile_h
    active = np.flatnonzero(np.asarray(coverage).any(axis=0))
    n_tiles = tiles_x * tiles_y
    if len(active) == 0:
        active = np.array([0], np.int64)
    fraction = len(active) / n_tiles
    ty, tx = np.divmod(active, tiles_x)
    base = (ty * tile_h)[:, None] * width + (tx * tile_w)[:, None]
    dy = np.arange(tile_h)[:, None] * width
    dx = np.arange(tile_w)[None, :]
    local = (dy + dx).reshape(-1)[None, :]
    pix_idx = (base + local).reshape(-1)
    valid = len(pix_idx)
    pad = (-valid) % num_devices
    if pad:
        pix_idx = np.concatenate([pix_idx, np.zeros(pad, pix_idx.dtype)])
    return pix_idx.astype(np.int32), valid, fraction


def select_compaction(
    coverage: np.ndarray,
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    num_devices: int,
):
    """The exchange compaction for this frame, ``(rect, tiles)``: the
    union rect for contiguous coverage, the active-tile list where it cuts
    the payload by at least 30% (bimodal coverage); (None, None) means the
    full frame."""
    rect = coverage_rect(coverage, width, height, tile_w, tile_h, num_devices)
    n_active = max(int(np.asarray(coverage).any(axis=0).sum()), 1)
    tile_payload = n_active * tile_w * tile_h
    tile_payload += (-tile_payload) % num_devices
    frame_pixels = width * height
    rect_payload = rect[2] * rect[3] if rect else frame_pixels
    if tile_payload < 0.7 * rect_payload and tile_payload < 0.9 * frame_pixels:
        return None, coverage_tiles(
            coverage, width, height, tile_w, tile_h, num_devices
        )
    return rect, None


def _slice_tiles(frames: Tensor, pix_idx) -> Tensor:
    """Restrict [..., H*W, C] frames to the active-tile pixels."""
    if pix_idx is None:
        return frames
    idx = torch.from_numpy(np.asarray(pix_idx)).to(frames.device).long()
    return frames.index_select(frames.dim() - 2, idx)


def paste_tiles(compact: np.ndarray, tiles, width: int, height: int) -> np.ndarray:
    """Host inverse of ``_slice_tiles``: the composited active pixels in a
    background frame (rgba 0, depth +inf)."""
    if tiles is None:
        return compact
    pix_idx, valid, _fraction = tiles
    out = np.zeros((width * height, compact.shape[-1]), compact.dtype)
    out[:, 4] = np.inf
    out[pix_idx[:valid]] = compact[:valid]
    return out


def _slice_rect(frames: Tensor, rect, width: int, height: int) -> Tensor:
    """Restrict [..., H*W, C] frames to the coverage rect -> [..., rh*rw, C]."""
    if rect is None:
        return frames
    x0, y0, rw, rh = rect
    lead = tuple(frames.shape[:-2])
    c = frames.shape[-1]
    img = frames.reshape(lead + (height, width, c))
    img = img[..., y0: y0 + rh, x0: x0 + rw, :]
    return img.reshape(lead + (rh * rw, c))


def paste_rect(rect_frame: np.ndarray, rect, width: int, height: int) -> np.ndarray:
    """Host inverse of ``_slice_rect``: the composited rect in a
    background frame (rgba 0, depth +inf)."""
    if rect is None:
        return rect_frame
    x0, y0, rw, rh = rect
    out = np.zeros((height, width, rect_frame.shape[-1]), rect_frame.dtype)
    out[..., 4] = np.inf
    out[y0: y0 + rh, x0: x0 + rw] = rect_frame.reshape(rh, rw, -1)
    return out.reshape(width * height, -1)


def _shard_layers(colors: Tensor, depths: Tensor, valid: Tensor, hints: Tensor,
                  rect, tiles, width: int, height: int):
    """One shard's rendered pieces as exchange-ready layers: [Lmax, P', 5]
    with padding slots cleared to the identity layer (colour 0, depth
    +inf) and restricted to the compacted pixels, and the hints with +inf
    on padding."""
    layers = torch.cat([colors, depths[..., None]], dim=-1)
    cleared = torch.zeros_like(layers)
    cleared[..., 4] = float("inf")
    layers = torch.where(valid[:, None, None], layers, cleared)
    layers = _slice_tiles(_slice_rect(layers, rect, width, height),
                          tiles[0] if tiles else None)
    return layers, torch.where(valid, hints, float("inf"))


def _check_pixels(mesh: Mesh, rect, tiles, width: int, height: int) -> None:
    if _compact_pixels(rect, tiles, width, height) % mesh.size:
        raise ValueError("exchanged pixel count is not divisible by the mesh size")


def _render_shards(mesh: Mesh, tables, cam, rect, tiles, width: int,
                   height: int, **kw):
    """Render each shard's block of the packed tables with the dense
    slice-march kernel, one launch per shard.  ``tables`` is the sharded
    (vol, meta, dims, lut, valid, hints) of ``shard_leading``; returns the
    exchange-ready (layers, hints) of every shard."""
    cam = _constant_camera(cam)
    layers, hints = [], []
    for r, dev in enumerate(mesh.devices):
        vol, meta, dims, lut, valid, hint = (t[r] for t in tables)
        with _on(dev):
            colors, depths = sm.slicemarch_render(
                vol, meta, dims, lut, cam.to(dev), width=width, height=height, **kw)
            lay, hin = _shard_layers(colors, depths, valid, hint, rect, tiles,
                                     width, height)
        layers.append(lay)
        hints.append(hin)
    return layers, hints


def render_and_composite_sharded_slicemarch(
    mesh: Mesh,
    vol,  # [D * Bmax, S_max, 8, 128] packed slice bricks
    meta,  # [D * Bmax, 12]
    dims,  # [D * Bmax, 8]
    lut,  # [D * Bmax, 4, size // 128, 128]
    cam,  # [20]
    valid,  # [D * Bmax] bool
    depth_hints,  # [D * Bmax] float32 (+inf for padding)
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    transport: str = "float32",
    sampling: str = "nearest",
    classification: str = "post",
    ghost: int = 0,
    rect=None,
    tiles=None,
) -> Shards:
    """The layered pipeline: each shard renders its pieces with the dense
    slice-march kernel, every layer's pixel chunk crosses the mesh in one
    all_to_all, and each shard folds all layers of its pixel shard in the
    global (hint, owner, local) order.  Returns the [P' / D, 5] pixel
    shards of the (compacted) frame."""
    _check_pixels(mesh, rect, tiles, width, height)
    tables = shard_leading(mesh, vol, meta, dims, lut, valid, depth_hints)
    layers, hints = _render_shards(
        mesh, tables, cam, rect, tiles, width, height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification)
    return _compose_shards(mesh, layers, hints, transport)


def _local_precomposite(mesh: Mesh, layers: Shards, hints: Shards) -> Shards:
    """Each shard's front-to-back fold of its own depth run: a stable
    argsort of its hints, every layer its own run."""
    partials = []
    for r, dev in enumerate(mesh.devices):
        with _on(dev):
            order = torch.argsort(hints[r], stable=True)
            keys = torch.arange(layers[r].shape[0], dtype=torch.int32, device=dev)
            partials.append(comp.composite_pixels(layers[r], order.to(torch.int32),
                                                  keys))
    return partials


def render_depth_contiguous_slicemarch(
    mesh: Mesh,
    vol,  # [D * Bmax, S_max, 8, 128] depth-contiguous packing
    meta,  # [D * Bmax, 12]
    dims,  # [D * Bmax, 8]
    lut,  # [D * Bmax, 4, size // 128, 128]
    cam,  # [20]
    valid,  # [D * Bmax] bool
    depth_hints,  # [D * Bmax] float32 (+inf for padding)
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    transport: str = "float32",
    sampling: str = "nearest",
    classification: str = "post",
    ghost: int = 0,
    rect=None,
    tiles=None,
) -> Shards:
    """The depth-contiguous pipeline (inputs from
    ``pack_depth_contiguous``): each shard renders its contiguous run of
    the global depth order with the dense slice-march kernel, folds it
    locally, and the exchange moves D single frames, O(shards x pixels)
    in place of O(layers x pixels).  Returns the [P' / D, 5] pixel
    shards."""
    _check_pixels(mesh, rect, tiles, width, height)
    tables = shard_leading(mesh, vol, meta, dims, lut, valid, depth_hints)
    layers, hints = _render_shards(
        mesh, tables, cam, rect, tiles, width, height, max_slices=max_slices,
        logical_width=logical_width, logical_height=logical_height,
        sampling=sampling, ghost=ghost, classification=classification)
    partials = _local_precomposite(mesh, layers, hints)
    return _exchange_fold_partials(mesh, partials, transport)


def render_depth_contiguous_tilemarch(
    mesh: Mesh,
    vol,  # [D * Bmax, S_max, 8, 128] depth-contiguous packing
    meta,  # [D * Bmax, 12]
    dims,  # [D * Bmax, 8]
    lut,  # [4, size // 128, 128] shared transfer function
    cam,  # [20]
    tile_offsets,  # [D, T + 1] per-shard CSR offsets
    tile_bricks,  # [D, Wmax] per-shard local slot ids
    tile_owners,  # [D, Wmax] per-shard run keys (slot order)
    item_bounds,  # [D, Wmax] per-item occupied-slice bounds
    *,
    width: int,
    height: int,
    max_slices: int,
    logical_width: Optional[int] = None,
    logical_height: Optional[int] = None,
    transport: str = "float32",
    sampling: str = "nearest",
    classification: str = "post",
    ghost: int = 0,
    rect=None,
    tiles=None,
) -> Shards:
    """The depth-contiguous pipeline through the tile-march kernel: each
    shard renders and pre-composites its depth run in one launch (per-tile
    CSR work lists over its local slots, every item its own run), so its
    memory is O(pixels) whatever its piece count; then the D partial
    frames are exchanged and folded as in the slice-march pipeline.
    Returns the [P' / D, 5] pixel shards."""
    _check_pixels(mesh, rect, tiles, width, height)
    vol_s, meta_s, dims_s, off_s, br_s, ow_s, ib_s = shard_leading(
        mesh, vol, meta, dims, tile_offsets, tile_bricks, tile_owners,
        item_bounds)
    lut, cam = _as_tensor(lut), _constant_camera(cam)
    partials = []
    for r, dev in enumerate(mesh.devices):
        with _on(dev):
            out_c, out_d = tm.tilemarch_render(
                vol_s[r], meta_s[r], dims_s[r], lut.to(dev), cam.to(dev),
                off_s[r][0], br_s[r][0], ow_s[r][0], ib_s[r][0],
                width=width, height=height, max_slices=max_slices,
                logical_width=logical_width, logical_height=logical_height,
                sampling=sampling, ghost=ghost, classification=classification,
            )
            c, d = sm.untile(out_c[None], out_d[None], width, height)
            partial = torch.cat([c[0], d[0, :, None]], dim=-1)
            partials.append(_slice_tiles(_slice_rect(partial, rect, width, height),
                                         tiles[0] if tiles else None))
    return _exchange_fold_partials(mesh, partials, transport)
