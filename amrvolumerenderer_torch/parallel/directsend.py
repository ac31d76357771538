"""Multi-device sort-last compositing over a list of shard devices.

The port of the JAX package's ``parallel/directsend.py`` one-shot
pipelines: the reference's direct-send exchange
(``DirectSend/Base/DirectSendBase.cpp``) over D shards, the counterpart of
JAX's ``shard_map``.

* A ``Mesh`` is the list of shard devices.  In one process,
  ``device="cpu"`` gives D shards on the CPU; CUDA gives D shards placed
  round-robin over the visible cards, so one card may hold several shards
  (JAX instead raises when fewer devices are visible than asked for).
  Under ``torch.distributed`` (``driver.maybe_initialize_distributed``)
  the mesh spans the processes, process-major, D / world size shards on
  each process's device; every process runs the whole host prep (as
  JAX's SPMD program does), so every host decision comes out the same on
  every rank, and each process renders and folds only its own shards.
* Each shard owns a block of the brick table and renders its pieces into
  full-frame layers on its own device (``ops.slicemarch.slicemarch_render``
  or ``ops.tilemarch.tilemarch_render``), one launch per shard.
* ``all_to_all`` exchanges pixel chunks: on shard r, ``received[s]`` is
  shard s's chunk r (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``);
  ``all_gather`` stacks every shard's value on every shard.  In one
  process both are device-to-device copies (``Tensor.to``), which PyTorch
  orders after the producing device's current stream and before the
  consuming one's; on one card every copy is local and stays on that
  card's stream.  Across processes they are one ``all_to_all_single`` /
  ``all_gather`` of the process group (NCCL on the cards, or gloo, through
  pinned host memory when the processes share a card).
* Each shard folds the layers of its pixel shard in the global (depth,
  owner, local index) order with the pixel mode of the composite kernel
  (``ops.composite.composite_pixels``), one launch per fold, reading the
  layers through the sort's index.
* The run pre-blend (``preblend_plan``, ``_compose_shards_preblend``)
  folds each shard's same-shard runs of the global order first (the
  composite kernel's runs mode, ``ops.composite.composite_runs``) and
  exchanges runs, not layers.
* ``all_to_all_autograd``, ``gather_frame_autograd`` and ``replicated``
  are the collectives the sharded gradient of
  ``diff.render_image_diff(mesh=...)`` goes through: across processes
  their backwards exchange the gradients back, hand each shard its rows
  of the frame's gradient, and sum a whole input's gradient over the
  processes, one collective a process each.

Functions that take a shard's tensors take its device from the mesh;
none defaults to the CPU.  Results are lists of per-shard pixel shards
(shard r holds rows ``[r * P / D, (r + 1) * P / D)`` of the frame; None
where another process holds the shard); ``gather_frame`` assembles them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..compositor import _composite_sorted_runs, sort_layers
from ..device import DEFAULT_DEVICE, Device, resolve_device
from ..image import byte_to_color_device, color_to_byte_device
from ..ops import composite as comp
from ..ops import raymarch as rm
from ..ops import slicemarch as sm
from ..ops import tilemarch as tm

Tensor = torch.Tensor
# one tensor per shard, on that shard's device (None: another process's)
Shards = List[Optional[Tensor]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The compositing axis: one device per shard, in shard order.

    A mesh of one process holds every shard.  A mesh over several
    processes (``torch.distributed``) records each shard's process in
    ``processes``, process-major and the same count per process (the order
    of the JAX package's flattened ``("dcn", "ranks")`` axes); this
    process holds the shards whose process is ``rank``, and ``devices``
    is None at the others."""

    devices: Tuple[Optional[torch.device], ...]
    processes: Tuple[int, ...] = ()  # empty: every shard in this process
    rank: int = 0
    group: Any = None  # the process group (None: the default group)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def num_processes(self) -> int:
        return max(self.processes) + 1 if self.processes else 1

    @property
    def local(self) -> List[int]:
        """The shards this process holds, in shard order."""
        if not self.processes:
            return list(range(self.size))
        return [r for r, p in enumerate(self.processes) if p == self.rank]


def _subset_devices(devices: Sequence[torch.device], num_devices: int):
    """``num_devices`` shard devices from the visible ``devices``: a
    prefix where there are enough (the JAX package's single-host policy),
    else round-robin over all of them."""
    return [devices[i % len(devices)] for i in range(num_devices)]


def make_mesh(num_devices: Optional[int] = None,
              device: Device = DEFAULT_DEVICE) -> Mesh:
    """A mesh of ``num_devices`` shards (default: one per visible device)
    on ``device``'s kind: the CPU, or the visible CUDA cards starting at
    ``device``'s index.  Under ``torch.distributed`` the mesh spans every
    process: each holds ``num_devices / world size`` shards on its own
    device (the one ``driver.maybe_initialize_distributed`` selected),
    process-major, and the count must divide (as JAX's multi-host
    ``_subset_devices`` requires)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        n_hosts, rank = dist.get_world_size(), dist.get_rank()
        if n_hosts > 1:
            num = n_hosts if num_devices is None else int(num_devices)
            if num < 1:
                raise ValueError("devices must be a positive device count")
            if num % n_hosts:
                raise ValueError(
                    f"num_devices={num} must be a multiple of the "
                    f"host count {n_hosts} on multi-host launches")
            processes = tuple(p for p in range(n_hosts) for _ in range(num // n_hosts))
            return Mesh(tuple(dev if p == rank else None for p in processes),
                        processes, rank)
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
    place block r on shard r's device (NumPy arrays or tensors); a shard
    of another process gets None."""
    out = []
    for a in arrays:
        t = _as_tensor(a)
        if t.shape[0] % mesh.size:
            raise ValueError(
                f"leading axis {t.shape[0]} is not divisible by the mesh "
                f"size {mesh.size}")
        n = t.shape[0] // mesh.size
        blocks: Shards = [None] * mesh.size
        for r in mesh.local:
            blocks[r] = t[r * n:(r + 1) * n].to(mesh.devices[r]).contiguous()
        out.append(blocks)
    return tuple(out)


def _collective(mesh: Mesh, op, out: Tensor, x: Tensor) -> Tensor:
    """Run the process-group collective ``op(out, x)``.  A gloo group
    cannot take CUDA tensors (processes sharing one card): both cross
    through pinned host memory around the collective."""
    if x.device.type == "cuda" and dist.get_backend(mesh.group) == "gloo":
        host_x = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host_x.copy_(x)
        host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        op(host_out, host_x)
        return out.copy_(host_out)
    op(out, x)
    return out


def all_to_all(mesh: Mesh, chunks: Shards) -> Shards:
    """``chunks[s]`` is shard s's [D, ...] send buffer; returns
    ``received`` with ``received[r][s] = chunks[s][r]`` on shard r.  In
    one process these are device-to-device copies; across processes one
    ``all_to_all_single`` moves every local shard's chunks at once."""
    if mesh.num_processes == 1:
        return [torch.stack([chunks[s][r].to(dev) for s in range(mesh.size)])
                for r, dev in enumerate(mesh.devices)]
    local, n = mesh.local, mesh.num_processes
    k = len(local)
    # rows (destination shard r, local sender s): process q's block holds
    # the rows of its own shards, which are contiguous (process-major)
    send = torch.stack([chunks[s][r] for r in range(mesh.size) for s in local])
    recv = _collective(
        mesh, lambda o, x: dist.all_to_all_single(o, x, group=mesh.group),
        torch.empty_like(send), send)
    # [sending process q, receiving local shard, q's local sender]
    recv = recv.reshape((n, k, k) + tuple(send.shape[1:]))
    out: Shards = [None] * mesh.size
    for i, r in enumerate(local):
        out[r] = recv[:, i].reshape((mesh.size,) + tuple(send.shape[1:]))
    return out


def all_gather(mesh: Mesh, xs: Shards) -> Shards:
    """Every shard's value stacked [D, ...] on every shard."""
    if mesh.num_processes == 1:
        return [torch.stack([x.to(dev) for x in xs]) for dev in mesh.devices]
    stacked = _gather_processes(mesh, torch.stack([xs[r] for r in mesh.local]))
    return [stacked if r in mesh.local else None for r in range(mesh.size)]


def _gather_processes(mesh: Mesh, x: Tensor) -> Tensor:
    """Every process's ``x`` concatenated on axis 0, in process order."""
    out = torch.empty((mesh.num_processes * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    # dist.all_gather into row blocks of one tensor: every backend has it
    return _collective(
        mesh, lambda o, y: dist.all_gather(list(o.chunk(mesh.num_processes)), y,
                                           group=mesh.group),
        out, x.contiguous())


def gather_frame(mesh: Mesh, shards: Shards,
                 device: Optional[torch.device] = None) -> Tensor:
    """The pixel shards concatenated in shard order on ``device`` (default:
    the first local shard's): the whole frame on every process, as JAX's
    ``process_allgather(frame, tiled=True)`` gives it."""
    local = [shards[r] for r in mesh.local]
    device = device or local[0].device
    if mesh.num_processes == 1:
        return torch.cat([s.to(device) for s in local])
    return _gather_processes(mesh, torch.cat(local)).to(device)


# ---------------------------------------------------------------------------
# Collectives that autograd goes through (the sharded gradient of
# ``diff.render_image_diff(mesh=...)``).  The exchange and the frame gather
# are each one ``torch.autograd.Function`` over all local shards, in one
# process as across processes, so that the backward issues one collective
# per process, in the same order on every process.  A replicated input is
# one tensor whose slices autograd sums in one process; across processes
# its gradient is summed by one ``all_reduce``.


def _spread(mesh: Mesh, local) -> Shards:
    """Local shard values (in ``mesh.local`` order) as a full ``Shards``."""
    out: Shards = [None] * mesh.size
    for r, x in zip(mesh.local, local):
        out[r] = x
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of all local shards.  Its backward is the same
    exchange of the gradients: the gradient of ``received[r][s]`` belongs to
    ``chunks[s][r]``, and the exchange is its own transpose."""

    @staticmethod
    def forward(ctx, mesh, *local):
        ctx.mesh = mesh
        received = all_to_all(mesh, _spread(mesh, local))
        return tuple(received[r] for r in mesh.local)

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        sent = all_to_all(mesh, _spread(mesh, grads))
        return (None, *(sent[r] for r in mesh.local))


class _GatherFrame(torch.autograd.Function):
    """``gather_frame`` of all local shards.  Every process computes the same
    loss from the whole frame (GSPMD's replicated scalar), so each local
    shard takes its own rows of the frame's gradient, with no sum over
    processes (a reduce-scatter would scale it by the process count)."""

    @staticmethod
    def forward(ctx, mesh, *local):
        ctx.mesh = mesh
        ctx.devices = [x.device for x in local]
        return gather_frame(mesh, _spread(mesh, local))

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        rows = grad.shape[0] // mesh.size
        return (None, *(grad[r * rows:(r + 1) * rows].to(dev)
                        for r, dev in zip(mesh.local, ctx.devices)))


class _Replicated(torch.autograd.Function):
    """Inputs every process holds whole: the identity forward, and a sum
    of the gradients over processes backward (each process's shards
    contribute only their own bricks' terms).  One ``all_reduce`` of all
    the inputs' gradients together."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        flat = torch.cat([g.reshape(-1).to(grads[0].device) for g in grads])
        summed = _collective(
            mesh, lambda o, y: dist.all_reduce(o.copy_(y), group=mesh.group),
            torch.empty_like(flat), flat)
        out, at = [], 0
        for g in grads:
            out.append(summed[at:at + g.numel()].reshape(g.shape).to(g.device, g.dtype))
            at += g.numel()
        return (None, *out)


def all_to_all_autograd(mesh: Mesh, chunks: Shards) -> Shards:
    """``all_to_all`` whose backward exchanges the gradients back."""
    return _spread(mesh, _AllToAll.apply(mesh, *(chunks[r] for r in mesh.local)))


def gather_frame_autograd(mesh: Mesh, shards: Shards) -> Tensor:
    """``gather_frame`` (on the first local shard's device) whose
    backward hands each local shard its rows."""
    return _GatherFrame.apply(mesh, *(shards[r] for r in mesh.local))


def replicated(mesh: Mesh, *xs) -> list:
    """``xs`` (tensors or other values) as inputs that every process holds
    whole: across processes, the gradient of each tensor that requires
    one is summed over the processes in the backward, so every process
    gets the whole gradient.  The same on every process: each decides
    from ``requires_grad``, which the same program sets alike."""
    xs = list(xs)
    picked = [i for i, x in enumerate(xs) if isinstance(x, Tensor) and x.requires_grad]
    if mesh.num_processes == 1 or not picked:
        return xs
    for i, y in zip(picked, _Replicated.apply(mesh, *(xs[i] for i in picked))):
        xs[i] = y
    return xs


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

    def each(fn, *xs):  # fn on the local shards, None elsewhere
        return [None if x[0] is None else fn(*x) for x in zip(*xs)]

    if transport == "ubyte":
        rc = all_to_all(mesh, each(lambda f: chunks(color_to_byte_device(f[..., :4])),
                                   frames))
        rd = all_to_all(mesh, each(lambda f: chunks(f[..., 4:]), frames))
        return each(lambda c, d: torch.cat([byte_to_color_device(c), d], dim=-1),
                    rc, rd)
    if transport != "float32":
        raise ValueError(f"unknown transport {transport!r}")
    return all_to_all(mesh, each(chunks, frames))


def _fold_layers(mesh: Mesh, received: Shards, gathered: Shards) -> Shards:
    """Each shard's fold of the exchanged layers of its pixel shard in the
    global (depth, owner, local index) order.  ``received[r]`` is [D,
    Lmax, P / D, 5] and ``gathered[r]`` the [D, Lmax] hints: flattened,
    they are in (owner, local index) order, so a stable argsort by depth
    gives the exact lexicographic order (DirectSendBase.cpp:329-388);
    owner = shard index.  Returns each shard's [P / D, 5] pixels."""
    out: Shards = [None] * mesh.size
    for r in mesh.local:
        dev = mesh.devices[r]
        with _on(dev):
            num, lmax = received[r].shape[:2]
            all_layers = received[r].reshape(num * lmax, -1, received[r].shape[-1])
            owners = torch.arange(num, dtype=torch.int32,
                                  device=dev).repeat_interleave(lmax)
            order = torch.argsort(gathered[r].reshape(-1), stable=True)
            out[r] = comp.composite_pixels(all_layers, order.to(torch.int32),
                                           owners[order])
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
    if layers_s[mesh.local[0]].shape[1] % mesh.size:
        raise ValueError("pixel count is not divisible by the mesh size")
    return _compose_shards(mesh, layers_s, hints_s, transport)


# ---------------------------------------------------------------------------
# Local run pre-blend before the layered exchange.
#
# The reference's composeLayered pre-blends each same-owner run locally and
# exchanges one flat frame per run: traffic O(runs x pixels), not
# O(layers x pixels) (DirectSendBase.cpp:400-446, pre-blend at 418-425).
# The host cuts the global (hint, owner, local) order into maximal
# same-shard runs (``preblend_plan``); each shard folds its runs with the
# same left-associative blends the post-exchange fold would have made
# (``ops.composite.composite_runs``), ships [rmax] run layers instead of
# [Lmax] raw layers, and the receiving fold blends the runs in global run
# order.  The fold tree is unchanged, so the frame equals
# ``_compose_shards``'s bit for bit.
# ---------------------------------------------------------------------------


def preblend_plan(slot_hints: np.ndarray, rmax_bucket: int = 4,
                  rmax: Optional[int] = None):
    """Host-side run decomposition of the global layer order.

    ``slot_hints`` is the [D, Lmax] per-shard depth-hint table (+inf on
    invalid slots).  Returns ``(local_order, run_slot, perm, rmax)``:

    * ``local_order[d, j]``: which local layer shard d folds at step j (its
      layers in the global order);
    * ``run_slot[d, j]``: the shard-local run buffer that step writes;
    * ``perm[g]``: flattened ``(shard * rmax + slot)`` of the g-th run in
      the global depth order (padding slots follow, blending as identity);
    * ``rmax``: run-buffer depth, rounded up to a multiple of
      ``rmax_bucket``.

    A given ``rmax`` forces that buffer depth (a batch chunk's frames share
    one); it must cover the frame's run count."""
    slot_hints = np.asarray(slot_hints)
    num_devices, lmax = slot_hints.shape
    owner = np.repeat(np.arange(num_devices), lmax)
    local = np.tile(np.arange(lmax), num_devices)
    flat = slot_hints.reshape(-1)
    order = np.lexsort((local, owner, flat))
    seq_owner = order // lmax
    # invalid (+inf) slots sort to the tail and blend as identities: they
    # join their shard's last valid run rather than each forming a run.
    # "Valid" is "sorts before the +inf tail": -inf is a legitimate front
    # hint at the head, and NaN lexsorts last and compares false
    num_valid = int((flat[order] < np.inf).sum())
    vo = seq_owner[:num_valid]
    run_break = np.ones(num_valid, bool)
    run_break[1:] = vo[1:] != vo[:-1]
    run_gid = np.cumsum(run_break) - 1  # valid-run id per sorted position
    run_owner = vo[run_break]  # [R] owner of each valid run, global order
    num_runs = len(run_owner)
    # shard-local slot of each run = its occurrence index within its owner
    by_owner = np.argsort(run_owner, kind="stable")
    sorted_owner = run_owner[by_owner]
    occ = np.arange(num_runs) - np.searchsorted(sorted_owner, sorted_owner)
    slot_of_run = np.empty(num_runs, np.int64)
    slot_of_run[by_owner] = occ
    counts = np.bincount(run_owner, minlength=num_devices)
    need = max(int(counts.max()) if num_runs else 1, 1)
    if rmax is None:
        rmax = -(-need // rmax_bucket) * rmax_bucket
    elif rmax < need:
        raise ValueError(f"forced rmax={rmax} < required run depth {need}")
    # per-shard step tables: each shard owns exactly lmax sorted positions
    # (its valid ones first), so a stable owner sort groups them in order
    slot_flat = np.full(len(order), -1, np.int64)
    slot_flat[:num_valid] = slot_of_run[run_gid]
    grouped = np.argsort(seq_owner, kind="stable").reshape(num_devices, lmax)
    local_order = local[order][grouped].astype(np.int32)
    slot_mat = slot_flat[grouped]
    n_valid_d = (slot_mat >= 0).sum(axis=1)
    last_valid = np.where(
        n_valid_d > 0,
        slot_mat[np.arange(num_devices), np.maximum(n_valid_d - 1, 0)],
        0,
    )
    run_slot = np.where(slot_mat >= 0, slot_mat,
                        last_valid[:, None]).astype(np.int32)
    # global run order -> flattened (shard, slot); padding slots trail
    perm = np.empty(num_devices * rmax, np.int64)
    perm[:num_runs] = run_owner * rmax + slot_of_run
    used = np.zeros(num_devices * rmax, bool)
    used[perm[:num_runs]] = True
    perm[num_runs:] = np.flatnonzero(~used)
    return local_order, run_slot, perm.astype(np.int32), int(rmax)


def _preblend_runs(layers: Tensor, local_order, run_slot, rmax: int) -> Tensor:
    """One shard's [rmax, P, 5] pre-blended run buffers of its [Lmax, P, 5]
    layers (cleared where invalid), folded in ``local_order`` into
    ``run_slot`` (one ``composite_runs`` launch on a CUDA tensor)."""
    dev = layers.device
    return comp.composite_runs(
        layers, _as_tensor(local_order).to(dev, torch.int32),
        _as_tensor(run_slot).to(dev, torch.int32), rmax)


def _fold_runs(mesh: Mesh, received: Shards, perm) -> Shards:
    """Each shard's fold of the exchanged runs of its pixel shard
    (``received[r]`` is [D, rmax, P / D, 5]) in the global run order
    ``perm``: every run its own group (owners ``arange(D * rmax)``), so the
    fold is the left-associative chain of the non-pre-blended path."""
    out: Shards = [None] * mesh.size
    perm = _as_tensor(perm)
    for r in mesh.local:
        dev = mesh.devices[r]
        with _on(dev):
            num, rmax = received[r].shape[:2]
            all_runs = received[r].reshape(num * rmax, -1, received[r].shape[-1])
            out[r] = comp.composite_pixels(
                all_runs, perm.to(dev, torch.int32),
                torch.arange(num * rmax, dtype=torch.int32, device=dev))
    return out


def _exchange_and_fold_runs(mesh: Mesh, runs: Shards, perm,
                            transport: str = "float32") -> Shards:
    """Exchange every shard's [rmax, P, 5] run layers and fold them in the
    global run order; ``transport="ubyte"`` quantises each run."""
    return _fold_runs(mesh, _exchange(mesh, runs, transport), perm)


def _compose_shards_preblend(mesh: Mesh, layers: Shards, local_order,
                             run_slot, perm, rmax: int,
                             transport: str = "float32") -> Shards:
    """``_compose_shards`` with the run pre-blend: each shard folds its
    layers into runs, O(runs) layers cross the mesh, and each pixel shard
    folds the runs in global order; the same frame bit for bit (float32).
    ``local_order`` / ``run_slot`` are ``preblend_plan``'s [D, Lmax]."""
    runs: Shards = [None] * mesh.size
    for r in mesh.local:
        runs[r] = _preblend_runs(layers[r], local_order[r], run_slot[r], rmax)
    return _exchange_and_fold_runs(mesh, runs, perm, transport)


def composite_layers_sharded_preblend(
    mesh: Mesh,
    layers,  # [D * Lmax, P, 5] global, split on axis 0
    hints,  # [D * Lmax] host depth hints (+inf on invalid)
    transport: str = "float32",
) -> Shards:
    """``composite_layers_sharded`` with the reference's local run
    pre-blend (DirectSendBase.cpp:418-425): exchange traffic O(runs x
    pixels).  ``"float32"`` equals the non-pre-blended exchange bit for bit
    (the same fold tree); ``"ubyte"`` quantises each pre-blended run on the
    wire (the reference's point: pre-blend first, byte send after) where
    the non-pre-blended path quantises each layer.  Returns the [P / D, 5]
    pixel shards."""
    (layers_s,) = shard_leading(mesh, layers)
    if layers_s[mesh.local[0]].shape[1] % mesh.size:
        raise ValueError("pixel count is not divisible by the mesh size")
    hints = _as_tensor(hints).cpu().numpy().reshape(mesh.size, -1)
    local_order, run_slot, perm, rmax = preblend_plan(hints)
    return _compose_shards_preblend(mesh, layers_s, local_order, run_slot,
                                    perm, rmax, transport)


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
    if imgs[mesh.local[0]].shape[1] % mesh.size:
        raise ValueError("pixel count is not divisible by the mesh size")
    order = [int(g) for g in np.asarray(group_order)]
    received = _exchange(mesh, [None if img is None else img[0] for img in imgs])
    out: Shards = [None] * mesh.size
    for r in mesh.local:
        recv = received[r]
        with _on(mesh.devices[r]):
            acc = recv[order[0]]
            for g in order[1:]:
                # acc is on top of the next piece (group order = blend order)
                acc = acc + recv[g] * (1.0 - acc[:, 3:4])
            out[r] = acc
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
    out: Shards = [None] * mesh.size
    for r in mesh.local:
        dev = mesh.devices[r]
        with _on(dev):
            keys = torch.arange(mesh.size, dtype=torch.int32, device=dev)
            out[r] = _composite_sorted_runs(received[r], keys)
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
    if parts[mesh.local[0]].shape[1] % mesh.size:
        raise ValueError("pixel count is not divisible by the mesh size")
    return _exchange_fold_partials(
        mesh, [None if p is None else p[0] for p in parts], transport)


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


def _cleared_layers(colors: Tensor, depths: Tensor, valid: Tensor) -> Tensor:
    """Rendered pieces ``[L, P, 4]`` / ``[L, P]`` as ``[L, P, 5]`` layers,
    invalid slots cleared to the identity layer (colour 0, depth +inf)."""
    layers = torch.cat([colors, depths[..., None]], dim=-1)
    cleared = torch.zeros_like(layers)
    cleared[..., 4] = float("inf")
    return torch.where(valid[:, None, None], layers, cleared)


def _shard_layers(colors: Tensor, depths: Tensor, valid: Tensor, hints: Tensor,
                  rect, tiles, width: int, height: int):
    """One shard's rendered pieces as exchange-ready layers: [Lmax, P', 5]
    with padding slots cleared to the identity layer (colour 0, depth
    +inf) and restricted to the compacted pixels, and the hints with +inf
    on padding."""
    layers = _slice_tiles(_slice_rect(_cleared_layers(colors, depths, valid),
                                      rect, width, height),
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
    layers: Shards = [None] * mesh.size
    hints: Shards = [None] * mesh.size
    for r in mesh.local:
        dev = mesh.devices[r]
        vol, meta, dims, lut, valid, hint = (t[r] for t in tables)
        with _on(dev):
            colors, depths = sm.slicemarch_render(
                vol, meta, dims, lut, cam.to(dev), width=width, height=height, **kw)
            layers[r], hints[r] = _shard_layers(colors, depths, valid, hint,
                                                rect, tiles, width, height)
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


def render_and_composite_sharded(
    mesh: Mesh,
    data,  # [D * Bmax, nx, ny, nz] padded brick values
    min_corner,  # [D * Bmax, 3]
    max_corner,  # [D * Bmax, 3]
    cell_dims,  # [D * Bmax, 3] int32
    color_table,  # [D * Bmax, size, 4] (size = lut_size)
    sample_distance,  # [D * Bmax]
    valid,  # [D * Bmax] bool: padding slots are False
    depth_hints,  # [D * Bmax] float32 (+inf for padding)
    camera_arrays,  # eye, forward, right, up
    fov_y_degrees: float,
    range_min: float,
    inverse_range: float,
    transform_scalars: Tuple[float, float, float],
    *,
    width: int,
    height: int,
    num_steps: int,
    log_scale: bool,
    normalize: bool,
    clip_start: float,
    apply_clip: bool,
    transport: str = "float32",
) -> Shards:
    """The raymarch-based multi-device frame: each shard marches its block
    of the brick table with the raymarch oracle (``ops.raymarch``; its
    padding slots take background, colour 0 and depth +inf), then the
    exchange and the pixel-mode fold in global (hint, owner, local) order
    (``_compose_shards``).  ``transport`` selects the exchange payload
    ("float32" exact, "ubyte" the reference's byte colours); the JAX
    function sends float32.  The JAX program closes over the camera, so
    XLA folds it; the march rounds the ray as that program does
    (``fold_camera``).  Returns the [width * height / D, 5] pixel
    shards."""
    if (width * height) % mesh.size:
        raise ValueError("width * height must be divisible by the mesh size")
    positive_floor, normalization_min, inverse_normalization_span = (
        float(np.float32(v)) for v in transform_scalars)
    tables = shard_leading(mesh, data, min_corner, max_corner, cell_dims,
                           color_table, sample_distance, valid, depth_hints)
    layers: Shards = [None] * mesh.size
    hints: Shards = [None] * mesh.size
    for r in mesh.local:
        dev = mesh.devices[r]
        b_data, b_min, b_max, b_dims, b_lut, b_step, b_valid, b_hints = (
            t[r] for t in tables)
        with _on(dev):
            # the march writes its slots' rows whole; padding slots take
            # background here
            out = torch.empty((b_data.shape[0], width * height, 5),
                              dtype=torch.float32, device=dev)
            valid = b_valid.to(torch.bool)
            out[~valid] = torch.tensor([0.0, 0.0, 0.0, 0.0, float("inf")],
                                       device=dev)
            slots = torch.nonzero(valid, as_tuple=True)[0]
            rm.render_bucket_into(
                out, slots, b_data[slots], b_min[slots], b_max[slots],
                b_dims[slots], b_lut[slots], b_step[slots], *camera_arrays,
                float(fov_y_degrees), float(np.float32(range_min)),
                float(np.float32(inverse_range)), positive_floor,
                normalization_min, inverse_normalization_span,
                width=width, height=height, num_steps=num_steps,
                log_scale=log_scale, normalize=normalize,
                clip_start=clip_start, apply_clip=apply_clip, fold_camera=True)
            layers[r] = out
            hints[r] = torch.where(b_valid.to(torch.bool),
                                   b_hints.to(torch.float32), float("inf"))
    return _compose_shards(mesh, layers, hints, transport)


def _local_precomposite(mesh: Mesh, layers: Shards, hints: Shards) -> Shards:
    """Each shard's front-to-back fold of its own depth run: a stable
    argsort of its hints, every layer its own run."""
    partials: Shards = [None] * mesh.size
    for r in mesh.local:
        dev = mesh.devices[r]
        with _on(dev):
            order = torch.argsort(hints[r], stable=True)
            keys = torch.arange(layers[r].shape[0], dtype=torch.int32, device=dev)
            partials[r] = comp.composite_pixels(layers[r], order.to(torch.int32),
                                                keys)
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
    partials: Shards = [None] * mesh.size
    for r in mesh.local:
        dev = mesh.devices[r]
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
            partials[r] = _slice_tiles(_slice_rect(partial, rect, width, height),
                                       tiles[0] if tiles else None)
    return _exchange_fold_partials(mesh, partials, transport)
