"""Persistent multi-device scene renderer: bricks resident on the shards.

The port of the JAX package's ``parallel/persistent.py``.  The one-shot
multi-device render (``renderer_fast.render_composited_sharded``) re-packs
and re-uploads the brick table every call, as the reference's
renderSingleTrial re-paints each trial (VolumeRenderer.cpp:1103-1339).
Animation and in-situ serving want the reference's data model instead:
brick data resident per rank for the whole run (the AMReX
DistributionMapping that main.cpp:19-36 sets up once), with only camera
state moving per frame.

``MultiChipSceneRenderer`` brings the persistent design of
``FastSceneRenderer`` to D shards (``directsend.Mesh``):

* the canonical piece table is placed once, split over the shards in a
  static slot order (a Morton curve of piece centres when every piece has
  one owner, else (owner, local index)), the reference's static rank
  assignment;
* per frame only the 20-float camera pack, the per-slot hints and the
  validity mask are computed on the host; the march-axis repack of each
  shard's table, its (meta, dims) tables and the LUTs are placed once per
  axis (per LUT) and reused;
* each shard renders its pieces with the dense slice-march kernel
  (``ops.slicemarch.slicemarch_render``), then either folds its runs of
  the global order (``ops.composite.composite_runs``) and exchanges runs,
  or exchanges every layer; each pixel shard folds in global order with
  ``ops.composite.composite_pixels``;
* above ``scan_piece_threshold`` pieces a shard (deep AMR) the shard
  renders its pieces in chunks of at most that many, folding each chunk
  into the run buffers before the next, so it never holds its whole layer
  stack;
* ``set_transfer_function`` / ``update_data`` keep working: the LUTs and
  the piece table are placed again, everything else stays.

Unlike the one-shot pipelines, the camera is an argument of the JAX
program here, so the camera pack is not folded
(``directsend._constant_camera`` is not applied).  Depth-hint ties break in
(owner, local) order, the reference's own tie-break
(DirectSendBase.cpp:378-388).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..camera import camera_basis
from ..device import DEFAULT_DEVICE, Device
from ..fast_scene import FastSceneRenderer, _repack_for_axis
from ..image import color_to_byte_device
from ..ops import composite as comp
from ..ops import slicemarch as sm
from ..ops import worklist as wl
from ..renderer_fast import _device_downsample, _grouped_cumcount
from ..types import CameraParameters, ColorMap, RenderParameters, SceneGeometry
from ..visibility import order_keys_or_hints
from . import directsend as ds


def _morton_order(box_min: np.ndarray, box_max: np.ndarray) -> np.ndarray:
    """Piece permutation along a Morton (Z-order) curve of piece centres.

    Centres quantise to a 10-bit grid per axis over the scene bounds; ties
    (coincident centres across refinement levels) break by original index."""
    centers = 0.5 * (np.asarray(box_min, float) + np.asarray(box_max, float))
    lo = centers.min(axis=0)
    span = centers.max(axis=0) - lo
    span[span == 0.0] = 1.0
    q = np.clip(((centers - lo) / span * 1023.0).astype(np.int64), 0, 1023)
    code = np.zeros(len(centers), np.int64)
    for bit in range(10):
        for a in range(3):
            code |= ((q[:, a] >> bit) & 1) << (3 * bit + (2 - a))
    return np.lexsort((np.arange(len(centers)), code))


class MultiChipSceneRenderer(FastSceneRenderer):
    """The multi-device twin of ``FastSceneRenderer``: prepare once, render
    any camera over ``num_devices`` shards (default: one per visible card;
    placed round-robin over the visible cards, or on the CPU with
    ``device="cpu"``).  See the module docstring."""

    def __init__(
        self,
        geometry: SceneGeometry,
        parameters: RenderParameters,
        num_devices: Optional[int] = None,
        color_map: Optional[ColorMap] = None,
        precision: str = "float32",
        transport: str = "float32",
        device: Device = DEFAULT_DEVICE,
    ):
        super().__init__(geometry, parameters, color_map=color_map,
                         device=device, precision=precision)
        if transport not in ("float32", "ubyte"):
            raise ValueError(f"unknown transport {transport!r}")
        self.transport = transport
        self.mesh = ds.make_mesh(num_devices, self.device)
        num_devices = self.mesh.size
        if (self.pad_w * self.pad_h) % num_devices:
            raise ValueError(
                f"padded frame ({self.pad_w}x{self.pad_h}) is not divisible "
                f"by the device count {num_devices}")
        self.num_devices = num_devices
        # static placement: the slot order split into contiguous per-shard
        # runs, fixed for the renderer's life.  slot_to_idx maps the
        # [D * Bmax] slots to canonical pieces (padding slots repeat piece
        # 0 and are masked by slot_valid).  With one owner, a Morton order
        # gives each shard a compact region, which is depth-contiguous from
        # most viewpoints: few runs per shard, so the pre-blend pays
        if len(np.unique(self.owners)) <= 1:
            order = _morton_order(self.box_min, self.box_max)
        else:
            order = np.lexsort((_grouped_cumcount(self.owners), self.owners))
        (slot_to_idx,), slot_valid, _ = ds.pack_contiguous(
            num_devices, np.zeros(len(order), np.float32), order.astype(np.int32))
        self._slot_to_idx = slot_to_idx
        self._slot_valid = slot_valid
        self._placed_cache: dict = {}  # axis -> per-shard [Bmax, S, 8, 128]
        self._placed_lut = None  # per-shard [Bmax, 4, size // 128, 128]
        self._meta_cache: dict = {}  # (axis, LUT epoch) -> per-shard tables
        self._lut_epoch = 0
        # deep-AMR shards: above this many pieces a shard, render in chunks
        # of at most this many pieces inside the run pre-blend, so no shard
        # holds more than rmax + threshold layers
        self.scan_piece_threshold = 16
        # pre-blend cost model (_use_preblend): the cost of a layer through
        # the exchange and the final fold over its cost in the local fold.
        # The JAX package's 18 is the TPU's HBM-to-interconnect ratio.  For
        # 8 shards on one NVIDIA H100 80GB HBM3 (700 W), chip_smoke.py's
        # phase 23 fits R = 4.48 from the pre-blend and plain steps' device
        # times on two scenes (PERF.md section 6)
        self.preblend_link_ratio = 4.5
        self._place_canonical()

    # ---- placement ------------------------------------------------------

    def _place_canonical(self) -> None:
        """(Re)place the slot-ordered canonical table on the shards."""
        idx = torch.from_numpy(self._slot_to_idx.astype(np.int64)).to(self.device)
        (self._placed_canonical,) = ds.shard_leading(
            self.mesh, self.canonical.index_select(0, idx))
        self._placed_cache = {}
        self._placed_lut = None

    def _placed_vol(self, axis: int):
        """Each shard's table repacked for march axis ``axis`` (float32:
        the kernel widens a bfloat16 cell exactly), cached per axis."""
        vol = self._placed_cache.get(axis)
        if vol is None:
            vol = [None if c is None else _repack_for_axis(c, axis, self.cube).float()
                   for c in self._placed_canonical]
            self._placed_cache[axis] = vol
        return vol

    def _placed_luts(self):
        """Each shard's per-slot LUTs (the one LUT repeated)."""
        if self._placed_lut is None:
            luts = self.lut[None].expand((len(self._slot_to_idx),) + tuple(self.lut.shape))
            (self._placed_lut,) = ds.shard_leading(self.mesh, luts)
        return self._placed_lut

    def _placed_tables(self, axis: int):
        """Each shard's (meta, dims) piece tables for march axis ``axis``,
        kept per (axis, LUT epoch): dims[:, 7] depends on the LUT."""
        key = (axis, self._lut_epoch)
        placed = self._meta_cache.get(key)
        if placed is None:
            meta, dims = self._axis_metadata(axis)
            idx = self._slot_to_idx
            placed = ds.shard_leading(self.mesh, meta[idx], dims[idx])
            # drop stale-LUT entries, keep the other axes of this epoch
            self._meta_cache = {k: v for k, v in self._meta_cache.items()
                                if k[1] == self._lut_epoch}
            self._meta_cache[key] = placed
        return placed

    # ---- invalidation hooks ---------------------------------------------

    def set_transfer_function(self, *args, **kwargs) -> None:
        super().set_transfer_function(*args, **kwargs)
        self._placed_lut = None
        self._lut_epoch += 1  # dims[:, 7] slice bounds depend on the LUT

    def update_data(self, brick_arrays) -> None:
        super().update_data(brick_arrays)
        self._place_canonical()
        self._lut_epoch += 1  # slice extrema changed with the values
        self._meta_cache = {}

    # ---- per-frame host state -------------------------------------------

    def _frame_state(self, camera: CameraParameters):
        """Per-frame host prep: march axis, 20-float camera pack, per-slot
        depth / order keys and the slot validity mask."""
        forward, right, up = camera_basis(camera)
        axis = wl.choose_march_axis(forward)
        idx = self._slot_to_idx
        hints = order_keys_or_hints(
            camera, self.render_width / max(self.render_height, 1),
            self.box_min, self.box_max,
            use_graph=self.parameters.use_visibility_graph,
            parents=self.parents,
            parent_min=self._parent_min,
            parent_max=self._parent_max,
            cache=self._order_cache,
        )
        slot_hints = np.where(self._slot_valid, hints[idx], np.float32(np.inf))
        # transparency culling folds into validity: a fully transparent
        # piece renders as a cleared layer
        slot_valid = self._slot_valid & self.visible[idx]
        cam = self._pack_cam(camera, forward, right, up)
        return axis, cam, slot_hints, slot_valid

    def _effective_hints(self, slot_hints, slot_valid) -> np.ndarray:
        """[D, Lmax] hints with culled and padding slots at +inf: the order
        the fold applies, for ``preblend_plan``."""
        return np.where(slot_valid, slot_hints,
                        np.float32(np.inf)).reshape(self.num_devices, -1)

    def _use_preblend(self, rmax: int) -> bool:
        """Per-frame choice by cost model: the pre-blend saves
        ``(lmax - rmax)`` layers of exchange per pixel and shard and spends
        a local fold that reads ``lmax`` layers and writes ``rmax``.  With
        ``R = preblend_link_ratio`` (local memory rate over per-link
        exchange rate) it pays iff ``(lmax - rmax) * R > lmax + rmax``.
        Scan mode always pre-folds (there the gain is memory), and so does
        ``transport="ubyte"``: the two paths quantise at different points
        (each run vs each layer), so flipping per frame would shift a static
        scene's colours between orbit frames.  In float32 both paths give
        the same frame bit for bit."""
        if self._scan_pieces() or self.transport == "ubyte":
            return True
        lmax = len(self._slot_to_idx) // self.num_devices
        return (lmax - rmax) * self.preblend_link_ratio > (lmax + rmax)

    def _scan_pieces(self) -> bool:
        """Deep-AMR mode: more than ``scan_piece_threshold`` pieces a shard."""
        return len(self._slot_to_idx) // self.num_devices > self.scan_piece_threshold

    # ---- the per-frame step ---------------------------------------------

    def _shard_inputs(self, axis: int, cam, slot_valid, slot_hints):
        """Per shard: (vol, meta, dims, lut, cam, valid, hints) on its
        device (None on another process's shards); the tables are the
        resident ones."""
        meta, dims = self._placed_tables(axis)
        vol, luts = self._placed_vol(axis), self._placed_luts()
        valid = torch.from_numpy(np.asarray(slot_valid, bool))
        hints = torch.from_numpy(np.asarray(slot_hints, np.float32))
        cam = torch.from_numpy(np.asarray(cam, np.float32))
        n = len(valid) // self.num_devices
        out = [None] * self.num_devices
        for r in self.mesh.local:
            dev = self.mesh.devices[r]
            out[r] = (vol[r], meta[r], dims[r], luts[r], cam.to(dev),
                      valid[r * n:(r + 1) * n].to(dev),
                      hints[r * n:(r + 1) * n].to(dev))
        return out

    def _render_layers(self, shards):
        """Stack mode: each shard's pieces rendered by one kernel-4 launch,
        invalid slots cleared.  Returns (layers, hints) per shard."""
        layers = [None] * self.num_devices
        hints = [None] * self.num_devices
        kw = self._kernel_kw()
        for r in self.mesh.local:
            vol, meta, dims, lut, cam, valid, hint = shards[r]
            with ds._on(self.mesh.devices[r]):
                colors, depths = sm.slicemarch_render(vol, meta, dims, lut, cam, **kw)
                layers[r], hints[r] = ds._shard_layers(
                    colors, depths, valid, hint, None, None, self.pad_w, self.pad_h)
        return layers, hints

    def _scan_runs(self, shards, local_order, run_slot, rmax: int):
        """Scan mode: each shard renders its pieces in ``local_order``, at
        most ``scan_piece_threshold`` a kernel-4 launch, and folds each
        chunk into its run buffers with ``composite_runs`` (``carry`` where
        a chunk continues the previous chunk's run).  The same folds in the
        same order as the stack mode, so the same runs bit for bit."""
        kw = self._kernel_kw()
        step = max(int(self.scan_piece_threshold), 1)
        runs = [None] * self.num_devices
        for r in self.mesh.local:
            vol, meta, dims, lut, cam, valid, _ = shards[r]
            dev = self.mesh.devices[r]
            order, slots = local_order[r], run_slot[r]
            out = None
            with ds._on(dev):
                for c0 in range(0, len(order), step):
                    sel = torch.from_numpy(order[c0: c0 + step].astype(np.int64)).to(dev)
                    colors, depths = sm.slicemarch_render(
                        vol[sel], meta[sel], dims[sel], lut[sel], cam, **kw)
                    layers = ds._cleared_layers(colors, depths, valid[sel])
                    out = comp.composite_runs(
                        layers, torch.arange(len(sel), dtype=torch.int32, device=dev),
                        torch.from_numpy(slots[c0: c0 + step]).to(dev), rmax,
                        out=out, carry=bool(c0 > 0 and slots[c0] == slots[c0 - 1]))
            runs[r] = out
        return runs

    def _step(self, axis: int, cam, slot_hints, slot_valid, plan=None):
        """One frame's pixel shards: the pre-blend step when ``plan``
        (``preblend_plan``'s four values) is given, else the plain step
        (every layer exchanged, folded by the gathered hints)."""
        hints = np.where(slot_valid, slot_hints, np.float32(np.inf))
        shards = self._shard_inputs(axis, cam, slot_valid, hints)
        if plan is None:
            layers, hints = self._render_layers(shards)
            return ds._compose_shards(self.mesh, layers, hints, self.transport)
        local_order, run_slot, perm, rmax = plan
        if self._scan_pieces():
            runs = self._scan_runs(shards, local_order, run_slot, rmax)
            return ds._exchange_and_fold_runs(self.mesh, runs, perm, self.transport)
        layers, _ = self._render_layers(shards)
        return ds._compose_shards_preblend(self.mesh, layers, local_order,
                                           run_slot, perm, rmax, self.transport)

    def _frame_plan(self, slot_hints, slot_valid):
        """``preblend_plan`` of the frame's hints when the pre-blend is
        used at its run depth, else None."""
        plan = ds.preblend_plan(self._effective_hints(slot_hints, slot_valid))
        return plan if self._use_preblend(plan[3]) else None

    def _assemble_shards(self, shards, bytes_out=False) -> torch.Tensor:
        """The pixel shards as the output-resolution frame on the primary
        device (on every process): gathered, cropped, AA-downsampled;
        byte-coded with ``bytes_out`` (``"rgb"``: alpha dropped)."""
        frame = ds.gather_frame(self.mesh, shards, self.device)
        frame = frame.reshape(self.pad_h, self.pad_w, 5)
        frame = frame[: self.render_height, : self.render_width].reshape(-1, 5)
        if self.sqrt_aa > 1:
            frame = _device_downsample(frame, self.render_width,
                                       self.render_height, self.sqrt_aa)
        if bytes_out:
            frame = color_to_byte_device(frame[:, :4])
            if bytes_out == "rgb":
                frame = frame[:, :3]
        return frame

    # ---- rendering ------------------------------------------------------

    def render_frame(self, camera: CameraParameters) -> torch.Tensor:
        """The output-resolution [width*height, 5] frame on the device."""
        axis, cam, slot_hints, slot_valid = self._frame_state(camera)
        plan = self._frame_plan(slot_hints, slot_valid)
        return self._assemble_shards(self._step(axis, cam, slot_hints, slot_valid, plan))

    def render_batch(
        self,
        cameras,
        overlay: bool = True,
        output_pattern: Optional[str] = None,
        max_chunk_bytes: int = 64 << 20,
        bytes_out=False,
    ) -> np.ndarray:
        """Render a camera sequence over the shards, one readback per chunk
        (the multi-device twin of ``FastSceneRenderer.render_batch``).

        Consecutive same-march-axis frames are grouped and rendered in
        power-of-two chunks of at most 16 frames and ``max_chunk_bytes`` of
        padded frames; a chunk's frames run back to back on the device under
        one chunk-wide run depth (each frame re-planned at that ``rmax``),
        are assembled there and copied back once.  Only camera packs and
        order keys change per frame; the tables stay resident.  Frames come
        back in input order as [len(cameras), width*height, 5] float32, or
        with ``bytes_out=True`` / ``"rgb"`` as 4- / 3-channel uint8 (the
        Mesa byte codec on the device after the fold; not with
        antialiasing, as in the JAX package).  ``last_batch_stats`` counts
        chunks in ``dispatch_count``.  Beyond reference."""
        cameras = list(cameras)
        if bytes_out and overlay:
            raise ValueError("bytes_out requires overlay=False (the "
                             "wireframe overlay blends float pixels)")
        if bytes_out and self.sqrt_aa > 1:
            raise ValueError(
                "bytes_out with antialiasing > 1 is not supported on the "
                "multi-device renderer; use float frames")
        num_out = self.parameters.width * self.parameters.height
        chans = (3 if bytes_out == "rgb" else 4) if bytes_out else 5
        frame_bytes = self.pad_w * self.pad_h * (chans if bytes_out else 5 * 4)

        def prep(i, camera):
            axis, cam, slot_hints, slot_valid = self._frame_state(camera)
            return axis, (i, cam, slot_hints, slot_valid)

        def pack(part, axis):
            # every frame planned under ONE chunk-wide rmax; a chunk whose
            # run depth defeats the pre-blend takes the plain step
            effs = [self._effective_hints(p[2], p[3]) for p in part]
            plans = [ds.preblend_plan(e) for e in effs]
            rmax = max(pl[3] for pl in plans)
            if not self._use_preblend(rmax):
                return part, [None] * len(part)
            return part, [pl if pl[3] == rmax else ds.preblend_plan(e, rmax=rmax)
                          for pl, e in zip(plans, effs)]

        def dispatch(packed, axis):
            part, plans = packed
            return torch.stack([
                self._assemble_shards(self._step(axis, p[1], p[2], p[3], plan),
                                      bytes_out)
                for p, plan in zip(part, plans)
            ])

        return self._run_chunked_batch(
            cameras, num_out=num_out, chans=chans, bytes_out=bytes_out,
            overlay=overlay, output_pattern=output_pattern, prep=prep,
            begin_group=lambda axis, group: axis,
            max_frames=max_chunk_bytes // frame_bytes, pack=pack, dispatch=dispatch,
        )
