"""A plain differentiable ray march and the fitting step around it: the
multi-view reconstruction's losses, gradient and Adam updates, worked out
again from the bricks, the cameras and the transfer function.

Semantics (the differentiable renderer, VolumePainter.cpp:735-922 made
smooth): each brick is marched from just inside its box (its entry
distance plus 1e-4 of its diagonal) in steps of half its finest cell
spacing, for ``num_steps`` steps, each sample taken while the distance
is short of the box's exit and the point inside the box; the sample is
the clamp-to-edge trilinear interpolation of cell-centred values, its
colour and opacity the linear interpolation between transfer-function
entries; samples fold front to back.  The bricks' layers fold front to
back in the order of their nearest corner along the view axis.  The loss
is the mean over views of the mean squared error against the targets;
Adam (PyTorch's defaults but the learning rate) then a clamp into [0, 1].

Plain PyTorch under autograd, one brick and one block of pixels at a
time (``torch.utils.checkpoint`` keeps a view's graph small); the steps
of a ray are one tensor axis and its fold a cumulative product.  It
imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import transfer
from .slicemarch import basis

Tensor = torch.Tensor
CHUNK = 32768  # pixels a block: a few GB of a block's activations at 224 steps


class Bricks:
    """The bricks as the march reads them, on one device and in one
    dtype: padded values are the leaf ``data`` ``[B, nx, ny, nz]``."""

    def __init__(self, boxes: Sequence, device, dtype=torch.float32, lut_size: int = 256,
                 scalar_range=(0.0, 1.0)):
        self.dtype = dtype
        self.dims = [tuple(b.data.shape) for b in boxes]
        pad = tuple(max(d[a] for d in self.dims) for a in range(3))
        self.pad = pad
        mins = np.array([b.min_corner for b in boxes], np.float64)
        maxs = np.array([b.max_corner for b in boxes], np.float64)
        self.bmin = mins.astype(np.float32)
        self.bmax = maxs.astype(np.float32)
        dims = np.array(self.dims, np.float64)
        spacing = (self.bmax.astype(np.float64) - self.bmin) / dims
        self.cell = spacing.astype(np.float32)
        self.steps = np.maximum(self.cell.min(axis=1).astype(np.float64) * 0.5,
                                1e-5).astype(np.float32)
        diag = np.linalg.norm(maxs - mins, axis=1)
        self.num_steps = int(np.ceil(diag / self.steps.astype(np.float64)).max()) + 2
        self.device = torch.device(device)
        luts = step_luts(self.steps, transfer.table, lut_size, *scalar_range)
        self.luts = torch.as_tensor(luts, device=device).to(dtype)  # [B, size, 4]

    def tensor(self, values: Sequence[Tensor]) -> Tensor:
        """The padded ``[B, nx, ny, nz]`` stack of per-brick values."""
        out = torch.zeros((len(values),) + self.pad, dtype=self.dtype, device=self.device)
        for i, v in enumerate(values):
            out[i, : v.shape[0], : v.shape[1], : v.shape[2]] = v.to(out)
        return out


def step_luts(steps: np.ndarray, table, size: int, lo: float, hi: float) -> np.ndarray:
    """Each brick's table for its own step: opacity nodes scaled by the
    ratio of its step to the coarsest brick's."""
    ref = float(np.max(steps))
    return np.stack([table(size, lo, hi, 1.0, float(s) / ref) for s in steps])


def rays(cam, width: int, height: int, device, dtype):
    """Unit directions ``[H*W, 3]``, pixel (0, 0) at the bottom left."""
    fwd, right, up = (torch.as_tensor(v.astype(np.float32), device=device).to(dtype)
                      for v in basis(cam.eye, cam.look_at, cam.up))
    tan = math.tan(math.radians(cam.fov_y_degrees) * 0.5)
    px = (torch.arange(width, device=device, dtype=dtype) + 0.5) * (2.0 / width) - 1.0
    py = (torch.arange(height, device=device, dtype=dtype) + 0.5) * (2.0 / height) - 1.0
    plane_x = (px * tan) * (width / height)
    plane_y = py * tan
    d = fwd + plane_x[None, :, None] * right + plane_y[:, None, None] * up
    d = d.reshape(-1, 3)
    return d / torch.sqrt((d * d).sum(-1, keepdim=True)), fwd


def _slab(eye: Tensor, d: Tensor, lo: Tensor, hi: Tensor):
    """Entry and exit distances ``[P]`` of the rays through one box."""
    par = d.abs() < 1e-8
    inv = 1.0 / torch.where(par, torch.ones_like(d), d)
    t1, t2 = (lo - eye) * inv, (hi - eye) * inv
    inside = (eye >= lo) & (eye <= hi)
    inf = float("inf")
    near = torch.where(par, torch.where(inside, -inf, inf), torch.minimum(t1, t2))
    far = torch.where(par, torch.where(inside, inf, -inf), torch.maximum(t1, t2))
    return near.amax(-1).to(d.dtype), far.amin(-1).to(d.dtype)


def _layer(data: Tensor, lut: Tensor, top: Tensor, low: Tensor, lo: Tensor, hi: Tensor,
           cell: Tensor, eye: Tensor, d: Tensor, d0: Tensor, tmax: Tensor,
           step: float, num_steps: int, range_min: float, inv_range: float) -> Tensor:
    """One brick's layer ``[R, 4]`` for rays ``d`` ``[R, 3]``: ``num_steps``
    samples a ray, the trilinear value, the lerped LUT entry, the fold."""
    with torch.no_grad():
        k = torch.arange(num_steps, device=d.device, dtype=d.dtype)
        dist = d0[:, None] + step * k  # [R, S]
        pos = eye + d[:, None, :] * dist[..., None]  # [R, S, 3]
        gate = (dist < tmax[:, None]) & ((pos >= lo) & (pos <= hi)).all(-1)
        f = torch.minimum(((pos - lo) / cell - 0.5).clamp(min=0.0), top.to(d.dtype))
        i0 = torch.minimum(torch.floor(f).long().clamp(min=0), low)
        w = (f - i0.to(d.dtype)).clamp(0.0, 1.0)
        step_up = torch.minimum(i0 + 1, top) - i0  # 0 or 1 a corner axis
        ny, nz = data.shape[1], data.shape[2]
        base = (i0[..., 0] * ny + i0[..., 1]) * nz + i0[..., 2]
        # the 8 corners, x fastest: (x, y, z) = (c & 1, c >> 1 & 1, c >> 2 & 1)
        offsets = [((c & 1) * step_up[..., 0] * ny + (c >> 1 & 1) * step_up[..., 1]) * nz
                   + (c >> 2 & 1) * step_up[..., 2] for c in range(8)]
        index = base[..., None] + torch.stack(offsets, -1)  # [R, S, 8]
    corners = torch.gather(data.reshape(-1), 0, index.reshape(-1)).reshape(index.shape)
    wx, wy, wz = (w[..., a, None] for a in range(3))
    cx = corners[..., 0::2] * (1.0 - wx) + corners[..., 1::2] * wx  # [R, S, 4]: (y, z)
    cy = cx[..., 0::2] * (1.0 - wy) + cx[..., 1::2] * wy  # [R, S, 2]: z
    value = (cy[..., 0:1] * (1.0 - wz) + cy[..., 1:2] * wz)[..., 0]
    value = torch.where(torch.isfinite(value), value, torch.zeros_like(value))
    n = ((value - range_min) * inv_range).clamp(0.0, 1.0)
    table_max = lut.shape[0] - 1
    u = n * table_max
    j0 = torch.floor(u).long().clamp(0, max(table_max - 1, 0))
    wl = (u - j0.to(u.dtype)).clamp(0.0, 1.0)[..., None]
    j1 = torch.clamp(j0 + 1, max=table_max)
    s = lut[j0] * (1.0 - wl) + lut[j1] * wl  # [R, S, 4]
    alpha = torch.where(gate, s[..., 3], torch.zeros_like(s[..., 3]))
    # transmittance before each step: the product of (1 - alpha) before it
    log_t = torch.cumsum(torch.log1p(-alpha), dim=1)
    before = torch.exp(torch.cat([torch.zeros_like(log_t[:, :1]), log_t[:, :-1]], 1))
    weight = alpha * before
    out = torch.cat([(s[..., :3] * weight[..., None]).sum(1), weight.sum(1, keepdim=True)], 1)
    return out.clamp(0.0, 1.0)


def _nearest_corner(lo, hi, cam) -> float:
    """The least view depth over a box's eight corners (float64)."""
    fwd = basis(cam.eye, cam.look_at, cam.up)[0]
    corners = np.array([[(lo, hi)[(c >> a) & 1][a] for a in range(3)] for c in range(8)],
                       np.float64)
    return float(((corners - np.asarray(cam.eye, np.float64)) @ fwd).min())


def render_view(bricks: Bricks, data: Tensor, cam, width: int, height: int,
                range_min: float = 0.0, inv_range: float = 1.0) -> Tensor:
    """The composited image ``[H*W, 4]`` of one view, differentiable in
    ``data`` where it requires a gradient."""
    dev, dt = bricks.device, bricks.dtype
    d, fwd = rays(cam, width, height, dev, dt)
    eye = torch.as_tensor(np.asarray(cam.eye, np.float32), device=dev).to(dt)
    count = width * height
    layers = []
    keys = []
    for b in range(len(bricks.dims)):
        lo = torch.as_tensor(bricks.bmin[b], device=dev).to(dt)
        hi = torch.as_tensor(bricks.bmax[b], device=dev).to(dt)
        cell = torch.as_tensor(bricks.cell[b], device=dev).to(dt)
        dims = torch.as_tensor(bricks.dims[b], device=dev)
        top, low = (dims - 1).clamp(min=0), (dims - 2).clamp(min=0)
        with torch.no_grad():
            tmin, tmax = _slab(eye, d, lo, hi)
            hit = tmax >= tmin
            eps = torch.sqrt(((hi - lo) ** 2).sum()) * 1e-4
            d0 = torch.where(hit, tmin, torch.zeros_like(tmin)) + eps
            d0 = torch.where(d0 < 0.0, eps, d0)
            idx = hit.nonzero().squeeze(1)
            # steps past the longest stretch inside the box are all gated off
            longest = float((tmax[idx] - d0[idx]).max()) if len(idx) else 0.0
            steps = min(bricks.num_steps, int(math.ceil(longest / float(bricks.steps[b]))) + 1)
            keys.append(_nearest_corner(bricks.bmin[b], bricks.bmax[b], cam))
        layer = torch.zeros((count, 4), dtype=dt, device=dev)
        for s in range(0, len(idx), CHUNK):
            sel = idx[s:s + CHUNK]
            args = (data[b], bricks.luts[b], top, low, lo, hi, cell, eye, d[sel], d0[sel],
                    tmax[sel], float(bricks.steps[b]), steps, range_min, inv_range)
            if data.requires_grad:
                part = checkpoint(_layer, *args, use_reentrant=False)
            else:
                part = _layer(*args)
            layer = layer.index_put((sel,), part)
        layers.append(layer)
    order = sorted(range(len(layers)), key=lambda i: keys[i])
    acc = torch.zeros((count, 4), dtype=dt, device=dev)
    for i in order:
        acc = acc + layers[i] * (1.0 - acc[:, 3:4])
    return acc.clamp(0.0, 1.0)


def valid_samples(bricks: Bricks, cam, width: int, height: int) -> int:
    """The samples a view's march has to take, steps inside a box and
    short of its exit, over every (brick, pixel) pair whose ray meets the
    box; and the number of those pairs."""
    dev, dt = bricks.device, torch.float32
    d, _ = rays(cam, width, height, dev, dt)
    eye = torch.as_tensor(np.asarray(cam.eye, np.float32), device=dev)
    total = pairs = 0
    k = torch.arange(bricks.num_steps, device=dev, dtype=dt)
    for b in range(len(bricks.dims)):
        lo = torch.as_tensor(bricks.bmin[b], device=dev)
        hi = torch.as_tensor(bricks.bmax[b], device=dev)
        tmin, tmax = _slab(eye, d, lo, hi)
        hit = tmax >= tmin
        eps = torch.sqrt(((hi - lo) ** 2).sum()) * 1e-4
        d0 = torch.where(hit, tmin, torch.zeros_like(tmin)) + eps
        d0 = torch.where(d0 < 0.0, eps, d0)
        idx = hit.nonzero().squeeze(1)
        pairs += len(idx)
        for s in range(0, len(idx), 4 * CHUNK):
            sel = idx[s:s + 4 * CHUNK]
            dist = d0[sel, None] + float(bricks.steps[b]) * k
            pos = eye + d[sel, None, :] * dist[..., None]
            gate = (dist < tmax[sel, None]) & ((pos >= lo) & (pos <= hi)).all(-1)
            total += int(gate.sum())
    return total, pairs


class Fit:
    """The fitting loop's reference: targets rendered from the truth,
    then steps of Adam on the padded brick values from a uniform start."""

    def __init__(self, bricks: Bricks, truth: Tensor, cams: List, width: int, height: int,
                 init: float, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.bricks, self.cams, self.width, self.height = bricks, cams, width, height
        self.lr, self.betas, self.eps = lr, betas, eps
        with torch.no_grad():
            self.targets = [render_view(bricks, truth, c, width, height) for c in cams]
        self.param = torch.full_like(truth, init)
        self.m = torch.zeros_like(self.param)
        self.v = torch.zeros_like(self.param)
        self.t = 0

    def step(self):
        """One step: returns ``(loss, gradient)`` at the parameters before it."""
        p = self.param.detach().requires_grad_(True)
        total = 0.0
        for cam, target in zip(self.cams, self.targets):
            image = render_view(self.bricks, p, cam, self.width, self.height)
            loss = ((image - target) ** 2).mean() / len(self.cams)
            loss.backward()
            total += float(loss.detach())
        g = p.grad
        b1, b2 = self.betas
        self.t += 1
        self.m = b1 * self.m + (1 - b1) * g
        self.v = b2 * self.v + (1 - b2) * g * g
        m_hat = self.m / (1 - b1 ** self.t)
        v_hat = self.v / (1 - b2 ** self.t)
        with torch.no_grad():
            self.param = (self.param - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)).clamp(0.0, 1.0)
        return total, g
