"""The benchmark's inputs, made from ``--seed``: scalar fields, the bricks
they are cut into, and camera paths.

This is the yardstick's frozen copy of the arithmetic the repository's
examples use (``examples/bench_orbit_torch.py``'s turbulence field and
orbit, ``examples/fit_volume_torch.py``'s views) and of the upstream
in-situ example's r^2 field, with the seed moving phases, the centre and
start angles.  Everything here is plain NumPy and PyTorch: the program
and the plain reference are handed the same arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per (seed, purpose): a seed up to 2**64."""
    key = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    key += [ord(c) for c in stream]
    return np.random.default_rng(key)


@dataclass
class Box:
    """One brick: cell values ``[nx, ny, nz]`` (float32) over world corners."""
    data: torch.Tensor
    lo: Tuple[int, int, int]  # lower cell index in its level's index space
    level: int
    min_corner: np.ndarray  # (3,) float64
    max_corner: np.ndarray  # (3,) float64


@dataclass
class Scene:
    """Bricks by level, with each level's cell size, and the refinement
    ratios between levels (all 2 here)."""
    levels: List[List[Box]]
    cell_sizes: List[float]

    @property
    def boxes(self) -> List[Box]:
        return [b for level in self.levels for b in level]


def _grid(n: int, lo: float, hi: float, device) -> torch.Tensor:
    """Cell centres of ``n`` cells over [lo, hi], float64."""
    return lo + (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n * (hi - lo)


def turbulence_field(n: int, phases: Sequence[float], device) -> torch.Tensor:
    """bench_orbit's multi-scale field on an ``n``^3 grid (coordinates
    i / n), with a phase added to each of its four sinusoids; in [0, 1]."""
    c = torch.arange(n, dtype=torch.float64, device=device) / n
    x, y, z = c[:, None, None], c[None, :, None], c[None, None, :]
    tau = 2.0 * math.pi
    f = (0.5
         + 0.25 * torch.sin(tau * 3 * x + phases[0]) * torch.cos(tau * 5 * y + phases[1])
         + 0.15 * torch.sin(tau * 9 * z + 1.0 + phases[2])
         + 0.10 * torch.sin(tau * 17 * (x + y + z) + phases[3]))
    return f.to(torch.float32)


def turbulence_scene(cfg: dict, seed: int, device) -> Scene:
    """``cfg["domain"]``^3 cells of the seeded turbulence field in bricks
    of ``cfg["brick"]``^3 over [0, 1]^3."""
    n, edge = cfg["domain"], cfg["brick"]
    phases = rng(seed, "phases").uniform(0.0, 2.0 * math.pi, 4)
    field = turbulence_field(n, phases, device)
    return Scene([_bricks(field, edge, 1.0 / n)], [1.0 / n])


def _bricks(field: torch.Tensor, edge: int, h: float) -> List[Box]:
    """A cubic field cut into bricks of ``edge``^3 cells of size ``h``."""
    n = field.shape[0]
    boxes = []
    for i in range(0, n, edge):
        for j in range(0, n, edge):
            for k in range(0, n, edge):
                lo = np.array([i, j, k], np.float64)
                boxes.append(Box(field[i:i + edge, j:j + edge, k:k + edge], (i, j, k), 0,
                                 lo * h, (lo + edge) * h))
    return boxes


def insitu_scene(cfg: dict, seed: int, device) -> Scene:
    """The upstream in-situ example's MultiFab: ``cfg["domain"]``^3 cells
    over [0, 1]^3 in boxes of ``cfg["brick"]``^3, holding r^2 about the
    domain's centre, the centre moved up to 0.05 on each axis by the
    seed."""
    n, edge = cfg["domain"], cfg["brick"]
    centre = 0.5 + rng(seed, "centre").uniform(-0.05, 0.05, 3)
    c = [_grid(n, 0.0, 1.0, device) - centre[a] for a in range(3)]
    field = (c[0][:, None, None] ** 2 + c[1][None, :, None] ** 2
             + c[2][None, None, :] ** 2).to(torch.float32)
    return Scene([_bricks(field, edge, 1.0 / n)], [1.0 / n])


def split(boxes: List[Box], edge: int) -> List[Box]:
    """Each brick cut into cubes of at most ``edge`` cells from its low
    corner: the pieces a slice march takes one at a time."""
    out = []
    for b in boxes:
        h = (np.asarray(b.max_corner) - np.asarray(b.min_corner)) / np.array(b.data.shape)
        n = b.data.shape
        for i in range(0, n[0], edge):
            for j in range(0, n[1], edge):
                for k in range(0, n[2], edge):
                    lo = np.array([i, j, k])
                    hi = np.minimum(lo + edge, n)
                    out.append(Box(b.data[i:hi[0], j:hi[1], k:hi[2]],
                                   tuple(int(v) for v in np.array(b.lo) + lo), b.level,
                                   np.asarray(b.min_corner) + lo * h,
                                   np.asarray(b.min_corner) + hi * h))
    return out


SCENES = {"turbulence": turbulence_scene, "insitu_r2": insitu_scene}


def make_scene(cfg: dict, seed: int, device) -> Scene:
    return SCENES[cfg["field"]](cfg, seed, device)


# ---------------------------------------------------------------- cameras


@dataclass(frozen=True)
class Camera:
    eye: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fov_y_degrees: float
    near_plane: float
    far_plane: float


class Orbit:
    """bench_orbit's orbit: eyes on a circle of ``radius`` about the
    domain's centre, ``height`` above it, ``per_rev`` positions a
    revolution from a seeded start angle.  Revolution ``r`` is turned by
    a fraction ``(phi + r * golden) mod 1`` of a step, so no camera comes
    twice in a run; revolution -1 is the warm-up's."""

    def __init__(self, traffic: dict, seed: int):
        g = rng(seed, "orbit")
        self.start = float(g.uniform(0.0, 2.0 * math.pi))
        self.phi = float(g.uniform(0.0, 1.0))
        self.radius = traffic["radius"]
        self.height = traffic["height_above"]
        self.per_rev = traffic["per_rev"]
        self.fov = traffic["fov_y_degrees"]

    def camera(self, index: int) -> Camera:
        rev, j = divmod(index, self.per_rev)
        frac = (self.phi + rev * GOLDEN) % 1.0
        angle = self.start + 2.0 * math.pi * (j + frac) / self.per_rev
        c = 0.5
        return Camera((c + self.radius * math.cos(angle), c + self.height,
                       c + self.radius * math.sin(angle)),
                      (c, c, c), (0.0, 1.0, 0.0), self.fov, 0.1, 20.0)

    def cameras(self, first: int, count: int) -> List[Camera]:
        return [self.camera(first + i) for i in range(count)]


def fit_views(traffic: dict, seed: int) -> List[Camera]:
    """fit_volume_torch.py's ``orbit_cameras``: ``views`` eyes at radius
    ``radius`` about the centre, bobbing 0.4 in y, from a seeded phase."""
    phase = float(rng(seed, "views").uniform(0.0, 2.0 * math.pi))
    n, radius = traffic["views"], traffic["radius"]
    cams = []
    for i in range(n):
        t = phase + 2.0 * math.pi * i / n
        cams.append(Camera((0.5 + radius * math.cos(t), 0.5 + 0.4 * math.sin(2 * t),
                            0.5 + radius * math.sin(t)),
                           (0.5, 0.5, 0.5), (0.0, 1.0, 0.0),
                           traffic["fov_y_degrees"], 0.1, 1000.0))
    return cams
