"""Native AMReX plotfile I/O (no AMReX dependency).

The reference consumes plotfiles through ``amrex::PlotFileData``
(VolumeRenderer.cpp:599-680).  A plotfile is a directory::

    plt00000/
      Header              # text: variables, domain, levels, grids
      Level_0/
        Cell_H            # text: box array + FAB offsets + min/max
        Cell_D_00000      # binary FABs (Fortran order, component-major)
      Level_1/...

This module implements a reader (header dialect "HyperCLaw-V1.1", float32 or
float64 FABs, either byte order) and a writer used by tests and examples.
Data is returned as per-level ``LevelBox`` lists in the level index space,
ready for ``amr.convexify`` and ``scene.build_scene_geometry``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .scene import LevelBox, LevelGeometry

_BOX_RE = re.compile(r"\(\((-?\d+),(-?\d+),(-?\d+)\)\s*\((-?\d+),(-?\d+),(-?\d+)\)")


@dataclasses.dataclass
class PlotFileData:
    """Parsed plotfile: the ``amrex::PlotFileData`` equivalent."""

    path: str
    var_names: List[str]
    space_dim: int
    time: float
    finest_level: int
    prob_lo: np.ndarray  # (3,)
    prob_hi: np.ndarray  # (3,)
    ref_ratios: List[int]  # per level transition
    cell_sizes: List[np.ndarray]  # per level (3,)
    level_paths: List[str]  # relative Cell paths

    def level_geometry(self, max_level: Optional[int] = None) -> List[LevelGeometry]:
        top = self.finest_level if max_level is None else max_level
        return [
            LevelGeometry(prob_lo=self.prob_lo, cell_size=self.cell_sizes[l])
            for l in range(top + 1)
        ]

    def get_level_boxes(self, level: int, variable: str) -> List[LevelBox]:
        """Read one variable of one level as a LevelBox list."""
        if variable not in self.var_names:
            raise ValueError(
                f"Variable '{variable}' not found in plotfile '{self.path}'."
            )
        comp = self.var_names.index(variable)
        level_dir = os.path.join(self.path, os.path.dirname(self.level_paths[level]))
        cell_h = os.path.join(level_dir, "Cell_H")
        boxes, fabs = _read_cell_header(cell_h)
        out: List[LevelBox] = []
        cache: Dict[str, "_FabFile"] = {}
        for (lo, hi), (fname, offset) in zip(boxes, fabs):
            fpath = os.path.join(level_dir, fname)
            if fpath not in cache:
                cache[fpath] = _FabFile(fpath)
            data = cache[fpath].read_component(offset, comp)
            shape = tuple(hi[d] - lo[d] + 1 for d in range(3))
            if data.shape != shape:
                raise ValueError(
                    f"Corrupt plotfile '{self.path}': FAB at {fname}:{offset}"
                    f" holds a {data.shape} box but Cell_H declares {shape}"
                )
            out.append(LevelBox(data=data, lo=np.asarray(lo, dtype=np.int64)))
        return out


def read_plotfile_header(path: str) -> PlotFileData:
    header_path = os.path.join(path, "Header")
    with open(header_path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    it = iter(lines)

    def nxt() -> str:
        # clean failure on truncated/garbage headers (the reference
        # validates its inputs exhaustively and fail-fasts,
        # VolumeRenderer.cpp:1341-1462; a bare StopIteration here would
        # surface as an unrelated error in the caller)
        try:
            return next(it)
        except StopIteration:
            raise ValueError(
                f"Malformed plotfile header '{header_path}': "
                "file ends mid-record (truncated or not an AMReX plotfile)"
            ) from None

    _version = nxt()
    ncomp = int(nxt())
    var_names = [nxt().strip() for _ in range(ncomp)]
    space_dim = int(nxt())
    time = float(nxt())
    finest_level = int(nxt())
    prob_lo = np.array([float(t) for t in nxt().split()])
    prob_hi = np.array([float(t) for t in nxt().split()])
    ratio_line = nxt().split()
    ref_ratios = [int(float(t)) for t in ratio_line] if ratio_line else []
    _prob_domains = nxt()  # per-level index domains on one line
    _level_steps = nxt()
    cell_sizes = []
    for _ in range(finest_level + 1):
        cell_sizes.append(np.array([float(t) for t in nxt().split()]))
    _coord_sys = nxt()
    _bwidth = nxt()

    level_paths: List[str] = []
    for level in range(finest_level + 1):
        first = nxt().split()
        ngrids = int(first[1])
        _steps = nxt()
        for _ in range(ngrids * space_dim):
            nxt()  # physical grid extents "lo hi" per dim per grid
        level_paths.append(nxt().strip())

    if space_dim == 3:
        prob_lo3, prob_hi3 = prob_lo, prob_hi
        cell3 = cell_sizes
    else:
        raise RuntimeError(
            f"Plotfile '{path}' has space dimension {space_dim}. "
            "The volume renderer currently expects 3D data."
        )

    return PlotFileData(
        path=path,
        var_names=var_names,
        space_dim=space_dim,
        time=time,
        finest_level=finest_level,
        prob_lo=prob_lo3,
        prob_hi=prob_hi3,
        ref_ratios=ref_ratios,
        cell_sizes=cell3,
        level_paths=level_paths,
    )


def _read_cell_header(path: str):
    """Parse Level_*/Cell_H: box array + FabOnDisk entries."""
    with open(path) as f:
        text = f.read()
    lines = text.splitlines()
    # box array section starts with "(<ngrids> 0"
    boxes: List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]] = []
    fabs: List[Tuple[str, int]] = []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        m = re.match(r"^\((\d+)\s+0\s*$", line)
        if m:
            ngrids = int(m.group(1))
            if i + ngrids >= len(lines):
                raise ValueError(
                    f"Malformed Cell_H '{path}': declares {ngrids} grids "
                    "but the box list is truncated"
                )
            for j in range(ngrids):
                bm = _BOX_RE.search(lines[i + 1 + j])
                if not bm:
                    raise ValueError(
                        f"Malformed Cell_H '{path}': expected a box triple, "
                        f"got {lines[i + 1 + j]!r}"
                    )
                g = [int(v) for v in bm.groups()]
                boxes.append(((g[0], g[1], g[2]), (g[3], g[4], g[5])))
            i += ngrids + 1
            continue
        if line.startswith("FabOnDisk:"):
            parts = line.split()
            if len(parts) < 3:
                raise ValueError(
                    f"Malformed Cell_H '{path}': bad FabOnDisk line {line!r}"
                )
            fabs.append((parts[1], int(parts[2])))
        i += 1
    if len(boxes) != len(fabs):
        raise ValueError(
            f"Malformed Cell_H '{path}': {len(boxes)} boxes but "
            f"{len(fabs)} FabOnDisk entries"
        )
    return boxes, fabs


_FAB_HEADER_RE = re.compile(
    rb"^FAB \(\((\d+), \(([\d ]+)\)\),\((\d+), \(([\d ]+)\)\)\)"
    rb"\(\((-?\d+),(-?\d+),(-?\d+)\) \((-?\d+),(-?\d+),(-?\d+)\) "
    rb"\((-?\d+),(-?\d+),(-?\d+)\)\) (\d+)"
)


class _FabFile:
    """Lazy reader of one Cell_D_* file containing multiple FABs."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")

    def read_component(self, offset: int, component: int) -> np.ndarray:
        f = self._file
        f.seek(offset)
        header = f.readline()
        m = _FAB_HEADER_RE.match(header)
        if not m:
            raise RuntimeError(f"Bad FAB header in {self.path}: {header[:120]!r}")
        nbytes = int(m.group(1))
        order = [int(t) for t in m.group(4).split()]
        lo = [int(m.group(k)) for k in (5, 6, 7)]
        hi = [int(m.group(k)) for k in (8, 9, 10)]
        ncomp = int(m.group(14))
        if component >= ncomp:
            raise ValueError("component index is out of bounds")
        if nbytes not in (4, 8):
            raise ValueError(
                f"Corrupt FAB in {self.path}: unsupported real size "
                f"{nbytes} (expected 4 or 8)"
            )
        shape = tuple(hi[d] - lo[d] + 1 for d in range(3))
        if any(s <= 0 for s in shape):
            raise ValueError(
                f"Corrupt FAB in {self.path}: non-positive box shape {shape}"
            )
        count = shape[0] * shape[1] * shape[2]
        little = order[0] > order[-1]  # (8 7 ... 1) => little endian
        f.seek(component * count * nbytes, os.SEEK_CUR)
        payload = f.read(count * nbytes)
        if len(payload) != count * nbytes:
            raise ValueError(
                f"Corrupt FAB in {self.path}: component {component} of box "
                f"{shape} needs {count * nbytes} bytes, file holds "
                f"{len(payload)} past the offset (truncated, or the header "
                "declares a larger box than was written)"
            )

        # native decode path (Fortran->C transpose + byteswap in C++)
        from . import native

        decoded = native.decode_fab(payload, shape, nbytes, little)
        if decoded is not None:
            return decoded

        dtype = np.dtype(("<" if little else ">") + ("f8" if nbytes == 8 else "f4"))
        raw = np.frombuffer(payload, dtype=dtype)
        # FAB data is Fortran order (x fastest); expose as [i, j, k] C-indexable
        data = raw.reshape(shape, order="F")
        return np.ascontiguousarray(data, dtype=np.float32)


# ---------------------------------------------------------------------------
# Writer (tests/examples; emits the same dialect the reader consumes)
# ---------------------------------------------------------------------------


def write_plotfile(
    path: str,
    levels: Sequence[Sequence[LevelBox]],
    level_geometry: Sequence[LevelGeometry],
    var_names: Sequence[str] = ("density",),
    ref_ratios: Optional[Sequence[int]] = None,
    prob_hi: Optional[Sequence[float]] = None,
    time: float = 0.0,
) -> None:
    """Write a minimal valid AMReX plotfile (float64 little-endian FABs).

    Each LevelBox's ``data`` may be 3D (single variable) or 4D with the last
    axis matching ``var_names``.
    """
    finest = len(levels) - 1
    ncomp = len(var_names)
    if ref_ratios is None:
        ref_ratios = [2] * finest
    prob_lo = level_geometry[0].prob_lo
    if prob_hi is None:
        # derive from level-0 coverage
        hi = np.full(3, -np.inf)
        for b in levels[0]:
            shape = b.data.shape[:3]
            corner = prob_lo + (np.asarray(b.lo) + shape) * level_geometry[0].cell_size
            hi = np.maximum(hi, corner)
        prob_hi = hi

    os.makedirs(path, exist_ok=True)
    header_lines = ["HyperCLaw-V1.1", str(ncomp)]
    header_lines += list(var_names)
    header_lines.append("3")
    header_lines.append(repr(time))
    header_lines.append(str(finest))
    header_lines.append(" ".join(repr(float(v)) for v in prob_lo))
    header_lines.append(" ".join(repr(float(v)) for v in prob_hi))
    header_lines.append(" ".join(str(r) for r in ref_ratios))

    domains = []
    for level in range(finest + 1):
        lo = np.full(3, np.iinfo(np.int64).max)
        hi = np.full(3, np.iinfo(np.int64).min)
        for b in levels[level]:
            lo = np.minimum(lo, b.lo)
            hi = np.maximum(hi, np.asarray(b.lo) + b.data.shape[:3])
        domains.append(
            f"(({lo[0]},{lo[1]},{lo[2]}) ({hi[0]-1},{hi[1]-1},{hi[2]-1}) (0,0,0))"
        )
    header_lines.append(" ".join(domains))
    header_lines.append(" ".join("0" for _ in range(finest + 1)))
    for level in range(finest + 1):
        header_lines.append(
            " ".join(repr(float(v)) for v in level_geometry[level].cell_size)
        )
    header_lines.append("0")  # cartesian
    header_lines.append("0")  # bwidth

    for level in range(finest + 1):
        boxes = levels[level]
        header_lines.append(f"{level} {len(boxes)} {time!r}")
        header_lines.append("0")
        geom = level_geometry[level]
        for b in boxes:
            shape = b.data.shape[:3]
            for d in range(3):
                lo_phys = prob_lo[d] + b.lo[d] * geom.cell_size[d]
                hi_phys = prob_lo[d] + (b.lo[d] + shape[d]) * geom.cell_size[d]
                header_lines.append(f"{lo_phys!r} {hi_phys!r}")
        header_lines.append(f"Level_{level}/Cell")

    with open(os.path.join(path, "Header"), "w") as f:
        f.write("\n".join(header_lines) + "\n")

    for level in range(finest + 1):
        level_dir = os.path.join(path, f"Level_{level}")
        os.makedirs(level_dir, exist_ok=True)
        boxes = levels[level]
        fab_name = f"Cell_D_{0:05d}"
        offsets: List[int] = []
        with open(os.path.join(level_dir, fab_name), "wb") as f:
            for b in boxes:
                offsets.append(f.tell())
                shape = b.data.shape[:3]
                lo = [int(v) for v in b.lo]
                hi = [lo[d] + shape[d] - 1 for d in range(3)]
                header = (
                    "FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))"
                    f"(({lo[0]},{lo[1]},{lo[2]}) ({hi[0]},{hi[1]},{hi[2]}) "
                    f"(0,0,0)) {ncomp}\n"
                )
                f.write(header.encode())
                data = b.data
                if data.ndim == 3:
                    data = data[..., None]
                for comp in range(ncomp):
                    f.write(
                        np.asfortranarray(data[..., comp].astype("<f8")).tobytes(
                            order="F"
                        )
                    )

        stats_min = []
        stats_max = []
        for b in boxes:
            data = b.data if b.data.ndim == 4 else b.data[..., None]
            stats_min.append([float(data[..., c].min()) for c in range(ncomp)])
            stats_max.append([float(data[..., c].max()) for c in range(ncomp)])

        cell_h = ["1", "1", str(ncomp), "0", f"({len(boxes)} 0"]
        for b in boxes:
            shape = b.data.shape[:3]
            lo = [int(v) for v in b.lo]
            hi = [lo[d] + shape[d] - 1 for d in range(3)]
            cell_h.append(
                f"(({lo[0]},{lo[1]},{lo[2]}) ({hi[0]},{hi[1]},{hi[2]}) (0,0,0))"
            )
        cell_h.append(")")
        cell_h.append(str(len(boxes)))
        for off in offsets:
            cell_h.append(f"FabOnDisk: {fab_name} {off}")
        cell_h.append("")
        cell_h.append(f"{len(boxes)},{ncomp}")
        for row in stats_min:
            cell_h.append(",".join(repr(v) for v in row) + ",")
        cell_h.append("")
        cell_h.append(f"{len(boxes)},{ncomp}")
        for row in stats_max:
            cell_h.append(",".join(repr(v) for v in row) + ",")
        with open(os.path.join(level_dir, "Cell_H"), "w") as f:
            f.write("\n".join(cell_h) + "\n")
