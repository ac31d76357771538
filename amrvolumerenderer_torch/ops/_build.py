"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source under ``ops/csrc/`` exposes a plain C entry point, so
it compiles in seconds without PyTorch's headers.  The shared library is
built at first use into ``build/torch_kernels/`` beside the package,
keyed by a hash of the source, the headers it includes and the flags, and
loaded once per process; ``build_all`` compiles several sources at once.
A missing compiler or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "torch_kernels")

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels.
# -fmad=false: no multiply-add contraction, so the kernel rounds like the
# plain PyTorch version (and the JAX reference) op for op.  Never
# --use_fast_math: IEEE division and sqrt decide nearest-cell indices.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of each library's launch functions
_SIGNATURES = {
    "tilemarch": {"avr_tilemarch_launch":
                  [_P] * 13 + [_I] * 8 + [_F, _F, _I, _I, _I, _P]},
    "slicemarch": {"avr_slicemarch_launch":
                   [_P] * 11 + [_I] * 7 + [_F, _F, _I, _I, _I, _P]},
    "composite": {"avr_composite_launch": [_P] * 7 + [_I, _I, _P],
                  "avr_composite_pixels_launch": [_P] * 4 + [_I, _I, _L, _P],
                  "avr_composite_runs_launch":
                  [_P] * 4 + [_I, _I, _I, _L, _I, _I, _P],
                  "avr_fold_diff_forward_launch": [_P] * 5 + [_I, _I, _P],
                  "avr_fold_diff_backward_launch": [_P] * 6 + [_I, _I, _P],
                  "avr_diffpairs_fold_forward_launch": [_P] * 7 + [_I, _P],
                  "avr_diffpairs_fold_backward_launch": [_P] * 8 + [_I, _P]},
    "raymarch": {"avr_raymarch_launch": [_P] * 13 + [_I] * 7 + [_P]},
    "numerics": {"avr_fma_launch": [_P] * 4 + [_F] * 3 + [_P, _P]},
    "diffmarch": {"avr_diffmarch_pairs_launch": [_P] * 4 + [_I, _I, _P],
                  "avr_diffpairs_build_launch": [_P] * 6 + [_I] * 3 + [_L] + [_P] * 12,
                  # the march's 14 inputs, then its walk (6 pointers, tiles, rows)
                  "avr_diffmarch_forward_launch":
                  [_P] * 20 + [_I, _L] + [_P] * 2 + [_I] * 8 + [_F] * 4 + [_P],
                  "avr_diffmarch_tangent_launch": [_P] * 27 + [_I] * 8 + [_F] * 4 + [_P],
                  "avr_diffmarch_backward_launch":
                  [_P] * 20 + [_I, _L] + [_P] * 7 + [_I] * 9 + [_F] * 4 + [_P]},
    "spans": {"avr_span_mark_launch": [_I, _I, _P]},
}
KERNELS = tuple(_SIGNATURES)

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # name -> nvcc output of the library's build
build_seconds: Dict[str, float] = {}  # name -> compile wall time (0 if cached)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return path


def _sources(name: str):
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, in
    include order (``#include "..."`` lines, followed recursively)."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        fname = todo.pop(0)
        if fname in seen:
            continue
        seen.append(fname)
        with open(os.path.join(_CSRC, fname)) as f:
            todo += re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M)
    return seen


def library_path(name: str) -> str:
    """Where the built library for ``name`` lives: a hash of the source,
    the headers it includes and the flags, so an edited header rebuilds."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in _sources(name):
        with open(os.path.join(_CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all(names=KERNELS) -> None:
    """Compile every kernel of ``names`` whose library is missing, one
    ``nvcc`` per source, all started together."""
    pending = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            build_seconds.setdefault(name, 0.0)
            if name not in build_log and os.path.exists(out + ".log"):
                with open(out + ".log") as f:
                    build_log[name] = f.read()
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in pending.items():
        build_log[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed to build {name}.cu:\n{build_log[name]}")
        else:
            with open(out + ".log", "w") as f:  # the ptxas report of a cached build
                f.write(build_log[name])
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(library_path(name))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
