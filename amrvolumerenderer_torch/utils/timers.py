"""Stage timing and profiling.

The reference reports per-stage wall times reduced with MPI_Reduce(MAX)
and printed on rank 0 (VolumeRenderer.cpp:1121-1136): "Render: <label>
took <s> s".  The port of the JAX package's ``utils/timers.py``: the same
report, with the CUDA device synchronised before the clock is read (work
queued on the card would otherwise land in a later stage), and a
``torch.profiler`` trace of the host and the card in place of
``jax.profiler.trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


def _sync() -> None:
    """Wait for the current CUDA device, if this process has used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimers:
    """Accumulates named stage durations and prints reference-format lines."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, label: str) -> Iterator[None]:
        _sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            elapsed = time.perf_counter() - start
            self.stages[label] = self.stages.get(label, 0.0) + elapsed
            if self.verbose:
                print(f"Render: {label} took {elapsed:.4f} s")

    def report(self) -> Dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, host and CUDA activity,
    written as ``render_trace.json`` (Chrome trace format: Perfetto or
    chrome://tracing) into ``log_dir``; nothing when ``log_dir`` is
    empty."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "render_trace.json"))
