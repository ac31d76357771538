"""A ``torch.profiler`` trace of a short steady part of the window, and
what the per-layer metrics read from it: device time by kernel, the
device's busy time, and the idle gaps with the host span around each.

Spans come from the benchmark's own files (``span``, a
``record_function`` around each call into the program); the program
records none of its own yet.
"""

from __future__ import annotations

import gzip
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."


def span(name: str):
    """A host span around one call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class Trace:
    """What one traced stretch of the window held."""
    window_s: float  # host clock from the stretch's first call to its last
    kernels: Dict[str, float] = field(default_factory=dict)  # name -> device s
    busy_s: float = 0.0  # union of device activity within the window
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest first
    units: int = 0  # frames or steps inside the stretch

    def device_seconds(self, *fragments: str) -> float:
        """Device seconds of the kernels whose names hold any fragment."""
        return sum(s for n, s in self.kernels.items() if any(f in n for f in fragments))

    def idle_percent(self) -> Optional[float]:
        """The share of the traced stretch with nothing running on the
        card; None where the trace saw no device work."""
        if self.busy_s <= 0.0 or self.window_s <= 0.0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


class Tracer:
    """Profiles the calls made between ``start`` and ``stop``; ``finish``
    reads the profile once the window has closed.  Inert unless
    ``enabled``."""

    def __init__(self, enabled: bool, out_path: Optional[str] = None):
        self.enabled = enabled
        self.out_path = out_path
        self.prof = None
        self.done = None  # (profile, window_s, units) once stopped
        self.t0 = 0.0
        self.result: Optional[Trace] = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def prime(self) -> None:
        """Start the profiler's tracing machinery once, in set-up: its
        first start takes seconds, which would otherwise fall inside the
        window."""
        if not self.enabled:
            return
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)

    @staticmethod
    def _activities():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def start(self) -> None:
        if not self.enabled or self.prof is not None or self.done is not None:
            return
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.__enter__()
        self._window = span("traced")
        self._window.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done = (self.prof, window_s, units)
        self.prof = None

    def finish(self) -> Optional[Trace]:
        """Reduce the stopped profile (and write it, gzipped, to
        ``out_path``); None when nothing was traced."""
        if self.done is None or self.result is not None:
            return self.result
        prof, window_s, units = self.done
        self.result = read(prof, window_s)
        self.result.units = units
        if self.out_path:
            os.makedirs(os.path.dirname(self.out_path), exist_ok=True)
            tmp = self.out_path + ".json"
            prof.export_chrome_trace(tmp)
            with open(tmp, "rb") as src, gzip.open(self.out_path, "wb") as dst:
                dst.write(src.read())
            os.unlink(tmp)
        return self.result


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def read(prof, window_s: float) -> Trace:
    """Reduce a finished profile: kernels by name, busy time and idle gaps
    inside the ``portbench.traced`` span."""
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    lo = hi = None
    for e in events:
        if e.name().startswith(SPAN_PREFIX):  # the spans, on either side
            if e.name() == SPAN_PREFIX + "traced" and e.device_type() != torch.autograd.DeviceType.CUDA:
                lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append(e)
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(e)
        else:
            host.append(e)
    trace = Trace(window_s=window_s)
    if lo is None:
        return trace
    spans = []
    for e in device:
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0 or s + d < lo or s > hi:
            continue
        trace.kernels[e.name()] = trace.kernels.get(e.name(), 0.0) + d * 1e-9
        spans.append((max(s, lo), min(s + d, hi)))
    busy = _merge(spans)
    trace.busy_s = sum(e - s for s, e in busy) * 1e-9
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:10]:
        mid = (s + e) // 2
        around = [h for h in host if h.start_ns() <= mid <= h.start_ns() + h.duration_ns()
                  and h.name() != SPAN_PREFIX + "traced"]
        outer = [h.name()[len(SPAN_PREFIX):] for h in around if h.name().startswith(SPAN_PREFIX)]
        inner = min((h for h in around if not h.name().startswith(SPAN_PREFIX)),
                    key=lambda h: h.duration_ns(), default=None)
        label = "/".join(outer) or "harness"
        label += "/" + (inner.name() if inner is not None else "host")
        named.append((label, (e - s) * 1e-9))
    trace.gaps = named
    return trace

