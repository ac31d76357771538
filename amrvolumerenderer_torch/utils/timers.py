"""Stage spans and profiling.

The reference reports per-stage wall times on rank 0
(VolumeRenderer.cpp:1121-1136).  The port times its stages on the device
instead, inside a ``torch.profiler`` trace (``device_trace``), so that no
stage waits for the card:

* ``span(name, tensor)`` brackets a stage of the forward pass and
  ``grad_span(name)`` one of the backward pass.  Each opens a
  ``record_function("avr." + name)`` for the host and, on a CUDA
  tensor's stream, launches a mark at each end: an empty kernel named
  ``avr_span_mark<stage, end>`` (``ops/csrc/spans.cu``; ``stage`` indexes
  ``SPANS``, ``end`` is 0 where the stage opens and 1 where it closes).
  A CUDA graph replay runs no host code, but every kernel of it shows in
  the profiler's device trace, by name, on that trace's clock: the marks
  split a replayed step by stage (``parse_mark`` reads them back).
* They are off by default, and off they record nothing, launch nothing
  and add no autograd node, so a captured graph holds the kernels it
  holds without them.  ``enable_spans`` is the one switch;
  ``device_trace`` turns them on for its block.
"""

from __future__ import annotations

import contextlib
import os
import re
from typing import Iterator, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD

# The differentiable path's stages, by mark id.  Forward: the ray set-up
# (``diff.render_layers_diff`` up to its march), the march with its clip,
# depth hint and miss mask, the depth-hint order (``default_order``), the
# ordered fold (``composite_layers_diff``).  Backward: the fold's, from
# the image's gradient to the layers'; the march's, from the layers'
# gradient to the march's inputs'.
SPANS = ("diff.rays", "diff.march", "diff.order", "diff.fold",
         "diff.fold.backward", "diff.march.backward")
HOST_PREFIX = "avr."
MARK = "avr_span_mark"
_MARK_NAME = re.compile(MARK + r"<(\d+), ?(\d+)>")

_on = False
_OFF = contextlib.nullcontext()


def enable_spans(flag: bool = True) -> bool:
    """Turn the stage spans on or off for the process; returns whether
    they were on.  Turning them on where a CUDA device is present builds
    and loads the marks' library (once a process), so that no mark loads
    inside a stream capture."""
    global _on
    before = _on
    if flag and torch.cuda.is_available():
        _check(_library().avr_span_mark_launch(-1, 0, None))
    _on = bool(flag)
    return before


def spans_enabled() -> bool:
    return _on


def parse_mark(kernel_name: str) -> Optional[Tuple[str, bool]]:
    """``(stage name, closes)`` of a mark kernel's name as a trace shows
    it; None for any other kernel."""
    m = _MARK_NAME.search(kernel_name)
    if m is None or int(m.group(1)) >= len(SPANS):
        return None
    return SPANS[int(m.group(1))], m.group(2) == "1"


def _library():
    from ..ops import _build

    return _build.load("spans")


def _check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"span mark launch failed: CUDA error {rc}")


def _mark(stage: int, end: int, tensor: Optional[torch.Tensor]) -> None:
    """Mark ``stage``'s end on ``tensor``'s current CUDA stream; nothing
    for a tensor off the card."""
    if tensor is None or tensor.device.type != "cuda":
        return
    _check(_library().avr_span_mark_launch(
        stage, end, torch.cuda.current_stream(tensor.device).cuda_stream))


class _Span:
    """A stage: its host span, and its marks on a tensor's device; as a
    context, a forward stage marked on ``tensor``'s stream."""

    def __init__(self, name: str, tensor: Optional[torch.Tensor] = None):
        self.stage = SPANS.index(name)
        self.tensor = tensor
        self.host = None

    def open(self, tensor: Optional[torch.Tensor]) -> None:
        self.host = torch.profiler.record_function(HOST_PREFIX + SPANS[self.stage])
        self.host.__enter__()
        _mark(self.stage, 0, tensor)

    def close(self, tensor: Optional[torch.Tensor]) -> None:
        _mark(self.stage, 1, tensor)
        if self.host is not None:
            self.host.__exit__(None, None, None)
            self.host = None

    def __enter__(self) -> None:
        self.open(self.tensor)

    def __exit__(self, *exc) -> None:
        self.close(self.tensor)


def span(name: str, tensor: torch.Tensor):
    """A context over forward stage ``name`` (one of ``SPANS``), marked on
    ``tensor``'s stream; the shared no-op context while spans are off."""
    return _Span(name, tensor) if _on else _OFF


class _Edge(torch.autograd.Function):
    """Identity on its tensors; its backward opens or closes a stage and
    passes the gradients on untouched."""

    @staticmethod
    def forward(ctx, stage, opens, *tensors):
        ctx.stage, ctx.opens = stage, opens
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        g = next((g for g in grads if g is not None), None)
        (ctx.stage.open if ctx.opens else ctx.stage.close)(g)
        return (None, None, *grads)


class _GradSpan:
    """Backward stage ``name`` between the forward's ``output`` (where the
    gradient enters: the stage opens) and its ``inputs`` (where every
    gradient has left: it closes)."""

    def __init__(self, name: str):
        self.stage = _Span(name)

    def _edge(self, opens: bool, tensors):
        carried = [i for i, t in enumerate(tensors) if t.requires_grad]
        if not carried or not torch.is_grad_enabled() or fwAD._current_level >= 0:
            return tensors
        out = list(tensors)
        for i, t in zip(carried, _Edge.apply(self.stage, opens,
                                             *(tensors[i] for i in carried))):
            out[i] = t
        return tuple(out)

    def output(self, tensor: torch.Tensor) -> torch.Tensor:
        return self._edge(True, (tensor,))[0]

    def inputs(self, *tensors: torch.Tensor) -> tuple:
        return self._edge(False, tensors)


class _NoGradSpan:
    @staticmethod
    def output(tensor):
        return tensor

    @staticmethod
    def inputs(*tensors):
        return tensors


_NO_GRAD_SPAN = _NoGradSpan()


def grad_span(name: str):
    """Backward stage ``name`` (one of ``SPANS``): pass the stage's
    differentiable inputs through ``.inputs(...)`` and its output through
    ``.output(...)``.  Off, or with nothing to differentiate (no reverse
    mode, or under forward mode), both return their tensors as they are."""
    return _GradSpan(name) if _on else _NO_GRAD_SPAN


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, host and CUDA activity,
    with the stage spans on, written as ``render_trace.json`` (Chrome
    trace format: Perfetto or chrome://tracing) into ``log_dir``; nothing
    when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = enable_spans(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        enable_spans(before)
    prof.export_chrome_trace(os.path.join(log_dir, "render_trace.json"))
