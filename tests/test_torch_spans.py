"""The differentiable path's stage spans (``utils/timers.py``: ``span``,
``grad_span``, ``enable_spans``): off, they record and launch nothing; on,
the host spans come in order and partition a step's autograd work, the
marks partition a CUDA graph replay's kernels (``portbench/stages.py``
pairs them), and images and gradients are the same bit for bit either way.

This file imports neither jax nor the tests' conftest, so its card cases
(marked ``cuda``; each skips itself without a CUDA device) run on a
machine that has only PyTorch:

    python -m pytest --noconftest -o markers=cuda -m cuda tests/test_torch_spans.py
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from amrvolumerenderer_torch import diff
from amrvolumerenderer_torch.parallel import directsend as ds
from amrvolumerenderer_torch.types import CameraParameters
from amrvolumerenderer_torch.utils import timers

FORWARD = ["diff.rays", "diff.march", "diff.order", "diff.fold"]
BACKWARD = ["diff.fold.backward", "diff.march.backward"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.fixture
def spans_off():
    """Leave the process's switch as the test found it."""
    before = timers.enable_spans(False)
    yield
    timers.enable_spans(before)


def scene(views: int, device="cpu", size=8):
    """Four bricks of 4^3 in a row, seen from ``views`` cameras around
    them: one ``(args, static)`` a view, the field of view as a number."""
    rng = np.random.default_rng(7)
    bricks = [(rng.uniform(0.1, 0.9, (4, 4, 4)).astype(np.float32), (0, 0, b), (1, 1, b + 1))
              for b in range(4)]
    out = []
    for v in range(views):
        angle = 0.4 + 0.7 * v
        cam = CameraParameters(eye=(0.5 + 9 * np.sin(angle), 0.5 + 2.0, 2 + 9 * np.cos(angle)),
                               look_at=(0.5, 0.5, 2.0), up=(0, 1, 0), fov_y_degrees=30)
        args, static = diff.prepare_scene(bricks, cam, width=size, height=size, device=device)
        out.append(((*args[:10], float(cam.fov_y_degrees), *args[11:]), static))
    return out


def step(views, volume, lut=None):
    """The fit's loss over the views, and its backward."""
    loss = 0.0
    images = []
    for args, static in views:
        image = diff.render_image_diff(volume, *args[1:4], args[4] if lut is None else lut,
                                       *args[5:], **static)
        images.append(image.detach())
        loss = loss + (image - 0.25).square().mean()
    loss.backward()
    return images


def host_events(prof):
    return sorted((e for e in prof.events()), key=lambda e: e.time_range.start)


def test_spans_off_record_and_launch_nothing(spans_off):
    views = scene(2)
    volume = views[0][0][0].clone().requires_grad_(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(views, volume)
    names = [e.name for e in prof.events()]
    assert not [n for n in names if n.startswith(timers.HOST_PREFIX) or timers.MARK in n
                or "_EdgeBackward" in n]
    assert timers.span("diff.rays", volume) is timers.span("diff.fold", volume)
    t = volume.detach()
    assert timers.grad_span("diff.fold.backward").output(t) is t
    assert timers.grad_span("diff.march.backward").inputs(t, volume)[1] is volume


def test_spans_on_come_in_order_and_partition_a_step(spans_off):
    """A 2-view step: each view's four forward spans, then each view's two
    backward spans (the last view's first, as autograd runs it); every
    autograd node of the fold's and the march's backward inside its span,
    the loss's and the gradient's accumulation outside."""
    views = scene(2)
    volume = views[0][0][0].clone().requires_grad_(True)
    timers.enable_spans(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(views, volume)
    events = host_events(prof)
    spans = [e for e in events if e.name.startswith(timers.HOST_PREFIX)]
    assert [e.name[len(timers.HOST_PREFIX):] for e in spans] == FORWARD * 2 + BACKWARD * 2
    inside = {}
    for e in events:
        if not e.name.startswith("autograd::engine::evaluate_function: "):
            continue
        node = e.name.split(": ")[1]
        around = [s.name[len(timers.HOST_PREFIX):] for s in spans
                  if s.time_range.start <= e.time_range.start
                  and e.time_range.end <= s.time_range.end]
        assert len(around) <= 1, (node, around)
        inside.setdefault(node, set()).add(around[0] if around else None)
    assert inside["_MarchBackward"] == {"diff.march.backward"}
    assert inside["WhereBackward0"] == {"diff.march.backward"}
    assert inside["_FmaBackward"] == {"diff.fold.backward"}
    assert inside["IndexSelectBackward0"] == {"diff.fold.backward"}
    assert inside["MeanBackward0"] == {None} and inside["_EdgeBackward"] == {None}


@pytest.mark.parametrize("wrt", ["volume", "lut", "eye"])
def test_image_and_gradients_same_with_spans_on_and_off(spans_off, wrt):
    views = scene(2)

    def run():
        args, static = views[0]
        leaves = {"volume": args[0].clone(), "lut": args[4].clone(), "eye": args[6].clone()}
        leaves[wrt].requires_grad_(True)
        call = list(args)
        call[0], call[4], call[6] = leaves["volume"], leaves["lut"], leaves["eye"]
        image = diff.render_image_diff(*call, **static)
        image.square().mean().backward()
        return image.detach(), leaves[wrt].grad

    off = run()
    timers.enable_spans(True)
    on = run()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert float(off[1].abs().sum()) > 0


def test_forward_mode_and_sharded_gradient_same_with_spans_on(spans_off):
    """Forward mode adds no edge; the sharded path reuses the stage names,
    a fold and a march a shard."""
    (args, static), = scene(1)
    tangent = torch.ones_like(args[0])

    def run():
        with fwAD.dual_level():
            image = diff.render_image_diff(fwAD.make_dual(args[0], tangent), *args[1:], **static)
            jvp = fwAD.unpack_dual(image).tangent
        data = args[0].clone().requires_grad_(True)
        image = diff.render_image_diff(data, *args[1:], mesh=ds.make_mesh(2, "cpu"), **static)
        image.square().mean().backward()
        return jvp, image.detach(), data.grad

    off = run()
    timers.enable_spans(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = run()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    names = [e.name[len(timers.HOST_PREFIX):] for e in host_events(prof)
             if e.name.startswith(timers.HOST_PREFIX)]
    # forward mode: one view's forward spans, no backward; sharded: the
    # order once, then a march a shard, a fold a shard, both backward
    assert names[:4] == FORWARD
    assert sorted(names[4:]) == sorted(["diff.order"] + ["diff.rays", "diff.march"] * 2
                                       + ["diff.fold"] * 2 + BACKWARD * 2)


def test_enable_spans_restores_state(spans_off, tmp_path):
    """``enable_spans`` returns the state it replaced; ``device_trace``
    leaves spans on where it found them on."""
    assert timers.enable_spans(True) is False and timers.spans_enabled()
    assert timers.enable_spans(True) is True
    with timers.device_trace(str(tmp_path)):
        assert timers.spans_enabled()
    assert timers.spans_enabled()
    assert timers.enable_spans(False) is True and not timers.spans_enabled()


# ---- on the card -----------------------------------------------------------

def device_events(prof):
    """(name, start ns, duration ns) of every device event of a profile."""
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def captured_step(device, spans: bool):
    """A 3-view fitting step (forward, backward, Adam, clamp) captured as
    one CUDA graph with spans on or off, after two eager steps; returns
    the replay and the parameters."""
    views = scene(3, device, size=16)
    timers.enable_spans(spans)
    param = torch.full(views[0][0][0].shape, 0.3, device=device, requires_grad=True)
    opt = torch.optim.Adam([param], lr=0.05, capturable=True)

    def run():
        opt.zero_grad(set_to_none=False)
        step(views, param)
        opt.step()
        with torch.no_grad():
            param.clamp_(0.0, 1.0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    timers.enable_spans(False)
    return graph, param


def replay_events(graph, replays=2):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    return device_events(prof)


@pytest.mark.cuda
def test_marks_pair_up_and_partition_a_replay(cuda, spans_off):
    from portbench import stages

    graph, _ = captured_step(cuda, spans=True)
    events = replay_events(graph)
    out = stages.split(events, 0, 2 ** 63 - 1, timers.parse_mark)
    # the card's pair path opens all seven spans a view, diff.pairs too
    assert out.unpaired == 0 and out.marks == 2 * 3 * 7 * 2
    assert set(out.seconds) == set(timers.SPANS) | {stages.OUTSIDE}
    for name, start, _ in events:
        if "diffmarch_forward_kernel" in name or "diffmarch_pairs_kernel" in name:
            assert out.stage_at(start) == "diff.march"
        elif "diffmarch_backward_kernel" in name:
            assert out.stage_at(start) == "diff.march.backward"
        elif "diffpairs_build_kernel" in name:
            assert out.stage_at(start) == "diff.pairs"
        elif "diffpairs_fold_forward_kernel" in name:
            assert out.stage_at(start) == "diff.fold"
        elif "diffpairs_fold_backward_kernel" in name:
            assert out.stage_at(start) == "diff.fold.backward"
    work = sum(d for n, _, d in events if timers.parse_mark(n) is None) * 1e-9
    assert sum(out.seconds.values()) == pytest.approx(work, rel=1e-9)


@pytest.mark.cuda
def test_capture_with_spans_off_holds_no_mark(cuda, spans_off):
    """Off, the replay holds no mark; on, it holds the same kernels in the
    same order, and the marks besides."""
    off, _ = captured_step(cuda, spans=False)
    on, _ = captured_step(cuda, spans=True)
    names_off = [n for n, _, _ in replay_events(off, 1)]
    names_on = [n for n, _, _ in replay_events(on, 1)]
    assert not [n for n in names_off if timers.MARK in n]
    assert [n for n in names_on if timers.parse_mark(n) is None] == names_off
    assert len(names_on) - len(names_off) == 3 * 7 * 2


@pytest.mark.cuda
def test_image_and_gradient_same_with_spans_on_and_off_on_the_card(cuda, spans_off):
    """Images at 16x16; the gradient at 1x1, where each brick's one hit
    pair adds its cells' terms alone, so that the backward kernel's atomics
    keep one order from run to run."""

    def run(size):
        views = scene(3, cuda, size=size)
        volume = views[0][0][0].clone().requires_grad_(True)
        images = step(views, volume)
        return images, volume.grad

    off, off_again = run(1), run(1)
    assert torch.equal(off[1], off_again[1]) and float(off[1].abs().sum()) > 0
    images_off = run(16)[0]
    timers.enable_spans(True)
    on = run(1)
    assert torch.equal(on[1], off[1])
    for a, b in zip(run(16)[0], images_off):
        assert torch.equal(a, b)
