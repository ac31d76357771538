"""The pairing of the program's stage marks on synthetic device events:
sums by stage, the time outside, marks kept out of both, gap labels."""

import pytest

from portbench import stages
from amrvolumerenderer_torch.utils.timers import SPANS, parse_mark


def mark(stage: str, closes: bool) -> str:
    return f"void avr_span_mark<{SPANS.index(stage)}, {int(closes)}>()"


def step(t0: int):
    """One view's forward and backward as a graph replays it: (name,
    start ns, duration ns), each kernel 10 ns after the last one's end."""
    plan = [("adam_before", 100), (mark("diff.rays", False), 1),
            ("rays_a", 200), ("rays_b", 300), (mark("diff.rays", True), 1),
            (mark("diff.march", False), 1), ("diffmarch_forward_kernel", 500),
            ("clip", 50), (mark("diff.march", True), 1),
            (mark("diff.fold", False), 1), ("fma_kernel", 70), (mark("diff.fold", True), 1),
            ("loss", 40), (mark("diff.fold.backward", False), 1), ("reduce_f64", 90),
            (mark("diff.fold.backward", True), 1), (mark("diff.march.backward", False), 1),
            ("diffmarch_backward_kernel", 800), (mark("diff.march.backward", True), 1),
            ("adam_after", 60)]
    events, t = [], t0
    for name, d in plan:
        events.append((name, t, d))
        t += d + 10
    return events, t


def test_marks_pair_and_partition_the_device_time():
    first, t = step(0)
    second, end = step(t + 1000)  # an idle gap between the replays
    out = stages.split(first + second, 0, end, parse_mark)
    ms = {k: round(v * 1e9) for k, v in out.seconds.items()}
    assert ms == {"diff.rays": 1000, "diff.march": 1100, "diff.fold": 140,
                  "diff.fold.backward": 180, "diff.march.backward": 1600,
                  stages.OUTSIDE: 400}
    assert out.marks == 20 and out.unpaired == 0
    assert round(out.mark_seconds * 1e9) == 20
    assert [iv[0] for iv in out.intervals[:5]] == [
        "diff.rays", "diff.march", "diff.fold", "diff.fold.backward", "diff.march.backward"]
    total = sum(d for n, _, d in first + second if parse_mark(n) is None)
    assert sum(out.seconds.values()) == pytest.approx(total * 1e-9, rel=1e-12)


def test_window_and_unpaired_marks():
    events, end = step(0)
    rays_open = next(s for n, s, _ in events if n == mark("diff.rays", False))
    # a window that starts after the first open mark: that stage's close
    # pairs with nothing, and its kernels count outside
    out = stages.split(events, rays_open + 2, end, parse_mark)
    assert out.unpaired == 1
    assert stages.OUTSIDE in out.seconds and "diff.rays" not in out.seconds
    # a mark with no close left at the end counts as unpaired too
    out = stages.split(events[:3], 0, end, parse_mark)
    assert out.unpaired == 1
    assert out.seconds == pytest.approx({stages.OUTSIDE: 100e-9, "diff.rays": 200e-9})


def test_gap_labels_name_the_stage_around_the_midpoint():
    events, end = step(0)
    out = stages.split(events, 0, end, parse_mark)
    march_bwd = next(iv for iv in out.intervals if iv[0] == "diff.march.backward")
    mid = (march_bwd[1] + march_bwd[2]) // 2
    assert out.label("step/cudaGraphLaunch", mid - 5, mid + 5) == \
        "step/cudaGraphLaunch@diff.march.backward"
    assert out.label("step/cudaStreamSynchronize", end + 10, end + 20) == \
        "step/cudaStreamSynchronize"
    assert out.stage_at(-1) is None


def test_program_parser_reads_only_marks():
    parse = stages.program_parser()
    assert parse is parse_mark
    assert parse(mark("diff.order", True)) == ("diff.order", True)
    assert parse("void avr_span_mark<3, 0>()") == ("diff.fold", False)
    assert parse("void at::native::vectorized_elementwise_kernel<4>()") is None
    assert parse(f"void avr_span_mark<{len(SPANS)}, 0>()") is None
