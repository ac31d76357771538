"""The program's stage marks in a traced stretch, paired: device time by
stage, the time outside every stage, and the stage around a moment.

The program marks each stage of its differentiable path with two empty
kernels, one where the stage opens and one where it closes
(``amrvolumerenderer_torch.utils.timers``: ``span``, ``grad_span``,
``parse_mark``).  They are kernels so that a CUDA graph replay, which
runs no host code, still shows them in the device trace.  A stream runs
its work in order, so every kernel or copy that starts between a pair
belongs to that stage; the marks themselves belong to none.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

OUTSIDE = "outside"

Event = Tuple[str, int, int]  # device event: name, start ns, duration ns


@dataclass
class Stages:
    """What the marks of one traced stretch split."""
    seconds: Dict[str, float] = field(default_factory=dict)  # stage or OUTSIDE -> device s
    intervals: List[Tuple[str, int, int]] = field(default_factory=list)  # stage, ns, ns
    marks: int = 0
    mark_seconds: float = 0.0  # device time of the marks themselves
    unpaired: int = 0  # marks that open or close no pair

    def stage_at(self, t_ns: int) -> Optional[str]:
        """The innermost stage open at ``t_ns``, if any."""
        inside = [iv for iv in self.intervals if iv[1] <= t_ns <= iv[2]]
        return min(inside, key=lambda iv: iv[2] - iv[1])[0] if inside else None

    def label(self, name: str, start_ns: int, end_ns: int) -> str:
        """An idle gap's ``breakdown`` label with ``@<stage>`` appended
        where its midpoint falls inside a stage."""
        stage = self.stage_at((start_ns + end_ns) // 2)
        return name if stage is None else f"{name}@{stage}"


def program_parser() -> Optional[Callable[[str], Optional[Tuple[str, bool]]]]:
    """The program's reader of its mark names; None where the program has
    no marks."""
    try:
        from amrvolumerenderer_torch.utils.timers import parse_mark
    except ImportError:
        return None
    return parse_mark


def split(events: Iterable[Event], lo: int, hi: int,
          parse: Callable[[str], Optional[Tuple[str, bool]]]) -> Stages:
    """Pair the marks among ``events`` (the stream's device events) and sum
    the other events' device time by the stage open at their start.  An
    event counts where it overlaps ``[lo, hi]``, whole, as
    ``portbench.trace.read`` counts kernels."""
    out = Stages()
    open_: List[Tuple[str, int]] = []
    for name, s, d in sorted(events, key=lambda e: e[1]):
        if d <= 0 or s + d < lo or s > hi:
            continue
        mark = parse(name)
        if mark is None:
            key = open_[-1][0] if open_ else OUTSIDE
            out.seconds[key] = out.seconds.get(key, 0.0) + d * 1e-9
            continue
        out.marks += 1
        out.mark_seconds += d * 1e-9
        stage, closes = mark
        if not closes:
            open_.append((stage, s))
        elif open_ and open_[-1][0] == stage:
            out.intervals.append((stage, open_.pop()[1], s + d))
        else:
            out.unpaired += 1
    out.unpaired += len(open_)
    return out
