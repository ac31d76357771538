"""The control and every planted fault come out as not correct, on cells
cut to a CPU's size; the benchmark's own runs are correct."""

import pytest

from portbench import controls

from .small import small_cell

CASES = [("turb512.orbit", m) for m in ("control", "stale", "half", "altered")]
CASES += [("insitu32.fit", m) for m in ("control", "stale", "half")]


@pytest.mark.parametrize("name,mode", CASES)
def test_fault_is_caught(name, mode):
    r = controls.reading(name, mode, 77, 0.5, device="cpu", spec=small_cell(name))
    assert r["correct"] is False, r


def test_sound_run_passes():
    r = controls.reading("insitu32.fit", "sound", 78, 0.5, device="cpu", spec=small_cell("insitu32.fit"))
    assert r["correct"] is True, r
