"""A short traced run of every cell on the card: the result line's keys
and a correct answer.  Skips without a CUDA device."""

import json

import pytest
import torch

from portbench import run

CELLS = [w["name"] for w in json.load(open(run.ROOT + "/BENCHMARK.json"))["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name):
    out, _ = run.run(name, 987654321, 2.0, True)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and "breakdown" in out
