"""The manifest keeps to its contract, and every cell, the parked ones
too, finds its files by name."""

import json
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
ENTRIES = run.manifest()  # the manifest's entries, then the parked cells'
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in ENTRIES["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_names_units_and_keys():
    for c in ENTRIES["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
    for w in ENTRIES["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in ENTRIES["end_to_end"] + ENTRIES["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in ENTRIES["end_to_end"]}
    for m in ENTRIES["per_layer"]:
        assert m["moves"] in moves and set(m) <= {"name", "unit", "better", "source", "layer",
                                                  "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_its_files(name):
    spec = run.load_cell(name)
    assert spec["traffic"]["kind"] in ("render_batch", "fit")
    assert spec["limits"]
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"] + spec["end_to_end"]:
        assert callable(run.reader(m["name"]))
    for m in spec["per_layer"]:
        assert name in m["workloads"]


@pytest.mark.parametrize("config", ENTRIES["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(config):
    data = json.load(open(os.path.join(ROOT, config["file"])))
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert key in data and key in data["assumed"]
