"""``turb192.fit`` finds its files by name and, cut to a CPU's size, runs
correct on the CPU; the pair-list metrics read what they should."""

from types import SimpleNamespace

import pytest

from portbench import pairs, run
from portbench.trace import Trace


def small_turb192() -> dict:
    """The cell at 16^3 in 64 bricks of 4^3, four views at 12 x 12."""
    spec = run.load_cell("turb192.fit")
    spec["config"] = dict(spec["config"], domain=16, brick=4)
    spec["traffic"] = dict(spec["traffic"], width=12, height=12, views=4, trace_after_calls=1)
    return spec


def test_turb192_cell_resolves_its_files():
    spec = run.load_cell("turb192.fit")
    cfg = spec["config"]
    assert (cfg["field"], cfg["domain"], cfg["brick"]) == ("turbulence", 192, 32)
    assert cfg["reduced"] == ["domain"] and "512^3" in cfg["assumed"]["domain"]
    assert spec["traffic"]["kind"] == "fit" and spec["traffic"]["views"] == 36
    assert set(spec["limits"]) == {"loss_gap", "grad_norm_gap", "change_norm_gap"}
    assert {m["name"] for m in spec["end_to_end"]} == {"setup_s", "steps_per_s"}
    assert {m["name"] for m in spec["per_layer"]} == {
        "diff_pairs_ms", "diffpairs_roofline", "diff_other_ms", "mfu.fit", "device_idle.fit"}


def test_turb192_runs_correct_on_the_cpu():
    out, checks = run.run("turb192.fit", 3000000019, 0.5, False, device="cpu",
                          cell_override=small_turb192())
    assert out["correct"], checks
    assert out["attempted"] > 0 and out["failed"] == 0


def test_pair_bounds_grow_with_the_work():
    few, many = pairs.view_bounds_s(8, 512 * 512, 10 ** 5), pairs.view_bounds_s(
        216, 512 * 512, 6 * 10 ** 5)
    assert all(0.0 < few[k] < many[k] for k in few)
    # the build's bytes bound it: a hit pair's slab test is 19 operations
    # (hundreds of ns), its pixels' rows and its pairs' rows 17 MB (5 us)
    want = (20 * 512 * 512 + 40 * 216 + 20 * 6 * 10 ** 5) / 3.35e12
    assert many["build"] == pytest.approx(want, rel=0.01)


def test_pair_metrics_read_nothing_without_pair_kernels(monkeypatch):
    monkeypatch.setattr("sys.argv", ["run", "--workload", "insitu32.fit", "--seed", "5"])
    ctx = SimpleNamespace(trace=Trace(window_s=1.0, kernels={"diffmarch_forward_kernel": 0.1},
                                      units=3), bounds={}, stats={}, flops=0.0)
    for name in ("diff_pairs_ms", "diffpairs_roofline"):
        assert run.reader(name)(ctx) is None


def test_pair_metrics_read_the_cells_pairs(monkeypatch):
    """With pair kernels in the trace: ms a step, and the share of the
    bound the cell's own pair counts give; none without a cell on the
    command line."""
    trace = Trace(window_s=1.0, kernels={"diffpairs_build_kernel": 0.02,
                                         "void diffpairs_fold_forward_kernel<true>": 0.01},
                  units=2)
    ctx = SimpleNamespace(trace=trace, bounds={}, stats={}, flops=0.0)
    assert run.reader("diff_pairs_ms")(ctx) == pytest.approx(15.0)
    monkeypatch.setattr("sys.argv", ["pytest"])
    assert run.reader("diffpairs_roofline")(ctx) is None
    monkeypatch.setattr("sys.argv", ["run", "--workload", "insitu32.fit", "--seed", "5",
                                     "--seconds", "51", "--trace", "1"])
    share = run.reader("diffpairs_roofline")(ctx)
    assert share is not None and 0.0 < share < 100.0


def test_pair_count_is_valid_samples_count():
    """The reader's hit pairs are ``valid_samples``' own count, view by
    view, on the cut cell."""
    import torch

    from portbench import scenes
    from portbench.reference import raymarch as ref_ray

    hit_pairs = run.reader("diffpairs_roofline").__globals__["hit_pairs"]
    spec = small_turb192()
    traffic = spec["traffic"]
    boxes = scenes.make_scene(spec["config"], 3000000019, torch.device("cpu")).boxes
    bricks = ref_ray.Bricks(boxes, "cpu", torch.float32, spec["config"]["lut_size"])
    counts = [hit_pairs(bricks, cam, traffic["width"], traffic["height"])
              for cam in scenes.fit_views(traffic, 3000000019)]
    assert counts == [ref_ray.valid_samples(bricks, cam, traffic["width"], traffic["height"])[1]
                      for cam in scenes.fit_views(traffic, 3000000019)]
    assert min(counts) > 0
