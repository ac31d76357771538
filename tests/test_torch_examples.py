"""The port's client examples (``examples/*_torch.py``) on the CPU: each
case of tests/test_examples.py, at the same small sizes, with
``--device cpu``, and the two benchmark examples (``bench_orbit_torch.py``
per frame and batched, ``bench_scaling_torch.py``, whose frame is held
against the JAX package's tile march in interpret mode on the same
inputs).  The examples run in this process (``main(argv)``), as there;
tests/test_torch_standalone.py runs them again with jax and the JAX
package blocked."""

import importlib.util
import os

import numpy as np
import pytest

from amrvolumerenderer_torch.plotfile import write_plotfile
from amrvolumerenderer_torch.scene import LevelBox, LevelGeometry

from test_torch_worklist import one_torch_thread  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
CPU = ["--device", "cpu"]


def load_example(script):
    """Import an example script as a module (examples/ is not a package)."""
    path = os.path.join(EXAMPLES, script)
    spec = importlib.util.spec_from_file_location(
        "example_" + script.replace(".py", ""), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def plotfile(tmp_path):
    """tests/test_examples.py's plotfile: one seeded 8^3 box."""
    n = 8
    rng = np.random.default_rng(0)
    boxes = [LevelBox(rng.random((n, n, n)) + 0.1, np.zeros(3, dtype=int))]
    geom = LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))
    path = str(tmp_path / "plt00000")
    write_plotfile(path, [boxes], [geom], var_names=["density"])
    return path


def test_render_volume_example(plotfile, tmp_path):
    out = tmp_path / "ex.ppm"
    mod = load_example("render_volume_torch.py")
    assert mod.main([plotfile, "--width", "24", "--height", "24", "--output",
                     str(out), *CPU]) == 0
    assert out.read_bytes().startswith(b"P6\n24 24\n")


def test_render_volume_rotate_example(plotfile, tmp_path):
    mod = load_example("render_volume_rotate_torch.py")
    mod.main([plotfile, "--frames", "2", "--width", "16", "--height", "16",
              "--output-dir", str(tmp_path / "orbit"), *CPU])
    frames = sorted(os.listdir(tmp_path / "orbit"))
    assert frames == ["frame_0000.png", "frame_0001.png"]


def test_render_volume_time_example(plotfile, tmp_path):
    mod = load_example("render_volume_time_torch.py")
    mod.main([os.path.join(os.path.dirname(plotfile), "plt*"),
              "--width", "16", "--height", "16",
              "--output-dir", str(tmp_path / "time"), *CPU])
    assert os.listdir(tmp_path / "time") == ["plt00000.png"]


def test_render_galaxy_example(plotfile, tmp_path):
    out = tmp_path / "galaxy.png"
    mod = load_example("render_galaxy_torch.py")
    mod.main([plotfile, "--width", "16", "--height", "16", "--min-level", "0",
              "--output", str(out), *CPU])
    assert out.read_bytes().startswith(b"\x89PNG")


def test_compute_histogram_example(plotfile, capsys):
    mod = load_example("compute_histogram_torch.py")
    mod.main([plotfile, "--bins", "16", *CPU])
    out = capsys.readouterr().out
    assert "samples: 512" in out
    assert "percentiles" in out


def test_render_from_arrays_example(tmp_path):
    mod = load_example("render_from_arrays_torch.py")
    out = tmp_path / "multifab-render.png"
    mod.main(["--width", "48", "--height", "48", "--output", str(out), *CPU])
    assert out.read_bytes().startswith(b"\x89PNG")


def test_render_animation_example(tmp_path):
    mod = load_example("render_animation_torch.py")
    assert mod.main([str(tmp_path / "anim"), "--frames", "3", "--size", "32",
                     *CPU]) == 0
    names = os.listdir(tmp_path / "anim")
    # 3 per-frame update_data renders + 3 batched orbit frames
    assert sorted(n for n in names if n.startswith("frame")) == [
        "frame0000.png", "frame0001.png", "frame0002.png"]
    assert sorted(n for n in names if n.startswith("orbit")) == [
        "orbit0000.png", "orbit0001.png", "orbit0002.png"]


def test_render_multichip_animation_example(tmp_path):
    mod = load_example("render_multichip_animation_torch.py")
    rc = mod.main(["--size", "32", "--frames", "2", "--devices", "4",
                   "--output-dir", str(tmp_path / "mesh"), *CPU])
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "mesh")) == [
        "multichip_00.ppm", "multichip_01.ppm"]


@pytest.mark.parametrize("flags,line", [
    ([], "orbit: 2 frames at 32x32 AA=1; "),
    (["--batch", "--rgb"], "orbit (batched): 2 frames at 32x32 AA=1; "),
], ids=["per-frame", "batch-rgb"])
def test_bench_orbit_example(tmp_path, capsys, flags, line):
    out = tmp_path / "first.png"
    mod = load_example("bench_orbit_torch.py")
    assert mod.main(["--domain", "32", "--width", "32", "--height", "32",
                     "--antialiasing", "1", "--frames", "2", "--save-first",
                     str(out), *flags, *CPU]) == 0
    printed = capsys.readouterr().out
    assert "scene prepared (1 pieces)" in printed
    assert line in printed and " ms/frame (" in printed
    assert out.read_bytes().startswith(b"\x89PNG")


def test_bench_scaling_example(capsys):
    mod = load_example("bench_scaling_torch.py")
    assert mod.main(["--domain", "64", "--width", "64", "--height", "64",
                     "--frames", "1", *CPU]) == 0
    printed = capsys.readouterr().out
    assert "8 bricks, " in printed and "checksum (one frame): " in printed
    assert " ms/frame at 64x64 with 8 bricks" in printed


def test_bench_scaling_frame_matches_jax_interpret():
    """bench_scaling's inputs (8 bricks at 64x64) through the port's plain
    tile march and the JAX package's ``tilemarch_render(interpret=True)``:
    equal bit for bit, colour and depth."""
    import jax.numpy as jnp
    import torch

    from amrvolumerenderer_tpu.ops import tilemarch as jtm
    from amrvolumerenderer_torch.ops import tilemarch as tm

    mod = load_example("bench_scaling_torch.py")
    tables = mod.build_scene(64, 64, 64)["tables"]
    kw = dict(width=64, height=64, max_slices=mod.BOX)
    want = jtm.tilemarch_render(*(jnp.asarray(a) for a in tables),
                                interpret=True, **kw)
    got = tm.tilemarch_render(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in tables), **kw)
    assert float(np.asarray(want[0])[:, 3].max()) > 0.0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
