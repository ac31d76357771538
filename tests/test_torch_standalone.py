"""The port stands alone: in a fresh interpreter where importing ``jax``,
``jaxlib`` or ``amrvolumerenderer_tpu`` raises, every module of
``amrvolumerenderer_torch`` imports (the animation path's ``transforms``
``device_scene``, ``ops.raymarch``, ``diff`` and ``utils.timers`` among
them), the CLI renders a plotfile through the default (slice-march)
route, the raymarch oracle, over two shards (``--devices 2``, the
``parallel`` package), an orbit through the batched tile-march path and
an orbit over two shards (the persistent multi-device renderer) on the
CPU, and the port's transfer-function fitting example, its eight client
examples and its two benchmark examples run."""

import os
import subprocess
import sys

import numpy as np
import pytest

from amrvolumerenderer_tpu.plotfile import write_plotfile
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = """
import importlib, pkgutil, runpy, sys

BLOCKED = ("jax", "jaxlib", "amrvolumerenderer_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Block())
"""

BLOCKED_RUN = BLOCK + """
import amrvolumerenderer_torch

names = [m.name for m in pkgutil.walk_packages(
    amrvolumerenderer_torch.__path__, "amrvolumerenderer_torch.")]
assert "amrvolumerenderer_torch.parallel.directsend" in names, names
assert "amrvolumerenderer_torch.parallel.persistent" in names, names
assert "amrvolumerenderer_torch.ops.raymarch" in names, names
assert "amrvolumerenderer_torch.device_scene" in names, names
assert "amrvolumerenderer_torch.diff" in names, names
assert "amrvolumerenderer_torch.utils.timers" in names, names
for name in names:
    importlib.import_module(name)
print("imported", len(names), "modules")
sys.argv = ["amrvolumerenderer_torch.driver"] + sys.argv[1:]
try:
    runpy.run_module("amrvolumerenderer_torch.driver", run_name="__main__")
except SystemExit as stop:
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    raise
"""


@pytest.fixture(scope="module")
def plotfile(tmp_path_factory):
    """A one-level r^2 plotfile in four boxes."""
    c = np.arange(16) / 15
    field = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    boxes = [LevelBox(field[i:i + 8, j:j + 16, :], np.array([i, j, 0]))
             for i in (0, 8) for j in (0,)]
    path = str(tmp_path_factory.mktemp("plt") / "plt00000")
    write_plotfile(path, [boxes], [LevelGeometry(np.zeros(3), np.full(3, 1 / 16))])
    return path


@pytest.mark.parametrize("flags", [[], ["--sampling", "trilinear",
                                        "--antialiasing", "4"], ["--devices", "2"],
                                   ["--render-method", "raymarch"]])
def test_port_imports_and_renders_with_jax_and_reference_blocked(
        tmp_path, plotfile, flags):
    out = tmp_path / "standalone.ppm"
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, "--width", "40", "--height", "32",
         "--device", "cpu", *flags, "--output", str(out), plotfile],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout
    assert "Saved volume composited image" in proc.stdout
    with open(out, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        f.readline()
        img = np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)
    assert (w, h) == (40, 32) and (img > 0).mean() > 0.1


def test_port_renders_orbit_with_jax_and_reference_blocked(tmp_path, plotfile):
    out = tmp_path / "orbit.ppm"
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, "--width", "32", "--height", "32",
         "--device", "cpu", "--orbit-frames", "2", "--output", str(out), plotfile],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout and "Saved orbit frames" in proc.stdout
    frames = [(tmp_path / f"orbit_{i:04d}.ppm").read_bytes() for i in range(2)]
    assert all(f.startswith(b"P6") for f in frames) and frames[0] != frames[1]


def test_port_renders_multi_device_orbit_with_jax_and_reference_blocked(
        tmp_path, plotfile):
    out = tmp_path / "orbit.ppm"
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, "--width", "32", "--height", "32",
         "--device", "cpu", "--devices", "2", "--orbit-frames", "2", "--output",
         str(out), plotfile],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout and "Saved orbit frames" in proc.stdout
    frames = [(tmp_path / f"orbit_{i:04d}.ppm").read_bytes() for i in range(2)]
    assert all(f.startswith(b"P6") for f in frames) and frames[0] != frames[1]


BLOCKED_EXAMPLE = BLOCK + """
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit:
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    assert "amrvolumerenderer_torch.diff" in sys.modules
    raise
"""


def test_port_fitting_example_runs_with_jax_and_reference_blocked():
    """examples/fit_transfer_function_torch.py, three Adam steps on the
    CPU: the loss must fall below half its first value (the descent
    tests/test_diff.py asks of twelve plain steps).  Three steps are too
    few for the example's own 10x goal, so its exit code may be 1."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_EXAMPLE,
         os.path.join(REPO, "examples", "fit_transfer_function_torch.py"),
         "--device", "cpu", "--steps", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode in (0, 1), proc.stderr[-3000:]
    summary = [line for line in proc.stdout.splitlines() if line.startswith("loss: ")]
    assert len(summary) == 1, proc.stdout
    first, final = (float(v) for v in summary[0][6:].split(" (")[0].split(" -> "))
    assert final < 0.5 * first, summary


BLOCKED_CLIENT_EXAMPLES = BLOCK + """
import json

for script, argv in json.loads(sys.argv[1]):
    sys.argv = [script] + argv
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as stop:
        assert stop.code in (None, 0), (script, stop.code)
    print("ran", script)
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
"""


def test_port_client_examples_run_with_jax_and_reference_blocked(tmp_path, plotfile):
    """The eight client examples (``examples/*_torch.py`` other than the
    fitting ones) in one interpreter with jax and the JAX package blocked,
    on the CPU at tests/test_torch_examples.py's sizes; each writes the
    outputs its JAX original writes."""
    import json

    ex = os.path.join(REPO, "examples")
    small = ["--width", "16", "--height", "16", "--device", "cpu"]
    runs = [
        ("render_volume_torch.py", [plotfile, *small, "--output",
                                    str(tmp_path / "ex.ppm")]),
        ("render_volume_rotate_torch.py", [plotfile, "--frames", "2", *small,
                                           "--output-dir", str(tmp_path / "orbit")]),
        ("render_volume_time_torch.py", [os.path.join(os.path.dirname(plotfile),
                                                      "plt*"), *small,
                                         "--output-dir", str(tmp_path / "time")]),
        ("render_galaxy_torch.py", [plotfile, *small, "--min-level", "0",
                                    "--output", str(tmp_path / "galaxy.png")]),
        ("compute_histogram_torch.py", [plotfile, "--bins", "16", "--device", "cpu"]),
        ("render_from_arrays_torch.py", [*small, "--output",
                                         str(tmp_path / "multifab-render.png")]),
        ("render_animation_torch.py", [str(tmp_path / "anim"), "--frames", "2",
                                       "--size", "32", "--device", "cpu"]),
        ("render_multichip_animation_torch.py", [
            "--size", "32", "--frames", "2", "--devices", "2",
            "--output-dir", str(tmp_path / "mesh"), "--device", "cpu"]),
    ]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_CLIENT_EXAMPLES,
         json.dumps([(os.path.join(ex, s), argv) for s, argv in runs])],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ran = [line[4:] for line in proc.stdout.splitlines() if line.startswith("ran ")]
    assert ran == [os.path.join(ex, script) for script, _ in runs]
    assert "samples: " in proc.stdout and "percentiles" in proc.stdout
    assert (tmp_path / "ex.ppm").read_bytes().startswith(b"P6")
    assert sorted(os.listdir(tmp_path / "orbit")) == ["frame_0000.png", "frame_0001.png"]
    assert os.listdir(tmp_path / "time") == ["plt00000.png"]
    assert (tmp_path / "galaxy.png").exists()
    assert (tmp_path / "multifab-render.png").exists()
    assert sorted(os.listdir(tmp_path / "anim")) == [
        "frame0000.png", "frame0001.png", "orbit0000.png", "orbit0001.png"]
    assert sorted(os.listdir(tmp_path / "mesh")) == ["multichip_00.ppm",
                                                     "multichip_01.ppm"]


def test_port_bench_examples_run_with_jax_and_reference_blocked(tmp_path):
    """The two benchmark examples (``examples/bench_orbit_torch.py`` per
    frame and batched, ``examples/bench_scaling_torch.py``) in one
    interpreter with jax and the JAX package blocked, on the CPU at
    tests/test_torch_examples.py's sizes."""
    import json

    ex = os.path.join(REPO, "examples")
    orbit = ["--domain", "32", "--width", "32", "--height", "32",
             "--antialiasing", "1", "--frames", "2", "--device", "cpu"]
    runs = [
        ("bench_orbit_torch.py", orbit),
        ("bench_orbit_torch.py", [*orbit, "--batch", "--rgb"]),
        ("bench_scaling_torch.py", ["--domain", "64", "--width", "64", "--height",
                                    "64", "--frames", "1", "--device", "cpu"]),
    ]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_CLIENT_EXAMPLES,
         json.dumps([(os.path.join(ex, s), argv) for s, argv in runs])],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ran = [line[4:] for line in proc.stdout.splitlines() if line.startswith("ran ")]
    assert ran == [os.path.join(ex, script) for script, _ in runs]
    assert "orbit: 2 frames at 32x32 AA=1; " in proc.stdout
    assert "orbit (batched): 2 frames at 32x32 AA=1; " in proc.stdout
    assert " ms/frame at 64x64 with 8 bricks" in proc.stdout
