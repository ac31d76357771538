"""The port's user entry points on the CPU (``--device cpu``):
``api.render``, ``render(plotfile)`` and the CLI write PPM/PNG files that
match the JAX package's tile-march output within 1 byte per channel; the
error paths give clean errors; and the CLI runs end to end with jax
blocked from importing."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import amrvolumerenderer_torch
from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu import driver as jax_driver
from amrvolumerenderer_tpu.io import load_png, load_ppm
from amrvolumerenderer_tpu.plotfile import write_plotfile
from amrvolumerenderer_torch import api, driver

from tests.conftest import make_r2_scene_data
from test_torch_worklist import one_torch_thread, port_levels  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_bytes(path):
    img, _, _ = (load_png if path.endswith(".png") else load_ppm)(path)
    return np.rint(img * 255).astype(np.int32)


def assert_images_within_one_byte(got_path, want_path):
    got, want = load_bytes(got_path), load_bytes(want_path)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (want > 0).mean() > 0.1  # premise: something was rendered


@pytest.fixture(scope="module")
def plotfile(tmp_path_factory):
    """A two-level plotfile: the r^2 field on 16^3 plus a refined box,
    so convexify and level selection take part."""
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    levels, geoms = make_r2_scene_data(16, 8)
    c = (np.arange(16) + 0.5) / 32 + 0.25
    fine = (c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    levels.append([LevelBox(fine, np.array([8, 8, 8]))])
    geoms.append(LevelGeometry(np.zeros(3), np.full(3, 1.0 / 32)))
    path = str(tmp_path_factory.mktemp("plt") / "plt00000")
    write_plotfile(path, levels, geoms)
    return path


@pytest.mark.parametrize("method", ["tilemarch", "slicemarch"])
@pytest.mark.parametrize("ext", ["ppm", "png"])
def test_api_render_matches_jax(tmp_path, method, ext):
    levels, geoms = make_r2_scene_data(16, 8)
    opts = dict(width=48, height=40, render_method=method)
    got = str(tmp_path / f"port.{ext}")
    want = str(tmp_path / f"jax.{ext}")
    image, timing = api.render(
        api.AmrData(*port_levels(levels, geoms)),
        api.RenderOptions(output_filename=got, device="cpu", **opts),
        verbose=False,
    )
    ref, _ = jax_api.render(
        jax_api.AmrData(level_data=levels, level_geometry=geoms),
        jax_api.RenderOptions(output_filename=want, **opts), verbose=False,
    )
    assert image.pixels.shape == ref.pixels.shape == (48 * 40, 5)
    assert timing.render_seconds > 0
    assert_images_within_one_byte(got, want)


@pytest.mark.parametrize("ext", ["ppm", "png"])
def test_render_plotfile_matches_jax(tmp_path, plotfile, ext):
    got = str(tmp_path / f"port.{ext}")
    want = str(tmp_path / f"jax.{ext}")
    rc = amrvolumerenderer_torch.render(
        plotfile, width=40, height=32, output=got, antialiasing=4,
        camera_eye=(1.8, 1.1, 2.4), camera_look_at=(0.5, 0.5, 0.5),
        device="cpu",
    )
    assert rc == 0
    # the JAX CLI has no camera flags: its run_options takes the camera
    options = jax_driver.parse_options([
        "--width", "40", "--height", "32", "--antialiasing", "4",
        "--render-method", "tilemarch", "--output", want, plotfile,
    ])
    from amrvolumerenderer_tpu.types import CameraParameters

    options.camera = CameraParameters(eye=(1.8, 1.1, 2.4),
                                      look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))
    assert jax_driver.run_options(options, verbose=False) == 0
    assert_images_within_one_byte(got, want)


@pytest.mark.parametrize("flags", [[], ["--sampling", "trilinear", "--classification",
                                        "pre", "--lut-size", "128"]])
def test_cli_matches_jax(tmp_path, plotfile, flags):
    got = str(tmp_path / "port.ppm")
    want = str(tmp_path / "jax.ppm")
    common = ["--width", "48", "--height", "48", *flags]
    assert driver.main([*common, "--device", "cpu", "--output", got, plotfile]) == 0
    assert jax_driver.main([*common, "--render-method", "tilemarch",
                            "--output", want, plotfile]) == 0
    assert_images_within_one_byte(got, want)


@pytest.mark.parametrize("argv,message", [
    (["--device", "cuda"], "no CUDA device"),
    (["--device", "cpu", "--render-method", "raymarch", "--sampling", "trilinear"],
     "requires the slicemarch or tilemarch method"),
    (["--device", "cpu", "--devices", "3", "--orbit-frames", "2"],
     "not divisible by the device count 3"),
    (["--device", "cpu", "--orbit-frames", "3", "--render-method", "raymarch"],
     "fast kernel family"),
    (["--device", "tpu"], "device must be"),
])
def test_cli_errors_are_clean(tmp_path, plotfile, capsys, argv, message):
    if argv[1] == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = driver.main([*argv, "--width", "32", "--height", "32", "--output",
                      str(tmp_path / "x.ppm"), plotfile])
    err = capsys.readouterr().err
    assert rc == 1
    assert message in err and "Traceback" not in err
    assert err.startswith("Error")


def test_api_errors(tmp_path):
    data = api.AmrData(*port_levels(*make_r2_scene_data(16, 8)))
    out = str(tmp_path / "x.ppm")
    # raymarch renders (the oracle), pixel for pixel as the JAX package
    levels, geoms = make_r2_scene_data(16, 8)
    ray = dict(width=32, height=32, render_method="raymarch",
               output_filename=str(tmp_path / "ray.ppm"))
    got, _ = api.render(data, api.RenderOptions(device="cpu", **ray),
                        verbose=False)
    want, _ = jax_api.render(jax_api.AmrData(level_data=levels, level_geometry=geoms),
                             jax_api.RenderOptions(**ray), verbose=False)
    np.testing.assert_array_equal(got.pixels, want.pixels)
    assert (got.pixels[:, 3] > 0).mean() > 0.1
    with pytest.raises(ValueError, match="multi-device"):
        api.render(data, api.RenderOptions(width=32, height=32, device="cpu",
                                           output_filename=out, devices=2,
                                           render_method="tilemarch"),
                   verbose=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.render(data, api.RenderOptions(width=32, height=32,
                                               output_filename=out),
                       verbose=False)
    assert not os.path.exists(out)


def test_runtime_pinning_and_help(capsys):
    amrvolumerenderer_torch.initialize_runtime("cpu")
    amrvolumerenderer_torch.finalize_runtime()
    with pytest.raises(RuntimeError):
        amrvolumerenderer_torch.finalize_runtime()
    assert driver.main(["--help"]) == 0
    assert "--device" in capsys.readouterr().out


def test_trace_dir_writes_profile(tmp_path, plotfile):
    trace = tmp_path / "trace"
    assert driver.main(["--width", "32", "--height", "32", "--device", "cpu",
                        "--trace-dir", str(trace), "--output",
                        str(tmp_path / "x.png"), plotfile]) == 0
    assert (trace / "render_trace.json").stat().st_size > 0


BLOCK_JAX = """
import runpy, sys
class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "amrvolumerenderer_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, BlockJax())
sys.argv = ["amrvolumerenderer_torch.driver"] + sys.argv[1:]
try:
    runpy.run_module("amrvolumerenderer_torch.driver", run_name="__main__")
except SystemExit:
    assert "jax" not in sys.modules
    assert "amrvolumerenderer_tpu" not in sys.modules
    raise
"""


def test_cli_runs_with_jax_blocked(tmp_path, plotfile):
    """The port's CLI end to end in a fresh interpreter where importing jax
    or the JAX package fails: the port must never need either."""
    out = tmp_path / "blocked.png"
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, "--width", "32", "--height", "32",
         "--device", "cpu", "--output", str(out), plotfile],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert out.stat().st_size > 0
    assert "Saved volume composited image" in proc.stdout
