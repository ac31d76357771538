"""The differentiable path over a sharded brick axis
(``diff.render_image_diff(..., mesh=...)``) on the CPU, against the
port's single call and against the JAX package's GSPMD gradient.

tests/test_diff.py::test_sharded_brick_axis_gradient_matches_single_device
shards its 8 bricks of 4^3 (seed 13, 8x8) over the 8-device mesh and holds
``jit(grad)`` to the unsharded gradient at rtol 1e-6.  Its camera (eye
(0.5, 0.5, 20), fov 45) puts no pixel centre on the bricks, so its frame
and gradients are all zero; the same bricks seen obliquely through a
narrow field of view ("oblique") give every brick a gradient and put
several bricks behind one another on every covered ray.  Both scenes come
from the JAX package's ``prepare_scene``, as NumPy arrays, for both
packages.

Tolerances: the frame equals the single call's (each pixel folds the same
layers in the same order); the data gradient rtol 1e-6 / atol 1e-9 (JAX's
test's bound); the LUT gradient, summed over shards in another order, 1e-4
of max |g|, and the eye gradient 1e-4 of the sum of its terms' magnitudes
(ROADMAP section 3); JAX's GSPMD gradients 1e-4 of max |g|.  Two gloo
processes of 4 shards each must give the one-process gradients, with the
eye and LUT gradients equal on both ranks and of the one-process
magnitude (no factor of the process count).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from amrvolumerenderer_tpu import diff as jdiff
from amrvolumerenderer_tpu.types import CameraParameters as JaxCamera
from amrvolumerenderer_torch import diff
from amrvolumerenderer_torch.parallel import directsend as ds

from test_torch_multihost import REPO, _free_port
from test_torch_worklist import one_torch_thread  # noqa: F401

DATA, LUT, EYE = 0, 4, 6
GRAD_REL = 1e-4
CAMERAS = {
    "test_diff": dict(eye=(0.5, 0.5, 20.0), look_at=(0.5, 0.5, 4.0)),
    "oblique": dict(eye=(2.0, 1.5, 14.0), look_at=(0.5, 0.5, 4.0),
                    fov_y_degrees=12.0),
}


def scene(name, width=8, height=8):
    """tests/test_diff.py's 8 bricks through the JAX package's
    ``prepare_scene``: (NumPy args, static)."""
    rng = np.random.default_rng(13)
    bricks = [(rng.uniform(0.1, 0.9, size=(4, 4, 4)).astype(np.float32),
               (0.0, 0.0, float(b)), (1.0, 1.0, float(b) + 1.0)) for b in range(8)]
    camera = JaxCamera(up=(0.0, 1.0, 0.0), **CAMERAS[name])
    args, static = jdiff.prepare_scene(bricks, camera, width=width, height=height)
    return tuple(np.asarray(a) for a in args), static


def run(args, static, mesh=None, shards=False):
    """The port's frame and the gradients of ``mean(frame)`` with respect
    to data, LUT and eye; ``shards`` passes the data as
    ``directsend.shard_leading`` blocks (their gradients concatenated)."""
    targs = list(diff.args_from_arrays(args, "cpu"))
    for i in (LUT, EYE):
        targs[i].requires_grad_(True)
    if shards:
        (data,) = ds.shard_leading(mesh, targs[DATA])
        data = [d.clone().requires_grad_(True) for d in data]
    else:
        data = targs[DATA].requires_grad_(True)
    image = diff.render_image_diff(data, *targs[1:], mesh=mesh, **static)
    image.mean().backward()
    g_data = torch.cat([d.grad for d in data]) if shards else data.grad
    return image.detach().numpy(), [g.numpy() for g in
                                    (g_data, targs[LUT].grad, targs[EYE].grad)]


def eye_terms(args, static):
    """Per eye component, the sum over the frame of |d mean(frame) / d
    eye|'s terms (forward mode): the scale a reordered sum of the eye
    gradient rounds against."""
    targs = list(diff.args_from_arrays(args, "cpu"))
    terms = []
    for c in range(3):
        with fwAD.dual_level():
            full = list(targs)
            full[EYE] = fwAD.make_dual(targs[EYE], torch.eye(3)[c])
            column = fwAD.unpack_dual(diff.render_image_diff(
                *full, remat=False, **static)).tangent
        terms.append(float(column.abs().sum()) / column.numel())
    return np.asarray(terms)


def assert_sharded_grads(got, want, terms):
    """Data at rtol 1e-6, LUT at 1e-4 of max |g|, eye at 1e-4 of its
    terms' sum."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-9)
    assert np.abs(got[1] - want[1]).max() <= GRAD_REL * np.abs(want[1]).max()
    assert np.all(np.abs(got[2] - want[2]) <= GRAD_REL * terms), (got[2], want[2])


@pytest.mark.parametrize("name", sorted(CAMERAS))
@pytest.mark.parametrize("num", [2, 4, 8])
def test_sharded_frame_and_gradients_match_single_call(name, num):
    args, static = scene(name)
    image, grads = run(args, static)
    got_image, got = run(args, static, ds.make_mesh(num, "cpu"))
    np.testing.assert_array_equal(got_image, image)
    assert_sharded_grads(got, grads, eye_terms(args, static))
    if name == "oblique":  # every brick is drawn, behind others
        assert all(np.abs(grads[0][b]).max() > 0.0 for b in range(8))
        assert image[:, 3].max() > 0.0


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_sharded_gradient_matches_jax_gspmd(name):
    """tests/test_diff.py:295-300's GSPMD gradient: the data sharded over
    the 8 virtual devices (tests/conftest.py), ``jit(grad(mean))``."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    assert len(jax.devices()) >= 8, "tests/conftest.py sets up 8 CPU devices"
    args, static = scene(name)
    jargs = tuple(jnp.asarray(a) for a in args)

    def loss(d):
        return jnp.mean(jdiff.render_image_diff(d, *jargs[1:], **static))

    mesh = Mesh(np.array(jax.devices()[:8]), ("bricks",))
    data = jax.device_put(jargs[0], NamedSharding(mesh, PartitionSpec("bricks")))
    want = np.asarray(jax.jit(jax.grad(loss))(data))
    _, got = run(args, static, ds.make_mesh(8, "cpu"))
    assert np.abs(got[0] - want).max() <= GRAD_REL * max(np.abs(want).max(), 1e-30)
    if name == "oblique":
        assert np.abs(want).max() > 0.0


def test_data_as_shards_receive_their_rows():
    args, static = scene("oblique")
    mesh = ds.make_mesh(4, "cpu")
    image, grads = run(args, static, mesh)
    got_image, got = run(args, static, mesh, shards=True)
    np.testing.assert_array_equal(got_image, image)
    for g, w in zip(got, grads):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("num", [2, 4])
def test_pixel_count_not_divisible_by_mesh(num):
    """7 x 9 = 63 pixels: padded with cleared pixels, cropped after the
    gather."""
    args, static = scene("oblique", width=7, height=9)
    image, grads = run(args, static)
    got_image, got = run(args, static, ds.make_mesh(num, "cpu"))
    assert got_image.shape == (63, 4)
    np.testing.assert_array_equal(got_image, image)
    assert_sharded_grads(got, grads, eye_terms(args, static))


def test_brick_count_not_divisible_by_mesh_raises():
    args, static = scene("oblique")
    targs = diff.args_from_arrays(args, "cpu")
    with pytest.raises(ValueError, match="not divisible by the mesh size 3"):
        diff.render_image_diff(*targs, mesh=ds.make_mesh(3, "cpu"), **static)


# one rank of the two-process case: the scene from an .npz, the data as
# this process's shards and then whole, each form's frame and gradients
# saved for the test to compare
RANK = r"""
import json, sys
import numpy as np
import torch
from amrvolumerenderer_torch import diff, driver
from amrvolumerenderer_torch.parallel import directsend as ds

assert driver.maybe_initialize_distributed("cpu", verbose=False)
scene = np.load(sys.argv[1])
static = json.loads(sys.argv[2])
rank = torch.distributed.get_rank()
mesh = ds.make_mesh(8, "cpu")
out = {"local": np.asarray(mesh.local)}
for form in ("shards", "whole"):
    args = list(diff.args_from_arrays([scene[f"a{i}"] for i in range(16)], "cpu"))
    for i in (4, 6):
        args[i].requires_grad_(True)
    if form == "shards":
        (data,) = ds.shard_leading(mesh, args[0])
        data = [None if d is None else d.clone().requires_grad_(True) for d in data]
    else:
        data = args[0].requires_grad_(True)
    image = diff.render_image_diff(data, *args[1:], mesh=mesh, **static)
    image.mean().backward()
    out[form + "_image"] = image.detach().numpy()
    out[form + "_data"] = (torch.cat([data[r].grad for r in mesh.local])
                           if form == "shards" else data.grad).numpy()
    out[form + "_lut"] = args[4].grad.numpy()
    out[form + "_eye"] = args[6].grad.numpy()
np.savez(sys.argv[3] + str(rank) + ".npz", **out)
torch.distributed.destroy_process_group()
"""


def test_two_processes_give_the_one_process_gradient(tmp_path):
    """Two gloo processes (the JAX-style launch variables, as
    tests/test_torch_multihost.py starts them), 4 shards each: each
    rank's rows of the data gradient are the one-process gradient's; the
    eye and LUT gradients are equal on both ranks and within tolerance of
    one process, so no factor of the process count; with the data whole,
    every rank holds the whole data gradient."""
    args, static = scene("oblique")
    np.savez(tmp_path / "scene.npz", **{f"a{i}": a for i, a in enumerate(args)})
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "LOCAL_")) and k != "AVR_DISTRIBUTED"}
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, str(tmp_path / "scene.npz"),
             json.dumps(static), str(tmp_path / "rank")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-3000:]

    image, want = run(args, static)
    terms = eye_terms(args, static)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    for r, got in enumerate(ranks):
        assert list(got["local"]) == list(range(4 * r, 4 * r + 4))
        rows = slice(4 * r, 4 * r + 4)
        for form in ("shards", "whole"):
            np.testing.assert_array_equal(got[form + "_image"], image)
            data = got[form + "_data"]
            if form == "whole":
                # the whole tensor is a replicated input: summed over ranks
                np.testing.assert_allclose(data, want[0], rtol=1e-6, atol=1e-9)
                data = data[rows]
            np.testing.assert_allclose(data, want[0][rows], rtol=1e-6, atol=1e-9)
            assert_sharded_grads([want[0], got[form + "_lut"], got[form + "_eye"]],
                                 want, terms)
    for key in ("shards_lut", "shards_eye", "whole_lut", "whole_eye", "whole_data"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
