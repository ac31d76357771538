"""The port's differentiable path (amrvolumerenderer_torch/diff.py) on the
CPU, against the JAX package's ``diff`` and against its own oracle.

Each JAX-side call is jitted, as ``tests/test_diff.py`` runs it; both
packages get the same seeded NumPy inputs (the port through
``diff.args_from_arrays``).  Tolerances (ROADMAP section 3; measured
values from ``scripts/torch_diff_parity.py``): forward colours 2e-6, the
golden manifest's (measured up to 1.8e-7), with the same non-finite depth
pattern; data and LUT gradients max |diff| <= 1e-4 x max |g_JAX|
(measured up to 2.4e-5: summation order and the forward's ulps).  A
camera gradient is one sum over the frame whose terms cancel: eye, basis
and field of view are held at 1e-4 of the sum of their terms' magnitudes
(from ``jax.jacfwd``), the per-pixel derivatives themselves (the port's
forward mode) at 1e-4 x max |J|.  The first group mirrors every case of
``tests/test_diff.py`` on the port alone, at that file's tolerances.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import diff as jdiff
from amrvolumerenderer_tpu.driver import load_plotfile_geometry as jax_load_geometry
from amrvolumerenderer_tpu.plotfile import write_plotfile
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
from amrvolumerenderer_tpu.types import CameraParameters as JaxCamera
from amrvolumerenderer_tpu.types import ScalarTransform as JaxTransform
from amrvolumerenderer_torch import diff
from amrvolumerenderer_torch.camera import camera_basis, compute_box_depth_hints
from amrvolumerenderer_torch.colormap import build_color_table
from amrvolumerenderer_torch.driver import load_plotfile_geometry
from amrvolumerenderer_torch.ops import composite as comp
from amrvolumerenderer_torch.ops import numerics
from amrvolumerenderer_torch.ops.raymarch import render_bucket_impl
from amrvolumerenderer_torch.scene import set_scene_normalization_range
from amrvolumerenderer_torch.types import CameraParameters, ScalarTransform

from test_diff import STATIC, make_args, smooth_lut
from test_torch_fold_diff import fold_case, plain_kernels
from test_torch_worklist import one_torch_thread  # noqa: F401

WIDTH = HEIGHT = 12
CAMERA = dict(eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.5), up=(0.0, 1.0, 0.0),
              fov_y_degrees=45.0)
FORWARD_ATOL = 2e-6
GRAD_REL = 1e-4
# argument positions of render_*_diff that carry a gradient here
DATA, LUT, EYE, FWD, RIGHT, UP, FOV = 0, 4, 6, 7, 8, 9, 10


def np_args(data, lut, **kw):
    """test_diff.make_args as NumPy arrays (one brick)."""
    return tuple(np.asarray(a) for a in make_args(data, lut, **kw))


def port(args):
    return diff.args_from_arrays(args, "cpu")


def port_image(args, static, **kw):
    return diff.render_image_diff(*port(args), **static, **kw)


def port_grads(args, static, weights, argnums, **kw):
    """The port's gradients of ``sum(image * weights)``."""
    targs = list(port(args))
    for i in argnums:
        targs[i].requires_grad_(True)
    image = diff.render_image_diff(*targs, **static, **kw)
    (image * torch.from_numpy(weights)).sum().backward()
    return [targs[i].grad.numpy() for i in argnums]


def jax_grads(args, static, weights, argnums):
    """``jax.jit(jax.grad)`` of ``sum(image * weights)``."""
    def loss(*picked):
        full = list(args)
        for i, v in zip(argnums, picked):
            full[i] = v
        return jnp.sum(jdiff.render_image_diff(*full, **static) * weights)

    grad = jax.jit(jax.grad(loss, argnums=tuple(range(len(argnums)))))
    return [np.asarray(g) for g in grad(*(jnp.asarray(args[i]) for i in argnums))]


def assert_grads_close(got, want, tag=""):
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(np.abs(w).max())
        assert scale > 0.0, (tag, i)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale, f"{tag} grad {i}: {err:.3g} of {scale:.3g}"


# -- the port alone: a mirror of every case of tests/test_diff.py ------------


def test_forward_matches_oracle_on_constant_field():
    data = np.full((8, 8, 8), 128.0 / 255.0, dtype=np.float32)
    args = np_args(data, smooth_lut())
    got_c, got_d = diff.render_layers_diff(*port(args), **STATIC)
    exp_c, exp_d = render_bucket_impl(*args[:10], *(float(a) for a in args[10:]),
                                      **STATIC)
    np.testing.assert_allclose(got_c.numpy(), exp_c.numpy(), atol=2e-6)
    np.testing.assert_array_equal(np.isfinite(got_d.numpy()),
                                  np.isfinite(exp_d.numpy()))


def test_forward_close_to_oracle_on_smooth_field():
    rng = np.random.default_rng(3)
    base = rng.uniform(0.2, 0.8, size=(4, 4, 4))
    data = np.kron(base, np.ones((2, 2, 2)))[:8, :8, :8].astype(np.float32)
    args = np_args(data, smooth_lut())
    got_c, _ = diff.render_layers_diff(*port(args), **STATIC)
    exp_c, _ = render_bucket_impl(*args[:10], *(float(a) for a in args[10:]),
                                  **STATIC)
    assert float((got_c - exp_c).abs().max()) < 0.12


@pytest.mark.parametrize("target", ["data", "lut"])
def test_grad_matches_finite_differences(target):
    """test_diff.py's two finite-difference cases (data: seed 11, LUT:
    seed 4, 64 entries) on the port, at their rel=0.12, abs=2e-4."""
    seed, size, pos = (11, 256, DATA) if target == "data" else (4, 64, LUT)
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32)
    args = np_args(data, smooth_lut(size=size, peak_alpha=0.3))
    w = rng.uniform(0.0, 1.0, size=(WIDTH * HEIGHT, 4)).astype(np.float32)
    (g,) = port_grads(args, STATIC, w, (pos,))
    g = g[0]
    assert np.any(g != 0.0)

    def loss(value):
        full = list(args)
        full[pos] = value[None]
        return float((port_image(full, STATIC) * torch.from_numpy(w)).sum())

    base = args[pos][0]
    eps = 2e-2
    for fi in np.argsort(np.abs(g).ravel())[::-1][:5]:
        at = np.unravel_index(fi, g.shape)
        up, down = np.array(base), np.array(base)
        up[at] += eps
        down[at] -= eps
        fd = (loss(up) - loss(down)) / (2 * eps)
        assert fd == pytest.approx(float(g[at]), rel=0.12, abs=2e-4), (
            f"{target} {at}: ad={g[at]:.6g} fd={fd:.6g}")


def test_jit_name_grad_matches_eager_and_jax():
    """``render_image_diff_jit`` is the eager function: its gradient equals
    ``render_image_diff``'s, and both are held to JAX's jitted gradient."""
    rng = np.random.default_rng(5)
    data = rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32)
    args = np_args(data, smooth_lut())
    w = np.full((WIDTH * HEIGHT, 4), 1.0 / (WIDTH * HEIGHT * 4), np.float32)
    assert diff.render_image_diff_jit is diff.render_image_diff
    (eager,) = port_grads(args, STATIC, w, (DATA,))
    targs = list(port(args))
    targs[DATA].requires_grad_(True)
    diff.render_image_diff_jit(*targs, **STATIC).mean().backward()
    np.testing.assert_allclose(targs[DATA].grad.numpy(), eager, rtol=1e-5, atol=1e-7)
    assert_grads_close([eager], jax_grads(args, STATIC, w, (DATA,)))


def test_composite_layers_diff_matches_manual_fold():
    rng = np.random.default_rng(9)
    layers = rng.uniform(0.0, 0.4, size=(3, 10, 4)).astype(np.float32)
    order = [2, 0, 1]
    got = diff.composite_layers_diff(torch.from_numpy(layers), order).numpy()
    accum = np.zeros((10, 4), dtype=np.float32)
    for li in order:
        accum = accum + layers[li] * (1.0 - accum[:, 3:4])
    np.testing.assert_allclose(got, np.clip(accum, 0, 1), rtol=1e-6, atol=1e-7)


def two_brick_args(d_far, d_near, lut, mins, maxs):
    camera = CameraParameters(**CAMERA)
    forward, right, up = camera_basis(camera)
    f32 = np.float32
    return (np.stack([d_far, d_near]).astype(f32), np.asarray(mins, f32),
            np.asarray(maxs, f32), np.full((2, 3), 4, np.int32),
            np.stack([lut, lut]).astype(f32), np.full(2, 0.125, f32),
            np.asarray(camera.eye, f32), np.asarray(forward, f32),
            np.asarray(right, f32), np.asarray(up, f32),
            f32(camera.fov_y_degrees), f32(0.0), f32(1.0))


def test_two_brick_default_order_is_depth_sorted():
    args = two_brick_args(np.full((4, 4, 4), 0.1), np.full((4, 4, 4), 0.9),
                          smooth_lut(peak_alpha=0.9),
                          [[0, 0, 0], [0, 0, 1]], [[1, 1, 1], [1, 1, 2]])
    image = port_image(args, STATIC).numpy()
    center = (HEIGHT // 2) * WIDTH + WIDTH // 2
    assert image[center, 0] > image[center, 2]


def test_remat_grad_matches_no_remat():
    rng = np.random.default_rng(6)
    data = rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32)
    args = np_args(data, smooth_lut())
    w = np.full((WIDTH * HEIGHT, 4), 1.0 / (WIDTH * HEIGHT * 4), np.float32)
    (g_remat,) = port_grads(args, STATIC, w, (DATA,), remat=True)
    (g_plain,) = port_grads(args, STATIC, w, (DATA,), remat=False)
    np.testing.assert_allclose(g_remat, g_plain, rtol=1e-6, atol=1e-9)


def two_bricks(seed):
    rng = np.random.default_rng(seed)
    return [
        (rng.uniform(0.1, 0.9, size=(6, 6, 6)).astype(np.float32),
         (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
        (rng.uniform(0.1, 0.9, size=(4, 8, 6)).astype(np.float32),
         (0.0, 0.0, 1.0), (1.0, 1.0, 2.0)),
    ]


def test_prepare_scene_end_to_end():
    args, static = diff.prepare_scene(two_bricks(8), CameraParameters(**CAMERA),
                                      width=WIDTH, height=HEIGHT, device="cpu")
    image = diff.render_image_diff(*args, **static)
    assert image.shape == (WIDTH * HEIGHT, 4)
    assert float(image[:, 3].max()) > 0.0
    data = args[0].clone().requires_grad_(True)
    diff.render_image_diff(data, *args[1:], **static).mean().backward()
    g = data.grad.numpy()
    assert np.any(g[0] != 0.0) and np.any(g[1] != 0.0)
    assert np.abs(g[1][:4, :8, :6]).sum() > 0.0


def test_split_brick_axis_gradient_matches_single_call():
    """test_diff.py's sharded brick-axis case: the 8 bricks rendered in 8
    one-brick calls and composited in the default order give the unsplit
    call's gradient (rtol 1e-6)."""
    rng = np.random.default_rng(13)
    bricks = [(rng.uniform(0.1, 0.9, size=(4, 4, 4)).astype(np.float32),
               (0.0, 0.0, float(b)), (1.0, 1.0, float(b) + 1.0)) for b in range(8)]
    camera = CameraParameters(eye=(0.5, 0.5, 20.0), look_at=(0.5, 0.5, 4.0),
                              up=(0.0, 1.0, 0.0))
    args, static = diff.prepare_scene(bricks, camera, width=8, height=8,
                                      device="cpu")

    data = args[0].clone().requires_grad_(True)
    diff.render_image_diff(data, *args[1:], **static).mean().backward()
    g_single = data.grad.numpy()

    split = args[0].clone().requires_grad_(True)
    colors = torch.cat([
        diff.render_layers_diff(split[b:b + 1], *(a[b:b + 1] for a in args[1:6]),
                                *args[6:], **static)[0]
        for b in range(8)])
    order = diff.default_order(args[1], args[2], args[6], args[7])
    diff.composite_layers_diff(colors, order).mean().backward()
    np.testing.assert_allclose(split.grad.numpy(), g_single, rtol=1e-6, atol=1e-9)


def test_no_nan_gradient_on_parallel_miss_rays():
    rng = np.random.default_rng(15)
    data = rng.uniform(0.2, 0.8, size=(4, 4, 4)).astype(np.float32)
    args = np_args(data, smooth_lut(), bmin=(2.0, 0.0, 0.0), bmax=(3.0, 1.0, 1.0))
    static = dict(STATIC, width=11, height=11)
    image = port_image(args, static).numpy()
    assert np.all(np.isfinite(image))
    (g,) = port_grads(args, static, np.ones((121, 4), np.float32), (DATA,))
    assert np.all(np.isfinite(g)), f"{np.isnan(g).sum()} NaN gradient cells"


def test_prepare_scene_opacity_reference_is_coarsest_brick():
    rng = np.random.default_rng(19)
    bricks = [
        (rng.uniform(0.2, 0.8, size=(4, 4, 4)).astype(np.float32),
         (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
        (rng.uniform(0.2, 0.8, size=(8, 8, 8)).astype(np.float32),
         (0.0, 0.0, 1.0), (1.0, 1.0, 2.0)),
    ]
    args, _ = diff.prepare_scene(bricks, CameraParameters(**CAMERA), width=8,
                                 height=8, device="cpu")
    luts = args[4].numpy()
    expected_coarse = build_color_table(1.0, 1.0, (0.0, 1.0), None, size=256)
    np.testing.assert_allclose(luts[0], expected_coarse, rtol=1e-6, atol=1e-7)
    assert np.all(luts[1][1:, 3] < luts[0][1:, 3])


def test_default_order_matches_corner_depth_hints():
    camera = CameraParameters(**CAMERA)
    mins = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 0.0]], np.float32)
    maxs = np.array([[1.0, 1.0, 2.0], [1.0, 1.0, 1.0]], np.float32)
    expected = np.argsort(compute_box_depth_hints(mins, maxs, camera))
    lut = np.zeros((256, 4), dtype=np.float32)  # transparent: no alpha at all
    args = two_brick_args(np.full((4, 4, 4), 0.5), np.full((4, 4, 4), 0.5), lut,
                          mins, maxs)
    orders = []
    real = diff.composite_layers_diff

    def spy(colors, order):
        orders.append(np.asarray(order))
        return real(colors, order)

    import unittest.mock as mock

    with mock.patch.object(diff, "composite_layers_diff", spy):
        port_image(args, STATIC)
    np.testing.assert_array_equal(orders[0], expected)


def r2_plotfile(path, n=8):
    c = np.arange(n) / (n - 1)
    field = (c[:, None, None] ** 2 + c[None, :, None] ** 2
             + c[None, None, :] ** 2).astype(np.float64)
    write_plotfile(path, [[LevelBox(field, np.zeros(3, dtype=int))]],
                   [LevelGeometry(np.zeros(3), np.full(3, 1.0 / n))],
                   var_names=["density"])


def test_prepare_geometry_from_plotfile(tmp_path):
    path = str(tmp_path / "plt00000")
    r2_plotfile(path)
    geometry = load_plotfile_geometry(path, "density", 0, -1, log_scale_input=False,
                                      verbose=False)
    args, static = diff.prepare_geometry(geometry, CameraParameters(**CAMERA),
                                         width=WIDTH, height=HEIGHT, device="cpu")
    assert float(diff.render_image_diff(*args, **static)[:, 3].max()) > 0.0
    data = args[0].clone().requires_grad_(True)
    diff.render_image_diff(data, *args[1:], **static).mean().backward()
    assert np.any(data.grad.numpy() != 0.0)

    set_scene_normalization_range(geometry, 0.0, 10.0)
    args2, _ = diff.prepare_geometry(geometry, CameraParameters(**CAMERA),
                                     width=WIDTH, height=HEIGHT, device="cpu")
    assert float(args2[11]) == 0.0 and float(args2[12]) == 1.0
    t = geometry.scalar_transform
    assert float(args2[14]) == np.float32(t.normalization_min)
    assert float(args2[15]) == np.float32(t.inverse_normalization_span)


def test_grad_wrt_camera_eye_is_finite_and_nonzero():
    rng = np.random.default_rng(23)
    data = rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32)
    args = np_args(data, smooth_lut(peak_alpha=0.3))
    w = rng.uniform(0.0, 1.0, size=(WIDTH * HEIGHT, 4)).astype(np.float32)
    (g,) = port_grads(args, STATIC, w, (EYE,))
    assert np.all(np.isfinite(g))
    assert np.any(g != 0.0)


def test_transfer_function_optimization_descends():
    rng = np.random.default_rng(21)
    data = rng.uniform(0.1, 0.9, size=(6, 6, 6)).astype(np.float32)
    args = port(np_args(data, smooth_lut(size=32, peak_alpha=0.5)))
    target = diff.render_image_diff(*args, **STATIC)

    def value_and_grad(table):
        table = table.detach().requires_grad_(True)
        image = diff.render_image_diff(*args[:4], table, *args[5:], **STATIC)
        loss = ((image - target) ** 2).mean()
        loss.backward()
        return float(loss.detach()), table.grad

    lut = torch.from_numpy(smooth_lut(size=32, peak_alpha=0.15))[None]
    losses = []
    for _ in range(12):
        val, g = value_and_grad(lut)
        losses.append(val)
        lut = torch.minimum(torch.maximum(lut - 2.0 * g, torch.tensor(0.0)),
                            torch.tensor(1.0))
    final, _ = value_and_grad(lut)
    assert final < 0.5 * losses[0], f"{losses[0]:.3g} -> {final:.3g}"


# -- against the JAX functions ----------------------------------------------


def test_trilinear_sample_matches_jax():
    """Values and gradients (brick, positions) at positions inside, on the
    clamp edges and outside the brick, padded shape larger than dims."""
    rng = np.random.default_rng(31)
    brick = rng.uniform(-1, 1, size=(6, 7, 5)).astype(np.float32)
    dims = np.array([5, 7, 4], np.int32)
    bmin = np.array([0.1, -0.2, 0.3], np.float32)
    cell = np.array([0.2, 0.15, 0.25], np.float32)
    pos = rng.uniform(-0.3, 1.6, size=(200, 3)).astype(np.float32)
    pos[:5] = bmin + cell * 0.5  # exactly on a cell centre: w = 0 ties
    w = rng.uniform(-1, 1, size=200).astype(np.float32)

    def jloss(b, p):
        return jnp.sum(jdiff.trilinear_sample(b, jnp.asarray(dims), jnp.asarray(bmin),
                                              jnp.asarray(cell), p) * w)

    jv = np.asarray(jax.jit(jdiff.trilinear_sample)(brick, dims, bmin, cell, pos))
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(brick, pos)
    tb = torch.from_numpy(brick).requires_grad_(True)
    tp = torch.from_numpy(pos).requires_grad_(True)
    tv = diff.trilinear_sample(tb, torch.from_numpy(dims), torch.from_numpy(bmin),
                               torch.from_numpy(cell), tp)
    (tv * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=0, atol=FORWARD_ATOL)
    assert_grads_close([tb.grad.numpy(), tp.grad.numpy()],
                       [np.asarray(g) for g in jg])


def test_lut_lookup_linear_matches_jax():
    rng = np.random.default_rng(32)
    lut = rng.uniform(0, 1, size=(33, 4)).astype(np.float32)
    u = rng.uniform(-0.2, 1.2, size=300).astype(np.float32)
    u[:4] = [0.0, 1.0, 0.5, 16.0 / 32.0]  # the bounds and a bin edge
    w = rng.uniform(-1, 1, size=(300, 4)).astype(np.float32)
    jv = np.asarray(jax.jit(jdiff.lut_lookup_linear)(lut, u))
    jg = jax.jit(jax.grad(lambda t, v: jnp.sum(jdiff.lut_lookup_linear(t, v) * w),
                          argnums=(0, 1)))(lut, u)
    tl = torch.from_numpy(lut).requires_grad_(True)
    tu = torch.from_numpy(u).requires_grad_(True)
    tv = diff.lut_lookup_linear(tl, tu)
    (tv * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=0, atol=FORWARD_ATOL)
    assert_grads_close([tl.grad.numpy(), tu.grad.numpy()], [np.asarray(g) for g in jg])


def fold_inputs(which):
    """(layers [B, P, 4], order [B], weights [P, 4]) as numpy arrays: "few",
    five layers of 40 pixels with opaque front pixels; or "ties",
    ``fold_case``'s eight layers of 1000 (clip ties at 0 and 1, values
    beyond the clip, -0.0 weights)."""
    if which == "ties":
        return tuple(t.numpy() for t in fold_case(8, 1000, "permuted", seed=33))
    rng = np.random.default_rng(33)
    layers = rng.uniform(0.0, 0.6, size=(5, 40, 4)).astype(np.float32)
    layers[0, :8] = [0.5, 0.25, 0.125, 1.0]  # opaque front pixels
    order = np.array([0, 3, 1, 4, 2])
    w = rng.uniform(-1, 1, size=(40, 4)).astype(np.float32)
    return layers, order, w


def check_fold_matches_jax(route, layers, order, w):
    """The port's fold by ``route`` against JAX's: values at FORWARD_ATOL
    and the layers' gradient of ``sum(image * w)`` at GRAD_REL.  "loop" is
    ``diff.composite_layers_diff`` on the CPU (its eager loop); "sweep" is
    ``ops.composite.fold_diff`` through the plain versions of its kernels
    (the card's back-to-front sweep and its order of the float64 sum)."""
    jv = np.asarray(jax.jit(jdiff.composite_layers_diff)(layers, order))
    (jg,) = jax.jit(jax.grad(lambda c: jnp.sum(jdiff.composite_layers_diff(c, order)
                                               * w), argnums=(0,)))(layers)
    tc = torch.from_numpy(layers).requires_grad_(True)
    with plain_kernels() if route == "sweep" else contextlib.nullcontext():
        if route == "loop":
            tv = diff.composite_layers_diff(tc, order)
        else:
            tv = comp.fold_diff(tc, torch.from_numpy(order))
        (tv * torch.from_numpy(w)).sum().backward()
    assert np.any(jv[:, 3] == 1.0)
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=0, atol=FORWARD_ATOL)
    assert_grads_close([tc.grad.numpy()], [np.asarray(jg)])


def test_composite_layers_diff_matches_jax():
    """Values and layer gradients, including pixels that saturate at
    alpha exactly 1 (the clip's tie)."""
    check_fold_matches_jax("loop", *fold_inputs("few"))


@pytest.mark.parametrize("route, inputs", [("sweep", "few"), ("sweep", "ties"),
                                           ("loop", "ties")])
def test_composite_layers_diff_matches_jax_by_route(route, inputs):
    """As ``test_composite_layers_diff_matches_jax``, by the plain versions
    of the card's fold kernels too, and on inputs with clip ties at 0 and
    1, values beyond the clip and -0.0 weights."""
    check_fold_matches_jax(route, *fold_inputs(inputs))


def grid_bricks(seed, camera):
    """Eight bricks side by side in a 2x2x2 block (their corner keys tie
    pairwise under an axis-aligned camera) through both prepare_scenes."""
    rng = np.random.default_rng(seed)
    bricks = [(rng.uniform(0.1, 0.9, size=(4, 4, 4)).astype(np.float32),
               (float(i), float(j), float(k)), (i + 1.0, j + 1.0, k + 1.0))
              for i in range(2) for j in range(2) for k in range(2)]
    return jdiff.prepare_scene(bricks, JaxCamera(**camera), width=8, height=8)


@pytest.mark.parametrize("camera", [
    dict(eye=(1.0, 1.0, 9.0), look_at=(1.0, 1.0, 1.0), up=(0.0, 1.0, 0.0)),
    dict(eye=(4.1, 3.3, -6.0), look_at=(1.0, 0.9, 1.2), up=(0.0, 1.0, 0.0),
         fov_y_degrees=50.0),
])
def test_default_order_matches_jax_argsort(camera):
    """The corner-depth key rounds as JAX's jitted einsum (an FMA chain)
    and ties keep brick order, as the stable ``jnp.argsort``."""
    args, _ = grid_bricks(41, camera)
    sel = jnp.asarray([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], bool)

    @jax.jit
    def key(mins, maxs, eye, fwd):
        corners = jnp.where(sel[None], maxs[:, None, :], mins[:, None, :])
        return jnp.min(jnp.einsum("bcx,x->bc", corners - eye[None, None, :], fwd),
                       axis=1)

    jkey = key(*(args[i] for i in (1, 2, 6, 7)))
    want = np.asarray(jnp.argsort(jkey))
    targs = port([np.asarray(a) for a in args])
    got = diff.default_order(*(targs[i] for i in (1, 2, 6, 7))).numpy()
    np.testing.assert_array_equal(got, want)
    if camera["eye"][0] == 1.0:  # axis-aligned: the near and far layers tie
        assert len(np.unique(np.asarray(jkey))) < len(want)


SCENE_TRANSFORMS = {
    "identity": (None, (0.0, 1.0)),
    "log-normalize-clip": (dict(log_scale_input=True, normalize_to_unit_range=True,
                                positive_floor=0.05, normalization_min=np.log(0.05),
                                inverse_normalization_span=0.5), (0.1, 0.7)),
}


@pytest.mark.parametrize("name", list(SCENE_TRANSFORMS))
def test_prepare_scene_and_geometry_args_equal_jax(tmp_path, name):
    transform, srange = SCENE_TRANSFORMS[name]
    kw = dict(width=10, height=6, scalar_range=srange, box_transparency=0.25,
              lut_size=64)
    bricks = two_bricks(8)
    jt = JaxTransform(**transform) if transform else None
    pt = ScalarTransform(**transform) if transform else None
    jargs, jstatic = jdiff.prepare_scene(bricks, JaxCamera(**CAMERA), transform=jt, **kw)
    pargs, pstatic = diff.prepare_scene(bricks, CameraParameters(**CAMERA),
                                        transform=pt, device="cpu", **kw)
    assert pstatic == jstatic
    assert len(pargs) == len(jargs)
    for p, j in zip(pargs, jargs):
        j = np.asarray(j)
        assert p.numpy().dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(p.numpy(), j)

    path = str(tmp_path / "plt00000")
    r2_plotfile(path)
    log = transform is not None
    jgeom = jax_load_geometry(path, "density", 0, -1, log_scale_input=log,
                              verbose=False)
    pgeom = load_plotfile_geometry(path, "density", 0, -1, log_scale_input=log,
                                   verbose=False)
    jargs, jstatic = jdiff.prepare_geometry(jgeom, JaxCamera(**CAMERA), width=12,
                                            height=12)
    pargs, pstatic = diff.prepare_geometry(pgeom, CameraParameters(**CAMERA),
                                           width=12, height=12, device="cpu")
    assert pstatic == jstatic
    for p, j in zip(pargs, jargs):
        assert p.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def saturating_lut():
    lut = smooth_lut(peak_alpha=0.6)
    lut[160:, 3] = 1.0  # opaque tail: rays saturate at alpha exactly 1
    return lut


def log_case():
    rng = np.random.default_rng(27)
    data = rng.uniform(0.01, 5.0, size=(6, 6, 6)).astype(np.float32)
    data[0, :, :3] = 0.02  # on the positive floor: jnp.maximum's tie
    data[5, 5, :2] = -1.0  # below zero: the floor
    args = list(np_args(data, smooth_lut(peak_alpha=0.3)))
    args[13:16] = [np.float32(0.02), np.float32(np.log(0.02)),
                   np.float32(1.0 / (np.log(5.0) - np.log(0.02)))]
    return tuple(args), dict(STATIC, log_scale=True, normalize=True,
                             apply_clip=True, clip_start=0.7)


def forward_cases():
    rng = np.random.default_rng(11)
    data = rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32)
    yield "random", np_args(data, smooth_lut(peak_alpha=0.3)), STATIC
    yield "saturating", np_args(data, saturating_lut()), STATIC
    yield "log-normalize-clip", *log_case()
    miss = rng.uniform(0.2, 0.8, size=(4, 4, 4)).astype(np.float32)
    yield "misses", np_args(miss, smooth_lut(), bmin=(0.3, 0.0, 0.0),
                            bmax=(1.3, 1.0, 1.0)), dict(STATIC, width=11, height=9)
    args, static = grid_bricks(41, dict(eye=(4.1, 3.3, -6.0), look_at=(1.0, 0.9, 1.2),
                                        up=(0.0, 1.0, 0.0), fov_y_degrees=50.0))
    yield "eight-bricks", tuple(np.asarray(a) for a in args), static


CASES = {name: (args, static) for name, args, static in forward_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    """Layers and depths of the jitted ``render_layers_diff`` and the
    jitted image, at 2e-6, the same non-finite depth pattern."""
    args, static = CASES[name]
    layers = jax.jit(jdiff.render_layers_diff, static_argnames=tuple(static))
    jc, jd = (np.asarray(v) for v in layers(*args, **static))
    tc, td = diff.render_layers_diff(*port(args), **static)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), np.isfinite(jd))
    finite = np.isfinite(jd)
    np.testing.assert_allclose(td.numpy()[finite], jd[finite], rtol=0,
                               atol=FORWARD_ATOL)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=FORWARD_ATOL)
    ji = np.asarray(jdiff.render_image_diff_jit(*args, **static))
    np.testing.assert_allclose(port_image(args, static).numpy(), ji, rtol=0,
                               atol=FORWARD_ATOL)
    if name == "saturating":
        assert np.any(jc[..., 3] == 1.0) and np.any(ji[:, 3] == 1.0)
    if name == "misses":
        assert not np.all(finite)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(name):
    """Gradients of a randomly weighted image loss with respect to data,
    LUT, eye, the three basis vectors and the field of view against
    ``jax.jit(jax.grad)``.

    Data and LUT: max |diff| <= 1e-4 x max |g_JAX|.  A camera gradient is
    one sum over every pixel whose terms cancel (JAX's own eager and
    jitted gradients differ by up to 7.9e-5 x max |g| here), so each
    component is held at 1e-4 x the sum of its terms' magnitudes, from
    the per-pixel derivatives ``jax.jacfwd`` gives."""
    args, static = CASES[name]
    w = np.random.default_rng(7).uniform(
        0, 1, size=(static["width"] * static["height"], 4)).astype(np.float32)
    argnums = (DATA, LUT, EYE, FWD, RIGHT, UP, FOV)
    got = port_grads(args, static, w, argnums)
    want = jax_grads(args, static, w, argnums)
    assert_grads_close(got[:2], want[:2], name)

    camera = argnums[2:]

    def image(*picked):
        full = list(args)
        for i, v in zip(camera, picked):
            full[i] = v
        return jdiff.render_image_diff(*full, **static)

    jac = jax.jit(jax.jacfwd(image, argnums=tuple(range(len(camera)))))(
        *(jnp.asarray(args[i]) for i in camera))
    for k, (g, ref, j) in enumerate(zip(got[2:], want[2:], jac)):
        column = np.asarray(j).reshape(*w.shape, -1)  # [H*W, 4, components]
        terms = np.abs(column * w[..., None]).sum(axis=(0, 1)).reshape(np.shape(g))
        assert np.all(terms > 0.0)
        err = np.abs(g - ref)
        assert np.all(err <= GRAD_REL * terms), (name, k, err / terms)


def port_jacobian(args, static, argnum):
    """d image / d args[argnum] by the port's forward mode, one pass a
    component: ``[H*W, 4, *shape]``."""
    import torch.autograd.forward_ad as fwAD

    targs = list(port(args))
    base, columns = targs[argnum], []
    for c in range(base.numel()):
        tangent = torch.zeros(base.numel())
        tangent[c] = 1.0
        with fwAD.dual_level():
            full = list(targs)
            full[argnum] = fwAD.make_dual(base, tangent.reshape(base.shape))
            out = diff.render_image_diff(*full, **static)
            columns.append(fwAD.unpack_dual(out).tangent.numpy())
    return np.stack(columns, -1).reshape(*columns[0].shape, *base.shape)


def test_camera_jacobian_and_fov_gradient_match_jax():
    """Forward mode (``torch.autograd.forward_ad``, the counterpart of
    ``jax.jvp``): the per-pixel derivatives with respect to the eye and the
    field of view against ``jax.jacfwd``, at 1e-4 x max |J|.  Then the
    field-of-view gradient with each pixel weighted by the sign of its JAX
    derivative, so that no term cancels."""
    args, static = CASES["random"]

    def image(eye, fov):
        full = list(args)
        full[EYE], full[FOV] = eye, fov
        return jdiff.render_image_diff(*full, **static)

    jac_eye, jac_fov = (np.asarray(j) for j in jax.jit(jax.jacfwd(
        image, argnums=(0, 1)))(jnp.asarray(args[EYE]), jnp.float32(args[FOV])))
    for want, got in ((jac_eye, port_jacobian(args, static, EYE)),
                      (jac_fov, port_jacobian(args, static, FOV))):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()

    w = np.sign(jac_fov).astype(np.float32)
    (want,) = jax_grads(args, static, w, (FOV,))
    (got,) = port_grads(args, static, w, (FOV,))
    assert float(want) > 0.0
    assert abs(float(got) - float(want)) <= GRAD_REL * abs(float(want))


def test_basis_and_log_scaled_data_gradients_flow():
    """The ray set-up's rsqrt and the log transform go through bit views;
    their gradients must reach the basis and log-scaled data."""
    args, static = log_case()
    w = np.ones((WIDTH * HEIGHT, 4), np.float32)
    g_data, g_fwd, g_right, g_up = port_grads(args, static, w,
                                              (DATA, FWD, RIGHT, UP))
    assert np.count_nonzero(g_data) > g_data.size // 4
    for g in (g_fwd, g_right, g_up):
        assert np.all(np.isfinite(g)) and np.any(g != 0.0)


def test_scalar_transform_matches_jax_at_ties():
    """The diff path's scalar transform and soft clip against the JAX
    package's, values and gradients, on samples exactly at the positive
    floor (``jnp.maximum``'s half gradient), at the normalisation and
    clip bounds, below zero and non-finite."""
    from amrvolumerenderer_tpu.transforms import (apply_scalar_transform,
                                                   saturate_soft_tail)

    rng = np.random.default_rng(37)
    raw = rng.uniform(-1.0, 6.0, size=300).astype(np.float32)
    raw[:6] = [0.02, 0.02, 0.0, -3.0, np.inf, np.nan]
    raw[6:8] = [5.0, np.float32(np.exp(np.float32(np.log(0.02)) + 1.0))]
    params = dict(positive_floor=np.float32(0.02),
                  normalization_min=np.float32(np.log(0.02)),
                  inverse_normalization_span=np.float32(1.0 / np.log(250.0)))

    def jfun(v):
        s = apply_scalar_transform(v, log_scale=True, normalize=True,
                                   **{k: jnp.float32(p) for k, p in params.items()})
        return saturate_soft_tail(s, 0.7, 1.0)

    jv = np.asarray(jax.jit(jfun)(raw))
    jg = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jfun(v))))(raw))
    t = torch.from_numpy(raw).requires_grad_(True)
    tv = diff._soft_tail(diff._scalar_transform(
        t, True, True, *(torch.tensor(p) for p in params.values())), 0.7)
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=0, atol=FORWARD_ATOL)
    assert t.grad[0] == jg[0] and jg[0] != 0.0  # the floor's tie
    np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5, atol=1e-6)


def test_numerics_gradients_follow_jax_rules():
    """``numerics.rsqrt`` and ``log`` keep their values and take JAX's
    derivatives; ``diff._clip`` gives half the gradient at a bound, as
    ``jnp.clip`` (``torch.clamp`` gives all of it)."""
    rng = np.random.default_rng(35)
    x = rng.uniform(0.01, 50.0, size=500).astype(np.float32)
    for ours, theirs in ((numerics.rsqrt, jax.lax.rsqrt), (numerics.log, jnp.log)):
        t = torch.from_numpy(x).requires_grad_(True)
        value = ours(t)
        value.sum().backward()
        with torch.no_grad():
            assert torch.equal(value, ours(torch.from_numpy(x)))
        want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(theirs(v))))(x))
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=2e-7, atol=0)

    v = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0)))(v))
    t = torch.from_numpy(v).requires_grad_(True)
    diff._clip(t, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert want[1] == 0.5 and want[3] == 0.5


def test_inference_mode_call_then_gradient():
    """A first call under ``torch.inference_mode`` must leave nothing
    behind that a later call with autograd cannot save for backward."""
    rng = np.random.default_rng(5)
    args = np_args(rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32),
                   smooth_lut())
    diff._constant.cache_clear()
    with torch.inference_mode():
        first = port_image(args, STATIC)
    w = np.ones((WIDTH * HEIGHT, 4), np.float32)
    (g,) = port_grads(args, STATIC, w, (DATA,))
    assert np.all(np.isfinite(g)) and np.any(g != 0.0)
    np.testing.assert_array_equal(first.numpy(), port_image(args, STATIC).detach().numpy())


def test_args_from_arrays_keeps_dtypes_and_cuda_is_explicit():
    args = diff.args_from_arrays((np.zeros((1, 2, 2, 2), np.float32),
                                  np.ones((1, 3), np.int32), np.float32(2.5), 1.0,
                                  np.int64(3)), "cpu")
    assert [a.dtype for a in args] == [torch.float32, torch.int32, torch.float32,
                                       torch.float32, torch.int32]
    assert args[2].shape == () and float(args[2]) == 2.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            diff.prepare_scene(two_bricks(1), CameraParameters(**CAMERA), width=4,
                               height=4)
