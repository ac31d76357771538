"""The differentiable path's march (amrvolumerenderer_torch/ops/diffmarch.py)
on the CPU: its hand-derived reverse and forward modes against autograd of
its own plain forward, and the autograd Function that carries them against
the JAX package's ``jax.grad`` and ``jax.jvp``.

Scenes (a few bricks of at most 8^3, at most 16x16 pixels): the random,
log-scaled and saturating cases of tests/test_torch_diff.py, a tie case
(voxels exactly at the positive floor, which normalises to exactly
range_min, and rays along an axis through cell centres at the faces, so
that every clip and the floor's maximum meet their half-gradient rule)
and parallel miss rays.

Tolerances.  ``march_backward_reference`` against autograd of
``march_forward_reference``, and ``march_tangent_reference`` (torch's
forward mode through it) on its own and from inside the Function's
``jvp`` against forward mode through it: max |diff| <= 1e-4 x max |g| per
input (``GRAD_REL``, ROADMAP section 3; measured worst 2.1e-5, the tie
case's step).  The backward is the same derivatives in another order of
float32 operations, and autograd
differentiates each lerp ``a (1 - w) + b w`` in ``w`` as ``-(g a) + g b``,
two rounded products that cancel where adjacent LUT entries or corners
are close, where the hand-derived ``g (b - a)`` keeps those digits.  The
Function against JAX: 1e-4 x max |g_JAX|, and for the image tangent 1e-4
x max |jvp_JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from amrvolumerenderer_tpu import diff as jdiff
from amrvolumerenderer_torch import diff
from amrvolumerenderer_torch.ops import diffmarch as dm
from amrvolumerenderer_torch.ops import numerics

from test_diff import STATIC, smooth_lut
from test_torch_diff import (CASES, GRAD_REL, assert_grads_close, jax_grads, np_args,
                             port, port_grads)
from test_torch_cuda import diff_scene, double_rounding_triples
from test_torch_worklist import one_torch_thread  # noqa: F401

REF_REL = GRAD_REL
FLOOR = 0.02


def captured(args, static):
    """The ``MarchInputs`` and ``MarchConfig`` that ``render_layers_diff``
    hands the march for the JAX argument tuple ``args`` on the CPU."""
    seen = []
    inner = dm.march

    def record(m, cfg):
        seen.append((m, cfg))
        return inner(m, cfg)

    dm.march = record
    try:
        with torch.no_grad():
            diff.render_layers_diff(*port(args), **static)
    finally:
        dm.march = inner
    (pair,) = seen
    return pair


def tie_case():
    """Rays along +z through cell centres: one pixel, six bricks of 4^3
    cells of 1/4 whose low corners put the ray on the centres of cells
    (i, j) for i in {0, 3}, j in {0, 1, 3}, so the ray's x and y weights sit
    on a face (h = 0 or h = top) or on a centre (w = 0); a step of half a
    cell from the first cell centre puts every other sample on a centre in
    z.  Log-scaled and normalised, the first layers of voxels at exactly
    the positive floor (and below zero, which takes the floor) normalise to
    exactly 0 = range_min."""
    rng = np.random.default_rng(43)
    ij = [(i, j) for i in (0, 3) for j in (0, 1, 3)]
    data = rng.uniform(0.05, 5.0, size=(len(ij), 4, 4, 4)).astype(np.float32)
    data[:, :, :, :2] = FLOOR
    data[:, 1, 1, 1] = -1.0
    f = torch.float32
    bmin = torch.tensor([[-(i + 0.5) * 0.25, -(j + 0.5) * 0.25, 0.0] for i, j in ij],
                        dtype=f)
    num = len(ij)
    m = dm.MarchInputs(
        data=torch.from_numpy(data),
        luts=torch.from_numpy(np.stack([smooth_lut(peak_alpha=0.5)] * num)),
        d0=torch.full((num, 1), 1.125), directions=torch.tensor([[0.0, 0.0, 1.0]]),
        eye=torch.tensor([0.0, 0.0, -1.0]), steps=torch.full((num,), 0.125),
        bmin=bmin, cell=torch.full((num, 3), 0.25),
        scalars=torch.tensor([0.0, 1.0, FLOOR, np.log(FLOOR),
                              1.0 / (np.log(5.0) - np.log(FLOOR))], dtype=f),
        tmax=torch.full((num, 1), 2.0), hit=torch.ones((num, 1), dtype=torch.bool),
        bmax=bmin + 1.0, top=torch.full((num, 3), 3, dtype=torch.int32),
        low=torch.full((num, 3), 2, dtype=torch.int32))
    return m, dm.MarchConfig(num_steps=10, log_scale=True, normalize=True,
                             apply_clip=True, clip_start=0.7)


def parallel_misses():
    """Parallel miss rays: a 1x5 image looking down -z (every ray's x
    component is exactly 0) on one brick in view and one beside it in x,
    whose slab test then gives tmin = +inf on every ray."""
    from amrvolumerenderer_torch.types import CameraParameters

    rng = np.random.default_rng(15)
    bricks = [(rng.uniform(0.2, 0.8, size=(4, 4, 4)).astype(np.float32), lo, hi)
              for lo, hi in (((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                             ((2.0, 0.0, 0.0), (3.0, 1.0, 1.0)))]
    camera = CameraParameters(eye=(0.5, 0.5, 3.0), look_at=(0.5, 0.5, 0.5),
                              up=(0.0, 1.0, 0.0), fov_y_degrees=30.0)
    args, static = diff.prepare_scene(bricks, camera, width=1, height=5, device="cpu")
    return captured(tuple(a.numpy() for a in args), static)


def contention():
    """The contention scene's march inputs from the ray set-up under
    ``RSQRT_SEED``, the card's, whose march the scene was made for.  (From
    another host estimate, an AMD EPYC's, the cell size's gradient, a sum
    of cancelling terms, differs from autograd's by 1.2e-4 of its scale.)"""
    with numerics.seed_rsqrt():
        return captured(*diff_scene("contention"))


SCENES = {
    "random": lambda: captured(*CASES["random"]),
    "log": lambda: captured(*CASES["log-normalize-clip"]),
    "saturating": lambda: captured(*CASES["saturating"]),
    "ties": tie_case,
    "parallel-misses": parallel_misses,
    "contention": lambda: contention(),
}


def autograd_grads(m, cfg, weights):
    """Autograd of ``sum(march_forward_reference * weights)`` with respect
    to the differentiable fields."""
    leaves = [t.clone().requires_grad_(True) for t in m[:dm.DIFFERENTIABLE]]
    out = dm.march_forward_reference(dm.MarchInputs(*leaves, *m[dm.DIFFERENTIABLE:]), cfg)
    grads = torch.autograd.grad((out * weights).sum(), leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]


def assert_rel(got, want, rel, tag):
    for name, g, w in zip(dm.MarchInputs._fields, got, want):
        err = float((g - w).abs().max())
        assert err <= rel * float(w.abs().max()), f"{tag} {name}: {err:.3g}"


@pytest.mark.parametrize("name", list(SCENES))
def test_backward_reference_matches_autograd(name):
    """The hand-derived reverse recurrence against autograd of the plain
    forward, for every differentiable input, at 1e-4 of each gradient's
    scale; the saturating case saturates mid-ray, the tie case meets every
    tie, and the miss rays get gradient 0."""
    m, cfg = SCENES[name]()
    weights = torch.from_numpy(np.random.default_rng(5).uniform(
        -1.0, 1.0, size=(*m.d0.shape, 4)).astype(np.float32))
    want = autograd_grads(m, cfg, weights)
    got = dm.march_backward_reference(m, cfg, weights)
    assert_rel(got, want, REF_REL, name)
    accum, before = dm.march_forward_reference(m, cfg, trace=True)
    gates = [dm._step(m, cfg, float(k)).gate for k in range(cfg.num_steps)]
    if name == "saturating":
        # opacity 1 reached mid-ray, and a later in-box step gated off by it
        assert any(bool((before[k] >= 1.0).logical_and(gates[k]).any())
                   for k in range(cfg.num_steps))
    if name == "ties":
        steps = [dm._step(m, cfg, float(k)) for k in range(cfg.num_steps)]
        live = [(st, gates[k] & (before[k] < 1.0)) for k, st in enumerate(steps)]
        h = torch.cat([st.h[a] for st, a in live])
        assert bool((h == 0.0).any()) and bool((h == 3.0).any())  # the faces
        assert any(bool((st.w[a] == 0.0).any()) for st, a in live)  # centres
        assert any(bool((st.value0[a] == FLOOR).any()) for st, a in live)
        assert any(bool((st.q[a] == 0.0).any()) for st, a in live)
        assert all(float(g.abs().max()) > 0.0 for g in want[:2])
    if name == "parallel-misses":
        assert bool(m.hit[0].any()) and not bool(m.hit[1].any())
        assert bool(torch.isinf(m.tmax[1]).all())  # parallel: tmin = +inf, tmax = -inf
        for g in got:
            assert bool(torch.isfinite(g).all())
        assert float(got[2][~m.hit].abs().max()) == 0.0  # no gradient on a miss


@pytest.mark.parametrize("name", list(SCENES))
def test_tangent_reference_matches_forward_mode(name):
    """The plain tangent, called on its own (it opens a dual level) and as
    the Function's ``jvp`` (inside the caller's level), against torch's
    forward mode through the plain forward, random tangents in every
    differentiable input, at 1e-4 of the tangent's scale."""
    m, cfg = SCENES[name]()
    rng = np.random.default_rng(9)
    tangents = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
                for t in m[:dm.DIFFERENTIABLE]]
    with fwAD.dual_level():
        duals = [fwAD.make_dual(t, d) for t, d in zip(m[:dm.DIFFERENTIABLE], tangents)]
        rest = m[dm.DIFFERENTIABLE:]
        want = fwAD.unpack_dual(dm.march_forward_reference(dm.MarchInputs(*duals, *rest),
                                                           cfg)).tangent
        through = fwAD.unpack_dual(dm.march(dm.MarchInputs(*duals, *rest), cfg)).tangent
    got = dm.march_tangent_reference(m, cfg, tangents)
    for g in (got, through):
        assert float((g - want).abs().max()) <= REF_REL * float(want.abs().max())
        assert bool(torch.isfinite(g).all())


# the tangent kernel's masks: which differentiable fields carry a tangent
# (the eye's forward mode gives the first distance and the eye one)
TANGENT_MASKS = {
    "eye": ("d0", "eye"),
    "data": ("data",),
    "lut": ("luts",),
    "scalars": ("scalars",),
    "all": dm.MarchInputs._fields[:dm.DIFFERENTIABLE],
}


@pytest.mark.parametrize("mask", list(TANGENT_MASKS))
@pytest.mark.parametrize("name", list(SCENES))
def test_tangent_reference_drops_absent_fields(name, mask):
    """The plain tangent with None for the fields that carry no tangent
    (their terms do not exist, as the kernel compiles them out) against
    the same with zero tangents there, within 1e-6 of the tangent's scale,
    both finite."""
    m, cfg = SCENES[name]()
    rng = np.random.default_rng(17)
    given = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
             if f in TANGENT_MASKS[mask] else None
             for f, t in zip(dm.MarchInputs._fields, m[:dm.DIFFERENTIABLE])]
    zeros = [torch.zeros_like(t) if g is None else g for g, t in zip(given, m)]
    got = dm.march_tangent_reference(m, cfg, given)
    want = dm.march_tangent_reference(m, cfg, zeros)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("which", ["eye", "data"])
def test_forward_mode_carries_only_the_given_fields(which):
    """Forward mode through ``render_image_diff`` hands the march's tangent
    only the fields that carry one at the dual level (None for the
    others): the eye's reaches the first distance and the eye, the data's
    the data alone."""
    args, static = CASES["random"]
    targs = list(port(args))
    argnum = {"eye": 6, "data": 0}[which]
    seen, inner = [], dm.diffmarch_tangent
    dm.diffmarch_tangent = lambda m, cfg, t: (seen.append(t), inner(m, cfg, t))[1]
    try:
        with torch.no_grad(), fwAD.dual_level():
            targs[argnum] = fwAD.make_dual(targs[argnum], torch.ones_like(targs[argnum]))
            out = fwAD.unpack_dual(diff.render_image_diff(*targs, **static)).tangent
    finally:
        dm.diffmarch_tangent = inner
    (tangents,) = seen
    carried = {f for f, t in zip(dm.MarchInputs._fields, tangents) if t is not None}
    assert carried == {"eye": {"d0", "eye"}, "data": {"data"}}[which]
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0.0


@pytest.mark.parametrize("name", list(SCENES))
def test_hit_pairs_match_numpy(name):
    """The pair list the kernels walk, on the CPU: each brick's count and
    hit pixels in pixel order are NumPy's, the rest of a row -1; with
    ``zero_rows`` the misses' rows are zeroed and the hits' rows kept."""
    m, _ = SCENES[name]()
    hit = m.hit.numpy()
    pixels, counts = dm.diffmarch_pairs(m.hit)
    np.testing.assert_array_equal(counts.numpy(), np.count_nonzero(hit, axis=1))
    for b in range(hit.shape[0]):
        listed = np.flatnonzero(hit[b])
        np.testing.assert_array_equal(pixels[b, :len(listed)].numpy(), listed)
        assert np.all(pixels[b, len(listed):].numpy() == -1)
    rows = torch.full((*m.hit.shape, 4), 7.0)
    dm.diffmarch_pairs(m.hit, rows)
    assert np.all(rows.numpy()[~hit] == 0.0) and np.all(rows.numpy()[hit] == 7.0)
    if name == "contention":  # every sample: the same eight cells, one LUT bin
        steps = [dm._step(m, cfg, float(k)) for k, cfg in
                 ((k, SCENES[name]()[1]) for k in range(4))]
        live = [st for st in steps if bool(st.gate.any())]
        assert live and len({int(v) for st in live for v in st.j0[st.gate]}) == 1
        assert len({tuple(o) for st in live
                    for o in st.offset.flatten(-3)[st.gate].tolist()}) == 1


def test_function_runs_the_plain_versions_on_the_cpu():
    """``render_layers_diff`` goes through the Function: one autograd node
    for the march, its forward the plain forward's bits, its backward the
    plain backward's gradients (``remat`` on or off)."""
    args, static = CASES["random"]
    m, cfg = captured(args, static)
    targs = list(port(args))
    targs[0].requires_grad_(True)
    colors, _ = diff.render_layers_diff(*targs, **static)
    node, names = colors.grad_fn, []
    while node is not None and len(names) < 10:
        names.append(type(node).__name__)
        node = node.next_functions[0][0] if node.next_functions else None
    assert any("_March" in n for n in names), names
    raw = dm.march_forward_reference(m, cfg)
    assert torch.equal(colors.detach(), torch.where(m.hit[..., None],
                                                    diff._clip(raw, 0.0, 1.0), 0.0))
    w = np.random.default_rng(2).uniform(0, 1, size=(static["width"] * static["height"],
                                                     4)).astype(np.float32)
    (g_on,) = port_grads(args, static, w, (0,), remat=True)
    (g_off,) = port_grads(args, static, w, (0,), remat=False)
    np.testing.assert_array_equal(g_on, g_off)


def test_wrappers_take_no_other_device():
    m, cfg = SCENES["random"]()
    meta = dm.MarchInputs(*(t.to("meta") for t in m))
    for call in (lambda: dm.diffmarch_forward(meta, cfg),
                 lambda: dm.diffmarch_tangent(meta, cfg, meta[:dm.DIFFERENTIABLE]),
                 lambda: dm.diffmarch_backward(meta, cfg, meta.d0, None)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    assert dm.checkpoint_count(cfg) == -(-cfg.num_steps // dm.CHECKPOINT_EVERY)


def jax_tie_case():
    """The tie case through the JAX argument tuple: test_diff.py's camera
    at 12x12 on a log-scaled, normalised 6^3 brick whose back layers sit
    at exactly the positive floor (they normalise to exactly range_min,
    and the floor's maximum ties) and whose cells include values below
    zero (they take the floor)."""
    rng = np.random.default_rng(47)
    data = rng.uniform(0.05, 5.0, size=(6, 6, 6)).astype(np.float32)
    data[:, :, :3] = FLOOR
    data[2:4, 2:4, 4] = -1.0
    args = list(np_args(data, smooth_lut(peak_alpha=0.4)))
    args[13:16] = [np.float32(FLOOR), np.float32(np.log(FLOOR)),
                   np.float32(1.0 / (np.log(5.0) - np.log(FLOOR)))]
    return tuple(args), dict(STATIC, log_scale=True, normalize=True)


JAX_CASES = {"saturating": lambda: CASES["saturating"], "ties": jax_tie_case,
             "random": lambda: CASES["random"], "log": lambda: CASES["log-normalize-clip"]}


@pytest.mark.parametrize("name", ["saturating", "ties"])
def test_function_gradients_match_jax_at_saturation_and_ties(name):
    """Data and LUT gradients of a randomly weighted image loss against
    ``jax.jit(jax.grad)`` at 1e-4 x max |g_JAX|."""
    args, static = JAX_CASES[name]()
    w = np.random.default_rng(7).uniform(
        0, 1, size=(static["width"] * static["height"], 4)).astype(np.float32)
    got = port_grads(args, static, w, (0, 4))
    want = jax_grads(args, static, w, (0, 4))
    assert_grads_close(got, want, name)
    if name == "ties":
        m, cfg = captured(args, static)
        steps = [dm._step(m, cfg, float(k)) for k in range(cfg.num_steps)]
        assert any(bool((st.q[st.gate] == 0.0).any()) for st in steps)
        assert any(bool((st.value0[st.gate] == FLOOR).any()) for st in steps)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_corner_table_step_and_scalar_gradients_match_jax(name):
    """The gradients that reach the march through the ray set-up and its
    per-brick tables: the corner tables (trilinear origin, cell size, slab
    entry), the step and the five transform scalars, against
    ``jax.jit(jax.grad)``.  Each is one sum over the frame whose terms may
    cancel, so each component is held at 1e-4 x the sum of its terms'
    magnitudes (from ``jax.jacfwd``), as the camera gradients are."""
    args, static = JAX_CASES[name]()
    w = np.random.default_rng(8).uniform(
        0, 1, size=(static["width"] * static["height"], 4)).astype(np.float32)
    argnums = (1, 2, 5, 11, 12, 13, 14, 15)
    got = port_grads(args, static, w, argnums)
    want = jax_grads(args, static, w, argnums)

    def image(*picked):
        full = list(args)
        for i, v in zip(argnums, picked):
            full[i] = v
        return jdiff.render_image_diff(*full, **static)

    jac = jax.jit(jax.jacfwd(image, argnums=tuple(range(len(argnums)))))(
        *(jnp.asarray(args[i]) for i in argnums))
    for i, g, ref, j in zip(argnums, got, want, jac):
        column = np.asarray(j).reshape(*w.shape, -1)
        terms = np.abs(column * w[..., None]).sum(axis=(0, 1)).reshape(np.shape(g))
        err = np.abs(g - ref)
        assert np.all(err <= GRAD_REL * np.maximum(terms, 1e-30)), (name, i, err, terms)
    assert any(np.any(g != 0.0) for g in got)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_tangent_matches_jax_jvp(name):
    """Forward mode through the Function (``torch.autograd.forward_ad``)
    against ``jax.jvp`` of the jitted image, random tangents in the data,
    the corner tables, the LUT, the step, the camera and the five scalars
    at once, at 1e-4 x max |jvp_JAX|."""
    args, static = JAX_CASES[name]()
    argnums = (0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    rng = np.random.default_rng(21)
    tangents = [np.asarray(rng.standard_normal(np.shape(args[i])) * 1e-2, np.float32)
                for i in argnums]

    def image(*picked):
        full = list(args)
        for i, v in zip(argnums, picked):
            full[i] = v
        return jdiff.render_image_diff(*full, **static)

    _, want = jax.jit(lambda p, t: jax.jvp(image, p, t))(
        tuple(jnp.asarray(args[i]) for i in argnums),
        tuple(jnp.asarray(t) for t in tangents))
    want = np.asarray(want)
    targs = list(port(args))
    with fwAD.dual_level():
        for i, t in zip(argnums, tangents):
            targs[i] = fwAD.make_dual(targs[i], torch.from_numpy(t).reshape(targs[i].shape))
        got = fwAD.unpack_dual(diff.render_image_diff(*targs, **static)).tangent.numpy()
    assert np.abs(want).max() > 0.0
    assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()


def test_position_fma_rounds_once_as_jax():
    """The march's position ``eye + direction * distance`` is one FMA in
    the jitted JAX program and in the kernel (``__fmaf_rn``): one rounding.
    ``numerics.fma``, which ``_step`` forms it with, equals jitted JAX bit
    for bit on triples where a float64 sum cast to float32 rounds twice,
    and on random ones; and on the constructed case ``1 + 2^-12``, ``2^-24
    (1 - 4095 2^-24)``, ``1`` the step's position is JAX's ``1 + 2^-23``,
    not the twice-rounded 1."""
    from amrvolumerenderer_torch.ops.numerics import fma

    a, b, c = double_rounding_triples(2048)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    assert 500 < int((twice != want).sum()) < 2048 - 500  # the ties the test needs
    got = fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)

    m, cfg = SCENES["random"]()
    num_bricks = m.d0.shape[0]
    direction = np.float32(1 + 2 ** -12)
    distance = np.float32(2 ** -24 * (1 - 4095 * 2 ** -24))
    m = m._replace(directions=torch.tensor([[direction, 0.5, 0.25]]),
                   d0=torch.full((num_bricks, 1), float(distance)),
                   eye=torch.tensor([1.0, 0.0, 0.0]), tmax=m.tmax[:, :1], hit=m.hit[:, :1])
    pos = dm._step(m, cfg, 0.0).pos
    want = np.asarray(jax.jit(lambda e, d, t: e[None, :] + d * t[:, None])(
        m.eye.numpy(), m.directions.numpy(), m.d0[0].numpy()))
    assert float(want[0, 0]) == 1 + 2 ** -23
    for row in pos:
        np.testing.assert_array_equal(row.numpy(), want)
