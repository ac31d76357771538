"""``amrvolumerenderer_torch.ops.numerics.fma`` against jitted JAX on the
CPU: XLA contracts ``a * b + c`` into one fused multiply-add, rounded
once, as the port's kernels do with ``__fmaf_rn``.  The plain versions form
every FMA site with ``numerics.fma``, so it must round once too, bit for
bit, also where a float64 sum cast to float32 would round twice; and its
derivatives stay those of the float64 expression."""

import jax
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from amrvolumerenderer_torch.ops.numerics import fma

from test_torch_cuda import double_rounding_triples


def jax_fma(a, b, c):
    return np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))


@pytest.mark.parametrize("c_kind", ["tensor", "number"])
def test_fma_rounds_once_as_jax(c_kind):
    """On 2048 constructed triples whose float64 sum falls exactly halfway
    between two float32 values (the exact sum just beyond it) and on random
    ones, ``fma`` equals jitted JAX bit for bit; ``c`` a tensor, or one
    Python number for every triple (1.0: each constructed triple is then a
    tie that a float64 sum cast to float32 rounds the wrong way)."""
    a, b, c = double_rounding_triples(2048)
    if c_kind == "number":
        a, b, c = np.abs(a[:2048]), b[:2048], np.float32(1.0)
        twice = (a.astype(np.float64) * b + 1.0).astype(np.float32)
    else:
        twice = (a.astype(np.float64) * b + c).astype(np.float32)
    want = jax_fma(a, b, np.broadcast_to(c, a.shape).astype(np.float32))
    assert int((twice != want).sum()) > 500  # the ties the test needs
    c_arg = float(c) if c_kind == "number" else torch.from_numpy(c)
    got = fma(torch.from_numpy(a), torch.from_numpy(b), c_arg).numpy()
    np.testing.assert_array_equal(got, want)


def test_fma_keeps_special_values():
    """Infinities, NaN, signed zeros and the largest finite values: ``fma``
    gives what the exact sum rounded once gives (the float64 expression,
    which cannot tie there), including the sign of a zero and overflow to
    infinity."""
    big = np.float32(3.4e38)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1.0, -1.5, big, -big, 2.0 ** -60],
                       np.float32)
    a, b, c = (g.ravel() for g in np.meshgrid(special, special, special, indexing="ij"))
    with np.errstate(invalid="ignore", over="ignore"):
        want = (a.astype(np.float64) * b + c).astype(np.float32)
    got = fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_array_equal(got[finite], want[finite])
    np.testing.assert_array_equal(np.signbit(got[finite]), np.signbit(want[finite]))


def test_fma_derivatives_are_the_float64_expressions():
    """Reverse and forward mode through ``fma`` give the derivatives of
    ``(a * b + c)`` in float64 cast to float32 (the rounding carries none),
    on constructed ties and random triples, with the once-rounded value."""
    a, b, c = (torch.from_numpy(v) for v in double_rounding_triples(64))
    leaves = [t.clone().requires_grad_(True) for t in (a, b, c)]
    out = fma(*leaves)
    np.testing.assert_array_equal(out.detach().numpy(), jax_fma(a.numpy(), b.numpy(),
                                                                c.numpy()))
    weights = torch.linspace(-1.0, 1.0, len(a))
    got = torch.autograd.grad((out * weights).sum(), leaves)
    refs = [t.clone().requires_grad_(True) for t in (a, b, c)]
    ref = (refs[0].double() * refs[1].double() + refs[2].double()).float()
    want = torch.autograd.grad((ref * weights).sum(), refs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tangents = [torch.linspace(0.5, 2.0, len(a)) * s for s in (1.0, -1.0, 0.25)]
    with fwAD.dual_level():
        duals = [fwAD.make_dual(t, d) for t, d in zip((a, b, c), tangents)]
        primal, tangent = fwAD.unpack_dual(fma(*duals))
        ref_dual = [fwAD.make_dual(t, d) for t, d in zip((a, b, c), tangents)]
        want_t = fwAD.unpack_dual((ref_dual[0].double() * ref_dual[1].double()
                                   + ref_dual[2].double()).float()).tangent
    assert torch.equal(tangent, want_t)
    assert torch.equal(primal, out.detach())


LAYOUT_CASES = {
    "broadcast-rows": lambda: (torch.randn(5, 3), torch.randn(4, 5, 1), torch.randn(3)),
    "number": lambda: (torch.randn(4, 5, 4), 0.5, torch.randn(4, 5, 4)),
    "transposed": lambda: (torch.randn(6, 4).t(), torch.randn(4, 6), 1.0),
    "strided-view": lambda: (torch.randn(4, 5, 2, 2)[..., 0], torch.randn(4, 5, 1),
                             torch.randn(())),
    "scalars": lambda: (torch.tensor(2.0), 3.0, torch.tensor(1.0)),
}


@pytest.mark.parametrize("name", list(LAYOUT_CASES))
def test_fma_layout_walks_the_broadcast(name):
    """The walk ``fma``'s kernel makes over its operands (``fma_layout``:
    merged sizes, per-operand strides, numbers as values), replayed here
    element by element on the operands' storage, reads what broadcasting
    reads: ``a * b + c`` in float64 over the broadcast shape."""
    from amrvolumerenderer_torch.ops.numerics import fma_layout

    ops = LAYOUT_CASES[name]()
    tensors, values, shape, sizes, strides, flat = fma_layout(ops, torch.device("cpu"))
    got = np.empty(int(np.prod(shape, dtype=np.int64)))
    for i in range(got.size):
        x = []
        for t, v, st in zip(tensors, values, strides):
            if t is None:
                x.append(v)
                continue
            at, r = 0, i
            for d in range(len(sizes) - 1, -1, -1):
                at, r = at + (r % sizes[d]) * st[d], r // sizes[d]
            storage = torch.as_strided(t, (t.untyped_storage().nbytes() // 4
                                           - t.storage_offset(),), (1,))
            x.append(float(storage[i if flat else at]))
        got[i] = x[0] * x[1] + x[2]
    want = (torch.as_tensor(ops[0]).double() * torch.as_tensor(ops[1]).double()
            + torch.as_tensor(ops[2]).double())
    np.testing.assert_array_equal(got.reshape(shape), want.numpy())
    assert len(sizes) <= len(shape) or shape == ()


def test_fma_layout_refuses_what_the_kernel_cannot_take():
    """Tensors of another type or device, and numbers float32 cannot hold,
    raise instead of rounding them somewhere else."""
    from amrvolumerenderer_torch.ops.numerics import fma_layout

    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="float32 tensors"):
        fma_layout((torch.ones(3, dtype=torch.float64), 1.0, 1.0), cpu)
    with pytest.raises(ValueError, match="float32 holds"):
        fma_layout((torch.ones(3), 0.1, 1.0), cpu)


def test_fma_rounds_once_in_the_subnormal_range():
    """Where the float64 sum lands exactly halfway between two float32
    subnormals while the exact sum lies just beyond it (``a = 2^-100 (1 + u
    2^-12)``, ``b = 2^-50 (1 - u 2^-12 + u^2 2^-24)``, ``c = 2^-127``, u in
    1..4, so
    ``a * b + c = 2^-127 + 2^-150 + u^3 2^-186``), ``fma`` gives the float32
    nearest the exact sum, computed here with exact fractions.  (XLA:CPU
    flushes subnormals, so JAX is no reference here; ``__fmaf_rn`` rounds
    them as IEEE says.)"""
    from fractions import Fraction

    u = np.arange(1, 5, dtype=np.float64)  # u^3 2^-186 within half a float64 ulp
    a = (2.0 ** -100 * (1.0 + u * 2.0 ** -12)).astype(np.float32)
    b = (2.0 ** -50 * (1.0 - u * 2.0 ** -12 + u ** 2 * 2.0 ** -24)).astype(np.float32)
    c = np.full(len(u), 2.0 ** -127, np.float32)
    got = fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    step = Fraction(2) ** -149  # the float32 subnormals' spacing
    for x, y, z, g, t in zip(a, b, c, got, twice):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        want = round(exact / step) * step  # no tie: the exact sum is not one
        assert Fraction(float(g)) == want
        assert Fraction(float(t)) != want  # the twice-rounded cast misses it
