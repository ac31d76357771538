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
    # the diff call's three walks (ops/diff.py): the depth's entry, the
    # fold step, the depth's dot product; then the ray grid's row step
    "depth-entry": lambda: (torch.randn(64, 3), torch.randn(13, 64, 1), torch.randn(3)),
    "fold-step": lambda: (torch.randn(64, 4), 1.0 - torch.randn(64, 4)[:, 3:4],
                          torch.randn(64, 4)),
    "depth-dot": lambda: (torch.randn(13, 64, 3)[..., 2], torch.tensor(0.25),
                          torch.randn(13, 64)),
    "ray-rows": lambda: (torch.randn(8, 1, 1), torch.randn(3), torch.randn(1, 16, 3)),
    # rows of 3 with an odd count (a scalar tail), an odd length, operands one
    # float off 16-byte alignment
    "rows-of-3": lambda: (torch.randn(7, 3), torch.randn(3), torch.randn(7, 1)),
    "odd-length": lambda: (torch.randn(11), torch.randn(11), -1.0),
    "unaligned": lambda: (torch.randn(65)[1:], torch.randn(64), torch.randn(66)[2:]),
}
# how each walk reads its operands (None: a number), where the case fixes it
LAYOUT_MODES = {
    "depth-entry": ("VECTOR", "GENERAL", "GENERAL"),
    "fold-step": ("VECTOR", "CONSTANT", "VECTOR"),
    "depth-dot": ("GENERAL", "CONSTANT", "VECTOR"),
    "ray-rows": ("CONSTANT", "GENERAL", "VECTOR"),
    "odd-length": ("VECTOR", "VECTOR", None),
    "unaligned": ("GENERAL", "VECTOR", "GENERAL"),
}


def replay_walk(tensors, values, walk):
    """``fma``'s kernel (csrc/numerics.cu) replayed on the operands'
    storage: a thread a run of FMA_RUN outputs of a row in each row of its
    chunk, each operand read by its mode at offsets divided out with the
    fast divisors.  Returns the float64 sums in the output's shape and the
    threads' count of full runs and of scalar tails; asserts that every 16-byte read is
    aligned and reads the run's own elements, and every constant read
    stands for the whole run."""
    from amrvolumerenderer_torch.ops import numerics as nm

    storage = [None if t is None else torch.as_strided(
        t, (t.untyped_storage().nbytes() // 4 - t.storage_offset(),), (1,)).numpy()
        for t in tensors]
    sizes, inner = walk.sizes, walk.inner

    def offsets(e):
        at = [0] * len(tensors)
        for d in range(len(sizes) - 1, 0, -1):
            q = nm.fma_divide(e, *walk.divisors[d])
            for k, st in enumerate(walk.strides):
                if st is not None:
                    at[k] += (e - q * sizes[d]) * st[d]
            e = q
        return [a + (0 if st is None else e * st[0]) for a, st in zip(at, walk.strides)]

    out = np.full(walk.loop * inner, np.nan)
    full_runs = tails = 0
    for y in range(-(-walk.loop // walk.chunk)):
        for i0 in range(0, inner, nm.FMA_RUN):
            n = min(nm.FMA_RUN, inner - i0)
            full_runs, tails = full_runs + (n == nm.FMA_RUN), tails + (n < nm.FMA_RUN)
            each = [offsets(i0 + j) for j in range(n)]
            for row in range(y * walk.chunk, min((y + 1) * walk.chunk, walk.loop)):
                x = []
                for k, (t, v, mode) in enumerate(zip(tensors, values, walk.modes)):
                    if t is None:
                        x.append(np.full(n, v))
                        continue
                    at = [e[k] + row * walk.loop_strides[k] for e in each]
                    if mode == nm.CONSTANT:
                        assert len(set(at)) == 1
                        at = at[:1] * n
                    elif mode == nm.VECTOR and n == nm.FMA_RUN:
                        assert (t.data_ptr() + 4 * at[0]) % 16 == 0
                        assert at == list(range(at[0], at[0] + nm.FMA_RUN))
                    x.append(storage[k][at].astype(np.float64))
                out[row * inner + i0:row * inner + i0 + n] = x[0] * x[1] + x[2]
    return out.reshape(walk.shape), full_runs, tails


@pytest.mark.parametrize("name", list(LAYOUT_CASES))
def test_fma_layout_walks_the_broadcast(name):
    """The walk ``fma``'s kernel makes over its operands (``fma_layout``:
    merged sizes, a looped outermost dimension where an operand repeats
    along it, per-operand strides and read modes, numbers as values),
    replayed here run by run on the operands' storage (``replay_walk``),
    reads what broadcasting reads: ``a * b + c`` in float64 over the
    broadcast shape, every output once; runs of FMA_RUN and one scalar tail
    where a row's length is not a multiple of it."""
    from amrvolumerenderer_torch.ops import numerics as nm

    ops = LAYOUT_CASES[name]()
    tensors, values, walk = nm.fma_layout(ops, torch.device("cpu"))
    got, full_runs, tails = replay_walk(tensors, values, walk)
    want = (torch.as_tensor(ops[0]).double() * torch.as_tensor(ops[1]).double()
            + torch.as_tensor(ops[2]).double())
    np.testing.assert_array_equal(got, want.numpy())
    assert len(walk.sizes) <= max(len(walk.shape), 1)
    threads = -(-walk.loop // walk.chunk)  # threads a run: one a chunk of rows
    assert full_runs == threads * (walk.inner // nm.FMA_RUN)
    assert tails == threads * (walk.inner % nm.FMA_RUN > 0)
    if name in LAYOUT_MODES:
        assert tuple(None if m is None else ("GENERAL", "VECTOR", "CONSTANT")[m]
                     for m in walk.modes) == LAYOUT_MODES[name]
    if name in ("depth-entry", "ray-rows"):  # the directions repeat over the bricks
        assert walk.loop == walk.shape[0] and walk.inner % nm.FMA_RUN == 0


# sizes the diff call (1024^2 and 512^2, 13 bricks) and the raymarch set-up
# divide by; then 2^31 - 1 and seeded sizes below it
DIVISOR_SIZES = [1, 2, 3, 4, 8, 13, 512, 1024, 3 * 1024, 262144, 3 * 262144, 1048576,
                 3 * 1048576, 13 * 1048576, 2 ** 31 - 1]


def test_fma_divisors_divide_as_integer_division():
    """The kernel's fast divisors (``fma_divisor``, ``fma_divide``: a
    multiply-high, an add and a shift) give ``n // d`` and ``n % d`` for
    every size the diff call and the raymarch set-up walk, and seeded sizes
    up to 2^31 - 1, on seeded dividends below 2^31 and the edges."""
    from amrvolumerenderer_torch.ops.numerics import fma_divide, fma_divisor

    rng = np.random.default_rng(31)
    sizes = DIVISOR_SIZES + [int(v) for v in rng.integers(1, 2 ** 31, 200)]
    for d in sizes:
        magic, shift = fma_divisor(d)
        assert 0 < magic < 2 ** 32 and 0 <= shift <= 31
        edges = [0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, 2 ** 31 - 1, 2 ** 31 - 1 - d]
        for n in edges + [int(v) for v in rng.integers(0, 2 ** 31, 200)]:
            if 0 <= n < 2 ** 31:
                q = fma_divide(n, magic, shift)
                assert (q, n - q * d) == divmod(n, d), (n, d)


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
