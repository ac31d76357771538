"""The differentiable fold's plain versions and its routing, on the CPU.

``ops.composite.fold_diff`` is one ``torch.autograd.Function`` whose
forward and backward are each one launch on the card
(``fold_diff_forward_kernel``, ``fold_diff_backward_kernel`` in
``csrc/composite.cu``); its wrappers take CUDA tensors only.  Their plain
versions, ``fold_diff_forward_reference`` and
``fold_diff_backward_reference``, are the arithmetic the kernels
implement, written out in PyTorch.  These tests run ``fold_diff`` with its
two launches replaced by the plain versions (``plain_kernels``) and hold
it to the eager loop (``diff._fold_layer_loop``: ``numerics.fma`` a layer,
differentiated by autograd), bit for bit, on the inputs of the card tests
(``fold_case``), and check which callers of ``diff.composite_layers_diff``
take the loop.  The helpers here serve tests/test_torch_cuda.py's card
tests and tests/test_torch_diff.py's comparison with JAX too."""

import contextlib
import unittest.mock as mock

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from amrvolumerenderer_torch import diff
from amrvolumerenderer_torch.ops import composite as comp
from amrvolumerenderer_torch.ops import numerics as nm


def fold_case(num_layers, pixels, order_kind, seed=0):
    """Inputs of the differentiable fold (CPU tensors): layers ``[B, P, 4]``
    in [0, 0.4); in a tenth of the pixels one layer opaque (alpha 1), so the
    image's alpha reaches exactly 1, the clip's tie; every twelfth pixel
    empty in every layer (the tie at 0); a few channels beyond the clip on
    either side (1.5, -0.25); the order ``[B]`` (``order_kind`` "identity"
    or "permuted"); the weights ``[P, 4]`` of the loss ``sum(image *
    weights)`` in [-1, 1], every fifth pixel's -0.0, so that the sweep
    forms -0.0 products."""
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0.0, 0.4, size=(num_layers, pixels, 4)).astype(np.float32)
    opaque = np.flatnonzero(rng.random(pixels) < 0.1)
    colors[rng.integers(0, num_layers, opaque.size), opaque, 3] = 1.0
    colors[:, ::12] = 0.0
    for value in (1.5, -0.25):
        at = (rng.integers(0, num_layers, 8), rng.integers(0, pixels, 8),
              rng.integers(0, 4, 8))
        colors[at] = value
    order = (np.arange(num_layers) if order_kind == "identity"
             else rng.permutation(num_layers))
    weights = rng.uniform(-1.0, 1.0, size=(pixels, 4)).astype(np.float32)
    weights[::5] = -0.0
    return torch.from_numpy(colors), torch.from_numpy(order), torch.from_numpy(weights)


def fold_run(fold, colors, order, weights, device):
    """``fold(layers, order)`` on ``device`` and the layers' gradient of
    ``sum(image * weights)``, both on the CPU."""
    layers = colors.to(device).requires_grad_(True)
    image = fold(layers, order.to(device))
    (image * weights.to(device)).sum().backward()
    return image.detach().cpu(), layers.grad.cpu()


def same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def fold_counters():
    """The fold kernels' launch counters and ``numerics.fma``'s."""
    return (comp.fold_diff_forward.launches, comp.fold_diff_backward.launches,
            nm.fma.launches)


@contextlib.contextmanager
def plain_kernels():
    """``comp.fold_diff`` with its two launches replaced by their plain
    versions, for its forward and its backward inside the block: the
    kernels' arithmetic under the Function's autograd, on any device."""
    with mock.patch.object(comp, "fold_diff_forward", comp.fold_diff_forward_reference), \
            mock.patch.object(comp, "fold_diff_backward", comp.fold_diff_backward_reference):
        yield


def plain_fold_run(colors, order, weights):
    """``fold_run`` of ``comp.fold_diff`` on the CPU through ``plain_kernels``."""
    with plain_kernels():
        return fold_run(comp.fold_diff, colors, order, weights, "cpu")


@pytest.mark.parametrize("order_kind", ["identity", "permuted"])
@pytest.mark.parametrize("num_layers", [1, 8, 13])
def test_fold_reference_matches_layer_loop(num_layers, order_kind):
    """``fold_diff`` through its plain versions (the plain forward and the
    plain back-to-front sweep) against the eager loop's autograd: the
    image and the layers' gradient bit for bit, with clip ties at 0 and 1,
    opaque layers, values beyond the clip and -0.0 cotangents."""
    colors, order, weights = fold_case(num_layers, 1000, order_kind)
    image, grad = plain_fold_run(colors, order, weights)
    want_image, want_grad = fold_run(diff._fold_layer_loop, colors, order, weights, "cpu")
    assert float(want_image[:, 3].max()) == 1.0
    assert float(want_image.min()) == 0.0
    assert same_bits(image, want_image)
    assert same_bits(grad, want_grad)
    if num_layers > 1:  # the -0.0 products that autograd's zeros turn into +0.0
        assert bool((grad == 0.0).any()) and not bool(torch.signbit(grad[grad == 0.0]).any())


def test_fold_reference_keeps_the_loop_transmittance():
    """With ``keep``, the forward's transmittance rows are the loop's ``1 -
    accum.a`` before each layer, and its unclipped image the loop's last
    accumulator."""
    colors, order, _ = fold_case(5, 64, "permuted")
    image, trans, pre = comp.fold_diff_forward_reference(colors, order, keep=True)
    accum = torch.zeros(64, 4)
    for k, layer in enumerate(order.tolist()):
        assert same_bits(trans[k], 1.0 - accum[:, 3])
        accum = diff.fma(colors[layer], 1.0 - accum[:, 3:4], accum)
    assert same_bits(pre, accum)
    assert same_bits(image, torch.clamp(accum, 0.0, 1.0))
    assert comp.fold_diff_forward_reference(colors, order)[1:] == (None, None)


@pytest.mark.parametrize("case", ["plain", "tangent", "short_order", "long_order"])
def test_cpu_callers_take_the_layer_loop(case):
    """On the CPU every caller of ``composite_layers_diff`` takes the eager
    loop, those that take it on the card too (a forward-mode tangent on the
    layers, an order of another length): ``fold_diff`` is never called and
    the fold kernels' counters do not move; the image is the loop's."""
    colors, order, _ = fold_case(8, 100, "permuted")
    if case == "short_order":
        order = order[:5]
    elif case == "long_order":
        order = torch.cat([order, order[:3]])
    before = fold_counters()
    with mock.patch.object(diff, "fold_diff", side_effect=AssertionError("kernel route")):
        if case == "tangent":
            with fwAD.dual_level():
                out = diff.composite_layers_diff(fwAD.make_dual(colors, torch.ones_like(colors)),
                                                 order)
                image, tangent = fwAD.unpack_dual(out)
            assert float(tangent.abs().max()) > 0.0
        else:
            layers = colors.clone().requires_grad_(True)
            image = diff.composite_layers_diff(layers, order)
            image.sum().backward()
            assert layers.grad is not None
    assert fold_counters() == before
    with torch.no_grad():
        assert same_bits(image.detach(), diff._fold_layer_loop(colors, order))


@pytest.mark.parametrize("mode", ["grad", "no_grad", "leaf_without_grad"])
def test_fold_diff_keeps_checkpoints_only_for_a_gradient(mode):
    """The forward keeps the transmittance and the unclipped image only
    when the layers' gradient will be formed: not under ``no_grad``, not
    for layers that need none."""
    colors, order, weights = fold_case(4, 50, "permuted")
    if mode != "leaf_without_grad":
        colors.requires_grad_(True)
    keeps = []

    def spy(c, o, keep=False):
        keeps.append(keep)
        return comp.fold_diff_forward_reference(c, o, keep)

    with mock.patch.object(comp, "fold_diff_forward", spy), \
            torch.set_grad_enabled(mode != "no_grad"):
        image = comp.fold_diff(colors, order)
    assert keeps == [mode == "grad"]
    assert (image.grad_fn is not None) == (mode == "grad")


def test_fold_diff_inside_a_dual_level():
    """Under forward mode with the tangent elsewhere (layers without one),
    ``fold_diff`` needs no forward-mode rule: it folds as outside, and its
    reverse-mode gradient is the loop's."""
    colors, order, weights = fold_case(6, 80, "permuted")
    want_image, want_grad = fold_run(diff._fold_layer_loop, colors, order, weights, "cpu")
    with fwAD.dual_level():
        fwAD.make_dual(torch.zeros(3), torch.ones(3))
        image, grad = plain_fold_run(colors, order, weights)
    assert same_bits(image, want_image)
    assert same_bits(grad, want_grad)


def test_fold_backward_reference_sums_in_the_kernel_order():
    """``g_t`` sums the four exact float64 products in the kernel's order,
    ``(p0 + p2) + (p1 + p3)`` (PyTorch's CUDA reduction over a row of four,
    which the eager loop's ``_Fma.backward`` reaches through
    ``sum_to_size``): products 1, 2^-60, -1, 0 sum to 2^-60 there, and to 0
    left to right (the CPU's order) or pairwise in order."""
    e = 2.0 ** -30
    layers = torch.tensor([[[0.0, 0.0, 0.0, 0.0]], [[1.0, e, 1.0, 1.0]]])
    g = torch.tensor([[1.0, e, -1.0, 0.0]])
    pre = torch.full((1, 4), 0.5)
    grad = comp.fold_diff_backward_reference(g, layers, torch.tensor([0, 1]),
                                             torch.ones(2, 1), pre)
    assert same_bits(grad[1], g)
    # layer 0 lies in front: its alpha gradient is g.a - g_t of layer 1
    assert same_bits(grad[0], torch.tensor([[1.0, e, -1.0, -(2.0 ** -60)]]))
    ((p0, p1, p2, p3),) = (g.double() * layers[1].double()).tolist()
    assert ((p0 + p1) + p2) + p3 == (p0 + p1) + (p2 + p3) == 0.0


@pytest.mark.parametrize("which", ["forward", "backward", "fold_diff"])
def test_fold_kernels_take_cuda_tensors_only(which):
    """The fold's wrappers launch kernels and have no CPU branch: on CPU
    tensors they raise before any launch (the CPU folds with the eager
    loop, and the plain versions serve the tests), and no counter moves."""
    colors, order, weights = fold_case(3, 40, "permuted")
    _, trans, pre = comp.fold_diff_forward_reference(colors, order, keep=True)
    call = {"forward": lambda: comp.fold_diff_forward(colors, order, keep=True),
            "backward": lambda: comp.fold_diff_backward(weights, colors, order, trans, pre),
            "fold_diff": lambda: comp.fold_diff(colors.requires_grad_(True), order)}[which]
    before = fold_counters()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert fold_counters() == before


@pytest.mark.parametrize("order_case", ["repeat", "out_of_range", "negative"])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_fold_references_reject_an_order_that_is_no_permutation(which, order_case):
    """An ``order`` of the layers' length that repeats an index, or holds
    one outside [0, B), raises in each plain version, as each kernel stops
    on it: the backward writes every layer's rows once, so a repeat would
    leave rows unwritten and overwrite a layer's gradient."""
    colors, order, weights = fold_case(4, 30, "permuted")
    _, trans, pre = comp.fold_diff_forward_reference(colors, order, keep=True)
    bad = order.clone()
    bad[2] = {"repeat": int(order[0]), "out_of_range": 4, "negative": -1}[order_case]
    with pytest.raises(ValueError, match="not a permutation"):
        if which == "forward":
            comp.fold_diff_forward_reference(colors, bad, keep=True)
        else:
            comp.fold_diff_backward_reference(weights, colors, bad, trans, pre)
