"""The differentiable path over hit pairs (``diff.render_image_pairs``: the
pair list, the march over its rows, the pair fold), in its plain versions
on the CPU.

The scene is the benchmark's turbulence field at 32^3 in 64 bricks of 8^3
(``portbench/scenes.py``), seen at 32 x 32 from four seeded views of the
fitting orbit.  The pair path is held to the benchmark's plain reference
(``portbench/reference/raymarch.py``, which shares no code with the port)
and to the port's dense path bit for bit; the card's kernels are held to
these plain versions in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from amrvolumerenderer_torch import diff
from amrvolumerenderer_torch.ops import composite as comp
from amrvolumerenderer_torch.ops import diffmarch as dm
from amrvolumerenderer_torch.types import CameraParameters
from amrvolumerenderer_torch.utils import timers
from portbench import scenes
from portbench.reference import raymarch as ref

SIZE = 32  # pixels a side
VIEWS = scenes.fit_views({"views": 4, "radius": 2.5, "fov_y_degrees": 45.0}, 11)

# The plain reference folds through log1p / cumsum / exp and rounds its
# positions and weights in another order, so a float32 pair path meets it
# within 3.6e-6 on an image channel and 3.8e-4 of the largest volume
# gradient on these views; the same reference computed in bfloat16 misses
# it by 0.33 and 0.75 (test_the_limits_catch_a_bfloat16_march).
IMAGE_ATOL = 1e-4
GRAD_REL = 1e-2


def turbulence(domain=32, brick=8):
    return scenes.turbulence_scene({"domain": domain, "brick": brick}, 11, "cpu").boxes


BOXES = turbulence()


def program_args(boxes, cam, size=SIZE):
    host = [(b.data.numpy(), b.min_corner, b.max_corner) for b in boxes]
    c = CameraParameters(eye=cam.eye, look_at=cam.look_at, up=cam.up,
                         fov_y_degrees=cam.fov_y_degrees)
    return diff.prepare_scene(host, c, width=size, height=size, device="cpu")


def weights(size=SIZE, seed=5):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(0, 1, (size * size, 4)).astype(np.float32))


def run(fn, args, static, argnums=(0,), **kwargs):
    """The image and the gradients of a weighted sum of it."""
    targs = list(args)
    for i in argnums:
        targs[i] = targs[i].clone().requires_grad_(True)
    image = fn(*targs, **static, **kwargs)
    (image * weights(int(np.sqrt(image.shape[0])))).sum().backward()
    return image.detach(), [targs[i].grad for i in argnums]


def same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def reference_run(cam, dtype):
    bricks = ref.Bricks(BOXES, "cpu", dtype, 256)
    data = bricks.tensor([b.data for b in BOXES]).requires_grad_(True)
    image = ref.render_view(bricks, data, cam, SIZE, SIZE)
    (image.float() * weights()).sum().backward()
    return image.detach().float(), data.grad.float()


@pytest.mark.parametrize("view", range(len(VIEWS)))
def test_pair_path_meets_the_plain_reference(view):
    """The image and the volume's gradient of the pair path against the
    benchmark's plain reference of the same semantics."""
    cam = VIEWS[view]
    args, static = program_args(BOXES, cam)
    image, (grad,) = run(diff.render_image_pairs, args, static)
    want_image, want_grad = reference_run(cam, torch.float32)
    assert float(image[:, 3].max()) > 0.1
    assert float((image - want_image).abs().max()) <= IMAGE_ATOL
    assert float((grad - want_grad).abs().max()) <= GRAD_REL * float(want_grad.abs().max())


@pytest.mark.parametrize("view", [0, 3])
def test_the_limits_catch_a_bfloat16_march(view):
    """The reference marched in bfloat16 misses both limits above: they
    tell a float32 march from the next precision down."""
    cam = VIEWS[view]
    want_image, want_grad = reference_run(cam, torch.float32)
    low_image, low_grad = reference_run(cam, torch.bfloat16)
    assert float((low_image - want_image).abs().max()) > IMAGE_ATOL
    assert float((low_grad - want_grad).abs().max()) > GRAD_REL * float(want_grad.abs().max())


@pytest.mark.parametrize("view", range(len(VIEWS)))
def test_pair_path_is_the_dense_path_bit_for_bit(view):
    """A miss layer of the dense path is exactly 0 and changes no sum: the
    pair path's image and its volume and LUT gradients equal the dense
    path's (``render_layers_diff`` and the eager fold) bit for bit."""
    args, static = program_args(BOXES, VIEWS[view])
    got_image, got = run(diff.render_image_pairs, args, static, argnums=(0, 4))
    want_image, want = run(diff.render_image_diff, args, static, argnums=(0, 4))
    assert same_bits(got_image, want_image)
    for g, w in zip(got, want):
        assert same_bits(g, w)


CAMERA_ARGS = (6, 7, 8, 9)  # eye, forward, right, up


def test_camera_gradients_through_the_pair_list():
    """With the eye and the basis carrying a gradient, the pairs' first
    distances are formed again under autograd (``diff._pair_d0``): the
    camera's gradient meets the dense path's at 1e-4 of its scale (the
    sums over pairs and over pixels add in other orders), and the image
    stays bit for bit."""
    args, static = program_args(BOXES, VIEWS[1])
    got_image, got = run(diff.render_image_pairs, args, static, argnums=CAMERA_ARGS)
    want_image, want = run(diff.render_image_diff, args, static, argnums=CAMERA_ARGS)
    assert same_bits(got_image, want_image)
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0.0
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def edge_case(name):
    """A scene, a view and the fewest pairs a pixel must have somewhere."""
    if name == "empty":  # no ray's line meets a box (the slab test holds the whole line)
        cam = scenes.Camera((0.5, 3.0, 0.5), (1.5, 3.0, 0.5), (0.0, 1.0, 0.0), 10.0, 0.1, 100.0)
        return BOXES, cam, 0
    if name == "one_brick":
        return turbulence(8, 8), VIEWS[0], 1
    # along the grid's diagonal, a ray crosses up to 10 of the 4 x 4 x 4 bricks
    cam = scenes.Camera((2.3, 2.1, 2.2), (0.5, 0.5, 0.5), (0.0, 1.0, 0.0), 30.0, 0.1, 100.0)
    return BOXES, cam, 8


@pytest.mark.parametrize("name", ["empty", "one_brick", "many_bricks_a_pixel"])
def test_pair_path_edge_cases(name):
    """No pair at all, a single brick, and pixels crossed by many bricks:
    the pair path is the dense path bit for bit, and the list holds what
    it should."""
    boxes, cam, most = edge_case(name)
    args, static = program_args(boxes, cam)
    got_image, (got,) = run(diff.render_image_pairs, args, static)
    want_image, (want,) = run(diff.render_image_diff, args, static)
    assert same_bits(got_image, want_image) and same_bits(got, want)
    pairs = build(args, static)
    assert int(pairs.pixel_count.max()) >= most
    if name == "empty":
        assert int(pairs.total) == 0 and float(got_image.abs().max()) == 0.0
        assert float(got.abs().max()) == 0.0
    else:
        assert int(pairs.total) > 0 and float(got_image[:, 3].max()) > 0.0


def build(args, static, order=None):
    """The pair list ``render_image_pairs`` builds for ``args``."""
    seen = []
    inner = dm.diffpairs_build
    dm.diffpairs_build = lambda *a: seen.append(inner(*a)) or seen[-1]
    try:
        with torch.no_grad():
            diff.render_image_pairs(*args, **static, order=order)
    finally:
        dm.diffpairs_build = inner
    (pairs,) = seen
    return pairs


@pytest.mark.parametrize("order_kind", ["default", "reversed"])
def test_pair_list_holds_every_hit_once(order_kind):
    """Every (brick, pixel) pair whose ray meets the brick is in the list
    once, with the dense path's first distance and exit distance bit for
    bit; each brick's runs cover its pairs, each run in one tile, in pixel
    order; each pixel's pairs follow the fold's order."""
    args, static = program_args(BOXES, VIEWS[2])
    dense = dm.MarchInputs
    captured = []
    inner = dm.march
    dm.march = lambda m, cfg: captured.append(m) or inner(m, cfg)
    try:
        with torch.no_grad():
            diff.render_layers_diff(*args, **static)
    finally:
        dm.march = inner
    (m,) = captured
    assert isinstance(m, dense)
    num_bricks = len(BOXES)
    order = None if order_kind == "default" else torch.arange(num_bricks - 1, -1, -1)
    pairs = build(args, static, order)
    if order is None:
        order = diff.default_order(args[1], args[2], args[6], args[7])
    total = int(pairs.total)
    brick, pixel = pairs.brick.long(), pairs.pixel.long()
    assert total == int(m.hit.sum()) == pairs.brick.shape[0]
    assert bool(m.hit[brick, pixel].all())
    assert len(set((brick * SIZE * SIZE + pixel).tolist())) == total
    assert same_bits(pairs.d0, m.d0[brick, pixel])
    assert same_bits(pairs.tmax, m.tmax[brick, pixel])
    assert torch.equal(pairs.brick_count.long(), torch.bincount(brick, minlength=num_bricks))
    tile = dm.tile_pixels(SIZE * SIZE)
    for b in range(num_bricks):
        for t in range(pairs.run_cnt.shape[1]):
            n = int(pairs.run_cnt[b, t])
            q = torch.arange(int(pairs.run_off[b, t]), int(pairs.run_off[b, t]) + n)
            assert bool((brick[q] == b).all()) and bool((pixel[q] // tile == t).all())
            assert bool((pixel[q][1:] > pixel[q][:-1]).all())
    rank = torch.empty(num_bricks, dtype=torch.long)
    rank[order] = torch.arange(num_bricks)
    for p in range(SIZE * SIZE):
        n, s = int(pairs.pixel_count[p]), int(pairs.pixel_start[p])
        q = pairs.fold_index[s:s + n].long()
        assert n == int(m.hit[:, p].sum()) and bool((pixel[q] == p).all())
        assert bool((rank[brick[q]][1:] > rank[brick[q]][:-1]).all())


def fold_rows(num_layers=8, pixels=300, seed=0):
    """Raw march rows for a dense fold and the same rows as a pair list:
    values around [0, 1] with exact 0s, 1s and values beyond the clip, a
    third of the (layer, pixel) pairs missing."""
    g = np.random.default_rng(seed)
    raw = g.uniform(-0.2, 1.2, (num_layers, pixels, 4)).astype(np.float32)
    raw[g.uniform(size=raw.shape) < 0.1] = 1.0
    raw[g.uniform(size=raw.shape) < 0.1] = 0.0
    hit = g.uniform(size=(num_layers, pixels)) > 0.33
    hit[:, :5] = False  # pixels of no pair
    order = torch.from_numpy(g.permutation(num_layers))
    raw, hit = torch.from_numpy(raw), torch.from_numpy(hit)
    ranks, pix = hit[order].nonzero(as_tuple=True)
    q = torch.argsort(pix * num_layers + ranks)  # pixel-major, fold order
    brick = order[ranks]
    counts = hit.sum(0)
    rows = raw[brick, pix]
    return raw, hit, order, rows, (q.to(torch.int32), (torch.cumsum(counts, 0) - counts).to(
        torch.int32), counts.to(torch.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_fold_is_the_dense_fold_bit_for_bit(seed):
    """The pair fold's plain versions against ``diff.composite_layers_diff``
    on the clipped, masked dense layers (``render_layers_diff``'s clip and
    ``where``): the image, and the gradient of each pair's raw row through
    the clip, bit for bit, clip ties and values beyond it included."""
    raw, hit, order, rows, (fold_index, start, count) = fold_rows(seed=seed)
    w = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (raw.shape[1], 4))
                         .astype(np.float32))
    dense = raw.clone().requires_grad_(True)
    layers = torch.where(hit[..., None], dm._clip(dense, 0.0, 1.0), 0.0)
    want = diff.composite_layers_diff(layers, order)
    (want * w).sum().backward()
    leaf = rows.clone().requires_grad_(True)
    pairs = dm.Pairs(*(None,) * 4, fold_index, start, count, *(None,) * 4)
    got = comp.fold_pairs(leaf, pairs)
    (got * w).sum().backward()
    assert same_bits(got.detach(), want.detach())
    ranks, pix = hit[order].nonzero(as_tuple=True)
    assert same_bits(leaf.grad, dense.grad[order[ranks], pix])


def test_pair_fold_marks_an_overflowed_pixel():
    """A pixel whose tile did not fit in the list (count -1) comes out NaN
    and takes no gradient row."""
    raw, hit, order, rows, (fold_index, start, count) = fold_rows(seed=2)
    count = count.clone()
    count[7] = -1
    image, trans, pre = comp.diffpairs_fold_forward_reference(rows, fold_index, start, count,
                                                             keep=True)
    assert bool(torch.isnan(image[7]).all()) and bool(torch.isnan(pre[7]).all())
    assert not bool(torch.isnan(image[8:]).any())
    grad = comp.diffpairs_fold_backward_reference(torch.ones_like(image), rows, fold_index,
                                                  start, count, trans, pre)
    assert not bool(torch.isnan(grad).any())


def test_cpu_render_image_diff_keeps_the_dense_layers(monkeypatch):
    """On the CPU ``render_image_diff`` folds the dense layers (the pair
    path serves CUDA tensors), and the pair list's plain build raises on
    an order that is no permutation."""
    args, static = program_args(BOXES, VIEWS[0])

    def refuse(*a, **k):
        raise AssertionError("the CPU took the pair path")

    monkeypatch.setattr(diff, "render_image_pairs", refuse)
    with torch.no_grad():
        image = diff.render_image_diff(*args, **static)
    assert float(image[:, 3].max()) > 0.0
    bad = torch.zeros(len(BOXES), dtype=torch.long)
    with pytest.raises(ValueError, match="permutation"):
        dm.diffpairs_build_reference(args[6], torch.ones(4, 3), args[1], args[2],
                                     torch.ones(len(BOXES)), bad)


def test_pair_build_has_its_span():
    """With spans on, the pair list's build is the stage ``diff.pairs``
    (mark id 6, after the six that were there), between the ray set-up's
    span and the march's."""
    assert timers.SPANS.index("diff.pairs") == 6
    args, static = program_args(BOXES, VIEWS[0])
    before = timers.enable_spans(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                diff.render_image_pairs(*args, **static)
    finally:
        timers.enable_spans(before)
    names = [e.name for e in prof.events() if e.name.startswith(timers.HOST_PREFIX)]
    assert names.index("avr.diff.rays") < names.index("avr.diff.pairs") < names.index(
        "avr.diff.march")
