"""The port's host utilities against the JAX package's, on the inputs of
tests/test_image.py, tests/test_io.py and tests/test_compositor.py: the
image algebra (``byte_to_color``, ``Viewport``, the ``ImageBuffer``
region operations and pixel access, ``CompactImage``), the blend rules on
tensors, the PPM/PNG readers, the host flat-mode compositor
(``piece_range``, ``compose_flat_host``, ``assemble_pieces``), the stage
timers and trace, and the float64 range oracle
``renderer._transformed_range_numpy``.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import compositor as jcomp
from amrvolumerenderer_tpu import image as jimage
from amrvolumerenderer_tpu import io as jio
from amrvolumerenderer_tpu.renderer import _transformed_range_numpy as jax_range
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
from amrvolumerenderer_torch import compositor, image, io, renderer
from amrvolumerenderer_torch.utils import timers

from test_torch_worklist import port_levels

ALL_KINDS = [k.name for k in image.ImageKind]


def both_buffers(kind, w=8, h=8, region=(0, None), lo=20, hi=40, seed=0):
    """tests/test_image.py's ``_sparse_buffer`` built in both packages
    over the same pixels: background outside flat pixels [lo, hi)."""
    rng = np.random.default_rng(seed)
    jbuf = jimage.ImageBuffer.create(jimage.ImageKind[kind], w, h, *region)
    jbuf.clear()
    n = jbuf.num_pixels
    a, b = max(lo - jbuf.region_begin, 0), min(hi - jbuf.region_begin, n)
    if b > a:
        if kind == "RGBA_U8":
            jbuf.pixels[a:b] = rng.integers(1, 256, (b - a, 4)).astype(np.uint8)
        else:
            px = (rng.random((b - a, jbuf.pixels.shape[1])) * 0.8 + 0.1).astype(
                np.float32)
            if kind in ("RGBA_U8_DEPTH_F32", "RGB_F32_DEPTH_F32"):
                px[:, -1] = rng.random(b - a) * 0.9
            if kind == "RGBA_F32_DEPTH_SORT":
                px[:, 4] = rng.random(b - a) * 10
            jbuf.pixels[a:b] = px
    pbuf = image.ImageBuffer(image.ImageKind[kind], w, h, np.array(jbuf.pixels),
                             jbuf.region_begin, jbuf.region_end)
    return jbuf, pbuf


def same_viewport(p, j):
    assert (p.min_x, p.min_y, p.max_x, p.max_y) == (j.min_x, j.min_y, j.max_x, j.max_y)


def same_buffer(p, j):
    assert p.kind.name == j.kind.name
    assert (p.width, p.height, p.region_begin, p.region_end) == (
        j.width, j.height, j.region_begin, j.region_end)
    same_viewport(p.valid_viewport, j.valid_viewport)
    np.testing.assert_array_equal(np.asarray(p.pixels), np.asarray(j.pixels))
    assert np.asarray(p.pixels).dtype == np.asarray(j.pixels).dtype


def same_compact(p, j):
    assert (p.region_begin, p.region_end, p.active_begin, p.active_end,
            p.num_pixels) == (j.region_begin, j.region_end, j.active_begin,
                              j.active_end, j.num_pixels)
    same_viewport(p.valid_viewport, j.valid_viewport)
    np.testing.assert_array_equal(np.asarray(p.pixels), np.asarray(j.pixels))


def test_byte_to_color_matches_jax():
    b = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(image.byte_to_color(b), jimage.byte_to_color(b))
    for v in range(256):
        assert int(image.color_to_byte(image.byte_to_color(np.uint8(v)))) == v


def test_viewport_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        a, b = rng.integers(-3, 9, 4), rng.integers(-3, 9, 4)
        pa, pb = image.Viewport(*map(int, a)), image.Viewport(*map(int, b))
        ja, jb = jimage.Viewport(*map(int, a)), jimage.Viewport(*map(int, b))
        assert pa.valid() == ja.valid()
        same_viewport(pa.intersect(pb), ja.intersect(jb))
        same_viewport(pa.union(pb), ja.union(jb))


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_pixel_access_matches_jax(kind):
    """pixel_index, get/set colour and depth, the order-dependence flag,
    on a windowed region (tests/test_image.py's window and roundtrip
    cases)."""
    jbuf, pbuf = both_buffers(kind, 10, 10, region=(5, 95), lo=0, hi=0)
    assert pbuf.blend_is_order_dependent() == jbuf.blend_is_order_dependent()
    for (x, y), rgba, depth in [((5, 2), (1.0, 0.0, 0.0, 1.0), 0.25),
                                ((3, 4), (1.0, 0.5, 0.25, 1.0), 2.0),
                                ((9, 8), (0.1, 0.7, 0.3, 0.4), 0.9)]:
        assert pbuf.pixel_index(x, y) == jbuf.pixel_index(x, y)
        pbuf.set_color(x, y, rgba)
        jbuf.set_color(x, y, rgba)
        np.testing.assert_array_equal(pbuf.get_color(x, y), jbuf.get_color(x, y))
        pbuf.set_depth(x, y, depth)
        jbuf.set_depth(x, y, depth)
        assert pbuf.get_depth(x, y) == jbuf.get_depth(x, y)
    same_buffer(pbuf, jbuf)


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_window_copy_and_blend_match_jax(kind):
    """window (shallow, of a window), copy_subrange (deep), deep_copy and
    blend over aligned, unaligned and gapped regions."""
    jbuf, pbuf = both_buffers(kind, region=(0, 64), lo=10, hi=50, seed=3)
    for sub in [(20, 50), (0, 64), (30, 30)]:
        same_buffer(pbuf.window(*sub), jbuf.window(*sub))
        same_buffer(pbuf.window(*sub).window(0, sub[1] - sub[0]),
                    jbuf.window(*sub).window(0, sub[1] - sub[0]))
    win = pbuf.window(20, 50)
    assert np.shares_memory(win.pixels, pbuf.pixels)
    sub = pbuf.copy_subrange(10, 40)
    same_buffer(sub, jbuf.copy_subrange(10, 40))
    assert not np.shares_memory(sub.pixels, pbuf.pixels)
    same_buffer(pbuf.deep_copy(), jbuf.deep_copy())

    for (tb, te), (bb, be) in [((0, 64), (0, 64)), ((0, 40), (24, 64)),
                               ((16, 64), (0, 48)), ((0, 10), (10, 64))]:
        jt, pt = both_buffers(kind, region=(tb, te), lo=tb + 4, hi=tb + 20, seed=1)
        jb, pb = both_buffers(kind, region=(bb, be), lo=bb + 10, hi=bb + 30, seed=2)
        pt.valid_viewport = image.Viewport(1, 0, 7, 6)
        jt.valid_viewport = jimage.Viewport(1, 0, 7, 6)
        same_buffer(pt.blend(pb), jt.blend(jb))
    _, top = both_buffers(kind, region=(0, 4))
    _, bottom = both_buffers(kind, region=(8, 16))
    with pytest.raises(AssertionError):
        top.blend(bottom)


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_compact_image_matches_jax(kind):
    """compress (with a valid viewport), uncompress, window, copy_subrange,
    deep_copy and the compact-domain blend, including empty images."""
    jbuf, pbuf = both_buffers(kind, lo=20, hi=40)
    pc, jc = pbuf.compress(), jbuf.compress()
    assert isinstance(pc, image.CompactImage)
    same_compact(pc, jc)
    same_buffer(pc.uncompress(), jc.uncompress())
    for sub in [(0, 64), (10, 30), (25, 35), (45, 64), (0, 10), (30, 30)]:
        same_compact(pc.window(*sub), jc.window(*sub))
        same_compact(pc.copy_subrange(*sub), jc.copy_subrange(*sub))
    same_compact(pc.window(10, 50).window(5, 25), jc.window(10, 50).window(5, 25))
    same_compact(pc.deep_copy(), jc.deep_copy())
    assert not np.shares_memory(pc.deep_copy().pixels, pc.pixels)

    pbuf.valid_viewport = image.Viewport(2, 2, 5, 5)
    jbuf.valid_viewport = jimage.Viewport(2, 2, 5, 5)
    same_compact(pbuf.compress(), jbuf.compress())
    same_buffer(pbuf.compress().uncompress(), jbuf.compress().uncompress())

    for (tb, te), (bb, be) in [((0, 64), (0, 64)), ((0, 40), (24, 64)),
                               ((16, 64), (0, 48))]:
        jt, pt = both_buffers(kind, region=(tb, te), lo=tb + 4, hi=tb + 20, seed=1)
        jb, pb = both_buffers(kind, region=(bb, be), lo=bb + 10, hi=bb + 30, seed=2)
        got = pt.compress().blend(pb.compress())
        same_compact(got, jt.compress().blend(jb.compress()))
        same_buffer(got.uncompress(), jt.compress().blend(jb.compress()).uncompress())
    je, pe = both_buffers(kind, lo=0, hi=0)
    same_compact(pe.compress().blend(pe.compress()), je.compress().blend(je.compress()))


def test_blend_rules_on_tensors_match_numpy_and_jax():
    """The blend rules switch between NumPy and torch as the JAX ones
    switch between NumPy and jnp."""
    rng = np.random.default_rng(5)
    top = rng.random((64, 5)).astype(np.float32)
    bottom = rng.random((64, 5)).astype(np.float32)
    top[:8, 4] = bottom[:8, 4]  # depth ties keep top
    for ours, theirs in ((image.blend_depth_sort, jimage.blend_depth_sort),
                         (image.blend_z_compare, jimage.blend_z_compare)):
        want = np.asarray(theirs(jnp.asarray(top), jnp.asarray(bottom)))
        np.testing.assert_array_equal(ours(top, bottom), want)
        got = ours(torch.from_numpy(top), torch.from_numpy(bottom))
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)


def checkerboard(module, w=8, h=6):
    img = module.ImageBuffer.create(module.ImageKind.RGBA_F32_DEPTH_SORT, w, h)
    for y in range(h):
        for x in range(w):
            v = 1.0 if (x + y) % 2 == 0 else 0.25
            img.set_color(x, y, (v, 0.5 * v, 1.0 - v, 1.0))
    return img


def test_readers_match_jax(tmp_path):
    """load_ppm and load_png on the JAX writers' files (tests/test_io.py's
    checkerboard and partial region) and on a PNG that uses every filter
    type (tests/test_io.py's filter case)."""
    import struct
    import zlib

    partial = jimage.ImageBuffer.create(jimage.ImageKind.RGBA_F32, 4, 4, 4, 12)
    partial.pixels[:] = [1.0, 1.0, 1.0, 1.0]
    files = []
    for name, img in (("board", checkerboard(jimage)), ("partial", partial)):
        for ext, save in (("ppm", jio.save_ppm), ("png", jio.save_png)):
            path = str(tmp_path / f"{name}.{ext}")
            assert save(img, path)
            files.append(path)

    rng = np.random.default_rng(9)
    w, h = 7, 5
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    raw = bytearray()
    for row in range(h):  # rows sent with filters 0, 1, 2, 3, 4 in turn
        ftype = row % 5
        line = rgb.reshape(h, -1)[row].astype(np.int32)
        prev = rgb.reshape(h, -1)[row - 1].astype(np.int32) if row else np.zeros_like(line)
        enc = np.zeros_like(line)
        for i in range(len(line)):
            a = line[i - 3] if i >= 3 else 0
            b, c = prev[i], (prev[i - 3] if i >= 3 else 0)
            p = a + b - c
            paeth = a if abs(p - a) <= min(abs(p - b), abs(p - c)) else (
                b if abs(p - b) <= abs(p - c) else c)
            pred = [0, a, b, (a + b) // 2, paeth][ftype]
            enc[i] = (line[i] - pred) % 256
        raw.append(ftype)
        raw.extend(enc.astype(np.uint8).tobytes())
    filters = str(tmp_path / "filters.png")
    with open(filters, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(jio._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(jio._png_chunk(b"IDAT", zlib.compress(bytes(raw))))
        f.write(jio._png_chunk(b"IEND", b""))
    files.append(filters)

    for path in files:
        load, jload = ((io.load_png, jio.load_png) if path.endswith(".png")
                       else (io.load_ppm, jio.load_ppm))
        got, gw, gh = load(path)
        want, ww, wh = jload(path)
        assert (gw, gh) == (ww, wh)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got, _, _ = io.load_png(filters)
    np.testing.assert_array_equal((got[::-1] * 255.0 + 0.5).astype(np.uint8), rgb)

    # the port's writers read back as the JAX readers read them
    board = checkerboard(image)
    for ext, save, load in (("ppm", io.save_ppm, jio.load_ppm),
                            ("png", io.save_png, jio.load_png)):
        path = str(tmp_path / f"port.{ext}")
        assert save(board, path)
        np.testing.assert_array_equal(load(path)[0], (io.load_ppm if ext == "ppm"
                                                      else io.load_png)(path)[0])


def test_readers_reject_malformed_files(tmp_path):
    cases = [("bad.ppm", b"P3\n# not binary\n", io.load_ppm),
             ("bad.png", b"\x89PNJUNK\r\n\x1a\n", io.load_png),
             ("trunc.png", b"\x89PNG\r\n\x1a\n\x00\x00\x00\rIHDR", io.load_png)]
    for name, payload, load in cases:
        path = tmp_path / name
        path.write_bytes(payload)
        with pytest.raises(Exception):
            load(str(path))


def test_piece_range_matches_jax():
    for size in (1, 5, 10, 64, 1000):
        for pieces in range(1, 9):
            for i in range(pieces):
                assert compositor.piece_range(size, i, pieces) == jcomp.piece_range(
                    size, i, pieces)


@pytest.mark.parametrize("kind", ["RGBA_F32", "RGBA_F32_DEPTH_SORT",
                                  "RGBA_U8_DEPTH_F32"])
@pytest.mark.parametrize("num_ranks", [1, 2, 4, 7])
def test_compose_flat_host_matches_jax(kind, num_ranks):
    """tests/test_compositor.py's flat compose, dense and compressed, with
    a split cap and a clipped viewport, through assemble_pieces."""
    rng = np.random.default_rng(num_ranks)
    jimages, pimages = [], []
    for r in range(num_ranks):
        jbuf, pbuf = both_buffers(kind, 8, 8, lo=r * 5, hi=r * 5 + 30, seed=r)
        if r == 0:
            jbuf.valid_viewport = jimage.Viewport(1, 1, 6, 6)
            pbuf.valid_viewport = image.Viewport(1, 1, 6, 6)
        jimages.append(jbuf)
        pimages.append(pbuf)
    order = np.asarray(rng.permutation(num_ranks), dtype=np.int32)
    for split, compress in ((1_000_000, False), (1_000_000, True), (3, False)):
        got = compositor.compose_flat_host(pimages, order, split, compress)
        want = jcomp.compose_flat_host(jimages, order, split, compress)
        assert len(got) == len(want)
        for p, j in zip(got, want):
            same_buffer(p, j)
        same_buffer(compositor.assemble_pieces(got), jcomp.assemble_pieces(want))


def test_stage_timers_and_trace(tmp_path, capsys):
    t = timers.StageTimers()
    for _ in range(2):
        with t.stage("composite"):
            torch.ones(8).sum()
    with t.stage("render"):
        pass
    report = t.report()
    assert set(report) == {"composite", "render"}
    assert all(v >= 0.0 for v in report.values())
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].startswith("Render: composite took ")
    assert report is not t.stages

    quiet = timers.StageTimers(verbose=False)
    with pytest.raises(ValueError):
        with quiet.stage("failing"):
            raise ValueError("stage body failed")
    assert "failing" in quiet.report() and capsys.readouterr().out == ""

    with timers.device_trace(""):
        pass
    trace = tmp_path / "trace"
    with timers.device_trace(str(trace)):
        torch.ones(64).cumsum(0)
    assert (trace / "render_trace.json").stat().st_size > 0


@pytest.mark.parametrize("log_scale,normalize", [(False, False), (True, False),
                                                 (True, True)])
def test_transformed_range_numpy_matches_jax(log_scale, normalize):
    """The float64 range oracle on the same bricks (NaN, inf, zero and
    negative samples among them) and transforms."""
    from amrvolumerenderer_tpu.scene import SceneBuildOptions as JOptions
    from amrvolumerenderer_tpu.scene import build_scene_geometry as jbuild
    from amrvolumerenderer_torch.scene import SceneBuildOptions, build_scene_geometry

    rng = np.random.default_rng(12)
    field = rng.uniform(-2.0, 40.0, size=(8, 8, 8))
    field[0, 0, :3] = [np.nan, np.inf, 0.0]
    levels = [[LevelBox(field[:4], np.zeros(3, dtype=int)),
               LevelBox(field[4:], np.array([4, 0, 0]))]]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 0.125))]
    opts = dict(log_scale_input=log_scale)
    jgeom = jbuild(levels, geoms, JOptions(**opts))
    pgeom = build_scene_geometry(*port_levels(levels, geoms), SceneBuildOptions(**opts))
    if normalize:
        for g in (jgeom, pgeom):
            g.scalar_transform.normalize_to_unit_range = True
            g.scalar_transform.normalization_min = 0.5
            g.scalar_transform.inverse_normalization_span = 0.4
    got = renderer._transformed_range_numpy(pgeom)
    assert got == jax_range(jgeom)
    assert all(np.isfinite(got))
