"""The port's scalar statistics, histograms and device-resident ingestion
(amrvolumerenderer_torch/device_scene.py, scene.py, api.py, driver.py and
the package's ``compute_histogram``) against the JAX package on the CPU.

Each port route is held against the same JAX route on the same seeded
inputs, exactly: statistics (bricks with NaN, inf and subnormal samples),
histogram counts of the tensor route against JAX's jitted device route
and of the NumPy route against JAX's NumPy route, bin centers and the
degenerate range, the histogram entry points' results, and the
device-ingested scenes (``prepare_device_scene`` / ``prepare_device_amr``):
canonical piece table, scalar ranges, transform and frame bit for bit
(the frames at the manifest's 2e-6, measured 0).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amrvolumerenderer_torch
import amrvolumerenderer_tpu
from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu import device_scene as jax_ds
from amrvolumerenderer_tpu import scene as jax_scene
from amrvolumerenderer_tpu.types import ScalarTransform as JaxTransform
from amrvolumerenderer_torch import api, device_scene, scene
from amrvolumerenderer_torch.camera import auto_orbit_camera
from amrvolumerenderer_torch.fast_scene import FastSceneRenderer
from amrvolumerenderer_torch.types import (
    CameraParameters,
    RenderParameters,
    ScalarTransform,
)

from tests.conftest import make_r2_scene_data
from test_torch_worklist import as_jax, one_torch_thread, port_levels  # noqa: F401

CPU = torch.device("cpu")
CAMERA = dict(eye=(2.5, 1.8, 3.0), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0))


def assert_same(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[finite], ref[finite])


def odd_bricks(seed):
    """Seeded bricks of float32 and float64 samples holding NaN, +-inf,
    positive and negative subnormals, zeros and a float64 value that
    rounds to a float32 subnormal."""
    rng = np.random.default_rng(seed)
    a = (rng.random((8, 8, 8)) * 2.0 - 0.5).astype(np.float32)
    a[0, 0, 0], a[1, 2, 3], a[4, 4, 4] = np.nan, np.inf, 1e-40
    b = (rng.random((6, 5, 7)) + 0.25).astype(np.float32)
    b[2, 2, 2], b[0, 1, 0] = -np.inf, -3e-39
    c = rng.random((4, 4, 9)) * 1e-3
    c[3, 3, 3] = 2e-40
    d = np.zeros((3, 3, 3), np.float32)
    return [a, b, c, d]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pick", [(0,), (1,), (2,), (0, 1, 2, 3), (3,)])
def test_device_scalar_stats_match_jax(seed, pick):
    arrays = [odd_bricks(seed)[i] for i in pick]
    got = device_scene.device_scalar_stats([torch.from_numpy(a) for a in arrays])
    want = jax_ds.device_scalar_stats([jnp.asarray(a) for a in arrays])
    assert got == want


def test_subnormal_positive_sample_zeroes_min_positive():
    """A brick holding a positive subnormal: XLA:CPU reduces it as zero,
    so the minimum positive value is 0 and log scaling finds no positive
    value, in both packages."""
    data = np.full((8, 8, 8), 0.5, np.float32)
    data[3, 1, 4] = 1e-40
    got = device_scene.device_scalar_stats([torch.from_numpy(data)])
    assert got == jax_ds.device_scalar_stats([jnp.asarray(data)])
    assert got[2] == 0.0
    box = ([data], (0, 0, 0), (1, 1, 1))
    with pytest.raises(RuntimeError, match="no positive scalar"):
        jax_ds.build_device_scene_geometry(
            [(jnp.asarray(box[0][0]), box[1], box[2])], log_scale_input=True)
    with pytest.raises(RuntimeError, match="no positive scalar"):
        device_scene.build_device_scene_geometry(
            [(torch.from_numpy(data), box[1], box[2])], log_scale_input=True)


@pytest.mark.parametrize("policy", ["device", "native", "numpy"])
def test_scalar_stats_routes_match_jax(monkeypatch, policy):
    """``AVR_SCALAR_STATS`` forces a route; NumPy and tensor inputs on each
    route equal the JAX package's same route."""
    arrays = odd_bricks(2)[:2]
    monkeypatch.setenv("AVR_SCALAR_STATS", policy)
    assert scene._scalar_stats(arrays) == jax_scene._scalar_stats(arrays)
    tensors = [torch.from_numpy(a) for a in arrays]
    jax_arrays = [jnp.asarray(a) for a in arrays]
    assert scene._scalar_stats(tensors) == jax_scene._scalar_stats(jax_arrays)


def test_auto_route_reduces_large_tensors_where_they_lie(monkeypatch):
    """Without the switch, tensors of at least the threshold's samples
    take the device route (as JAX's device arrays do), smaller ones the
    native pass."""
    arrays = odd_bricks(3)[:3]
    monkeypatch.delenv("AVR_SCALAR_STATS", raising=False)
    routed = []
    device_route = scene._scalar_stats_device
    monkeypatch.setattr(scene, "_scalar_stats_device",
                        lambda a: routed.append(len(a)) or device_route(a))
    tensors = [torch.from_numpy(a) for a in arrays]
    jax_arrays = [jnp.asarray(a) for a in arrays]
    for threshold in (100, 1 << 22):
        monkeypatch.setattr(scene, "_DEVICE_STATS_MIN_SAMPLES", threshold)
        monkeypatch.setattr(jax_scene, "_DEVICE_STATS_MIN_SAMPLES", threshold)
        assert scene._scalar_stats(tensors) == jax_scene._scalar_stats(jax_arrays)
    assert routed == [3]


TRANSFORMS = {
    "identity": dict(),
    "normalize": dict(normalize_to_unit_range=True, normalization_min=-0.25,
                      normalization_max=1.5, inverse_normalization_span=1 / 1.75),
    "log": dict(log_scale_input=True, positive_floor=1e-3),
    "log-normalize": dict(log_scale_input=True, positive_floor=2e-4,
                          normalize_to_unit_range=True,
                          normalization_min=math.log(2e-4), normalization_max=0.5,
                          inverse_normalization_span=1 / (0.5 - math.log(2e-4))),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("bins,range_", [(64, (0.0, 1.0)), (37, (-0.3, 0.8)),
                                         (256, (-9.0, 1.2))])
def test_histogram_routes_match_jax_exactly(name, bins, range_):
    """Tensor bricks against JAX's jitted route, NumPy bricks against its
    NumPy route: equal counts and totals."""
    arrays = odd_bricks(4)
    t, jt = ScalarTransform(**TRANSFORMS[name]), JaxTransform(**TRANSFORMS[name])
    got = device_scene.device_histogram([torch.from_numpy(a) for a in arrays], t,
                                        bins, range_)
    want = jax_ds.device_histogram([jnp.asarray(a) for a in arrays], jt, bins,
                                   range_)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.uint64 and got[1] == want[1] == sum(a.size for a in arrays)
    got = device_scene.device_histogram(arrays, t, bins, range_)
    want = jax_ds.device_histogram(arrays, jt, bins, range_)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_chunked_reductions_match_jax(monkeypatch):
    """Statistics and histograms reduce concatenated chunks of bricks; a
    chunk smaller than one brick, and mixed float32 / float64 bricks,
    give JAX's results."""
    arrays = odd_bricks(5)
    tensors = [torch.from_numpy(a) for a in arrays]
    jax_arrays = [jnp.asarray(a) for a in arrays]
    t = ScalarTransform(**TRANSFORMS["log-normalize"])
    jt = JaxTransform(**TRANSFORMS["log-normalize"])
    want_stats = jax_ds.device_scalar_stats(jax_arrays)
    want_hist = jax_ds.device_histogram(jax_arrays, jt, 41, (0.0, 1.0))
    for chunk in (1 << 26, 300, 1):
        monkeypatch.setattr(device_scene, "_CHUNK_SAMPLES", chunk)
        assert device_scene.device_scalar_stats(tensors) == want_stats
        got = device_scene.device_histogram(tensors, t, 41, (0.0, 1.0))
        np.testing.assert_array_equal(got[0], want_hist[0])
        assert got[1] == want_hist[1]


def test_histogram_bin_centers_and_degenerate_range():
    bins = 16
    reps = np.arange(bins) + 1
    values = np.repeat((np.arange(bins) + 0.5) / bins, reps).astype(np.float32)
    t = ScalarTransform()
    for a in (values, torch.from_numpy(values)):
        counts, total = device_scene.device_histogram([a], t, bins, (0.0, 1.0))
        assert total == values.size
        np.testing.assert_array_equal(counts, reps.astype(np.uint64))
        counts, total = device_scene.device_histogram([a], t, bins, (1.0, 1.0))
        assert total == 0 and counts.sum() == 0
    with pytest.raises(ValueError, match="binCount"):
        device_scene.device_histogram([values], t, 0, (0.0, 1.0))


def amr_data(levels, geoms, **kw):
    """(JAX AmrData, the port's) over the same arrays."""
    port = port_levels(levels, geoms)
    return (jax_api.AmrData(level_data=levels, level_geometry=geoms, **kw),
            api.AmrData(level_data=port[0], level_geometry=port[1], **kw))


def assert_hist_equal(got, want):
    np.testing.assert_array_equal(got.bin_counts, want.bin_counts)
    for name in ("normalized_range", "processed_range", "has_processed_range",
                 "original_range", "has_original_range", "sample_count"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("options", [
    dict(bin_count=32), dict(bin_count=16, log_scale_input=True),
    dict(bin_count=8, min_level=0, max_level=0),
])
def test_api_compute_histogram_matches_jax(options):
    """tests/test_api.py:139-160 (the r^2 scene; log scale on values
    shifted positive)."""
    levels, geoms = make_r2_scene_data(32, 16)
    if options.get("log_scale_input"):
        for box in levels[0]:
            box.data = box.data + 0.01
    jdata, pdata = amr_data(levels, geoms)
    got = api.compute_histogram(pdata, api.HistogramOptions(**options, device="cpu"))
    want = jax_api.compute_histogram(jdata, jax_api.HistogramOptions(**options))
    assert_hist_equal(got, want)
    assert got.sample_count == got.bin_counts.sum() == 32 ** 3
    if not options.get("log_scale_input"):
        assert got.bin_counts[:16].sum() > got.bin_counts[16:].sum()


@pytest.mark.parametrize("component", [0, 1])
def test_histogram_component_selection_matches_jax(component):
    """tests/test_api.py:162-180: a 4D box, one component at a time."""
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    rng = np.random.default_rng(3)
    multi = rng.random((8, 8, 8, 2))
    multi[..., 1] = 0.5
    jdata, pdata = amr_data([[LevelBox(multi, np.zeros(3, dtype=int))]],
                            [LevelGeometry(np.zeros(3), np.full(3, 1.0 / 8))])
    options = dict(bin_count=8, component=component)
    got = api.compute_histogram(pdata, api.HistogramOptions(**options, device="cpu"))
    assert_hist_equal(got, jax_api.compute_histogram(
        jdata, jax_api.HistogramOptions(**options)))
    assert got.sample_count == 512
    assert (got.bin_counts[0] == 512) == (component == 1)
    with pytest.raises(ValueError, match="binCount"):
        api.compute_histogram(pdata, api.HistogramOptions(bin_count=0, device="cpu"))


def test_compute_histogram_dict_matches_jax(tmp_path):
    """tests/test_driver.py:135: the reference binding's dict, for a
    two-box plotfile, plain and log scaled."""
    from amrvolumerenderer_tpu.plotfile import write_plotfile
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    c = np.arange(16) / 15
    field = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    path = str(tmp_path / "plt00000")
    write_plotfile(path, [[LevelBox(field[i:i + 8], np.array([i, 0, 0]))
                           for i in (0, 8)]],
                   [LevelGeometry(np.zeros(3), np.full(3, 1 / 16))],
                   var_names=["density"])
    for kw in (dict(bins=32), dict(bins=17, log_scale=True)):
        got = amrvolumerenderer_torch.compute_histogram(path, **kw, device="cpu")
        assert got == amrvolumerenderer_tpu.compute_histogram(path, **kw)
        assert len(got["counts"]) == kw["bins"] and got["samples"] == 16 ** 3
    result = amrvolumerenderer_torch.compute_histogram(path, bins=32, device="cpu")
    assert result["normalized_range"] == [0.0, 1.0]
    assert result["processed_range"] is not None
    assert result["original_range"] is not None


def test_compute_scene_histogram_of_tensor_bricks_matches_jax():
    """A scene whose bricks hold tensors bins on the tensor route, equal to
    JAX's device route for the same scene of device arrays."""
    levels, _ = make_r2_scene_data(32, 16)
    bricks = [(b.data, b.lo / 32.0, (b.lo + 16) / 32.0) for b in levels[0]]
    got_scene = device_scene.build_device_scene_geometry(
        [(torch.from_numpy(d.astype(np.float32)), lo, hi) for d, lo, hi in bricks])
    want_scene = jax_ds.build_device_scene_geometry(
        [(jnp.asarray(d, jnp.float32), lo, hi) for d, lo, hi in bricks])
    for bins in (16, 100):
        assert_hist_equal(scene.compute_scene_histogram(got_scene, bins),
                          jax_scene.compute_scene_histogram(want_scene, bins))


def r2_device_bricks(shift=0.0):
    levels, _ = make_r2_scene_data(32, 16)
    return [(np.asarray(b.data + shift, np.float32), b.lo / 32.0,
             (b.lo + np.asarray(b.data.shape)) / 32.0) for b in levels[0]]


def assert_same_geometry(got, want):
    for name in ("original_scalar_range", "processed_scalar_range",
                 "scalar_range", "has_original_scalar_range"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.explicit_bounds.min_corner,
                                  want.explicit_bounds.min_corner)
    np.testing.assert_array_equal(got.explicit_bounds.max_corner,
                                  want.explicit_bounds.max_corner)
    for name in ("log_scale_input", "normalize_to_unit_range", "positive_floor",
                 "normalization_min", "inverse_normalization_span"):
        assert getattr(got.scalar_transform, name) == getattr(
            want.scalar_transform, name), name
    for g, w in zip(got.bricks, want.bricks):
        np.testing.assert_array_equal(g.min_corner, w.min_corner)
        np.testing.assert_array_equal(g.max_corner, w.max_corner)


def assert_same_renderer(port, ref, camera):
    """Canonical table, piece metadata, scalar range and frame."""
    np.testing.assert_array_equal(port.canonical.float().numpy(),
                                  np.asarray(ref.canonical, np.float32))
    np.testing.assert_array_equal(port.box_min, ref.box_min)
    np.testing.assert_array_equal(port.box_max, ref.box_max)
    np.testing.assert_array_equal(port.dims_world, ref.dims_world)
    np.testing.assert_array_equal(port.parents, ref.parents)
    np.testing.assert_array_equal(port.visible, ref.visible)
    assert port.scalar_range == tuple(ref.scalar_range)
    frame = port.render(camera)
    want = ref.render(as_jax(camera))
    assert (want[:, 3] > 0).mean() > 0.1
    assert_same(frame, want)


@pytest.mark.parametrize("knobs", [("nearest", False), ("nearest", True),
                                   ("trilinear", False)])
def test_prepare_device_scene_matches_jax(knobs):
    """tests/test_fast_scene.py:86-126: r^2 bricks as tensors (shifted
    positive for log scale)."""
    sampling, log_scale = knobs
    bricks = r2_device_bricks(0.05 if log_scale else 0.0)
    params = RenderParameters(width=32, height=32, sampling=sampling)
    port = device_scene.prepare_device_scene(
        [(torch.from_numpy(d), lo, hi) for d, lo, hi in bricks], params,
        log_scale_input=log_scale, device="cpu")
    ref = jax_ds.prepare_device_scene(
        [(jnp.asarray(d), lo, hi) for d, lo, hi in bricks], as_jax(params),
        log_scale_input=log_scale)
    assert port.canonical.device == CPU
    assert all(isinstance(b.data, torch.Tensor) for b in port.geometry.bricks)
    assert_same_geometry(port.geometry, ref.geometry)
    assert_same_renderer(port, ref, CameraParameters(**CAMERA))


def test_device_ingestion_equals_host_ingestion():
    """The tensor-ingested renderer against the port's host-ingested one
    of the same scene: the same frame (JAX's test allows 1e-5)."""
    levels, geoms = port_levels(*make_r2_scene_data(32, 16))
    geometry = api.load_amr_geometry(
        api.AmrData(level_data=levels, level_geometry=geoms), 0, -1, 0, False,
        True, verbose=False)
    params = RenderParameters(width=32, height=32)
    host = FastSceneRenderer(geometry, params, device=CPU)
    dev = device_scene.prepare_device_scene(
        [(torch.from_numpy(d), lo, hi) for d, lo, hi in r2_device_bricks()],
        params, device="cpu")
    camera = CameraParameters(**CAMERA)
    np.testing.assert_allclose(dev.render(camera), host.render(camera), atol=1e-5)


def two_level_scene():
    """tests/test_multilevel.py::make_two_level_scene: coarse 16^3 over
    [0,1]^3 and fine 16^3 over [0.25, 0.75]^3 (ratio 2)."""
    from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry

    def radial(n, lo, hi):
        c = lo + (np.arange(n) + 0.5) / n * (hi - lo)
        return ((c[:, None, None] - 0.5) ** 2 + (c[None, :, None] - 0.5) ** 2
                + (c[None, None, :] - 0.5) ** 2)

    levels = [[LevelBox(radial(16, 0.0, 1.0), np.zeros(3, dtype=int))],
              [LevelBox(radial(16, 0.25, 0.75) * 1.5, np.array([8, 8, 8]))]]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / 16)),
             LevelGeometry(np.zeros(3), np.full(3, 1.0 / 32))]
    return levels, geoms


@pytest.mark.parametrize("log_scale", [False, True])
def test_prepare_device_amr_matches_jax(log_scale):
    """tests/test_multilevel.py:160-190: two levels of tensors, convexified
    on metadata."""
    levels, geoms = two_level_scene()
    if log_scale:
        for box in levels[0] + levels[1]:
            box.data = box.data + 0.02
    params = RenderParameters(width=32, height=32)
    port = device_scene.prepare_device_amr(
        [[(torch.from_numpy(np.asarray(b.data, np.float32)), b.lo) for b in lv]
         for lv in levels], port_levels(levels, geoms)[1], [(2, 2, 2)],
        parameters=params, log_scale_input=log_scale, device="cpu")
    ref = jax_ds.prepare_device_amr(
        [[(jnp.asarray(np.asarray(b.data, np.float32)), b.lo) for b in lv]
         for lv in levels], geoms, [(2, 2, 2)], parameters=as_jax(params),
        log_scale_input=log_scale)
    assert port.canonical.shape[0] == ref.canonical.shape[0] > 2
    assert_same_geometry(port.geometry, ref.geometry)
    assert_same_renderer(port, ref, CameraParameters(
        eye=(2.2, 1.6, 2.8), look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)))


def test_prepare_device_amr_level_selection():
    """tests/test_multilevel.py:193-214, plus a 4D box's component."""
    levels, geoms = two_level_scene()
    port_geoms = port_levels(levels, geoms)[1]
    tensors = [[(torch.from_numpy(np.asarray(b.data, np.float32)), b.lo)
                for b in lv] for lv in levels]
    only_fine = device_scene.prepare_device_amr(
        tensors, port_geoms, [(2, 2, 2)],
        parameters=RenderParameters(width=32, height=32), min_level=1,
        device="cpu")
    assert only_fine.canonical.shape[0] == 1
    with pytest.raises(ValueError, match="refinementRatios"):
        device_scene.prepare_device_amr(
            tensors, port_geoms, [], parameters=RenderParameters(width=32, height=32),
            device="cpu")
    stacked = [[(torch.stack([d, d * 2.0], dim=-1), lo) for d, lo in lv]
               for lv in tensors]
    second = device_scene.prepare_device_amr(
        stacked, port_geoms, [(2, 2, 2)], component=1, device="cpu",
        parameters=RenderParameters(width=32, height=32))
    first = device_scene.prepare_device_amr(
        tensors, port_geoms, [(2, 2, 2)], device="cpu",
        parameters=RenderParameters(width=32, height=32))
    assert second.geometry.original_scalar_range == pytest.approx(
        tuple(2.0 * v for v in first.geometry.original_scalar_range))


def test_prepare_device_scene_is_exported_and_defaults_to_cuda():
    assert "prepare_device_scene" in amrvolumerenderer_torch.__all__
    assert "compute_histogram" in amrvolumerenderer_torch.__all__
    assert amrvolumerenderer_torch.prepare_device_scene is \
        device_scene.prepare_device_scene
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        amrvolumerenderer_torch.prepare_device_scene(
            [(torch.ones(4, 4, 4), (0, 0, 0), (1, 1, 1))], RenderParameters())
