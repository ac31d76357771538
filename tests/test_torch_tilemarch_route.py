"""The port's one-shot tile-march route (``renderer_fast.
render_composited_tilemarch``) against the JAX package's function of that
name, at max |diff| 0 with the same non-finite depth pattern.

Both work on ``prepare_slicemarch_scene``'s prep: split pieces fall back to
their parent box's depth hint when the visibility graph is off, owners
break hint ties in the visibility rank order, and one tile-march launch
renders the frame.  The JAX side runs its Pallas kernel in interpret mode.
Scenes: bench.py's 3-level scene (nearest and trilinear, graph on and off)
directly and through ``api.render(render_method="tilemarch")``, and a
two-level scene of more than 96 pieces through the router of the
slice-march route.
"""

import numpy as np
import pytest

from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu import renderer_fast as jax_rf
from amrvolumerenderer_tpu.scene import LevelBox, LevelGeometry
from amrvolumerenderer_torch import api, renderer_fast
from amrvolumerenderer_torch.state import geometry_from

from test_torch_renderer_fast import frame_args
from test_torch_worklist import (  # noqa: F401
    as_jax,
    one_torch_thread,
    port_levels,
    three_level_geometry,
)

SAMPLINGS = ["nearest", "trilinear"]
GRAPH = [True, False]


def assert_equal_frames(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[finite], want[finite])
    assert (want[:, 3] > 0).mean() > 0.05


@pytest.fixture(scope="module")
def scene():
    g3 = three_level_geometry()
    return g3, geometry_from(g3)


@pytest.mark.parametrize("graph", GRAPH, ids=["graph", "nograph"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_route_matches_jax(scene, sampling, graph):
    """The function itself, with the caller's scalar range and reference
    sample distance."""
    jax_geometry, geometry = scene
    params, camera, srange, rsd = frame_args(geometry, (sampling, "post", 256),
                                             None, 48)
    params.use_visibility_graph = graph
    got = renderer_fast.render_composited_tilemarch(
        geometry, params, camera, srange, rsd, 48, 48, None, device="cpu")
    want = jax_rf.render_composited_tilemarch(
        jax_geometry, as_jax(params), as_jax(camera), srange, rsd, 48, 48,
        None, interpret=True)
    assert_equal_frames(got, want)


def three_level_data():
    """bench.py's 3-level scene (the levels of ``three_level_geometry``)
    as (the JAX package's AmrData, the port's)."""
    n = 32

    def field(lo, hi):
        c = lo + (np.arange(n) + 0.5) / n * (hi - lo)
        r = np.sqrt((c[:, None, None] - 0.5) ** 2 + (c[None, :, None] - 0.5) ** 2
                    + (c[None, None, :] - 0.5) ** 2)
        return np.exp(-((r - 0.18) / 0.06) ** 2) + 0.7 * np.exp(
            -((r - 0.38) / 0.05) ** 2)

    levels = [[LevelBox(field(0.0, 1.0), np.zeros(3, int))],
              [LevelBox(field(0.25, 0.75), np.full(3, 16, int))],
              [LevelBox(field(0.375, 0.625), np.full(3, 48, int))]]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / (s * n)))
             for s in (1, 2, 4)]
    ratios = [(2, 2, 2), (2, 2, 2)]
    return (jax_api.AmrData(levels, geoms, ratios),
            api.AmrData(*port_levels(levels, geoms), ratios))


@pytest.mark.parametrize("graph", GRAPH, ids=["graph", "nograph"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_api_render_tilemarch_matches_jax(sampling, graph):
    jax_data, data = three_level_data()
    options = dict(width=48, height=48, sampling=sampling,
                   visibility_graph=graph, render_method="tilemarch")
    got, _ = api.render(data, api.RenderOptions(device="cpu", **options),
                        verbose=False)
    want, _ = jax_api.render(jax_data, jax_api.RenderOptions(**options),
                             verbose=False)
    assert_equal_frames(got.pixels, want.pixels)


def deep_two_level_data():
    """64 level-0 bricks of 4^3 cells over a 16^3 domain, and 64 level-1
    bricks refining its middle half: more than 96 pieces."""
    def r2(n, lo, hi):
        c = lo + (np.arange(n) + 0.5) / n * (hi - lo)
        return (c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)

    coarse, fine = r2(16, 0.0, 1.0), r2(16, 0.25, 0.75)
    corners = [np.array([i, j, k]) for i in range(0, 16, 4)
               for j in range(0, 16, 4) for k in range(0, 16, 4)]
    levels = [
        [LevelBox(coarse[i:i + 4, j:j + 4, k:k + 4], np.array([i, j, k]))
         for i, j, k in corners],
        [LevelBox(fine[i:i + 4, j:j + 4, k:k + 4], np.array([i, j, k]) + 8)
         for i, j, k in corners],
    ]
    geoms = [LevelGeometry(np.zeros(3), np.full(3, 1.0 / 16)),
             LevelGeometry(np.zeros(3), np.full(3, 1.0 / 32))]
    ratios = [(2, 2, 2)]
    return (jax_api.AmrData(levels, geoms, ratios),
            api.AmrData(*port_levels(levels, geoms), ratios))


@pytest.mark.parametrize("graph", GRAPH, ids=["graph", "nograph"])
def test_more_than_96_pieces_route_matches_jax(monkeypatch, graph):
    """The slice-march route hands a scene of more than 96 pieces to
    tile-march, on the prep it already made, and the frame equals JAX's
    (whose router does the same)."""
    calls = []
    direct = renderer_fast._tilemarch_frame

    def counted(prep, *args, **kwargs):
        calls.append(prep["vol"].shape[0])
        return direct(prep, *args, **kwargs)

    monkeypatch.setattr(renderer_fast, "_tilemarch_frame", counted)
    jax_data, data = deep_two_level_data()
    options = dict(width=32, height=32, visibility_graph=graph,
                   render_method="slicemarch")
    got, _ = api.render(data, api.RenderOptions(device="cpu", **options),
                        verbose=False)
    assert len(calls) == 1 and calls[0] > renderer_fast.TILEMARCH_PIECE_THRESHOLD
    want, _ = jax_api.render(jax_data, jax_api.RenderOptions(**options),
                             verbose=False)
    assert_equal_frames(got.pixels, want.pixels)
