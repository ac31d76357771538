"""The port's one-shot slice-march route (amrvolumerenderer_torch/
renderer_fast.py) against the JAX package's.

Each side builds its own scene objects from the same seeded arrays (the
port's through ``state.geometry_from``).  ``prepare_slicemarch_scene``
returns a dict equal to the JAX one, array for array; ``composited_frame``
(march + composite + untile) matches the JAX frame in interpret mode at
the manifest's atol of 2e-6; ``api.render`` with ``"slicemarch"`` and
``"auto"`` reproduces golden row ``slicemarch-1dev`` through this route,
``"tilemarch"`` reproduces ``tilemarch-1dev`` through the tile-march route,
and a scene of more than 96 pieces goes to tile-march.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import api as jax_api
from amrvolumerenderer_tpu import renderer_fast as jax_rf
from amrvolumerenderer_tpu.compositor import sort_layers as jax_sort_layers
from amrvolumerenderer_tpu.renderer import render_layers as jax_render_layers
from amrvolumerenderer_torch import api, renderer, renderer_fast
from amrvolumerenderer_torch.camera import auto_orbit_camera
from amrvolumerenderer_torch.compositor import composite_layers_host, sort_layers
from amrvolumerenderer_torch.ops import numerics
from amrvolumerenderer_torch.state import geometry_from
from amrvolumerenderer_torch.types import (
    CameraParameters,
    RenderParameters,
    color_map_from_tuples,
)

from tests.conftest import make_r2_scene_data
from test_torch_worklist import (  # noqa: F401
    as_jax,
    one_torch_thread,
    port_levels,
    three_level_geometry,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "manifest_pixels.npz")
ATOL = 2e-6
CPU = torch.device("cpu")
KNOBS = [("nearest", "post", 256), ("trilinear", "post", 256),
         ("trilinear", "pre", 128)]
EYES = [None, (-1.9, 2.3, -1.2), (0.4, 0.45, 0.5), (0.5, 0.6, 3.2)]


@pytest.fixture(scope="module")
def scenes():
    """(JAX geometry, the port's copy) of the golden r^2 scene and bench.py's
    3-level scene."""
    levels, geoms = make_r2_scene_data(16, 8)
    r2 = jax_api.load_amr_geometry(
        jax_api.AmrData(level_data=levels, level_geometry=geoms),
        0, -1, 0, False, True, verbose=False)
    g3 = three_level_geometry()
    return {"r2": (r2, geometry_from(r2)), "3lvl": (g3, geometry_from(g3))}


def frame_args(geometry, knobs, eye, size):
    """(params, camera, scalar range, reference distance) for the port."""
    sampling, classification, lut_size = knobs
    params = RenderParameters(width=size, height=size, sampling=sampling,
                              classification=classification, lut_size=lut_size)
    bounds = renderer.compute_global_bounds(geometry)
    camera = (auto_orbit_camera(bounds) if eye is None else
              CameraParameters(eye=eye, look_at=(0.5, 0.5, 0.5), up=(0, 1, 0)))
    return (params, camera, renderer.compute_global_scalar_range(geometry),
            renderer.compute_reference_sample_distance(geometry, bounds))


def assert_matches(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=ATOL)


@pytest.mark.parametrize("eye", EYES, ids=["auto", "oblique", "inside", "axis2"])
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(map(str, k)))
@pytest.mark.parametrize("scene", ["r2", "3lvl"])
def test_prepare_matches_jax(scenes, scene, knobs, eye):
    jax_geometry, geometry = scenes[scene]
    params, camera, srange, rsd = frame_args(geometry, knobs, eye, 48)
    got = renderer_fast.prepare_slicemarch_scene(
        geometry, params, camera, srange, rsd, 48, 40, None)
    want = jax_rf.prepare_slicemarch_scene(
        jax_geometry, as_jax(params), as_jax(camera), srange, rsd, 48, 40, None)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key


@pytest.mark.parametrize("knobs,eye", [(KNOBS[0], EYES[1]), (KNOBS[2], EYES[2])])
def test_composited_frame_matches_jax(scenes, knobs, eye):
    jax_geometry, geometry = scenes["3lvl"]
    params, camera, srange, rsd = frame_args(geometry, knobs, eye, 64)
    prep = renderer_fast.prepare_slicemarch_scene(
        geometry, params, camera, srange, rsd, 64, 64, None)
    order = sort_layers(prep["depth_hints"], prep["owners"], prep["local_indices"])
    owners_sorted = prep["owners"][order]
    kw = dict(width=prep["pad_w"], height=prep["pad_h"], max_slices=prep["s_max"],
              logical_width=64, logical_height=64, sampling=params.sampling,
              ghost=prep["ghost"], classification=params.classification)
    keys = ("vol", "meta", "dims", "luts", "cam", "wb", "wt", "coverage")
    want = jax_rf.composited_frame(
        *(jnp.asarray(prep[k]) for k in keys), jnp.asarray(order),
        jnp.asarray(owners_sorted), jnp.asarray(prep["wbounds"]),
        interpret=True, **kw)
    inp = renderer_fast.slicemarch_device_inputs(prep, CPU)
    got = renderer_fast.composited_frame(
        *(inp[k] for k in keys), torch.from_numpy(order),
        torch.from_numpy(np.ascontiguousarray(owners_sorted)), inp["wbounds"], **kw)
    assert (np.asarray(want)[:, 3] > 0).mean() > 0.1
    assert_matches(got.numpy(), want)


@pytest.mark.parametrize("method,row", [("slicemarch", "slicemarch-1dev"),
                                        ("auto", "slicemarch-1dev"),
                                        ("tilemarch", "tilemarch-1dev")])
def test_api_render_reproduces_golden_row_through_its_route(monkeypatch, method, row):
    """The other route is patched to raise, so the row proves the route."""
    def refuse(*args, **kwargs):
        raise AssertionError("rendered through the wrong route")

    other = ("render_composited_slicemarch" if method == "tilemarch"
             else "render_composited_tilemarch")
    monkeypatch.setattr(renderer_fast, other, refuse)
    with numerics.seed_rsqrt():  # the row's rsqrt model
        image, _ = api.render(
            api.AmrData(*port_levels(*make_r2_scene_data(16, 8))),
            api.RenderOptions(width=48, height=48, render_method=method, device="cpu"),
            verbose=False)
    assert_matches(image.pixels, np.load(GOLDEN)[row])


def test_more_than_96_pieces_go_to_tilemarch(monkeypatch):
    """512 bricks of 2^3 cells: the router hands the frame, with the prep
    it made, to tile-march, whose frame equals the direct tile-march
    route's."""
    calls = []
    direct = renderer_fast._tilemarch_frame

    def counted(*args, **kwargs):
        calls.append(1)
        return direct(*args, **kwargs)

    monkeypatch.setattr(renderer_fast, "_tilemarch_frame", counted)
    data = api.AmrData(*port_levels(*make_r2_scene_data(16, 2)))
    options = dict(width=32, height=32, device="cpu")
    auto, _ = api.render(data, api.RenderOptions(**options), verbose=False)
    assert calls == [1]
    tile, _ = api.render(data, api.RenderOptions(render_method="tilemarch",
                                                 **options), verbose=False)
    np.testing.assert_array_equal(auto.pixels, tile.pixels)
    assert (auto.pixels[:, 3] > 0).mean() > 0.1


@pytest.mark.parametrize("knobs", [KNOBS[0], KNOBS[1]])
def test_render_layers_match_jax(scenes, knobs):
    """The layered path (kernel 3): per-piece layers equal the JAX ones,
    and their host fold is the composited frame."""
    jax_geometry, geometry = scenes["r2"]
    params, camera, srange, rsd = frame_args(geometry, knobs, EYES[1], 40)
    bounds = renderer.compute_global_bounds(geometry)
    got = renderer.render_layers(geometry, params, camera, bounds, srange, rsd,
                                 40, 40, None, method="slicemarch", device=CPU)
    want = jax_render_layers(jax_geometry, as_jax(params), as_jax(camera),
                             as_jax(bounds), srange, rsd, 40, 40, None,
                             method="slicemarch")
    for g, w in zip(got, want):
        assert_matches(g, w)
    layers, hints, owners, local = got
    frame = renderer_fast.render_composited_slicemarch(
        geometry, params, camera, srange, rsd, 40, 40, None, device=CPU)
    folded = composite_layers_host(layers, hints, owners, local)
    assert_matches(frame, folded)
    np.testing.assert_array_equal(sort_layers(hints, owners, local),
                                  jax_sort_layers(hints, owners, local))
    # the raymarch oracle's layers (one per brick) equal JAX's; it samples
    # the nearest cell only, and both packages refuse trilinear
    if params.sampling == "trilinear":
        with pytest.raises(ValueError, match="requires the slicemarch"):
            renderer.render_layers(geometry, params, camera, bounds, srange,
                                   rsd, 40, 40, None, method="raymarch",
                                   device=CPU)
        return
    got = renderer.render_layers(geometry, params, camera, bounds, srange, rsd,
                                 40, 40, None, method="raymarch", device=CPU)
    want = jax_render_layers(jax_geometry, as_jax(params), as_jax(camera),
                             as_jax(bounds), srange, rsd, 40, 40, None,
                             method="raymarch")
    for g, w in zip(got, want):
        assert_matches(g, w)


def test_transparent_scene_and_antialiasing(scenes):
    """A fully transparent transfer function renders background; AA=4
    renders at 2x and box-filters on the device like the JAX route."""
    jax_geometry, geometry = scenes["r2"]
    params, camera, srange, rsd = frame_args(geometry, KNOBS[0], EYES[1], 32)
    clear = color_map_from_tuples([(0.0, 1, 1, 1, 0.0), (1.0, 1, 1, 1, 0.0)])
    out = renderer_fast.render_composited_slicemarch(
        geometry, params, camera, srange, rsd, 64, 64, clear,
        downsample_block=2, device=CPU)
    assert out.shape == (32 * 32, 5)
    assert (out[:, :4] == 0).all() and np.isinf(out[:, 4]).all()
    got = renderer_fast.render_composited_slicemarch(
        geometry, params, camera, srange, rsd, 64, 64, None,
        downsample_block=2, device=CPU)
    want = jax_rf.render_composited_slicemarch(
        jax_geometry, as_jax(params), as_jax(camera), srange, rsd, 64, 64, None,
        interpret=True, downsample_block=2)
    assert (want[:, 3] > 0).mean() > 0.1
    assert_matches(got, want)
