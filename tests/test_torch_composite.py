"""The port's tile composite (amrvolumerenderer_torch/ops/composite.py)
against the JAX package's Pallas kernels in interpret mode: the plain
version must match ``composite_tiles`` (L <= 96) and ``composite_tiles_hbm``
(L > 96) at the manifest's atol of 2e-6 with the same non-finite pattern,
on seeded layers with depth ties, same-owner runs, coverage holes and NaN
in every unscheduled block.  ``compositor.sort_layers`` and the host fold
``composite_layers_host`` match their JAX twins array for array."""

import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu import compositor as jax_compositor
from amrvolumerenderer_tpu.ops import composite as jcomp
from amrvolumerenderer_torch import compositor
from amrvolumerenderer_torch.ops import composite as comp
from amrvolumerenderer_torch.ops import slicemarch as sm

from test_torch_worklist import one_torch_thread  # noqa: F401

ATOL = 2e-6


def seeded_layers(num_layers, num_tiles, seed):
    """Layers in tile order with premultiplied colours, depths drawn from a
    few values (so ties are common), owners in runs, and coverage holes
    whose blocks hold NaN (an unscheduled block is undefined)."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.0, 1.0, (num_layers, num_tiles, 1, 8, 128))
    alpha *= rng.uniform(0.0, 1.0, alpha.shape) < 0.7  # transparent pixels
    rgb = rng.uniform(0.0, 1.0, (num_layers, num_tiles, 3, 8, 128)) * alpha
    colors = np.concatenate([rgb, alpha], axis=2).astype(np.float32)
    depths = rng.choice(np.array([0.5, 1.0, 1.25, 2.0, np.inf], np.float32),
                        (num_layers, num_tiles, 8, 128))
    coverage = rng.uniform(0.0, 1.0, (num_layers, num_tiles)) < 0.75
    colors[~coverage] = np.nan
    depths[~coverage] = np.nan
    owners = np.sort(rng.integers(0, max(num_layers // 3, 2), num_layers))
    hints = rng.choice(np.array([0.1, 0.2, 0.3], np.float32), num_layers)
    local = np.arange(num_layers, dtype=np.int32)
    order = jax_compositor.sort_layers(hints, owners, local)
    return colors, depths, order, owners[order].astype(np.int32), coverage


def assert_matches(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=ATOL)


@pytest.mark.parametrize("num_layers,seed", [(5, 0), (5, 1), (100, 2)])
def test_composite_matches_jax_kernel(num_layers, seed):
    colors, depths, order, owners_sorted, coverage = seeded_layers(
        num_layers, 4, seed)
    jax_fn = jcomp.composite_tiles if num_layers <= 96 else jcomp.composite_tiles_hbm
    ref_c, ref_d = jax_fn(colors, depths, order, owners_sorted, coverage,
                          interpret=True)
    port_fn = comp.composite_tiles if num_layers <= 96 else comp.composite_tiles_hbm
    got_c, got_d = port_fn(
        torch.from_numpy(colors), torch.from_numpy(depths),
        torch.from_numpy(order), torch.from_numpy(owners_sorted),
        torch.from_numpy(coverage),
    )
    assert np.isfinite(np.asarray(ref_c)).all()  # premise: NaN never leaks
    assert (np.asarray(ref_c)[:, 3] > 0).mean() > 0.5
    assert_matches(got_c.numpy(), ref_c)
    assert_matches(got_d.numpy(), ref_d)


def test_sort_and_host_fold_match_jax():
    rng = np.random.default_rng(3)
    num_layers, pixels = 7, 96
    layers = rng.uniform(0.0, 1.0, (num_layers, pixels, 5)).astype(np.float32)
    layers[:, :, 4] = rng.choice(np.array([0.5, 1.0, np.inf], np.float32),
                                 (num_layers, pixels))
    hints = rng.choice(np.array([0.1, 0.2], np.float32), num_layers)
    owners = rng.integers(0, 3, num_layers).astype(np.int32)
    local = rng.permutation(num_layers).astype(np.int32)
    np.testing.assert_array_equal(
        compositor.sort_layers(hints, owners, local),
        jax_compositor.sort_layers(hints, owners, local))
    np.testing.assert_array_equal(
        compositor.composite_layers_host(layers, hints, owners, local),
        jax_compositor.composite_layers_host(layers, hints, owners, local))


def test_device_fold_matches_host_oracle():
    """The tile composite of untiled layers is the host fold of
    composeLayered, pixel for pixel."""
    colors, depths, order, owners_sorted, coverage = seeded_layers(6, 2, 4)
    colors[~coverage] = 0.0
    depths[~coverage] = np.inf
    out_c, out_d = comp.composite_reference(
        torch.from_numpy(colors), torch.from_numpy(depths),
        torch.from_numpy(order), torch.from_numpy(owners_sorted),
        torch.from_numpy(coverage))
    frame_c, frame_d = sm.untile(out_c[None], out_d[None], 64, 32)
    lc, ld = sm.untile(torch.from_numpy(colors), torch.from_numpy(depths), 64, 32)
    layers = torch.cat([lc, ld[..., None]], dim=-1).numpy()
    # the fold visits layer order[i] at position i
    hints = np.empty(6, np.float32)
    hints[order] = np.arange(6)
    owners = np.empty(6, np.int32)
    owners[order] = owners_sorted
    ref = compositor.composite_layers_host(layers, hints, owners,
                                           np.zeros(6, np.int32))
    assert_matches(frame_c[0].numpy(), ref[:, :4])
    assert_matches(frame_d[0].numpy(), ref[:, 4])


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        comp.composite_tiles(
            torch.zeros((1, 1, 4, 8, 128), device="meta"),
            torch.zeros((1, 1, 8, 128), device="meta"),
            torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.ones((1, 1), dtype=torch.bool))
