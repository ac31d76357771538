"""The raymarch march kernel's CPU side (amrvolumerenderer_torch/ops/
raymarch.py and csrc/raymarch.cu): what the kernel's wrapper hands it,
checked without the card.

* On CPU tensors ``render_bucket_into`` runs the plain version and
  launches nothing.
* The kernel reads LUT entries classified once per cell
  (``classify_cells``).  The classification is elementwise, so these
  equal the per-sample classification on every cell; the plain march,
  which classifies each sample, equals the JAX package's
  ``render_bucket_impl`` (jitted on the CPU) bit for bit, over log scale,
  normalisation, the soft clip and 128/256-entry LUTs.
* Both versions write the bucket's rows whole, so the callers' stacks
  start from ``torch.empty``: the sharded frame with padding slots still
  equals JAX's.
* Each C entry point's ``ctypes`` signature (``_build._SIGNATURES``)
  agrees, argument for argument, with its ``extern "C"`` declaration.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amrvolumerenderer_tpu.camera import camera_basis as jax_camera_basis
from amrvolumerenderer_tpu.ops import raymarch as jax_rm
from amrvolumerenderer_tpu.parallel import directsend as jds
from amrvolumerenderer_tpu.renderer import _build_camera_arrays as jax_camera_arrays
from amrvolumerenderer_tpu.types import CameraParameters as JaxCamera
from amrvolumerenderer_torch import renderer
from amrvolumerenderer_torch.camera import camera_basis
from amrvolumerenderer_torch.ops import _build
from amrvolumerenderer_torch.ops import raymarch as rm
from amrvolumerenderer_torch.parallel import directsend as ds
from amrvolumerenderer_torch.types import CameraParameters

from test_torch_raymarch import SIMPLE, assert_same, owned_r2_geometry, sharded_tables
from test_torch_worklist import as_jax, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SCALARS = (0.0, 1.3, 0.05, -1.0, 0.7)  # range min, 1 / span, floor, norm min, 1 / span


def seeded_bucket(seed, lut_size=256):
    """4 bricks of 12x10x9 cells, cropped cell counts, non-finite cells,
    per-brick LUTs and steps (tests/test_torch_raymarch.py's generator)."""
    rng = np.random.default_rng(seed)
    nb, shape = 4, (12, 10, 9)
    data = (rng.random((nb,) + shape) * 2.0 + 0.01).astype(np.float32)
    data[0, 0, 0, 0] = np.nan
    data[1, 1, 1, 1] = -np.inf
    bmin = rng.uniform(-0.2, 0.6, (nb, 3)).astype(np.float32)
    bmax = (bmin + rng.uniform(0.25, 0.7, (nb, 3))).astype(np.float32)
    dims = np.array([[12 - rng.integers(0, 3), 10, 9 - rng.integers(0, 2)]
                     for _ in range(nb)], np.int32)
    lut = rng.random((nb, lut_size, 4)).astype(np.float32)
    lut[..., 3] *= 0.3
    step = rng.uniform(0.01, 0.04, nb).astype(np.float32)
    return data, bmin, bmax, dims, lut, step


def bucket_args(bucket, camera, width, height, flags):
    """(positional, keyword) arguments of ``render_bucket_into`` after
    ``out`` for a bucket seen from ``camera``."""
    data, bmin, bmax, dims, lut, step = bucket
    forward, right, up = jax_camera_basis(JaxCamera(**camera))
    log_scale, normalize, apply_clip = flags
    args = (np.arange(data.shape[0])[::-1].copy(), data, bmin, bmax, dims, lut,
            step, *(np.asarray(v, np.float32) for v in (camera["eye"], forward,
                                                         right, up)),
            camera["fov_y_degrees"], *(float(np.float32(v)) for v in SCALARS))
    kw = dict(width=width, height=height,
              num_steps=rm.max_steps_for_bucket(bmin, bmax, step),
              log_scale=log_scale, normalize=normalize, clip_start=0.8,
              apply_clip=apply_clip)
    return args, kw


def jax_layers(args, kw):
    """JAX's render_brick_bucket on the same bucket, as ``[B, P, 5]`` rows
    in the order of ``args[0]``."""
    jc, jd = jax_rm.render_brick_bucket(
        *(jnp.asarray(a) for a in args[1:11]), jnp.float32(args[11]),
        *(jnp.float32(v) for v in args[12:]), **kw)
    layers = np.concatenate([np.asarray(jc), np.asarray(jd)[..., None]], axis=-1)
    out = np.empty_like(layers)
    out[args[0]] = layers
    return out


def test_cpu_out_runs_the_plain_version_and_launches_nothing():
    """A CPU ``out``: the plain version, every row of the bucket written
    (a NaN-filled stack keeps only its spare row), no kernel launch."""
    args, kw = bucket_args(seeded_bucket(0), SIMPLE, 20, 14, (True, True, True))
    before = rm.render_bucket_into.launches
    got = torch.full((5, 20 * 14, 5), float("nan"))
    rm.render_bucket_into(got, *args, **kw)
    assert rm.render_bucket_into.launches == before
    assert torch.isnan(got[4]).all() and not torch.isnan(got[:4]).any()
    want = torch.full((5, 20 * 14, 5), float("nan"))
    samples = rm.render_bucket_into_reference(want, *args, count_samples=True, **kw)
    assert torch.equal(got[:4], want[:4])
    assert samples.dtype == torch.int64 and int(samples) > 0
    assert (got[:4, :, 3] > 0).float().mean() > 0.02


def test_march_bucket_refuses_what_the_kernel_does_not_take():
    """The launch checks its stack and tables before it builds anything."""
    args, kw = bucket_args(seeded_bucket(1), SIMPLE, 8, 8, (False, False, False))
    bucket = rm._bucket(CPU, args[0], *args[1:7], args[7], args[8:11], args[11],
                        8, 8, False)
    cells = torch.zeros(bucket.data.shape, dtype=torch.int32)
    steps = kw["num_steps"]
    with pytest.raises(ValueError, match="out must be"):
        rm.march_bucket(torch.empty((4, 63, 5)), bucket, cells, steps)
    with pytest.raises(TypeError, match="lut_index has dtype"):
        rm.march_bucket(torch.empty((4, 64, 5)), bucket, cells.long(), steps)
    with pytest.raises(TypeError, match="top has dtype"):
        rm.march_bucket(torch.empty((4, 64, 5)),
                        bucket._replace(top=bucket.top.long()), cells, steps)
    with pytest.raises(ValueError, match="has no kernel"):
        rm.render_bucket_into(torch.empty((4, 64, 5), device="meta"), *args, **kw)


# (seed, lut entries, log scale, normalize, soft clip, fov)
CLASSIFY = [(0, 256, True, True, True, 45.0), (1, 128, True, True, True, 30.0),
            (2, 256, True, False, False, 60.0), (3, 128, False, True, True, 37.0),
            (4, 256, False, False, True, 45.0), (5, 128, False, False, False, 11.628)]


@pytest.mark.parametrize("case", CLASSIFY, ids=lambda c: f"seed{c[0]}-lut{c[1]}")
def test_per_cell_classification_matches_per_sample_and_jax(case):
    """LUT entries classified once per cell (the kernel's input) equal the
    per-sample classification on every cell, and the plain march that
    classifies each sample equals JAX at 0."""
    seed, size, *flags, fov = case
    bucket = seeded_bucket(seed, size)
    args, kw = bucket_args(bucket, dict(SIMPLE, eye=(1.6, 1.2, 1.9),
                                        fov_y_degrees=fov), 24, 20, tuple(flags))
    want = jax_layers(args, kw)
    out = torch.empty((4, 24 * 20, 5))
    assert rm.render_bucket_into_reference(out, *args, **kw) is None
    assert (want[..., 3] > 0).mean() > 0.02
    assert_same(out.numpy(), want)
    # the entries themselves, every cell against the per-sample function
    data = torch.from_numpy(bucket[0])
    classify = rm._classifier(size - 1, *SCALARS[:2], *SCALARS[2:], flags[0],
                              flags[1], 0.8 if flags[2] else None)
    cells = rm.classify_cells(data, classify)
    assert cells.dtype == torch.int32
    assert torch.equal(cells.long(), classify(data))
    assert 0 <= int(cells.min()) <= int(cells.max()) <= size - 1


@pytest.mark.parametrize("size", [(1, 40), (40, 1)], ids=["column", "row"])
def test_axis_aligned_rays_match_jax(size):
    """An axis-aligned camera on a one-pixel-wide (or -high) frame: every
    ray is parallel to one axis, so the slab test's parallel-ray guard
    decides each brick."""
    width, height = size
    bucket = seeded_bucket(6)
    cx, cy = (0.5 * (bucket[1][0, :2] + bucket[2][0, :2])).tolist()  # brick 0
    # a one-pixel-high frame's aspect widens the view 40 times: a narrow fov
    args, kw = bucket_args(bucket, dict(SIMPLE, eye=(cx, cy, 3.0),
                                        look_at=(cx, cy, 0.5),
                                        fov_y_degrees=45.0 if width == 1 else 1.5),
                           width, height, (False, True, False))
    bucket = rm._bucket(CPU, args[0], *args[1:7], args[7], args[8:11], args[11],
                        width, height, False)
    assert (bucket.directions[:, 0 if width == 1 else 1] == 0).all()
    out = torch.empty((4, width * height, 5))
    rm.render_bucket_into(out, *args, **kw)
    want = jax_layers(args, kw)
    assert (want[..., 3] > 0).any()
    assert_same(out.numpy(), want)


@pytest.mark.parametrize("num_devices", [3, 5])
def test_sharded_padding_slots_take_background(num_devices):
    """8 bricks over 3 or 5 shards leave padding slots, which no bucket
    marches: the stack starts empty, so they must be given background."""
    geometry = owned_r2_geometry(num_devices)
    width, height = 30, 20
    camera = CameraParameters(eye=(1.7, 1.3, 2.1), look_at=(0.5, 0.5, 0.5),
                              up=(0, 1, 0), fov_y_degrees=40.0)
    bounds = renderer.compute_global_bounds(geometry)
    rsd = renderer.compute_reference_sample_distance(geometry, bounds)
    srange = geometry.scalar_range
    tables = sharded_tables(geometry, num_devices, camera, srange, rsd)
    assert not tables[6].all()
    t = geometry.scalar_transform
    scalars = (camera.fov_y_degrees, srange[0], 1.0 / (srange[1] - srange[0]),
               (t.positive_floor, t.normalization_min, t.inverse_normalization_span))
    kw = dict(width=width, height=height,
              num_steps=rm.max_steps_for_bucket(tables[1], tables[2], tables[5]),
              log_scale=t.log_scale_input, normalize=t.normalize_to_unit_range,
              clip_start=1.0, apply_clip=False)
    want = np.asarray(jds.render_and_composite_sharded(
        jds.make_mesh(num_devices), *(jnp.asarray(a) for a in tables),
        jax_camera_arrays(as_jax(camera)), *scalars, **kw))
    forward, right, up = camera_basis(camera)
    cams = [np.asarray(v, np.float32) for v in (camera.eye, forward, right, up)]
    got = ds.render_and_composite_sharded(ds.make_mesh(num_devices, "cpu"),
                                          *tables, cams, *scalars, **kw)
    assert (want[:, 3] > 0).mean() > 0.1
    assert_same(np.concatenate([g.numpy() for g in got]), want)


def extern_c_signatures(source: str) -> dict:
    """{function: [ctypes type, ...]} of every ``extern "C"`` function
    defined in a CUDA source."""
    kinds = {"const void*": _build._P, "void*": _build._P, "int": _build._I,
             "float": _build._F, "long long": _build._L}
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{', source,
                                   re.S):
        types = []
        for param in params.split(","):
            words = " ".join(param.split())
            kind = re.sub(r"\s*\w+$", "", words).replace(" *", "*")
            types.append(kinds[kind])
        out[name] = types
    return out


@pytest.mark.parametrize("library,function", [
    (lib, fn) for lib, fns in _build._SIGNATURES.items() for fn in fns])
def test_ctypes_signature_matches_extern_c(library, function):
    with open(os.path.join(_build._CSRC, f"{library}.cu")) as f:
        declared = extern_c_signatures(f.read())
    assert set(declared) == set(_build._SIGNATURES[library])
    assert declared[function] == _build._SIGNATURES[library][function]
