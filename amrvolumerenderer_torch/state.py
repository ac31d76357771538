"""Carry a prepared scene across packages: state dict <-> renderer.

A renderer has no weights; its state is the packed scene.  ``STATE_KEYS``
lists it: the canonical piece table ``[L, 32, 32, 32]`` (float32, or
bfloat16), the piece boxes, core dims, parents and owners, the parent
(brick) boxes, the log-LUT ``[4, size // 128, 128]`` and its alpha column,
the scalar range, the reference sample distance, the ghost width and the
padded and tight bounds (each ``[2, 3]``: min, max).  ``OPTIONAL_KEYS``
adds what a renderer has when it has it: the piece-visibility mask (which
``set_transfer_function`` changes), the per-piece value ranges it is
derived from, and the storage precision.

A bfloat16 table is carried as the JAX package holds it: NumPy's view of
a JAX bfloat16 array has the ``bfloat16`` dtype of ``ml_dtypes``, which
``torch`` does not take, so the port reads its 16-bit patterns and
reinterprets them (``_canonical_tensor``) without importing ml_dtypes.  The
port's own bfloat16 table goes out as its float32 widening, which is
exact, with ``precision`` saying how to store it.

``state_from_renderer`` reads those attributes with NumPy from any object
that has them (a JAX ``FastSceneRenderer`` or the port's);
``renderer_from_state`` builds the port's renderer from them.
``geometry_from`` does the same for a built scene: the port's
``SceneGeometry`` from any object with the JAX geometry's attributes.
"""

from __future__ import annotations

from typing import Dict

import dataclasses

import numpy as np
import torch

from .device import DEFAULT_DEVICE, Device
from .fast_scene import FastSceneRenderer
from .types import (
    Brick,
    RenderParameters,
    ScalarTransform,
    SceneGeometry,
    VolumeBounds,
)

# state key -> renderer attribute
STATE_KEYS = {
    "canonical": "canonical",
    "box_min": "box_min",
    "box_max": "box_max",
    "dims_world": "dims_world",
    "parents": "parents",
    "owners": "owners",
    "parent_min": "_parent_min",
    "parent_max": "_parent_max",
    "lut": "_lut",
    "lut_alpha": "_lut_alpha",
    "scalar_range": "scalar_range",
    "reference_sample_distance": "reference_sample_distance",
    "ghost": "ghost",
    "bounds": "bounds",
    "tight_bounds": "tight_bounds",
}
OPTIONAL_KEYS = {
    "visible": "visible",
    "piece_ranges": "piece_ranges",
    "precision": "precision",
}


def _to_numpy(value) -> np.ndarray:
    if hasattr(value, "min_corner"):  # VolumeBounds of either package
        return np.stack([value.min_corner, value.max_corner])
    if hasattr(value, "detach"):  # torch tensor on any device
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()  # exact; ``precision`` keeps the storage
        return value.numpy()
    return np.asarray(value)


def _canonical_tensor(canonical) -> torch.Tensor:
    """The canonical table as a CPU tensor of its own dtype: float32, or
    bfloat16 from an ``ml_dtypes`` bfloat16 array (its 16-bit patterns,
    reinterpreted)."""
    arr = np.asarray(canonical)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


def state_from_renderer(obj) -> Dict[str, np.ndarray]:
    """The packed-scene state of ``obj`` as NumPy arrays (and, for the
    optional keys it has, its visibility mask, piece ranges and
    precision)."""
    state = {key: _to_numpy(getattr(obj, attr)) for key, attr in STATE_KEYS.items()}
    for key, attr in OPTIONAL_KEYS.items():
        value = getattr(obj, attr, None)
        if value is not None:
            state[key] = value if key == "precision" else _to_numpy(value)
    return state


def renderer_from_state(
    state: Dict[str, np.ndarray],
    parameters: RenderParameters,
    device: Device = DEFAULT_DEVICE,
) -> FastSceneRenderer:
    """A port ``FastSceneRenderer`` over ``state`` on ``device``.  The
    parameters' sampling must match the state's ghost width (1 for
    trilinear, 0 for nearest) and its lut_size the LUT's."""
    missing = sorted(set(STATE_KEYS) - set(state))
    if missing:
        raise KeyError(f"state lacks {missing}")
    ghost = int(state["ghost"])
    if ghost != (1 if parameters.sampling == "trilinear" else 0):
        raise ValueError(
            f"state has ghost width {ghost}, which does not match "
            f"sampling={parameters.sampling!r}"
        )
    lut = np.asarray(state["lut"], np.float32)
    if lut.shape[1] * lut.shape[2] != parameters.lut_size:
        raise ValueError(
            f"state LUT has {lut.shape[1] * lut.shape[2]} entries, "
            f"parameters ask for {parameters.lut_size}"
        )
    tables = {key: np.asarray(state[key]) for key in STATE_KEYS}
    tables["canonical"] = _canonical_tensor(state["canonical"])
    for key in OPTIONAL_KEYS:
        if state.get(key) is not None:
            tables[key] = state[key]
    if "precision" in tables:
        tables["precision"] = str(tables["precision"])
    tables["lut"] = lut
    tables["ghost"] = ghost
    tables["scalar_range"] = tuple(float(v) for v in tables["scalar_range"])
    tables["reference_sample_distance"] = float(tables["reference_sample_distance"])
    for key in ("bounds", "tight_bounds"):
        b = np.asarray(tables[key], np.float64)
        tables[key] = VolumeBounds(b[0], b[1])
    return FastSceneRenderer.from_tables(parameters, device=device, **tables)


def geometry_from(obj) -> SceneGeometry:
    """The port's ``SceneGeometry`` (bricks, bounds, ranges, transform)
    from any object with the JAX ``SceneGeometry``'s attributes.  Brick
    data arrays are shared, not copied."""
    bounds = obj.explicit_bounds
    transform = obj.scalar_transform
    return SceneGeometry(
        bricks=[
            Brick(data=np.asarray(b.data), min_corner=b.min_corner,
                  max_corner=b.max_corner, level=int(b.level),
                  owner=int(b.owner))
            for b in obj.bricks
        ],
        explicit_bounds=(
            None if bounds is None
            else VolumeBounds(bounds.min_corner, bounds.max_corner)
        ),
        scalar_range=tuple(obj.scalar_range),
        has_scalar_range=bool(obj.has_scalar_range),
        processed_scalar_range=tuple(obj.processed_scalar_range),
        has_processed_scalar_range=bool(obj.has_processed_scalar_range),
        original_scalar_range=tuple(obj.original_scalar_range),
        has_original_scalar_range=bool(obj.has_original_scalar_range),
        scalar_transform=ScalarTransform(**{
            f.name: getattr(transform, f.name)
            for f in dataclasses.fields(ScalarTransform)
        }),
    )
