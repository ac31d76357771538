"""Camera math: view/projection matrices, ray basis, auto-framing orbit.

Reproduces the reference semantics of ``Common/CameraUtils.hpp:16-61``,
``Common/VolumePainter.cpp:518-541`` (perspective matrix) and
``VolumeRenderer/VolumeRenderer.cpp:947-1023`` (seeded random orbit camera),
including an exact ``std::mt19937`` so camera placement is bit-reproducible
against the reference's seed 91021.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .types import CameraParameters, Vec3, VolumeBounds, vec3

K_PI = 3.14159265358979323846


def safe_normalize(v: Vec3) -> Vec3:
    """Normalize, falling back to -z for degenerate input (CameraUtils.hpp:16-22)."""
    v = np.asarray(v, dtype=np.float64)
    length = float(np.linalg.norm(v))
    if length > 0.0 and math.isfinite(length):
        return v / length
    return np.array([0.0, 0.0, -1.0])


def make_view_matrix(eye: Vec3, look_at: Vec3, up: Vec3) -> np.ndarray:
    """Right-handed look-at matrix with the reference's (unusual) element layout.

    The reference stores the camera basis vectors in *columns* and the
    translation in *row* 3 (CameraUtils.hpp:24-61); the visibility ordering
    multiplies it as ``modelview @ corner`` (VisibilityOrdering.cpp:176).  We
    reproduce the exact same element placement so clip-space depths match.
    """
    eye = np.asarray(eye, dtype=np.float64)
    forward = safe_normalize(np.asarray(look_at, dtype=np.float64) - eye)
    right = np.cross(forward, np.asarray(up, dtype=np.float64))
    right_len = float(np.linalg.norm(right))
    if right_len > 0.0 and math.isfinite(right_len):
        right = right / right_len
    else:
        right = np.array([1.0, 0.0, 0.0])
    up_ortho = np.cross(right, forward)

    view = np.eye(4, dtype=np.float32)
    view[0, 0], view[1, 0], view[2, 0] = right.astype(np.float32)
    view[3, 0] = np.float32(-np.dot(right, eye))
    view[0, 1], view[1, 1], view[2, 1] = up_ortho.astype(np.float32)
    view[3, 1] = np.float32(-np.dot(up_ortho, eye))
    view[0, 2], view[1, 2], view[2, 2] = (-forward).astype(np.float32)
    view[3, 2] = np.float32(np.dot(forward, eye))
    view[0, 3] = view[1, 3] = view[2, 3] = 0.0
    view[3, 3] = 1.0
    return view


def make_perspective_matrix(
    fov_y_degrees: float, aspect: float, near_plane: float, far_plane: float
) -> np.ndarray:
    """OpenGL-style perspective matrix (VolumePainter.cpp:518-541)."""
    m = np.eye(4, dtype=np.float32)
    fov_tangent = math.tan(fov_y_degrees * K_PI / 180.0 * 0.5)
    size = near_plane * fov_tangent
    left, right = -size * aspect, size * aspect
    bottom, top = -size, size
    m[0, 0] = 2.0 * near_plane / (right - left)
    m[1, 1] = 2.0 * near_plane / (top - bottom)
    m[0, 2] = (right + left) / (right - left)
    m[1, 2] = (top + bottom) / (top - bottom)
    m[2, 2] = -(far_plane + near_plane) / (far_plane - near_plane)
    m[3, 2] = -1.0
    m[2, 3] = -(2.0 * far_plane * near_plane) / (far_plane - near_plane)
    m[3, 3] = 0.0
    return m


def camera_basis(camera: CameraParameters) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Forward/right/up ray-generation basis (VolumePainter.cpp:631-656)."""
    forward = safe_normalize(camera.look_at - camera.eye)
    right = np.cross(forward, camera.up)
    right_len = float(np.linalg.norm(right))
    if right_len > 0.0 and math.isfinite(right_len):
        right = right / right_len
    else:
        right = np.array([1.0, 0.0, 0.0])
    up = np.cross(right, forward)
    return forward, right, up


class MT19937:
    """Exact 32-bit Mersenne Twister (matches ``std::mt19937``)."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER_MASK = 0x80000000
    LOWER_MASK = 0x7FFFFFFF

    def __init__(self, seed: int):
        self.mt = [0] * self.N
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            self.mt[i] = (
                1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i
            ) & 0xFFFFFFFF
        self.index = self.N

    def _generate(self):
        for i in range(self.N):
            y = (self.mt[i] & self.UPPER_MASK) | (
                self.mt[(i + 1) % self.N] & self.LOWER_MASK
            )
            self.mt[i] = self.mt[(i + self.M) % self.N] ^ (y >> 1)
            if y & 1:
                self.mt[i] ^= self.MATRIX_A
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= self.N:
            self._generate()
        y = self.mt[self.index]
        self.index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def uniform_float(self, lo: float, hi: float) -> float:
        """``std::uniform_real_distribution<float>`` via libstdc++'s
        ``generate_canonical<float, 24>`` (one 32-bit draw scaled by 2^-32)."""
        x = self.next_u32()
        canonical = np.float32(np.float32(x) * np.float32(2.0**-32))
        # libstdc++ guards against canonical == 1.0 by re-drawing; with a
        # 2^-32 scale this cannot exceed 1.0f but can equal it after rounding.
        if canonical >= np.float32(1.0):
            canonical = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
        return float(
            np.float32(lo) + canonical * (np.float32(hi) - np.float32(lo))
        )


def auto_orbit_camera(
    bounds: VolumeBounds,
    camera_seed: int = 91021,
    custom_up: Vec3 | None = None,
) -> CameraParameters:
    """Seeded random orbit camera framing the bounds.

    Reproduces VolumeRenderer.cpp:974-1023: fovY = 45 deg, altitude limited to
    +/- 45 deg, distance = r / tan(fov/2) + max(0.25 r, 0.5), near 0.1,
    far = 4x distance; mt19937 seeded (default 91021) drives azimuth then
    altitude draws.
    """
    center = 0.5 * (bounds.min_corner + bounds.max_corner)
    half_extent = 0.5 * (bounds.max_corner - bounds.min_corner)
    bounding_radius = float(np.linalg.norm(half_extent))
    if bounding_radius <= 0.0:
        bounding_radius = 1.0

    fov_y = K_PI * 0.25
    max_altitude = K_PI * 0.25
    half_fov = fov_y * 0.5
    min_distance = bounding_radius / math.tan(half_fov) if half_fov > 0 else bounding_radius
    safety_margin = max(0.25 * bounding_radius, 0.5)
    camera_distance = min_distance + safety_margin

    rng = MT19937(camera_seed)
    azimuth = rng.uniform_float(0.0, 2.0 * K_PI)
    altitude = rng.uniform_float(-max_altitude, max_altitude)
    cos_alt = math.cos(altitude)

    eye = vec3(
        center[0] + camera_distance * cos_alt * math.sin(azimuth),
        center[1] + camera_distance * math.sin(altitude),
        center[2] + camera_distance * cos_alt * math.cos(azimuth),
    )

    up_vector = vec3(custom_up) if custom_up is not None else vec3(0.0, 1.0, 0.0)
    view_dir = safe_normalize(center - eye)
    if np.linalg.norm(np.cross(view_dir, up_vector)) <= 1e-4:
        up_vector = vec3(0.0, 0.0, 1.0)
        if np.linalg.norm(np.cross(view_dir, up_vector)) <= 1e-4:
            up_vector = vec3(1.0, 0.0, 0.0)
    up_vector = safe_normalize(up_vector)

    return CameraParameters(
        eye=eye,
        look_at=center,
        up=up_vector,
        fov_y_degrees=fov_y * 180.0 / K_PI,
        near_plane=0.1,
        far_plane=camera_distance * 4.0,
    )


def orbit_camera_sequence(
    base: CameraParameters,
    frames: int,
    total_degrees: float = 360.0,
) -> list:
    """``frames`` cameras circling ``base.look_at`` about the up axis.

    Frame ``i`` rotates the base eye by ``i * total_degrees / frames``
    around the axis through the look-at point along ``base.up`` (Rodrigues
    rotation); fov/near/far/up carry over unchanged.  Frame 0 is exactly
    the base camera (angle 0 evaluates to the identity in float), so an
    orbit's first frame is pixel-identical to a single render *on the same
    kernel family* (orbits always render through the fast kernels; a
    single render with ``render_method='auto'`` resolves to the raymarch
    oracle on non-TPU backends, where pixels differ by the oracle's
    half-step quantization).  This is
    the camera path of the reference's rotation miniapp
    (python/examples/render_volume_rotate.py: equal azimuth steps about
    the vertical axis); beyond reference as a product surface.
    """
    if frames <= 0:
        raise ValueError("orbit frames must be positive")
    axis = safe_normalize(base.up)
    look_at = np.asarray(base.look_at, dtype=np.float64)
    offset = np.asarray(base.eye, dtype=np.float64) - look_at
    cameras = []
    for i in range(frames):
        angle = math.radians(total_degrees) * i / frames
        c, s = math.cos(angle), math.sin(angle)
        rotated = (
            offset * c
            + np.cross(axis, offset) * s
            + axis * float(np.dot(axis, offset)) * (1.0 - c)
        )
        cameras.append(
            CameraParameters(
                eye=look_at + rotated,
                look_at=base.look_at,
                up=base.up,
                fov_y_degrees=base.fov_y_degrees,
                near_plane=base.near_plane,
                far_plane=base.far_plane,
            )
        )
    return cameras


def compute_box_depth_hint(
    min_corner: Vec3, max_corner: Vec3, camera: CameraParameters
) -> float:
    """Minimum view-depth over the 8 box corners (VolumeRenderer.cpp:541-553)."""
    view_dir = safe_normalize(camera.look_at - camera.eye)
    min_depth = float("inf")
    for idx in range(8):
        corner = np.array(
            [
                max_corner[0] if idx & 1 else min_corner[0],
                max_corner[1] if idx & 2 else min_corner[1],
                max_corner[2] if idx & 4 else min_corner[2],
            ]
        )
        min_depth = min(min_depth, float(np.dot(corner - camera.eye, view_dir)))
    return min_depth


def compute_box_depth_hints(
    min_corners: np.ndarray, max_corners: np.ndarray, camera: CameraParameters
) -> np.ndarray:
    """Vectorized ``compute_box_depth_hint`` over [B, 3] corner arrays."""
    view_dir = safe_normalize(camera.look_at - camera.eye)
    min_corners = np.asarray(min_corners, float)
    max_corners = np.asarray(max_corners, float)
    sel = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], bool)
    corners = np.where(sel[None], max_corners[:, None, :], min_corners[:, None, :])
    depths = (corners - camera.eye[None, None, :]) @ view_dir
    return depths.min(axis=1).astype(np.float32)
