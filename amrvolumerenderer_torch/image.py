"""Image buffers, the byte codec and the blend rules the overlay and IO use.

The NumPy parts of the JAX package's ``image.py`` (``ImageKind``,
``ImageBuffer``, ``color_to_byte`` and the per-kind blends), plus
``color_to_byte_device`` and ``byte_to_color_device``, the byte codec's
torch twins for tensors on the device.
A pixel buffer is a ``[num_pixels, C]`` array with the reference's
flat-pixel region window ``[region_begin, region_end)``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


class ImageKind(enum.Enum):
    RGBA_F32_DEPTH_SORT = "rgba_f32_depth_sort"  # premultiplied RGBA + depth
    RGBA_F32 = "rgba_f32"
    RGBA_U8 = "rgba_u8"
    RGBA_U8_DEPTH_F32 = "rgba_u8_depth_f32"
    RGB_F32_DEPTH_F32 = "rgb_f32_depth_f32"


_CHANNELS = {
    ImageKind.RGBA_F32_DEPTH_SORT: 5,
    ImageKind.RGBA_F32: 4,
    ImageKind.RGBA_U8: 4,
    ImageKind.RGBA_U8_DEPTH_F32: 5,
    ImageKind.RGB_F32_DEPTH_F32: 4,
}


def color_to_byte(c):
    """Mesa-compatible float->byte conversion: ``clamp(int(c * 256))``
    (Common/Color.hpp:66-91)."""
    tv = np.asarray(np.asarray(c, dtype=np.float32) * np.float32(256.0)).astype(
        np.int32
    )
    return np.clip(tv, 0, 255).astype(np.uint8)


def color_to_byte_device(colors: torch.Tensor) -> torch.Tensor:
    """``color_to_byte`` on a float32 tensor, on its device: float32
    multiply, truncation, clamp.  Out-of-range and NaN inputs saturate as
    in the JAX package's device codec (NaN -> 0)."""
    scaled = torch.nan_to_num(colors * 256.0, nan=0.0).clamp(-1.0, 256.0)
    return torch.clamp(scaled.to(torch.int32), 0, 255).to(torch.uint8)


_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def byte_to_color_device(b: torch.Tensor) -> torch.Tensor:
    """Byte -> float ``b / 255`` on the tensor's device (Common/Color.hpp:
    36-64), rounded as the JAX package's device twin runs: every caller
    jits it, and XLA:CPU compiles the division by the constant 255 into a
    multiply by its float32 reciprocal (read off the optimised HLO; up to
    6e-8 from an IEEE division).  A uint8 input lands in [0, 1], so the
    host codec's clip is the identity here."""
    return b.to(torch.float32) * _INV_255


# Pixel-wise blend rules: ``top`` is blended on top of ``bottom``.


def blend_depth_sort(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Depth-hint sorted over blend of [r, g, b, a, depth] pixels: the
    nearer pixel is front; ties keep ``top`` (ImageRGBAFloatColorDepthSort
    .hpp:13-27)."""
    top_is_front = top[..., 4:5] <= bottom[..., 4:5]
    front = np.where(top_is_front, top, bottom)
    back = np.where(top_is_front, bottom, top)
    out_rgba = front[..., :4] + back[..., :4] * (1.0 - front[..., 3:4])
    out_d = np.minimum(top[..., 4:5], bottom[..., 4:5])
    return np.concatenate([out_rgba, out_d], axis=-1)


def blend_over(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Ordered over blend of premultiplied RGBA."""
    return top + bottom * (1.0 - top[..., 3:4])


def blend_over_bytes(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Byte-space over blend with integer truncation."""
    t = top.astype(np.int32)
    b = bottom.astype(np.int32)
    out = t + (b * (255 - t[..., 3:4])) // 255
    return np.clip(out, 0, 255).astype(np.uint8)


def blend_z_compare(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Closest-depth select (depth last); ties keep ``top``."""
    return np.where(top[..., -1:] <= bottom[..., -1:], top, bottom)


def blend_pixels(kind: ImageKind, top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    if kind == ImageKind.RGBA_F32_DEPTH_SORT:
        return blend_depth_sort(top, bottom)
    if kind == ImageKind.RGBA_F32:
        return blend_over(top, bottom)
    if kind == ImageKind.RGBA_U8:
        return blend_over_bytes(top, bottom)
    return blend_z_compare(top, bottom)


@dataclasses.dataclass
class ImageBuffer:
    """Flat pixel rows for ``[region_begin, region_end)`` of a
    ``width x height`` frame (Image.hpp:90-110)."""

    kind: ImageKind
    width: int
    height: int
    pixels: np.ndarray  # [region_end - region_begin, C]
    region_begin: int = 0
    region_end: Optional[int] = None

    def __post_init__(self):
        if self.region_end is None:
            self.region_end = self.width * self.height
        assert self.pixels.shape == (
            self.region_end - self.region_begin,
            _CHANNELS[self.kind],
        ), (self.pixels.shape, self.region_begin, self.region_end)

    @classmethod
    def create(
        cls,
        kind: ImageKind,
        width: int,
        height: int,
        region_begin: int = 0,
        region_end: Optional[int] = None,
    ) -> "ImageBuffer":
        if region_end is None:
            region_end = width * height
        dtype = np.uint8 if kind == ImageKind.RGBA_U8 else np.float32
        pixels = np.zeros((region_end - region_begin, _CHANNELS[kind]), dtype)
        return cls(kind, width, height, pixels, region_begin, region_end)

    @property
    def num_pixels(self) -> int:
        return self.region_end - self.region_begin

    def clear(self, rgba=(0.0, 0.0, 0.0, 0.0), depth: float = 1.0) -> None:
        rgba = np.asarray(rgba, dtype=np.float32)
        if self.kind == ImageKind.RGBA_U8:
            self.pixels[:] = color_to_byte(rgba)[None, :]
        elif self.kind == ImageKind.RGBA_U8_DEPTH_F32:
            self.pixels[:, :4] = color_to_byte(rgba).astype(np.float32)[None, :]
            self.pixels[:, 4] = depth
        elif self.kind == ImageKind.RGB_F32_DEPTH_F32:
            self.pixels[:, :3] = rgba[:3][None, :]
            self.pixels[:, 3] = depth
        elif self.kind == ImageKind.RGBA_F32_DEPTH_SORT:
            self.pixels[:, :4] = rgba[None, :]
            self.pixels[:, 4] = np.inf
        else:
            self.pixels[:] = rgba[None, :]

    def blend(self, bottom: "ImageBuffer") -> "ImageBuffer":
        """Blend self on top of ``bottom`` with union-region semantics
        (ImageColorOnly.hpp:119-199): non-overlapping parts are copied
        through, the overlap is blended."""
        assert self.kind == bottom.kind
        begin = min(self.region_begin, bottom.region_begin)
        end = max(self.region_end, bottom.region_end)
        out = np.zeros((end - begin, self.pixels.shape[1]), self.pixels.dtype)
        ov_begin = max(self.region_begin, bottom.region_begin)
        ov_end = min(self.region_end, bottom.region_end)
        for img in (self, bottom):
            if img.region_begin < ov_begin:
                out[img.region_begin - begin: ov_begin - begin] = img.pixels[
                    : ov_begin - img.region_begin
                ]
            if img.region_end > ov_end:
                out[ov_end - begin: img.region_end - begin] = img.pixels[
                    ov_end - img.region_begin:
                ]
        if ov_end > ov_begin:
            out[ov_begin - begin: ov_end - begin] = blend_pixels(
                self.kind,
                self.pixels[ov_begin - self.region_begin: ov_end - self.region_begin],
                bottom.pixels[
                    ov_begin - bottom.region_begin: ov_end - bottom.region_begin
                ],
            )
        return ImageBuffer(self.kind, self.width, self.height, out, begin, end)
