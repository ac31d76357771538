"""Image buffers, the byte codec and the blend rules.

The port of the JAX package's ``image.py``: ``ImageKind``, the byte codec
(``color_to_byte``, ``byte_to_color`` and their torch twins for tensors on
the device), the per-kind blends (on NumPy arrays or tensors, as the JAX
ones take NumPy or jnp arrays), ``Viewport``, ``ImageBuffer`` (the
reference's ``Image`` contracts, Common/Image.hpp) and ``CompactImage``
(the bounding-range stand-in for its run-length sparse images).  A pixel
buffer is a ``[num_pixels, C]`` array with the reference's flat-pixel
region window ``[region_begin, region_end)``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


def _xp(a):
    """NumPy for host arrays, torch for tensors."""
    return np if isinstance(a, np.ndarray) else torch


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


def byte_to_color(b):
    """Byte->float conversion ``b / 255`` (Common/Color.hpp:36-64)."""
    return np.clip(np.asarray(b, dtype=np.float32) / np.float32(255.0), 0.0, 1.0)


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


def blend_depth_sort(top, bottom):
    """Depth-hint sorted over blend of [r, g, b, a, depth] pixels: the
    nearer pixel is front; ties keep ``top`` (ImageRGBAFloatColorDepthSort
    .hpp:13-27).  NumPy arrays or tensors."""
    xp = _xp(top)
    top_is_front = top[..., 4:5] <= bottom[..., 4:5]
    front = xp.where(top_is_front, top, bottom)
    back = xp.where(top_is_front, bottom, top)
    out_rgba = front[..., :4] + back[..., :4] * (1.0 - front[..., 3:4])
    out_d = xp.minimum(top[..., 4:5], bottom[..., 4:5])
    return xp.concatenate([out_rgba, out_d], axis=-1)


def blend_over(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Ordered over blend of premultiplied RGBA."""
    return top + bottom * (1.0 - top[..., 3:4])


def blend_over_bytes(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """Byte-space over blend with integer truncation."""
    t = top.astype(np.int32)
    b = bottom.astype(np.int32)
    out = t + (b * (255 - t[..., 3:4])) // 255
    return np.clip(out, 0, 255).astype(np.uint8)


def blend_z_compare(top, bottom):
    """Closest-depth select (depth last); ties keep ``top``.  NumPy arrays
    or tensors."""
    return _xp(top).where(top[..., -1:] <= bottom[..., -1:], top, bottom)


def blend_pixels(kind: ImageKind, top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    if kind == ImageKind.RGBA_F32_DEPTH_SORT:
        return blend_depth_sort(top, bottom)
    if kind == ImageKind.RGBA_F32:
        return blend_over(top, bottom)
    if kind == ImageKind.RGBA_U8:
        return blend_over_bytes(top, bottom)
    return blend_z_compare(top, bottom)


_ORDER_DEPENDENT = {
    ImageKind.RGBA_F32_DEPTH_SORT: True,
    ImageKind.RGBA_F32: True,
    ImageKind.RGBA_U8: True,
    ImageKind.RGBA_U8_DEPTH_F32: False,
    ImageKind.RGB_F32_DEPTH_F32: False,
}


@dataclasses.dataclass
class Viewport:
    """Integer pixel rectangle, bounds inclusive (Common/Viewport.hpp)."""

    min_x: int
    min_y: int
    max_x: int
    max_y: int

    def valid(self) -> bool:
        return self.min_x <= self.max_x and self.min_y <= self.max_y

    def intersect(self, other: "Viewport") -> "Viewport":
        return Viewport(max(self.min_x, other.min_x), max(self.min_y, other.min_y),
                        min(self.max_x, other.max_x), min(self.max_y, other.max_y))

    def union(self, other: "Viewport") -> "Viewport":
        return Viewport(min(self.min_x, other.min_x), min(self.min_y, other.min_y),
                        max(self.max_x, other.max_x), max(self.max_y, other.max_y))


@dataclasses.dataclass
class ImageBuffer:
    """Flat pixel rows for ``[region_begin, region_end)`` of a
    ``width x height`` frame (Image.hpp:90-110), with the valid viewport
    the sparse compaction clips to (default: the whole frame)."""

    kind: ImageKind
    width: int
    height: int
    pixels: np.ndarray  # [region_end - region_begin, C]
    region_begin: int = 0
    region_end: Optional[int] = None
    valid_viewport: Optional[Viewport] = None

    def __post_init__(self):
        if self.region_end is None:
            self.region_end = self.width * self.height
        if self.valid_viewport is None:
            self.valid_viewport = Viewport(0, 0, self.width - 1, self.height - 1)
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

    def blend_is_order_dependent(self) -> bool:
        return _ORDER_DEPENDENT[self.kind]

    def pixel_index(self, x: int, y: int) -> int:
        return y * self.width + x - self.region_begin

    def get_color(self, x: int, y: int) -> np.ndarray:
        px = np.asarray(self.pixels[self.pixel_index(x, y)])
        if self.kind == ImageKind.RGBA_U8:
            return byte_to_color(px)
        if self.kind == ImageKind.RGBA_U8_DEPTH_F32:
            return byte_to_color(px[:4])
        if self.kind == ImageKind.RGB_F32_DEPTH_F32:
            return np.concatenate([px[:3].astype(np.float32), [np.float32(1.0)]])
        return px[:4].astype(np.float32)

    def set_color(self, x: int, y: int, rgba) -> None:
        idx = self.pixel_index(x, y)
        rgba = np.asarray(rgba, dtype=np.float32)
        if self.kind == ImageKind.RGBA_U8:
            self.pixels[idx] = color_to_byte(rgba)
        elif self.kind == ImageKind.RGBA_U8_DEPTH_F32:
            self.pixels[idx, :4] = color_to_byte(rgba).astype(np.float32)
        elif self.kind == ImageKind.RGB_F32_DEPTH_F32:
            self.pixels[idx, :3] = rgba[:3]
        elif self.kind == ImageKind.RGBA_F32_DEPTH_SORT:
            self.pixels[idx, :4] = rgba
            self.pixels[idx, 4] = np.inf
        else:
            self.pixels[idx] = rgba

    def get_depth(self, x: int, y: int) -> float:
        if self.kind in (ImageKind.RGBA_U8_DEPTH_F32, ImageKind.RGB_F32_DEPTH_F32,
                         ImageKind.RGBA_F32_DEPTH_SORT):
            return float(self.pixels[self.pixel_index(x, y), -1])
        return 1.0

    def set_depth(self, x: int, y: int, depth: float) -> None:
        if self.kind in (ImageKind.RGBA_U8_DEPTH_F32, ImageKind.RGB_F32_DEPTH_F32,
                         ImageKind.RGBA_F32_DEPTH_SORT):
            self.pixels[self.pixel_index(x, y), -1] = depth

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

    def window(self, sub_begin: int, sub_end: int) -> "ImageBuffer":
        """Shallow view of a subrange, offsets relative to this region
        (the Image.hpp window contract)."""
        assert 0 <= sub_begin <= sub_end <= self.num_pixels
        return ImageBuffer(self.kind, self.width, self.height,
                           self.pixels[sub_begin:sub_end],
                           self.region_begin + sub_begin,
                           self.region_begin + sub_end, self.valid_viewport)

    def copy_subrange(self, sub_begin: int, sub_end: int) -> "ImageBuffer":
        w = self.window(sub_begin, sub_end)
        return dataclasses.replace(w, pixels=np.array(w.pixels))

    def deep_copy(self) -> "ImageBuffer":
        return self.copy_subrange(0, self.num_pixels)

    def blend(self, bottom: "ImageBuffer") -> "ImageBuffer":
        """Blend self on top of ``bottom`` with union-region semantics
        (ImageColorOnly.hpp:119-199): non-overlapping parts are copied
        through, the overlap is blended; the regions must touch or
        overlap."""
        assert self.kind == bottom.kind
        assert self.region_begin <= bottom.region_end
        assert bottom.region_begin <= self.region_end
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
        return ImageBuffer(self.kind, self.width, self.height, out, begin, end,
                           self.valid_viewport.intersect(bottom.valid_viewport))

    def compress(self) -> "CompactImage":
        return CompactImage.from_buffer(self)


@dataclasses.dataclass
class CompactImage:
    """Bounding-range compaction: the stand-in for the reference's
    run-length sparse images (``Common/ImageSparse*``).  One dense run of
    pixels covers every foreground pixel inside the valid viewport; every
    operation costs O(active pixels), not O(region)."""

    kind: ImageKind
    width: int
    height: int
    region_begin: int
    region_end: int
    active_begin: int  # flat pixel index of the first kept pixel
    pixels: np.ndarray  # [active_count, C]
    valid_viewport: Viewport

    @staticmethod
    def _background_mask(buf: ImageBuffer) -> np.ndarray:
        if buf.kind in (ImageKind.RGBA_F32, ImageKind.RGBA_F32_DEPTH_SORT):
            return buf.pixels[:, 3] <= 0.0
        if buf.kind == ImageKind.RGBA_U8:
            return buf.pixels[:, 3] == 0
        # colour-depth images: background is not closer than the far plane
        return buf.pixels[:, -1] >= 1.0

    @classmethod
    def from_buffer(cls, buf: ImageBuffer) -> "CompactImage":
        """Keep the run from the first to the last foreground pixel inside
        the valid viewport (ImageSparseColorOnly.hpp:98-199)."""
        mask = ~cls._background_mask(buf)
        idx = np.arange(buf.region_begin, buf.region_end)
        xs, ys = idx % buf.width, idx // buf.width
        vp = buf.valid_viewport
        mask = mask & ((xs >= vp.min_x) & (xs <= vp.max_x)
                       & (ys >= vp.min_y) & (ys <= vp.max_y))
        if not np.any(mask):
            return cls(buf.kind, buf.width, buf.height, buf.region_begin,
                       buf.region_end, buf.region_begin, buf.pixels[:0], vp)
        first = int(np.argmax(mask))
        last = int(len(mask) - np.argmax(mask[::-1]))
        return cls(buf.kind, buf.width, buf.height, buf.region_begin,
                   buf.region_end, buf.region_begin + first,
                   np.array(buf.pixels[first:last]), vp)

    def uncompress(self) -> ImageBuffer:
        out = ImageBuffer.create(self.kind, self.width, self.height,
                                 self.region_begin, self.region_end)
        out.clear()
        begin = self.active_begin - self.region_begin
        out.pixels[begin:begin + len(self.pixels)] = self.pixels
        out.valid_viewport = self.valid_viewport
        return out

    @property
    def active_end(self) -> int:
        return self.active_begin + len(self.pixels)

    @property
    def num_pixels(self) -> int:
        return self.region_end - self.region_begin

    def _background_row(self) -> np.ndarray:
        """One cleared pixel of this kind (as ``ImageBuffer.clear``)."""
        buf = ImageBuffer.create(self.kind, 1, 1)
        buf.clear()
        return buf.pixels[0]

    def _dense_active(self, begin: int, end: int) -> np.ndarray:
        """[begin, end) of the active domain: stored pixels where covered,
        background elsewhere."""
        out = np.tile(self._background_row(), (end - begin, 1))
        lo, hi = max(self.active_begin, begin), min(self.active_end, end)
        if hi > lo:
            out[lo - begin:hi - begin] = self.pixels[
                lo - self.active_begin:hi - self.active_begin]
        return out

    def window(self, sub_begin: int, sub_end: int) -> "CompactImage":
        """Shallow compact view of a subrange, offsets relative to this
        region (ImageSparseColorOnly.hpp:386-442)."""
        assert 0 <= sub_begin <= sub_end <= self.num_pixels
        begin, end = self.region_begin + sub_begin, self.region_begin + sub_end
        a0 = min(max(self.active_begin, begin), end)
        a1 = max(min(self.active_end, end), a0)
        if a1 == a0:  # empty: anchored at the region start
            return CompactImage(self.kind, self.width, self.height, begin, end,
                                begin, self.pixels[:0], self.valid_viewport)
        return CompactImage(self.kind, self.width, self.height, begin, end, a0,
                            self.pixels[a0 - self.active_begin:a1 - self.active_begin],
                            self.valid_viewport)

    def copy_subrange(self, sub_begin: int, sub_end: int) -> "CompactImage":
        w = self.window(sub_begin, sub_end)
        return dataclasses.replace(w, pixels=np.array(w.pixels))

    def deep_copy(self) -> "CompactImage":
        return self.copy_subrange(0, self.num_pixels)

    def blend(self, bottom: "CompactImage") -> "CompactImage":
        """Blend self over ``bottom`` in the compact domain, with
        ``ImageBuffer.blend``'s union-region semantics; the work is the
        span of the two active runs (ImageSparseColorOnly.hpp:214-382)."""
        assert self.kind == bottom.kind
        assert self.width == bottom.width and self.height == bottom.height
        region_begin = min(self.region_begin, bottom.region_begin)
        region_end = max(self.region_end, bottom.region_end)
        vp = self.valid_viewport.intersect(bottom.valid_viewport)
        nonempty = [im for im in (self, bottom) if len(im.pixels)]
        if not nonempty:
            return CompactImage(self.kind, self.width, self.height, region_begin,
                                region_end, region_begin, self.pixels[:0], vp)
        a0 = min(im.active_begin for im in nonempty)
        a1 = max(im.active_end for im in nonempty)
        out = blend_pixels(self.kind, self._dense_active(a0, a1),
                           bottom._dense_active(a0, a1))
        return CompactImage(self.kind, self.width, self.height, region_begin,
                            region_end, a0, out, vp)
