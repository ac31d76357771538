"""Image file output with byte-exact parity to the reference writers.

PPM: binary P6, rows bottom to top, bytes by the Mesa ``clamp(int(c *
256))`` codec (Common/SavePPM.cpp:17-36).  PNG: 8-bit RGB, alpha dropped,
same row order (Common/SavePNG.cpp), written with zlib.  The port of the
JAX package's ``io`` writers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native
from .image import ImageBuffer, color_to_byte


def _rgb_bytes_bottom_up(image: ImageBuffer) -> np.ndarray:
    """[H, W, 3] uint8 with row 0 = top of the file (image row height-1)."""
    w, h = image.width, image.height
    if image.kind.name.startswith("RGBA_U8"):
        rgb = image.pixels[:, :3].astype(np.uint8).reshape(h, w, 3)
    else:
        rgb = color_to_byte(image.pixels[:, :3]).reshape(h, w, 3)
    return rgb[::-1]


def _full_frame(image: ImageBuffer) -> ImageBuffer:
    """Blend a partial-region image onto a cleared frame (SavePPM.cpp:52-64)."""
    if image.region_begin == 0 and image.region_end == image.width * image.height:
        return image
    blank = ImageBuffer.create(image.kind, image.width, image.height)
    blank.clear()
    return image.blend(blank)


def save_ppm(image: ImageBuffer, filename: str) -> bool:
    image = _full_frame(image)
    payload = None
    if not image.kind.name.startswith("RGBA_U8"):
        payload = native.encode_ppm_pixels(
            np.asarray(image.pixels, dtype=np.float32), image.width, image.height
        )
    if payload is None:
        payload = _rgb_bytes_bottom_up(image).tobytes()
    try:
        with open(filename, "wb") as f:
            f.write(f"P6\n{image.width} {image.height}\n255\n".encode())
            f.write(payload)
        return True
    except OSError:
        return False


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    chunk = tag + payload
    return struct.pack(">I", len(payload)) + chunk + struct.pack(
        ">I", zlib.crc32(chunk) & 0xFFFFFFFF
    )


def save_png(image: ImageBuffer, filename: str) -> bool:
    data = _rgb_bytes_bottom_up(_full_frame(image))
    h, w, _ = data.shape
    raw = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8), data.reshape(h, -1)], axis=1
    ).tobytes()  # filter type 0 per row
    try:
        with open(filename, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n")
            f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
            f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
            f.write(_png_chunk(b"IEND", b""))
        return True
    except OSError:
        return False


def save_image(image: ImageBuffer, filename: str) -> bool:
    """Dispatch on extension; unknown extensions default to PPM
    (VolumeRenderer.cpp:1316-1327)."""
    if filename.lower().endswith(".png"):
        return save_png(image, filename)
    return save_ppm(image, filename)
