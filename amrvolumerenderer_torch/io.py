"""Image files with byte-exact parity to the reference writers.

PPM: binary P6, rows bottom to top, bytes by the Mesa ``clamp(int(c *
256))`` codec (Common/SavePPM.cpp:17-36).  PNG: 8-bit RGB, alpha dropped,
same row order (Common/SavePNG.cpp), written with zlib.  The port of the
JAX package's ``io``: the writers and the readers the tests and the
golden comparison use.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

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


def load_ppm(filename: str) -> Tuple[np.ndarray, int, int]:
    """Read a binary P6 file back into an [H, W, 3] float array in [0, 1]
    with row 0 = image row 0 (the bottom)."""
    with open(filename, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P6":
            raise ValueError(f"not a binary PPM: magic {magic!r}")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = [int(t) for t in line.split()]
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), dtype=np.uint8).reshape(h, w, 3)
    # file rows are top of frame first, image row h-1 first: flip back
    return data[::-1].astype(np.float32) / float(maxval), w, h


def load_png(filename: str) -> Tuple[np.ndarray, int, int]:
    """Minimal PNG reader: non-interlaced 8-bit RGB with every filter type
    (0 none, 1 sub, 2 up, 3 average, 4 paeth), since external encoders
    pick filters per row.  Returns [H, W, 3] in [0, 1], row 0 the bottom."""
    with open(filename, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise ValueError("not a PNG file")
        idat = b""
        w = h = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack(">I", header[:4])
            tag = header[4:]
            payload = f.read(length)
            f.read(4)  # crc
            if tag == b"IHDR":
                (w, h, bit_depth, color_type, compression, filter_method,
                 interlace) = struct.unpack(">IIBBBBB", payload[:13])
                # full-width scanlines only: an interlaced file would
                # decode to garbage, so refuse all but baseline 8-bit RGB
                if bit_depth != 8 or color_type != 2:
                    raise ValueError(
                        f"unsupported PNG: bit depth {bit_depth}, color "
                        f"type {color_type} (need 8-bit RGB)")
                if compression != 0 or filter_method != 0 or interlace != 0:
                    raise ValueError(
                        "unsupported PNG: compression/filter/interlace = "
                        f"{compression}/{filter_method}/{interlace} "
                        "(need 0/0/0, non-interlaced baseline)")
            elif tag == b"IDAT":
                idat += payload
            elif tag == b"IEND":
                break
    raw = zlib.decompress(idat)
    stride = w * 3
    rows = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int32)
    pos = 0
    for row in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], dtype=np.uint8).astype(
            np.int32)
        pos += 1 + stride
        if ftype == 0:
            out = line
        elif ftype == 1:  # sub: mod-256 addition is associative, a cumsum
            out = line.reshape(-1, 3).cumsum(axis=0).reshape(-1) % 256
        elif ftype == 2:  # up
            out = (line + prev) % 256
        elif ftype == 3:  # average of left and up, floored
            out = line.copy()
            for i in range(stride):
                left = out[i - 3] if i >= 3 else 0
                out[i] = (out[i] + (left + prev[i]) // 2) % 256
        elif ftype == 4:  # paeth predictor (RFC 2083 section 6.6)
            out = line.copy()
            for i in range(stride):
                a = out[i - 3] if i >= 3 else 0
                b = prev[i]
                c = prev[i - 3] if i >= 3 else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                if pa <= pb and pa <= pc:
                    pred = a
                elif pb <= pc:
                    pred = b
                else:
                    pred = c
                out[i] = (out[i] + pred) % 256
        else:
            raise ValueError(f"unknown PNG filter {ftype}")
        rows[row] = out.astype(np.uint8)
        prev = rows[row].astype(np.int32)
    return rows.reshape(h, w, 3)[::-1].astype(np.float32) / 255.0, w, h
