"""PNG encoding and decoding with zlib and numpy.

The port reads PNG images (``sensor_msgs/CompressedImage`` with format
png, and ``.png`` files in image directories and zips) and writes its
plots as RGB PNG without OpenCV or matplotlib (the machine with the card
has no matplotlib). ``roman_tpu`` decodes with ``cv2.imdecode``; ``decode_png``
returns the same pixels for the images it accepts: gray, gray with alpha,
RGB and RGBA at 8 or 16 bits, not interlaced, with any of the five row
filters. Channels are in RGB(A) order, 16-bit samples as native uint16.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """An (h, w, 3) uint8 RGB image as PNG bytes (filter 0 on every
    row)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.asarray(rgb, np.uint8).reshape(h, 3 * w)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (h, w, 3) uint8 RGB image to `path` as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, stride) uint8 of the raw samples."""
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            row = cur.copy()
        elif ftype == 1:  # sub: a running sum along each byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = cur
            row = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:
            row = cur + prev
        elif ftype in (3, 4):  # average, paeth: sequential along the row
            r = bytearray(cur.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    r[i] = (r[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    r[i] = (r[i] + _paeth(a, up[i], c)) & 0xFF
            row = np.frombuffer(bytes(r), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = row
        prev = row
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (h, w) gray, (h, w, 2) gray and alpha, (h, w, 3) RGB or
    (h, w, 4) RGBA, uint8 or uint16. Raises ValueError for what it does not
    decode (palette or sub-byte images, interlacing, a bad signature)."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG (bad signature)")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not supported "
                         "(gray, gray+alpha, RGB, RGBA at 8 or 16 bits are)")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def to_color(img: np.ndarray) -> np.ndarray:
    """A decoded image as (h, w, 3) uint8 RGB, as cv2.imread(...,
    IMREAD_COLOR) reads a PNG: 16-bit samples keep their high byte, alpha
    is dropped, gray is repeated into three channels."""
    img = np.asarray(img)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
