"""Pure-python LZ4 frame/block codec (host copy of roman_tpu/data/lz4.py):
decompression + a literals-only compressor, used by
roman_tpu_torch.data.rosbag for lz4-compressed chunk records (rosbag's
roslz4 writes the standard LZ4 frame format, magic 0x184D2204, spec
v1.4+; reference bags recorded with `rosbag record --lz4` would otherwise
need the lz4 wheel, which the port does not depend on).

The decompressor implements the full block format (literal runs +
overlapping match copies). The compressor emits spec-valid frames whose
blocks are stored as literal runs (no matches) — correct, just not
compact — so `BagWriter(compression='lz4')` produces bags any LZ4
decoder accepts and tests can roundtrip without native lz4. xxh32 is
implemented for the frame-header checksum byte that strict decoders
verify.
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204
_MASK32 = 0xFFFFFFFF

# xxHash32 constants
_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917,
                           668265263, 374761393)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (needed for the LZ4 frame header-checksum byte)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _MASK32
        v2 = (seed + _P2) & _MASK32
        v3 = seed & _MASK32
        v4 = (seed - _P1) & _MASK32
        while i <= n - 16:
            for k, v in enumerate((v1, v2, v3, v4)):
                (lane,) = struct.unpack_from("<I", data, i + 4 * k)
                v = (v + lane * _P2) & _MASK32
                v = (_rotl(v, 13) * _P1) & _MASK32
                if k == 0:
                    v1 = v
                elif k == 1:
                    v2 = v
                elif k == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _MASK32
    else:
        h = (seed + _P5) & _MASK32
    h = (h + n) & _MASK32
    while i <= n - 4:
        (lane,) = struct.unpack_from("<I", data, i)
        h = (h + lane * _P3) & _MASK32
        h = (_rotl(h, 17) * _P4) & _MASK32
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _MASK32
        h = (_rotl(h, 11) * _P1) & _MASK32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _MASK32
    h ^= h >> 13
    h = (h * _P3) & _MASK32
    h ^= h >> 16
    return h


# ---------------------------------------------------------------------------
# block format
# ---------------------------------------------------------------------------

def decompress_block(src: bytes, max_size: int | None = None) -> bytes:
    """LZ4 block decompression: token-driven literal runs + match copies
    (match offsets may overlap the output tail — byte-serial copy)."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break  # last sequence is literals-only
        # match
        (offset,) = struct.unpack_from("<H", src, i)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: offset beyond output")
        if offset >= mlen:
            out += out[start:start + mlen]
        else:  # overlapping copy must be byte-serial
            for k in range(mlen):
                out.append(out[start + k])
        if max_size is not None and len(out) > max_size:
            raise ValueError("LZ4 block exceeds declared size")
    return bytes(out)


def compress_block_stored(src: bytes) -> bytes:
    """A valid LZ4 block that stores `src` as one literal run."""
    lit = len(src)
    if lit < 15:
        return bytes([lit << 4]) + src
    head = bytearray([0xF0])
    rem = lit - 15
    while rem >= 255:
        head.append(255)
        rem -= 255
    head.append(rem)
    return bytes(head) + src


# ---------------------------------------------------------------------------
# frame format
# ---------------------------------------------------------------------------

_BD_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def decompress_frame(buf: bytes) -> bytes:
    """LZ4 frame (magic 0x184D2204) -> content bytes. Checksums are
    skipped over, not verified (read path)."""
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an LZ4 frame (magic {magic:#x})")
    i = 4
    flg = buf[i]
    bd = buf[i + 1]
    i += 2
    version = flg >> 6
    if version != 1:
        raise ValueError(f"unsupported LZ4 frame version {version}")
    block_checksum = bool(flg & 0x10)
    content_size_flag = bool(flg & 0x08)
    content_checksum = bool(flg & 0x04)
    max_block = _BD_SIZES.get((bd >> 4) & 0x7, 1 << 22)
    if content_size_flag:
        i += 8
    i += 1  # header-checksum byte (not verified on read)
    out = bytearray()
    while True:
        (size,) = struct.unpack_from("<I", buf, i)
        i += 4
        if size == 0:
            break
        uncompressed = bool(size & 0x80000000)
        size &= 0x7FFFFFFF
        data = buf[i:i + size]
        i += size
        if block_checksum:
            i += 4
        out += data if uncompressed else decompress_block(data, max_block)
    if content_checksum:
        i += 4
    return bytes(out)


def compress_frame(data: bytes, block_size: int = 1 << 20) -> bytes:
    """Spec-valid LZ4 frame with literal-run blocks (block-independent,
    no block/content checksums; header checksum computed via xxh32)."""
    flg = (1 << 6) | (1 << 5)  # version 01, block-independent
    bd = 7 << 4                # 4 MB max block size class
    header = bytes([flg, bd])
    hc = (xxh32(header) >> 8) & 0xFF
    parts = [struct.pack("<I", _MAGIC), header, bytes([hc])]
    for s in range(0, len(data), block_size):
        chunk = data[s:s + block_size]
        block = compress_block_stored(chunk)
        if len(block) >= len(chunk):  # store uncompressed (high bit set)
            parts.append(struct.pack("<I", len(chunk) | 0x80000000))
            parts.append(chunk)
        else:
            parts.append(struct.pack("<I", len(block)))
            parts.append(block)
    parts.append(struct.pack("<I", 0))  # end mark
    return b"".join(parts)
