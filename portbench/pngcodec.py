"""PNG codec of the benchmark (numpy + zlib; 8-bit RGB and RGBA only).

`encode` writes the corpus' originals: a copy of the port's encoder
(io/pypng.py: per row the filter with the least sum of |int8| residuals,
the first on a tie, then zlib at the given level), so that seed 0's
originals are byte for byte the ones the flagship's record was taken on.
`decode` is the reference's own reader for the slices the program writes.
It undoes the five row filters for all rows at once along anti-diagonals:
pixel (y, x) depends only on (y, x-1), (y-1, x) and (y-1, x-1), so every
pixel of one diagonal is recovered in one vectorized step.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {3: 2, 4: 6}
_CHANNELS = {2: 3, 6: 4}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload)))


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of bytes [H, stride] uint8 -> filtered rows [H, 1 + stride],
    the filter byte first."""
    h = rows.shape[0]
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    cands = np.stack([x, x - left, x - up, x - ((left + up) >> 1),
                      x - paeth]).astype(np.uint8)
    cost = np.abs(cands.view(np.int8).astype(np.int64)).sum(axis=2)
    best = np.argmin(cost, axis=0)
    out = np.empty((h, rows.shape[1] + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = cands[best, np.arange(h)]
    return out


def encode(image: np.ndarray, level: int) -> bytes:
    """uint8 [H, W, 3 or 4] -> PNG bytes."""
    arr = np.ascontiguousarray(image)
    h, w, c = arr.shape
    if arr.dtype != np.uint8 or c not in _COLOR_TYPE:
        raise ValueError(f"encode takes uint8 RGB/RGBA, got {arr.dtype} "
                         f"with {c} channels")
    raw = filter_rows(arr.reshape(h, w * c), c).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def _unfilter(filters: np.ndarray, body: np.ndarray) -> np.ndarray:
    """filters [H] and filtered pixels [H, W, C] uint8 -> pixels."""
    h, w, c = body.shape
    if filters.max(initial=0) > 4:
        raise ValueError("bad PNG filter type")
    rec = np.zeros((h + 1, w + 1, c), np.int16)  # a zero row and column
    f = body.astype(np.int16)
    ftype = filters.astype(np.int64)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - y
        a = rec[y + 1, x]
        b = rec[y, x + 1]
        cc = rec[y, x]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        rec[y + 1, x + 1] = (f[y, x] + pred[ftype[y], np.arange(len(y))]) \
            & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB or RGBA, no interlace) -> uint8 [H, W, C];
    raises ValueError on anything else."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, head = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if zlib.crc32(tag + payload) != struct.unpack_from(
                ">I", data, pos + 8 + length)[0]:
            raise ValueError(f"bad CRC in {tag!r}")
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if head is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = head
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, color {color}, "
                         f"interlace {interlace}")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError("PNG data length mismatch")
    raw = raw.reshape(h, w * c + 1)
    return _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, c))
