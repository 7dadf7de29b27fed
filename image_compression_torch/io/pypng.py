"""PNG codec in pure Python (zlib + numpy): the port's PNG path.

Scope: bit depth 8/16, color types 0 (gray) / 2 (RGB) / 4 (gray+alpha) /
6 (RGBA), no interlace, no palette. Encoding picks, per row, the reference
native encoder's filter (native/pngio.cpp, copied as csrc/pngio.cpp): the
one among None, Sub, Up, Avg and Paeth with the least sum of |int8|
residuals, the first such on a tie, computed for all rows at once in numpy,
then `zlib.compress(raw, level)` (deflateInit's defaults, as the native
encoder). Its bytes therefore equal the native encoder's, for 8- and 16-bit
samples alike (the filters work bytewise). Decoding handles all five
filters (None/Sub/Up vectorized; Avg/Paeth by a per-pixel row loop).
Anything out of scope decodes to None so the caller can fall back to PIL
(io/image_io.py).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload)))


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of PNG bytes [H, stride] uint8 -> filtered rows [H, 1 + stride]
    (filter byte first), each row with the filter of least sum |int8|."""
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
                      x - paeth]).astype(np.uint8)     # mod 256
    cost = np.abs(cands.view(np.int8).astype(np.int64)).sum(axis=2)
    best = np.argmin(cost, axis=0)                     # first on a tie
    out = np.empty((h, rows.shape[1] + 1), np.uint8)
    out[:, 0] = best
    out[:, 1:] = cands[best, np.arange(h)]
    return out


def encode(image_hwc: np.ndarray, level: int = 4) -> bytes:
    """uint8/uint16 HWC (or HW) -> PNG bytes, adaptive row filters."""
    arr = np.ascontiguousarray(image_hwc)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"unsupported channel count: {c}")
    if arr.dtype == np.uint8:
        depth = 8
        rows = arr.reshape(h, w * c)
    elif arr.dtype == np.uint16:
        depth = 16
        rows = arr.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    else:
        raise ValueError(f"unsupported dtype: {arr.dtype}")
    raw = filter_rows(rows, c * depth // 8).tobytes()

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def _unfilter_row(filt: int, cur: np.ndarray, prev: np.ndarray | None,
                  bpp: int) -> np.ndarray:
    """In-place unfilter of one row of bytes; returns the recovered row."""
    if filt == 0:
        return cur
    if filt == 2:
        if prev is not None:
            np.add(cur, prev, out=cur)
        return cur
    if filt == 1:
        # raw[i] = f[i] + raw[i-bpp]: per-phase cumsum (mod-256 via uint8)
        n = cur.shape[0]
        pad = (-n) % bpp
        g = np.concatenate([cur, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
        np.cumsum(g, axis=0, dtype=np.uint8, out=g)
        return g.reshape(-1)[:n]
    # Avg / Paeth: sequential left-dependency with nonlinear ops
    up = prev if prev is not None else np.zeros_like(cur)
    out = cur
    if filt == 3:
        for i in range(out.shape[0]):
            left = int(out[i - bpp]) if i >= bpp else 0
            out[i] = (int(out[i]) + ((left + int(up[i])) >> 1)) & 0xFF
        return out
    if filt == 4:
        for i in range(out.shape[0]):
            a = int(out[i - bpp]) if i >= bpp else 0
            b = int(up[i])
            cc = int(up[i - bpp]) if i >= bpp else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
            out[i] = (int(out[i]) + pred) & 0xFF
        return out
    raise ValueError(f"bad PNG filter: {filt}")


def try_decode(data: bytes) -> np.ndarray | None:
    """PNG bytes -> uint8/uint16 HWC array, or None if out of scope
    (palette/interlace/other depths) so the caller can fall back to PIL."""
    if len(data) < 45 or data[:8] != _SIG:
        return None
    pos = 8
    w = h = depth = 0
    color = -1
    idat = []
    while pos + 8 <= len(data):
        (clen,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + clen]
        if tag == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if interlace != 0:
                return None
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + clen
    if depth not in (8, 16) or color not in _CHANNELS or not idat:
        return None
    c = _CHANNELS[color]
    bpp = c * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.shape[0] != h * (stride + 1):
        raise ValueError("PNG data length mismatch")
    raw = raw.reshape(h, stride + 1)
    filters = raw[:, 0]
    body = raw[:, 1:].copy()

    if np.all(filters == 2):  # Up on every row: one vectorized cumsum
        np.cumsum(body, axis=0, dtype=np.uint8, out=body)
    else:
        prev = None
        for y in range(h):
            prev = _unfilter_row(int(filters[y]), body[y], prev, bpp)
            body[y] = prev
    if depth == 8:
        out = body.reshape(h, w, c)
    else:
        out = body.view(">u2").astype(np.uint16).reshape(h, w, c)
    return np.ascontiguousarray(out)
