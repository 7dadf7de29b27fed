"""ctypes bindings of the port's native PNG writer (csrc/pngio.cpp).

The library is built with g++ at first use (kernels.py) and gives the
throughput path for PNG encoding, decoding and parallel slice writing.
Where g++ or zlib.h is missing, or the build fails, `load_library` returns
None and callers use the pure-Python codec (io/pypng.py), whose bytes are
the same: the choice changes speed, never the output. Which writer runs is
printed once per process (`writer()` names it).
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

_U8P = ctypes.POINTER(ctypes.c_uint8)
_state: dict = {}  # "lib": the CDLL or None, "why": the writer's line
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pngio_encode.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_size_t)]
    lib.pngio_encode.restype = ctypes.c_int
    lib.pngio_encode16.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(_U8P),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.pngio_encode16.restype = ctypes.c_int
    lib.pngio_decode.argtypes = [
        _U8P, ctypes.c_size_t, _U8P, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.pngio_decode.restype = ctypes.c_int
    lib.pngio_free.argtypes = [_U8P]
    lib.pngio_free.restype = None
    lib.pngio_write_slices.argtypes = [
        _U8P, ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.pngio_write_slices.restype = ctypes.c_int
    lib.pngio_write_slices_pack.argtypes = lib.pngio_write_slices.argtypes
    lib.pngio_write_slices_pack.restype = ctypes.c_int
    lib.pngio_write_slices_conn.argtypes = [
        _U8P, _U8P, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.pngio_write_slices_conn.restype = ctypes.c_int
    lib.pngio_labels_from_conn.argtypes = [
        _U8P, _U8P, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.pngio_labels_from_conn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL | None:
    """The native writer, built at first use; None where it cannot be
    built (the Python codec then writes the same bytes)."""
    with _lock:
        if "lib" not in _state:
            _state["lib"], _state["why"] = _build()
            print(f"png writer: {_state['why']}", flush=True)
    return _state["lib"]


def _build() -> tuple[ctypes.CDLL | None, str]:
    from image_compression_torch import kernels
    lib, why = None, ""
    gxx = kernels.gxx_path()
    if gxx is None:
        why = "python (no g++ on PATH)"
    elif kernels.zlib_header(gxx) is None:
        why = "python (g++ finds no zlib.h)"
    else:
        try:
            lib = _bind(kernels.load("pngio"))
            why = f"native ({kernels.library_path('pngio').name}, g++)"
        except (kernels.BuildError, OSError) as e:
            first = str(e).strip().splitlines()[0]
            why = f"python (building csrc/pngio.cpp failed: {first})"
    return lib, why


def available() -> bool:
    return load_library() is not None


def writer() -> str:
    """Which writer this process uses: "native (...)" or "python (why)"."""
    load_library()
    return _state["why"]


def _require() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native PNG writer unavailable: " + writer())
    return lib


def encode_png(image_hwc: np.ndarray, level: int = 4) -> bytes:
    """uint8 or uint16 HWC/HW -> PNG bytes (16-bit inputs write 16-bit
    PNGs)."""
    lib = _require()
    is16 = np.asarray(image_hwc).dtype == np.uint16
    arr = np.ascontiguousarray(image_hwc, np.uint16 if is16 else np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    out = _U8P()
    out_len = ctypes.c_size_t()
    if is16:
        rc = lib.pngio_encode16(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), h, w, c,
            level, ctypes.byref(out), ctypes.byref(out_len))
    else:
        rc = lib.pngio_encode(arr.ctypes.data_as(_U8P), h, w, c, level,
                              ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"pngio_encode failed: {rc}")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.pngio_free(out)


def decode_png(data: bytes) -> np.ndarray | None:
    """PNG bytes -> HWC array (uint8 or uint16), or None for a PNG the
    decoder does not handle (palette, interlace, other depths)."""
    lib = _require()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    h, w, c, depth = (ctypes.c_int() for _ in range(4))
    dims = (ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
            ctypes.byref(depth))
    if lib.pngio_decode(buf, len(data), None, *dims) != 0:
        return None
    out = np.empty((h.value, w.value, c.value),
                   np.uint16 if depth.value == 16 else np.uint8)
    rc = lib.pngio_decode(buf, len(data), out.ctypes.data_as(_U8P), *dims)
    if rc != 0:
        raise ValueError(f"pngio_decode failed: {rc}")
    return out


def _written(rc: int, total: ctypes.c_longlong, out_path) -> int | None:
    """A native slice write's result: the bytes it wrote, None where they
    would have exceeded max_bytes (nothing written); OSError on failure."""
    if rc == -2:
        return None
    if rc < 0:
        raise OSError(f"pngio_write_slices failed for {out_path}")
    return total.value


def write_slices_native(image_rgba_u8: np.ndarray, labels_hw: np.ndarray,
                        out_path: str | pathlib.Path, level: int = 4,
                        n_threads: int = 0, pack: bool = False,
                        max_bytes: int | None = None) -> int | None:
    """Parallel native slicer; returns the bytes written (slice PNGs +
    metadata.bin, or the pack). pack writes one SLPK file at out_path
    (io/pack.py) instead of a directory of slice PNGs + metadata.bin. With
    max_bytes, an output that would take more bytes is not written, and
    the result is None."""
    lib = _require()
    img = np.ascontiguousarray(image_rgba_u8, np.uint8)
    labels = np.ascontiguousarray(labels_hw, np.int32)
    h, w = labels.shape
    if img.shape != (h, w, 4):
        raise ValueError(f"image {img.shape} does not match labels {h}x{w}")
    fn = lib.pngio_write_slices_pack if pack else lib.pngio_write_slices
    total = ctypes.c_longlong(0)
    rc = fn(img.ctypes.data_as(_U8P),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), h, w,
            str(out_path).encode(), level, n_threads,
            -1 if max_bytes is None else max_bytes, ctypes.byref(total))
    return _written(rc, total, out_path)


def _conn_planes(hbits: np.ndarray, vbits: np.ndarray, height: int,
                 width: int) -> tuple[np.ndarray, np.ndarray]:
    stride = -(-width // 8)
    hb = np.ascontiguousarray(hbits, np.uint8)
    vb = np.ascontiguousarray(vbits, np.uint8)
    if hb.shape != (height, stride) or vb.shape != (height, stride):
        raise ValueError(f"planes {hb.shape} {vb.shape}: expected "
                         f"({height}, {stride})")
    return hb, vb


def labels_from_conn_native(hbits: np.ndarray, vbits: np.ndarray,
                            height: int, width: int) -> np.ndarray:
    """Labels int32 [H, W] from packed connectivity planes by the native
    union-find: each region's smallest flat pixel index, as the solver's
    labels and ops/labels_wire.labels_from_connectivity give them."""
    lib = _require()
    hb, vb = _conn_planes(hbits, vbits, height, width)
    out = np.empty((height, width), np.int32)
    rc = lib.pngio_labels_from_conn(
        hb.ctypes.data_as(_U8P), vb.ctypes.data_as(_U8P), height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError("pngio_labels_from_conn failed")
    return out


def write_slices_conn_native(image_rgba_u8: np.ndarray, hbits: np.ndarray,
                             vbits: np.ndarray, out_path: str | pathlib.Path,
                             level: int = 4, n_threads: int = 0,
                             pack: bool = False,
                             max_bytes: int | None = None) -> int | None:
    """Labels from packed connectivity planes (union-find, smallest pixel
    index per region) and the parallel slicer in one native call; the
    result as write_slices_native's."""
    lib = _require()
    img = np.ascontiguousarray(image_rgba_u8, np.uint8)
    h, w = img.shape[:2]
    if img.shape != (h, w, 4):
        raise ValueError(f"image {img.shape}: expected RGBA")
    hb, vb = _conn_planes(hbits, vbits, h, w)
    total = ctypes.c_longlong(0)
    rc = lib.pngio_write_slices_conn(
        img.ctypes.data_as(_U8P), hb.ctypes.data_as(_U8P),
        vb.ctypes.data_as(_U8P), h, w, str(out_path).encode(), level,
        n_threads, 1 if pack else 0,
        -1 if max_bytes is None else max_bytes, ctypes.byref(total))
    return _written(rc, total, out_path)
