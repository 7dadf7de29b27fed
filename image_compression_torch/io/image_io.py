"""Image load/save and recursive dataset scanning.

PNGs decode and encode through the native codec (csrc/pngio.cpp via
io/native.py) where it is built, else through io/pypng.py (zlib + numpy);
the two encoders write the same bytes. PIL is imported only to decode
inputs neither handles (palette, interlaced, non-PNG formats); where PIL is
missing that raises a clear error. Arrays are RGB(A) uint8 or uint16 HWC.
"""

from __future__ import annotations

import io
import os
import pathlib

import numpy as np

from image_compression_torch.io import native, pypng


def find_image_files_recursively(root: str | pathlib.Path,
                                 extension: str = "png") -> list[pathlib.Path]:
    """Recursive, case-insensitive suffix scan; sorted for determinism."""
    suffix = "." + extension.lower().lstrip(".")
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if name.lower().endswith(suffix):
                out.append(pathlib.Path(dirpath) / name)
    out.sort()
    return out


def _la_to_rgba(arr: np.ndarray) -> np.ndarray:
    """2-channel gray+alpha -> RGBA (luma replicated), dtype preserved."""
    h, w = arr.shape[:2]
    out = np.empty((h, w, 4), arr.dtype)
    out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = arr[:, :, 0]
    out[:, :, 3] = arr[:, :, 1]
    return out


def _decode_with_pil(data: bytes) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError("image is not a PNG the built-in decoder handles "
                         "(8/16-bit gray/RGB/RGBA, not interlaced), and PIL "
                         "is not installed to decode it") from e
    with Image.open(io.BytesIO(data)) as im:
        if im.mode in ("RGB", "RGBA", "L"):
            return np.asarray(im)
        if im.mode == "LA":
            return np.asarray(im.convert("RGBA"))
        if im.mode in ("P", "1"):
            return np.asarray(im.convert(
                "RGBA" if "transparency" in im.info else "RGB"))
        if im.mode in ("I;16", "I;16B", "I;16L"):
            return np.asarray(im).astype(np.uint16)
        return np.asarray(im.convert("RGB"))


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Image bytes -> uint8/uint16 HWC, keeping channel count and depth
    (gray+alpha becomes RGBA; grayscale stays one channel)."""
    arr = (native.decode_png(data) if native.available()
           else pypng.try_decode(data))
    if arr is None:
        arr = _decode_with_pil(data)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[2] == 2:
        arr = _la_to_rgba(arr)
    return np.ascontiguousarray(arr)


def load_image(path: str | pathlib.Path) -> np.ndarray:
    return decode_image_bytes(pathlib.Path(path).read_bytes())


def encode_png(image_hwc: np.ndarray, compression_level: int = 4) -> bytes:
    """PNG bytes of a uint8/uint16 image: the native encoder where it is
    built, else io/pypng.py (the same bytes)."""
    if native.available():
        return native.encode_png(image_hwc, compression_level)
    return pypng.encode(image_hwc, compression_level)


def write_image(path: str | pathlib.Path, image_hwc: np.ndarray,
                compression_level: int = 4) -> bool:
    """Encode a PNG at the given zlib level (forces a .png suffix)."""
    arr = np.ascontiguousarray(image_hwc)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    try:
        pathlib.Path(path).with_suffix(".png").write_bytes(
            encode_png(arr, compression_level))
        return True
    except OSError:
        return False


def to_float01_rgb(image_hwc: np.ndarray) -> np.ndarray:
    """uint8/uint16 HWC (1/3/4 channels) -> float32 RGB in [0, 1]: gray
    replicated, alpha dropped, scaled by 1/255 (16-bit: 1/65535)."""
    arr = image_hwc
    if arr.ndim == 2:
        arr = arr[:, :, None]
    c = arr.shape[2]
    if c == 1:
        arr = np.repeat(arr, 3, axis=2)
    elif c == 4:
        arr = arr[:, :, :3]
    elif c != 3:
        raise ValueError(f"unsupported channel count: {c}")
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    if arr.dtype == np.float32:
        return arr
    raise ValueError(f"unsupported dtype: {arr.dtype}")


def ensure_rgba(image_hwc: np.ndarray) -> np.ndarray:
    """1/3/4-channel uint8/uint16 -> RGBA with opaque alpha; depth kept."""
    arr = image_hwc
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c == 4:
        return arr
    if c not in (1, 3):
        raise ValueError(f"unsupported channel count: {c}")
    out = np.empty((h, w, 4), arr.dtype)
    out[:, :, :3] = arr
    out[:, :, 3] = np.iinfo(arr.dtype).max
    return out
