"""Slice a labelled image into per-segment PNGs + metadata.bin.

Port of the reference's io/slicer.py. container="files" is the reference
layout (output_path/<name>/slice_<label>.png + metadata.bin);
container="pack" writes the same bytes into one SLPK file
output_path/<name>.pack (io/pack.py). A segment that fills its whole bbox
with opaque pixels is written as RGB; every other segment as RGBA with a
transparent background. 8-bit images go through the native writer
(csrc/pngio.cpp via io/native.py) when it is built, as in the reference;
otherwise, and for 16-bit images, through io/pypng.py. Both encoders write
the same bytes, so slice files, packs and metadata.bin are byte-equal to
the reference's whichever runs.
"""

from __future__ import annotations

import concurrent.futures
import os
import pathlib

import numpy as np
from scipy import ndimage

from image_compression_torch.io import native, pypng
from image_compression_torch.io.image_io import ensure_rgba
from image_compression_torch.io.metadata import (SliceMetadata,
                                                 encode_metadata)
from image_compression_torch.io.pack import pack_bytes, write_pack
from image_compression_torch.ops.labels_wire import labels_from_connectivity


def compute_bounding_boxes(
        labels_hw: np.ndarray) -> dict[int, tuple[int, int, int, int]]:
    """Bounding boxes (x, y, w, h) of every label present in the map."""
    labels_hw = np.ascontiguousarray(labels_hw)
    lab_min = int(labels_hw.min())
    objects = ndimage.find_objects(labels_hw - lab_min + 1)
    boxes: dict[int, tuple[int, int, int, int]] = {}
    for idx, sl in enumerate(objects):
        if sl is None:
            continue
        ys, xs = sl
        boxes[idx + lab_min] = (int(xs.start), int(ys.start),
                                int(xs.stop - xs.start),
                                int(ys.stop - ys.start))
    return boxes


def slice_image(image_rgba: np.ndarray, labels_hw: np.ndarray, label: int,
                box: tuple[int, int, int, int]) -> np.ndarray:
    """One segment as an RGBA crop with transparent background, or as RGB
    when it fills its bbox with opaque pixels."""
    x, y, w, h = box
    crop = image_rgba[y:y + h, x:x + w]
    mask = labels_hw[y:y + h, x:x + w] == label
    opaque = np.iinfo(image_rgba.dtype).max
    if mask.all() and (crop[:, :, 3] == opaque).all():
        return crop[:, :, :3].copy()
    out = np.zeros((h, w, 4), image_rgba.dtype)
    out[mask] = crop[mask]
    return out


def _target(output_path, name, container: str) -> pathlib.Path:
    """The slice directory or pack file of one image, its parent made."""
    if container not in ("files", "pack"):
        raise ValueError(f"unknown container: {container!r}")
    if container == "pack":
        out = pathlib.Path(output_path) / f"{name}.pack"
        out.parent.mkdir(parents=True, exist_ok=True)
    else:
        out = pathlib.Path(output_path) / name
        out.mkdir(parents=True, exist_ok=True)
    return out


def _use_native(image_rgba: np.ndarray, use_native: bool | None) -> bool:
    if use_native is False or image_rgba.dtype != np.uint8:
        return False
    if native.available():
        return True
    if use_native:
        raise RuntimeError("native writer requested but unavailable: "
                           + native.writer())
    return False


def write_slices(image_hwc: np.ndarray, labels_hw: np.ndarray,
                 output_path: str | pathlib.Path,
                 file_directory_name: str | pathlib.Path,
                 image_format: str = "png", compression_level: int = 4,
                 max_workers: int | None = None,
                 use_native: bool | None = None,
                 container: str = "files",
                 max_bytes: int | None = None) -> int | None:
    """Write one PNG per segment plus metadata.bin (or one pack); returns
    the bytes written, and raises OSError if a file cannot be written. With
    max_bytes, an output that takes more bytes is not left written (its
    directory stays empty, no pack is made) and the result is None. Only "png" keeps
    the round trip lossless, so any other image_format raises.
    use_native=None takes the native writer when it is built; True
    requires it; False never uses it."""
    if image_format != "png":
        raise ValueError(
            f"write_slices supports only image_format='png' (lossless "
            f"round-trip contract), got {image_format!r}")
    out = _target(output_path, file_directory_name, container)
    pack = container == "pack"
    image_rgba = ensure_rgba(np.asarray(image_hwc))
    labels_hw = np.asarray(labels_hw)
    h_img, w_img = labels_hw.shape
    if _use_native(image_rgba, use_native) and labels_hw.min() >= 0 and \
            labels_hw.max() < np.iinfo(np.int32).max:
        return native.write_slices_native(image_rgba, labels_hw, out,
                                          compression_level, max_workers or 0,
                                          pack=pack, max_bytes=max_bytes)
    boxes = compute_bounding_boxes(labels_hw)

    def encode_one(label: int) -> tuple[SliceMetadata, bytes]:
        box = boxes[label]
        data = pypng.encode(slice_image(image_rgba, labels_hw, label, box),
                            compression_level)
        return SliceMetadata(label=label, filename=f"slice_{label}.png",
                             x=box[0], y=box[1], width=box[2],
                             height=box[3]), data

    # zlib releases the interpreter lock: encode the slices in threads
    workers = max_workers or min(32, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        results = list(pool.map(encode_one, sorted(boxes)))
    metas = [meta for meta, _ in results]
    blobs = [data for _, data in results]
    meta_bytes = encode_metadata(metas, w_img, h_img)
    total = (pack_bytes(len(meta_bytes), [len(b) for b in blobs]) if pack
             else len(meta_bytes) + sum(len(b) for b in blobs))
    if max_bytes is not None and total > max_bytes:
        return None
    if pack:
        write_pack(out, metas, blobs, w_img, h_img)
    else:
        for meta, data in results:
            (out / meta.filename).write_bytes(data)
        (out / "metadata.bin").write_bytes(meta_bytes)
    return total


def write_slices_from_conn(image_hwc: np.ndarray, hbits: np.ndarray,
                           vbits: np.ndarray,
                           output_path: str | pathlib.Path,
                           file_directory_name: str | pathlib.Path,
                           image_format: str = "png",
                           compression_level: int = 4,
                           max_workers: int | None = None,
                           use_native: bool | None = None,
                           container: str = "files",
                           max_bytes: int | None = None) -> int | None:
    """write_slices from the bit-packed connectivity planes of
    ops/labels_wire.py (its result and max_bytes as write_slices'). The
    native writer rebuilds the labels and slices in one call; otherwise
    labels come from connected components (both give each region its
    smallest pixel index)."""
    if image_format != "png":
        raise ValueError("write_slices_from_conn supports only 'png'")
    image_rgba = ensure_rgba(np.asarray(image_hwc))
    h_img, w_img = image_rgba.shape[:2]
    if _use_native(image_rgba, use_native):
        return native.write_slices_conn_native(
            image_rgba, hbits, vbits,
            _target(output_path, file_directory_name, container),
            compression_level, max_workers or 0,
            pack=container == "pack", max_bytes=max_bytes)
    labels = labels_from_connectivity(np.asarray(hbits), np.asarray(vbits),
                                      h_img, w_img)
    return write_slices(image_hwc, labels.astype(np.int64), output_path,
                        file_directory_name, image_format, compression_level,
                        max_workers, False, container, max_bytes)
