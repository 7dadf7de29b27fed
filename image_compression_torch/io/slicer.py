"""Slice a labelled image into per-segment PNGs + metadata.bin.

Port of the reference's io/slicer.py for the reference's file layout
(output_path/<name>/slice_<label>.png + metadata.bin), encoding through
io/pypng.py. A segment that fills its whole bbox with opaque pixels is
written as RGB; every other segment as RGBA with a transparent background.
metadata.bin is byte-compatible with the reference.
"""

from __future__ import annotations

import concurrent.futures
import os
import pathlib

import numpy as np
from scipy import ndimage

from image_compression_torch.io.image_io import ensure_rgba, write_image
from image_compression_torch.io.metadata import (SliceMetadata,
                                                 write_metadata_binary)
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


def write_slices(image_hwc: np.ndarray, labels_hw: np.ndarray,
                 output_path: str | pathlib.Path,
                 file_directory_name: str | pathlib.Path,
                 image_format: str = "png", compression_level: int = 4,
                 max_workers: int | None = None) -> bool:
    """Write one PNG per segment plus metadata.bin into
    output_path/file_directory_name/. Only "png" keeps the round trip
    lossless, so any other image_format raises."""
    if image_format != "png":
        raise ValueError(
            f"write_slices supports only image_format='png' (lossless "
            f"round-trip contract), got {image_format!r}")
    out_dir = pathlib.Path(output_path) / file_directory_name
    out_dir.mkdir(parents=True, exist_ok=True)
    image_rgba = ensure_rgba(np.asarray(image_hwc))
    labels_hw = np.asarray(labels_hw)
    h_img, w_img = labels_hw.shape
    boxes = compute_bounding_boxes(labels_hw)

    def write_one(label: int) -> tuple[bool, SliceMetadata]:
        box = boxes[label]
        filename = f"slice_{label}.{image_format}"
        ok = write_image(out_dir / filename,
                         slice_image(image_rgba, labels_hw, label, box),
                         compression_level)
        return ok, SliceMetadata(label=label, filename=filename, x=box[0],
                                 y=box[1], width=box[2], height=box[3])

    # zlib releases the interpreter lock: encode the slices in threads
    workers = max_workers or min(32, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        results = list(pool.map(write_one, sorted(boxes)))
    write_metadata_binary([meta for _, meta in results],
                          out_dir / "metadata.bin", w_img, h_img)
    return all(ok for ok, _ in results)


def write_slices_from_conn(image_hwc: np.ndarray, hbits: np.ndarray,
                           vbits: np.ndarray,
                           output_path: str | pathlib.Path,
                           file_directory_name: str | pathlib.Path,
                           image_format: str = "png",
                           compression_level: int = 4,
                           max_workers: int | None = None) -> bool:
    """write_slices from the bit-packed connectivity planes of
    ops/labels_wire.py (labels rebuilt by connected components)."""
    h_img, w_img = np.asarray(image_hwc).shape[:2]
    labels = labels_from_connectivity(np.asarray(hbits), np.asarray(vbits),
                                      h_img, w_img)
    return write_slices(image_hwc, labels.astype(np.int64), output_path,
                        file_directory_name, image_format, compression_level,
                        max_workers)
