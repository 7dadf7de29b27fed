"""The bytes the program's writer writes for a kept slicing, worked out
again: a frozen plain copy of the port's Python slice writer
(`io/slicer.write_slices` with use_native=False, its PNGs from
`io/pypng.py`, copied as portbench/pngcodec.encode; the native writer
writes the same bytes), part of the benchmark's reference; it imports
nothing of the program.

A slicing's regions are the 4-connected components of its label map, each
named by its smallest flat pixel index (what the program's connectivity
wire carries to the writer). Each region is one PNG of its bounding box:
RGB where it fills the box, else RGBA with the region opaque and the rest
transparent; metadata.bin holds a 16-byte header and per slice a 22-byte
entry and its name "slice_<label>.png".
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from portbench import pngcodec

HEADER = 16
ENTRY = 22


def minlabel_regions(labels: np.ndarray) -> np.ndarray:
    """[H, W] labels -> the 4-connected components of equal labels, each
    labelled by its smallest flat pixel index (doubled-grid connected
    components: pixels at even coordinates, the links between equal
    neighbours at odd ones)."""
    height, width = labels.shape
    grid = np.zeros((2 * height - 1, 2 * width - 1), bool)
    grid[::2, ::2] = True
    grid[::2, 1::2] = labels[:, :-1] == labels[:, 1:]
    grid[1::2, ::2] = labels[:-1, :] == labels[1:, :]
    cc, ncc = ndimage.label(grid)
    cc_pix = cc[::2, ::2]
    flat = np.arange(height * width, dtype=np.int64).reshape(height, width)
    minlab = ndimage.minimum(flat, labels=cc_pix,
                             index=np.arange(1, ncc + 1))
    return np.asarray(minlab, np.int64)[cc_pix - 1]


def slice_crop(image_rgba: np.ndarray, regions: np.ndarray, label: int,
               box: tuple[slice, slice]) -> np.ndarray:
    """One region as an RGB crop of its box where it fills the box with
    opaque pixels, else an RGBA crop with a transparent background."""
    crop = image_rgba[box]
    mask = regions[box] == label
    if mask.all() and (crop[:, :, 3] == 255).all():
        return crop[:, :, :3].copy()
    out = np.zeros(crop.shape, np.uint8)
    out[mask] = crop[mask]
    return out


def slicing_bytes(image_rgb: np.ndarray, labels: np.ndarray,
                  level: int) -> int:
    """Bytes the writer writes for `labels` over uint8 `image_rgb` [H, W, 3]
    at zlib `level`: every slice PNG plus metadata.bin."""
    regions = minlabel_regions(np.asarray(labels))
    image_rgba = np.concatenate(
        [image_rgb, np.full(image_rgb.shape[:2] + (1,), 255, np.uint8)], -1)
    total = HEADER
    boxes = ndimage.find_objects(regions + 1)
    for label, box in enumerate(boxes):
        if box is None:
            continue
        png = pngcodec.encode(slice_crop(image_rgba, regions, label, box),
                              level)
        total += len(png) + ENTRY + len(f"slice_{label}.png")
    return total
