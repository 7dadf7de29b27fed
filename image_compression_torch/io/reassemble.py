"""Lossless reassembly of sliced images.

Reads metadata.bin and the slice PNGs of a directory, or a single-file
pack (io/pack.py), and composites them onto a transparent canvas at their
recorded positions; alpha > 0 selects segment pixels. The inverse of
io/slicer.py; port of the reference's io/reassemble.py.
"""

from __future__ import annotations

import hashlib
import pathlib
import sys

import numpy as np

from image_compression_torch.io.image_io import (decode_image_bytes,
                                                 ensure_rgba, load_image,
                                                 write_image)
from image_compression_torch.io.metadata import read_metadata_binary
from image_compression_torch.io.pack import is_pack, read_pack


def reassemble_array(slice_dir: str | pathlib.Path) -> np.ndarray:
    """Composite all slices of a directory or pack file onto a canvas
    [H, W, 4]."""
    slice_dir = pathlib.Path(slice_dir)
    blob_by_name: dict[str, bytes] | None = None
    if is_pack(slice_dir):
        records, blobs, width, height = read_pack(slice_dir)
        blob_by_name = {m.filename: b for m, b in zip(records, blobs)}
    else:
        records, width, height = read_metadata_binary(
            slice_dir / "metadata.bin")
    if not records:
        raise ValueError("No slices in metadata")

    canvas = None  # dtype adopted from the first slice (8- or 16-bit)
    for m in records:
        if not m.filename:
            print(f"Warning: empty filename for label {m.label}, skipping",
                  file=sys.stderr)
            continue
        try:
            if blob_by_name is not None:
                piece = ensure_rgba(decode_image_bytes(
                    blob_by_name[m.filename]))
            else:
                path = slice_dir / m.filename
                if not path.exists():
                    # the reference resolves filenames relative to the cwd
                    path = pathlib.Path(m.filename)
                piece = ensure_rgba(load_image(path))
        except (OSError, ValueError, KeyError):
            print(f"Warning: failed to load slice '{m.filename}', skipping",
                  file=sys.stderr)
            continue
        copy_w = min(piece.shape[1], width - m.x)
        copy_h = min(piece.shape[0], height - m.y)
        if copy_w <= 0 or copy_h <= 0:
            print(f"Warning: slice '{m.filename}' lies outside canvas, "
                  "skipping", file=sys.stderr)
            continue
        if canvas is None:
            canvas = np.zeros((height, width, 4), piece.dtype)
        src = piece[:copy_h, :copy_w].astype(canvas.dtype, copy=False)
        mask = src[:, :, 3] > 0
        region = canvas[m.y:m.y + copy_h, m.x:m.x + copy_w]
        region[mask] = src[mask]

    if canvas is None:
        canvas = np.zeros((height, width, 4), np.uint8)
    return canvas


def reassemble(slice_dir: str | pathlib.Path,
               out_filename: str | pathlib.Path,
               compression_level: int = 4) -> bool:
    """Reassemble and write the reconstructed PNG."""
    try:
        canvas = reassemble_array(slice_dir)
    except (OSError, ValueError) as e:
        print(f"Error reassembling: {e}", file=sys.stderr)
        return False
    return write_image(out_filename, canvas, compression_level)


def output_record(src: str | pathlib.Path,
                  slice_dir: str | pathlib.Path) -> dict:
    """What compress wrote for one source image into its slice directory:
    the stem, the output's bytes (slices + metadata.bin), the slice count,
    whether it fell back (one slice whose bytes are the source's) and the
    sha256 of every output file's name and bytes, in name order."""
    src, slice_dir = pathlib.Path(src), pathlib.Path(slice_dir)
    files = {p.name: p.read_bytes() for p in sorted(slice_dir.iterdir())}
    slices = [k for k in files if k.startswith("slice_")]
    digest = hashlib.sha256()
    for name, blob in files.items():
        digest.update(name.encode() + blob)
    return {"name": src.stem,
            "out_bytes": sum(len(v) for v in files.values()),
            "slices": len(slices),
            "fallback": len(slices) == 1
            and files[slices[0]] == src.read_bytes(),
            "sha256": digest.hexdigest()}
