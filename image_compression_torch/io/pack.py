"""Single-file slice container ("pack"): one file per compressed image.

The port's copy of the reference's io/pack.py. A pack keeps the exact
per-slice PNG bytes and metadata payload of the loose layout
(slice_<label>.png files + metadata.bin) in ONE file, so compressing an
image costs one file create instead of K+1. `unpack_to_dir` recovers the
loose layout byte for byte, and reassembly reads both (io/reassemble.py).

Wire format (little-endian):

  magic    4 bytes  "SLPK"
  u32      version = 1
  u64      metadata length, then the metadata payload — byte-identical to
           metadata.bin (io/metadata.py, metadata.cpp:4-34)
  then per metadata record, in record order:
  u64      PNG length, then the slice PNG bytes
"""

from __future__ import annotations

import pathlib
import struct

from image_compression_torch.io.metadata import (SliceMetadata,
                                                 decode_metadata,
                                                 encode_metadata)

MAGIC = b"SLPK"
VERSION = 1
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def write_pack(path: str | pathlib.Path, records: list[SliceMetadata],
               blobs: list[bytes], image_width: int,
               image_height: int) -> None:
    """Write one pack file; blobs[i] is the PNG for records[i]."""
    if len(records) != len(blobs):
        raise ValueError(f"{len(records)} records vs {len(blobs)} blobs")
    meta = encode_metadata(records, image_width, image_height)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_U32.pack(VERSION))
        f.write(_U64.pack(len(meta)))
        f.write(meta)
        for blob in blobs:
            f.write(_U64.pack(len(blob)))
            f.write(blob)


def read_pack(path: str | pathlib.Path
              ) -> tuple[list[SliceMetadata], list[bytes], int, int]:
    """Returns (records, blobs, original_width, original_height)."""
    data = pathlib.Path(path).read_bytes()
    if data[:4] != MAGIC:
        raise ValueError(f"not a pack file: {path}")
    (version,) = _U32.unpack_from(data, 4)
    if version != VERSION:
        raise ValueError(f"unsupported pack version {version}")
    (meta_len,) = _U64.unpack_from(data, 8)
    off = 16
    records, width, height = decode_metadata(data[off:off + meta_len])
    off += meta_len
    blobs = []
    for _ in records:
        (blob_len,) = _U64.unpack_from(data, off)
        off += 8
        blobs.append(data[off:off + blob_len])
        off += blob_len
    return records, blobs, width, height


def is_pack(path: str | pathlib.Path) -> bool:
    path = pathlib.Path(path)
    if not path.is_file():
        return False
    with open(path, "rb") as f:
        return f.read(4) == MAGIC


def unpack_to_dir(pack_path: str | pathlib.Path,
                  out_dir: str | pathlib.Path) -> None:
    """Expand a pack into the reference's loose layout (slice_<label>.png
    files + metadata.bin), byte-identical to what the loose writer emits."""
    records, blobs, width, height = read_pack(pack_path)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "metadata.bin").write_bytes(
        encode_metadata(records, width, height))
    for rec, blob in zip(records, blobs):
        (out_dir / rec.filename).write_bytes(blob)
