"""Binary slice-metadata codec, byte-compatible with the reference.

Wire format (little-endian, packed; metadata.h:12-28, metadata.cpp:4-78):

  header:  uint32 magic = 0x534C4943 ("SLIC" read as LE uint32)
           uint32 count
           uint32 original_width
           uint32 original_height
  record:  int32 label, int32 x, int32 y, int32 width, int32 height,
           uint16 filename_len, filename_len bytes of filename

This is the lossless round-trip contract: files produced here are readable by
the reference `reassemble` binary and vice versa.
"""

from __future__ import annotations

import dataclasses
import pathlib
import struct

MAGIC = 0x534C4943
_HEADER = struct.Struct("<IIII")
_FIXED = struct.Struct("<iiiiiH")


@dataclasses.dataclass
class SliceMetadata:
    """One slice record (metadata.h:6-10)."""

    label: int
    filename: str
    x: int
    y: int
    width: int
    height: int


def encode_metadata(records: list[SliceMetadata], image_width: int,
                    image_height: int) -> bytes:
    """Serialize records to the packed binary format (metadata.cpp:4-34)."""
    out = bytearray()
    out += _HEADER.pack(MAGIC, len(records), image_width, image_height)
    for m in records:
        name = m.filename.encode("utf-8")
        if len(name) > 0xFFFF:
            raise ValueError(f"filename too long: {m.filename!r}")
        out += _FIXED.pack(m.label, m.x, m.y, m.width, m.height, len(name))
        out += name
    return bytes(out)


def decode_metadata(data: bytes) -> tuple[list[SliceMetadata], int, int]:
    """Parse the packed binary format (metadata.cpp:36-78).

    Returns (records, original_width, original_height).
    """
    if len(data) < _HEADER.size:
        raise ValueError("metadata too short")
    magic, count, width, height = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError("Invalid metadata file (magic mismatch)")
    offset = _HEADER.size
    records = []
    for _ in range(count):
        label, x, y, w, h, name_len = _FIXED.unpack_from(data, offset)
        offset += _FIXED.size
        name = data[offset:offset + name_len].decode("utf-8")
        offset += name_len
        records.append(SliceMetadata(label, name, x, y, w, h))
    return records, width, height


def write_metadata_binary(records: list[SliceMetadata],
                          path: str | pathlib.Path,
                          image_width: int, image_height: int) -> None:
    pathlib.Path(path).write_bytes(
        encode_metadata(records, image_width, image_height))


def read_metadata_binary(
        path: str | pathlib.Path) -> tuple[list[SliceMetadata], int, int]:
    return decode_metadata(pathlib.Path(path).read_bytes())
