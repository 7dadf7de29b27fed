"""Host I/O of the PyTorch port: metadata.bin byte layout, the zlib PNG
codec, PIL only as a lazy fallback, and slice -> reassemble against the
JAX package's writer (same metadata bytes, same decoded slice pixels)."""

import io
import struct
import sys

import numpy as np
import pytest

from image_compression_tpu.io import metadata as jmeta
from image_compression_tpu.io.slicer import write_slices as j_write_slices
from image_compression_torch.io import image_io, pypng
from image_compression_torch.io.metadata import (
    MAGIC, SliceMetadata, decode_metadata, encode_metadata)
from image_compression_torch.io.reassemble import reassemble, reassemble_array
from image_compression_torch.io.slicer import write_slices


def test_exact_byte_layout():
    """Byte-for-byte the reference's packed little-endian structs."""
    rec = SliceMetadata(3, "ab.png", 1, 2, 30, 40)
    data = encode_metadata([rec], 111, 222)
    expected = struct.pack("<IIII", 0x534C4943, 1, 111, 222)
    expected += struct.pack("<iiiiiH", 3, 1, 2, 30, 40, 6) + b"ab.png"
    assert data == expected
    assert MAGIC == jmeta.MAGIC


def test_metadata_bytes_match_reference():
    recs = [(0, "slice_0.png", 0, 0, 10, 20), (7, "slïce_7.png", 5, 9, 100, 1),
            (-3, "x.png", -1, -2, 3, 4)]
    ours = encode_metadata([SliceMetadata(*r) for r in recs], 256, 512)
    ref = jmeta.encode_metadata([jmeta.SliceMetadata(*r) for r in recs], 256,
                                512)
    assert ours == ref
    records, w, h = decode_metadata(ours)
    assert [tuple(vars(r).values()) for r in records] == recs
    assert (w, h) == (256, 512)


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint8, 3),
                                            (np.uint8, 4), (np.uint16, 3)])
def test_pypng_roundtrip(dtype, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, np.iinfo(dtype).max, (9, 13, channels),
                       dtype=np.int64).astype(dtype)
    out = image_io.decode_image_bytes(pypng.encode(img, 4))
    np.testing.assert_array_equal(out, img)


def test_decodes_pil_written_png_with_all_filters():
    """PIL picks adaptive filters (Sub/Up/Avg/Paeth); pypng decodes them."""
    from PIL import Image
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    img[:8] = np.arange(16, dtype=np.uint8)[None, :, None] * 8
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(image_io.decode_image_bytes(buf.getvalue()),
                                  img)


def test_palette_png_needs_pil(monkeypatch):
    """Out-of-scope PNGs go to PIL, imported lazily; without PIL the error
    says so."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(
        buf, format="PNG")
    assert image_io.decode_image_bytes(buf.getvalue()).shape == (4, 4, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="PIL"):
        image_io.decode_image_bytes(buf.getvalue())


def _labelled_image():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    labels = np.zeros((24, 32), np.int64)
    labels[:, 16:] = 16
    labels[12:, :10] = 12 * 32
    labels[20:, 28:] = 20 * 32 + 28
    return img, labels


def test_slices_match_reference_and_reassemble(tmp_path):
    img, labels = _labelled_image()
    assert write_slices(img, labels, tmp_path / "t", "im")
    assert j_write_slices(img, labels, tmp_path / "j", "im")
    ours, ref = tmp_path / "t" / "im", tmp_path / "j" / "im"
    assert (ours / "metadata.bin").read_bytes() == \
        (ref / "metadata.bin").read_bytes()
    names = sorted(p.name for p in ref.glob("slice_*.png"))
    assert names == sorted(p.name for p in ours.glob("slice_*.png"))
    for name in names:
        np.testing.assert_array_equal(image_io.load_image(ours / name),
                                      image_io.load_image(ref / name))
    np.testing.assert_array_equal(reassemble_array(ours),
                                  image_io.ensure_rgba(img))
    assert reassemble(ours, tmp_path / "rec.png")
    np.testing.assert_array_equal(image_io.load_image(tmp_path / "rec.png"),
                                  image_io.ensure_rgba(img))


def test_non_png_format_rejected(tmp_path):
    img, labels = _labelled_image()
    with pytest.raises(ValueError, match="png"):
        write_slices(img, labels, tmp_path, "im", image_format="jpg")


def test_to_float01_rgb_and_ensure_rgba():
    gray = np.arange(12, dtype=np.uint8).reshape(3, 4, 1)
    rgb = image_io.to_float01_rgb(gray)
    assert rgb.shape == (3, 4, 3) and rgb.dtype == np.float32
    np.testing.assert_allclose(rgb[..., 2], gray[..., 0] / 255.0)
    assert image_io.ensure_rgba(gray)[..., 3].min() == 255
