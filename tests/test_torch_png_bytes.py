"""PNG bytes of the PyTorch port against the JAX reference's native writer
(native/pngio.cpp, which the reference uses whenever it is built): the
port's Python encoder and the port's own native library give bytes equal
to the reference's encode_png (u8 with 1-4 channels, u16, odd sizes);
slice files, metadata.bin and the SLPK pack written from the connectivity
wire are byte-equal to the reference's from both of the port's writers;
and a pack reassembles losslessly."""

import numpy as np
import pytest
import torch

from image_compression_tpu.io import native as jnative
from image_compression_tpu.io import pack as jpack
from image_compression_tpu.io.slicer import \
    write_slices_from_conn as j_write_slices_from_conn
from image_compression_torch.io import native, pack, pypng
from image_compression_torch.io.image_io import ensure_rgba
from image_compression_torch.io.reassemble import reassemble_array
from image_compression_torch.io.slicer import write_slices_from_conn
from image_compression_torch.ops.labels_wire import pack_connectivity

SHAPES = [(1, 1), (3, 5), (1, 9), (97, 131)]


def _image(shape, channels, dtype, seed):
    """Noise over a gradient, so that every filter wins some row."""
    rng = np.random.default_rng(seed)
    h, w = shape
    top = np.iinfo(dtype).max
    grad = (np.add.outer(np.arange(h), np.arange(w)) * (top // (h + w)))
    img = grad[:, :, None] + rng.integers(0, top // 8 + 1, (h, w, channels))
    img[h // 2:, : w // 2] = rng.integers(0, top + 1,
                                          (h - h // 2, w // 2, channels))
    return (img % (top + 1)).astype(dtype)


def test_writer_is_native_here():
    """g++ and zlib.h are present on this machine: the port builds its own
    copy of pngio.cpp, and says so."""
    assert native.available()
    assert native.writer().startswith("native")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encoders_equal_reference_native(dtype, channels):
    for k, shape in enumerate(SHAPES):
        img = _image(shape, channels, dtype, seed=10 * channels + k)
        for level in (1, 4, 9):
            want = jnative.encode_png(img, level)
            assert pypng.encode(img, level) == want
            assert native.encode_png(img, level) == want
        np.testing.assert_array_equal(pypng.try_decode(want), img)
        np.testing.assert_array_equal(native.decode_png(want), img)


def test_filter_choice_is_the_least_abs_sum_first_on_tie():
    """Row by row, pypng's filter is the first of None/Sub/Up/Avg/Paeth
    with the least sum of |int8| residuals (a loop over rows as the
    reference's C++ does it)."""
    img = _image((31, 17), 3, np.uint8, seed=5)
    rows = img.reshape(31, -1).astype(np.int64)
    got = pypng.filter_rows(img.reshape(31, -1), 3)
    for y in range(31):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        p = left + prev - ul
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        cands = [cur, cur - left, cur - prev, cur - (left + prev) // 2,
                 cur - paeth]
        costs = [np.abs(((c % 256) ^ 128) - 128).sum() for c in cands]
        best = int(np.argmin(costs))
        assert got[y, 0] == best
        np.testing.assert_array_equal(got[y, 1:], cands[best] % 256)


def _labelled_wire(dtype=np.uint8):
    """A 40x56 image with six regions (one with a hole, one thin) and its
    connectivity wire."""
    rng = np.random.default_rng(3)
    h, w = 40, 56
    top = np.iinfo(dtype).max
    img = rng.integers(0, top + 1, (h, w, 3)).astype(dtype)
    img[:, 20:40] = (30, 60, 90)
    img[5:25, 42:] = np.arange(14)[None, :, None] * (top // 14)
    labels = np.zeros((h, w), np.int64)
    labels[:, 20:40] = 1
    labels[10:15, 25:30] = 2
    labels[5:25, 42:] = 3
    labels[30:, 45:] = 4
    labels[38:, :] = 5
    hb, vb = pack_connectivity(torch.as_tensor(labels)[None])
    return img, hb[0].numpy(), vb[0].numpy()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("container", ["files", "pack"])
def test_slices_equal_reference(tmp_path, use_native, container, dtype):
    """16-bit images take the Python slicer on both sides (the native one
    is 8-bit), whose encoder is then the native encode16 or pypng."""
    img, hb, vb = _labelled_wire(dtype)
    assert j_write_slices_from_conn(img, hb, vb, tmp_path / "j", "im",
                                    container=container, use_native=True)
    assert write_slices_from_conn(img, hb, vb, tmp_path / "t", "im",
                                  container=container, use_native=use_native)
    if container == "pack":
        ours = (tmp_path / "t" / "im.pack").read_bytes()
        assert ours == (tmp_path / "j" / "im.pack").read_bytes()
        recs, blobs, w, h = pack.read_pack(tmp_path / "t" / "im.pack")
        j_recs, j_blobs, jw, jh = jpack.read_pack(tmp_path / "j" / "im.pack")
        assert blobs == j_blobs and (w, h) == (jw, jh) == (56, 40)
        assert [vars(r) for r in recs] == [vars(r) for r in j_recs]
        assert len(recs) == 7  # region 1 and its hole's island split
        return
    ours, ref = tmp_path / "t" / "im", tmp_path / "j" / "im"
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in ours.iterdir())
    assert "metadata.bin" in names and len(names) == 8
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name


def test_pack_reassembles_and_unpacks(tmp_path):
    img, hb, vb = _labelled_wire()
    write_slices_from_conn(img, hb, vb, tmp_path, "im", container="pack")
    write_slices_from_conn(img, hb, vb, tmp_path, "loose")
    packed = tmp_path / "im.pack"
    assert pack.is_pack(packed) and not pack.is_pack(tmp_path / "loose")
    np.testing.assert_array_equal(reassemble_array(packed), ensure_rgba(img))
    pack.unpack_to_dir(packed, tmp_path / "unpacked")
    loose = sorted(p.name for p in (tmp_path / "loose").iterdir())
    assert loose == sorted(p.name for p in (tmp_path / "unpacked").iterdir())
    for name in loose:
        assert (tmp_path / "unpacked" / name).read_bytes() == \
            (tmp_path / "loose" / name).read_bytes()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("container", ["files", "pack"])
def test_max_bytes_writes_all_or_nothing(tmp_path, use_native, container):
    """Both writers return the bytes they wrote (the slice files and
    metadata.bin, or the pack); with max_bytes one byte under that they
    write nothing and return None, and at exactly that they write the same
    bytes (the compress writer's never-expand guard)."""
    img, hb, vb = _labelled_wire()

    def written(root):
        out = root / ("im.pack" if container == "pack" else "im")
        if not out.exists():
            return {}
        files = [out] if out.is_file() else sorted(out.iterdir())
        return {f.name: f.read_bytes() for f in files}

    total = write_slices_from_conn(img, hb, vb, tmp_path / "a", "im",
                                   container=container, use_native=use_native)
    files = written(tmp_path / "a")
    assert total == sum(len(b) for b in files.values()) > 0
    assert write_slices_from_conn(
        img, hb, vb, tmp_path / "b", "im", container=container,
        use_native=use_native, max_bytes=total - 1) is None
    assert written(tmp_path / "b") == {}
    assert write_slices_from_conn(
        img, hb, vb, tmp_path / "c", "im", container=container,
        use_native=use_native, max_bytes=total) == total
    assert written(tmp_path / "c") == files
