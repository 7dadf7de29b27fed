"""The port's tooling modules against the JAX reference's:

- io/converter.py: convert_dataset on PNG sources (RGB, RGBA and gray;
  down- and upscaled) writes the same file names and count as the
  reference's, and pixels within 1 level of its PIL BILINEAR resize on at
  least 98% of entries (torch's antialiased bilinear rounds differently);
  a file that fails to decode is printed and skipped by both; the CLI's
  `convert` runs it.
- utils/profiling.py: StageClock's timings; device_trace on the CPU
  writes a Chrome trace naming the recorded ops and spans.
- utils/random_partition.py: equal to the reference's (bitwise, 3 seeds).
- utils/pattern_generator.py: the photo mosaic and collage equal the
  reference's on synthetic "photos" (bitwise); a photo smaller than a
  mosaic cell raises in both, and the collage clamps its panels to a small
  photo in both.
"""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from image_compression_torch.cli.main import main as cli
from image_compression_torch.io import pypng
from image_compression_torch.io.converter import convert_dataset
from image_compression_torch.io.image_io import load_image
from image_compression_torch.utils import pattern_generator as tpg
from image_compression_torch.utils import random_partition as trp
from image_compression_torch.utils.profiling import (StageClock, device_trace,
                                                     span)


def _sources(root):
    rng = np.random.default_rng(4)
    root.mkdir()
    (root / "sub").mkdir()
    smooth = np.kron(rng.integers(0, 256, (12, 16, 3)),
                     np.ones((8, 8, 1))).astype(np.uint8)        # 96x128
    noisy = rng.integers(0, 256, (40, 30, 3), np.uint8)
    rgba = np.concatenate([smooth[:100 // 2 * 2, :100],
                           np.full((96, 100, 1), 200, np.uint8)], axis=2)
    gray = smooth[:, :, 0]
    for name, img in (("smooth.png", smooth), ("sub/noisy.png", noisy),
                      ("rgba.png", rgba), ("gray.png", gray)):
        (root / name).write_bytes(pypng.encode(img))
    (root / "broken.png").write_bytes(b"not a png")


def test_convert_matches_reference(tmp_path, capsys):
    from image_compression_tpu.io.converter import (
        convert_dataset as j_convert)

    _sources(tmp_path / "src")
    shutil.copytree(tmp_path / "src", tmp_path / "ref")
    n = convert_dataset(tmp_path / "src", "png", 64, 48, device="cpu")
    n_ref = j_convert(tmp_path / "ref", "png", 64, 48)
    assert n == n_ref == 4
    assert "broken.png" in capsys.readouterr().out
    names = sorted(p.relative_to(tmp_path / "src").as_posix()
                   for p in (tmp_path / "src").rglob("*.png"))
    assert names == sorted(p.relative_to(tmp_path / "ref").as_posix()
                           for p in (tmp_path / "ref").rglob("*.png"))
    for name in names:
        if name == "broken.png":
            continue
        got = load_image(tmp_path / "src" / name).astype(int)
        want = load_image(tmp_path / "ref" / name).astype(int)
        assert got.shape == want.shape == (48, 64, 3), name
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.02, (
            name, diff.max(), (diff > 0).mean())


def test_convert_cli(tmp_path, capsys):
    _sources(tmp_path / "src")
    cli(["convert", "--dataset-dir", str(tmp_path / "src"),
         "--source-format", "png", "--size", "32", "--device", "cpu"])
    assert "converted 4 images" in capsys.readouterr().out
    assert load_image(tmp_path / "src" / "sub" / "noisy.png").shape == (
        32, 32, 3)


def test_stage_clock_timings():
    """With timings, each stage adds its seconds under its name (twice for
    a stage run twice); without, the stages time nothing."""
    timings: dict = {}
    clock = StageClock(timings, "cpu")
    for _ in range(2):
        with clock.stage("solve"):
            time.sleep(0.002)
    with clock.stage("write"):
        pass
    assert list(timings) == ["solve", "write"]
    assert 0.004 <= timings["solve"] < 1.0 and 0 <= timings["write"] < 0.5
    with StageClock(None, "cpu").stage("solve"):
        pass
    assert list(timings) == ["solve", "write"]


def test_device_trace_writes_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace") as handle:
        with span("smoke_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert handle.path.parent == tmp_path / "trace"
    events = json.loads(handle.path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "smoke_range" in names and "aten::mm" in names


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_partition_matches_reference(seed):
    from image_compression_tpu.utils import random_partition as jrp

    kw = dict(min_h=6, min_w=5, split_prob=0.7, min_rect_count=4,
              seed=seed)
    lab = trp.random_rect_partition(48, 40, **kw)
    np.testing.assert_array_equal(lab, jrp.random_rect_partition(48, 40,
                                                                 **kw))
    assert lab.dtype == np.int32 and len(np.unique(lab)) >= 4
    np.testing.assert_array_equal(trp.partition_to_edge_signs(lab),
                                  jrp.partition_to_edge_signs(lab))


def _photos(rng, shapes):
    return [rng.integers(0, 256, s, np.uint8) for s in shapes]


@pytest.mark.parametrize("name", ["generate_photo_mosaic",
                                  "generate_photo_collage"])
def test_photo_generators_match_reference(name):
    from image_compression_tpu.utils import pattern_generator as jpg

    photos = _photos(np.random.default_rng(9),
                     [(80, 90, 3), (70, 100, 4), (64, 64, 3)])
    got = getattr(tpg, name)(96, 80, photos, np.random.default_rng(3),
                             **({"cell": 32} if "mosaic" in name else {}))
    want = getattr(jpg, name)(96, 80, photos, np.random.default_rng(3),
                              **({"cell": 32} if "mosaic" in name else {}))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_small_photos_as_in_the_reference():
    from image_compression_tpu.utils import pattern_generator as jpg

    small = _photos(np.random.default_rng(5), [(20, 24, 3)])
    for mod in (tpg, jpg):
        with pytest.raises(ValueError):
            mod.generate_photo_mosaic(64, 64, small,
                                      np.random.default_rng(0), cell=32)
    got = tpg.generate_photo_collage(64, 64, small, np.random.default_rng(1))
    want = jpg.generate_photo_collage(64, 64, small,
                                      np.random.default_rng(1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
