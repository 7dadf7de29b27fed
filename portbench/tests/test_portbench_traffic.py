"""The seeded corpus copy and the benchmark's PNG codec."""

import numpy as np
import pytest

from portbench import pngcodec
from portbench.traffic import generator


def test_seed_zero_is_the_ports_mixed_corpus():
    from image_compression_torch.utils.pattern_generator import mixed_corpus
    ours = list(generator.mixed_corpus(12, 256, (64, 128), seed=0))
    theirs = list(mixed_corpus(12, 256, (64, 128)))
    assert [s for s, _ in ours] == [s for s, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_seeds_differ_in_pixels_not_in_shape():
    a = list(generator.mixed_corpus(4, 64, (16, 32), seed=2 ** 31 + 7))
    b = list(generator.mixed_corpus(4, 64, (16, 32), seed=2 ** 31 + 8))
    assert [s for s, _ in a] == [s for s, _ in b]
    assert all(x.shape == y.shape for (_, x), (_, y) in zip(a, b))
    assert any(not np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_encoder_is_the_ports():
    from image_compression_torch.io import pypng
    for _, img in generator.mixed_corpus(4, 64, (16, 32), seed=3):
        assert pngcodec.encode(img, 6) == pypng.encode(img, 6)


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 5, 4), (33, 20, 3)])
def test_decode_round_trip(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[shape[0] // 2:] = img[:shape[0] - shape[0] // 2]  # Up/Paeth rows
    for level in (0, 4, 9):
        assert np.array_equal(pngcodec.decode(pngcodec.encode(img, level)),
                              img)


def test_decode_rejects_damage():
    data = bytearray(pngcodec.encode(np.zeros((4, 4, 3), np.uint8), 4))
    data[40] ^= 1
    with pytest.raises(ValueError):
        pngcodec.decode(bytes(data))


def test_make_writes_sorted_corpus(tmp_path):
    params = {"generator": "mixed_corpus", "images": 5, "size": 32,
              "cells": [8, 16], "png_level": 6}
    corpus = generator.make(params, 11, tmp_path)
    assert list(corpus) == sorted(corpus)
    for stem, rec in corpus.items():
        data = (tmp_path / f"{stem}.png").read_bytes()
        assert len(data) == rec["png_bytes"]
        assert np.array_equal(pngcodec.decode(data), rec["image"])
