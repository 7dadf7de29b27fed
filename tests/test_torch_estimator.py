"""PNG size estimator and size totals of the PyTorch port vs the JAX
reference. Sizes agree within a relative 1e-5: both sides compute in f32 but
may group sums (entropy over 256 bins, totals over slots) differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import png_estimator as je
from image_compression_tpu.ops import rewards as jr
from image_compression_tpu.ops import segment_stats as js
from image_compression_torch.ops import png_estimator as te
from image_compression_torch.ops import rewards as tr
from image_compression_torch.ops import segment_stats as ts

torch.set_num_threads(1)

RTOL = 1e-5
PROFILES = {
    "reference": {},
    "product": dict(overhead_base=68.0, entropy_correction="miller_madow",
                    literal_hist="nonmatch", distance_window=32768),
    "fixed_filter": dict(adaptive_filter=False, l_min=3),
}


def _blocks(h, w, bs):
    ys, xs = np.mgrid[:h, :w]
    return ((ys // bs * bs) * w + (xs // bs * bs)).astype(np.int32)


def _fixture():
    """Noise, a gradient, a vertically periodic tile (LZ-window term) and
    low-amplitude noise, with block partitions of several sizes."""
    rng = np.random.default_rng(2)
    ys, xs = np.mgrid[:64, :64]
    images = np.stack([
        rng.random((64, 64, 3)),
        np.repeat(((ys + xs) / 126.0)[..., None], 3, -1),
        np.tile(rng.random((8, 64, 3)), (8, 1, 1)),
        np.clip(rng.normal(0.5, 0.03, (64, 64, 3)), 0, 1)]).astype(np.float32)
    labels = np.stack([_blocks(64, 64, 16), _blocks(64, 64, 8),
                       _blocks(64, 64, 32), np.zeros((64, 64), np.int32)])
    return images, labels


@pytest.mark.parametrize("profile,minlabel,k_max", [
    ("reference", True, 64), ("reference", False, 16),
    ("product", True, 64), ("product", True, 16), ("product", False, 64),
    ("fixed_filter", True, 16)])
def test_total_sizes(profile, minlabel, k_max):
    """k_max 16 overflows the 8-pixel block partition (64 segments): the
    clamp slot and the surplus-overhead bound are priced too."""
    images, labels = _fixture()
    kw = dict(k_max=k_max, minlabel=minlabel, **PROFILES[profile])
    ref = np.asarray(jr.estimated_total_sizes_batched(
        jnp.asarray(images), jnp.asarray(labels), **kw))
    got = tr.estimated_total_sizes_batched(torch.as_tensor(images),
                                           torch.as_tensor(labels), **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)


def test_to_rgba_u8_bitwise():
    images, _ = _fixture()
    np.testing.assert_array_equal(
        np.asarray(jr.to_rgba_u8(jnp.asarray(images))),
        tr.to_rgba_u8(torch.as_tensor(images)).numpy())


@pytest.mark.parametrize("class_caps", [None, (2, 1)])
def test_per_slot_sizes_fast(class_caps):
    """Every slot's size, including spills past tight class caps into the
    literal-only bound."""
    images, labels = _fixture()
    rgba = np.array(jr.to_rgba_u8(jnp.asarray(images)))
    st = ts.segment_stats(torch.as_tensor(labels), 64)
    kw = dict(class_caps=class_caps, **PROFILES["product"])
    got = te.estimate_segment_png_sizes_fast(
        torch.as_tensor(rgba), st.inverse, st.counts, st.bboxes, st.valid,
        **kw)
    for i in range(len(labels)):
        s = js.segment_stats(jnp.asarray(labels[i]), 64)
        ref = je.estimate_segment_png_sizes_fast(
            jnp.asarray(rgba[i]), s.inverse, s.counts, s.bboxes, s.valid, **kw)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=0)


def test_per_slot_sizes_packed():
    """Batch-pooled caps: spills depend on batch order exactly as in the
    reference."""
    images, labels = _fixture()
    rgba = np.array(jr.to_rgba_u8(jnp.asarray(images)))
    st = ts.segment_stats(torch.as_tensor(labels), 64)
    got = te.estimate_segment_png_sizes_packed(
        torch.as_tensor(rgba), st.inverse, st.counts, st.bboxes, st.valid,
        class_caps=(12, 3))
    ref = je.estimate_segment_png_sizes_packed(
        jnp.asarray(rgba), jnp.asarray(st.inverse.numpy()),
        jnp.asarray(st.counts.numpy()), jnp.asarray(st.bboxes.numpy()),
        jnp.asarray(st.valid.numpy()), class_caps=(12, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=0)


def test_classify_and_pack_bitwise():
    rng = np.random.default_rng(9)
    x0 = rng.integers(0, 200, 40)
    y0 = rng.integers(0, 200, 40)
    side = rng.choice([8, 30, 60, 100, 250], 40)
    bboxes = np.stack([x0, y0, x0 + side, y0 + side], 1).astype(np.int32)
    valid = rng.random(40) < 0.9
    sizes, caps = [32, 64, 128, 256], [6, 5, 4, 3]
    ref = je._classify_and_pack(jnp.asarray(bboxes), jnp.asarray(valid),
                                sizes, caps, 40)
    got = te._classify_and_pack(torch.as_tensor(bboxes, dtype=torch.int64),
                                torch.as_tensor(valid), sizes, caps)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
