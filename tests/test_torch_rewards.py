"""Rewards of the PyTorch port (ops/rewards.compute_rewards_batched, the flat
estimator) vs the JAX reference, in every mode: the size-difference reward
with the single-segment penalty, fallback_aware with and without its clip
binding, sorted and minlabel stats, the fast and the flat estimator, the
reference and the product estimator profiles, and k_max overflow.
Tolerance: rewards within 1e-5 relative (+ 1e-6 absolute; both sides sum
f32 slot sizes in their own order); per-slot flat sizes within 1e-5
relative. The solve-and-reward stage of the RL step is held on integer
costs (labels bitwise, rewards as above)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.config import Config as JConfig
from image_compression_tpu.ops import png_estimator as je
from image_compression_tpu.ops import rewards as jr
from image_compression_tpu.ops import segment_stats as js
from image_compression_tpu.ops.multicut import multicut_grid as j_multicut
from image_compression_torch.config import Config
from image_compression_torch.ops import png_estimator as te
from image_compression_torch.ops import rewards as tr
from image_compression_torch.ops import segment_stats as ts
from image_compression_torch.train.steps import solve_and_reward

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
PRODUCT = dict(overhead_base=68.0, entropy_correction="miller_madow",
               literal_hist="nonmatch", distance_window=32768)


def _blocks(h, w, bs):
    ys, xs = np.mgrid[:h, :w]
    return ((ys // bs * bs) * w + (xs // bs * bs)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _fixture():
    """Four 32x32 images (noise, gradient, noise + flat halves, low-amplitude
    noise) with block partitions, a two-region split and one region;
    labels are each region's smallest pixel index (minlabel form)."""
    rng = np.random.default_rng(4)
    ys, xs = np.mgrid[:32, :32]
    half = np.concatenate([rng.random((32, 16, 3)),
                           np.full((32, 16, 3), 0.4)], axis=1)
    images = np.stack([
        rng.random((32, 32, 3)),
        np.repeat(((ys + xs) / 62.0)[..., None], 3, -1),
        half,
        np.clip(rng.normal(0.5, 0.03, (32, 32, 3)), 0, 1)]).astype(np.float32)
    split = np.where(xs < 16, 0, 16).astype(np.int32)
    labels = np.stack([_blocks(32, 32, 8), _blocks(32, 32, 16), split,
                       np.zeros((32, 32), np.int32)])
    sizes = np.array([3300.0, 400.0, 1800.0, 2500.0], np.float32)
    return images, labels, sizes


@pytest.mark.parametrize("mode", [
    dict(),                                          # penalty, sorted stats
    dict(minlabel=True, lam=0.7),
    dict(minlabel=True, fallback_aware=True),
    dict(minlabel=True, fallback_aware=True, fallback_reward_clip=0.02),
    dict(minlabel=True, fast=False),
    dict(fast=False, fallback_aware=True, **PRODUCT),
    dict(minlabel=True, k_max=8, adaptive_filter=False),  # overflow
], ids=["penalty", "minlabel_lam", "fallback_aware", "fallback_clip",
        "flat", "flat_fallback_product", "overflow_fixed"])
def test_compute_rewards_batched(mode):
    images, labels, sizes = _fixture()
    kw = {"k_max": 16, **mode}
    ref = np.asarray(jr.compute_rewards_batched(
        jnp.asarray(images), jnp.asarray(labels), jnp.asarray(sizes), **kw))
    got = tr.compute_rewards_batched(torch.as_tensor(images),
                                     torch.as_tensor(labels),
                                     torch.as_tensor(sizes), **kw).numpy()
    assert got.dtype == np.float32 and got.shape == (4,)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if "fallback_reward_clip" in mode:  # the clip binds somewhere
        assert (ref == -mode["fallback_reward_clip"]).any()
    if not mode.get("fallback_aware"):
        # the single-segment penalty: lam on the one-region image only
        no_pen = tr.compute_rewards_batched(
            torch.as_tensor(images), torch.as_tensor(labels),
            torch.as_tensor(sizes), **dict(kw, lam=0.0)).numpy()
        lam = mode.get("lam", 0.5)
        np.testing.assert_allclose(no_pen - got, [0, 0, 0, lam], atol=1e-6)


@pytest.mark.parametrize("profile", [{}, PRODUCT])
def test_flat_estimator_per_slot(profile):
    """estimate_segment_png_sizes (every slot over the whole image) per
    slot, image by image against the reference's; on the images of at most
    2 segments (within the fast estimator's slot caps, so it evaluates
    every slot rather than bounding it) equal to the fast estimator."""
    images, labels, _ = _fixture()
    rgba = tr.to_rgba_u8(torch.as_tensor(images))
    stats = ts.segment_stats_minlabel(torch.as_tensor(labels), 16)
    got = te.estimate_segment_png_sizes(rgba, stats.inverse, stats.counts,
                                        stats.bboxes, stats.valid,
                                        **profile).numpy()
    for i in range(len(images)):
        st = js.segment_stats_minlabel(jnp.asarray(labels[i]), 16)
        ref = np.asarray(je.estimate_segment_png_sizes(
            jnp.asarray(rgba[i].numpy()), st.inverse, st.counts, st.bboxes,
            st.valid, **profile))
        np.testing.assert_allclose(got[i], ref, rtol=RTOL)
    fast = te.estimate_segment_png_sizes_fast(
        rgba, stats.inverse, stats.counts, stats.bboxes, stats.valid,
        **profile).numpy()
    np.testing.assert_allclose(fast[2:], got[2:], rtol=RTOL)


def test_solve_and_reward_integer_costs():
    """The RL step's solve-and-reward stage (the solver at the shipped
    settings, with matrix aggregation, minlabel stats; the shipped reward
    profile, fast estimator) on integer-valued sampled costs: labels
    bitwise, rewards within 1e-5 of the reference's vmapped multicut_grid
    + compute_rewards_batched; in both the plain reward and the
    fallback-aware one."""
    from image_compression_torch.ops.edges import (flatten_edge_planes,
                                                   unflatten_edge_planes)

    images, _, sizes = _fixture()
    rng = np.random.default_rng(9)
    planes = rng.integers(-3, 9, (4, 32, 32, 2)).astype(np.float32)
    w = flatten_edge_planes(torch.as_tensor(planes))
    cfg = Config()
    jcfg = JConfig()
    jcfg.multicut.hier_agg = cfg.multicut.hier_agg
    mc = jcfg.multicut
    j_labels = jax.jit(jax.vmap(functools.partial(
        j_multicut, mode=mc.mode, max_rounds=mc.max_rounds,
        icm_sweeps=mc.icm_sweeps, hier_rounds=tuple(mc.hier_rounds),
        hier_caps=mc.hier_caps, hier_agg=mc.hier_agg)))(
        jnp.asarray(unflatten_edge_planes(w, 32, 32).numpy()))
    for fallback_aware in (False, True):
        cfg.reward.fallback_aware = fallback_aware
        rw = cfg.reward
        ref = np.asarray(jr.compute_rewards_batched(
            jnp.asarray(images), j_labels, jnp.asarray(sizes),
            k_max=rw.max_segments, min_pixels=rw.min_pixels_per_segment,
            l_min=rw.l_min, beta=rw.beta, b_match_token=rw.b_match_token,
            gamma=rw.gamma, overhead_base=rw.overhead_base,
            adaptive_filter=rw.adaptive_filter,
            lam=rw.lambda_single_segment,
            entropy_correction=rw.entropy_correction,
            literal_hist=rw.literal_hist,
            distance_window=rw.distance_window,
            fallback_aware=fallback_aware,
            fallback_reward_clip=rw.fallback_reward_clip, minlabel=True))
        labels, got = solve_and_reward(w, torch.as_tensor(images),
                                       torch.as_tensor(sizes), cfg)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
        got = got.numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
