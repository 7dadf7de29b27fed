"""Felzenszwalb (hierarchical at 64x64 and 48x80, pixel-space at 40x44)
and SLIC of the PyTorch port against the JAX reference on the CPU:
bitwise labels on piecewise-constant block images; on seeded noisy images
>= 99% of edge-cost entries equal to the reference's, with the min_size
property of tests/test_extractors.py held; a batch of 2 equal to each image
run alone."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from image_compression_tpu.ops import edges as jedges
from image_compression_tpu.ops import graph_based as jgraph
from image_compression_tpu.ops import slic as jslic
from image_compression_torch.ops import edges as tedges
from image_compression_torch.ops import graph_based, slic

torch.set_num_threads(1)


def _blocks(h, w, seed, side=16, noise=0.0):
    """Piecewise-constant blocks of random colour (noise > 0: plus Gaussian
    noise of that standard deviation, in [0, 1] units)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    for y in range(0, h, side):
        for x in range(0, w, side):
            img[y:y + side, x:x + side] = rng.random(3)
    img += noise * rng.standard_normal(img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _images(h, w):
    """[block image, block image with other block sides] and two noisy
    ones: blocks under noise, and a smooth field under noise."""
    rng = np.random.default_rng(h * w)
    ys, xs = np.mgrid[:h, :w] / max(h, w)
    smooth = np.stack([ys, xs, (ys + xs) / 2], -1)
    smooth = smooth + 0.04 * rng.standard_normal(smooth.shape)
    return (np.stack([_blocks(h, w, 1), _blocks(h, w, 2, side=8)]),
            np.stack([_blocks(h, w, 3, noise=0.03),
                      np.clip(smooth, 0, 1).astype(np.float32)]))


# (name, height, width, hier)
GRAPH_CASES = [("hier 64x64", 64, 64, True), ("hier 48x80", 48, 80, True),
               ("pixel-space 40x44", 40, 44, False)]


@functools.lru_cache(maxsize=None)
def _graph_run(h, w, hier):
    blocks, noisy = _images(h, w)
    fn = jax.vmap(functools.partial(jgraph.felzenszwalb_labels, hier=hier))
    out = {}
    for kind, imgs in (("blocks", blocks), ("noisy", noisy)):
        out[kind] = (imgs, np.asarray(fn(jnp.asarray(imgs))),
                     graph_based.felzenszwalb_labels(
                         torch.as_tensor(imgs), hier=hier).numpy())
    return out


@functools.lru_cache(maxsize=None)
def _slic_run(h, w):
    blocks, noisy = _images(h, w)
    out = {}
    for kind, imgs in (("blocks", blocks), ("noisy", noisy)):
        out[kind] = (imgs,
                     np.asarray(jax.vmap(jslic.slic_labels)(
                         jnp.asarray(imgs))),
                     slic.slic_labels(torch.as_tensor(imgs)).numpy())
    return out


def _edge_agreement(lab_a, lab_b):
    ea = np.asarray(jedges.edges_from_labels(jnp.asarray(lab_a)))
    eb = tedges.edges_from_labels(torch.as_tensor(lab_b)).numpy()
    return (ea == eb).mean()


@pytest.mark.parametrize("name,h,w,hier", GRAPH_CASES)
def test_graph_blocks_bitwise(name, h, w, hier):
    _imgs, want, got = _graph_run(h, w, hier)["blocks"]
    np.testing.assert_array_equal(got, want)
    assert all(len(np.unique(lab)) > 1 for lab in got)


@pytest.mark.parametrize("name,h,w,hier", GRAPH_CASES)
def test_graph_noisy_agreement_and_min_size(name, h, w, hier):
    _imgs, want, got = _graph_run(h, w, hier)["noisy"]
    assert _edge_agreement(want, got) >= 0.99
    assert max(len(np.unique(lab)) for lab in got) > 1
    for lab in got:
        _, sizes = np.unique(lab, return_counts=True)
        assert sizes.min() >= min(250, lab.size)


@pytest.mark.parametrize("name,h,w,hier", GRAPH_CASES)
def test_graph_batch_equals_single(name, h, w, hier):
    imgs, _want, got = _graph_run(h, w, hier)["noisy"]
    for i in range(2):
        alone = graph_based.felzenszwalb_labels(
            torch.as_tensor(imgs[i:i + 1]), hier=hier).numpy()
        np.testing.assert_array_equal(alone[0], got[i])


def test_graph_edge_costs_bitwise_on_blocks():
    imgs, _want, _got = _graph_run(64, 64, True)["blocks"]
    np.testing.assert_array_equal(
        graph_based.graph_based_edge_costs(torch.as_tensor(imgs)).numpy(),
        np.asarray(jgraph.graph_based_edge_costs(jnp.asarray(imgs))))


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80)])
def test_slic_blocks_bitwise_noisy_agreement(h, w):
    run = _slic_run(h, w)
    _imgs, want, got = run["blocks"]
    np.testing.assert_array_equal(got, want)
    _imgs, want, got = run["noisy"]
    assert _edge_agreement(want, got) >= 0.99
    for lab in got:  # every superpixel is one connected component
        for value in np.unique(lab):
            assert ndimage.label(lab == value)[1] == 1


def test_slic_batch_equals_single():
    imgs, _want, got = _slic_run(64, 64)["noisy"]
    for i in range(2):
        alone = slic.slic_labels(torch.as_tensor(imgs[i:i + 1])).numpy()
        np.testing.assert_array_equal(alone[0], got[i])


def test_graph_round_bound_is_exact():
    """Pixel-space phases capped at 2 rounds (binding on these images):
    each image of a batch stops at exactly the bound, as the reference's
    while_loop does."""
    imgs, _want, got = _graph_run(40, 44, False)["noisy"]
    fn = jax.vmap(functools.partial(jgraph.felzenszwalb_labels, hier=False,
                                    max_rounds=2))
    capped = graph_based.felzenszwalb_labels(torch.as_tensor(imgs),
                                             hier=False, max_rounds=2)
    np.testing.assert_array_equal(capped.numpy(),
                                  np.asarray(fn(jnp.asarray(imgs))))
    assert (capped.numpy() != got).any()  # the bound did bind
