"""Canny, watershed, the colour helpers and the pretraining targets of the
PyTorch port against the JAX reference on the CPU: edge planes and labels
bitwise on seeded 2 x 48x48 images and on flat and step fixtures, a batch
equal to each image run alone, and create_target_with_mask for every
EdgeTarget (graph and SLIC there at the agreement the statistical
extractors are held to, tests/test_torch_graph_based.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.config import EdgeTarget as JEdgeTarget
from image_compression_tpu.ops import canny as jcanny
from image_compression_tpu.ops import color as jcolor
from image_compression_tpu.ops import targets as jtargets
from image_compression_tpu.ops import watershed as jws
from image_compression_torch.config import EdgeTarget
from image_compression_torch.ops import canny, color, targets, watershed

torch.set_num_threads(1)


def _structured(rng, h, w):
    """Blocks of colour with mild noise and a noisy patch: strong, weak and
    absent edges, several watershed basins."""
    img = np.zeros((h, w, 3), np.float32)
    img[:, :] = (0.15, 0.35, 0.6)
    img[h // 6:2 * h // 3, w // 5:3 * w // 4] = (0.8, 0.25, 0.1)
    img[h // 2:, : w // 3] = (0.3, 0.85, 0.4)
    img += rng.normal(0, 6 / 255.0, img.shape)
    img[-h // 4:, -w // 4:] = rng.random((h // 4, w // 4, 3))
    return np.clip(img, 0, 1).astype(np.float32)


def _fixtures():
    rng = np.random.default_rng(0)
    seeded = np.stack([_structured(rng, 48, 48), rng.random((48, 48, 3))
                       .astype(np.float32)])
    flat = np.full((1, 32, 32, 3), 0.5, np.float32)
    step = np.zeros((1, 32, 40, 3), np.float32)
    step[:, :, 20:] = 1.0
    return {"seeded 2x48x48": seeded, "flat": flat, "step": step}


FIXTURES = _fixtures()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_canny_bitwise(name):
    imgs = FIXTURES[name]
    want = np.asarray(jcanny.canny_edge_costs(jnp.asarray(imgs)))
    got = canny.canny_edge_costs(torch.as_tensor(imgs)).numpy()
    np.testing.assert_array_equal(got, want)
    edges = canny.canny_edges(torch.as_tensor(imgs)).numpy()
    np.testing.assert_array_equal(
        edges, np.asarray(jcanny.canny_edges(jnp.asarray(imgs))))
    if name == "seeded 2x48x48":
        assert edges.mean() > 0.05  # hysteresis grew real edge chains
    if name == "flat":
        assert not edges.any()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_watershed_bitwise(name):
    imgs = FIXTURES[name]
    want = np.asarray(jax.vmap(jws.watershed_labels)(jnp.asarray(imgs)))
    got = watershed.watershed_labels(torch.as_tensor(imgs)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        watershed.watershed_edge_costs(torch.as_tensor(imgs)).numpy(),
        np.asarray(jws.watershed_edge_costs(jnp.asarray(imgs))))


def test_watershed_sweep_bound_is_exact():
    """With max_iters binding (3 sweeps), each image of a batch stops at
    exactly the bound, as the reference's while_loop does."""
    imgs = FIXTURES["seeded 2x48x48"]
    want = np.asarray(jax.vmap(lambda x: jws.watershed_labels(
        x, max_iters=3))(jnp.asarray(imgs)))
    got = watershed.watershed_labels(torch.as_tensor(imgs),
                                     max_iters=3).numpy()
    np.testing.assert_array_equal(got, want)
    full = watershed.watershed_labels(torch.as_tensor(imgs)).numpy()
    assert (got != full).any()  # the bound did bind


@pytest.mark.parametrize("fn", [canny.canny_edge_costs,
                                watershed.watershed_edge_costs])
def test_batch_equals_single(fn):
    imgs = torch.as_tensor(FIXTURES["seeded 2x48x48"])
    batch = fn(imgs)
    for i in range(2):
        torch.testing.assert_close(fn(imgs[i:i + 1])[0], batch[i], rtol=0,
                                   atol=0)


def test_color_helpers_bitwise():
    rng = np.random.default_rng(3)
    img = rng.random((2, 20, 24, 3)).astype(np.float32)
    u8 = (img * 255).astype(np.uint8)
    for x in (img, u8):
        np.testing.assert_array_equal(
            color.rgb_to_gray_u8(torch.as_tensor(x)).numpy(),
            np.asarray(jcolor.rgb_to_gray_u8(jnp.asarray(x))))
    np.testing.assert_array_equal(color.to_u8(torch.as_tensor(img)).numpy(),
                                  np.asarray(jcolor.to_u8(jnp.asarray(img))))
    planes = (rng.random((2, 3, 20, 24)) * 255).astype(np.float32)
    for ksize in (3, 9):
        np.testing.assert_array_equal(
            color.gaussian_blur(torch.as_tensor(planes), ksize, 1.0).numpy(),
            np.asarray(jcolor.gaussian_blur(jnp.asarray(planes), ksize, 1.0)))


@pytest.mark.parametrize("target", list(EdgeTarget))
def test_create_target_with_mask(target):
    """Shape, the {0, 1} costs and the masks of the reference; canny and
    watershed equal it bitwise, graph and SLIC on >= 99% of entries."""
    rng = np.random.default_rng(1)
    imgs = np.stack([_structured(rng, 48, 48)] * 2)
    want = np.asarray(jtargets.create_target_with_mask(
        jnp.asarray(imgs), JEdgeTarget(target.value)))
    got = targets.create_target_with_mask(torch.as_tensor(imgs),
                                          target).numpy()
    assert got.shape == want.shape == (2, 48, 48, 4)
    np.testing.assert_array_equal(got[..., 2:], want[..., 2:])
    assert set(np.unique(got[..., :2])) <= {0.0, 1.0}
    if target in (EdgeTarget.CANNY, EdgeTarget.WATERSHED):
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("shape", [(1, 1), (3, 7)])
def test_tiny_images_match_reference(shape):
    """Images smaller than a seed offset and than the blur's reach:
    reflect-101 padding wider than the side, one centre seed, one SLIC
    cell; every extractor's costs equal the reference's."""
    img = np.random.default_rng(7).random((1, *shape, 3)).astype(np.float32)
    for target in EdgeTarget:
        want = np.asarray(jtargets.compute_edge_costs(
            jnp.asarray(img), JEdgeTarget(target.value)))
        got = targets.compute_edge_costs(torch.as_tensor(img), target)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=target.value)
