"""Connectivity wire of the PyTorch port vs the JAX reference: the packed
bytes are bitwise equal, and the host rebuild recovers minlabel ids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.ops import labels_wire as jw
from image_compression_torch.ops import labels_wire as tw
from image_compression_torch.ops.multicut import relabel_connected

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 7, 13), (1, 16, 9)])
def test_pack_connectivity_bitwise(shape):
    rng = np.random.default_rng(shape[-1])
    labels = rng.integers(0, 3, size=shape).astype(np.int32)
    h_ref, v_ref = jw.pack_connectivity(jnp.asarray(labels))
    h, v = tw.pack_connectivity(torch.as_tensor(labels))
    np.testing.assert_array_equal(np.asarray(h_ref), h.numpy())
    np.testing.assert_array_equal(np.asarray(v_ref), v.numpy())


def test_labels_from_connectivity_roundtrip():
    """Packing minlabel labels and rebuilding them is the identity."""
    rng = np.random.default_rng(3)
    raw = torch.as_tensor(rng.integers(0, 4, size=(2, 20, 21)))
    labels = relabel_connected(raw)
    h, v = tw.pack_connectivity(labels)
    for i in range(2):
        rebuilt = tw.labels_from_connectivity(h[i].numpy(), v[i].numpy(),
                                              20, 21)
        np.testing.assert_array_equal(rebuilt, labels[i].numpy())
        np.testing.assert_array_equal(
            rebuilt, jw.labels_from_connectivity(h[i].numpy(), v[i].numpy(),
                                                 20, 21))
