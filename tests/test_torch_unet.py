"""EdgeUNet of the PyTorch port vs the flax reference, at f32 and a small
base. Tolerance: max |difference| <= 1e-5 x max |reference output| (both
sides sum the f32 convolutions and GroupNorm statistics in their own
order; measured ~4e-6 of the maximum)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.models.unet import EdgeUNet as JUNet
from image_compression_tpu.pipeline import learned_costs as j_learned_costs
from image_compression_torch.models.convert import state_dict_from_flax
from image_compression_torch.models.unet import EdgeUNet, init_random_
from image_compression_torch.pipeline import learned_costs

torch.set_num_threads(1)


def _pair(base, size, seed=1):
    """Same random flax params in both models (f32)."""
    jm = JUNet(base=base, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3))))
    tm = EdgeUNet(base=base, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, tm.eval()


def _close(ref, got):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("size", [32, 36])
def test_forward_f32(size):
    """36 exercises the odd-size pad correction of the up path."""
    jm, params, tm = _pair(8, size)
    x = np.random.default_rng(0).random((2, size, size, 3)).astype(
        np.float32)
    with torch.no_grad():
        _close(jax.jit(jm.apply)(params, jnp.asarray(x)),
               tm(torch.as_tensor(x)).numpy())


def test_learned_costs_f32():
    jm, params, tm = _pair(8, 32)
    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        _close(jax.jit(lambda p, b: j_learned_costs(jm, p, b))(
            params, jnp.asarray(x)),
               learned_costs(tm, torch.as_tensor(x)).numpy())


def test_bf16_model_runs_and_seeded_init_is_deterministic():
    a = init_random_(EdgeUNet(base=8), seed=3)
    b = init_random_(EdgeUNet(base=8), seed=3)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    x = torch.rand((1, 16, 16, 3))
    with torch.no_grad():
        out = a(x)
    assert out.shape == (1, 16, 16, 4) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
