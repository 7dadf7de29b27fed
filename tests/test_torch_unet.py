"""EdgeUNet of the PyTorch port vs the flax reference, at f32 and a small
base. Tolerance: max |difference| <= 1e-5 x max |reference output| (both
sides sum the f32 convolutions and GroupNorm statistics in their own
order; measured ~4e-6 of the maximum)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_compression_tpu.models.unet import EdgeUNet as JUNet
from image_compression_tpu.pipeline import learned_costs as j_learned_costs
from image_compression_torch.models import unet
from image_compression_torch.models.convert import state_dict_from_flax
from image_compression_torch.models.unet import EdgeUNet, init_random_
from image_compression_torch.ops.group_norm_relu import (
    group_norm_relu, group_norm_relu_plain)
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


def test_norm_relu_on_the_cpu_is_the_chain():
    """On the CPU the norm's entry point and its plain version are the
    chain bit for bit: x.float(), F.group_norm, F.relu, back to x's dtype;
    also on a plane whose size is not a multiple of 8."""
    gen = torch.Generator().manual_seed(4)
    w, b = torch.randn(16, generator=gen), torch.randn(16, generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn((2, 16, 9, 13), generator=gen) * 2 + 0.5).to(dtype)
        want = F.relu(F.group_norm(x.float(), 8, w, b, 1e-6)).to(dtype)
        for fn in (group_norm_relu, group_norm_relu_plain):
            got = fn(x, w, b, 8, 1e-6)
            assert got.dtype == dtype
            assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                        else torch.int32),
                               want.view(torch.int16 if dtype == torch.bfloat16
                                         else torch.int32))


def test_double_conv_picks_the_chain_outside_inference_mode(monkeypatch):
    """A bf16 U-Net sends its 14 norms to group_norm_relu (the kernel on a
    card) under inference mode only; under no_grad, with grad, and for an
    f32 U-Net they run the chain. On the CPU every mode gives the same
    output bit for bit."""
    calls = []

    def recorded(name, fn):
        def call(*args):
            calls.append(name)
            return fn(*args)
        return call

    monkeypatch.setattr(unet, "group_norm_relu",
                        recorded("entry", group_norm_relu))
    monkeypatch.setattr(unet, "group_norm_relu_plain",
                        recorded("chain", group_norm_relu_plain))
    x = torch.rand((1, 20, 28, 3), generator=torch.Generator().manual_seed(5))
    outs = []
    for dtype, mode, want in (
            (torch.bfloat16, torch.inference_mode, "entry"),
            (torch.bfloat16, torch.no_grad, "chain"),
            (torch.bfloat16, contextlib.nullcontext, "chain"),
            (torch.float32, torch.inference_mode, "chain")):
        model = init_random_(EdgeUNet(base=8, dtype=dtype), seed=6)
        calls.clear()
        with mode():
            out = model(x)
        assert calls == [want] * 14, (dtype, mode)
        if dtype == torch.bfloat16:
            outs.append(out.detach())
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
