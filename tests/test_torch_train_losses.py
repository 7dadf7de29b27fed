"""Pretraining loss and edge metrics of the PyTorch port (train/losses.py,
train/metrics.py) vs the JAX reference, f32.

Tolerances: loss terms within 1e-6 relative of the reference function
evaluated in f64 (the reference's own f32 sums over 2,000 edges on the
CPU drift 4.7e-6 from that value, the port's 1.5e-7), and within 1e-12 in
f64; confusion counts and the sign-accuracy counts exact; the gradient of
the pretraining loss through a base-8 EdgeUNet within 1e-4 x max |grad|
per tensor against jax.grad in f32 (both sides sum the convolutions' f32
products in their own order), except the conv biases that feed a
GroupNorm of one channel per group (the first DoubleConv at base 8), whose
gradient is zero in exact arithmetic: those are held to 1e-5 x the largest
gradient of the model on both sides (rounding noise)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.models.unet import EdgeUNet as JUNet
from image_compression_tpu.train import losses as jl
from image_compression_tpu.train import metrics as jm
from image_compression_torch.config import Config
from image_compression_torch.models.convert import (flax_from_state_dict,
                                                    state_dict_from_flax)
from image_compression_torch.models.unet import GROUPS, EdgeUNet, init_random_
from image_compression_torch.train import losses as tl
from image_compression_torch.train import metrics as tm
from image_compression_torch.train.steps import _pretrain_loss

torch.set_num_threads(1)


def _inputs(seed=0, shape=(3, 16, 20)):
    """Raw outputs with large and near-zero logits, soft and hard labels,
    masks with the padding column/row zero and a few holes."""
    rng = np.random.default_rng(seed)
    out = (rng.normal(size=shape + (4,)) * 3).astype(np.float32)
    out[0, :2, :2, 0] = 0.0  # p = 0.5 exactly: predicted connect
    y = (rng.random(shape + (2,)) < 0.6).astype(np.float32)
    y[1, :, :3, 0] = 0.3  # soft labels
    mask = np.ones(shape + (2,), np.float32)
    mask[:, :, -1, 0] = 0
    mask[:, -1, :, 1] = 0
    mask[-1, 5:9, 5:9] = 0
    return out, np.concatenate([y, mask], axis=-1)


@pytest.mark.parametrize("kw", [
    {}, dict(pos_weight=0.7, w_sign=0.5, w_sigma=0.3, sigma_min=0.05,
             sigma_max=1.5)])
def test_pretrain_loss(kw):
    out, targets = _inputs()
    with jax.enable_x64(True):
        ref = jl.pretrain_loss(jnp.asarray(out, jnp.float64),
                               jnp.asarray(targets, jnp.float64), **kw)
        ref = [float(v) for v in ref]
    names = tl.PretrainLossOut._fields
    for dtype, rtol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        got = tl.pretrain_loss(torch.as_tensor(out, dtype=dtype),
                               torch.as_tensor(targets, dtype=dtype), **kw)
        for name, r, g in zip(names, ref, got):
            np.testing.assert_allclose(float(g), r, rtol=rtol,
                                       err_msg=f"{name} {dtype}")
    f32 = jl.pretrain_loss(jnp.asarray(out), jnp.asarray(targets), **kw)
    assert int(got.correct) == int(f32.correct)
    assert int(got.valid) == int(f32.valid)


def test_pretrain_loss_all_masked():
    """No valid edge: the denominators clamp at 1 as in the reference."""
    out, targets = _inputs(1)
    targets[..., 2:] = 0
    ref = jl.pretrain_loss(jnp.asarray(out), jnp.asarray(targets))
    got = tl.pretrain_loss(torch.as_tensor(out), torch.as_tensor(targets))
    assert float(got.loss) == float(ref.loss) == 0.0
    assert float(got.valid_weight) == float(ref.valid_weight) == 2.0


@pytest.mark.parametrize("thresh", [0.5, 0.3])
def test_edge_metrics_counts_exact(thresh):
    out, targets = _inputs(2)
    ref = jm.edge_metrics(jnp.asarray(out), jnp.asarray(targets), thresh)
    got = tm.edge_metrics(torch.as_tensor(out), torch.as_tensor(targets),
                          thresh)
    assert tuple(int(v) for v in got) == tuple(int(v) for v in ref)
    both = got + got
    assert tuple(int(v) for v in both) == tuple(2 * int(v) for v in ref)
    assert (got + got).summary() == pytest.approx((ref + ref).summary(),
                                                  rel=1e-12)
    assert got.summary() == pytest.approx(ref.summary(), rel=1e-12)


def test_metrics_logger_records(tmp_path):
    """One JSON object per line under the reference's file name, "time"
    first, appended across loggers of one run id."""
    import json
    for i in range(2):
        log = tm.MetricsLogger(tmp_path, "run7")
        log.write({"phase": "pretrain", "epoch": i})
        log.close()
    lines = (tmp_path / "metrics_run7.jsonl").read_text().splitlines()
    recs = [json.loads(ln) for ln in lines]
    assert [list(r) for r in recs] == [["time", "phase", "epoch"]] * 2
    assert [r["epoch"] for r in recs] == [0, 1]


@functools.lru_cache(maxsize=None)
def _unet_pair():
    """The flax model and seeded random params (the port's init, mapped to
    the flax tree: no init program to compile)."""
    jnet = JUNet(base=8, dtype=jnp.float32)
    params = flax_from_state_dict(init_random_(
        EdgeUNet(base=8, dtype=torch.float32), 4).state_dict())
    return jnet, params


def test_pretrain_loss_gradients():
    """d loss / d params of the whole pretraining loss (BCE, the detached
    sigma NLL) through the U-Net, against jax.grad."""
    jnet, params = _unet_pair()
    rng = np.random.default_rng(3)
    images = rng.random((2, 32, 32, 3)).astype(np.float32)
    _, targets = _inputs(3, (2, 32, 32))
    cfg = Config()
    p = cfg.pretrain

    def jloss(prm):
        out = jnet.apply(prm, jnp.asarray(images))
        return jl.pretrain_loss(out, jnp.asarray(targets),
                                pos_weight=p.pos_weight, w_sign=p.w_sign,
                                w_sigma=p.w_sigma, sigma_min=p.sigma_min,
                                sigma_max=p.sigma_max).loss

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, ref_grads))

    model = EdgeUNet(base=8, dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params))
    loss = _pretrain_loss(model(torch.as_tensor(images)),
                          torch.as_tensor(targets), cfg).loss
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    _check_grads(model, ref)


def _check_grads(model, ref):
    """Per tensor within 1e-4 x max |reference grad|; a conv bias feeding a
    GroupNorm of one channel per group has zero gradient in exact
    arithmetic and is held to 1e-5 x the model's largest gradient on both
    sides."""
    scale = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, prm in model.named_parameters():
        want = ref[name].numpy()
        got = prm.grad.numpy()
        if (name.endswith(("conv0.bias", "conv1.bias"))
                and prm.numel() == GROUPS):
            assert np.abs(got).max() <= 1e-5 * scale, name
            assert np.abs(want).max() <= 1e-5 * scale, name
            continue
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_sigma_nll_does_not_reach_the_logits():
    """The stop-gradient on p: the sigma NLL's gradient w.r.t. the mu
    logits is zero; w.r.t. the sigma channels it is the reference's."""
    out, targets = _inputs(4)
    kw = dict(w_sign=0.0, w_sigma=1.0)
    ref = jax.grad(lambda o: jl.pretrain_loss(o, jnp.asarray(targets),
                                              **kw).loss)(jnp.asarray(out))
    x = torch.as_tensor(out).requires_grad_(True)
    tl.pretrain_loss(x, torch.as_tensor(targets), **kw).loss.backward()
    assert not x.grad[..., 0::2].any()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-9)


def test_loss_gradient_wrt_outputs_at_zero_logits():
    """d loss / d outputs of the full loss equals jax.grad's everywhere,
    also where a logit is exactly 0 (a base-8 U-Net gives exact zeros
    where every feature of a pixel is cut by the ReLU): there jax's
    subgradients (the max splits the tie, |x|' = 1) give -y, not 1 - y."""
    out, targets = _inputs(0)
    assert (out[..., 0] == 0).sum() == 4
    ref = jax.grad(lambda o: jl.pretrain_loss(o, jnp.asarray(targets)).loss)(
        jnp.asarray(out))
    x = torch.as_tensor(out).requires_grad_(True)
    tl.pretrain_loss(x, torch.as_tensor(targets)).loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-9)
