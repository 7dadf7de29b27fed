"""Policy, advantages and RL losses of the PyTorch port (train/policy.py,
ops/prng.normal, models/value.py, the RL losses of train/steps.py) vs the
JAX reference, f32.

Tolerances: `normal` within 1e-6 absolute of jax.random.normal on 10^6
draws (the bits are bitwise; erfinv's f32 polynomial rounds apart);
sampled costs within 1e-6 x (1 + |w|); log-densities, entropies and
advantages within 1e-5 relative (sums over edges in f32); losses within
1e-5 relative + 1e-6 absolute (a loss is a zero-mean-weighted sum of O(1)
per-edge terms, so its own size may be far below theirs);
advantages use the population std (ddof 0), as jnp.std; gradients of the
RL losses through a base-8 EdgeUNet, and of the value net's loss, within
1e-4 x max |grad| per tensor against jax.grad (the conv biases that feed a
one-channel-per-group GroupNorm, zero in exact arithmetic, within 1e-5 x
the model's largest gradient: f32 rounding noise)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_compression_tpu.config import Config as JConfig
from image_compression_tpu.models.unet import EdgeUNet as JUNet
from image_compression_tpu.models.value import ValueNet as JValueNet
from image_compression_tpu.train import policy as jp
from image_compression_tpu.train.steps import _policy_forward
from image_compression_torch.config import Config
from image_compression_torch.models.convert import (flax_from_state_dict,
                                                    state_dict_from_flax)
from image_compression_torch.models.unet import GROUPS, EdgeUNet, init_random_
from image_compression_torch.models.value import ValueNet
from image_compression_torch.ops import prng
from image_compression_torch.train import policy as tp
from image_compression_torch.train.steps import rl_loss, rl_ppo_loss

torch.set_num_threads(1)

RTOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))  # a writable copy of jax arrays


@pytest.mark.parametrize("step", [0, 1, 12345])
def test_normal_matches_jax(step):
    """The policy noise of RL step `step`: normal(fold_in(PRNGKey(0),
    step)), 10^6 draws."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), step)
    ref = np.asarray(jax.random.normal(jkey, (1000, 1000)))
    got = prng.normal(prng.fold_in(prng.prng_key(0), step),
                      (1000, 1000)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-6
    assert np.isfinite(got).all()


def _mu_sigma(b=3, e=50, seed=0):
    rng = np.random.default_rng(seed)
    mu = (2 * np.tanh(rng.normal(size=(b, e)))).astype(np.float32)
    sigma = (0.1 + 0.8 * rng.random((b, e))).astype(np.float32)
    return mu, sigma


@pytest.mark.parametrize("antithetic", [False, True])
def test_sampling(antithetic):
    mu, sigma = _mu_sigma()
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    tkey = prng.fold_in(prng.prng_key(0), 7)
    jfn = (jp.sample_antithetic_policy if antithetic
           else jp.sample_gaussian_policy)
    tfn = (tp.sample_antithetic_policy if antithetic
           else tp.sample_gaussian_policy)
    ref = jfn(jkey, jnp.asarray(mu), jnp.asarray(sigma))
    got = tfn(tkey, _t(mu), _t(sigma))
    assert got.w.shape == ((6 if antithetic else 3), 50)
    w_ref = np.asarray(ref.w)
    assert np.all(np.abs(got.w.numpy() - w_ref) <= 1e-6 * (1 + np.abs(w_ref)))
    np.testing.assert_allclose(got.logp.numpy(), np.asarray(ref.logp),
                               rtol=RTOL)
    np.testing.assert_allclose(got.entropy.numpy(), np.asarray(ref.entropy),
                               rtol=RTOL)
    if antithetic:  # mirrored about mu
        np.testing.assert_allclose((got.w[:3] + got.w[3:]).numpy(),
                                   2 * mu, rtol=1e-6, atol=1e-6)


def test_logp_entropy_and_elementwise():
    mu, sigma = _mu_sigma(seed=1)
    w = mu + np.random.default_rng(2).normal(size=mu.shape).astype(
        np.float32)
    ref = jp.gaussian_logp(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sigma))
    got = tp.gaussian_logp(_t(w), _t(mu), _t(sigma))
    np.testing.assert_allclose(got.logp.numpy(), np.asarray(ref.logp),
                               rtol=RTOL)
    np.testing.assert_allclose(got.entropy.numpy(), np.asarray(ref.entropy),
                               rtol=RTOL)
    np.testing.assert_allclose(
        tp.gaussian_logp_elem(_t(w), _t(mu), _t(sigma)).numpy(),
        np.asarray(jp.gaussian_logp_elem(jnp.asarray(w), jnp.asarray(mu),
                                         jnp.asarray(sigma))), rtol=1e-6,
        atol=1e-6)


REWARDS = np.array([0.3, -0.1, 0.05, 0.2, -0.4, 0.1], np.float32)


def test_advantages_population_std():
    """ddof 0: with torch.std's default correction the values would be
    sqrt((n - 1) / n) of these."""
    ref = np.asarray(jp.antithetic_advantage(jnp.asarray(REWARDS)))
    got = tp.antithetic_advantage(_t(REWARDS)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert np.std(got) == pytest.approx(1.0, rel=1e-5)  # ddof 0
    for b in (0.07, REWARDS[::-1].copy()):  # EMA scalar, value per image
        ref = np.asarray(jp.whitened_advantage(jnp.asarray(REWARDS),
                                               jnp.asarray(b)))
        got = tp.whitened_advantage(_t(REWARDS), _t(np.float32(b))).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)
        assert np.std(got) == pytest.approx(1.0, rel=1e-5)
    # a constant advantage: std clamps at 1e-6 on both sides
    np.testing.assert_array_equal(
        tp.whitened_advantage(_t(np.ones(4, np.float32)),
                              _t(np.float32(1))).numpy(),
        np.asarray(jp.whitened_advantage(jnp.ones(4), jnp.float32(1))))


@pytest.mark.parametrize("initialized", [False, True])
def test_ema_baseline(initialized):
    ref = jp.ema_baseline_update(jnp.float32(0.25), jnp.asarray(initialized),
                                 jnp.asarray(REWARDS), 0.99)
    got = tp.ema_baseline_update(torch.tensor(0.25), torch.tensor(initialized),
                                 _t(REWARDS), 0.99)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    assert bool(got[1]) and bool(ref[1])


@pytest.mark.parametrize("clip", [0.2, 0.05])
def test_reinforce_and_ppo_loss_values(clip):
    mu, sigma = _mu_sigma(b=6, seed=3)
    rng = np.random.default_rng(4)
    w = mu + sigma * rng.normal(size=mu.shape).astype(np.float32)
    old = (mu + 0.1 * rng.normal(size=mu.shape)).astype(np.float32)
    adv = REWARDS
    ref = jp.reinforce_loss(jnp.asarray(adv), jp.gaussian_logp(
        jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sigma)), 50, 1e-3)
    got = tp.reinforce_loss(_t(adv), tp.gaussian_logp(_t(w), _t(mu),
                                                      _t(sigma)), 50, 1e-3)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    lo_ref = jp.gaussian_logp_elem(jnp.asarray(w), jnp.asarray(old),
                                   jnp.asarray(sigma))
    ref = jp.ppo_clip_loss(jnp.asarray(adv), jnp.asarray(w), jnp.asarray(mu),
                           jnp.asarray(sigma), lo_ref, 50, clip, 1e-3)
    got = tp.ppo_clip_loss(_t(adv), _t(w), _t(mu), _t(sigma), _t(lo_ref), 50,
                           clip, 1e-3)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


# --- gradients through the U-Net ------------------------------------------

def _cfgs(sampler):
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.rl.sampler = sampler
        c.rl.entropy_coef = 1e-3
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _net():
    jnet = JUNet(base=8, dtype=jnp.float32)
    params = flax_from_state_dict(init_random_(
        EdgeUNet(base=8, dtype=torch.float32), 5).state_dict())
    images = np.random.default_rng(6).random((2, 32, 32, 3)).astype(
        np.float32)
    return jnet, params, images


@functools.lru_cache(maxsize=None)
def _j_grad(sampler: str, ppo: bool):
    """jax.value_and_grad of the reference's RL loss (reinforce_loss or
    ppo_clip_loss of a fixed sample under _policy_forward), jitted once."""
    jnet, _, _ = _net()
    _, jcfg = _cfgs(sampler)
    anti = sampler == "antithetic"

    def loss(params, images, w, adv, logp_old_elem):
        mu, sigma = _policy_forward(jnet, params, images, jcfg)
        if anti:
            mu = jnp.concatenate([mu, mu], axis=0)
            sigma = jnp.concatenate([sigma, sigma], axis=0)
        if ppo:
            return jp.ppo_clip_loss(adv, w, mu, sigma, logp_old_elem,
                                    mu.shape[-1], jcfg.rl.ppo_clip,
                                    jcfg.rl.entropy_coef)
        return jp.reinforce_loss(adv, jp.gaussian_logp(w, mu, sigma),
                                 mu.shape[-1], jcfg.rl.entropy_coef)

    return jax.jit(jax.value_and_grad(loss))


def _check_grads(model, ref_tree):
    ref = state_dict_from_flax(jax.tree.map(np.asarray, ref_tree))
    scale = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for name, prm in model.named_parameters():
        want, got = ref[name].numpy(), prm.grad.numpy()
        if (name.endswith(("conv0.bias", "conv1.bias"))
                and prm.numel() == GROUPS):
            assert np.abs(got).max() <= 1e-5 * scale, name
            assert np.abs(want).max() <= 1e-5 * scale, name
            continue
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("sampler,baseline,ppo", [
    ("single", "ema", False), ("single", "value", False),
    ("antithetic", "ema", False), ("antithetic", "value", False),
    ("single", "ema", True)])
def test_rl_loss_gradients(sampler, baseline, ppo):
    """The update's loss of a fixed sample: the advantage of each variant
    (antithetic pair differences; whitened against the EMA or against
    per-image value predictions) computed on both sides, then d loss /
    d params. PPO: logp_old from a shifted sampling distribution, so the
    ratio is off 1 and the clip binds on some edges (what the second of
    K = 2 epochs differentiates)."""
    jnet, params, images = _net()
    cfg, jcfg = _cfgs(sampler)
    mu, sigma = _policy_forward(jnet, params, jnp.asarray(images), jcfg)
    anti = sampler == "antithetic"
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    sample = (jp.sample_antithetic_policy if anti
              else jp.sample_gaussian_policy)(key, mu, sigma)
    w = np.asarray(sample.w)
    n = w.shape[0]
    rewards = REWARDS[:n]
    if anti:
        j_adv = jp.antithetic_advantage(jnp.asarray(rewards))
        t_adv = tp.antithetic_advantage(_t(rewards))
    else:
        b = (np.float32(0.05) if baseline == "ema"
             else np.float32([0.2, -0.3]))
        j_adv = jp.whitened_advantage(jnp.asarray(rewards), jnp.asarray(b))
        t_adv = tp.whitened_advantage(_t(rewards), _t(b))
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=RTOL,
                               atol=1e-7)
    mu2 = np.concatenate([np.asarray(mu)] * (2 if anti else 1))
    sigma2 = np.concatenate([np.asarray(sigma)] * (2 if anti else 1))
    lo = np.asarray(jp.gaussian_logp_elem(
        jnp.asarray(w), jnp.asarray(mu2 + 0.3 * sigma2), jnp.asarray(sigma2)))
    if ppo:
        rho = np.exp(np.asarray(jp.gaussian_logp_elem(
            jnp.asarray(w), jnp.asarray(mu2), jnp.asarray(sigma2))) - lo)
        assert ((rho < 0.8) | (rho > 1.2)).mean() > 0.05

    ref_loss, ref_grads = _j_grad(sampler, ppo)(
        params, jnp.asarray(images), jnp.asarray(w), j_adv, jnp.asarray(lo))
    model = EdgeUNet(base=8, dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params))
    x = torch.as_tensor(images)
    loss = (rl_ppo_loss(model, x, _t(w), t_adv, _t(lo), cfg) if ppo
            else rl_loss(model, x, _t(w), t_adv, cfg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=RTOL, atol=1e-6)
    _check_grads(model, ref_grads)


def test_value_net_forward_and_gradient():
    """ValueNet (flax "SAME" padding at stride 2, odd and even sides) and
    the gradient of its squared-error loss against the rewards."""
    jnet = JValueNet(dtype=jnp.float32)
    images = np.random.default_rng(7).random((3, 33, 32, 3)).astype(
        np.float32)
    params = flax_from_state_dict(init_random_(
        ValueNet(dtype=torch.float32), 1).state_dict())
    target = jnp.asarray(REWARDS[:3])

    def jloss(prm):
        v = jnet.apply(prm, jnp.asarray(images))
        return jnp.mean((v - target) ** 2), v

    (ref_loss, ref_v), ref_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    model = ValueNet(dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    v = model(torch.as_tensor(images))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref_v),
                               rtol=1e-5, atol=1e-6)
    loss = torch.mean((v - _t(REWARDS[:3])) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, ref_grads))
    for name, prm in model.named_parameters():
        want = ref[name].numpy()
        assert np.abs(prm.grad.numpy() - want).max() <= \
            1e-4 * np.abs(want).max(), name
