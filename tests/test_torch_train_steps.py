"""Optimizers, state conversion and whole steps of the PyTorch port
(train/steps.py, models/convert.py) vs the JAX reference and optax, f32.

Tolerances: the optimizers on identical gradients within 1e-7 absolute of
optax's parameters after each of 3 steps (AdamW, the global-norm clip +
Adam with the clip binding and not, Adam); a state converted by
train_state_from_jax / rl_state_from_jax then stepped on identical
gradients within 1e-7 of optax's next parameters (the Adam moments take
their parameter's layout map, the ConvTranspose flip included). Whole
steps are held only by their losses (Adam's first steps move a parameter
by about lr x sign(g), so gradients near zero that round apart in the two
frameworks move a parameter by up to 2 lr): the pretrain step's loss
before (1e-5 relative) and after the step (1e-3 relative); one RL step of
a state converted from the reference's against the reference's next step:
loss (1e-5 relative + 1e-6 absolute), mean reward and EMA baseline (1e-5
relative), step counter exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_compression_tpu.config import Config as JConfig
from image_compression_tpu.models.unet import EdgeUNet as JUNet
from image_compression_tpu.train import steps as js
from image_compression_torch.config import Config
from image_compression_torch.models.convert import (flax_from_state_dict,
                                                    rl_state_from_jax,
                                                    state_dict_from_flax,
                                                    train_state_from_jax)
from image_compression_torch.models.unet import EdgeUNet, init_random_
from image_compression_torch.models.value import ValueNet
from image_compression_torch.train import steps as ts

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _params(kind="unet"):
    """Seeded flax params (the port's init mapped to the flax tree)."""
    net = (EdgeUNet(base=8, dtype=torch.float32) if kind == "unet"
           else ValueNet(dtype=torch.float32))
    return flax_from_state_dict(init_random_(net, 2).state_dict())


def _module(kind, params):
    m = (EdgeUNet(base=8, dtype=torch.float32) if kind == "unet"
         else ValueNet(dtype=torch.float32))
    m.load_state_dict(state_dict_from_flax(params))
    return m


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.normal(size=p.shape)).astype(
        np.float32), params)


def _set_grads(module, grads):
    sd = state_dict_from_flax(grads)
    for name, p in module.named_parameters():
        p.grad = sd[name].clone()


def _assert_params(module, params, atol=1e-7):
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    for name, p in module.named_parameters():
        err = np.abs(p.detach().numpy() - sd[name].numpy()).max()
        assert err <= atol, (name, err)


@functools.lru_cache(maxsize=None)
def _optax(which):
    """The reference's optimizer (rl at lr 1e-3, so that moves show past
    f32 rounding) and its jitted update, compiled once per module."""
    jcfg = JConfig()
    jcfg.rl.lr = 1e-3
    tx = {"pretrain": js.make_pretrain_optimizer, "rl": js.make_rl_optimizer,
          "value": js.make_value_optimizer}[which](jcfg)
    return tx, jax.jit(tx.update)


def _optimizers(cfg, which, module):
    make = {"pretrain": ts.make_pretrain_optimizer,
            "rl": ts.make_rl_optimizer,
            "value": ts.make_value_optimizer}[which]
    return _optax(which) + (make(cfg, module.parameters()),)


@pytest.mark.parametrize("which,kind,scale", [
    ("pretrain", "unet", 1e-2), ("rl", "unet", 1e-4), ("rl", "unet", 1.0),
    ("value", "value", 1e-2)], ids=["adamw", "clip_idle", "clip_binds",
                                    "value_adam"])
def test_optimizer_matches_optax(which, kind, scale):
    """3 steps on identical gradients. RL at scale 1e-4 has a global norm
    under grad_clip (the clip passes), at 1.0 far above it (it binds)."""
    cfg = Config()
    cfg.rl.lr = 1e-3  # as _optax's
    params = _params(kind)
    module = _module(kind, params)
    tx, update, opt = _optimizers(cfg, which, module)
    state = tx.init(params)
    for k in range(3):
        g = _grads(params, k, scale)
        if which == "rl":
            norm = float(optax.global_norm(g))
            assert (norm > cfg.rl.grad_clip) == (scale == 1.0)
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
        _set_grads(module, g)
        opt.step()
        _assert_params(module, params)


@pytest.mark.parametrize("kind", ["unet", "value"])
def test_flax_round_trip(kind):
    """flax_from_state_dict inverts state_dict_from_flax, and the mapped
    tree has the structure and shapes of the reference's own init."""
    from image_compression_tpu.models.value import ValueNet as JValueNet
    params = _params(kind)
    net = (JUNet(base=8, dtype=jnp.float32) if kind == "unet"
           else JValueNet(dtype=jnp.float32))
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    assert jax.tree.structure(shapes) == jax.tree.structure(params)
    assert jax.tree.leaves(jax.tree.map(lambda a: a.shape, shapes)) == \
        jax.tree.leaves(jax.tree.map(lambda a: a.shape, params))
    sd = state_dict_from_flax(params)
    back = flax_from_state_dict(sd)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(back)))


def test_clip_by_global_norm_rule():
    """optax's rule t * max_norm / ||g|| (not torch's max_norm /
    (||g|| + 1e-6)), and identity under the norm."""
    g = [torch.full((3,), 2.0), torch.full((2, 2), -1.0)]
    norm = ts.clip_by_global_norm_(g, 1.0)
    assert float(norm) == pytest.approx(4.0)
    ref = optax.clip_by_global_norm(1.0).update(
        [jnp.full((3,), 2.0), jnp.full((2, 2), -1.0)], None)[0]
    for a, b in zip(g, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    small = [torch.full((3,), 0.1)]
    ts.clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.full((3,), 0.1))


def _advance(which, params, n):
    """n optax steps on seeded gradients -> (params, opt_state)."""
    tx, update = _optax(which)
    state = tx.init(params)
    for k in range(n):
        upd, state = update(_grads(params, 10 + k, 1e-2), state, params)
        params = optax.apply_updates(params, upd)
    return params, state


def test_train_state_from_jax_continues_optax():
    """A reference TrainState two AdamW steps in (non-zero moments, count
    2) converts, then one more step on identical gradients lands on
    optax's parameters."""
    cfg = Config()
    _, update = _optax("pretrain")
    params, opt_state = _advance("pretrain", _params(), 2)
    jstate = js.TrainState(params, opt_state, jnp.asarray(2))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                 dtype=torch.float32, device="cpu")
    assert state.step == 2 and state.model.dtype == torch.float32
    _assert_params(state.model, params, atol=0)
    g = _grads(params, 99, 1e-2)
    upd, _ = update(g, opt_state, params)
    _set_grads(state.model, g)
    state.optimizer.step()
    _assert_params(state.model, optax.apply_updates(params, upd))


@pytest.mark.parametrize("baseline", ["ema", "value"])
def test_rl_state_from_jax_continues_optax(baseline):
    """The same for a reference RLState: the U-Net's clipped Adam, the EMA
    baseline and its flag, and (baseline "value") the value net's Adam."""
    cfg = Config()
    cfg.rl.baseline = baseline
    cfg.rl.lr = 1e-3  # as _optax's
    params, opt_state = _advance("rl", _params(), 2)
    vparams, vstate = (), ()
    if baseline == "value":
        vparams, vstate = _advance("value", _params("value"), 3)
    jstate = js.RLState(params, opt_state, jnp.asarray(5),
                        jnp.asarray(0.125), jnp.asarray(True), vparams,
                        vstate)
    state = rl_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                              dtype=torch.float32, device="cpu")
    assert state.step == 5 and bool(state.baseline_init)
    assert float(state.baseline) == 0.125
    g = _grads(params, 98, 1e-2)
    upd, _ = _optax("rl")[1](g, opt_state, params)
    _set_grads(state.model, g)
    state.optimizer.step()
    _assert_params(state.model, optax.apply_updates(params, upd))
    if baseline == "value":
        vg = _grads(vparams, 97, 1e-2)
        vupd, _ = _optax("value")[1](vg, vstate, vparams)
        _set_grads(state.value_model, vg)
        state.value_optimizer.step()
        _assert_params(state.value_model, optax.apply_updates(vparams, vupd))


def _pretrain_batch():
    from image_compression_torch.config import EdgeTarget
    from image_compression_torch.ops.targets import create_target_with_mask
    images = np.random.default_rng(8).random((2, 32, 32, 3)).astype(
        np.float32)
    targets = create_target_with_mask(torch.as_tensor(images),
                                      EdgeTarget.CANNY)
    return images, targets.numpy()


def test_pretrain_step_loss_before_and_after():
    cfg, jcfg = Config(), JConfig()
    images, targets = _pretrain_batch()
    jnet = JUNet(base=8, dtype=jnp.float32)
    params = _params()
    tx = js.make_pretrain_optimizer(jcfg)
    jstep = js.make_pretrain_step(jnet, tx, jcfg)
    jeval = js.make_pretrain_eval(jnet, jcfg)
    jstate, aux, jm = jstep(js.TrainState(params, tx.init(params),
                                          jnp.asarray(0)),
                            jnp.asarray(images), jnp.asarray(targets))
    after_ref = float(jeval(jstate.params, jnp.asarray(images),
                            jnp.asarray(targets))[0]["loss"])

    model = _module("unet", params)
    state = ts.TrainState(model, ts.make_pretrain_optimizer(
        cfg, model.parameters()))
    x, t = torch.as_tensor(images), torch.as_tensor(targets)
    _, taux, tm = ts.make_pretrain_step(cfg)(state, x, t)
    stats, _ = ts.make_pretrain_eval(cfg)(state.model, x, t)
    assert state.step == 1
    np.testing.assert_allclose(float(taux["loss"]), float(aux["loss"]),
                               rtol=1e-5)
    assert tuple(int(v) for v in tm) == tuple(int(v) for v in jm)
    assert int(taux["sign_correct"]) == int(aux["sign_correct"])
    np.testing.assert_allclose(float(stats["loss"]), after_ref, rtol=1e-3)
    assert float(stats["loss"]) < float(taux["loss"])


def test_rl_state_from_jax_then_one_step():
    """A reference RLState one step in (Adam moments, EMA baseline set),
    converted; the port's next RL step against the reference's next step
    on the same batch: the policy noise is the same draw
    (normal(fold_in(PRNGKey(0), step))), the solver the same settings."""
    cfg, jcfg = Config(), JConfig()
    jcfg.multicut.hier_agg = cfg.multicut.hier_agg
    for c in (cfg, jcfg):
        # the reference estimator profile (the lighter program to compile;
        # the shipped profile's solve + reward: test_torch_rewards.py)
        c.reward.overhead_base = 9.308622
        c.reward.entropy_correction, c.reward.literal_hist = "none", "all"
        c.reward.distance_window = 0
        c.reward.max_segments = 16
        c.rl.entropy_coef = 1e-3
    rng = np.random.default_rng(12)
    images = rng.random((2, 32, 32, 3)).astype(np.float32)
    images[:, :, 16:] = images[:, :1, 16:]  # a smooth half per image
    sizes = np.array([2600.0, 2900.0], np.float32)
    jnet = JUNet(base=8, dtype=jnp.float32)
    tx = js.make_rl_optimizer(jcfg)
    jstep = js.make_rl_step(jnet, tx, jcfg)
    key = jax.random.PRNGKey(0)
    jstate = js.init_rl_state(_params(), tx)
    jstate, aux0 = jstep(jstate, key, jnp.asarray(images), jnp.asarray(sizes))
    state = rl_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                              dtype=torch.float32, device="cpu")
    assert state.step == 1 and bool(state.baseline_init)
    jstate, aux = jstep(jstate, key, jnp.asarray(images), jnp.asarray(sizes))

    from image_compression_torch.ops import prng
    _, taux = ts.make_rl_step(cfg)(state, prng.prng_key(0),
                                   torch.as_tensor(images),
                                   torch.as_tensor(sizes))
    assert state.step == int(jstate.step) == 2
    np.testing.assert_allclose(float(taux["reward_mean"]),
                               float(aux["reward_mean"]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["baseline"]),
                               float(aux["baseline"]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["loss"]), float(aux["loss"]),
                               rtol=1e-5, atol=1e-6)
    assert float(aux["reward_mean"]) != float(aux0["reward_mean"])
