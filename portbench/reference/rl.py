"""The RL cell's plain reference and the comparison that decides `correct`.

The reference follows the program's first three REINFORCE steps from the
raw weights file and the benchmark's own images, in float32 (TF32 off):
the policy forward (reference/unet.py, squashes), the sample keyed by
fold_in(prng_key(seed), step) (antithetic pairs), the multicut
at the configuration's settings, the estimator reward, the EMA baseline,
the advantage, the REINFORCE loss with its entropy term, the gradient by
autograd and optax's clip_by_global_norm + Adam, all in the frozen plain
copies beside this file. The batches are worked out again from the
program's feed rule (epoch 0 shuffled by numpy's default_rng(0), batches
in order).

It follows the program step by step from the program's own sample: the
solve of a sampled cost near zero flips with the last bits of mu, and the
normalized antithetic advantage turns one flipped solve into a different
gradient, so a reference that drew from its own float32 mu would compare
two estimators and not two computations. So it computes its own sample,
compares the program's with it (`sample_gap`, the start), and then solves,
rewards and updates on the program's sample, from its own rewards and its
own parameters.

Numbers compared, each against its limit in limits/<cell>.json:
  sample_gap  the widest |program's sample - reference's own| of the steps
              (forward, squashes and noise)
  reward_gap  the widest |program's reward - the reference's reward of the
              program's sample| over the steps' samples (solve and reward)
  grad_gap    by the median leaf: | |g_p| - |g_r| | over max(|g_r|, the
              median leaf's |g_r|), g the first step's clipped gradient as
              Adam holds it (exp_avg / (1 - b1) after one step). Not by
              the worst leaf: which leaf is worst changes from seed to
              seed (GroupNorm scales, convolution weights) and sound
              bfloat16 runs read 0.03-0.33 there, no less than the float8
              control (0.22-0.68)
  change_gap  the same for the parameters' change after the steps, also
              by the median leaf: under Adam an element moves by about lr
              whatever its gradient, so a small leaf whose elements'
              gradients flip sign in the last bits (outc.weight, 256
              elements) changes its norm by up to 19% in sound runs;
              leaves whose reference gradient is under 1e-3 x the median
              leaf's are left out (they move by round-off alone)
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.reference import policy, prng, unet
from portbench.reference.compress import load_weights, to_float01
from portbench.reference.edges import (flatten_edge_planes, squash_mu,
                                       squash_sigma, unflatten_edge_planes)
from portbench.reference.multicut import multicut_grid
from portbench.reference.rewards import compute_rewards_batched

STEPS = 3
NUMBERS = ("sample_gap", "reward_gap", "grad_gap", "change_gap")
B1, B2, EPS = 0.9, 0.999, 1e-8


def feed(corpus: dict, batch_size: int, steps: int):
    """The first `steps` batches of epoch 0: (images uint8, sizes)."""
    stems = list(corpus)
    order = np.arange(len(stems))
    np.random.default_rng(0).shuffle(order)
    for i in range(steps):
        idx = order[i * batch_size:(i + 1) * batch_size]
        yield (np.stack([corpus[stems[j]]["image"] for j in idx]),
               np.asarray([corpus[stems[j]]["png_bytes"] for j in idx],
                          np.float32))


def policy_forward(params, x, rl: dict, cast):
    out = unet.forward(params, x, cast)
    mu = torch.stack([out[..., 0], out[..., 2]], -1)
    sigma = torch.stack([out[..., 1], out[..., 3]], -1)
    return (flatten_edge_planes(squash_mu(mu, rl["mu_scale"])),
            flatten_edge_planes(squash_sigma(sigma, rl["sigma_min"],
                                             rl["sigma_max"])))


class Adam:
    """optax.chain(clip_by_global_norm(c), adam(lr)) in float32."""

    def __init__(self, params: dict, lr: float, max_norm: float):
        self.lr, self.max_norm, self.t = lr, max_norm, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < self.max_norm
        self.t += 1
        t = torch.tensor(float(self.t), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** t)
        for k, p in params.items():
            g = torch.where(keep, grads[k], (grads[k] / g_norm)
                            * self.max_norm)
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * (g * g) + B2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)
            p.copy_(p + (-self.lr) * u)


def reference_steps(spec: dict, corpus: dict, seed: int, device: str,
                    cast=unet.identity, steps: int = STEPS,
                    follow: list | None = None) -> dict:
    """The reference's first steps: samples, rewards, the first gradient
    and the parameters after the last step. With `follow` (the
    followed run's sample of each step), it solves, rewards and updates on
    those samples and reports the widest gap to its own as sample_gap."""
    s = spec["config"]["settings"]
    rl, rw, mc = s["rl"], s["reward"], s["multicut"]
    if (rl["baseline"], rl["sampler"], rl["whiten"], rl["ppo_epochs"]) != (
            "ema", "antithetic", False, 0):
        raise ValueError("the reference follows the antithetic sampler, the "
                         "EMA baseline and the plain REINFORCE update")
    params = {k: v.clone().requires_grad_()
              for k, v in load_weights(spec["config"], device).items()}
    opt = Adam(params, rl["lr"], rl["grad_clip"])
    key = prng.prng_key(seed)
    baseline = torch.zeros((), device=device)
    binit = torch.zeros((), dtype=torch.bool, device=device)
    out = {"reward": [], "w": [], "sample_gap": 0.0}
    for step, (imgs, sizes) in enumerate(
            feed(corpus, spec["config"]["batch_size"], steps)):
        x = to_float01(imgs, device)
        sz = torch.as_tensor(sizes, device=device)
        h, w = x.shape[1:3]
        with unet.no_tf32():
            with torch.no_grad():
                mu, sigma = policy_forward(params, x, rl, cast)
            k = prng.fold_in(key, step)
            smp = policy.sample_antithetic_policy(k, mu, sigma).w
            x2, sz2 = torch.cat([x, x]), torch.cat([sz, sz])
            if follow is not None:
                out["sample_gap"] = max(out["sample_gap"], float(
                    (follow[step] - smp).abs().max()))
                smp = follow[step]
            with torch.no_grad():
                labels = multicut_grid(
                    unflatten_edge_planes(smp, h, w), mode=mc["mode"],
                    max_rounds=mc["max_rounds"],
                    icm_sweeps=mc["icm_sweeps"],
                    hier_rounds=tuple(mc["hier_rounds"]),
                    hier_caps=mc["hier_caps"], hier_agg=mc["hier_agg"])
                rewards = compute_rewards_batched(
                    x2, labels, sz2, k_max=rw["max_segments"],
                    min_pixels=rw["min_pixels_per_segment"],
                    l_min=rw["l_min"], beta=rw["beta"],
                    b_match_token=rw["b_match_token"], gamma=rw["gamma"],
                    overhead_base=rw["overhead_base"],
                    adaptive_filter=rw["adaptive_filter"],
                    lam=rw["lambda_single_segment"],
                    entropy_correction=rw["entropy_correction"],
                    literal_hist=rw["literal_hist"],
                    distance_window=rw["distance_window"],
                    fallback_aware=rw["fallback_aware"],
                    fallback_reward_clip=rw["fallback_reward_clip"])
            baseline, binit = policy.ema_baseline_update(
                baseline, binit, rewards, rl["baseline_momentum"])
            adv = policy.antithetic_advantage(rewards)
            mu_g, sigma_g = policy_forward(params, x, rl, cast)
            mu_g, sigma_g = torch.cat([mu_g, mu_g]), torch.cat(
                [sigma_g, sigma_g])
            loss = policy.reinforce_loss(
                adv, policy.gaussian_logp(smp, mu_g, sigma_g),
                mu_g.shape[-1], rl["entropy_coef"])
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            opt.step(params, grads)
        out["reward"].append(rewards)
        out["w"].append(smp)
        if step == 0:
            out["grad1"] = {k: v / (1 - B1) for k, v in opt.mu.items()}
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            d.items()}


def gaps(got: dict, want: dict, p0: dict) -> dict:
    """The numbers, from the program's (or the control's) readings `got`
    and those of the reference that followed it, `want`: each with reward
    (per sample), grad1 and params (after the steps); p0 the starting
    parameters."""
    reward_gap = max(float((a - b).abs().max())
                     for a, b in zip(got["reward"], want["reward"]))
    gp, gr = _norms(got["grad1"]), _norms(want["grad1"])
    g_med = float(np.median(list(gr.values())))
    grad = {k: abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr}
    cp = _norms({k: got["params"][k] - p0[k] for k in p0})
    cr = _norms({k: want["params"][k] - p0[k] for k in p0})
    moved = [k for k in cr if gr[k] >= 1e-3 * g_med]
    c_med = float(np.median([cr[k] for k in moved]))
    change = {k: abs(cp[k] - cr[k]) / max(cr[k], c_med) for k in moved}
    return {"sample_gap": want["sample_gap"], "reward_gap": reward_gap,
            "grad_gap": float(np.median(list(grad.values()))),
            "change_gap": float(np.median(list(change.values()))),
            "grad_gap_worst_leaf": max(grad.values()),
            "change_gap_worst_leaf": max(change.values()),
            "left_out": sorted(set(cr) - set(moved))}


def check(spec: dict, corpus: dict, seed: int, got: dict,
          device: str) -> dict:
    want = reference_steps(spec, corpus, seed, device, follow=got["w"])
    g = gaps(got, want, load_weights(spec["config"], device))
    limits = spec["limits"]
    return {k: harness.check(g[k], limits[k]) for k in NUMBERS}


def control(spec: dict, corpus: dict, seed: int, device: str) -> dict:
    """The control: the reference's steps with float8 convolutions (e5m2
    gradients) put in the program's place, followed by the float32
    reference as the program is."""
    low = reference_steps(spec, corpus, seed, device, unet.fp8)
    want = reference_steps(spec, corpus, seed, device, follow=low["w"])
    return gaps(low, want, load_weights(spec["config"], device))
