"""Frozen copy of the port's `train/policy.py` (plain PyTorch), part of the
benchmark's reference; it imports nothing of the program.

Gaussian edge-cost policy, advantages and losses for REINFORCE.

Port of the reference's train/policy.py, the parts the benchmark's
configuration runs: a diagonal Gaussian over flattened edge costs with
antithetic (mirrored-pair) sampling, per-sample log-prob and closed-form
entropy; the scalar EMA baseline; the antithetic advantage; the REINFORCE
loss.

The noise is `jax.random.normal` of the key (ops/prng.normal), so a run
keyed like the reference's draws the reference's samples. Standard
deviations are population ones (ddof 0, `jnp.std`'s), not torch.std's
default correction 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference import prng

LOG_2PI = math.log(2.0 * math.pi)


class PolicySample(NamedTuple):
    w: torch.Tensor        # [B, E] sampled edge costs
    logp: torch.Tensor     # [B]
    entropy: torch.Tensor  # [B]


def _std0(x: torch.Tensor) -> torch.Tensor:
    """Population standard deviation (ddof 0), as jnp.std."""
    return torch.std(x, correction=0)


def policy_noise(key: tuple[int, int], mu: torch.Tensor) -> torch.Tensor:
    """eps = normal(key, [B, E]) for mu [B, E]."""
    return prng.normal(key, mu.shape, mu.device).to(mu.dtype)


def gaussian_logp_elem(w: torch.Tensor, mu: torch.Tensor,
                       sigma: torch.Tensor) -> torch.Tensor:
    """Per-edge log-density [B, E]."""
    z = (w - mu) / sigma
    return -0.5 * z * z - torch.log(sigma) - 0.5 * LOG_2PI


def gaussian_logp(w: torch.Tensor, mu: torch.Tensor,
                  sigma: torch.Tensor) -> PolicySample:
    """Summed log-prob and entropy of fixed costs w under N(mu, sigma)."""
    ent_elem = 0.5 * (1.0 + LOG_2PI) + torch.log(sigma)
    return PolicySample(w, gaussian_logp_elem(w, mu, sigma).sum(-1),
                        ent_elem.sum(-1))


def sample_antithetic_policy(key: tuple[int, int], mu: torch.Tensor,
                             sigma: torch.Tensor) -> PolicySample:
    """Mirrored pairs from one noise draw eps: w+ = mu + sigma * eps and
    w- = mu - sigma * eps stacked on the batch axis -> [2B, E]."""
    noise = policy_noise(key, mu)
    w = torch.cat([mu + sigma * noise, mu - sigma * noise], dim=0)
    return gaussian_logp(w, torch.cat([mu, mu], dim=0),
                         torch.cat([sigma, sigma], dim=0))


def antithetic_advantage(rewards: torch.Tensor) -> torch.Tensor:
    """[2B] rewards of mirrored pairs -> adv(w+) = (r+ - r-) / 2,
    adv(w-) = -(r+ - r-) / 2, divided by their population std (clamped at
    1e-6; zero-mean by construction)."""
    b = rewards.shape[0] // 2
    d = 0.5 * (rewards[:b] - rewards[b:])
    adv = torch.cat([d, -d])
    return adv / _std0(adv).clamp(min=1e-6)


def ema_baseline_update(value: torch.Tensor, initialized: torch.Tensor,
                        rewards: torch.Tensor, momentum: float = 0.99):
    """Scalar EMA of the mean reward; the first call adopts the batch mean.
    Returns (new_value, new_initialized)."""
    mean_r = rewards.mean()
    new_value = torch.where(initialized,
                            value * momentum + mean_r * (1.0 - momentum),
                            mean_r)
    return new_value, torch.ones_like(initialized)


def reinforce_loss(adv: torch.Tensor, sample: PolicySample, num_edges: int,
                   entropy_coef: float = 1e-4) -> torch.Tensor:
    """loss = -mean(adv * logp / E) - c * mean(entropy / E)."""
    e = float(num_edges)
    return (-(adv * (sample.logp / e)).mean()
            - entropy_coef * (sample.entropy / e).mean())
