"""Gaussian edge-cost policy, advantages and losses for REINFORCE.

Port of the reference's train/policy.py: a diagonal Gaussian over
flattened edge costs with reparameterized sampling, per-sample log-prob
and closed-form entropy; the scalar EMA baseline; the whitened and the
mirrored-pair (antithetic) advantages; the REINFORCE loss and the per-edge
clipped PPO surrogate.

The noise is `jax.random.normal` of the key (ops/prng.normal), so a run
keyed like the reference's draws the reference's samples. Standard
deviations are population ones (ddof 0, `jnp.std`'s), not torch.std's
default correction 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from image_compression_torch.ops import prng

LOG_2PI = math.log(2.0 * math.pi)


class PolicySample(NamedTuple):
    w: torch.Tensor        # [B, E] sampled edge costs
    logp: torch.Tensor     # [B]
    entropy: torch.Tensor  # [B]


def _std0(x: torch.Tensor) -> torch.Tensor:
    """Population standard deviation (ddof 0), as jnp.std."""
    return torch.std(x, correction=0)


def policy_noise(key: tuple[int, int], mu: torch.Tensor,
                 rows: slice | None = None,
                 global_batch: int | None = None) -> torch.Tensor:
    """eps = normal(key, [B, E]) for mu [B, E]; with `rows`, the draw is the
    global batch's [global_batch, E] and this keeps rows `rows` (the slice
    of one data-parallel rank)."""
    if rows is None:
        return prng.normal(key, mu.shape, mu.device).to(mu.dtype)
    return prng.normal(key, (global_batch, mu.shape[1]),
                       mu.device)[rows].to(mu.dtype)


def sample_gaussian_policy(key: tuple[int, int], mu: torch.Tensor,
                           sigma: torch.Tensor,
                           noise: torch.Tensor | None = None
                           ) -> PolicySample:
    """mu, sigma [B, E] -> reparameterized sample w = mu + sigma * eps,
    eps = normal(key, [B, E]) (or `noise`), with summed log-prob and
    entropy."""
    if noise is None:
        noise = policy_noise(key, mu)
    return gaussian_logp(mu + sigma * noise, mu, sigma)


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
                             sigma: torch.Tensor,
                             noise: torch.Tensor | None = None
                             ) -> PolicySample:
    """Mirrored pairs from one noise draw eps (or `noise`): w+ = mu + sigma
    * eps and w- = mu - sigma * eps stacked on the batch axis -> [2B, E]."""
    if noise is None:
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


def whitened_advantage(rewards: torch.Tensor,
                       baseline: torch.Tensor) -> torch.Tensor:
    """adv = r - b, standardized by its population std clamped at 1e-6."""
    adv = rewards - baseline
    return (adv - adv.mean()) / _std0(adv).clamp(min=1e-6)


def reinforce_loss(adv: torch.Tensor, sample: PolicySample, num_edges: int,
                   entropy_coef: float = 1e-4) -> torch.Tensor:
    """loss = -mean(adv * logp / E) - c * mean(entropy / E)."""
    e = float(num_edges)
    return (-(adv * (sample.logp / e)).mean()
            - entropy_coef * (sample.entropy / e).mean())


def ppo_clip_loss(adv: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
                  sigma: torch.Tensor, logp_old_elem: torch.Tensor,
                  num_edges: int, clip: float = 0.2,
                  entropy_coef: float = 1e-4) -> torch.Tensor:
    """Per-edge clipped PPO surrogate with the image's advantage shared by
    its edges:
      L = -mean_{b,e} min(rho_be adv_b, clip(rho_be, 1 +- eps) adv_b)
          - c * mean_b(entropy_b / E),
    rho = exp(logp_elem - logp_old_elem). At rho == 1 its gradient is
    reinforce_loss's."""
    logp_elem = gaussian_logp_elem(w, mu, sigma)
    rho = torch.exp(logp_elem - logp_old_elem)
    un = rho * adv[:, None]
    cl = rho.clamp(1.0 - clip, 1.0 + clip) * adv[:, None]
    ent_elem = 0.5 * (1.0 + LOG_2PI) + torch.log(sigma)
    return (-torch.minimum(un, cl).mean()
            - entropy_coef * (ent_elem.sum(-1) / float(num_edges)).mean())
