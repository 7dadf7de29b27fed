"""Pretraining loss: masked weighted BCE on edge logits + sigma calibration.

Port of the reference's train/losses.py:
  * masked BCE-with-logits on the mu logits, with connect-class (y=1)
    weight pos_weight, normalized by the weighted mask sum;
  * sigma head mapped to [sigma_min, sigma_max] by a sigmoid; a Gaussian
    NLL calibrates it against the squared error of p = sigmoid(logit),
    with p detached (no gradient reaches the mu logits through it);
  * total = w_sign * bce + w_sigma * nll.

Layout: outputs [B, H, W, 4] = (logit_r, sigma_r_raw, logit_d,
sigma_d_raw); targets [B, H, W, 4] = (y_r, y_d, mask_r, mask_d).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PretrainLossOut(NamedTuple):
    loss: torch.Tensor          # scalar
    loss_sign: torch.Tensor     # scalar (BCE part)
    loss_sigma: torch.Tensor    # scalar (NLL part)
    valid_weight: torch.Tensor  # scalar: max(mask_r.sum(), 1) + max(mask_d.sum(), 1)
    correct: torch.Tensor       # sign-accuracy numerator
    valid: torch.Tensor         # sign-accuracy denominator


def _bce_with_logits(logits, labels):
    """max(x, 0) - x*y + log(1 + e^-|x|), the stable form, with jax's
    gradient at x = 0: the max splits the tie and |x|' = 1 there (so the
    derivative is -y, where torch's clamp and abs would give 1 - y)."""
    abs_x = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * labels + torch.log1p(torch.exp(-abs_x)))


def pretrain_loss(outputs: torch.Tensor, targets: torch.Tensor,
                  pos_weight: float = 0.1, w_sign: float = 1.0,
                  w_sigma: float = 0.01, sigma_min: float = 0.1,
                  sigma_max: float = 0.9, reduce=None) -> PretrainLossOut:
    """The loss of one batch. With `reduce` (a function summing a tensor
    over the data-parallel ranks) the normalizers are the global batch's,
    so each rank's loss is its share of the global loss: the shares sum to
    it, and so do their gradients."""
    logit_r, sigma_r_z, logit_d, sigma_d_z = outputs.unbind(-1)
    y_r, y_d, mask_r, mask_d = targets.unbind(-1)

    bce_r = _bce_with_logits(logit_r, y_r)
    bce_d = _bce_with_logits(logit_d, y_d)
    # y == 1 (connect) weight pos_weight, y == 0 (cut) weight 1
    w_r = (1.0 - y_r) + y_r * pos_weight
    w_d = (1.0 - y_d) + y_d * pos_weight
    num = (bce_r * w_r * mask_r).sum() + (bce_d * w_d * mask_d).sum()
    den = (w_r * mask_r).sum() + (w_d * mask_d).sum()
    sum_r, sum_d = mask_r.sum(), mask_d.sum()
    if reduce is not None:  # targets only: no gradient flows through them
        den, sum_r, sum_d = reduce(torch.stack([den, sum_r, sum_d])).unbind()
    loss_sign = num / den.clamp(min=1.0)

    p_r = (1.0 / (1.0 + torch.exp(-logit_r))).clamp(1e-7, 1 - 1e-7)
    p_d = (1.0 / (1.0 + torch.exp(-logit_d))).clamp(1e-7, 1 - 1e-7)

    span = sigma_max - sigma_min
    sigma_r = (sigma_min + span / (1.0 + torch.exp(-sigma_r_z))).clamp(
        min=1e-4)
    sigma_d = (sigma_min + span / (1.0 + torch.exp(-sigma_d_z))).clamp(
        min=1e-4)

    err2_r = (p_r.detach() - y_r) ** 2
    err2_d = (p_d.detach() - y_d) ** 2
    nll_r = 0.5 * (err2_r / sigma_r ** 2 + torch.log(sigma_r ** 2))
    nll_d = 0.5 * (err2_d / sigma_d ** 2 + torch.log(sigma_d ** 2))

    valid_w = sum_r.clamp(min=1.0) + sum_d.clamp(min=1.0)
    loss_sigma = ((nll_r * mask_r).sum() + (nll_d * mask_d).sum()) / valid_w

    loss = w_sign * loss_sign + w_sigma * loss_sigma

    pred_r = p_r >= 0.5
    pred_d = p_d >= 0.5
    correct = (((pred_r == (y_r >= 0.5)) * mask_r).sum()
               + ((pred_d == (y_d >= 0.5)) * mask_d).sum())
    valid = mask_r.sum() + mask_d.sum()
    return PretrainLossOut(loss, loss_sign, loss_sigma, valid_w, correct,
                           valid)
