"""Train steps: supervised pretraining and online REINFORCE.

Port of the reference's train/steps.py. The pretrain step is forward, loss,
backward and an AdamW step. The RL step keeps the reference's three stages:
  1. forward under no_grad -> mu_old, sigma_old (flattened edge lists);
  2. sample, solve and reward under no_grad: the policy noise is
     `normal(fold_in(key, step))` as in the reference, the batched solver
     runs at cfg.multicut (with the port's hier_agg "matrix" its levels 0-1
     run in the multicut leaf kernel), the reward is
     ops/rewards.compute_rewards_batched;
  3. update: the forward again with grad, the REINFORCE (or K clipped PPO)
     loss of the fixed sample, and the optimizer step.

The model, its optimizer and the counters live in a TrainState / RLState
and are updated in place. The optimizers are optax's, operation for
operation (OptaxAdam): AdamW(lr, wd) over every parameter (norms and
biases included) for pretraining; clip_by_global_norm followed by Adam for
RL; Adam for the value net.

Data parallelism (parallel/mesh.py): inside a torch.distributed process
group each rank runs these steps on its slice of the global batch. The
pretrain loss takes the global batch's normalizers, so the ranks' losses
are shares of the global loss and their gradients are summed; the RL step
draws the global batch's noise and keeps its rows, gathers the rewards
(and value predictions) in the global batch's order to compute the
baseline, the advantages and the reward mean exactly as one process would,
and averages the gradients. Every reduction happens before the optimizer's
clip. Without a process group none of this runs and the steps are those of
one process.
"""

from __future__ import annotations

import dataclasses

import torch

from image_compression_torch.config import Config
from image_compression_torch.models.unet import EdgeUNet, init_random_
from image_compression_torch.ops import prng
from image_compression_torch.ops.edges import (flatten_edge_planes,
                                               split_model_output, squash_mu,
                                               squash_sigma,
                                               unflatten_edge_planes)
from image_compression_torch.ops.multicut import (multicut_grid,
                                                  produces_minlabel)
from image_compression_torch.ops.rewards import compute_rewards_batched
from image_compression_torch.parallel import mesh as pmesh
from image_compression_torch.train.losses import pretrain_loss
from image_compression_torch.train.metrics import EdgeMetrics, edge_metrics
from image_compression_torch.train.policy import (antithetic_advantage,
                                                  ema_baseline_update,
                                                  gaussian_logp,
                                                  gaussian_logp_elem,
                                                  policy_noise,
                                                  ppo_clip_loss,
                                                  reinforce_loss,
                                                  sample_antithetic_policy,
                                                  sample_gaussian_policy,
                                                  whitened_advantage)
from image_compression_torch.utils.profiling import StageClock, span

ADAM_BETAS = (0.9, 0.999)  # optax's defaults
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    model: EdgeUNet
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.model.load_state_dict(d["params"])
        self.optimizer.load_state_dict(d["opt_state"])
        self.step = int(d["step"])


@dataclasses.dataclass
class RLState:
    model: EdgeUNet
    optimizer: torch.optim.Optimizer
    step: int = 0
    baseline: torch.Tensor | None = None       # EMA of the mean reward
    baseline_init: torch.Tensor | None = None  # bool
    # the learned value baseline (cfg.rl.baseline == "value"), else None
    value_model: torch.nn.Module | None = None
    value_optimizer: torch.optim.Optimizer | None = None

    def state_dict(self) -> dict:
        d = {"params": self.model.state_dict(),
             "opt_state": self.optimizer.state_dict(), "step": self.step,
             "baseline": self.baseline.detach().cpu(),
             "baseline_init": self.baseline_init.detach().cpu()}
        if self.value_model is not None:
            d["value_params"] = self.value_model.state_dict()
            d["value_opt_state"] = self.value_optimizer.state_dict()
        return d

    def load_state_dict(self, d: dict) -> None:
        if ("value_params" in d) != (self.value_model is not None):
            raise ValueError("the checkpoint's value baseline does not match "
                             "this run's cfg.rl.baseline")
        self.model.load_state_dict(d["params"])
        self.optimizer.load_state_dict(d["opt_state"])
        self.step = int(d["step"])
        dev = self.baseline.device
        self.baseline = d["baseline"].to(dev, torch.float32)
        self.baseline_init = d["baseline_init"].to(dev, torch.bool)
        if self.value_model is not None:
            self.value_model.load_state_dict(d["value_params"])
            self.value_optimizer.load_state_dict(d["value_opt_state"])


@torch.no_grad()
def clip_by_global_norm_(tensors, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where the global norm g is at
    least max_norm, t <- (t / g) * max_norm. (torch's clip_grad_norm_
    scales by max_norm / (g + 1e-6) instead.) Returns g."""
    tensors = list(tensors)
    g_norm = torch.sqrt(sum(torch.sum(t * t) for t in tensors))
    keep = g_norm < max_norm
    for t in tensors:
        t.copy_(torch.where(keep, t, (t / g_norm) * max_norm))
    return g_norm


class OptaxAdam(torch.optim.Optimizer):
    """optax's Adam family as a torch optimizer, operation for operation:
    [clip_by_global_norm(max_norm)] -> scale_by_adam(b1, b2, eps) ->
    [add_decayed_weights(weight_decay)] -> scale(-lr), then p + u. In f32:
      mu <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu;   t <- t + 1
      u  <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
      p  <- p + (-lr) u
    torch's AdamW decays p by the factor (1 - lr wd) first and folds the
    bias corrections into the step size, which rounds differently (one ulp
    of a parameter near 1 each step). The state keys are torch Adam's
    (step, exp_avg, exp_avg_sq), so models/convert.py fills them from an
    optax state."""

    def __init__(self, params, lr: float, betas=ADAM_BETAS,
                 eps: float = ADAM_EPS, weight_decay: float = 0.0,
                 max_norm: float | None = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.max_norm = max_norm

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.max_norm is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            if grads:
                clip_by_global_norm_(grads, self.max_norm)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                g = p.grad
                mu = st["exp_avg"]
                nu = st["exp_avg_sq"]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                st["step"] += 1
                # the bias corrections in f32 on the host (exact as Python
                # floats, so the device divides by the f32 values)
                t = st["step"].to(torch.float32)
                bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
                bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.copy_(p + (-group["lr"]) * u)
        return loss


def make_pretrain_optimizer(cfg: Config, params) -> OptaxAdam:
    """optax.adamw(lr, weight_decay=wd): decoupled decay of every
    parameter."""
    return OptaxAdam(params, cfg.pretrain.lr,
                     weight_decay=cfg.pretrain.weight_decay)


def make_value_optimizer(cfg: Config, params) -> OptaxAdam:
    """optax.adam(value_lr) for the learned value baseline."""
    return OptaxAdam(params, cfg.rl.value_lr)


def make_rl_optimizer(cfg: Config, params) -> OptaxAdam:
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr))."""
    return OptaxAdam(params, cfg.rl.lr, max_norm=cfg.rl.grad_clip)


def _data_parallel(flag: bool) -> bool:
    """`flag`, checked: a step reduces over the ranks only inside a process
    group."""
    if flag and not pmesh.distributed():
        raise ValueError("data_parallel=True needs a process group "
                         "(parallel/mesh.initialize_distributed)")
    return flag


def _rank_sum(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().clone()
    pmesh.all_reduce_sum_([x])
    return x


def _grads(module: torch.nn.Module) -> list:
    return [p.grad for p in module.parameters() if p.grad is not None]


def _pretrain_loss(out, targets, cfg: Config, reduce=None):
    p = cfg.pretrain
    return pretrain_loss(out, targets, pos_weight=p.pos_weight,
                         w_sign=p.w_sign, w_sigma=p.w_sigma,
                         sigma_min=p.sigma_min, sigma_max=p.sigma_max,
                         reduce=reduce)


def _global_stats(stats: dict, metrics: EdgeMetrics, keys):
    """Sum `keys` of stats (loss shares and counts) and every metric count
    over the ranks."""
    stats = {k: (_rank_sum(v) if k in keys else v) for k, v in stats.items()}
    return stats, EdgeMetrics(*[_rank_sum(c) for c in metrics])


def make_pretrain_step(cfg: Config, data_parallel: bool = False):
    """step(state, images [B, H, W, 3], targets [B, H, W, 4]) ->
    (state, aux, EdgeMetrics); aux holds device scalars. With
    data_parallel (inside a process group) the batch is this rank's slice,
    the gradients are summed over the ranks before the optimizer, and aux
    and the metrics are the global batch's."""
    dp = _data_parallel(data_parallel)

    def step(state: TrainState, images: torch.Tensor,
             targets: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        out = state.model(images)
        lo = _pretrain_loss(out, targets, cfg, _rank_sum if dp else None)
        lo.loss.backward()
        if dp:
            pmesh.all_reduce_sum_(_grads(state.model))
        state.optimizer.step()
        state.step += 1
        aux = {"loss": lo.loss.detach(), "loss_sign": lo.loss_sign.detach(),
               "loss_sigma": lo.loss_sigma.detach(),
               "sign_correct": lo.correct, "sign_valid": lo.valid}
        metrics = edge_metrics(out.detach(), targets)
        if dp:
            return (state, *_global_stats(aux, metrics, aux.keys()))
        return state, aux, metrics

    return step


def make_pretrain_eval(cfg: Config):
    """evaluate(model, images, targets, sharded=False) -> (stats,
    EdgeMetrics). sharded: the batch is this rank's slice of a global batch
    and the results are the global batch's."""

    @torch.no_grad()
    def evaluate(model: EdgeUNet, images: torch.Tensor,
                 targets: torch.Tensor, sharded: bool = False):
        out = model(images)
        lo = _pretrain_loss(out, targets, cfg,
                            _rank_sum if sharded else None)
        stats = {"loss": lo.loss, "valid_weight": lo.valid_weight,
                 "sign_correct": lo.correct, "sign_valid": lo.valid}
        metrics = edge_metrics(out, targets)
        if sharded:
            return _global_stats(stats, metrics,
                                 ("loss", "sign_correct", "sign_valid"))
        return stats, metrics

    return evaluate


def policy_forward(model: EdgeUNet, images: torch.Tensor, cfg: Config):
    """U-Net forward -> (mu, sigma) flattened edge lists [B, E] (the
    padding column/row is dropped, so no mask is needed)."""
    out = model(images)
    mu_raw, sigma_raw = split_model_output(out)
    r = cfg.rl
    mu = flatten_edge_planes(squash_mu(mu_raw, r.mu_scale))
    sigma = flatten_edge_planes(
        squash_sigma(sigma_raw, r.sigma_min, r.sigma_max))
    return mu, sigma


def _pairs(x: torch.Tensor, antithetic: bool) -> torch.Tensor:
    return torch.cat([x, x], dim=0) if antithetic else x


def rl_loss(model: EdgeUNet, images: torch.Tensor, w: torch.Tensor,
            adv: torch.Tensor, cfg: Config) -> torch.Tensor:
    """REINFORCE loss of the fixed sample w under the policy's current
    forward (the gradient of differentiating through the sampled forward)."""
    mu, sigma = policy_forward(model, images, cfg)
    antithetic = cfg.rl.sampler == "antithetic"
    mu, sigma = _pairs(mu, antithetic), _pairs(sigma, antithetic)
    return reinforce_loss(adv, gaussian_logp(w, mu, sigma), mu.shape[-1],
                          cfg.rl.entropy_coef)


def rl_ppo_loss(model: EdgeUNet, images: torch.Tensor, w: torch.Tensor,
                adv: torch.Tensor, logp_old_elem: torch.Tensor,
                cfg: Config) -> torch.Tensor:
    """Per-edge clipped PPO surrogate of the fixed sample w."""
    mu, sigma = policy_forward(model, images, cfg)
    antithetic = cfg.rl.sampler == "antithetic"
    mu, sigma = _pairs(mu, antithetic), _pairs(sigma, antithetic)
    return ppo_clip_loss(adv, w, mu, sigma, logp_old_elem, mu.shape[-1],
                         cfg.rl.ppo_clip, cfg.rl.entropy_coef)


def segment_costs(costs_flat: torch.Tensor, height: int, width: int,
                  cfg: Config) -> torch.Tensor:
    """The batched solver at cfg.multicut's settings, as the reference's RL
    step calls it (matchings per round and the leaf choice at the solver's
    defaults)."""
    mc = cfg.multicut
    return multicut_grid(
        unflatten_edge_planes(costs_flat, height, width),
        mode=mc.mode, max_rounds=mc.max_rounds, icm_sweeps=mc.icm_sweeps,
        hier_rounds=tuple(mc.hier_rounds) if mc.hier_rounds else None,
        hier_caps=mc.hier_caps, hier_agg=mc.hier_agg)


def _rewards(images, labels, image_sizes, height, width, cfg: Config):
    rw = cfg.reward
    mc = cfg.multicut
    return compute_rewards_batched(
        images, labels, image_sizes, k_max=rw.max_segments,
        min_pixels=rw.min_pixels_per_segment, l_min=rw.l_min, beta=rw.beta,
        b_match_token=rw.b_match_token, gamma=rw.gamma,
        overhead_base=rw.overhead_base, adaptive_filter=rw.adaptive_filter,
        lam=rw.lambda_single_segment,
        entropy_correction=rw.entropy_correction,
        literal_hist=rw.literal_hist, distance_window=rw.distance_window,
        fallback_aware=rw.fallback_aware,
        fallback_reward_clip=rw.fallback_reward_clip,
        minlabel=produces_minlabel(height, width, mc.mode, mc.icm_sweeps))


@torch.no_grad()
def solve_and_reward(w: torch.Tensor, images: torch.Tensor,
                     image_sizes: torch.Tensor, cfg: Config):
    """Sampled costs w [B', E] on their images [B', H, W, 3] -> (labels
    [B', H, W] of the solver at cfg.multicut, rewards [B'])."""
    height, width = images.shape[1], images.shape[2]
    labels = segment_costs(w, height, width, cfg)
    return labels, _rewards(images, labels, image_sizes, height, width, cfg)


class RLStep:
    """One REINFORCE step in three stages (see the module docstring):
    `forward`, `solve_reward`, `update`; calling the object runs all three.
    cfg.rl.sampler "antithetic" solves mirrored pairs (2B solves) with the
    pair-difference advantage; baseline "value" subtracts the value net's
    prediction (trained in the same step) instead of the EMA;
    cfg.rl.ppo_epochs = K > 0 replaces the update by K clipped steps.

    With data_parallel (inside a process group) the images are
    this rank's slice of the global batch: the noise is the global draw's
    rows, mirrored pairs stay on their rank, and the baseline, advantages,
    reward mean and gradients are the global batch's."""

    def __init__(self, cfg: Config, data_parallel: bool = False):
        r = cfg.rl
        if r.sampler not in ("single", "antithetic"):
            raise ValueError(f"unknown rl.sampler: {r.sampler}")
        if r.baseline not in ("ema", "value"):
            raise ValueError(f"unknown rl.baseline: {r.baseline}")
        self.cfg = cfg
        self.antithetic = r.sampler == "antithetic"
        self.use_value = r.baseline == "value"
        self.dp = _data_parallel(data_parallel)

    def _gather(self, x: torch.Tensor, pairs: int) -> torch.Tensor:
        """A per-sample vector of this rank ([pairs * n]: the w+ rows, then
        the w- rows) -> the global batch's, in one process's order."""
        if not self.dp:
            return x
        size = pmesh.world()[1]
        return (pmesh.all_gather_rows(x).reshape(size, pairs, -1)
                .transpose(0, 1).reshape(-1))

    def _local(self, x: torch.Tensor, pairs: int) -> torch.Tensor:
        """The inverse of _gather: this rank's entries of a global
        vector."""
        if not self.dp:
            return x
        rank, size = pmesh.world()
        return x.reshape(pairs, size, -1)[:, rank].reshape(-1)

    @torch.no_grad()
    def forward(self, state: RLState, images: torch.Tensor):
        return policy_forward(state.model, images, self.cfg)

    @torch.no_grad()
    def solve_reward(self, key: tuple[int, int], step_idx: int,
                     mu: torch.Tensor, sigma: torch.Tensor,
                     images: torch.Tensor, image_sizes: torch.Tensor):
        """-> (w [B', E], rewards [B']): the sample keyed by
        fold_in(key, step_idx), solved and rewarded on its own image."""
        key = prng.fold_in(key, step_idx)
        with span("sample", mu.device):
            noise = None
            if self.dp:
                global_batch = mu.shape[0] * pmesh.world()[1]
                noise = policy_noise(key, mu, pmesh.rank_slice(global_batch),
                                     global_batch)
            sampler = (sample_antithetic_policy if self.antithetic
                       else sample_gaussian_policy)
            w = sampler(key, mu, sigma, noise).w
        if self.antithetic:
            images = torch.cat([images, images], dim=0)
            image_sizes = torch.cat([image_sizes, image_sizes], dim=0)
        return w, solve_and_reward(w, images, image_sizes, self.cfg)[1]

    def update(self, state: RLState, w: torch.Tensor, images: torch.Tensor,
               rewards: torch.Tensor, mu_old: torch.Tensor,
               sigma_old: torch.Tensor):
        r = self.cfg.rl
        pairs = 2 if self.antithetic else 1
        rewards_g = self._gather(rewards, pairs)
        # the EMA tracks the mean reward in every mode
        baseline, binit = ema_baseline_update(
            state.baseline, state.baseline_init, rewards_g,
            r.baseline_momentum)
        vloss = torch.zeros((), device=rewards.device)
        if self.antithetic:
            adv = antithetic_advantage(rewards_g)
        elif self.use_value:
            state.value_optimizer.zero_grad(set_to_none=True)
            v = state.value_model(images)
            vloss = torch.mean((v - rewards) ** 2)
            vloss.backward()
            if self.dp:
                pmesh.all_reduce_mean_(_grads(state.value_model))
            state.value_optimizer.step()
            # the advantage takes the prediction before the update, and
            # the policy does not shape V
            v = self._gather(v.detach(), 1)
            adv = (whitened_advantage(rewards_g, v) if r.whiten
                   else rewards_g - v)
        else:
            adv = (whitened_advantage(rewards_g, baseline) if r.whiten
                   else rewards_g - baseline)
        adv = self._local(adv, pairs)

        model, opt = state.model, state.optimizer
        if r.ppo_epochs > 0:
            # logp_old of the sampling distribution (stage 1's outputs)
            logp_old_elem = gaussian_logp_elem(
                w, _pairs(mu_old, self.antithetic),
                _pairs(sigma_old, self.antithetic))
            for _ in range(r.ppo_epochs):
                opt.zero_grad(set_to_none=True)
                loss = rl_ppo_loss(model, images, w, adv, logp_old_elem,
                                   self.cfg)
                loss.backward()
                if self.dp:
                    pmesh.all_reduce_mean_(_grads(model))
                opt.step()
        else:
            opt.zero_grad(set_to_none=True)
            loss = rl_loss(model, images, w, adv, self.cfg)
            loss.backward()
            if self.dp:
                pmesh.all_reduce_mean_(_grads(model))
            opt.step()
        state.step += 1
        state.baseline, state.baseline_init = baseline, binit
        loss, vloss = loss.detach().clone(), vloss.detach().clone()
        if self.dp:
            pmesh.all_reduce_mean_([loss, vloss])
        aux = {"loss": loss, "reward_mean": rewards_g.mean(),
               "baseline": baseline, "value_loss": vloss}
        return state, aux

    def __call__(self, state: RLState, key: tuple[int, int],
                 images: torch.Tensor, image_sizes: torch.Tensor,
                 timings: dict | None = None):
        """Runs the three stages; with `timings`, adds each stage's seconds
        (the device synchronized at each boundary) under "forward",
        "solve_reward" and "update". Traced, the step is a span "rl.step"
        (id = the state's step before it) holding the three stages."""
        clock = StageClock(timings, images.device)
        with span("rl.step", images.device, id=state.step):
            with clock.stage("forward"):
                mu, sigma = self.forward(state, images)
            with clock.stage("solve_reward"):
                w, rewards = self.solve_reward(key, state.step, mu, sigma,
                                               images, image_sizes)
            with clock.stage("update"):
                return self.update(state, w, images, rewards, mu, sigma)


def make_rl_step(cfg: Config, data_parallel: bool = False) -> RLStep:
    return RLStep(cfg, data_parallel)


def make_rl_eval(cfg: Config):
    """Deterministic-mu evaluation: evaluate(model, images, sizes) ->
    rewards [B] of the solver's labels on mu."""

    @torch.no_grad()
    def evaluate(model: EdgeUNet, images: torch.Tensor,
                 image_sizes: torch.Tensor) -> torch.Tensor:
        mu, _ = policy_forward(model, images, cfg)
        return solve_and_reward(mu, images, image_sizes, cfg)[1]

    return evaluate


def init_train_state(model: EdgeUNet, cfg: Config, seed: int = 0,
                     device: str | torch.device = "cpu") -> TrainState:
    """Seeded random weights (models/unet.init_random_) on `device` and a
    fresh pretraining optimizer."""
    model = init_random_(model, seed).to(device)
    return TrainState(model, make_pretrain_optimizer(cfg, model.parameters()))


def init_rl_state(model: EdgeUNet, cfg: Config,
                  value_model: torch.nn.Module | None = None) -> RLState:
    """A fresh RL state around `model` (already holding its weights, on its
    device): new optimizer(s), step 0, the EMA baseline uninitialized."""
    dev = next(model.parameters()).device
    return RLState(
        model, make_rl_optimizer(cfg, model.parameters()), 0,
        torch.zeros((), device=dev), torch.zeros((), dtype=torch.bool,
                                                 device=dev),
        value_model,
        (make_value_optimizer(cfg, value_model.parameters())
         if value_model is not None else None))
