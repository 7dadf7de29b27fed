"""Convert the reference's flax parameters and train states to torch.

Input: flax parameter trees as nested mappings of numpy arrays (with or
without the top-level "params" key), e.g. a checkpoint restored by the
reference package and mapped through numpy. Outputs: state_dicts for
models/unet.EdgeUNet and models/value.ValueNet, and the port's
TrainState / RLState with their optimizers' state; `flax_from_state_dict`
maps a state_dict back. Layouts:

  * Conv kernels are HWIO -> torch OIHW;
  * ConvTranspose kernels (kh, kw, in, out) map to torch ConvTranspose2d
    (in, out, kh, kw) spatially FLIPPED: flax's ConvTranspose defaults to
    transpose_kernel=False, i.e. a plain convolution over the dilated input;
  * Dense kernels (in, out) are transposed to torch's (out, in);
  * GroupNorm "scale" is torch's "weight".

Adam's first and second moments are elementwise in their parameter, so
they take their parameter's map (the ConvTranspose flip included); optax's
update `count` is torch's per-parameter `step`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax EdgeUNet or ValueNet params (or an Adam moment tree of the same
    structure) -> state_dict (f32 tensors)."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, value in _flatten(params):
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        module, leaf = path[:-1], path[-1]
        if leaf == "kernel":
            if arr.ndim == 2:  # Dense
                arr = arr.t()
            elif module[-1] == "up":  # ConvTranspose
                arr = arr.permute(2, 3, 0, 1).flip(-1, -2)
            else:
                arr = arr.permute(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(module + (leaf,))] = arr.contiguous()
    return out


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of state_dict_from_flax: an EdgeUNet or ValueNet
    state_dict -> the flax parameter tree {"params": ...} of numpy f32
    arrays, for the reference package to apply."""
    tree: dict = {}
    for name, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32)
        *module, leaf = name.split(".")
        if leaf == "weight":
            if arr.ndim == 2:  # Dense
                arr, leaf = arr.t(), "kernel"
            elif arr.ndim == 4 and module[-1] == "up":  # ConvTranspose
                arr, leaf = arr.flip(-1, -2).permute(2, 3, 0, 1), "kernel"
            elif arr.ndim == 4:
                arr, leaf = arr.permute(2, 3, 1, 0), "kernel"
            else:  # GroupNorm
                leaf = "scale"
        node = tree
        for key in module:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr.numpy())
    return {"params": tree}


def _fields(node) -> dict | None:
    """The named fields of a NamedTuple (optax's states) or a mapping."""
    if hasattr(node, "_asdict"):
        return node._asdict()
    if isinstance(node, Mapping):
        return dict(node)
    return None


def find_adam_state(opt_state) -> tuple[int, Mapping, Mapping]:
    """(count, mu, nu) of the one Adam state inside an optax state tree
    (adamw's, or chain(clip_by_global_norm, adam)'s), found by its field
    names, so no optax import is needed."""
    fields = _fields(opt_state)
    if fields is not None and {"count", "mu", "nu"} <= set(fields):
        return int(np.asarray(fields["count"])), fields["mu"], fields["nu"]
    children = (fields.values() if fields is not None
                else opt_state if isinstance(opt_state, (list, tuple))
                else ())
    for child in children:
        try:
            return find_adam_state(child)
        except LookupError:
            continue
    raise LookupError("no Adam state (count, mu, nu) in the optimizer state")


def load_optimizer_from_optax(optimizer: torch.optim.Optimizer,
                              module: torch.nn.Module, opt_state) -> None:
    """Set `optimizer`'s per-parameter Adam state from an optax state tree
    whose moments mirror `module`'s flax parameters."""
    count, mu, nu = find_adam_state(opt_state)
    mu_sd, nu_sd = state_dict_from_flax(mu), state_dict_from_flax(nu)
    for name, p in module.named_parameters():
        if name not in mu_sd:
            raise KeyError(f"optimizer state has no moment for {name}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu_sd[name].to(p.device, p.dtype),
            "exp_avg_sq": nu_sd[name].to(p.device, p.dtype)}


def _unet_for(params: Mapping, dtype, device):
    from image_compression_torch.models.unet import EdgeUNet
    sd = state_dict_from_flax(params)
    model = EdgeUNet(base=sd["inc.conv0.weight"].shape[0], dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.to(device)


def train_state_from_jax(jax_state: Any, cfg, dtype=torch.bfloat16,
                         device: str | torch.device = "cuda"):
    """The reference's TrainState (params, opt_state, step as numpy leaves)
    -> the port's TrainState: the EdgeUNet (base read from the params), an
    AdamW of cfg.pretrain holding the converted moments, and the step."""
    from image_compression_torch.device import resolve_device
    from image_compression_torch.train.steps import (TrainState,
                                                     make_pretrain_optimizer)
    device = resolve_device(device)
    model = _unet_for(jax_state.params, dtype, device)
    opt = make_pretrain_optimizer(cfg, model.parameters())
    load_optimizer_from_optax(opt, model, jax_state.opt_state)
    return TrainState(model, opt, int(np.asarray(jax_state.step)))


def rl_state_from_jax(jax_state: Any, cfg, dtype=torch.bfloat16,
                      device: str | torch.device = "cuda"):
    """The reference's RLState (numpy leaves) -> the port's RLState: the
    EdgeUNet and its clipped Adam with the converted moments, step,
    baseline, baseline_init, and (baseline "value") the ValueNet with its
    Adam."""
    from image_compression_torch.device import resolve_device
    from image_compression_torch.models.value import ValueNet
    from image_compression_torch.train.steps import init_rl_state
    device = resolve_device(device)
    model = _unet_for(jax_state.params, dtype, device)
    value_model = None
    if cfg.rl.baseline == "value":
        value_model = ValueNet(dtype=dtype)
        value_model.load_state_dict(
            state_dict_from_flax(jax_state.value_params), strict=True)
        value_model = value_model.to(device)
    state = init_rl_state(model, cfg, value_model)
    load_optimizer_from_optax(state.optimizer, model, jax_state.opt_state)
    if value_model is not None:
        load_optimizer_from_optax(state.value_optimizer, value_model,
                                  jax_state.value_opt_state)
    state.step = int(np.asarray(jax_state.step))
    state.baseline = torch.tensor(float(np.asarray(jax_state.baseline)),
                                  dtype=torch.float32, device=device)
    state.baseline_init = torch.tensor(
        bool(np.asarray(jax_state.baseline_init)), device=device)
    return state
