"""Online REINFORCE loop.

Port of the reference's train/reinforce.py: from pretrained params, per
batch one RL step (policy sample -> multicut -> PNG-size reward -> EMA
baseline -> advantage -> entropy-regularized update with the global-norm
clip); every min(eval_every, steps_per_epoch) steps a deterministic-mu
evaluation on the validation set, a JSONL record, a full-state "latest"
checkpoint every 5th evaluation and the params of the best evaluation so
far ("best_params"); a final checkpoint at the end. Resume and the
SIGTERM/SIGINT interrupt checkpoint as in the pretraining loop.

Data parallel as the pretraining loop (use_mesh inside a process group):
each rank trains on its slice of every global batch, evaluation shards a
batch that divides by the world size and sums the rewards over the ranks,
the U-Net (and value net) are broadcast from rank 0 at the start and after
a resume, and only rank 0 writes.
"""

from __future__ import annotations

from typing import Mapping

import torch

from image_compression_torch.config import Config
from image_compression_torch.io.image_io import find_image_files_recursively
from image_compression_torch.models.unet import EdgeUNet
from image_compression_torch.ops import prng
from image_compression_torch.parallel import mesh as pmesh
from image_compression_torch.train.checkpoint import (CheckpointManager,
                                                      save_params)
from image_compression_torch.train.data import ImageBatches
from image_compression_torch.train.pretrain import _Interrupt
from image_compression_torch.train.ranks import RankSetup
from image_compression_torch.train.steps import (init_rl_state,
                                                 make_rl_eval, make_rl_step)


def run_reinforce(cfg: Config, pretrained_params: Mapping[str, torch.Tensor],
                  log=print, resume: str | None = None,
                  device: str | torch.device = "cuda",
                  use_mesh: bool = True):
    """Returns (final RLState, run_id).

    pretrained_params: an EdgeUNet state_dict (its base is read from it);
    the U-Net computes in bf16 with f32 parameters.
    resume: a prior RL full-state checkpoint (optimizer, EMA baseline and
    value net included); continues at its step. The value-baseline setting
    must match the run being resumed.
    use_mesh: inside a process group (parallel/mesh.initialize_distributed),
    train data parallel over its ranks (False there raises);
    cfg.rl.batch_size is the global batch and must divide by the world
    size.
    """
    r = cfg.rl
    ranks = RankSetup(use_mesh, device, r.batch_size, cfg.results_dir,
                      "fcn_training", log)
    device, log = ranks.device, ranks.log
    model = EdgeUNet(base=pretrained_params["inc.conv0.weight"].shape[0])
    model.load_state_dict(pretrained_params)
    model = model.to(device)
    value_model = None
    if r.baseline == "value":
        from image_compression_torch.models.unet import init_random_
        from image_compression_torch.models.value import ValueNet
        value_model = init_random_(ValueNet(), seed=1).to(device)
    state = init_rl_state(model, cfg, value_model)
    if resume is not None:
        CheckpointManager.restore_path(resume, state)
        log(f"resumed RL state from {resume} at step {state.step}")
    if ranks.dp:
        for net in (model, value_model):
            if net is not None:
                pmesh.broadcast_module_(net)

    train_paths = find_image_files_recursively(cfg.dataset_dir,
                                               cfg.image_format)
    train_paths = train_paths[:r.max_train_images]
    val_paths = find_image_files_recursively(cfg.val_dataset_dir,
                                             cfg.image_format)
    val_paths = val_paths[:r.max_val_images]
    if not train_paths:
        raise FileNotFoundError(f"no images under {cfg.dataset_dir}")

    cache = 4 << 30  # decoded-image RAM cache (epochs re-read the corpus)
    train_data = ImageBatches(train_paths, r.batch_size, cfg.image_size,
                              with_file_sizes=True, workers=4, drop_last=True,
                              cache_bytes=cache)
    val_data = ImageBatches(val_paths, r.batch_size, cfg.image_size,
                            with_file_sizes=True, workers=2, drop_last=False,
                            cache_bytes=cache // 4)

    step_fn = make_rl_step(cfg, data_parallel=ranks.dp)
    eval_fn = make_rl_eval(cfg)
    ckpt = ranks.ckpt
    metrics_log = ranks.metrics(cfg.results_dir)
    # constant base key: the step folds in its step counter
    key = prng.prng_key(0)

    def to_device(arr):
        return torch.as_tensor(arr).to(device, non_blocking=True)

    def run_eval():
        rsum = 0.0
        n = 0
        for images, sizes in val_data.epoch(0, shuffle=False):
            rows = ranks.shard(len(images))
            if rows is not None:
                images, sizes = images[rows], sizes[rows]
            total = eval_fn(state.model, to_device(images),
                            to_device(sizes)).sum()
            if rows is not None:
                total = total.clone()
                pmesh.all_reduce_sum_([total])
            rsum += float(total)
            n += len(images) * (1 if rows is None else ranks.size)
        return rsum / max(n, 1)

    # skip the epochs a resumed run already finished (step counts batches)
    steps_per_epoch = max(len(train_paths) // r.batch_size, 1)
    start_epoch = state.step // steps_per_epoch
    n_evals = 0
    best_eval = -float("inf")
    interrupt = _Interrupt()
    try:
        for epoch in range(start_epoch, r.epochs):
            for batch_count, (images, sizes) in enumerate(
                    train_data.epoch(epoch), 1):
                _, aux = step_fn(state, key, to_device(images[ranks.rows]),
                                 to_device(sizes[ranks.rows]))
                if interrupt.any_rank(ranks.dp, device):
                    path = ranks.save("interrupt", state)
                    log(f"interrupted: checkpointed to {path}")
                    return state, ckpt.run_id

                # the stride is capped at the epoch length: batch_count
                # restarts every epoch, so a longer stride would never eval
                if batch_count % min(r.eval_every, steps_per_epoch) == 0:
                    n_evals += 1
                    eval_r = run_eval()
                    record = {"phase": "rl", "epoch": epoch,
                              "step": batch_count,
                              "loss": float(aux["loss"]),
                              "reward_mean": float(aux["reward_mean"]),
                              "baseline": float(aux["baseline"]),
                              "eval_reward_mean": eval_r,
                              "sampler": r.sampler,
                              "rl_baseline": r.baseline}
                    if r.baseline == "value":
                        record["value_loss"] = float(aux["value_loss"])
                    metrics_log.write(record)
                    log(f"epoch={epoch} step={batch_count} "
                        f"loss={record['loss']:.6f} "
                        f"Rmean={record['reward_mean']:.4f} "
                        f"baseline={record['baseline']:.4f}")
                    log(f"Eval reward mean={eval_r:.4f}")
                    # full-state saves are large: every 5th evaluation
                    if n_evals % 5 == 0:
                        ranks.save("latest", state)
                    # the params of the best evaluation so far (RL can
                    # drift away from a good start)
                    if eval_r > best_eval:
                        best_eval = eval_r
                        if ranks.lead:
                            save_params(ckpt._path("best_params"),
                                        state.model.state_dict())

        ranks.save("final", state)
        return state, ckpt.run_id
    finally:
        interrupt.restore()
        metrics_log.close()
