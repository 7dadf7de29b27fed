"""Supervised pretraining loop.

Port of the reference's train/pretrain.py: an epoch loop over the train
set with validation every val_every batches (and after the first), the
best-on-validation / per-epoch / final checkpoints under a unix-timestamp
run id, the JSONL metrics (loss, sign accuracy, P/R/F1 for connect and
cut), resume from a full-state checkpoint, warm start from a params file,
and a checkpoint on SIGTERM/SIGINT. The classical targets are computed on
the device once per image and extractor, cached as packed bits in RAM and
on disk (TargetDiskCache, the reference's file names and format).

Data parallel (use_mesh, inside a torch.distributed process group: see
parallel/): every rank reads each global batch and trains on its slice
(the step reduces over the ranks), validation shards a batch when it
divides by the world size, the parameters are broadcast from rank 0 at the
start and after a resume, and only rank 0 writes checkpoints, the JSONL
log and the log lines.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import signal
import time

import numpy as np
import torch

from image_compression_torch.config import Config, EdgeTarget
from image_compression_torch.device import resolve_device
from image_compression_torch.io.image_io import find_image_files_recursively
from image_compression_torch.models.unet import EdgeUNet
from image_compression_torch.ops.edges import edge_validity_masks
from image_compression_torch.ops.targets import create_target_with_mask
from image_compression_torch.parallel import mesh as pmesh
from image_compression_torch.train.checkpoint import (CheckpointManager,
                                                      load_params)
from image_compression_torch.train.data import ImageBatches
from image_compression_torch.train.ranks import RankSetup
from image_compression_torch.train.steps import (init_train_state,
                                                 make_pretrain_eval,
                                                 make_pretrain_step)

ENSEMBLE = (EdgeTarget.GRAPH, EdgeTarget.CANNY, EdgeTarget.SLIC,
            EdgeTarget.WATERSHED)


class TargetDiskCache:
    """Disk layer of the pretraining target cache: one packed-bits file per
    (image path, extractor, resolution) under cache_dir/targets, named by
    the sha1 of "<path>|<extractor>|<size>|v<VERSION>" (the reference's
    names, so the two share a cache). Files are written to a per-process
    temporary name and renamed, so a killed run leaves no truncated
    entry."""

    VERSION = 2  # bump when an extractor's output changes

    def __init__(self, cache_dir, extractor: str, image_size: int):
        self.dir = pathlib.Path(cache_dir) / "targets"
        self.dir.mkdir(parents=True, exist_ok=True)
        self._tag = f"{extractor}|{image_size}|v{self.VERSION}"

    def _path(self, image_path):
        key = hashlib.sha1(f"{image_path}|{self._tag}".encode()).hexdigest()
        return self.dir / f"{key}.bits"

    def load(self, image_path) -> np.ndarray | None:
        try:
            return np.fromfile(self._path(image_path), dtype=np.uint8)
        except FileNotFoundError:
            return None

    def store(self, image_path, bits: np.ndarray) -> None:
        p = self._path(image_path)
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        bits.tofile(tmp)
        tmp.replace(p)


class _Interrupt:
    """The first SIGTERM/SIGINT sets `flag` (the loop checkpoints after
    the current batch and returns); a second takes the previous handler."""

    def __init__(self):
        self.flag = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread: no handlers
                pass

    def _on_signal(self, signum, frame):
        self.flag = True
        signal.signal(signum, self._prev[signum])

    def restore(self) -> None:
        for sig, handler in self._prev.items():
            signal.signal(sig, handler)

    def any_rank(self, dp: bool, device: torch.device) -> bool:
        """The flag of any rank (every rank then stops after the same
        batch); the local flag without data parallelism."""
        if not dp:
            return self.flag
        flag = torch.tensor([float(self.flag)], device=device)
        pmesh.all_reduce_sum_([flag])
        return bool(flag.item() > 0)


def run_pretraining(cfg: Config, log=print, resume: str | None = None,
                    init_params: str | None = None,
                    device: str | torch.device = "cuda",
                    model: EdgeUNet | None = None,
                    use_mesh: bool = True) -> tuple:
    """Returns (final TrainState, run_id).

    use_mesh: inside a process group (parallel/mesh.initialize_distributed),
    train data parallel over its ranks (False there raises);
    cfg.pretrain.batch_size is the global batch and must divide by the
    world size.

    model: the EdgeUNet to train (default: base 64, bf16), given seeded
    random weights (models/unet.init_random_, seed 0).
    init_params: a params file (save_params) to warm-start from; the
    optimizer state and step start fresh. Exclusive with `resume`.
    resume: a full-state checkpoint; training continues at the epoch its
    step implies. SIGTERM/SIGINT save "<run>_interrupt" after the current
    batch and return.
    """
    p = cfg.pretrain
    ranks = RankSetup(use_mesh, device, p.batch_size, cfg.results_dir,
                      "fcn_pretrained", log)
    device, log = ranks.device, ranks.log
    state = init_train_state(model if model is not None else EdgeUNet(),
                             cfg, 0, device)

    train_paths = find_image_files_recursively(cfg.dataset_dir,
                                               cfg.image_format)
    train_paths = train_paths[:p.max_train_images]
    val_paths = find_image_files_recursively(cfg.val_dataset_dir,
                                             cfg.image_format)
    val_paths = val_paths[:p.max_val_images]
    if not train_paths:
        raise FileNotFoundError(f"no images under {cfg.dataset_dir}")

    cache = 4 << 30  # decoded-image RAM cache (epochs re-read the corpus)
    train_data = ImageBatches(train_paths, p.batch_size, cfg.image_size,
                              workers=4, drop_last=True, yield_indices=True,
                              cache_bytes=cache)
    val_data = ImageBatches(val_paths, p.batch_size, cfg.image_size,
                            workers=2, drop_last=False,
                            cache_bytes=cache // 4)

    start_epoch = 1
    if init_params is not None:
        if resume is not None:
            raise ValueError("--init-params and --resume are mutually "
                             "exclusive: resume restores full state and "
                             "would discard the warm-started params")
        state.model.load_state_dict(load_params(init_params))
        log(f"warm-started params from {init_params}")
    if resume is not None:
        CheckpointManager.restore_path(resume, state)
        steps_per_epoch = max(len(train_paths) // p.batch_size, 1)
        start_epoch = 1 + state.step // steps_per_epoch
        log(f"resumed from {resume} at step {state.step} "
            f"(epoch {start_epoch})")
    if ranks.dp:
        pmesh.broadcast_module_(state.model)
    step_fn = make_pretrain_step(cfg, data_parallel=ranks.dp)
    eval_fn = make_pretrain_eval(cfg)

    # cycled extractor schedule (cfg.pretrain.target_ensemble): batch t
    # trains against extractor t mod 4; validation stays on cfg.edge_target
    ensemble = ENSEMBLE if p.target_ensemble else (cfg.edge_target,)

    def to_device(arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr).to(device, non_blocking=True)

    def targets_fn(images, target=cfg.edge_target) -> torch.Tensor:
        with torch.no_grad():
            return create_target_with_mask(images, target)

    # targets are deterministic per image: computed once, reused across
    # epochs; cost planes are {0, 1}, so each image caches as packed bits
    # in RAM and on disk; the masks are static and rebuilt on load
    masks_np = edge_validity_masks(cfg.image_size, cfg.image_size).numpy()
    val_targets: dict = {}

    def unpack(bits):
        flat = np.unpackbits(bits, count=cfg.image_size * cfg.image_size * 2)
        return flat.reshape(cfg.image_size, cfg.image_size, 2) \
            .astype(np.float32)

    disks = {t: TargetDiskCache(cfg.cache_dir, t.value, cfg.image_size)
             for t in ensemble}
    train_target_bits: dict = {}

    def lookup(target, idx) -> np.ndarray | None:
        bits = train_target_bits.get((target, int(idx)))
        if bits is None:
            bits = disks[target].load(train_paths[int(idx)])
            if bits is not None:
                train_target_bits[(target, int(idx))] = bits
        return bits

    def train_targets(indices, images, target) -> torch.Tensor:
        missing = [j for j, idx in enumerate(indices)
                   if lookup(target, idx) is None]
        if missing:  # any miss: compute the whole batch, cache new entries
            targets = targets_fn(images, target)
            host = targets.cpu().numpy()
            for j in missing:
                bits = np.packbits(host[j, :, :, :2].astype(np.uint8),
                                   axis=None)
                train_target_bits[(target, int(indices[j]))] = bits
                disks[target].store(train_paths[int(indices[j])], bits)
            return targets
        costs = np.stack([unpack(train_target_bits[(target, int(idx))])
                          for idx in indices]) * masks_np[None]
        return to_device(np.concatenate(
            [costs, np.broadcast_to(masks_np[None], costs.shape)], axis=-1))

    best_val_loss = float("inf")

    def run_validation():
        loss_num = loss_den = 0.0
        correct = valid = 0
        agg = None
        for i, images in enumerate(val_data.epoch(0, shuffle=False)):
            rows = ranks.shard(len(images))
            images = to_device(images if rows is None else images[rows])
            if i not in val_targets:
                val_targets[i] = targets_fn(images)
            stats, m = eval_fn(state.model, images, val_targets[i],
                               sharded=rows is not None)
            w = float(stats["valid_weight"])
            loss_num += float(stats["loss"]) * w
            loss_den += w
            correct += int(stats["sign_correct"])
            valid += int(stats["sign_valid"])
            agg = m if agg is None else agg + m
        val_loss = loss_num / max(loss_den, 1e-12)
        acc = correct / max(valid, 1)
        return val_loss, acc, (agg.summary() if agg is not None else {})

    metrics_log = ranks.metrics(cfg.results_dir)
    interrupt = _Interrupt()
    try:
        for epoch in range(start_epoch, p.epochs + 1):
            epoch_losses: list = []  # device scalars, fetched once an epoch
            t0 = time.time()
            for batch_count, (images, indices) in enumerate(
                    train_data.epoch(epoch), 1):
                images = to_device(images[ranks.rows])
                indices = indices[ranks.rows]
                ext = ensemble[(epoch * 7919 + batch_count) % len(ensemble)]
                targets = train_targets(indices, images, ext)
                _, aux, train_m = step_fn(state, images, targets)
                epoch_losses.append(aux["loss"])
                if interrupt.any_rank(ranks.dp, device):
                    path = ranks.save("interrupt", state)
                    log(f"interrupted: checkpointed to {path}")
                    return state, ranks.ckpt.run_id

                if batch_count % p.val_every == 0 or batch_count == 1:
                    val_loss, val_acc, val_sum = run_validation()
                    train_acc = (int(aux["sign_correct"])
                                 / max(int(aux["sign_valid"]), 1))
                    tm = train_m.summary()
                    record = {
                        "phase": "pretrain", "epoch": epoch,
                        "batch": batch_count,
                        "train_loss": float(aux["loss"]),
                        "train_sign_acc": train_acc,
                        "val_loss": val_loss, "val_sign_acc": val_acc,
                        **{f"train_{k}": v for k, v in tm.items()},
                        **{f"val_{k}": v for k, v in val_sum.items()},
                    }
                    metrics_log.write(record)
                    log(f"Epoch [{epoch}/{p.epochs}] Batch [{batch_count}] "
                        f"train: loss={record['train_loss']:.4f} "
                        f"sign_acc={train_acc:.4f} "
                        f"cut P/R/F1={tm['precision_cut']:.3f}/"
                        f"{tm['recall_cut']:.3f}/{tm['f1_cut']:.3f} "
                        f"| val: loss={val_loss:.4f} sign_acc={val_acc:.4f} "
                        f"cut P/R/F1={val_sum.get('precision_cut', 0):.3f}/"
                        f"{val_sum.get('recall_cut', 0):.3f}/"
                        f"{val_sum.get('f1_cut', 0):.3f}")
                    if val_loss < best_val_loss:
                        best_val_loss = val_loss
                        ranks.save("best", state)

            avg_loss = (float(torch.stack(epoch_losses).mean())
                        if epoch_losses else 0.0)
            metrics_log.write({"phase": "pretrain_epoch", "epoch": epoch,
                               "avg_loss": avg_loss,
                               "seconds": time.time() - t0})
            log(f"Epoch [{epoch}/{p.epochs}] avg loss {avg_loss:.4f} "
                f"({time.time() - t0:.1f}s)")
            ranks.save(f"epoch_{epoch}", state)

        ranks.save("final", state)
        return state, ranks.ckpt.run_id
    finally:
        interrupt.restore()
        metrics_log.close()


def compute_global_pos_weight(data: ImageBatches, cfg: Config,
                              max_batches: int | None = None,
                              device: str | torch.device = "cuda") -> float:
    """Dataset-wide neg/pos ratio of the connect class over valid edges of
    cfg.edge_target's targets (a data-derived pos_weight)."""
    device = resolve_device(device)
    n_pos = n_neg = 0.0
    for i, images in enumerate(data.epoch(0, shuffle=False)):
        if isinstance(images, tuple):
            images = images[0]
        with torch.no_grad():
            t = create_target_with_mask(torch.as_tensor(images).to(device),
                                        cfg.edge_target)
        y, m = t[..., :2], t[..., 2:] > 0
        n_pos += float(((y > 0.5) & m).sum())
        n_neg += float(((y < 0.5) & m).sum())
        if max_batches and i + 1 >= max_batches:
            break
    return (n_neg + 1e-6) / (n_pos + 1e-6)
