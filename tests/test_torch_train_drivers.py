"""Training loops and CLI of the PyTorch port (train/pretrain.py,
train/reinforce.py, train/checkpoint.py, train/data.py, cli/main.py) on a
tiny corpus on the CPU (base-8 U-Net, 32x32 images, batch 4), with the
settings of tests/test_drivers.py: step counts, checkpoint names, the
JSONL records' keys, the target caches, resume, the interrupt checkpoint,
the RL variants, and the CLI from pretraining to a lossless round trip
of a trained checkpoint. ImageBatches' order is the reference's."""

import json
import pathlib

import numpy as np
import pytest
import torch

from image_compression_torch.cli.main import main as cli
from image_compression_torch.config import Config, EdgeTarget
from image_compression_torch.io import pypng
from image_compression_torch.models.unet import EdgeUNet
from image_compression_torch.train import pretrain as pt
from image_compression_torch.train import reinforce as rf
from image_compression_torch.train.checkpoint import load_params
from image_compression_torch.train.data import ImageBatches
from image_compression_torch.utils.pattern_generator import GENERATORS

torch.set_num_threads(2)

SUMMARY = ("precision_conn", "recall_conn", "f1_conn", "precision_cut",
           "recall_cut", "f1_cut")
PRETRAIN_KEYS = {"time", "phase", "epoch", "batch", "train_loss",
                 "train_sign_acc", "val_loss", "val_sign_acc",
                 *(f"train_{k}" for k in SUMMARY),
                 *(f"val_{k}" for k in SUMMARY)}
EPOCH_KEYS = {"time", "phase", "epoch", "avg_loss", "seconds"}
RL_KEYS = {"time", "phase", "epoch", "step", "loss", "reward_mean",
           "baseline", "eval_reward_mean", "sampler", "rl_baseline"}


@pytest.fixture
def tiny_dataset(tmp_path):
    rng = np.random.default_rng(0)
    dirs = []
    for name, n in (("train", 8), ("val", 2)):
        d = tmp_path / name
        d.mkdir()
        for i in range(n):
            img = GENERATORS["low_frequency"](32, 32, False, rng)
            (d / f"{name[0]}{i}.png").write_bytes(pypng.encode(img))
        dirs.append(d)
    return dirs


def tiny_cfg(tmp_path, train, val):
    cfg = Config(dataset_dir=str(train), val_dataset_dir=str(val),
                 results_dir=str(tmp_path / "results"),
                 cache_dir=str(tmp_path / "cache"), image_size=32)
    cfg.edge_target = EdgeTarget.CANNY
    cfg.pretrain.epochs = 1
    cfg.pretrain.batch_size = 4
    cfg.pretrain.val_every = 2
    cfg.rl.epochs = 1
    cfg.rl.batch_size = 4
    cfg.rl.eval_every = 2
    cfg.multicut.max_rounds = 6
    cfg.multicut.icm_sweeps = 1
    cfg.reward.max_segments = 16
    return cfg


def _pretrain(cfg, **kw):
    return pt.run_pretraining(cfg, log=kw.pop("log", lambda *_: None),
                              device="cpu", model=EdgeUNet(base=8), **kw)


def _records(results):
    return [json.loads(ln) for p in sorted(results.glob("metrics_*.jsonl"))
            for ln in p.read_text().splitlines()]


def test_pretrain_then_reinforce(tmp_path, tiny_dataset):
    cfg = tiny_cfg(tmp_path, *tiny_dataset)
    logs = []
    state, run_id = _pretrain(cfg, log=logs.append)
    assert state.step == 2  # 8 images / batch 4
    assert any("val" in ln for ln in logs)
    results = tmp_path / "results"
    names = {p.name for p in results.iterdir()}
    assert {f"fcn_pretrained_{run_id}_{t}" for t in
            ("best", "epoch_1", "final")} <= names

    rl_logs = []
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    rl_state, rl_id = rf.run_reinforce(cfg, before, log=rl_logs.append,
                                       device="cpu")
    assert rl_state.step == 2
    assert bool(rl_state.baseline_init)
    assert any("Eval reward" in ln for ln in rl_logs)
    assert any(not torch.equal(v, before[k])
               for k, v in rl_state.model.state_dict().items())
    names = {p.name for p in results.iterdir()}
    assert {f"fcn_training_{rl_id}_best_params",
            f"fcn_training_{rl_id}_final"} <= names
    # a *_params file is a plain EdgeUNet state_dict
    sd = torch.load(results / f"fcn_training_{rl_id}_best_params",
                    weights_only=True)
    EdgeUNet(base=8).load_state_dict(sd)

    records = _records(results)
    pre = [r for r in records if r["phase"] == "pretrain"]
    assert [r["batch"] for r in pre] == [1, 2]
    assert all(set(r) == PRETRAIN_KEYS for r in pre)
    assert [set(r) for r in records if r["phase"] == "pretrain_epoch"] == \
        [EPOCH_KEYS]
    rl = [r for r in records if r["phase"] == "rl"]
    assert len(rl) == 1 and set(rl[0]) == RL_KEYS
    assert np.isfinite(rl[0]["reward_mean"])


def test_pretrain_target_ensemble(tmp_path, tiny_dataset):
    """target_ensemble cycles the four extractors per batch
    ((epoch * 7919 + batch) % 4: GRAPH then CANNY in epoch 1) and keys the
    disk cache per extractor."""
    cfg = tiny_cfg(tmp_path, *tiny_dataset)
    cfg.pretrain.target_ensemble = True
    state, _ = _pretrain(cfg)
    assert state.step == 2
    cache_files = list((tmp_path / "cache" / "targets").glob("*.bits"))
    assert len(cache_files) == 8  # 2 batches x 4 images
    assert [pt.ENSEMBLE[(1 * 7919 + b) % 4] for b in (1, 2)] == \
        [EdgeTarget.GRAPH, EdgeTarget.CANNY]


def test_target_cache_survives_restart(tmp_path, tiny_dataset,
                                       monkeypatch):
    """A second run reads every train target from disk: the extractor is
    called for the validation batch only."""
    cfg = tiny_cfg(tmp_path, *tiny_dataset)
    _pretrain(cfg)
    assert len(list((tmp_path / "cache" / "targets").glob("*.bits"))) == 8
    real = pt.create_target_with_mask
    calls = {"train_misses": 0}

    def counting(images, target):
        if images.shape[0] == cfg.pretrain.batch_size:
            calls["train_misses"] += 1
        return real(images, target)

    monkeypatch.setattr(pt, "create_target_with_mask", counting)
    _pretrain(cfg)
    assert calls["train_misses"] == 0


def test_disk_cache_names_are_the_reference_s(tmp_path):
    """The same sha1 file names as the reference's TargetDiskCache."""
    from image_compression_tpu.train.pretrain import \
        TargetDiskCache as JCache
    ours = pt.TargetDiskCache(tmp_path, "canny", 256)
    theirs = JCache(tmp_path, "canny", 256)
    assert ours.VERSION == theirs.VERSION == 2
    assert ours._path("a/b.png") == theirs._path("a/b.png")
    bits = np.arange(7, dtype=np.uint8)
    ours.store("a/b.png", bits)
    np.testing.assert_array_equal(theirs.load("a/b.png"), bits)


def test_pretrain_resume_and_interrupt(tmp_path, tiny_dataset, monkeypatch):
    """resume restores params + optimizer + step and skips finished
    epochs; the interrupt checkpoint (after the first batch) resumes from
    its step."""
    cfg = tiny_cfg(tmp_path, *tiny_dataset)
    state1, run1 = _pretrain(cfg)
    ckpt_path = tmp_path / "results" / f"fcn_pretrained_{run1}_final"
    cfg.pretrain.epochs = 2
    logs = []
    state2, _ = _pretrain(cfg, log=logs.append, resume=str(ckpt_path))
    assert any("resumed" in ln for ln in logs)
    assert state2.step == 4  # one more epoch of 2 steps
    with pytest.raises(ValueError, match="mutually exclusive"):
        _pretrain(cfg, resume=str(ckpt_path), init_params=str(ckpt_path))

    class Flagged(pt._Interrupt):
        def __init__(self):
            super().__init__()
            self.flag = True  # a signal arrived during the first batch

    monkeypatch.setattr(pt, "_Interrupt", Flagged)
    state3, run3 = _pretrain(cfg)
    assert state3.step == 1
    interrupt = tmp_path / "results" / f"fcn_pretrained_{run3}_interrupt"
    monkeypatch.undo()
    state4, _ = _pretrain(cfg, resume=str(interrupt))
    # as in the reference: the step (1) implies epoch 1, which runs again
    # from its start (steps 2-3), then epoch 2 (steps 4-5)
    assert state4.step == 5


@pytest.mark.parametrize("variant", ["antithetic", "value", "ppo"])
def test_reinforce_variants(tmp_path, tiny_dataset, variant):
    cfg = tiny_cfg(tmp_path, *tiny_dataset)
    if variant == "antithetic":
        cfg.rl.sampler = "antithetic"
    elif variant == "value":
        cfg.rl.baseline = "value"
    else:
        cfg.rl.ppo_epochs = 2
    params = EdgeUNet(base=8).state_dict()
    logs = []
    state, _ = rf.run_reinforce(cfg, params, log=logs.append, device="cpu")
    assert state.step == 2
    assert any("Eval reward" in ln for ln in logs)
    rec = [r for r in _records(tmp_path / "results") if r["phase"] == "rl"]
    assert rec and np.isfinite(rec[0]["loss"])
    if variant == "value":
        assert "value_loss" in rec[0]
        assert all(torch.isfinite(p).all()
                   for p in state.value_model.parameters())


def test_reinforce_eval_stride_latest_and_resume(tmp_path, tiny_dataset):
    """The eval stride is min(eval_every, steps per epoch): eval_every 1000
    still evaluates once an epoch; eval_every 1 over 5 epochs of 2 steps
    gives 10 evaluations and a "latest" checkpoint at the 5th and 10th;
    resume from "latest" continues at its step."""
    cfg = tiny_cfg(tmp_path, *tiny_dataset)
    cfg.rl.eval_every = 1000
    params = EdgeUNet(base=8).state_dict()
    logs = []
    rf.run_reinforce(cfg, params, log=logs.append, device="cpu")
    assert sum("Eval reward" in ln for ln in logs) == 1

    cfg.rl.eval_every = 1
    cfg.rl.epochs = 5
    logs = []
    state, run_id = rf.run_reinforce(cfg, params, log=logs.append,
                                     device="cpu")
    assert state.step == 10
    assert sum("Eval reward" in ln for ln in logs) == 10
    latest = tmp_path / "results" / f"fcn_training_{run_id}_latest"
    assert latest.exists()
    cfg.rl.epochs = 6
    logs = []
    resumed, _ = rf.run_reinforce(cfg, params, log=logs.append, device="cpu",
                                  resume=str(latest))
    assert any("at step 10" in ln for ln in logs)
    assert resumed.step == 12


def test_image_batches_order_is_the_reference_s(tmp_path, tiny_dataset):
    from image_compression_tpu.train.data import ImageBatches as JBatches
    paths = sorted(tiny_dataset[0].glob("*.png"))
    ours = ImageBatches(paths, 3, 32, yield_indices=True, seed=4,
                        with_file_sizes=True, drop_last=False)
    theirs = JBatches(paths, 3, 32, yield_indices=True, seed=4,
                      with_file_sizes=True, drop_last=False)
    assert len(ours) == len(theirs) == 3
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        want = list(theirs.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_cli_pretrain_train_compress_round_trip(tmp_path, tiny_dataset):
    """pretrain -> train -> compress --checkpoint <best_params> ->
    reassemble, lossless, with the shipped base-64 U-Net at 32x32; without
    --device cpu the commands raise here (no GPU)."""
    from image_compression_torch.io.image_io import ensure_rgba, load_image
    train, val = tiny_dataset
    cfg = tiny_cfg(tmp_path, train, val)
    conf = tmp_path / "cfg.json"
    conf.write_text(json.dumps(cfg.to_dict()))
    res = tmp_path / "results"
    common = ["--config", str(conf), "--device", "cpu"]
    cli(["pretrain", *common, "--epochs", "1"])  # the shipped base 64
    final = next(res.glob("fcn_pretrained_*_final"))
    cli(["train", *common, "--checkpoint", str(final)])
    best = next(res.glob("fcn_training_*_best_params"))
    assert set(load_params(best)) == set(EdgeUNet(base=8).state_dict())
    out = tmp_path / "compressed"
    cli(["compress", "--dataset-dir", str(val), "--results-dir", str(out),
         "--checkpoint", str(best), "--device", "cpu"])
    for src in sorted(val.glob("*.png")):
        rec = tmp_path / f"{src.stem}_rec.png"
        cli(["reassemble", str(out / src.stem), "-o", str(rec)])
        np.testing.assert_array_equal(load_image(rec),
                                      ensure_rgba(load_image(src)))
    if not torch.cuda.is_available():
        for cmd in (["pretrain", "--config", str(conf)],
                    ["train", "--config", str(conf), "--checkpoint",
                     str(final)]):
            with pytest.raises(RuntimeError, match="cuda"):
                cli(cmd)


def test_compute_global_pos_weight(tmp_path, tiny_dataset):
    """The dataset-wide neg/pos ratio of the connect class over valid
    edges, against the reference's on the same batches (canny targets,
    bitwise on both sides, so the ratio is the same float)."""
    from image_compression_tpu.config import Config as JConfig
    from image_compression_tpu.config import EdgeTarget as JTarget
    from image_compression_tpu.train.data import ImageBatches as JBatches
    from image_compression_tpu.train.pretrain import \
        compute_global_pos_weight as j_pos_weight
    paths = sorted(tiny_dataset[0].glob("*.png"))
    cfg = tiny_cfg(tmp_path, *tiny_dataset)
    jcfg = JConfig(edge_target=JTarget.CANNY)
    got = pt.compute_global_pos_weight(ImageBatches(paths, 4, 32), cfg,
                                       max_batches=1, device="cpu")
    want = j_pos_weight(JBatches(paths, 4, 32), jcfg, max_batches=1)
    assert got == want and got > 0
