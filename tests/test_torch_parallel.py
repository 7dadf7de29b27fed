"""Data parallelism and meshes of the PyTorch port (parallel/mesh.py and
the data-parallel train steps).

- shard_batch places equal chunks in device order and raises on an uneven
  split; replicate copies; make_mesh names only what it is given (CUDA by
  default, raising without it).
- initialize_distributed is a no-op without a cluster environment and
  raises on a partial one; world() is (0, 1) without a group.
- Two gloo processes (file:// rendezvous, so parallel test runs cannot
  collide on a port) each take half of a global batch of 4 (f32 EdgeUNet
  base 8, 32x32) and run one pretrain step, one REINFORCE step with the
  antithetic sampler and one with the single sampler, EMA baseline and
  whitening. Their losses, rewards, baselines and parameters are within
  1e-6 of one process running the same steps on the global batch (the
  ranks' parameters bitwise equal to each other). Rank 0's reduced
  gradients (before the RL step's clip) are within 1e-5 x each tensor's
  largest entry of the one process's, and so is the global norm the clip
  saw: Adam's update and a binding clip cancel a constant factor, so only
  the gradients show a sum taken where a mean is due. That one-process step is
  held to the reference by tests/test_torch_train_steps.py. The exception,
  as in that file: a conv bias that feeds a GroupNorm of one channel per
  group has a zero gradient in exact arithmetic (the norm subtracts it
  again), so its computed gradient is rounding noise that Adam's first step
  scales to +-lr; for those the gradients (the ranks' reduced one and the
  one process's) are held to 1e-5 x the model's largest gradient instead.
- The same processes run run_pretraining and run_reinforce (global batch
  4, two steps each, a validation and evaluation batch that shards): the
  ranks share rank 0's run id and end with bitwise equal parameters, only
  rank 0 logs and writes (the same files as one process), a global batch
  of 3 raises over two ranks (and runs in one process), use_mesh=False
  raises inside the group, and the first
  record's global training loss is within 1e-6 of one process's. Later
  records are not compared: Adam scales rounding-level gradient
  differences up to lr, and the RL reward of a sampled solve is a step
  function of the bf16 costs.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from image_compression_torch.models.unet import GROUPS
from image_compression_torch.parallel import mesh

REPO = pathlib.Path(__file__).resolve().parent.parent

WORKER = r"""
import sys
import numpy as np
import torch
from image_compression_torch.config import Config
from image_compression_torch.models.unet import EdgeUNet, init_random_
from image_compression_torch.ops import prng
from image_compression_torch.ops.targets import create_target_with_mask
from image_compression_torch.parallel import mesh
from image_compression_torch.train import steps

init_method, world, rank, out = sys.argv[1:5]
world, rank = int(world), int(rank)
torch.set_num_threads(1)
if world > 1:
    assert mesh.initialize_distributed(init_method, world, rank,
                                       device="cpu")
assert mesh.world() == ((rank, world) if world > 1 else (0, 1))

cfg = Config()
cfg.image_size = 32
rng = np.random.default_rng(7)
images = rng.random((4, 32, 32, 3)).astype(np.float32)
sizes = rng.uniform(2500.0, 3500.0, 4).astype(np.float32)
rows = mesh.rank_slice(4)
x, s = torch.as_tensor(images[rows]), torch.as_tensor(sizes[rows])

def net():
    return init_random_(EdgeUNet(base=8, dtype=torch.float32), seed=0)

res = {}
state = steps.init_train_state(EdgeUNet(base=8, dtype=torch.float32), cfg)
targets = create_target_with_mask(x, cfg.edge_target)
_, aux, m = steps.make_pretrain_step(cfg, data_parallel=world > 1)(
    state, x, targets)

# the RL optimizer clips the reduced gradients in place: keep them (and the
# global norm the clip saw) as they were before it
clipped = {}
clip = steps.clip_by_global_norm_

def recording_clip(tensors, max_norm):
    tensors = list(tensors)
    clipped["grads"] = [t.clone() for t in tensors]
    clipped["norm"] = clip(tensors, max_norm)
    return clipped["norm"]

steps.clip_by_global_norm_ = recording_clip

def grads(model):
    named = [(k, p.grad) for k, p in model.named_parameters()]
    if clipped:
        named = zip([k for k, g in named if g is not None],
                    clipped.pop("grads"))
    return dict(named)

res["pretrain"] = {"loss": aux["loss"], "correct": aux["sign_correct"],
                   "tp_conn": m.tp_conn,
                   "params": state.model.state_dict(),
                   "grads": grads(state.model)}
for name, sampler, whiten in (("antithetic", "antithetic", False),
                              ("whitened", "single", True)):
    cfg.rl.sampler, cfg.rl.whiten = sampler, whiten
    rl_state = steps.init_rl_state(net(), cfg)
    rl_step = steps.make_rl_step(cfg, data_parallel=world > 1)
    mu, sigma = rl_step.forward(rl_state, x)
    w, rewards = rl_step.solve_reward(prng.prng_key(0), 0, mu, sigma, x, s)
    _, aux = rl_step.update(rl_state, w, x, rewards, mu, sigma)
    res[name] = {"loss": aux["loss"], "reward_mean": aux["reward_mean"],
                 "baseline": aux["baseline"], "rewards": rewards,
                 "w": w, "params": rl_state.model.state_dict(),
                 "grads": grads(rl_state.model),
                 "grad_norm": clipped.pop("norm")}

# the training loops: a global batch of 4 over the ranks, 2 steps of each phase,
# a sharded validation / evaluation batch of 4; only rank 0 writes
import pathlib
from image_compression_torch.train.pretrain import run_pretraining
from image_compression_torch.train.reinforce import run_reinforce
corpus, results = pathlib.Path(sys.argv[5]), pathlib.Path(sys.argv[6])
cfg = Config(dataset_dir=str(corpus / "train"),
             val_dataset_dir=str(corpus / "val"),
             results_dir=str(results / "pre"),
             cache_dir=str(results / "cache"), image_size=32)
cfg.pretrain.batch_size = cfg.rl.batch_size = 4
cfg.pretrain.epochs = cfg.rl.epochs = 1
cfg.rl.eval_every = 1
logs = []
pre, pre_id = run_pretraining(cfg, log=logs.append, device="cpu",
                              model=EdgeUNet(base=8, dtype=torch.float32))
cfg.results_dir = str(results / "rl")
rl, rl_id = run_reinforce(cfg, pre.model.state_dict(), log=logs.append,
                          device="cpu")
res["loops"] = {"pre": pre.model.state_dict(),
                  "rl": rl.model.state_dict(), "ids": [pre_id, rl_id],
                  "steps": [pre.step, rl.step], "logs": len(logs),
                  "baseline": rl.baseline}
cfg.pretrain.batch_size = 3  # does not divide over two ranks
cfg.results_dir = str(results / "uneven")
try:
    run_pretraining(cfg, log=logs.append, device="cpu")
    res["loops"]["uneven"] = "ran"
except ValueError as e:
    res["loops"]["uneven"] = str(e)
if world > 1:  # every rank would write the whole batch's run
    cfg.pretrain.batch_size = 4
    try:
        run_pretraining(cfg, log=logs.append, device="cpu", use_mesh=False)
        res["loops"]["no_mesh"] = "ran"
    except ValueError as e:
        res["loops"]["no_mesh"] = str(e)
torch.save(res, out)
"""


def test_shard_batch_and_replicate():
    m = mesh.make_mesh(["cpu"] * 4)
    assert m.size == 4 and m.axis_name == "data"
    x = torch.arange(8 * 3).reshape(8, 3)
    tree = mesh.shard_batch(m, {"x": x, "y": (x[:, 0],)})
    assert [c.device.type for c in tree["x"]] == ["cpu"] * 4
    assert torch.equal(torch.cat(tree["x"]), x)
    assert [c.tolist() for c in tree["y"][0]] == [[0, 3], [6, 9],
                                                  [12, 15], [18, 21]]
    with pytest.raises(ValueError, match="evenly"):
        mesh.shard_batch(m, x[:6])
    copies = mesh.replicate(m, x)
    assert len(copies) == 4 and all(torch.equal(c, x) for c in copies)


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        assert mesh.make_mesh().devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.make_mesh()


def test_no_group_without_environment(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not mesh.initialize_distributed(device="cpu")
    assert mesh.world() == (0, 1) and not mesh.distributed()
    assert mesh.rank_slice(6) == slice(0, 6)
    t = torch.ones(3)
    mesh.all_reduce_mean_([t])
    assert torch.equal(t, torch.ones(3))


def test_data_parallel_step_needs_a_group():
    from image_compression_torch.config import Config
    from image_compression_torch.train import steps
    assert not mesh.distributed()
    for make in (steps.make_pretrain_step, steps.make_rl_step):
        with pytest.raises(ValueError, match="process group"):
            make(Config(), data_parallel=True)


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"},
                                 {"WORLD_SIZE": "2", "RANK": "0",
                                  "MASTER_ADDR": "localhost"}])
def test_partial_environment_raises(monkeypatch, env):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="partly set"):
        mesh.initialize_distributed(device="cpu")
    with pytest.raises(ValueError, match="world_size and rank"):
        mesh.initialize_distributed("file:///nonexistent", device="cpu")


def _corpus(root):
    import numpy as np

    from image_compression_torch.io import pypng
    from image_compression_torch.utils.pattern_generator import GENERATORS
    rng = np.random.default_rng(0)
    for d, n in (("train", 8), ("val", 4)):
        (root / d).mkdir(parents=True)
        for i in range(n):
            img = GENERATORS["low_frequency"](32, 32, False, rng)
            (root / d / f"{i}.png").write_bytes(pypng.encode(img))


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """(directory, [rank 0, rank 1, one process] results) of one run of the
    worker script in each of the three processes."""
    tmp_path = tmp_path_factory.mktemp("workers")
    return tmp_path, _run_workers(tmp_path)


def _run_workers(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    init = "file://" + str(tmp_path / "rendezvous")
    _corpus(tmp_path / "corpus")
    runs = [(2, 0), (2, 1), (1, 0)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, init, str(w), str(r),
         str(tmp_path / f"out_{w}_{r}.pt"), str(tmp_path / "corpus"),
         str(tmp_path / f"results_{w}")], env=env, cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for w, r in runs]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-3000:]
    return [torch.load(tmp_path / f"out_{w}_{r}.pt", weights_only=True)
            for w, r in runs]


def _records(d):
    (path,) = d.glob("metrics_*.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_two_gloo_ranks_run_the_training_loops(workers):
    tmp_path, (r0, r1, one) = workers
    d0, d1, d = r0["loops"], r1["loops"], one["loops"]
    assert d0["ids"] == d1["ids"] and d0["steps"] == d["steps"] == [2, 2]
    assert d0["logs"] == d["logs"] > 0 and d1["logs"] == 0
    assert "does not divide" in d0["uneven"] and d["uneven"] == "ran"
    assert "use_mesh=False inside a process group" in d0["no_mesh"]
    for phase in ("pre", "rl"):
        assert all(torch.equal(d0[phase][k], d1[phase][k])
                   for k in d[phase]), phase
        pid = d0["ids"][phase == "rl"]
        names = sorted(p.name.replace(pid, "ID") for p in
                       (tmp_path / "results_2" / phase).iterdir())
        want = sorted(p.name.replace(d["ids"][phase == "rl"], "ID") for p in
                      (tmp_path / "results_1" / phase).iterdir())
        assert names == want, (names, want)
    got = _records(tmp_path / "results_2" / "pre")[0]["train_loss"]
    want = _records(tmp_path / "results_1" / "pre")[0]["train_loss"]
    assert abs(got - want) <= 1e-6, (got, want)


def _close(a, b, what):
    diff = float((a.double() - b.double()).abs().max())
    assert diff <= 1e-6, f"{what}: {diff}"


def test_two_gloo_ranks_equal_one_process(workers):
    _, (r0, r1, one) = workers
    for phase in ("pretrain", "antithetic", "whitened"):
        grads = [r0[phase]["grads"], one[phase]["grads"]]
        top = max(float(g.abs().max()) for gs in grads for g in gs.values())
        for k, v in one[phase]["params"].items():
            assert torch.equal(r0[phase]["params"][k],
                               r1[phase]["params"][k]), (phase, k)
            if k.endswith(("conv0.bias", "conv1.bias")) and \
                    v.numel() == GROUPS:
                assert all(float(g[k].abs().max()) <= 1e-5 * top
                           for g in grads), (phase, k)
            else:
                _close(r0[phase]["params"][k], v, f"{phase} {k}")
                # the reduced gradient itself: Adam's step and a clip that
                # binds do not see a constant factor (a sum in place of a
                # mean), the gradient does
                diff = float((grads[0][k] - grads[1][k]).abs().max())
                scale = float(grads[1][k].abs().max())
                assert diff <= 1e-5 * scale, (phase, k, diff, scale)
        assert grads[0].keys() == grads[1].keys(), phase
        _close(r0[phase]["loss"], one[phase]["loss"], f"{phase} loss")
        assert torch.equal(r0[phase]["loss"], r1[phase]["loss"])
    _close(r0["pretrain"]["correct"], one["pretrain"]["correct"], "correct")
    assert int(r0["pretrain"]["tp_conn"]) == int(one["pretrain"]["tp_conn"])
    # rewards in the global batch's order: the antithetic w+ rows of both
    # ranks, then their w- rows
    anti = [r["antithetic"]["rewards"] for r in (r0, r1)]
    _close(torch.cat([anti[0][:2], anti[1][:2], anti[0][2:], anti[1][2:]]),
           one["antithetic"]["rewards"], "antithetic rewards")
    _close(torch.cat([r0["antithetic"]["w"][:2], r1["antithetic"]["w"][:2]]),
           one["antithetic"]["w"][:4], "antithetic noise")
    _close(torch.cat([r0["whitened"]["rewards"], r1["whitened"]["rewards"]]),
           one["whitened"]["rewards"], "whitened rewards")
    for phase in ("antithetic", "whitened"):
        for k in ("reward_mean", "baseline"):
            _close(r0[phase][k], one[phase][k], f"{phase} {k}")
        got, want = r0[phase]["grad_norm"], one[phase]["grad_norm"]
        assert abs(float(got) - float(want)) <= 1e-5 * float(want), (
            phase, float(got), float(want))
