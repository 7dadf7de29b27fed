"""CUDA kernels of the PyTorch port against their plain versions, and the
device paths (solver, classical extractors, classical compress) against
the CPU, on the card. Every test here needs a CUDA GPU and skips without
one. This file
imports no JAX, so it runs on a machine without the reference's
dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from image_compression_torch.config import Config, EdgeTarget
from image_compression_torch.ops import multicut_leaf as leaf
from image_compression_torch.ops.multicut import multicut_grid
from image_compression_torch.utils.profiling import counters

pytestmark = pytest.mark.cuda


def launches() -> int:
    """The leaf kernel's launches in this process so far."""
    return counters().get("leaf.launches", 0)


def norm_launches() -> int:
    """The GroupNorm + ReLU kernel's launches in this process so far."""
    return counters().get("group_norm_relu.launches", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda")


def _costs(kind, shape=(2, 64, 64)):
    rng = np.random.default_rng(3)
    if kind == "heavy":
        return (-np.abs(rng.normal(size=shape + (2,))) - 0.1).astype(
            np.float32)
    return rng.integers(-8, 9, size=shape + (2,)).astype(np.float32)


@pytest.mark.parametrize("kind,s1,shape", [
    ("int", 64, (2, 64, 64)), ("int", 128, (2, 64, 64)),
    ("heavy", 64, (2, 64, 64)), ("int", 64, (3, 48, 48))])
def test_leaf_kernel_matches_plain(cuda, kind, s1, shape):
    """Every output bitwise equal to the plain version on integer costs and
    the heavy-freezing recipe, also on a ragged batch (3 x 48x48: 27
    supertiles); one launch counted per call."""
    args = (*leaf.leaf_inputs(torch.as_tensor(_costs(kind, shape),
                                              device=cuda)),
            s1, 2, 1, shape[1] * shape[2])
    before = launches()
    got = leaf.leaf_cuda(*args)
    assert launches() == before + 1
    for g, w in zip(got, leaf.leaf_plain(*args)):
        assert g.shape == w.shape and torch.equal(g, w)


def test_leaf_kernel_rejects_bad_inputs(cuda):
    w0h, w0v, wmid, pix = leaf.leaf_inputs(
        torch.as_tensor(_costs("int"), device=cuda))
    with pytest.raises(ValueError, match="f32"):
        leaf.leaf_cuda(w0h.double(), w0v, wmid, pix, 64, 2, 1, 64 * 64)
    with pytest.raises(ValueError, match="s1"):
        leaf.leaf_cuda(w0h, w0v, wmid, pix, 256, 2, 1, 64 * 64)


def test_leaf_kernel_repeats_on_real_costs(cuda):
    """No float atomics: two launches on real-valued costs agree bit for
    bit."""
    rng = np.random.default_rng(4)
    costs = torch.as_tensor(rng.normal(size=(2, 64, 64, 2)).astype(
        np.float32), device=cuda)
    args = (*leaf.leaf_inputs(costs), 64, 2, 1, 64 * 64)
    for a, b in zip(leaf.leaf_cuda(*args), leaf.leaf_cuda(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 96, 160)])
def test_solver_on_card_equals_cpu(cuda, shape):
    """multicut_grid through the kernel gives the CPU plain path's labels,
    also where sorted rounds finish a non-square image."""
    costs = torch.as_tensor(_costs("int", shape))
    kw = dict(hier_rounds=(2, 1), hier_caps="flat64")
    before = launches()
    on_card = multicut_grid(costs.to(cuda), **kw)
    assert launches() == before + 1
    assert torch.equal(on_card.cpu(), multicut_grid(costs, **kw))


def test_solver_repeats_on_real_costs(cuda):
    """The sorted finishing rounds sum pair costs in a fixed order: two
    solves of real-valued costs on a non-square batch give the same
    labels."""
    costs = torch.as_tensor(np.random.default_rng(5).normal(
        size=(2, 96, 160, 2)).astype(np.float32), device=cuda)
    kw = dict(hier_rounds=(2, 1), hier_caps="flat64")
    assert torch.equal(multicut_grid(costs, **kw), multicut_grid(costs, **kw))


@pytest.mark.parametrize("shape,kw", [
    ((4, 12, 12), {}), ((2, 8, 40), {}),
    ((2, 64, 64), dict(mode="random_mate", icm_sweeps=8, hier_agg="pixel")),
    ((2, 64, 64), dict(mode="mutual")), ((2, 64, 64), dict(mode="hybrid")),
    ((2, 48, 80), dict(mode="random_mate", hier_agg="matrix"))])
def test_solver_configurations_on_card_equal_cpu(cuda, shape, kw):
    """The tiny-grid ensemble, ICM, pixel aggregation, the sorted path's
    modes with the tile presolve and the random-mate hierarchy give the
    CPU's labels on integer costs."""
    costs = torch.as_tensor(_costs("int", shape))
    assert torch.equal(multicut_grid(costs.to(cuda), **kw).cpu(),
                       multicut_grid(costs, **kw))


def test_coin_bits_on_card_equal_cpu(cuda):
    from image_compression_torch.ops import prng
    for salt in (0, 50_003, 2 ** 31 - 1):
        key = prng.fold_in(prng.prng_key(2), salt)
        assert torch.equal(prng.random_bits(key, (77, 256), cuda).cpu(),
                           prng.random_bits(key, (77, 256)))


def _photo_like(n, h, w, seed):
    """Blocks of colour under mild noise, with a noisy patch, in [0, 1]."""
    rng = np.random.default_rng(seed)
    img = np.repeat(np.repeat(rng.random((n, h // 16, w // 16, 3)), 16, 1),
                    16, 2)
    img = img + 0.03 * rng.standard_normal(img.shape)
    img[:, -h // 4:, -w // 4:] = rng.random((n, h // 4, w // 4, 3))
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.mark.parametrize("target", list(EdgeTarget))
def test_extractors_on_card_equal_cpu(cuda, target):
    """Canny and watershed costs bitwise; graph and SLIC costs on >= 99%
    of entries (their float sums may round apart without margin)."""
    from image_compression_torch.ops.targets import compute_edge_costs
    x = torch.as_tensor(_photo_like(2, 64, 96, seed=4))
    got = compute_edge_costs(x.to(cuda), target).cpu()
    want = compute_edge_costs(x, target)
    if target in (EdgeTarget.CANNY, EdgeTarget.WATERSHED):
        assert torch.equal(got, want)
    else:
        assert (got == want).float().mean() >= 0.99


@pytest.mark.parametrize("target", [EdgeTarget.CANNY, EdgeTarget.GRAPH])
def test_classical_compress_on_card_equals_cpu(cuda, tmp_path, target):
    """compress_directory with classical costs over 3 batches (device and
    host overlapped) writes the CPU's bytes, losslessly."""
    from image_compression_torch.io import pypng
    from image_compression_torch.io.image_io import ensure_rgba, load_image
    from image_compression_torch.io.reassemble import reassemble_array
    from image_compression_torch.pipeline import compress_directory
    data = tmp_path / "data"
    data.mkdir()
    for i, img in enumerate(_photo_like(5, 64, 64, seed=5)):
        (data / f"im{i}.png").write_bytes(pypng.encode(
            (img * 255).astype(np.uint8)))
    outs = {}
    for dev in ("cpu", "cuda"):
        cfg = Config(dataset_dir=str(data), results_dir=str(tmp_path / dev))
        outs[dev] = compress_directory(cfg, classical=target, batch_size=2,
                                       device=dev)
    for c, g in zip(outs["cpu"], outs["cuda"]):
        names = sorted(p.name for p in c.iterdir())
        assert names == sorted(p.name for p in g.iterdir())
        for name in names:
            assert (c / name).read_bytes() == (g / name).read_bytes()
        src = load_image(data / f"{g.name}.png")
        np.testing.assert_array_equal(reassemble_array(g), ensure_rgba(src))


def _rl_cfg():
    cfg = Config()
    cfg.rl.sampler, cfg.rl.whiten = "antithetic", False
    cfg.reward.fallback_aware = True
    cfg.reward.max_segments = 16
    return cfg


def test_training_steps_on_card(cuda):
    """A few pretrain steps lower the loss of their batch (bf16 U-Net, f32
    parameters); RL steps give finite rewards, set the baseline, change
    the params and launch the leaf kernel each step."""
    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.ops import prng
    from image_compression_torch.ops.targets import create_target_with_mask
    from image_compression_torch.train import steps
    cfg = _rl_cfg()
    x = torch.as_tensor(_photo_like(2, 64, 64, seed=6), device=cuda)
    targets = create_target_with_mask(x, EdgeTarget.GRAPH)
    state = steps.init_train_state(EdgeUNet(base=8), cfg, 0, cuda)
    step = steps.make_pretrain_step(cfg)
    first = float(step(state, x, targets)[1]["loss"])
    for _ in range(3):
        step(state, x, targets)
    after = float(steps.make_pretrain_eval(cfg)(state.model, x,
                                                targets)[0]["loss"])
    assert np.isfinite(first) and after < first

    rl = steps.init_rl_state(state.model, cfg)
    before = {k: v.clone() for k, v in rl.model.state_dict().items()}
    rl_step = steps.make_rl_step(cfg)
    sizes = torch.full((2,), 9000.0, device=cuda)
    for _ in range(2):
        n0 = launches()
        _, aux = rl_step(rl, prng.prng_key(0), x, sizes)
        assert launches() > n0
        assert np.isfinite(float(aux["reward_mean"]))
    assert rl.step == 2 and bool(rl.baseline_init)
    assert any(not torch.equal(v, before[k])
               for k, v in rl.model.state_dict().items())


def test_rl_solve_and_reward_on_card_equal_cpu(cuda):
    """Sampled costs rounded to 1/16 (exact in every sum): the RL solve's
    labels equal the CPU's bitwise, the rewards within 1e-5."""
    from image_compression_torch.ops import prng
    from image_compression_torch.train import steps
    from image_compression_torch.train.policy import sample_antithetic_policy
    cfg = _rl_cfg()
    x = torch.as_tensor(_photo_like(2, 64, 64, seed=7))
    rng = np.random.default_rng(8)
    e = 2 * 64 * 63
    mu = torch.as_tensor(rng.normal(0.5, 1.0, (2, e)).astype(np.float32))
    sigma = torch.full((2, e), 0.5)
    w = sample_antithetic_policy(prng.prng_key(3), mu, sigma).w
    q = torch.round(w * 16) / 16
    x2 = torch.cat([x, x])
    sizes = torch.tensor([9000.0, 7000.0, 9000.0, 7000.0])
    lab_c, rew_c = steps.solve_and_reward(q, x2, sizes, cfg)
    lab_g, rew_g = steps.solve_and_reward(q.to(cuda), x2.to(cuda),
                                          sizes.to(cuda), cfg)
    assert torch.equal(lab_g.cpu(), lab_c)
    assert torch.allclose(rew_g.cpu(), rew_c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("agg", ["matrix", "pixel"])
def test_spatial_solve_on_card_equals_unsharded(cuda, agg):
    """The spatially sharded solve over four strips on one card
    (Mesh([cuda:0] * 4)) gives the unsharded solve's labels bit for bit;
    with matrix aggregation the strips launch the leaf kernel, with pixel
    aggregation nothing does."""
    from image_compression_torch.parallel.mesh import make_mesh
    from image_compression_torch.parallel.spatial import (
        multicut_grid_spatial)
    rng = np.random.default_rng(12)
    costs = torch.as_tensor(rng.normal(0.3, 1.0, (256, 256, 2)).astype(
        np.float32), device=cuda)
    want = multicut_grid(costs[None], icm_sweeps=0, hier_agg=agg)[0]
    n0 = launches()
    got = multicut_grid_spatial(costs, make_mesh([cuda] * 4), agg=agg)
    assert (launches() > n0) == (agg == "matrix")
    assert torch.equal(got, want)


def _flagship_model(device):
    import pathlib

    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.train.checkpoint import load_params
    params = load_params(pathlib.Path(__file__).resolve().parents[1]
                         / "image_compression_torch" / "weights"
                         / "fcn_pretrained_r4_mixed.pt")
    model = EdgeUNet(base=params["inc.conv0.weight"].shape[0])
    model.load_state_dict(params)
    return model.to(device)


def test_flagship_compress_on_card_is_lossless(cuda, tmp_path):
    """The trained flagship (the weights file, bf16) compresses 8 images of
    the mixed corpus at 256x256 losslessly, launching the leaf kernel, and
    no output is larger than its original plus a one-slice record."""
    from image_compression_torch.io.image_io import (ensure_rgba,
                                                     load_image, write_image)
    from image_compression_torch.io.reassemble import reassemble_array
    from image_compression_torch.pipeline import compress_directory
    from image_compression_torch.utils.pattern_generator import mixed_corpus
    model = _flagship_model(cuda)
    data = tmp_path / "data"
    data.mkdir()
    for stem, img in mixed_corpus(8, 256):
        write_image(data / f"{stem}.png", img, 6)
    n0 = launches()
    outs = compress_directory(Config(dataset_dir=str(data),
                                     results_dir=str(tmp_path / "out")),
                              model, device="cuda")
    assert launches() > n0 and len(outs) == 8
    for out in outs:
        src = data / f"{out.name}.png"
        np.testing.assert_array_equal(reassemble_array(out),
                                      ensure_rgba(load_image(src)))
        size = sum(p.stat().st_size for p in out.iterdir())
        assert size <= src.stat().st_size + 49, out.name


def _every_value(depth, channels):
    """A square image holding every value of the integer `depth` in each
    channel, each channel's values shifted against the last's; 2-D where
    `channels` is 0."""
    n = np.iinfo(depth).max + 1
    side = int(np.sqrt(n))
    values = np.arange(n, dtype=depth).reshape(side, side)
    if not channels:
        return values
    return np.stack([np.roll(values, 7 * k) for k in range(channels)], axis=2)


def test_float01_batch_on_card_equals_host_division(cuda):
    """The compress batch made float32 on the card (integer pixels uploaded
    from page-locked memory, then the depth's table gathered) is bit for
    bit the host's to_float01_rgb on every 8- and 16-bit value, for each
    channel layout and a batch mixing depths. The batches are built back
    to back and compared only after the last, so a page-locked buffer
    reused before its upload ended would show."""
    from image_compression_torch.io.image_io import to_float01_rgb
    from image_compression_torch.pipeline import _float01_batch
    every8 = [np.tile(_every_value(np.uint8, c), (16, 16, 1))
              if c else np.tile(_every_value(np.uint8, 0), (16, 16))
              for c in (0, 1, 3, 4)]
    every16 = [_every_value(np.uint16, c) for c in (0, 1, 3, 4)]
    batches = [every8, every16, every8[::-1], [every8[2], every16[2],
                                               every8[3], every16[1]]]
    got = [_float01_batch(images, cuda) for images in batches]
    for images, g in zip(batches, got):
        want = torch.as_tensor(np.stack([to_float01_rgb(im)
                                         for im in images]))
        assert g.device.type == cuda.type and g.dtype == torch.float32
        assert torch.equal(g.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n,height,width", [(8, 256, 256), (8, 1024, 1024),
                                            (1, 37, 53)])
def test_group_norm_relu_matches_chain_at_every_site(cuda, monkeypatch, n,
                                                     height, width):
    """At each of the flagship U-Net's 14 norm sites, on its activations of
    mixed-corpus images, with the trained and with random gamma and beta,
    the kernel's output is the chain's except on at most 0.1% of the
    elements, and there by at most 1 bf16 ulp of the affine step's terms
    (group_norm_relu.distance: an output that cancels to near 0 moves by
    more of its own ulps); its mean and rstd are within 1e-5 of a float64
    computation (the mean relative to the row's root mean square, the
    scale its sum is rounded at). 37 x 53 runs planes whose sizes are not
    multiples of 8."""
    from image_compression_torch.io.image_io import to_float01_rgb
    from image_compression_torch.models import unet
    from image_compression_torch.ops import group_norm_relu as gnr
    from image_compression_torch.utils.pattern_generator import mixed_corpus
    side = max(height, width)
    images = np.stack([to_float01_rgb(img)[:height, :width]
                       for _, img in mixed_corpus(n, side if side >= 64
                                                  else 64)])
    gen = torch.Generator(device=cuda).manual_seed(9)
    seen = []

    def check(x, weight, bias, groups, eps):
        want = gnr.group_norm_relu_plain(x, weight, bias, groups, eps)
        x = x.contiguous()  # the first site's input is channels_last here
        c = x.shape[1]
        rand = (torch.randn(c, generator=gen, device=cuda),
                torch.randn(c, generator=gen, device=cuda))
        xd = x.double().reshape(x.shape[0], groups, -1)
        mean64 = xd.mean(-1)
        var64 = xd.var(-1, unbiased=False)
        rstd64 = (var64 + eps).rsqrt()
        rms64 = (mean64 ** 2 + var64).sqrt()
        for w, b in ((weight, bias), rand):
            y, mean, rstd = gnr.group_norm_relu_cuda(x, w, b, groups, eps)
            ulps, scaled = gnr.distance(
                y, gnr.group_norm_relu_plain(x, w, b, groups, eps), x, w, b,
                mean, rstd)
            seen.append((tuple(x.shape), float(scaled.max()),
                         float((ulps > 0).double().mean()),
                         float(((mean.double() - mean64).abs()
                                / rms64).max()),
                         float(((rstd.double() - rstd64).abs()
                                / rstd64).max())))
        return want

    monkeypatch.setattr(unet, "group_norm_relu_plain", check)
    with torch.no_grad():
        _flagship_model(cuda)(torch.as_tensor(images, device=cuda))
    assert len(seen) == 2 * 14
    for shape, term_ulps, share, mean_err, rstd_err in seen:
        assert term_ulps <= 1 and share <= 1e-3, (shape, term_ulps, share)
        assert mean_err <= 1e-5 and rstd_err <= 1e-5, (shape, mean_err,
                                                       rstd_err)


def test_group_norm_relu_launches(cuda):
    """14 launches a compress forward (bf16, inference mode); none in an RL
    step, whose forwards run under no_grad and with grad."""
    from image_compression_torch.models.unet import EdgeUNet, init_random_
    from image_compression_torch.ops import prng
    from image_compression_torch.pipeline import learned_costs
    from image_compression_torch.train import steps
    model = init_random_(EdgeUNet(base=8), seed=1).to(cuda)
    x = torch.as_tensor(_photo_like(2, 64, 64, seed=10), device=cuda)
    n0 = norm_launches()
    with torch.inference_mode():
        learned_costs(model, x)
    assert norm_launches() == n0 + 14
    rl = steps.init_rl_state(model, _rl_cfg())
    n0 = norm_launches()
    steps.make_rl_step(_rl_cfg())(rl, prng.prng_key(0), x,
                                  torch.full((2,), 9000.0, device=cuda))
    assert norm_launches() == n0


def test_group_norm_relu_rejects_bad_inputs(cuda):
    from image_compression_torch.ops.group_norm_relu import (
        group_norm_relu_cuda)
    x = torch.randn((2, 16, 8, 8), device=cuda).to(torch.bfloat16)
    w = torch.ones(16, device=cuda)
    b = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        group_norm_relu_cuda(x.float(), w, b, 8, 1e-6)
    with pytest.raises(ValueError, match="groups"):
        group_norm_relu_cuda(x[:, :12].contiguous(), w[:12], b[:12], 8, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm_relu_cuda(x.to(memory_format=torch.channels_last), w, b,
                             8, 1e-6)
    with pytest.raises(ValueError, match="weight"):
        group_norm_relu_cuda(x, w.to(torch.bfloat16), b, 8, 1e-6)
