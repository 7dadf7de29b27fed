"""A whole run at a small size on the CPU (the look for a card skipped),
with the timed path broken underneath: `correct` must come out false for
each fault the cell can have. The sound run beside them comes out true."""

import pytest
import torch

from portbench.tests import tiny


def test_sound_compress_run_is_correct():
    assert tiny.run("flagship.mixed1024")["correct"]


def _costs_altered(mp):
    from image_compression_torch.models.unet import EdgeUNet
    orig = EdgeUNet.forward
    mp.setattr(EdgeUNet, "forward", lambda self, x: -orig(self, x))


def _answer_altered(mp):
    from image_compression_torch import pipeline
    orig = pipeline.merge_refine_batch

    def split(images, labels, **k):
        out = orig(images, labels, **k)
        w = out.shape[-1]
        cols = torch.arange(w, device=out.device)
        return torch.where(cols < w // 2, out, out + 10 ** 6)
    mp.setattr(pipeline, "merge_refine_batch", split)


def _solver_altered(mp):
    from image_compression_torch import pipeline
    orig = pipeline.segment_batch

    def split(costs, *a, **k):  # every image cut down the middle
        out = orig(costs, *a, **k)
        w = out.shape[-1]
        cols = torch.arange(w, device=out.device)
        return torch.where(cols < w // 2, out, out + 10 ** 6)
    mp.setattr(pipeline, "segment_batch", split)


def _output_expanded(mp):
    from image_compression_torch import pipeline
    orig = pipeline._write_batch

    def grow(*a, **k):  # a padded record, the pixels intact
        dirs = orig(*a, **k)
        for d in dirs:
            with open(d / "metadata.bin", "ab") as f:
                f.write(bytes(64 << 10))
        return dirs
    mp.setattr(pipeline, "_write_batch", grow)


def _half_batch_left_out(mp):
    from image_compression_torch import pipeline
    orig = pipeline._write_batch

    def half(images, wire, cfg, results_dir, names, src_paths=None):
        keep = len(names) // 2
        names = names[:keep] + [None] * (len(names) - keep)
        return orig(images, wire, cfg, results_dir, names, src_paths)
    mp.setattr(pipeline, "_write_batch", half)


def _pixel_altered(mp):
    from image_compression_torch import pipeline
    from portbench import pngcodec
    orig = pipeline._write_batch

    def flip(*a, **k):
        dirs = orig(*a, **k)
        for d in dirs:  # one pixel of each image's first slice
            name = sorted(d.glob("slice_*.png"))[0]
            px = pngcodec.decode(name.read_bytes())
            px[0, 0, 0] ^= 1
            name.write_bytes(pngcodec.encode(px, 4))
        return dirs
    mp.setattr(pipeline, "_write_batch", flip)


@pytest.mark.parametrize("fault", [_costs_altered, _answer_altered,
                                   _solver_altered, _output_expanded,
                                   _half_batch_left_out, _pixel_altered])
def test_compress_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not tiny.run("flagship.mixed1024")["correct"]


def test_sound_rl_run_is_correct():
    assert tiny.run("rl_r4.mixed256")["correct"]


def _state_unchanged(mp):
    from image_compression_torch.train import steps
    mp.setattr(steps.OptaxAdam, "step", lambda self, closure=None: None)


def _half_batch_mean(mp):
    from image_compression_torch.train import steps
    orig = steps.rl_loss

    def half(model, images, w, adv, cfg):
        b = images.shape[0]
        rows = torch.cat([torch.arange(b // 2), b + torch.arange(b // 2)])
        return orig(model, images[:b // 2], w[rows], adv[rows], cfg)
    mp.setattr(steps, "rl_loss", half)


def _reward_altered(mp):
    from image_compression_torch.train import steps
    orig = steps.compute_rewards_batched

    def bump(*a, **k):
        r = orig(*a, **k).clone()
        r[0] += 0.5
        return r
    mp.setattr(steps, "compute_rewards_batched", bump)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_mean,
                                   _reward_altered])
def test_rl_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not tiny.run("rl_r4.mixed256")["correct"]
