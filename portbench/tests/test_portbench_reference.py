"""The plain reference: its reader of the program's slice directories, and
its pipeline and RL steps against the program's own float32 path at this
commit (the frozen copies must compute what the program computes)."""

import copy

import numpy as np
import pytest
import torch

from portbench.reference import compress as refc
from portbench.reference import rl as refrl
from portbench.tests import tiny
from portbench.traffic import generator


def _labels(h, w):
    lab = np.zeros((h, w), np.int64)
    lab[:, w // 2:] = 1
    lab[h // 3:, : w // 3] = 2
    lab[0, 0] = 3
    return lab


@pytest.mark.parametrize("native", [True, False])
def test_reads_port_written_slices(tmp_path, native):
    from image_compression_torch.io import native as nat
    from image_compression_torch.io.slicer import write_slices
    if native and not nat.available():
        pytest.skip("the native writer is not built here")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)
    lab = _labels(24, 40)
    write_slices(img, lab, tmp_path, "im", use_native=native)
    region, lossless = refc.read_output(tmp_path / "im", img)
    assert lossless
    for a, b in zip(refc.same_region(region), refc.same_region(lab)):
        assert np.array_equal(a, b)
    bad = img.copy()
    bad[5, 5, 1] ^= 1
    assert not refc.read_output(tmp_path / "im", bad)[1]
    assert refc.read_output(tmp_path / "missing", img) == (None, False)


def test_reads_a_passthrough(tmp_path):
    from image_compression_torch.pipeline import write_passthrough
    from portbench import pngcodec
    img = np.full((16, 16, 3), 7, np.uint8)
    src = tmp_path / "src.png"
    src.write_bytes(pngcodec.encode(img, 6))
    write_passthrough(src, (16, 16), tmp_path / "out", "im")
    region, lossless = refc.read_output(tmp_path / "out" / "im", img)
    assert lossless and (region == 0).all()


def _f32_spec(cell, size=32):
    spec = tiny.spec(cell, size=size)
    spec["config"] = copy.deepcopy(spec["config"])
    spec["config"]["model"]["conv_dtype"] = "float32"
    return spec


@pytest.mark.parametrize("fallback", [True, False])
def test_reference_pipeline_is_the_programs_float32_path(tmp_path,
                                                          fallback):
    from image_compression_torch import pipeline
    from image_compression_torch.config import Config
    from portbench.drivers.compress import load_model
    spec = _f32_spec("flagship.mixed1024", size=64)
    # at this size every image falls back; without the fallback the
    # solver's cuts reach merge refinement
    spec["config"]["settings"]["compress_fallback"] = fallback
    corpus = generator.make(spec["traffic"], 21, tmp_path)
    imgs = np.stack([r["image"] for r in corpus.values()])
    sizes = [r["png_bytes"] for r in corpus.values()]
    model = load_model(spec["config"], "cpu").eval()
    cfg = Config.from_dict(spec["config"]["settings"])
    with torch.inference_mode():
        want = pipeline._device_labels(
            list(imgs), lambda b: pipeline.learned_costs(model, b), cfg,
            torch.device("cpu"), orig_sizes=sizes)
        costs = pipeline.learned_costs(
            model, torch.as_tensor(imgs).float() / 255)
    sd = refc.load_weights(spec["config"], "cpu")
    got_costs = refc.reference_costs(sd, imgs, "cpu")
    assert torch.allclose(got_costs, costs, atol=1e-5)
    got = refc.reference_labels(imgs, costs, sizes,
                                spec["config"]["settings"])
    assert torch.equal(got, want)
    assert fallback or sum(len(torch.unique(g)) > 1 for g in got) >= 2


def test_reference_rl_steps_are_the_programs_float32_steps(tmp_path):
    from portbench.drivers import rl as driver
    spec = _f32_spec("rl_r4.mixed256")
    run = driver.Run(spec, 23, "cpu", tmp_path)
    run.setup()
    run.window(0)  # the window's own first steps are the ones checked
    run.feed.close()
    want = refrl.reference_steps(spec, run.corpus, 23, "cpu",
                                 follow=run.got["w"])
    g = refrl.gaps(run.got, want, refc.load_weights(spec["config"], "cpu"))
    assert g["sample_gap"] < 1e-5 and g["reward_gap"] == 0.0
    assert g["grad_gap"] < 1e-4
    assert g["change_gap"] < 1e-4
