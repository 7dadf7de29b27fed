"""Entry points of the PyTorch port: device resolution, the solver
configuration check, compress_directory's passthrough, and the CLI, with a
checkpoint and without one (classical costs, canny by default)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from image_compression_torch.cli.main import main as cli_main
from image_compression_torch.config import Config, EdgeTarget
from image_compression_torch.device import resolve_device
from image_compression_torch.io import pypng
from image_compression_torch.io.image_io import ensure_rgba, load_image
from image_compression_torch.io.reassemble import reassemble_array
from image_compression_torch.models.unet import EdgeUNet, init_random_
from image_compression_torch.pipeline import (compress_arrays,
                                              compress_directory,
                                              segment_batch)

torch.set_num_threads(1)


def test_cuda_is_the_default_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        compress_arrays([img], lambda b: b[..., :2], Config(), tmp_path,
                        ["im"])
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw", [dict(mode="random"),
                                dict(hier_leaf="pallas"), dict(hier_agg="dense")])
def test_unported_solver_settings_raise(kw):
    """Every solver setting of the reference is ported; values it rejects
    raise ValueError here too, nothing falls back quietly."""
    with pytest.raises(ValueError):
        segment_batch(torch.zeros((1, 32, 32, 2)), **kw)


@pytest.mark.parametrize("kw", [dict(mode="random_mate"), dict(icm_sweeps=8),
                                dict(hier_agg="pixel"), dict(mode="mutual"),
                                dict(mode="hybrid", matchings_per_round=2),
                                dict(hier_leaf="xla")])
def test_reference_solver_settings_accepted(kw):
    """The settings a compress config may name run and give minlabel-shaped
    labels of the input's shape."""
    costs = torch.as_tensor(np.random.default_rng(0).integers(
        -4, 5, (1, 32, 32, 2)).astype(np.float32))
    labels = segment_batch(costs, **kw)
    assert labels.shape == (1, 32, 32) and labels.dtype == torch.int32
    flat = torch.arange(32 * 32, dtype=torch.int32).reshape(1, 32, 32)
    assert bool((labels >= 0).all()) and bool((labels < 32 * 32).all())
    if kw.get("mode") not in ("mutual", "hybrid"):  # the hierarchy: minlabel
        assert bool((labels <= flat).all())


def test_compress_directory_passthrough(tmp_path):
    """A fallen-back image copies its source PNG verbatim as slice_0.png."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    data = tmp_path / "data"
    data.mkdir()
    (data / "noise.png").write_bytes(pypng.encode(img))
    cfg = Config(dataset_dir=str(data), results_dir=str(tmp_path / "out"))
    model = init_random_(EdgeUNet(base=8), seed=0)
    dirs = compress_directory(cfg, model, batch_size=1, device="cpu")
    assert (dirs[0] / "slice_0.png").read_bytes() == \
        (data / "noise.png").read_bytes()
    np.testing.assert_array_equal(reassemble_array(dirs[0]), ensure_rgba(img))


def test_cli_compress_and_reassemble(tmp_path, capsys):
    rng = np.random.default_rng(1)
    img = np.zeros((32, 32, 3), np.uint8)
    img[:, 16:] = rng.integers(0, 256, (32, 16, 3))
    data = tmp_path / "data"
    data.mkdir()
    (data / "im.png").write_bytes(pypng.encode(img))
    ckpt = tmp_path / "unet.pt"
    torch.save(init_random_(EdgeUNet(), seed=0).state_dict(), ckpt)
    cli_main(["compress", "--dataset-dir", str(data), "--results-dir",
              str(tmp_path / "out"), "--checkpoint", str(ckpt), "--device",
              "cpu", "--no-fallback"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (slice_dir,) = out["compressed"]
    cli_main(["reassemble", slice_dir, "-o", str(tmp_path / "rec.png")])
    np.testing.assert_array_equal(load_image(tmp_path / "rec.png"),
                                  ensure_rgba(img))


def _dataset(tmp_path):
    """Two 32x32 images with flat, textured and noisy parts."""
    rng = np.random.default_rng(2)
    data = tmp_path / "data"
    data.mkdir()
    images = []
    for i in range(2):
        img = np.full((32, 32, 3), 40 + 100 * i, np.uint8)
        img[6:22, 8:26] = (220, 30 * i, 90)
        img[22:, :12] = rng.integers(0, 256, (10, 12, 3))
        (data / f"im{i}.png").write_bytes(pypng.encode(img))
        images.append(img)
    return data, images


def test_cli_compress_without_checkpoint_is_canny(tmp_path, capsys):
    """No --checkpoint and no --classical: canny costs, as the reference;
    the outputs are those of compress_directory(classical=CANNY)."""
    data, images = _dataset(tmp_path)
    cli_main(["compress", "--dataset-dir", str(data), "--results-dir",
              str(tmp_path / "cli"), "--device", "cpu", "--no-fallback"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = Config(dataset_dir=str(data), results_dir=str(tmp_path / "api"),
                 compress_fallback=False)
    want = compress_directory(cfg, classical=EdgeTarget.CANNY, device="cpu")
    got = [pathlib.Path(d) for d in out["compressed"]]
    assert [d.name for d in got] == [d.name for d in want]
    for g, w, img in zip(got, want, images):
        names = sorted(p.name for p in w.iterdir())
        assert len(names) > 2  # sliced
        assert names == sorted(p.name for p in g.iterdir())
        for name in names:
            assert (g / name).read_bytes() == (w / name).read_bytes()
        np.testing.assert_array_equal(reassemble_array(g), ensure_rgba(img))


@pytest.mark.parametrize("extractor", ["graph", "slic", "watershed"])
@pytest.mark.parametrize("pack", [False, True])
def test_cli_classical_compress_reassembles(tmp_path, capsys, extractor,
                                            pack):
    data, images = _dataset(tmp_path)
    cli_main(["compress", "--dataset-dir", str(data), "--results-dir",
              str(tmp_path / "out"), "--device", "cpu", "--classical",
              extractor] + (["--pack"] if pack else []))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["compressed"]) == 2
    for k, (path, img) in enumerate(zip(out["compressed"], images)):
        assert path.endswith(f"im{k}.pack" if pack else f"im{k}")
        rec = tmp_path / f"rec{k}.png"
        cli_main(["reassemble", path, "-o", str(rec)])
        np.testing.assert_array_equal(load_image(rec), ensure_rgba(img))
