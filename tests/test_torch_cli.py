"""Entry points of the PyTorch port: device resolution, the solver
configuration check, compress_directory's passthrough, and the CLI."""

import json

import numpy as np
import pytest
import torch

from image_compression_torch.cli.main import main as cli_main
from image_compression_torch.config import Config
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


@pytest.mark.parametrize("kw", [dict(mode="random_mate"),
                                dict(icm_sweeps=8), dict(hier_agg="pixel")])
def test_unported_solver_settings_raise(kw):
    with pytest.raises(NotImplementedError):
        segment_batch(torch.zeros((1, 32, 32, 2)), **kw)


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
