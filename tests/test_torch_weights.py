"""The flagship's trained weights in the port, held to the JAX package.

`image_compression_torch/weights/fcn_pretrained_r4_mixed.pt` is the
EdgeUNet state_dict (f32) of the orbax checkpoint
`artifacts/fcn_pretrained_r4_mixed_params`, converted with
`models/convert.state_dict_from_flax`. The orbax tree is read here with CPU
restore arguments: the JAX package's own `load_params` raises off the TPU,
because the checkpoint's sharding file names the TPU that wrote it.
`image_compression_torch/weights/flagship_mixed_reference.json` records the
JAX package's compress of the first images of the mixed corpus (made by the
port's generators, PNGs by the port's encoder at level 6) with those
weights, at the shipped settings with hier_agg="matrix", in bf16 and f32
(and the shipped pixel aggregation in bf16, for context); `chip_smoke.py`
holds the port's run on the card against it.

Both files are written by this module:

    python tests/test_torch_weights.py <orbax dir> <out.pt>
    python tests/test_torch_weights.py --record <out.json>

Tolerances: the flagship U-Net (base 64) in f32 is held within 5e-5 x max
|reference output|. test_torch_unet.py holds base 8 within 1e-5; at base 64
the convolutions sum up to 9 x 512 products per output, and oneDNN and XLA
sum them in their own orders (which depend on the CPU's vector width): on
these inputs the difference measured 1.92e-5 x max (at 1, 2, 4 and 8 torch
threads alike), and the bound leaves 2.6x room for other CPUs. Compress
is compared on the JAX f32 costs rounded to 1/16, where every sum is exact
and the solver is bitwise between the frameworks.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import pathlib
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from image_compression_tpu import pipeline as jp  # noqa: E402
from image_compression_tpu.config import Config as JConfig  # noqa: E402
from image_compression_tpu.io import native as jnative  # noqa: E402
from image_compression_tpu.models.unet import EdgeUNet as JUNet  # noqa: E402
from image_compression_torch import pipeline as tp  # noqa: E402
from image_compression_torch.config import Config  # noqa: E402
from image_compression_torch.io import native as tnative  # noqa: E402
from image_compression_torch.io.image_io import (ensure_rgba,  # noqa: E402
                                                 load_image, write_image)
from image_compression_torch.io.reassemble import (  # noqa: E402
    output_record, reassemble_array)
from image_compression_torch.models.convert import (  # noqa: E402
    flax_from_state_dict, state_dict_from_flax)
from image_compression_torch.models.unet import EdgeUNet  # noqa: E402
from image_compression_torch.ops import labels_wire as twire  # noqa: E402
from image_compression_torch.train.checkpoint import load_params  # noqa: E402
from image_compression_torch.utils.pattern_generator import \
    mixed_corpus  # noqa: E402

torch.set_num_threads(1)

ORBAX = REPO / "artifacts" / "fcn_pretrained_r4_mixed_params"
WEIGHTS = REPO / "image_compression_torch" / "weights" / \
    "fcn_pretrained_r4_mixed.pt"
RECORD = REPO / "image_compression_torch" / "weights" / \
    "flagship_mixed_reference.json"
# the corpus runs of the record: the first N images at SIDE x SIDE
RUNS = {"full": (32, 256), "small": (4, 128)}
ORIG_LEVEL = 6  # zlib level of the originals (PIL's default)
F32_UNET_TOL = 5e-5  # x max |reference output|, see the module docstring


def read_orbax_params(path: str | pathlib.Path) -> dict:
    """The orbax params tree {"params": {...}} as numpy arrays, restored
    onto the CPU (the JAX package's load_params asks for the TPU that
    wrote the checkpoint)."""
    import orbax.checkpoint as ocp

    path = pathlib.Path(path).absolute()
    meta = json.loads((path / "_METADATA").read_text())["tree_metadata"]
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    args: dict = {}
    for entry in meta.values():
        keys = [k["key"] for k in entry["key_metadata"]]
        node = args
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = ocp.ArrayRestoreArgs(sharding=cpu)
    tree = ocp.PyTreeCheckpointer().restore(path, restore_args=args)
    return jax.tree.map(np.asarray, tree)


def write_weights(orbax_dir: str | pathlib.Path,
                  out: str | pathlib.Path) -> None:
    """The orbax params as an EdgeUNet state_dict, in the model's order."""
    params = state_dict_from_flax(read_orbax_params(orbax_dir))
    order = EdgeUNet(base=params["inc.conv0.weight"].shape[0]).state_dict()
    assert set(order) == set(params)
    torch.save({k: params[k] for k in order}, out)


def sha256(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def write_corpus(directory: pathlib.Path, n: int, size: int) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    for stem, img in mixed_corpus(n, size):
        write_image(directory / f"{stem}.png", img, ORIG_LEVEL)


def output_entries(data: pathlib.Path, out: pathlib.Path) -> list[dict]:
    """io/reassemble.output_record of every source image, sorted by name:
    the record's entries (chip_smoke.py reads them the same way)."""
    return [output_record(src, out / src.stem)
            for src in sorted(data.glob("*.png"))]


@contextlib.contextmanager
def jax_unet_dtype(dtype):
    """The JAX package's compress_directory builds EdgeUNet() (bf16); this
    makes it build the U-Net at `dtype` for the duration."""
    saved = jp.EdgeUNet
    jp.EdgeUNet = functools.partial(JUNet, dtype=dtype)
    try:
        yield
    finally:
        jp.EdgeUNet = saved


def jax_compress(params: dict, data: pathlib.Path, out: pathlib.Path,
                 dtype, agg: str = "matrix") -> list[dict]:
    """The JAX package's compress_directory at the shipped settings with
    `agg`, its U-Net at `dtype`; returns output_entries."""
    cfg = JConfig(dataset_dir=str(data), results_dir=str(out))
    cfg.multicut.hier_agg = agg
    with jax_unet_dtype(dtype):
        jp.compress_directory(cfg, params=params, batch_size=8)
    return output_entries(data, out)


def summary(data: pathlib.Path, entries: list[dict]) -> dict:
    orig = sum(p.stat().st_size for p in sorted(data.glob("*.png")))
    return {"out_orig": sum(e["out_bytes"] for e in entries) / orig,
            "images": entries}


def write_record(out: str | pathlib.Path) -> None:
    """Run the JAX package's compress on the corpus runs of RUNS with the
    orbax flagship params and write the record."""
    params = read_orbax_params(ORBAX)
    record = {
        "command": "python tests/test_torch_weights.py --record "
                   + str(pathlib.Path(out).absolute().relative_to(REPO)),
        "weights": str(WEIGHTS.relative_to(REPO)),
        "weights_sha256": sha256(WEIGHTS),
        "reference": "image_compression_tpu.pipeline.compress_directory, "
                     f"batch_size 8, jax {jax.__version__} on the CPU, "
                     "params of artifacts/fcn_pretrained_r4_mixed_params",
        "config": "Config() (the shipped settings) with "
                  "multicut.hier_agg='matrix'; 'pixel_bf16': the shipped "
                  "hier_agg='pixel', for context",
        "corpus": "utils/pattern_generator.mixed_corpus(n, size) (seed 0, "
                  "cells 64/128), PNGs by io/image_io.write_image at zlib "
                  f"level {ORIG_LEVEL}",
        "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for name, (n, size) in RUNS.items():
            data = tmp / name / "data"
            write_corpus(data, n, size)
            run = {"n": n, "size": size, "orig_bytes": {
                p.stem: p.stat().st_size for p in sorted(data.glob("*.png"))}}
            variants = [("f32", jnp.float32, "matrix"),
                        ("bf16", jnp.bfloat16, "matrix")]
            if name == "full":
                variants.append(("pixel_bf16", jnp.bfloat16, "pixel"))
            for key, dtype, agg in variants:
                entries = jax_compress(params, data, tmp / name / key, dtype,
                                       agg)
                run[key] = summary(data, entries)
                print(f"{name} {key}: out/orig {run[key]['out_orig']:.4f}",
                      flush=True)
            record["runs"][name] = run
    pathlib.Path(out).write_text(json.dumps(record, indent=1) + "\n")


# ---------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def params():
    return load_params(WEIGHTS)


@pytest.fixture(scope="module")
def small(tmp_path_factory, params):
    """The record's small run: its corpus, the JAX package's f32 costs of
    it and a JAX f32 model."""
    n, size = RUNS["small"]
    data = tmp_path_factory.mktemp("small") / "data"
    write_corpus(data, n, size)
    images = [load_image(p) for p in sorted(data.glob("*.png"))]
    x = np.stack(images).astype(np.float32) / 255.0
    jm = JUNet(dtype=jnp.float32)
    jparams = flax_from_state_dict(params)
    costs = np.asarray(jax.jit(
        lambda p, b: jp.learned_costs(jm, p, b))(jparams, jnp.asarray(x)))
    return dict(data=data, images=images, x=x, jm=jm, jparams=jparams,
                costs=costs)


def test_weights_file_equals_the_orbax_checkpoint(params):
    """(a) Every tensor of the committed file is the orbax flagship's,
    converted: names, shapes, dtype and bits."""
    want = state_dict_from_flax(read_orbax_params(ORBAX))
    model = EdgeUNet(base=params["inc.conv0.weight"].shape[0])
    assert list(params) == list(model.state_dict())
    assert set(params) == set(want)
    for k, v in want.items():
        assert params[k].dtype == torch.float32 and v.dtype == torch.float32
        assert params[k].shape == v.shape, k
        assert torch.equal(params[k], v), k
    model.load_state_dict(params, strict=True)
    assert sum(v.numel() for v in params.values()) == 7_703_172


def test_record_names_the_weights():
    record = json.loads(RECORD.read_text())
    assert record["weights_sha256"] == sha256(WEIGHTS)
    assert record["weights"] == str(WEIGHTS.relative_to(REPO))
    for name, (n, size) in RUNS.items():
        run = record["runs"][name]
        assert (run["n"], run["size"]) == (n, size)
        assert len(run["f32"]["images"]) == len(run["bf16"]["images"]) == n


def test_flagship_unet_f32(params, small):
    """(b) The flagship U-Net, port vs JAX, f32, on the 4 x 128x128 mixed
    images."""
    ref = np.asarray(jax.jit(small["jm"].apply)(
        small["jparams"], jnp.asarray(small["x"])))
    model = EdgeUNet(base=64, dtype=torch.float32)
    model.load_state_dict(params)
    with torch.no_grad():
        got = model.eval()(torch.as_tensor(small["x"])).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= F32_UNET_TOL * np.abs(ref).max()


def test_flagship_compress_on_rounded_costs(small, tmp_path):
    """(c) Compress of the small corpus by both packages on the JAX f32
    costs rounded to 1/16: labels, wire, metadata.bin and every slice's
    bytes equal, reassembly lossless, and merge refinement and the writer
    see a trained model's regions (an image keeps >= 3 slices)."""
    q = np.round(small["costs"] * 16) / 16
    images = small["images"]
    paths = sorted(small["data"].glob("*.png"))
    names = [p.stem for p in paths]
    sizes = [p.stat().st_size for p in paths]  # the originals' bytes
    jcfg, tcfg = JConfig(), Config()
    jcfg.multicut.hier_agg = "matrix"
    j_labels = np.asarray(jp._device_labels(images, lambda b: jnp.asarray(q),
                                            jcfg, orig_sizes=sizes))
    with torch.inference_mode():
        t_labels = tp._device_labels(
            images, lambda b: torch.as_tensor(q), tcfg, torch.device("cpu"),
            orig_sizes=sizes)
        t_wire = [np.asarray(w) for w in tp._pack_wire(t_labels)]
    np.testing.assert_array_equal(t_labels.numpy(), j_labels)
    j_wire = [np.asarray(w) for w in jp._pack_wire(jnp.asarray(j_labels))]
    for a, b in zip(t_wire, j_wire):
        np.testing.assert_array_equal(a, b)
    j_dirs = jp._write_batch(images, j_wire, jcfg, tmp_path / "jax", names,
                             src_paths=paths)
    t_dirs = tp._write_batch(images, t_wire, tcfg, tmp_path / "torch", names,
                             src_paths=paths)
    slices = []
    for jd, td, img in zip(j_dirs, t_dirs, images):
        j_files = {p.name: p.read_bytes() for p in sorted(jd.iterdir())}
        t_files = {p.name: p.read_bytes() for p in sorted(td.iterdir())}
        assert t_files == j_files, td.name
        assert np.array_equal(reassemble_array(td), ensure_rgba(img))
        slices.append(len(t_files) - 1)
    assert max(slices) >= 3, slices


def test_record_small_runs_equal_a_fresh_jax_run(small, tmp_path):
    """(d) The record's small entries are what the JAX package writes now
    (f32, matrix aggregation): every image's bytes, slices and decision."""
    record = json.loads(RECORD.read_text())["runs"]["small"]
    orig = {p.stem: p.stat().st_size
            for p in sorted(small["data"].glob("*.png"))}
    assert orig == record["orig_bytes"]
    entries = jax_compress(small["jparams"], small["data"], tmp_path / "f32",
                           jnp.float32)
    assert summary(small["data"], entries) == record["f32"]


def test_load_params_names_the_conversion_for_orbax(tmp_path):
    """An orbax directory is refused with the command that converts it."""
    for marker in ("_CHECKPOINT_METADATA", "manifest.ocdbt"):
        d = tmp_path / marker.strip("_").lower()
        d.mkdir()
        (d / marker).write_text("{}")
        with pytest.raises(ValueError, match="test_torch_weights.py"):
            load_params(d)
    with pytest.raises(ValueError, match="orbax"):
        load_params(ORBAX)


def test_cli_compress_and_train_take_the_weights_file(tmp_path):
    """compress --checkpoint and train --checkpoint read the weights file
    (base 64 from its first conv): compress is lossless, and two RL steps
    at the r4 RL settings change the params."""
    from image_compression_torch.cli.main import main as cli

    dirs = {d: tmp_path / d for d in ("train", "val")}
    for i, (stem, img) in enumerate(mixed_corpus(6, 32, cells=(8, 16))):
        d = dirs["train" if i < 4 else "val"]
        d.mkdir(exist_ok=True)
        write_image(d / f"{stem}.png", img, ORIG_LEVEL)
    cli(["compress", "--dataset-dir", str(dirs["val"]), "--results-dir",
         str(tmp_path / "out"), "--checkpoint", str(WEIGHTS), "--device",
         "cpu"])
    for src in sorted(dirs["val"].glob("*.png")):
        assert np.array_equal(reassemble_array(tmp_path / "out" / src.stem),
                              ensure_rgba(load_image(src)))
    cfg = Config(dataset_dir=str(dirs["train"]),
                 val_dataset_dir=str(dirs["val"]),
                 results_dir=str(tmp_path / "rl"),
                 cache_dir=str(tmp_path / "cache"), image_size=32)
    cfg.rl.sampler, cfg.rl.baseline, cfg.rl.whiten = "antithetic", "ema", \
        False
    cfg.rl.lr, cfg.rl.entropy_coef, cfg.rl.epochs = 2e-5, 1e-5, 1
    cfg.rl.batch_size = 2
    cfg.reward.fallback_aware = True
    (tmp_path / "rl.json").write_text(json.dumps(cfg.to_dict()))
    cli(["train", "--config", str(tmp_path / "rl.json"), "--checkpoint",
         str(WEIGHTS), "--device", "cpu"])
    (final,) = (tmp_path / "rl").glob("fcn_training_*_final")
    trained, start = load_params(final), load_params(WEIGHTS)
    assert set(trained) == set(start)
    assert any(not torch.equal(trained[k], v) for k, v in start.items())


def test_mixed_corpus_is_the_reference_recipe():
    """mixed_corpus draws the reference's generators in the order of
    benchmarks/make_mixed_corpus.py (the 4-class cycle, cells 64 then 128,
    one generator)."""
    from image_compression_tpu.utils import pattern_generator as jpg

    rng = np.random.default_rng(0)
    size = 128
    makers = [jpg.generate_sigma_mosaic, jpg.generate_anticorr_mosaic,
              jpg.generate_mixed_mosaic]
    for i, (stem, img) in enumerate(mixed_corpus(10, size)):
        cell = (64, 128)[(i // 4) % 2]
        if i % 4 == 3:
            want, _ = jpg.generate_flat_noise_composite(size, size, rng)
        else:
            want, _ = makers[i % 4](size, size, rng, cell=cell)
        assert stem.endswith(f"_{i:04d}")
        np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("size", [(64, 64), (37, 70)])
def test_labels_from_conn_native(size):
    """The port's binding of pngio_labels_from_conn: bitwise to the JAX
    package's on the same wire, and equal to the wire's unpacking
    (ops/labels_wire) into smallest-pixel labels."""
    if not (tnative.available() and jnative.load_library() is not None):
        pytest.fail("the native library does not build here")
    h, w = size
    rng = np.random.default_rng(h)
    labels = np.zeros((1, h, w), np.int32)
    blocks = rng.integers(0, 5, (h // 8 + 1, w // 8 + 1))
    part = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
    flat = np.arange(h * w).reshape(h, w)
    for v in np.unique(part):  # smallest flat index per block label
        labels[0][part == v] = flat[part == v].min()
    hb, vb = (np.asarray(a)[0] for a in twire.pack_connectivity(
        torch.as_tensor(labels)))
    got = tnative.labels_from_conn_native(hb, vb, h, w)
    assert got.dtype == np.int32 and got.shape == (h, w)
    np.testing.assert_array_equal(
        got, jnative.labels_from_conn_native(hb, vb, h, w))
    np.testing.assert_array_equal(
        got, twire.labels_from_connectivity(hb, vb, h, w))
    # smallest-pixel labels of the wire's connected components: they pack
    # to the same wire
    for a, b in zip(twire.pack_connectivity(torch.as_tensor(got)), (hb, vb)):
        np.testing.assert_array_equal(a.numpy(), b)
    flat = np.arange(h * w).reshape(h, w)
    for v in np.unique(got):
        assert flat[got == v].min() == v

if __name__ == "__main__":
    if sys.argv[1:2] == ["--record"] and len(sys.argv) == 3:
        write_record(sys.argv[2])
    elif len(sys.argv) == 3:
        write_weights(sys.argv[1], sys.argv[2])
    else:
        sys.exit(__doc__)
