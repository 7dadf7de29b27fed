"""CLI of the port: `python -m image_compression_torch.cli.main <command>`.

  compress    segment + slice every PNG of --dataset-dir into --results-dir,
              with learned costs from an EdgeUNet state_dict (--checkpoint,
              a torch.save of models/convert.state_dict_from_flax output)
              or, without a checkpoint, with a classical extractor
              (--classical slic|canny|graph|watershed, canny by default);
              --pack writes one SLPK file per image
  reassemble  rebuild one image from its slice directory or pack file
  convert     resize every --source-format image of --dataset-dir to
              --size x --size and write it as a PNG beside the source
  pretrain    supervised pretraining on classical targets (--epochs,
              --resume a full-state checkpoint, --init-params a params file)
  train       REINFORCE from pretrained params (--checkpoint, a params file
              or a full-state checkpoint; --epochs, --resume)

Runs on CUDA unless --device cpu is given. pretrain and train join a
data-parallel process group first when a cluster environment is set, so
that under `torchrun --nproc_per_node=N` they train on N cards (NCCL;
gloo with --device cpu).
"""

from __future__ import annotations

import argparse
import json
import sys

from image_compression_torch.config import Config, EdgeTarget


def _add_config_args(p) -> None:
    p.add_argument("--config", help="JSON config file (Config.to_dict "
                   "schema)")
    p.add_argument("--dataset-dir", dest="dataset_dir")
    p.add_argument("--val-dataset-dir", dest="val_dataset_dir")
    p.add_argument("--results-dir", dest="results_dir")
    p.add_argument("--image-size", dest="image_size", type=int)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _load_config(args) -> Config:
    cfg = Config.from_json(args.config) if args.config else Config()
    for key in ("dataset_dir", "val_dataset_dir", "results_dir",
                "image_size"):
        val = getattr(args, key, None)
        if val is not None:
            setattr(cfg, key, val)
    if getattr(args, "pack", False):
        cfg.slice_container = "pack"
    if getattr(args, "no_fallback", False):
        cfg.compress_fallback = False
    return cfg


def cmd_compress(args):
    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.pipeline import compress_directory
    from image_compression_torch.train.checkpoint import load_params

    cfg = _load_config(args)
    model = None
    if args.checkpoint:
        params = load_params(args.checkpoint)
        model = EdgeUNet(base=params["inc.conv0.weight"].shape[0])
        model.load_state_dict(params)
    classical = EdgeTarget(args.classical) if args.classical else None
    dirs = compress_directory(cfg, model, limit=args.limit,
                              classical=classical, device=args.device)
    print(json.dumps({"compressed": [str(d) for d in dirs]}))


def cmd_reassemble(args):
    from image_compression_torch.io.reassemble import reassemble

    ok = reassemble(args.slice_dir, args.output)
    print(f"Reconstructed image written to {args.output}" if ok
          else "reassembly failed")
    if not ok:
        sys.exit(1)


def cmd_convert(args):
    from image_compression_torch.io.converter import convert_dataset

    n = convert_dataset(args.dataset_dir or "dataset",
                        source_format=args.source_format, width=args.size,
                        height=args.size, device=args.device)
    print(f"converted {n} images")


def _training(run):
    """Run a training command inside the data-parallel group, when a
    cluster environment asks for one; rank 0 prints its result."""
    from image_compression_torch.parallel import mesh

    def cmd(args):
        joined = mesh.initialize_distributed(device=args.device)
        try:
            msg = run(args)
            if mesh.world()[0] == 0:
                print(msg)
        finally:
            if joined:
                import torch.distributed as dist
                dist.destroy_process_group()
    return cmd


@_training
def cmd_pretrain(args):
    from image_compression_torch.train.pretrain import run_pretraining

    cfg = _load_config(args)
    if args.epochs:
        cfg.pretrain.epochs = args.epochs
    _state, run_id = run_pretraining(cfg, resume=args.resume,
                                     init_params=args.init_params,
                                     device=args.device)
    return f"pretraining done, run id {run_id}"


@_training
def cmd_train(args):
    from image_compression_torch.train.checkpoint import load_params
    from image_compression_torch.train.reinforce import run_reinforce

    cfg = _load_config(args)
    if args.epochs:
        cfg.rl.epochs = args.epochs
    _state, run_id = run_reinforce(cfg, load_params(args.checkpoint),
                                   resume=args.resume, device=args.device)
    return f"training done, run id {run_id}"


def main(argv=None):
    parser = argparse.ArgumentParser(prog="image_compression_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("compress", help="segment + slice images")
    _add_config_args(p)
    p.add_argument("--checkpoint",
                   help="EdgeUNet state_dict saved with torch.save, e.g. a "
                        "training run's *_params file (learned costs)")
    p.add_argument("--classical", choices=[e.value for e in EdgeTarget],
                   help="classical extractor instead of the U-Net "
                        "(canny without a checkpoint)")
    p.add_argument("--limit", type=int, help="max images")
    p.add_argument("--pack", action="store_true",
                   help="one SLPK container file per image instead of a "
                        "directory of slice PNGs (reassemble reads both)")
    p.add_argument("--no-fallback", action="store_true",
                   help="always slice (disable the single-slice fallback)")
    p.set_defaults(fn=cmd_compress)

    p = sub.add_parser("reassemble", help="rebuild an image from slices")
    p.add_argument("slice_dir")
    p.add_argument("-o", "--output", default="reconstructed.png")
    p.set_defaults(fn=cmd_reassemble)

    p = sub.add_parser("convert", help="dataset preparation: resize and "
                       "re-encode as PNG")
    _add_config_args(p)
    p.add_argument("--source-format", default="jpeg")
    p.add_argument("--size", type=int, default=256)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("pretrain", help="supervised pretraining")
    _add_config_args(p)
    p.add_argument("--epochs", type=int)
    p.add_argument("--resume", help="full-state checkpoint to continue from")
    p.add_argument("--init-params", help="params file to warm-start from "
                   "(optimizer state and step start fresh)")
    p.set_defaults(fn=cmd_pretrain)

    p = sub.add_parser("train", help="REINFORCE training")
    _add_config_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="pretrained params: a *_params file or a full-state "
                        "checkpoint")
    p.add_argument("--epochs", type=int)
    p.add_argument("--resume", help="RL checkpoint to continue from")
    p.set_defaults(fn=cmd_train)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
