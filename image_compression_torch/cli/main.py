"""CLI of the port: `python -m image_compression_torch.cli.main <command>`.

  compress    segment + slice every PNG of --dataset-dir into --results-dir,
              with learned costs from an EdgeUNet state_dict (--checkpoint,
              a torch.save of models/convert.state_dict_from_flax output)
              or, without a checkpoint, with a classical extractor
              (--classical slic|canny|graph|watershed, canny by default);
              --pack writes one SLPK file per image
  reassemble  rebuild one image from its slice directory or pack file

Runs on CUDA unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys

from image_compression_torch.config import Config, EdgeTarget


def _load_config(args) -> Config:
    cfg = Config.from_json(args.config) if args.config else Config()
    for key in ("dataset_dir", "val_dataset_dir", "results_dir",
                "image_size"):
        val = getattr(args, key, None)
        if val is not None:
            setattr(cfg, key, val)
    if args.pack:
        cfg.slice_container = "pack"
    if args.no_fallback:
        cfg.compress_fallback = False
    return cfg


def cmd_compress(args):
    import torch

    from image_compression_torch.models.unet import EdgeUNet
    from image_compression_torch.pipeline import compress_directory

    cfg = _load_config(args)
    model = None
    if args.checkpoint:
        model = EdgeUNet()
        model.load_state_dict(torch.load(args.checkpoint, map_location="cpu",
                                         weights_only=True))
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


def main(argv=None):
    parser = argparse.ArgumentParser(prog="image_compression_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("compress", help="segment + slice images")
    p.add_argument("--config", help="JSON config file (Config.to_dict "
                   "schema)")
    p.add_argument("--dataset-dir", dest="dataset_dir")
    p.add_argument("--val-dataset-dir", dest="val_dataset_dir")
    p.add_argument("--results-dir", dest="results_dir")
    p.add_argument("--image-size", dest="image_size", type=int)
    p.add_argument("--checkpoint",
                   help="EdgeUNet state_dict saved with torch.save "
                        "(learned costs)")
    p.add_argument("--classical", choices=[e.value for e in EdgeTarget],
                   help="classical extractor instead of the U-Net "
                        "(canny without a checkpoint)")
    p.add_argument("--limit", type=int, help="max images")
    p.add_argument("--pack", action="store_true",
                   help="one SLPK container file per image instead of a "
                        "directory of slice PNGs (reassemble reads both)")
    p.add_argument("--no-fallback", action="store_true",
                   help="always slice (disable the single-slice fallback)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_compress)

    p = sub.add_parser("reassemble", help="rebuild an image from slices")
    p.add_argument("slice_dir")
    p.add_argument("-o", "--output", default="reconstructed.png")
    p.set_defaults(fn=cmd_reassemble)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
