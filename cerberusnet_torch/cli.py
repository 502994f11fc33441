"""Command line, the port's counterpart of ``cerberusnet_tpu/cli.py``:
train or evaluate a model from a JSON experiment config.

    python -m cerberusnet_torch.cli --config configs/cerberus_evidence.json
    python -m cerberusnet_torch.cli --config cfg.json --eval-only
    python -m cerberusnet_torch.cli --config cfg.json --device cpu
    python -m cerberusnet_torch.cli --config cfg.json --infer l.png,r.png,t.png
    python -m cerberusnet_torch.cli --config cfg.json --predict-dir preds/
    python -m cerberusnet_torch.cli --config cfg.json --export-dir art/ \
        [--quant int8] [--export-stacked]

``--import-torch`` (a PyTorch ``TorchCerberus`` checkpoint, loaded before
any other action), ``--profile``, ``--export-dir`` (with ``--quant`` and
``--export-stacked``), ``--infer`` with ``--infer-out``, ``--predict-dir``,
``--eval-only`` and training run in the reference's order; ``--device`` is
``cuda`` unless given. ``--quant`` and ``--export-stacked`` without
``--export-dir`` are refused (the reference ignores them and trains).

Data and spatial parallelism: with ``train.num_data_devices`` D and
``train.num_spatial_devices`` S the command starts D x S ranks itself
when that is more than one (D = 0: every card, divided by S), one a card
(``parallel.launch``, NCCL; gloo on the CPU, or for ranks sharing the card
``--device cuda:0`` names), each running the same action; rank 0 alone
prints and writes. A host with fewer cards than ranks raises ValueError.
A process started by ``torchrun`` (``WORLD_SIZE`` set) joins that group
instead:

    python -m cerberusnet_torch.cli --config configs/cerberus_dp_v4_8.json
    torchrun --nproc-per-node 8 -m cerberusnet_torch.cli \
        --config configs/cerberus_dp_v4_8.json
    python -m cerberusnet_torch.cli --config cfg.json --device cpu  # with
        # "train": {"num_data_devices": 1, "num_spatial_devices": 2}
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m cerberusnet_torch.cli",
        description="Train or evaluate cerberusnet_torch models from a "
                    "JSON config.")
    ap.add_argument("--config", required=True,
                    help="path to ExperimentConfig JSON")
    ap.add_argument("--eval-only", action="store_true",
                    help="evaluate (the restored weights) and print the "
                         "metrics as JSON")
    ap.add_argument("--ckpt-dir", default=None, help="override train.ckpt_dir")
    ap.add_argument("--print-config", action="store_true",
                    help="dump the parsed config and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument(
        "--infer", default=None, metavar="IMG[,IMG...]",
        help="one sample's inference on image files (comma-separated, in "
             "the variant's input order, e.g. left.png,right.png,"
             "temporal.png): writes the raw .npz, the benchmark PNGs and a "
             "panel, then exits")
    ap.add_argument("--infer-out", default="predictions", metavar="DIR",
                    help="output directory of --infer (default: "
                         "predictions/)")
    ap.add_argument(
        "--predict-dir", default=None, metavar="DIR",
        help="inference over the held-out split, written as benchmark "
             "files (KITTI 16-bit flow and disparity PNGs, Cityscapes "
             "labelIds) into DIR, then exit")
    ap.add_argument(
        "--import-torch", default=None, metavar="CKPT",
        help="load a PyTorch TorchCerberus checkpoint into the model before "
             "any other action (the joint variant)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of a few train steps "
                         "into DIR and exit")
    ap.add_argument("--export-dir", default=None, metavar="DIR",
                    help="export the (restored) model to DIR as a "
                         "torch.export artifact (model.pt2, manifest.json) "
                         "and exit")
    ap.add_argument("--quant", default=None, choices=["int8"],
                    help="with --export-dir: calibration-based int8 PTQ of "
                         "the exported graph (the TensorRT-int8 analogue)")
    ap.add_argument("--export-stacked", action="store_true",
                    help="with --export-dir (cerberus variant): export the "
                         "producer-stacked signature, one (3B,H,W,3) input")
    return ap


def _parse(argv):
    """(parser, arguments, config) of a command line."""
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.export_dir and (args.quant or args.export_stacked):
        ap.error("--quant and --export-stacked need --export-dir")

    from cerberusnet_torch.train.config import ExperimentConfig

    config = ExperimentConfig.from_json(args.config)
    if args.ckpt_dir is not None:
        config.train.ckpt_dir = args.ckpt_dir
    return ap, args, config


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap, args, config = _parse(argv)
    if args.print_config:
        print(config.to_json())
        return 0

    import torch
    import torch.distributed as dist

    from cerberusnet_torch.parallel.mesh import data_ranks, launch

    device = torch.device(args.device)
    # NCCL takes a card a rank; ranks sharing one card or the CPU, gloo
    backend = ("nccl" if device.type == "cuda" and device.index is None
               else "gloo")
    if os.environ.get("WORLD_SIZE") and not dist.is_initialized():
        # a rank torchrun started: join its group (env://)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        try:
            return _run(ap, args, config)
        finally:
            dist.destroy_process_group()
    ranks = data_ranks(config.train.num_data_devices, device,
                       config.train.num_spatial_devices)
    if ranks > 1:
        launch(_rank, ranks, args=(argv,), backend=backend)
        return 0
    return _run(ap, args, config)


def _rank(argv):
    """A rank the command started: the same action in its group."""
    return _run(*_parse(argv))


def _run(ap, args, config):
    from cerberusnet_torch.train.trainer import Trainer

    trainer = Trainer(config, device=args.device)
    say = print if trainer.writer else (lambda *a, **k: None)
    if args.import_torch:
        trainer.import_torch_weights(args.import_torch)
    if args.profile:
        say(f"trace written to {trainer.profile(args.profile)}")
        return 0
    if args.export_dir:
        out = trainer.export(args.export_dir, quant=args.quant,
                             stacked=args.export_stacked)
        say(f"exported AOT artifact to {out}")
        return 0
    if args.infer:
        imgs = [p for p in args.infer.split(",") if p]
        if len(imgs) != len(trainer.input_keys):
            ap.error(f"--infer needs {len(trainer.input_keys)} images "
                     f"({','.join(trainer.input_keys)}), got {len(imgs)}")
        made = trainer.predict_images(dict(zip(trainer.input_keys, imgs)),
                                      args.infer_out)
        say("\n".join(made))
        return 0
    if args.predict_dir:
        made = trainer.predict_to_dir(args.predict_dir)
        say(f"wrote {len(made)} prediction files to {args.predict_dir}")
        return 0
    if args.eval_only:
        say(json.dumps(trainer.evaluate(), indent=2))
        return 0
    trainer.fit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
