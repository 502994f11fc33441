"""Command line, the port's counterpart of ``cerberusnet_tpu/cli.py``:
train or evaluate a model from a JSON experiment config.

    python -m cerberusnet_torch.cli --config configs/cerberus_evidence.json
    python -m cerberusnet_torch.cli --config cfg.json --eval-only
    python -m cerberusnet_torch.cli --config cfg.json --device cpu

``--config``, ``--eval-only``, ``--ckpt-dir``, ``--print-config`` and
``--device`` (``cuda`` unless given) run. The reference's other flags are
accepted and raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import sys

# flag (argparse dest) -> the ROADMAP item that ports it
UNPORTED = {
    "infer": "A7", "infer_out": "A7", "predict_dir": "A7",
    "import_torch": "A7", "profile": "A7", "export_dir": "A9",
    "export_stacked": "A9", "quant": "A10",
}


def main(argv=None):
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
    ap.add_argument("--infer", default=None, metavar="IMG[,IMG...]")
    ap.add_argument("--infer-out", default=None, metavar="DIR")
    ap.add_argument("--predict-dir", default=None, metavar="DIR")
    ap.add_argument("--import-torch", default=None, metavar="CKPT")
    ap.add_argument("--profile", default=None, metavar="DIR")
    ap.add_argument("--export-dir", default=None, metavar="DIR")
    ap.add_argument("--export-stacked", action="store_true")
    ap.add_argument("--quant", default=None, choices=["int8"])
    args = ap.parse_args(argv)

    from cerberusnet_torch.train.config import ExperimentConfig

    config = ExperimentConfig.from_json(args.config)
    if args.ckpt_dir is not None:
        config.train.ckpt_dir = args.ckpt_dir
    if args.print_config:
        print(config.to_json())
        return 0
    for dest, item in UNPORTED.items():
        if getattr(args, dest):
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")

    from cerberusnet_torch.train.trainer import Trainer

    trainer = Trainer(config, device=args.device)
    if args.eval_only:
        print(json.dumps(trainer.evaluate(), indent=2))
        return 0
    trainer.fit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
