"""End-to-end migration for users of the reference's PyTorch model: the
counterpart of the JAX package's ``examples/migrate_from_torch.py``.

1. A checkpoint of the reference's ``TorchCerberus`` (a ``torch.save`` of
   its state_dict, bare or under "state_dict" or "model") is given.
2. ``Trainer.import_torch_weights`` loads it (``weights.load_torch_cerberus``:
   a rename of its keys, no arithmetic).
3. The imported model is evaluated, run on three image files
   (``predict_images``) and exported as a deployment artifact
   (``Trainer.export``: a ``torch.export`` program, which the C++ runner
   takes once packaged).

Run:  python -m cerberusnet_torch.examples.migrate_from_torch CKPT [OUT_DIR] [--device cpu]
      (CKPT at the tiny widths of ``TINY``)
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cerberusnet_torch.data import io as data_io
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer

TINY = dict(encoder_channels=[8, 12, 16, 16, 16, 16],
            est_channels=[16, 16, 12], ctx_channels=[16, 16],
            fpn_channels=16)


def config() -> ExperimentConfig:
    """The reference example's experiment at ``TINY`` widths, 64x64."""
    return ExperimentConfig.from_dict({
        "name": "migrated",
        "model": {"variant": "cerberus", **TINY},
        "data": {"dataset": "synthetic", "hw": [64, 64], "batch_size": 2,
                 "num_workers": 1, "synthetic_length": 4, "shuffle": False,
                 "eval_split": "val"},
        "optim": {"lr": 1e-4, "warmup_steps": 0, "total_steps": 10,
                  "schedule": "constant"},
        "train": {"epochs": 1, "num_data_devices": 1},
    })


def main(ckpt: str, out_dir="/tmp/cerberus_migrate", device="cuda") -> dict:
    """Returns {"metrics", "predictions" (the files written), "export"}."""
    os.makedirs(out_dir, exist_ok=True)
    trainer = Trainer(config(), device=device)
    trainer.import_torch_weights(ckpt)
    print(f"[1-2] weights imported from {ckpt}")

    metrics = trainer.evaluate()
    print(f"[3a] evaluate(): { {k: round(float(v), 4) for k, v in metrics.items()} }")

    rng = np.random.default_rng(0)
    img_paths = []
    for n in ("left", "right", "temporal"):
        p = os.path.join(out_dir, f"{n}.png")
        data_io.write_image_u8(p, rng.integers(0, 255, (64, 64, 3), np.uint8))
        img_paths.append(p)
    made = trainer.predict_images(dict(zip(trainer.input_keys, img_paths)),
                                  os.path.join(out_dir, "preds"))
    print(f"[3b] predict_images wrote {len(made)} files")

    artifact = trainer.export(os.path.join(out_dir, "artifact"))
    print(f"[3c] exported deployment artifact: {artifact}")
    print("migration demo complete")
    return {"metrics": metrics, "predictions": made, "export": artifact}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("out_dir", nargs="?", default="/tmp/cerberus_migrate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.ckpt, args.out_dir, args.device)
