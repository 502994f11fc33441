"""End-to-end demo: train a tiny CerberusNet on synthetic data, evaluate
it, draw a panel of its predictions and export a deployment artifact; the
counterpart of the JAX package's ``examples/demo_end_to_end.py``.

Run:  python -m cerberusnet_torch.examples.demo_end_to_end [OUT_DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from cerberusnet_torch.data import io as data_io
from cerberusnet_torch.data.loader import batches, preprocess
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.utils import visualization as vis


def config(out_dir: str) -> ExperimentConfig:
    """The reference demo's experiment: the tiny CerberusNet at 128x256, 8
    synthetic samples in batches of 2, 2 epochs; the correlations are the
    kernels on the card and their plain versions on the CPU."""
    return ExperimentConfig.from_dict({
        "name": "demo",
        "model": {"variant": "cerberus",
                  "encoder_channels": [8, 12, 16, 16, 16, 16],
                  "est_channels": [16, 16, 12], "ctx_channels": [16, 16],
                  "fpn_channels": 16},
        "data": {"dataset": "synthetic", "hw": [128, 256], "batch_size": 2,
                 "num_workers": 2, "synthetic_length": 8},
        "optim": {"lr": 1e-3, "warmup_steps": 0, "schedule": "constant",
                  "total_steps": 100},
        "train": {"epochs": 2, "ckpt_dir": os.path.join(out_dir, "ckpt"),
                  "log_every": 2, "num_data_devices": 1},
    })


def main(out_dir="/tmp/cerberus_demo", device="cuda") -> dict:
    """Returns {"metrics": evaluate()'s, "panel": its path, "export": the
    artifact's directory}."""
    os.makedirs(out_dir, exist_ok=True)
    trainer = Trainer(config(out_dir), device=device)
    trainer.fit()
    metrics = trainer.evaluate()
    print("metrics:", metrics)

    # visualize one prediction of the trained masters
    batch = batches(trainer.dataset, 1, 1)[0]
    prep = preprocess(batch, trainer.config.data.hw, trainer.dtype,
                      trainer.device)
    with torch.no_grad():
        out = trainer.model(*(prep[k] for k in trainer.input_keys))
    panel = vis.summary_panel({
        "image": batch["left"][0],
        "seg": out["seg_logits"][0].argmax(-1).cpu().numpy(),
        "flow": out["flow"][0].float().cpu().numpy(),
        "disp": out["disp"][0, ..., 0].float().cpu().numpy(),
    })
    panel_path = os.path.join(out_dir, "predictions.png")
    data_io.write_image_u8(panel_path, panel)
    print("wrote", panel_path)

    art = trainer.export(os.path.join(out_dir, "export"))
    print("exported the deployment artifact to", art)
    return {"metrics": metrics, "panel": panel_path, "export": art}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="/tmp/cerberus_demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.out_dir, args.device)
