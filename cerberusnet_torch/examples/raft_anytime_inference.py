"""RAFT anytime inference: one set of weights, any iteration count; the
counterpart of the JAX package's ``examples/raft_anytime_inference.py``.

The RAFT update block is weight-tied, so the parameters do not depend on
the iteration count (``models/raft.py``). That gives a latency/accuracy
dial at deploy time with no retraining: build ``RAFTFlowNet`` with fewer
(or more) iterations than training used and load the same ``state_dict``.
This demo trains a tiny model for 20 steps at 4 iterations, then runs it at
1, 2, 4 and 8 and prints each count's full-resolution EPE against the
ground truth (monotone improvement is what a trained RAFT shows; a model
this briefly trained only shows the mechanism). Iteration k's level field
is the k-th iterate of any longer run from the same state.

Run:  python -m cerberusnet_torch.examples.raft_anytime_inference [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from cerberusnet_torch.data.loader import batches, preprocess
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer, build_model

ITERS = (1, 2, 4, 8)
TRAIN_STEPS = 20


def config() -> ExperimentConfig:
    """The reference example's tiny RAFTFlowNet experiment: 64x64 synthetic
    frames, batch 2, 4 iterations, a constant learning rate."""
    return ExperimentConfig.from_dict({
        "name": "raft_anytime",
        "model": {"variant": "raft",
                  "encoder_channels": [8, 12, 16, 16, 16, 16],
                  "raft_fdim": 16, "raft_hdim": 12, "raft_cdim": 8,
                  "raft_corr_levels": 2, "raft_radius": 2, "raft_iters": 4},
        "data": {"dataset": "synthetic", "hw": [64, 64], "batch_size": 2,
                 "num_workers": 1, "synthetic_length": 2, "shuffle": False},
        "optim": {"lr": 1e-3, "schedule": "constant", "total_steps": 1000},
        "train": {"epochs": 1, "log_every": 1000, "num_data_devices": 1},
    })


@torch.no_grad()
def anytime(cfg: ExperimentConfig, state: dict, inputs, iters=ITERS,
            device="cpu") -> dict:
    """{k: the outputs of ``cfg``'s model built at k iterations, loaded
    from ``state``, on ``inputs``} for each k of ``iters``."""
    out = {}
    for k in iters:
        model, _ = build_model(dataclasses.replace(cfg.model, raft_iters=k),
                               None, cfg.model.torch_dtype)
        model.load_state_dict(state)
        out[k] = model.to(device).eval()(*inputs)
    return out


def main(device="cuda") -> dict:
    """Trains, then returns {iterations: full-resolution EPE}."""
    trainer = Trainer(config(), device=device)
    batch = batches(trainer.dataset, 2, 1)[0]
    print(f"training {TRAIN_STEPS} steps at iters=4 ...")
    for step in range(TRAIN_STEPS):
        comps = trainer.train_step(dict(batch))
        if step % 5 == 0:
            print(f"  step {step}: flow seq loss {float(comps['flow']):.4f}")

    prep = preprocess(batch, trainer.config.data.hw, trainer.dtype,
                      trainer.device)
    outs = anytime(trainer.config, trainer.model.state_dict(),
                   (prep["left"], prep["temporal"]), device=trainer.device)
    gt = np.asarray(batch["flow_gt"])
    epe = {}
    for iters, out in outs.items():
        flow = out["flow"].float().cpu().numpy()
        epe[iters] = float(np.sqrt(((flow - gt) ** 2).sum(-1)).mean())
        print(f"inference iters={iters}: full-res EPE {epe[iters]:.3f} px")
    return epe


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
