"""Helpers that pair the JAX package's parameter trees with the port's,
shared by the port's tests and by ``scripts/raft_bf16_grad_spread.py``:
copies of a JAX tree, the port's masters from one, random flax parameters
at realistic scales, and the tiny ``cerberus_raft`` experiment."""

import jax
import numpy as np
import torch

from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import UNCERTAINTY, build_model
from cerberusnet_torch.weights import load_flax_params

TINY_RAFT = dict(encoder_channels=(8, 12, 16, 16, 16, 16), fdim=16, hdim=16,
                 cdim=8, iters=3)
RAFT_HW = (64, 64)


def numpy_tree(tree):
    """Copies of a JAX tree's leaves (a donated buffer is reused)."""
    return jax.tree.map(np.array, tree)


def port_masters(cfg: ExperimentConfig, params) -> dict:
    """The port's masters (name -> float32 tensor) from a JAX trainer's
    parameter tree, log-variances included."""
    params = dict(params)
    log_vars = params.pop("__task_uncertainty__", {})
    ref, _ = build_model(cfg.model, "plain", torch.float32)
    load_flax_params(ref, params)
    out = {n: p.detach().clone() for n, p in ref.named_parameters()}
    out.update({f"{UNCERTAINTY}.{k}": torch.from_numpy(
        np.asarray(v, np.float32)) for k, v in log_vars.items()})
    return out


def draw_params(shapes, seed):
    """Random values for a flax tree of the leaves' shapes, at realistic
    scales: kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.asarray(0.1 * rng.randn(*leaf.shape), np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def raft_config_dict():
    """configs/cerberus_raft.json at tiny widths and size (float32, batch
    2, 64x64): its variant, one-cycle schedule and sequence gamma."""
    return {
        "name": "tiny-raft",
        "model": {"variant": "cerberus_raft", "fpn_channels": 16,
                  "encoder_channels": list(TINY_RAFT["encoder_channels"]),
                  "raft_fdim": 16, "raft_hdim": 16, "raft_cdim": 8,
                  "raft_iters": 3, "raft_radius": 4},
        "data": {"dataset": "synthetic", "hw": list(RAFT_HW), "batch_size": 2,
                 "synthetic_length": 2, "shuffle": False},
        "optim": {"optimizer": "adamw", "lr": 2e-3, "schedule": "onecycle",
                  "total_steps": 20, "grad_clip": 1.0},
        "loss": {"seq_gamma": 0.8},
        "train": {"num_data_devices": 1},
    }
