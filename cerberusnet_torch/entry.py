"""Entry points: serving a joint model at default widths, and training.

``entry(variant=...)`` builds the joint model, ``"cerberus"``
(``CerberusNet``, the default) or ``"cerberus_dcv"`` (``CerberusDCV``), at
the reference's default widths with seeded random weights and returns
``(forward, example_inputs)``: the forward takes (left, right, temporal)
NHWC frames and returns the model's output dict. For CerberusNet,
``pallas_levels=N`` runs the encoder's first N levels as fused kernels.

``train_entry()`` reads an experiment config (``configs/*.json``, any
variant the port builds) and returns ``(trainer, batches)``: a ``Trainer``
and batches of its synthetic dataset, ready for
``trainer.train_step(batch)``.

Both run on the GPU unless the caller asks for ``device="cpu"``; with no
CUDA device they raise rather than carry on on the CPU.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from cerberusnet_torch.data.loader import batches
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.dcv_flow import CerberusDCV
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import init_params

REPO_ROOT = Path(__file__).resolve().parent.parent
SERVED = {"cerberus": CerberusNet, "cerberus_dcv": CerberusDCV}


def make_frames(seed: int, hw=(512, 1024), device="cuda",
                dtype: torch.dtype = torch.bfloat16):
    """A (left, right, temporal) triple of unit-normal (1, H, W, 3) frames,
    drawn on the CPU from ``seed`` so every device sees the same values."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(
        torch.randn((1, *hw, 3), generator=gen).to(device=device,
                                                       dtype=dtype)
        for _ in range(3))


def entry(device="cuda", dtype: torch.dtype = torch.bfloat16, hw=(512, 1024),
          seed: int = 0, corr_impl: str | None = None,
          variant: str = "cerberus", pallas_levels: int = 0):
    """Returns (forward, example_inputs) for the default-width model of
    ``variant`` ("cerberus" or "cerberus_dcv"). ``pallas_levels`` runs
    CerberusNet's first N encoder levels as fused kernels."""
    if variant not in SERVED:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{tuple(SERVED)}")
    fused = {}
    if pallas_levels:
        if variant != "cerberus":
            raise ValueError(f"pallas_levels is CerberusNet's; {variant!r} "
                             f"has no fused encoder levels")
        fused = dict(pallas_levels=pallas_levels)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the model on the CPU")
    model = SERVED[variant](corr_impl=corr_impl, dtype=dtype, **fused)
    init_params(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()

    @torch.inference_mode()
    def forward(left, right, temporal):
        return model(left, right, temporal)

    return forward, make_frames(seed, hw, device=device, dtype=dtype)


def train_entry(config_path="configs/cerberus_synthetic.json",
                batch_size: int = 2, device="cuda",
                corr_impl: str | None = None, n_batches: int = 1,
                **overrides):
    """Returns (trainer, batches) for the experiment in ``config_path`` (a
    path relative to the repository root, or absolute).

    ``batch_size`` replaces ``data.batch_size``; ``corr_impl="plain"`` runs
    the plain correlations (a yardstick for the kernels); each keyword in
    ``overrides`` names a config section and maps keys to new values, e.g.
    ``optim={"schedule": "constant"}``. The batches are the first
    ``n_batches`` of the trainer's synthetic dataset, as numpy dicts."""
    with open(REPO_ROOT / config_path) as f:
        raw = json.load(f)
    for section, values in overrides.items():
        raw[section] = {**raw.get(section, {}), **values}
    raw["data"] = {**raw.get("data", {}), "batch_size": batch_size}
    if corr_impl is not None:
        raw["model"] = {**raw.get("model", {}), "corr_impl": corr_impl}
    trainer = Trainer(ExperimentConfig.from_dict(raw), device=device)
    return trainer, batches(trainer.dataset, batch_size, n_batches)
