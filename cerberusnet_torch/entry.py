"""Entry points: serving a joint model at default widths, and training.

``entry(variant=...)`` builds the joint model, ``"cerberus"``
(``CerberusNet``, the default), ``"cerberus_dcv"`` (``CerberusDCV``) or
``"cerberus_raft"`` (``CerberusRAFT``), at the reference's default widths
with seeded random weights and returns ``(forward, example_inputs)``: the
forward takes (left, right, temporal) NHWC frames and returns the model's
output dict. For CerberusNet, ``pallas_levels=N`` runs the encoder's first
N levels as fused kernels; for CerberusRAFT, ``raft_level``,
``raft_iters`` and ``raft_lookup`` set its operating level (3, or 4 at the
deploy point of ``configs/raft_lv4_deploy.json``), its iterations and its
volume lookup.

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
from cerberusnet_torch.models.raft import CerberusRAFT
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import init_params

REPO_ROOT = Path(__file__).resolve().parent.parent
SERVED = {"cerberus": CerberusNet, "cerberus_dcv": CerberusDCV,
          "cerberus_raft": CerberusRAFT}


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
          variant: str = "cerberus", pallas_levels: int = 0,
          raft_level: int = 3, raft_iters: int = 12,
          raft_lookup: str = "onehot"):
    """Returns (forward, example_inputs) for the default-width model of
    ``variant`` ("cerberus", "cerberus_dcv" or "cerberus_raft").
    ``pallas_levels`` runs CerberusNet's first N encoder levels as fused
    kernels; ``raft_level``, ``raft_iters`` and ``raft_lookup`` are
    CerberusRAFT's, which has no correlation kernel (``corr_impl``)."""
    if variant not in SERVED:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{tuple(SERVED)}")
    if pallas_levels and variant != "cerberus":
        raise ValueError(f"pallas_levels is CerberusNet's; {variant!r} "
                         f"has no fused encoder levels")
    if variant == "cerberus_raft":
        if corr_impl is not None:
            raise ValueError("CerberusRAFT has no correlation kernel: "
                             "corr_impl does not apply")
        kw = dict(level=raft_level, iters=raft_iters, lookup_impl=raft_lookup)
    else:
        kw = dict(corr_impl=corr_impl)
        if pallas_levels:
            kw["pallas_levels"] = pallas_levels
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the model on the CPU")
    model = SERVED[variant](dtype=dtype, **kw)
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
