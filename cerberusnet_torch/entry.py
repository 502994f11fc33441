"""Entry points: serving a joint model at default widths, and training.

``entry(variant=...)`` builds a model at the reference's default widths
with seeded random weights and returns ``(forward, example_inputs)``: the
joint ``"cerberus"`` (``CerberusNet``, the default), ``"cerberus_dcv"``
(``CerberusDCV``) or ``"cerberus_raft"`` (``CerberusRAFT``), or the
single-task ``"flow"`` (``FlowNet``), ``"stereo"`` (``StereoNet``) or
``"seg"`` (``SegNet``). The forward takes (left, right, temporal) NHWC
frames, gives the model the ones it reads (flow: left, temporal; stereo:
left, right; seg: left) and returns its output dict. ``seg_head`` ("fpn"
or "aspp") is the segmentation head of the joint models and SegNet. For
CerberusNet, ``pallas_levels=N`` runs the encoder's first N levels as
fused kernels; for CerberusRAFT, ``raft_level``, ``raft_iters`` and
``raft_lookup`` set its operating level (3, or 4 at the deploy point of
``configs/raft_lv4_deploy.json``), its iterations and its volume lookup.

``train_entry()`` reads an experiment config (``configs/*.json``, any
variant and dataset the port takes; a KITTI or Cityscapes config needs
``data={"root": ...}``) and returns ``(trainer, batches)``: a ``Trainer``
and batches of its dataset, ready for ``trainer.train_step(batch)``.

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
from cerberusnet_torch.models.disparity import StereoNet
from cerberusnet_torch.models.flow import FlowNet
from cerberusnet_torch.models.raft import CerberusRAFT
from cerberusnet_torch.models.segmentation import SegNet
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import init_params

REPO_ROOT = Path(__file__).resolve().parent.parent
FRAMES = ("left", "right", "temporal")
# variant: (model, the frames its forward takes, in order)
SERVED = {"cerberus": (CerberusNet, FRAMES),
          "cerberus_dcv": (CerberusDCV, FRAMES),
          "cerberus_raft": (CerberusRAFT, FRAMES),
          "flow": (FlowNet, ("left", "temporal")),
          "stereo": (StereoNet, ("left", "right")),
          "seg": (SegNet, ("left",))}
SEGMENTING = ("cerberus", "cerberus_dcv", "cerberus_raft", "seg")


def make_frames(seed: int, hw=(512, 1024), device="cuda",
                dtype: torch.dtype = torch.bfloat16, batch: int = 1):
    """A (left, right, temporal) triple of unit-normal (batch, H, W, 3)
    frames, drawn on the CPU from ``seed`` so every device sees the same
    values."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(
        torch.randn((batch, *hw, 3), generator=gen).to(device=device,
                                                           dtype=dtype)
        for _ in range(3))


def entry(device="cuda", dtype: torch.dtype = torch.bfloat16, hw=(512, 1024),
          seed: int = 0, corr_impl: str | None = None,
          variant: str = "cerberus", pallas_levels: int = 0,
          raft_level: int = 3, raft_iters: int = 12,
          raft_lookup: str = "onehot", seg_head: str = "fpn",
          model_kw: dict | None = None):
    """Returns (forward, example_inputs) for the default-width model of
    ``variant`` (a key of ``SERVED``). ``pallas_levels`` runs
    CerberusNet's first N encoder levels as fused kernels; ``raft_level``,
    ``raft_iters`` and ``raft_lookup`` are CerberusRAFT's, which has no
    correlation kernel (``corr_impl``), nor has SegNet; ``seg_head`` is
    the segmentation head of the models in ``SEGMENTING``; ``model_kw``
    gives the model's constructor other widths (the tests' narrow models)
    or arithmetic (``{"fused": False}``: the naive estimators beside the
    reference's default fused ones).
    ``forward.model`` is the module it serves."""
    if variant not in SERVED:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{tuple(SERVED)}")
    if pallas_levels and variant != "cerberus":
        raise ValueError(f"pallas_levels is CerberusNet's; {variant!r} "
                         f"has no fused encoder levels")
    if seg_head != "fpn" and variant not in SEGMENTING:
        raise ValueError(f"{variant!r} has no segmentation head: seg_head "
                         f"does not apply")
    kw = {"seg_head": seg_head} if variant in SEGMENTING else {}
    if variant in ("cerberus_raft", "seg"):
        if corr_impl is not None:
            raise ValueError(f"{variant!r} has no correlation kernel: "
                             "corr_impl does not apply")
    else:
        kw["corr_impl"] = corr_impl
    if variant == "cerberus_raft":
        kw.update(level=raft_level, iters=raft_iters, lookup_impl=raft_lookup)
    if pallas_levels:
        kw["pallas_levels"] = pallas_levels
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the model on the CPU")
    cls, takes = SERVED[variant]
    model = cls(dtype=dtype, **kw, **(model_kw or {}))
    init_params(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()

    @torch.inference_mode()
    def forward(left, right, temporal):
        frames = dict(zip(FRAMES, (left, right, temporal)))
        return model(*[frames[k] for k in takes])

    forward.model = model
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
    ``n_batches`` of the trainer's dataset, as numpy dicts."""
    with open(REPO_ROOT / config_path) as f:
        raw = json.load(f)
    for section, values in overrides.items():
        raw[section] = {**raw.get(section, {}), **values}
    raw["data"] = {**raw.get("data", {}), "batch_size": batch_size}
    if corr_impl is not None:
        raw["model"] = {**raw.get("model", {}), "corr_impl": corr_impl}
    trainer = Trainer(ExperimentConfig.from_dict(raw), device=device)
    return trainer, batches(trainer.dataset, batch_size, n_batches)
