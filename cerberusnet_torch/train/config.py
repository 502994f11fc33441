"""Experiment configuration: the port's copy of
``cerberusnet_tpu/train/config.py``.

The same dataclass tree, the same keys and the same defaults, so every
``configs/*.json`` parses unchanged (``ExperimentConfig.from_json``); an
unknown key raises ``ValueError`` as in the reference.

Parsing accepts every value. ``ExperimentConfig.check_supported()``, which
the ``Trainer`` calls, raises the reference's ``ValueError`` for a model
variant or a dataset it does not know; the port builds the model variants
in ``VARIANTS`` (``seg_head`` "fpn" or "aspp" for the joint models and
``seg``) and reads the datasets in ``DATASETS`` (``data.root``; Sintel's
pass ``data.render_pass``), with every loss term (``loss.rmi_weight``,
``photometric_weight``, ``smoothness_weight`` among them) and the
augmentation (``crop_hw``, ``scales``, ``flip_lr_prob``, ``brightness``,
``contrast``) and ``data.num_workers`` decode threads; ``train.tensorboard``
writes event files under ``ckpt_dir/tb``; ``train.qat`` (its ranges from
``qat_calib_batches`` batches) trains with fake-quantized convs and
``train.debug_nans`` stops at the first NaN; ``train.num_data_devices``
trains on that many ranks, one a card (``parallel/mesh.py``), and
``train.num_spatial_devices`` S splits each frame's rows over S of them,
for every variant and loss, at every H the reference runs there (the
bands may differ in height, ``parallel/mesh.py``). ``model.pallas_levels``
runs CerberusNet's first N encoder levels as fused kernels (K9) and
``model.pallas_grad`` selects their backward: ``"pallas"`` the
reverse-sweep kernel (K10), ``"xla"`` the plain convolutions recomputed;
the DCV and RAFT variants ignore both, as the reference does.
``model.fused`` (the PWC and DCV models), ``est_input``,
``distribute_outputs`` and ``upsample_impl`` (CerberusNet) choose the
decoders' arithmetic, which rounds otherwise in bf16
(``models/flow.py``); ``train.qat`` and
int8 export rebuild the model with ``fused`` False, as the reference
does. The RAFT variants (``raft``, ``raft_stereo``,
``cerberus_raft``) read the ``raft_*`` keys, ``raft_lookup`` choosing the
volume lookup (``"onehot"`` or ``"gather"``, the same function), and their
losses ``loss.seq_gamma``. Keys that only steer XLA's program in the
reference, with the same arithmetic and the same parameter tree whatever
their value, are accepted and have no effect here: ``corr_stack``,
``upfeat_impl`` (two lowerings of one rounding, ``models/flow.py``),
``batched_encoder``, ``s2d_stem``, ``stem_pad_channels``,
``s2d_levels`` (for CerberusNet each raises ``ValueError`` beside
``pallas_levels``, as the reference's encoder does), ``entry_grad``,
``raft_unroll`` (``nn.scan`` or an unrolled loop over one parameter tree)
and ``optim.flatten``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch

# model.variant values the port builds (train/trainer.py ``build_model``)
VARIANTS = ("cerberus", "flow", "stereo", "seg", "cerberus_dcv", "dcv_flow",
            "dcv_stereo", "raft", "raft_stereo", "cerberus_raft")
# data.dataset values the port reads (train/trainer.py ``_build_dataset``)
DATASETS = ("synthetic", "kitti", "cityscapes", "sintel", "flyingchairs",
            "flyingthings3d")


@dataclasses.dataclass
class ModelConfig:
    variant: str = "cerberus"
    encoder_channels: Tuple[int, ...] = (16, 32, 64, 96, 128, 196)
    num_classes: int = 19
    max_disp_full: int = 96
    flow_max_disp: int = 4
    est_channels: Tuple[int, ...] = (128, 128, 96, 64, 32)
    ctx_channels: Tuple[int, ...] = (128, 128, 128, 96, 64, 32)
    fpn_channels: int = 96
    seg_head: str = "fpn"
    # None: the CUDA kernels on a GPU. "pallas" and "pallas_wl" (the
    # reference's two Pallas layouts) mean the same here; "pure"/"purev"
    # (the reference's XLA formulations) and "plain" run the plain torch
    # correlations.
    corr_impl: Optional[str] = None
    fused: bool = True
    corr_stack: str = "major"
    distribute_outputs: bool = True
    upfeat_impl: str = "subpixel"
    upsample_impl: str = "resize"
    batched_encoder: bool = True
    s2d_stem: bool = False
    stem_pad_channels: int = 0
    s2d_levels: int = 0
    entry_grad: str = "auto"
    pallas_levels: int = 0
    pallas_grad: str = "xla"
    est_input: str = "concat"
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    raft_iters: int = 12
    raft_radius: int = 4
    raft_fdim: int = 128
    raft_hdim: int = 96
    raft_cdim: int = 64
    raft_corr_levels: int = 4
    raft_level: int = 3
    raft_unroll: bool = False
    raft_lookup: str = "onehot"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def port_corr_impl(self) -> Optional[str]:
        """The port's ``impl`` for the correlations (see ``corr_impl``)."""
        return "plain" if self.corr_impl in ("pure", "purev", "plain") else None


@dataclasses.dataclass
class DataConfig:
    dataset: str = "synthetic"
    root: str = ""
    split: str = "training"
    render_pass: str = "clean"
    eval_split: Optional[str] = None
    hw: Tuple[int, int] = (512, 1024)
    batch_size: int = 4
    num_workers: int = 4
    shuffle: bool = True
    synthetic_length: int = 64
    synthetic_sparse: bool = False
    crop_hw: Optional[Tuple[int, int]] = None
    flip_lr_prob: float = 0.0
    brightness: float = 0.0
    contrast: float = 0.0
    scales: Tuple[float, ...] = ()


@dataclasses.dataclass
class OptimConfig:
    optimizer: str = "adamw"  # adamw | adam | sgd
    lr: float = 1e-4
    weight_decay: float = 4e-4
    schedule: str = "cosine"  # cosine | poly | onecycle | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0
    poly_power: float = 0.9
    accum_steps: int = 1
    flatten: bool = True
    ema_decay: float = 0.0
    grads_dtype: str = "float32"


@dataclasses.dataclass
class LossConfig:
    seg_weight: float = 1.0
    flow_weight: float = 1.0
    disp_weight: float = 1.0
    focal_gamma: Optional[float] = None
    robust_q: Optional[float] = None
    photometric_weight: float = 0.0
    smoothness_weight: float = 0.0
    rmi_weight: float = 0.0
    uncertainty_weighting: bool = False
    seq_gamma: float = 0.8

    @property
    def weights(self):
        return {"seg": self.seg_weight, "flow": self.flow_weight,
                "disp": self.disp_weight}


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 10
    seed: int = 0
    log_every: int = 50
    eval_every_epochs: int = 1
    ckpt_dir: str = ""
    resume: bool = True
    keep_checkpoints: int = 3
    ckpt_every_epochs: int = 1
    recover_on_nan: bool = False
    max_nan_recoveries: int = 3
    nan_recovery_reset_steps: int = 200
    num_data_devices: int = 0  # 0 = all visible devices
    num_spatial_devices: int = 1
    remat: bool = False
    debug_nans: bool = False
    # The reference forces its pure correlations; here the plain ones.
    interpret_kernels: bool = False
    tensorboard: bool = False
    qat: bool = False
    qat_calib_batches: int = 2


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "experiment"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_json(self, path: Optional[str] = None) -> str:
        """The config as indented JSON, written to ``path`` if given."""
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "ExperimentConfig":
        if path_or_str.lstrip().startswith("{"):
            raw = json.loads(path_or_str)
        else:
            with open(path_or_str) as f:
                raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "ExperimentConfig":
        def build(dc, d):
            names = {f.name for f in dataclasses.fields(dc)}
            kwargs = {}
            for k, v in d.items():
                if k not in names:
                    raise ValueError(
                        f"unknown config key {k!r} for {dc.__name__}")
                kwargs[k] = tuple(v) if isinstance(v, list) else v
            return dc(**kwargs)

        known = {"name", "model", "data", "optim", "loss", "train"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"unknown top-level config section(s) {sorted(unknown)} "
                f"(expected {sorted(known)})")
        return cls(
            name=raw.get("name", "experiment"),
            model=build(ModelConfig, raw.get("model", {})),
            data=build(DataConfig, raw.get("data", {})),
            optim=build(OptimConfig, raw.get("optim", {})),
            loss=build(LossConfig, raw.get("loss", {})),
            train=build(TrainConfig, raw.get("train", {})),
        )

    def check_supported(self):
        """Raises the reference's ValueError for an unknown model variant
        or dataset, for CerberusNet's fused levels beside the s2d knobs
        and for an unknown ``optim.grads_dtype``."""
        m, d, o = self.model, self.data, self.optim
        if m.variant == "cerberus" and m.pallas_levels and (
                m.s2d_levels or m.s2d_stem or m.stem_pad_channels):
            raise ValueError("model.pallas_levels is mutually exclusive with "
                             "s2d_stem, stem_pad_channels and s2d_levels")
        if o.grads_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"optim.grads_dtype must be 'float32' or 'bfloat16', "
                f"got {o.grads_dtype!r}")
        if m.variant not in VARIANTS:
            raise ValueError(f"unknown model variant {m.variant!r}")
        if d.dataset not in DATASETS:
            raise ValueError(f"unknown dataset {d.dataset!r}")
