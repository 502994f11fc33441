"""The trainer, port of ``cerberusnet_tpu/train/trainer.py``
(``build_optimizer`` and ``Trainer``: the train step, ``fit``, evaluation,
EMA, gradient accumulation, bf16 gradients, checkpoints and NaN recovery).

A step: preprocess the batch on the device, run the model in its compute
type, ``joint_loss`` (with ``loss.uncertainty_weighting``, Kendall's
weighting by three learned float32 log-variances), backward (through the
correlation kernels' backward on a GPU), upcast the gradients to float32,
clip them by their global norm, update float32 master weights, and copy
the masters into the model. The masters live here, not in the model: the
serving model holds bf16 parameters (the classifier float32), and an
update of 1e-4 vanishes in bf16 rounding. This is what the reference does with flax's float32
parameters and bf16 compute: its gradient of a float32 parameter is the
bf16 gradient of the cast, converted.

The model is ``build_model``'s for ``model.variant``: the joint
``CerberusNet``, ``CerberusDCV`` or ``CerberusRAFT`` (each with the
``seg_head`` "fpn" or "aspp"), or the single-task ``FlowNet``,
``StereoNet``, ``SegNet``, ``DCVFlowNet``, ``DCVStereoNet``,
``RAFTFlowNet`` or ``RAFTStereoNet`` (a RAFT model's losses are the
sequence losses over its iterates). The data is ``data.dataset``'s: the
synthetic set, or KITTI-2015 or Cityscapes under ``data.root``; a train
step augments its batch on the device (``data.crop_hw``, ``scales``,
``flip_lr_prob``, ``brightness``, ``contrast``) before ``preprocess``
resizes it to ``data.hw``, as the reference's does. ``Trainer.fit`` runs
the reference's epochs through the prefetching loader
(``data.num_workers`` decode threads), evaluates on ``data.eval_split``
with the EMA weights, logs to ``train_log.csv`` (and, with
``train.tensorboard``, to event files under ``ckpt_dir/tb``) and
checkpoints under ``train.ckpt_dir`` in the port's own format (one
``torch.save`` file per step; the reference's is Orbax's). Sintel,
FlyingChairs and FlyingThings3D (``data/flow_datasets.py``) are the other
datasets.

Evaluation and prediction, with the EMA weights when kept:
``evaluate_tta`` (multi-scale and mirrored test-time augmentation,
``eval/tta.py``), ``predict_to_dir`` (the held-out split's KITTI and
Cityscapes submission files at each batch's native size,
``eval/submission.py``) and ``predict_images`` (image files in, the raw
outputs, the benchmark PNGs and a panel out). ``import_torch_weights``
loads a PyTorch ``TorchCerberus`` checkpoint into the masters;
``profile`` writes a ``torch.profiler`` trace of a few train steps (the
reference's is an XProf trace).

Deployment: ``export`` writes the evaluation weights' inference graph as a
``torch.export`` artifact (``export/aot.py``), as a float graph, the
stacked signature or, with ``quant="int8"``, the int8 graph of
``quant/ptq.py``. ``train.qat`` trains with fake-quantized convs
(``quant/qat.py``) against fixed ranges; ``train.debug_nans`` runs the
steps and evaluations under ``DebugNans`` (``train/debug_nans.py``).

Data parallelism (``train.num_data_devices``, ``parallel/mesh.py``): one
process a rank, each holding its slice of every global batch of
``data.batch_size``, as the reference's ``data`` mesh axis shards it.
The losses and metrics are the global batch's, the gradients are
all-reduced, and every rank makes the same update; rank 0 alone writes.
The spatial axis (``train.num_spatial_devices`` S): each frame's rows are
split over S ranks, each running the model on its band with the halos of
``parallel/halo.py``; D x S ranks train with D = ``num_data_devices``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import itertools
import math
import os
import re
import time
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cerberusnet_torch.data import augment
from cerberusnet_torch.data import io as data_io
from cerberusnet_torch.data.cityscapes import CityscapesDataset
from cerberusnet_torch.data.encodings import resize_bilinear
from cerberusnet_torch.data.flow_datasets import (
    FlyingChairsDataset,
    FlyingThings3DDataset,
    SintelDataset,
)
from cerberusnet_torch.data.kitti import Kitti2015Dataset
from cerberusnet_torch.data.loader import (
    DataLoader,
    batches,
    pad_batch,
    preprocess,
    to_device,
)
from cerberusnet_torch.eval.submission import to_numpy, write_predictions
from cerberusnet_torch.eval.tta import tta_forward
from cerberusnet_torch.export.aot import (
    DeployOutputs,
    export_inference,
    save_exported,
)
from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.common import set_spatial
from cerberusnet_torch.models.dcv_flow import (
    CerberusDCV,
    DCVFlowNet,
    DCVStereoNet,
)
from cerberusnet_torch.models.disparity import StereoNet
from cerberusnet_torch.models.flow import FlowNet
from cerberusnet_torch.models.raft import (
    CerberusRAFT,
    RAFTFlowNet,
    RAFTStereoNet,
    keep_tied_float32,
)
from cerberusnet_torch.models.segmentation import SegNet
from cerberusnet_torch.parallel.mesh import (
    level_extents,
    make_mesh,
    shard_samples,
)
from cerberusnet_torch.quant import ptq, qat
from cerberusnet_torch.train import losses
from cerberusnet_torch.train.config import (
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
)
from cerberusnet_torch.train.debug_nans import DebugNans
from cerberusnet_torch.train.metrics import METRICS, MetricState
from cerberusnet_torch.utils import visualization as vis
from cerberusnet_torch.utils.tblogger import TBLogger
from cerberusnet_torch.weights import init_params, load_torch_cerberus

# ----------------------------------------------------------------- model


# the RAFT variants: (model, input keys)
RAFT_VARIANTS = {"raft": (RAFTFlowNet, ("left", "temporal")),
                 "raft_stereo": (RAFTStereoNet, ("left", "right")),
                 "cerberus_raft": (CerberusRAFT, ("left", "right", "temporal"))}


def build_model(cfg: ModelConfig, corr_impl: str | None,
                dtype: torch.dtype):
    """(model, input keys) for ``cfg.variant``, with the arguments the
    reference's ``build_model`` passes: the DCV models keep their default
    level, dilations and (stereo) max_disp, as there, the RAFT models take
    every ``raft_*`` key, the joint models and ``SegNet`` take
    ``seg_head``, and only CerberusNet's encoder takes ``pallas_levels``
    and ``pallas_grad`` (the RAFT models and ``SegNet`` have no
    correlation kernel, so no ``corr_impl`` either). The PWC and DCV
    models take ``fused``, and CerberusNet alone ``est_input``,
    ``distribute_outputs``, ``upfeat_impl`` and ``upsample_impl`` (the
    single-task ones keep their decoders' defaults, as there). The model's forward
    takes the batch's tensors under the input keys, in order, and returns
    the output dict of its heads."""
    common = dict(encoder_channels=tuple(cfg.encoder_channels),
                  est_channels=tuple(cfg.est_channels),
                  ctx_channels=tuple(cfg.ctx_channels), corr_impl=corr_impl,
                  dtype=dtype, fused=cfg.fused)
    seg = dict(num_classes=cfg.num_classes, fpn_channels=cfg.fpn_channels,
               seg_head=cfg.seg_head)
    if cfg.variant == "cerberus":
        return CerberusNet(max_disp_full=cfg.max_disp_full,
                           flow_max_disp=cfg.flow_max_disp,
                           pallas_levels=cfg.pallas_levels,
                           pallas_grad=cfg.pallas_grad,
                           est_input=cfg.est_input,
                           distribute_outputs=cfg.distribute_outputs,
                           upfeat_impl=cfg.upfeat_impl,
                           upsample_impl=cfg.upsample_impl, **seg,
                           **common), (
                               "left", "right", "temporal")
    if cfg.variant == "cerberus_dcv":
        return CerberusDCV(flow_max_disp=cfg.flow_max_disp, **seg,
                           **common), ("left", "right", "temporal")
    if cfg.variant == "flow":
        return FlowNet(max_disp=cfg.flow_max_disp, **common), (
            "left", "temporal")
    if cfg.variant == "stereo":
        return StereoNet(max_disp_full=cfg.max_disp_full, **common), (
            "left", "right")
    if cfg.variant == "seg":
        return SegNet(encoder_channels=tuple(cfg.encoder_channels),
                      dtype=dtype, **seg), ("left",)
    if cfg.variant == "dcv_flow":
        return DCVFlowNet(max_disp=cfg.flow_max_disp, **common), (
            "left", "temporal")
    if cfg.variant == "dcv_stereo":
        return DCVStereoNet(**common), ("left", "right")
    if cfg.variant in RAFT_VARIANTS:
        model, keys = RAFT_VARIANTS[cfg.variant]
        # the weights used at every iteration stay float32, so the
        # gradients of their uses sum in float32, as the reference's do
        return keep_tied_float32(model(
            encoder_channels=tuple(cfg.encoder_channels),
            level=cfg.raft_level, fdim=cfg.raft_fdim, hdim=cfg.raft_hdim,
            cdim=cfg.raft_cdim, corr_levels=cfg.raft_corr_levels,
            radius=cfg.raft_radius, iters=cfg.raft_iters,
            lookup_impl=cfg.raft_lookup, dtype=dtype,
            **(seg if model is CerberusRAFT else {}))), keys
    raise ValueError(f"unknown model variant {cfg.variant!r}")


def check_spatial_mesh(config: ExperimentConfig) -> tuple:
    """The reference's refusals of a spatial axis of S =
    ``train.num_spatial_devices`` ranks, before any rank or band is made:
    ValueError when S exceeds the coarsest pyramid level's H // 2^L rows
    (its ``Trainer``'s guard: a spatial rank would hold no row) or does not
    divide H (its ``shard_batch``'s ``device_put`` places H / S rows a
    device). Returns the frame's rows at each level (``level_extents``),
    which set the bands (``make_mesh``'s ``extents``)."""
    n = config.train.num_spatial_devices
    levels = len(config.model.encoder_channels)
    h = config.data.hw[0]
    if n > 1 and h // 2**levels < n:
        raise ValueError(
            f"train.num_spatial_devices={n} exceeds the coarsest pyramid "
            f"level's height {h // 2**levels} (input H {h} / 2^{levels}): "
            f"a spatial rank would hold no row of it; use H >= "
            f"{2**levels * n} or fewer spatial devices")
    if n > 1 and h % n:
        raise ValueError(
            f"data.hw[0]={h} rows split over train.num_spatial_devices={n}: "
            f"the global size of dimension 1 should be divisible by {n}, "
            f"but it is equal to {h}")
    return level_extents(h, levels)


# the reference's key for the log-variances in its parameter tree
UNCERTAINTY = "__task_uncertainty__"
TASKS = ("seg", "flow", "disp")


# ------------------------------------------------------------- schedules
#
# Each is the optax schedule of the same name as a function of the update
# count, which starts at 0: optax evaluates the schedule at the count of
# updates made so far, so warmup from 0 gives a learning rate of 0 (and no
# change, weight decay included) on the first update.


def _polynomial(init, end, power, steps, begin=0) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count - begin, 0), steps) / steps
        return (init - end) * frac**power + end

    return schedule


def _warmup_cosine(init, peak, warmup, total) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init, peak, warmup, total)."""
    decay_steps = total - warmup
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs total_steps > warmup_steps, got "
                         f"{total} and {warmup}")
    warm = _polynomial(init, peak, 1, warmup)

    def schedule(count):
        if count < warmup:
            return warm(count)
        c = min(count - warmup, decay_steps)
        return peak * 0.5 * (1 + math.cos(math.pi * c / decay_steps))

    return schedule


def _linear_onecycle(total, peak, pct_start=0.3, pct_final=0.85,
                     div_factor=25.0, final_div_factor=1e4):
    """optax.linear_onecycle_schedule(total, peak)."""
    bounds = (0, int(pct_start * total), int(pct_final * total), total)
    values = [peak / div_factor]
    for scale in (div_factor, 1.0 / div_factor, 1.0 / final_div_factor):
        values.append(values[-1] * scale)

    def schedule(count):
        if count >= bounds[-1]:
            return values[-1]
        for i in range(3):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return (values[i + 1] - values[i]) * pct + values[i]
        return 0.0

    return schedule


def build_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """The learning rate of each update, as ``build_optimizer`` of the
    reference builds it."""
    if cfg.schedule in ("cosine", "poly") and cfg.warmup_steps >= cfg.total_steps:
        raise ValueError(
            f"optim.warmup_steps ({cfg.warmup_steps}) must be < "
            f"optim.total_steps ({cfg.total_steps}) for the "
            f"{cfg.schedule!r} schedule (decay phase would be empty)")
    if cfg.schedule == "cosine":
        return _warmup_cosine(0.0, cfg.lr, cfg.warmup_steps, cfg.total_steps)
    if cfg.schedule == "onecycle":
        return _linear_onecycle(cfg.total_steps, cfg.lr)
    if cfg.schedule == "poly":
        return _polynomial(cfg.lr, cfg.lr * 1e-3, cfg.poly_power,
                           cfg.total_steps - cfg.warmup_steps,
                           begin=cfg.warmup_steps)
    return lambda count: cfg.lr


# ------------------------------------------------------------- optimizer


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw | adam | sgd)``
    over a list of float32 tensors, with the learning rate of
    ``build_schedule``.

    The update rules are torch.optim's, which equal optax's: AdamW's
    decoupled decay is scaled by the learning rate and applied to every
    tensor, biases included, and eps is added outside the square root of
    the bias-corrected second moment (b1 0.9, b2 0.999, eps 1e-8, as
    optax's defaults); Adam is the same without decay; SGD with momentum
    0.9 keeps t = g + 0.9 t and steps by -lr t, as ``optax.trace`` does.
    Clipping is optax's rule, not ``clip_grad_norm_``'s: the gradients are
    scaled by max_norm / norm only when norm >= max_norm, with no epsilon.
    ``flatten`` runs the same arithmetic on one raveled vector in the
    reference, so it needs nothing here."""

    def __init__(self, cfg: OptimConfig, params):
        self.params = list(params)
        self.schedule = build_schedule(cfg)
        self.grad_clip = cfg.grad_clip
        self.count = 0
        if cfg.optimizer == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=0.0,
                                         weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "adam":
            self.opt = torch.optim.Adam(self.params, lr=0.0)
        elif cfg.optimizer == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=0.0, momentum=0.9)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    @torch.no_grad()
    def step(self, grads):
        """One update of ``params`` by ``grads`` (float32, in order)."""
        if self.grad_clip:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            grads = [g * scale for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = float(self.schedule(self.count))
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        """torch.optim's state and the update count (the schedule's)."""
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.opt.load_state_dict(state["opt"])
        self.count = state["count"]


# --------------------------------------------------------------- trainer

# a checkpoint's file name under train.ckpt_dir, by its step
_CKPT = re.compile(r"ckpt_(\d+)\.pt")


class Trainer:
    """``Trainer(config, device="cuda")``: the model of ``model.variant``
    in the config's compute type on ``device``, seeded weights (flax's
    initialisers, ``train.seed``), float32 masters and the optimizer over
    them, the training dataset (``data.split``) and, with
    ``data.eval_split``, the held-out one. Without a CUDA device it raises
    unless ``device="cpu"``. With ``train.ckpt_dir`` and ``train.resume``
    it restores the newest checkpoint there.

    With ``loss.uncertainty_weighting`` three float32 log-variances,
    ``__task_uncertainty__.seg``, ``.flow`` and ``.disp``, start at 0 and
    are masters beside the model's, as the reference keeps them in its
    parameter tree: they count in the clip's global norm, AdamW's decay
    applies to them, and the EMA and checkpoints hold them.

    ``optim.ema_decay`` keeps float32 copies of the masters, moved after
    every ``train_step`` as ``optax.incremental_update``; evaluation and
    the panels run them in the model and put the masters back.
    ``optim.accum_steps`` = k keeps the running mean of the gradients and
    clips and updates once every k calls (``optax.MultiSteps``): the
    schedule counts updates, the EMA and ``step`` count calls.
    ``optim.grads_dtype="bfloat16"`` differentiates with respect to a bf16
    cast of every float32 leaf (the classifier of a bf16 model, every
    parameter of a float32 one, the log-variances), as the reference does.
    ``train.remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` of the loss), so
    the forward kernels launch twice a step.

    ``train.qat``, as the reference's: the activation ranges are
    calibrated (``ptq.calibrate`` on ``train.qat_calib_batches`` batches)
    on the weights the trainer starts from, restored or imported, and stay
    fixed; every forward of the trainer (the loss, evaluation, TTA, the
    panels) runs the convs fake-quantized against them. CerberusNet's
    fused levels rebuild as plain ones (``model.pallas_levels`` becomes 0
    in the config, as there) and the fused estimators as the naive ones
    (``model.fused`` becomes False, as there): the fake quantization
    replaces the convs' forwards, which neither fused form calls.
    ``train.debug_nans`` raises ``FloatingPointError`` at the first
    operator that outputs a NaN in a step (forward, backward, update) or
    an evaluation forward.

    Data parallelism: the trainer is one rank of ``self.mesh``
    (``make_mesh(train.num_data_devices, device)``: the process group it
    runs in, one process a mesh of one; "cuda" a card a rank). Rank r
    trains on rows [r B/N, (r+1) B/N) of each global batch of B =
    ``data.batch_size``: its loader decodes only those, and ``train_step``
    and ``loss_and_grads`` take this rank's slice (``shard_samples``). Each
    step draws the global batch's augmentation from the same generator on
    every rank and keeps its rows of the draws; the losses reduce over the
    global batch (``losses.joint_loss``'s ``mesh``), so the loss components
    a step returns are the global ones on every rank; the float32
    gradients are all-reduced (a mean: ``parallel/mesh.py``'s convention),
    also under bf16 gradients, before clipping, accumulation, the update
    and the EMA, which every rank makes alike. ``evaluate`` sums the
    ranks' metric states. Rank 0 alone writes checkpoints,
    ``train_log.csv``, TensorBoard, the panels, exports and predictions;
    every rank restores the same checkpoint after a barrier. With more
    than one rank CerberusNet's fused levels are off
    (``model.pallas_levels`` becomes 0), as the reference turns them off
    under a data mesh of more than one device.

    The spatial axis: with ``train.num_spatial_devices`` S > 1 the mesh is
    D x S ranks, D = ``num_data_devices``, and rank (d, s) holds data
    shard d's samples and its band s of the rows of every map, the
    coarsest level's rows split as evenly as they go, the first ones a row
    taller where they do not divide, and each finer level's band the rows
    under the coarser band at the frame's "SAME" extents
    (``parallel/mesh.py``; ``set_spatial``: the model's modules take their halos from the
    neighbouring bands). The loader decodes shard d's samples, whole
    frames; a step augments and preprocesses them, then keeps its band
    (``DataMesh.band``); the losses, gradients and metrics are the global
    batch's over the whole frame. ``evaluate_tta`` (whose resizes need the
    whole frame) runs whole frames on every rank and counts spatial rank
    0's; the forwards rank 0 makes alone (panels, predictions) and QAT's
    calibration run whole frames. An H whose coarsest level has fewer rows
    than S, or that S does not divide, raises ValueError
    (``check_spatial_mesh``), as the reference."""

    def __init__(self, config: ExperimentConfig, device="cuda"):
        config.check_supported()
        extents = check_spatial_mesh(config)
        if config.train.qat:
            config.model.pallas_levels = 0
            config.model.fused = False
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to train on the CPU")
        self.mesh = make_mesh(config.train.num_data_devices, device,
                              config.train.num_spatial_devices,
                              extents=extents)
        if self.mesh.size > 1 and config.model.pallas_levels:
            config.model.pallas_levels = 0
        device = self.mesh.device
        self.config = config
        self.device = device
        m, d = config.model, config.data
        # interpret_kernels forces the reference's pure correlations; here
        # the plain ones
        self.corr_impl = ("plain" if config.train.interpret_kernels
                          else m.port_corr_impl)
        self.dtype = m.torch_dtype
        self.dataset = self._build_dataset(d.split)
        self.eval_dataset = (self._build_dataset(d.eval_split)
                             if d.eval_split else None)

        self.augment_config = augment.AugmentConfig(
            crop_hw=tuple(d.crop_hw) if d.crop_hw else None,
            flip_lr_prob=d.flip_lr_prob, brightness=d.brightness,
            contrast=d.contrast, scales=tuple(d.scales))
        # the augmentation's draws, seeded as the reference's key
        self.augment_generator = torch.Generator().manual_seed(
            config.train.seed + 1)

        self.model, self.input_keys = build_model(m, self.corr_impl,
                                                  self.dtype)
        self.model = set_spatial(self.model.to(device).train(), self.mesh)
        params = dict(self.model.named_parameters())
        # the log-variances are leaves of the loss, as the model's
        # parameters are, with masters of their own
        self.log_vars = {}
        if config.loss.uncertainty_weighting:
            self.log_vars = {t: torch.zeros((), device=device,
                                            requires_grad=True)
                             for t in TASKS}
            for t, s in self.log_vars.items():
                params[f"{UNCERTAINTY}.{t}"] = s
        self.names = list(params)
        self._params = [params[n] for n in self.names]
        self.masters = self._initial_masters()
        self.history: list = []
        self._start()
        if config.train.ckpt_dir and config.train.resume:
            self._maybe_restore()
        self._qat_ema = (self._calibrate_qat_ranges() if config.train.qat
                         else None)

    def _build_dataset(self, split):
        """``data.dataset``'s split: the synthetic one (seed 1 for "val"),
        or KITTI-2015, Cityscapes, Sintel (``data.render_pass``),
        FlyingChairs or FlyingThings3D under ``data.root``."""
        d = self.config.data
        if d.dataset == "synthetic":
            return SyntheticPerceptionDataset(
                length=d.synthetic_length, hw=tuple(d.hw),
                # labels in the model's class range
                num_classes=self.config.model.num_classes,
                sparse=d.synthetic_sparse, seed=1 if split == "val" else 0)
        if d.dataset == "kitti":
            return Kitti2015Dataset(d.root, split)
        if d.dataset == "cityscapes":
            return CityscapesDataset(d.root, split)
        if d.dataset == "sintel":
            return SintelDataset(d.root, split, render_pass=d.render_pass)
        if d.dataset == "flyingchairs":
            return FlyingChairsDataset(d.root, split)
        if d.dataset == "flyingthings3d":
            return FlyingThings3DDataset(d.root, split)
        raise ValueError(f"unknown dataset {d.dataset!r}")

    def _loader(self, dataset, batch_size, sharded=True, **kw):
        """A DataLoader of ``dataset`` with ``data.num_workers`` decode
        threads, page-locked on a GPU; ``sharded``: this rank's rows of
        each global batch, else every sample."""
        return DataLoader(dataset, batch_size,
                          num_workers=self.config.data.num_workers,
                          pin_memory=self.device.type == "cuda",
                          **({"mesh": self.mesh} if sharded else {}), **kw)

    @property
    def writer(self) -> bool:
        """Whether this process writes files: rank 0's."""
        return self.mesh.rank == 0

    # -- weights -----------------------------------------------------------

    def _initial_masters(self) -> dict:
        """The float32 masters ``train.seed`` draws: the model's (on the
        CPU, so any device gets the same values) and log-variances of 0."""
        ref, _ = build_model(self.config.model, self.corr_impl, torch.float32)
        init_params(ref, torch.Generator().manual_seed(self.config.train.seed))
        masters = {n: p.detach().to(self.device).clone()
                   for n, p in ref.named_parameters()}
        for t in self.log_vars:
            masters[f"{UNCERTAINTY}.{t}"] = torch.zeros((), device=self.device)
        return masters

    def _start(self):
        """A fresh optimizer over the masters, the EMA at the masters, no
        accumulated gradient, step 0, and the masters in the model."""
        o = self.config.optim
        self.optimizer = Optimizer(o, [self.masters[n] for n in self.names])
        self.ema = ({n: m.clone() for n, m in self.masters.items()}
                    if o.ema_decay > 0 else None)
        self._accum = None
        self._mini_step = 0
        self.step = 0
        self._sync(self.masters)

    @torch.no_grad()
    def load_masters(self, masters: dict):
        """Sets the float32 masters (name -> tensor, as ``self.masters``)
        and starts afresh from them: optimizer, EMA, accumulation, step."""
        for n in self.names:
            self.masters[n].copy_(masters[n])
        self._start()

    @torch.no_grad()
    def _sync(self, values: dict):
        """Copies ``values`` (the masters or the EMA) into the model and
        the log-variance leaves, in their types."""
        for p, n in zip(self._params, self.names):
            p.copy_(values[n])

    @contextlib.contextmanager
    def _eval_weights(self):
        """The EMA in the model (when kept) for the body, the masters back
        after it: a train step after an evaluation starts from the
        masters."""
        if self.ema is None:
            yield
            return
        self._sync(self.ema)
        try:
            yield
        finally:
            self._sync(self.masters)

    # -- steps -------------------------------------------------------------

    def _nan_check(self):
        """The ``DebugNans`` mode under ``train.debug_nans``."""
        return (DebugNans() if self.config.train.debug_nans
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def _whole_frames(self):
        """The model without the spatial axis for the body: a forward of
        whole frames on this rank alone (no halo exchange)."""
        if not self.mesh.banded:
            yield
            return
        set_spatial(self.model, None)
        try:
            yield
        finally:
            set_spatial(self.model, self.mesh)

    def _forward(self, batch):
        inputs = [batch[k] for k in self.input_keys]
        if self._qat_ema is None:
            return self.model(*inputs)
        with qat.qat_interception(self.model, self._qat_ema):
            return self.model(*inputs)

    def _calib_batches(self, batch_size: int, n: int) -> list:
        """The training dataset's first ``n`` batches (or as many as it
        has), preprocessed, as model-input tuples: QAT's ranges and int8
        export calibrate on them."""
        loader = DataLoader(self.dataset, batch_size, num_workers=1)
        out = []
        for b in itertools.islice(loader, n):
            prep = preprocess(b, self.config.data.hw, self.dtype, self.device)
            out.append(tuple(prep[k] for k in self.input_keys))
        return out

    def _calibrate_qat_ranges(self) -> dict:
        """QAT's fixed ranges: each conv's input absmax on the current
        weights, as ``qat.init_ema`` holds them."""
        batches_ = self._calib_batches(self.config.data.batch_size,
                                       self.config.train.qat_calib_batches)
        with self._whole_frames():
            scales = ptq.calibrate(self.model, batches_)
        print(f"[trainer] QAT: calibrated {len(scales)} conv ranges")
        return qat.init_ema(scales, self.device)

    def _loss_fn(self, batch):
        outputs = self._forward(batch)
        cfg = self.config.loss
        total, comps = losses.joint_loss(
            outputs, batch, weights=cfg.weights, focal_gamma=cfg.focal_gamma,
            robust_q=cfg.robust_q, photometric_weight=cfg.photometric_weight,
            smoothness_weight=cfg.smoothness_weight,
            rmi_weight=cfg.rmi_weight, seq_gamma=cfg.seq_gamma,
            mesh=self.mesh)
        if self.log_vars:
            log_vars = self.log_vars
            if self.config.optim.grads_dtype == "bfloat16":
                # the bf16 leaves of the reference: exp(-s) and 0.5 s in
                # bf16, the cast's backward upcasts their gradients
                log_vars = {t: s.to(torch.bfloat16)
                            for t, s in log_vars.items()}
            total = losses.uncertainty_weighted_total(comps, log_vars)
            comps = {**comps, "total": total}
        return total, comps

    def _augmented(self, batch):
        """The batch on the device, augmented by ``data``'s augmentation
        (when any) with the next draws of ``augment_generator``, before
        ``preprocess``, as the reference's ``train_step`` does: a crop is
        then resized to ``data.hw``. The draws are the global batch's on
        every rank (the generator moves alike), this rank keeping its
        rows."""
        batch = to_device(batch, self.device)
        cfg = self.augment_config
        if not cfg.enabled:
            return batch
        b, h, w = batch["left"].shape[:3]
        n = b * self.mesh.data_size
        draws = augment.draw(cfg, n, (h, w), self.augment_generator)
        draws = augment.shard_draws(draws, self.mesh.shard(n))
        return augment.apply(batch, draws, cfg)

    def loss_and_grads(self, batch):
        """Forward and backward on a batch as the dataset gives it (the
        augmentation, when configured, draws anew at each call); returns
        (loss components, {parameter name: float32 gradient}), the global
        batch's under data parallelism. Changes no weight."""
        with self._nan_check():
            comps, grads = self._rank_loss_and_grads(batch)
            self.mesh.mean_grads(list(grads.values()))
            return comps, grads

    def _rank_loss_and_grads(self, batch):
        """``loss_and_grads`` before the gradients' all-reduce: each
        rank's own gradients (N times its rows' share of the global batch's
        gradient under a mesh of N ranks). ``batch``: this rank's samples,
        whole frames; on a spatial mesh it keeps its band after
        preprocessing."""
        batch = self.mesh.band(preprocess(
            self._augmented(batch), self.config.data.hw, self.dtype,
            self.device))
        for p in self._params:
            p.grad = None
        bf16 = self.config.optim.grads_dtype == "bfloat16"
        # bf16 gradients: the float32 leaves hold their bf16 values for the
        # step (a float32 module computes in float32 on them, as flax
        # promotes a bf16 parameter to the module's type)
        rounded = [(p, n) for p, n in zip(self._params, self.names)
                   if bf16 and p.dtype == torch.float32]
        with torch.no_grad():
            for p, _ in rounded:
                p.copy_(p.to(torch.bfloat16))
        try:
            if self.config.train.remat:
                total, comps = checkpoint(self._loss_fn, batch,
                                          use_reentrant=False)
            else:
                total, comps = self._loss_fn(batch)
            total.backward()
        finally:
            with torch.no_grad():
                for p, n in rounded:
                    p.copy_(self.masters[n])
        grads = {}
        for n, p in zip(self.names, self._params):
            g = p.grad if p.grad is not None else torch.zeros_like(
                self.masters[n])
            grads[n] = (g.to(torch.bfloat16) if bf16 else g).float()
        return {k: v.detach() for k, v in comps.items()}, grads

    def apply_grads(self, grads: dict):
        """One call of the reference's optimizer: clips, updates the masters
        and copies them into the model; with ``optim.accum_steps`` = k,
        adds the gradients to the running mean and updates by it every k
        calls. Then moves the EMA and counts the step."""
        with torch.no_grad(), self._nan_check():
            self._apply_grads(grads)

    def _apply_grads(self, grads: dict):
        g = [grads[n] for n in self.names]
        k = self.config.optim.accum_steps
        if k > 1:
            if self._accum is None:
                self._accum = [torch.zeros_like(x) for x in g]
            # optax.MultiSteps' mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(g, self._accum)
            torch._foreach_div_(delta, self._mini_step + 1)
            torch._foreach_add_(self._accum, delta)
            self._mini_step = (self._mini_step + 1) % k
            if self._mini_step == 0:
                self.optimizer.step(self._accum)
                torch._foreach_zero_(self._accum)
                self._sync(self.masters)
        else:
            self.optimizer.step(g)
            self._sync(self.masters)
        if self.ema is not None:
            # optax.incremental_update(new, old, s): s new + (1 - s) old
            s = 1.0 - self.config.optim.ema_decay
            ema = [self.ema[n] for n in self.names]
            torch._foreach_mul_(ema, 1.0 - s)
            torch._foreach_add_(ema, torch._foreach_mul(
                [self.masters[n] for n in self.names], s))
        self.step += 1

    def train_step(self, batch):
        """One step; returns the loss components (device tensors, before
        the update), as the reference's ``train_step`` does."""
        comps, grads = self.loss_and_grads(batch)
        self.apply_grads(grads)
        return comps

    # -- evaluation --------------------------------------------------------

    def _prep_eval_batch(self, batch, sharded=True):
        """Pads a partial batch to ``data.batch_size`` (``sharded``: this
        rank's share of it), preprocesses it on the device and attaches the
        (B,) sample mask that keeps the padding out of the metrics. A
        data-parallel loader's batch comes padded, its mask under
        "_sample_mask". Whole frames, also on a spatial mesh."""
        batch = dict(batch)
        mask = batch.pop("_sample_mask", None)
        if mask is None:
            rows = self.mesh.data_size if sharded else 1
            batch, mask = pad_batch(batch, self.config.data.batch_size // rows)
        prep = preprocess(batch, self.config.data.hw, self.dtype, self.device)
        prep["_sample_mask"] = torch.as_tensor(mask).to(self.device)
        return prep

    def _eval_loader(self, loader=None, sharded=True):
        """``loader``, or else one over every sample of the held-out dataset
        (the training one without ``data.eval_split``), in order, the last
        batch partial (``sharded``: this rank's rows of each)."""
        if loader is not None:
            return loader
        return self._loader(self.eval_dataset or self.dataset,
                            self.config.data.batch_size, sharded=sharded,
                            drop_last=False)

    @torch.no_grad()
    def evaluate(self, loader=None):
        """Metrics (``MetricState.compute()``) of the EMA weights, or the
        masters without EMA, over ``loader`` or else every sample of the
        held-out dataset, the last batch padded and masked. Under data
        parallelism each rank runs its rows of each batch (a ``loader``
        given is this rank's) and the ranks' states are summed; on a
        spatial mesh each rank its band of them."""
        metrics = MetricState.zeros(self.config.model.num_classes,
                                    self.device)
        with self._eval_weights():
            for batch in self._eval_loader(loader):
                with self._nan_check():
                    prep = self.mesh.band(self._prep_eval_batch(batch))
                    out = self._forward(prep)
                metrics = metrics.update(out, prep)
        return metrics.summed(self.mesh).compute()

    @torch.no_grad()
    def evaluate_tta(self, scales=(0.75, 1.0, 1.25), flip: bool = True,
                     loader=None, per_class: bool = False):
        """``evaluate`` with multi-scale and mirrored test-time
        augmentation (``eval/tta.py``: each batch's predictions averaged
        over ``scales`` and, with ``flip``, their mirrored passes);
        ``per_class`` adds each class's IoU (``iou/<name>``). On a spatial
        mesh (the resizes need the whole frame) every rank runs whole
        frames of its samples and spatial rank 0's count."""
        metrics = MetricState.zeros(self.config.model.num_classes,
                                    self.device)
        with self._eval_weights(), self._whole_frames():
            for batch in self._eval_loader(loader):
                prep = self._prep_eval_batch(batch)
                out = tta_forward(self._forward,
                                  {k: prep[k] for k in self.input_keys},
                                  scales=tuple(scales), flip=flip)
                if self.mesh.spatial_rank == 0:
                    metrics = metrics.update(out, prep)
        return metrics.summed(self.mesh).compute(per_class=per_class)

    @torch.no_grad()
    def predict_to_dir(self, out_dir: str, loader=None):
        """The evaluation weights' predictions over ``loader`` or the
        held-out split as benchmark files under ``out_dir``
        (``eval/submission.py``: KITTI 16-bit flow and disparity PNGs,
        Cityscapes labelIds), named ``{index:06d}_10`` and resized to the
        batch's own (native) frame size; the rows that pad the last batch
        are dropped. Returns the files written; rank 0 alone writes (and
        runs) under data parallelism, the other ranks return []."""
        made, idx = [], 0
        if not self.writer:
            return made
        with self._eval_weights(), self._whole_frames():
            for batch in self._eval_loader(loader, sharded=False):
                n = len(batch["left"])
                native_hw = tuple(batch["left"].shape[1:3])
                out = self._forward(self._prep_eval_batch(batch,
                                                          sharded=False))
                out = {k: v[:n] for k, v in out.items()
                       if isinstance(v, torch.Tensor)}
                names = [f"{idx + i:06d}_10" for i in range(n)]
                idx += n
                made += write_predictions(out, out_dir, names,
                                          native_hw=native_hw)
        return made

    @torch.no_grad()
    def predict_images(self, paths: dict, out_dir: str, name: str = "sample"):
        """One sample's predictions from image files: ``paths`` maps each
        of the model's input keys (``input_keys``, e.g. left / right /
        temporal) to an image, resized to ``data.hw``. Writes the raw
        outputs (``<name>.npz``), the benchmark PNGs (``eval/submission.py``'s
        layout) and a panel (``<name>_panel.png``) under ``out_dir``;
        returns the files written (rank 0 alone writes; [] elsewhere)."""
        if not self.writer:
            return []
        missing = [k for k in self.input_keys if k not in paths]
        if missing:
            raise ValueError(
                f"variant {self.config.model.variant!r} needs images for "
                f"{missing} (got {sorted(paths)})")
        batch = {k: data_io.read_image_u8(paths[k])[None]
                 for k in self.input_keys}
        prep = preprocess(batch, self.config.data.hw, self.dtype, self.device)
        with self._eval_weights(), self._whole_frames():
            out = self._forward(prep)
        out = {k: to_numpy(v) for k, v in out.items()
               if isinstance(v, torch.Tensor)}
        os.makedirs(out_dir, exist_ok=True)
        npz_path = os.path.join(out_dir, f"{name}.npz")
        np.savez(npz_path, **{k: v[0] for k, v in out.items()})
        made = [npz_path] + write_predictions(out, out_dir, [name])
        panel_path = os.path.join(out_dir, f"{name}_panel.png")
        vis.write_png_u8(panel_path, self._panel(batch["left"], out))
        return made + [panel_path]

    def _panel(self, image, out):
        """The first sample's (H, W, 3) uint8 panel at ``data.hw``: the
        image (uint8 (B, H, W, 3), resized bilinearly when it has another
        size), then the segmentation overlay, flow and disparity of
        ``out``, as present."""
        image = torch.as_tensor(image[:1])
        if tuple(image.shape[1:3]) != tuple(self.config.data.hw):
            image = resize_bilinear(image.float(), self.config.data.hw).clamp(
                0, 255).to(torch.uint8)
        inputs = {"image": image[0].numpy()}
        if "seg_logits" in out:
            inputs["seg"] = to_numpy(out["seg_logits"][0]).argmax(-1)
        if "flow" in out:
            inputs["flow"] = to_numpy(out["flow"][0])
        if "disp" in out:
            inputs["disp"] = to_numpy(out["disp"][0, ..., 0])
        return vis.summary_panel(inputs)

    @torch.no_grad()
    def render_panel(self):
        """The predictions of the evaluation weights on the training
        dataset's first sample as an (H, W, 3) uint8 panel at ``data.hw``
        (``predict_images``'s panel)."""
        batch = next(iter(self._loader(self.dataset, 1, sharded=False)))
        prep = preprocess(batch, self.config.data.hw, self.dtype, self.device)
        with self._eval_weights(), self._whole_frames():
            out = self._forward(prep)
        return self._panel(batch["left"], out)

    def dump_visualization(self, path: str) -> str:
        """Writes ``render_panel()`` to ``path`` as a PNG."""
        return vis.write_png_u8(path, self.render_panel())

    # -- weights from elsewhere, and a trace ------------------------------

    @torch.no_grad()
    def import_torch_weights(self, path: str):
        """Loads a PyTorch checkpoint of the reference's ``TorchCerberus``
        mirror (a ``torch.save`` of its state_dict, bare or under
        "state_dict" or "model") into the masters at this config's widths,
        and into the EMA when kept, as the reference's import does; the
        optimizer and the step stay. The joint "cerberus" variant with the
        FPN head only, as there."""
        m = self.config.model
        if m.variant != "cerberus":
            raise ValueError("torch import maps the joint CerberusNet mirror; "
                             f"got variant {m.variant!r}")
        if m.seg_head != "fpn":
            raise ValueError("torch import maps the FPN seg head (the "
                             f"mirror's); got seg_head {m.seg_head!r}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("state_dict", "model"):
            if isinstance(sd, dict) and key in sd and not hasattr(
                    sd[key], "shape"):
                sd = sd[key]
        ref, _ = build_model(m, self.corr_impl, torch.float32)
        load_torch_cerberus(ref, sd)
        for n, p in ref.named_parameters():
            self.masters[n].copy_(p)
            if self.ema is not None:
                self.ema[n].copy_(p)
        self._sync(self.masters)
        print(f"[trainer] imported torch weights from {path}")
        if self._qat_ema is not None:
            # the ranges calibrated at construction saw other weights
            self._qat_ema = self._calibrate_qat_ranges()

    def profile(self, log_dir: str, steps: int = 5) -> str:
        """A ``torch.profiler`` trace (host and, on a GPU, device activity)
        of ``steps`` train steps on the training set's first batch, after
        one step outside the trace, written to ``log_dir/trace.json`` (by
        rank 0, each rank tracing its steps on its rows of the batch);
        returns its path. The steps update the weights."""
        batch = shard_samples(
            batches(self.dataset, self.config.data.batch_size, 1)[0],
            self.mesh)
        self.train_step(batch)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(steps):
                comps = self.train_step(batch)
            float(comps["total"])  # waits for the device
        path = os.path.join(log_dir, "trace.json")
        if self.writer:
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        return path

    # -- deployment --------------------------------------------------------

    def export(self, out_dir: str, batch: int = 1, quant: str | None = None,
               calib_batches: int = 2, quant_skip: tuple = (),
               stacked: bool = False) -> str:
        """Exports the evaluation weights (the EMA when kept, else the
        masters; not the log-variances) as a deployment artifact
        (``export/aot.py``): NHWC frames of ``batch`` at ``data.hw`` in the
        compute type in, (seg_logits, flow, disp) out, those the variant
        has. Every variant exports. Returns ``out_dir``.

        ``quant="int8"`` is the reference's TensorRT int8 build: the model
        rebuilt with plain encoder levels and naive estimators (its fused
        levels and fused estimators do not call the convs' forwards) is
        calibrated on ``calib_batches`` training
        batches of ``batch`` (or, after QAT, takes its trained ranges),
        quantized from the float32 weights with ``quant_skip`` left float
        and the float weights stripped, and exported with its int8 convs.

        ``stacked=True`` (CerberusNet only) exports the producer-stacked
        signature: one (3 batch, H, W, 3) input holding [left; right;
        temporal].

        Rank 0 alone exports under data parallelism; the other ranks
        return None."""
        if not self.writer:
            return None
        m = self.config.model
        if stacked and m.variant != "cerberus":
            raise ValueError("stacked export needs the 3-frame cerberus "
                             f"variant, got {m.variant!r}")
        model = self.deploy_model(quant, batch, calib_batches, quant_skip)
        h, w = self.config.data.hw
        n_inputs = len(self.input_keys)
        if stacked:
            model.stacked_input = True
            batch, n_inputs = 3 * batch, 1
        example = tuple(torch.zeros((batch, h, w, 3), dtype=self.dtype,
                                    device=self.device)
                        for _ in range(n_inputs))
        with (ptq.quant_interception(model) if quant
              else contextlib.nullcontext()):
            exported = export_inference(DeployOutputs(model), example)
        return save_exported(exported, out_dir)

    def deploy_model(self, quant: str | None = None, batch: int = 1,
                     calib_batches: int = 2, quant_skip: tuple = ()):
        """The model ``export`` exports, in evaluation mode: a new one of
        this config's with the evaluation weights and, with
        ``quant="int8"``, plain encoder levels, naive estimators
        (``fused=False``) and the ``quant`` entries
        (the float weights of the quantized convs stripped)."""
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {quant!r} (expected "
                             "'int8')")
        m = self.config.model
        model, _ = build_model(
            dataclasses.replace(m, pallas_levels=0, fused=False) if quant
            else m,
            self.corr_impl, self.dtype)
        model = model.to(self.device).eval()
        values = self.ema if self.ema is not None else self.masters
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(values[n])
        if not quant:
            return model
        kernels = {n[:-len(".weight")]: v for n, v in values.items()
                   if n.endswith(".weight")}
        if self._qat_ema is not None:
            # the ranges the weights trained against
            return qat.finalize(model, self._qat_ema, skip=quant_skip,
                                strip=True, weights=kernels)
        scales = ptq.calibrate(model, self._calib_batches(batch,
                                                          calib_batches))
        return ptq.quantize(model, scales, skip=quant_skip, strip=True,
                            weights=kernels)

    # -- checkpoints -------------------------------------------------------

    def _checkpoints(self) -> dict:
        """{step: path} of the checkpoints under ``train.ckpt_dir``."""
        d = self.config.train.ckpt_dir
        if not d or not os.path.isdir(d):
            return {}
        found = (_CKPT.fullmatch(name) for name in os.listdir(d))
        return {int(m.group(1)): os.path.join(d, m.group(0))
                for m in found if m}

    def save_checkpoint(self):
        """Writes the state at this step (masters, EMA, optimizer with its
        update count, accumulated gradients, step) to one file under
        ``train.ckpt_dir``, through a temporary file and ``os.replace``,
        and keeps the newest ``train.keep_checkpoints``. Returns its path,
        or None without a ``ckpt_dir``; rank 0 alone writes (None
        elsewhere), the ranks' states being equal."""
        d = self.config.train.ckpt_dir
        if not d or not self.writer:
            return None
        os.makedirs(d, exist_ok=True)
        state = {"step": self.step, "masters": self.masters, "ema": self.ema,
                 "optimizer": self.optimizer.state_dict(),
                 "accum": self._accum, "mini_step": self._mini_step}
        path = os.path.join(d, f"ckpt_{self.step:08d}.pt")
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        kept = sorted(self._checkpoints().items())
        for _, old in kept[:-self.config.train.keep_checkpoints]:
            os.remove(old)
        return path

    @torch.no_grad()
    def _maybe_restore(self):
        """Restores the newest checkpoint under ``train.ckpt_dir``; returns
        its step, or None when there is none. Every rank of a mesh calls it
        together: it waits for rank 0's writes first."""
        self.mesh.barrier()
        ckpts = self._checkpoints()
        if not ckpts:
            return None
        # on the CPU: the optimizer keeps its step counts there
        state = torch.load(ckpts[max(ckpts)], map_location="cpu",
                           weights_only=True)
        for n, m in self.masters.items():
            m.copy_(state["masters"][n])
        self._start()
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for n, e in self.ema.items():
                e.copy_(state["ema"][n])
        if state["accum"] is not None:
            self._accum = [a.to(self.device) for a in state["accum"]]
        self._mini_step = state["mini_step"]
        self.step = state["step"]
        print(f"[trainer] restored checkpoint at step {self.step}")
        return self.step

    # -- the loop ----------------------------------------------------------

    def fit(self):
        """``train.epochs`` epochs over the training dataset; returns the
        history, one row a epoch: epoch, step, epoch_seconds, the last
        step's loss components (``loss_*``) and, every
        ``train.eval_every_epochs``, the held-out metrics. With a
        ``ckpt_dir``: rows appended to its ``train_log.csv``, a
        ``predictions_epoch{e}.png`` panel at each evaluation, checkpoints
        every ``ckpt_every_epochs`` and at the last epoch. With
        ``recover_on_nan``, a non-finite loss rolls back to the newest
        checkpoint (to the seeded weights without one), up to
        ``max_nan_recoveries`` times within ``nan_recovery_reset_steps``
        healthy steps. Losses are read on the host only at ``log_every``, at
        an epoch's end and, under ``recover_on_nan``, every step. With
        ``train.tensorboard`` and a ``ckpt_dir``, an event file under
        ``ckpt_dir/tb`` gets the loss components at ``log_every``
        ("loss/..."), each epoch's row and, at each evaluation, the panel
        ("eval/panel"), where the reference logs them. Under data
        parallelism every rank runs the loop on its rows and keeps the same
        history; rank 0 alone prints and writes."""
        cfg = self.config
        t = cfg.train
        loader = self._loader(self.dataset, cfg.data.batch_size,
                              shuffle=cfg.data.shuffle, seed=t.seed)
        log_path = tb = None
        if t.ckpt_dir and self.writer:
            os.makedirs(t.ckpt_dir, exist_ok=True)
            log_path = os.path.join(t.ckpt_dir, "train_log.csv")
            if t.tensorboard:
                tb = TBLogger(os.path.join(t.ckpt_dir, "tb"))
        try:
            return self._fit(loader, log_path, tb)
        finally:
            if tb:
                tb.close()

    def _fit(self, loader, log_path, tb):
        cfg = self.config
        t = cfg.train
        nan_recoveries = 0
        steps_since_recovery = 0
        if t.recover_on_nan and t.ckpt_dir and not self._checkpoints():
            # a rollback point before the first step: an early divergence
            # must not silently restart from scratch
            print("[trainer] recover_on_nan: saving initial rollback "
                  "checkpoint")
            self.save_checkpoint()
        for epoch in range(t.epochs):
            t_epoch = time.time()
            comps = {}
            for i, batch in enumerate(loader):
                comps = self.train_step(batch)
                if t.recover_on_nan and not math.isfinite(
                        float(comps["total"])):
                    nan_recoveries += 1
                    steps_since_recovery = 0
                    if nan_recoveries > t.max_nan_recoveries:
                        raise RuntimeError(
                            f"loss non-finite after {nan_recoveries - 1} "
                            "checkpoint recoveries — aborting")
                    print(f"[trainer] non-finite loss at step {self.step}; "
                          f"restoring last checkpoint (recovery "
                          f"{nan_recoveries}/{t.max_nan_recoveries})")
                    self.load_masters(self._initial_masters())
                    if self._maybe_restore() is None:
                        print("[trainer] WARNING: no checkpoint to restore — "
                              "NaN recovery re-initialized from scratch at "
                              "step 0 (set train.ckpt_dir for real rollback)")
                    continue
                steps_since_recovery += 1
                if (nan_recoveries and t.nan_recovery_reset_steps
                        and steps_since_recovery
                        >= t.nan_recovery_reset_steps):
                    # a long healthy stretch forgets old transient NaNs
                    nan_recoveries = 0
                if (i + 1) % t.log_every == 0 and self.writer:
                    vals = {k: float(v) for k, v in comps.items()}
                    print(f"[epoch {epoch} step {i + 1}] {vals}")
                    if tb:
                        tb.scalars(vals, self.step, prefix="loss/")
            # the losses' read waits for the device, so epoch_seconds holds
            # the epoch's device work
            losses_row = {f"loss_{k}": float(v) for k, v in comps.items()}
            row = {"epoch": epoch, "step": self.step,
                   "epoch_seconds": round(time.time() - t_epoch, 2),
                   **losses_row}
            if (self.eval_dataset is not None
                    and (epoch + 1) % t.eval_every_epochs == 0):
                row.update(self.evaluate())
                if t.ckpt_dir and self.writer:
                    self.dump_visualization(os.path.join(
                        t.ckpt_dir, f"predictions_epoch{epoch}.png"))
                if tb:
                    tb.image("eval/panel", self.render_panel(), self.step)
            if tb:
                tb.scalars(row, self.step)
                tb.flush()
            self.history.append(row)
            if self.writer:
                print(f"[epoch {epoch}] {row}")
            if log_path:
                self._append_log(log_path, row)
            if ((epoch + 1) % t.ckpt_every_epochs == 0
                    or epoch + 1 == t.epochs):
                self.save_checkpoint()
        return self.history

    def _append_log(self, path: str, row: dict):
        """Appends ``row`` to the CSV at ``path``. The header names every
        column a row can hold (the reference's names only the first row's,
        so its evaluation rows run past it); a row without evaluation
        leaves the metric columns empty."""
        metrics = METRICS if self.eval_dataset is not None else ()
        fields = sorted({*row, *metrics})
        write_header = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields, restval="")
            if write_header:
                writer.writeheader()
            writer.writerow(row)
