"""The train step, port of ``cerberusnet_tpu/train/trainer.py``
(``build_optimizer`` and the train step of ``Trainer``).

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
``CerberusNet`` or ``CerberusDCV``, or the single-task ``DCVFlowNet`` or
``DCVStereoNet``. ``fit``, checkpoints, evaluation, EMA, NaN recovery and
logging are not ported yet (ROADMAP A5, A7): the trainer takes steps on
batches it is given.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from cerberusnet_torch.data.loader import preprocess
from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.dcv_flow import (
    CerberusDCV,
    DCVFlowNet,
    DCVStereoNet,
)
from cerberusnet_torch.train import losses
from cerberusnet_torch.train.config import (
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
)
from cerberusnet_torch.weights import init_params

# ----------------------------------------------------------------- model


def build_model(cfg: ModelConfig, corr_impl: str | None,
                dtype: torch.dtype):
    """(model, input keys) for ``cfg.variant``, with the arguments the
    reference's ``build_model`` passes: the DCV models keep their default
    level, dilations and (stereo) max_disp, as there, and ignore
    ``pallas_levels`` and ``pallas_grad``, which only CerberusNet's encoder
    takes. The model's forward takes the batch's tensors under the input
    keys, in order."""
    common = dict(encoder_channels=tuple(cfg.encoder_channels),
                  est_channels=tuple(cfg.est_channels),
                  ctx_channels=tuple(cfg.ctx_channels), corr_impl=corr_impl,
                  dtype=dtype)
    if cfg.variant == "cerberus":
        return CerberusNet(num_classes=cfg.num_classes,
                           max_disp_full=cfg.max_disp_full,
                           flow_max_disp=cfg.flow_max_disp,
                           fpn_channels=cfg.fpn_channels,
                           pallas_levels=cfg.pallas_levels,
                           pallas_grad=cfg.pallas_grad, **common), (
                               "left", "right", "temporal")
    if cfg.variant == "cerberus_dcv":
        return CerberusDCV(num_classes=cfg.num_classes,
                           flow_max_disp=cfg.flow_max_disp,
                           fpn_channels=cfg.fpn_channels, **common), (
                               "left", "right", "temporal")
    if cfg.variant == "dcv_flow":
        return DCVFlowNet(max_disp=cfg.flow_max_disp, **common), (
            "left", "temporal")
    if cfg.variant == "dcv_stereo":
        return DCVStereoNet(**common), ("left", "right")
    raise ValueError(f"unknown model variant {cfg.variant!r}")


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


# --------------------------------------------------------------- trainer


class Trainer:
    """``Trainer(config, device="cuda")``: the model of ``model.variant``
    in the config's compute type on ``device``, seeded weights (flax's
    initialisers, ``train.seed``), float32 masters and the optimizer over
    them. Without a CUDA device it raises unless ``device="cpu"``.

    With ``loss.uncertainty_weighting`` three float32 log-variances,
    ``__task_uncertainty__.seg``, ``.flow`` and ``.disp``, start at 0 and
    are masters beside the model's, as the reference keeps them in its
    parameter tree: they count in the clip's global norm, and AdamW's
    decay applies to them."""

    def __init__(self, config: ExperimentConfig, device="cuda"):
        config.check_supported()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to train on the CPU")
        self.config = config
        self.device = device
        m = config.model
        # interpret_kernels forces the reference's pure correlations; here
        # the plain ones
        self.corr_impl = ("plain" if config.train.interpret_kernels
                          else m.port_corr_impl)
        self.dtype = m.torch_dtype
        d = config.data
        self.dataset = SyntheticPerceptionDataset(
            length=d.synthetic_length, hw=tuple(d.hw),
            num_classes=m.num_classes, sparse=d.synthetic_sparse,
            seed=1 if d.split == "val" else 0)

        ref, _ = build_model(m, self.corr_impl, torch.float32)
        init_params(ref, torch.Generator().manual_seed(config.train.seed))
        self.model, self.input_keys = build_model(m, self.corr_impl,
                                                  self.dtype)
        self.model = self.model.to(device).train()
        params = dict(self.model.named_parameters())
        self.masters = {n: p.detach().to(device).clone()
                        for n, p in ref.named_parameters()}
        # the log-variances are leaves of the loss, as the model's
        # parameters are, with masters of their own
        self.log_vars = {}
        if config.loss.uncertainty_weighting:
            self.log_vars = {t: torch.zeros((), device=device,
                                            requires_grad=True)
                             for t in TASKS}
            for t, s in self.log_vars.items():
                params[f"{UNCERTAINTY}.{t}"] = s
                self.masters[f"{UNCERTAINTY}.{t}"] = s.detach().clone()
        self.names = list(params)
        self._params = [params[n] for n in self.names]
        self._start()

    # -- weights -----------------------------------------------------------

    def _start(self):
        """A fresh optimizer over the masters, and the masters in the
        model."""
        self.optimizer = Optimizer(self.config.optim,
                                   [self.masters[n] for n in self.names])
        self._sync()

    @torch.no_grad()
    def load_masters(self, masters: dict):
        """Sets the float32 masters (name -> tensor, as ``self.masters``),
        copies them into the model and starts the optimizer afresh."""
        for n in self.names:
            self.masters[n].copy_(masters[n])
        self._start()

    @torch.no_grad()
    def _sync(self):
        for p, n in zip(self._params, self.names):
            p.copy_(self.masters[n])

    # -- steps -------------------------------------------------------------

    def _loss_fn(self, batch):
        outputs = self.model(*[batch[k] for k in self.input_keys])
        cfg = self.config.loss
        total, comps = losses.joint_loss(
            outputs, batch, weights=cfg.weights, focal_gamma=cfg.focal_gamma,
            robust_q=cfg.robust_q, photometric_weight=cfg.photometric_weight,
            smoothness_weight=cfg.smoothness_weight,
            rmi_weight=cfg.rmi_weight, seq_gamma=cfg.seq_gamma)
        if self.log_vars:
            total = losses.uncertainty_weighted_total(comps, self.log_vars)
            comps = {**comps, "total": total}
        return total, comps

    def loss_and_grads(self, batch):
        """Forward and backward on a batch as the dataset gives it; returns
        (loss components, {parameter name: float32 gradient}). Changes no
        weight."""
        batch = preprocess(batch, self.config.data.hw, self.dtype,
                           self.device)
        for p in self._params:
            p.grad = None
        total, comps = self._loss_fn(batch)
        total.backward()
        grads = {n: (p.grad.float() if p.grad is not None
                     else torch.zeros_like(self.masters[n]))
                 for n, p in zip(self.names, self._params)}
        return {k: v.detach() for k, v in comps.items()}, grads

    def apply_grads(self, grads: dict):
        """Clips, updates the masters and copies them into the model."""
        self.optimizer.step([grads[n] for n in self.names])
        self._sync()

    def train_step(self, batch):
        """One step; returns the loss components (device tensors, before
        the update), as the reference's ``train_step`` does."""
        comps, grads = self.loss_and_grads(batch)
        self.apply_grads(grads)
        return comps
