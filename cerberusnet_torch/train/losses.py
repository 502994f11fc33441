"""Losses of the joint models, port of ``cerberusnet_tpu/train/losses.py``
(``joint_loss`` without its RMI, photometric and smoothness terms).

Tensors are NHWC, as the model's outputs; everything reduces in float32.
Each loss is a masked mean over valid pixels (sparse ground truth):

  * segmentation: cross-entropy with ignore index 255, optionally focal
  * flow: per-level weighted EPE (or the robust (|.|_1 + eps)^q variant)
    over the prediction pyramid, against ground truth averaged over the
    valid pixels of each 2^l x 2^l cell and scaled by 1/2^l
  * disparity: berHu per level, with the same pyramid
  * RAFT's sequence loss, for a model that returns ``*_iterates``: the
    gamma-weighted L1 over every iterate, at the operating level, against
    the same valid-aware ground truth at that level
  * joint: the weighted sum

``uncertainty_weighted_total`` replaces the weighted sum with Kendall's
weighting by learned log-variances. The RMI, photometric and smoothness
terms are not ported yet (ROADMAP A4): ``joint_loss`` raises
``NotImplementedError`` when asked for them.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

# PWC-Net multi-scale weights, levels 6..2.
DEFAULT_LEVEL_WEIGHTS: Mapping[int, float] = {6: 0.32, 5: 0.08, 4: 0.02,
                                              3: 0.01, 2: 0.005}


def _masked_mean(x, mask):
    """Mean of x over mask (float 0/1); 0 if the mask is empty."""
    num = (x * mask).sum()
    den = mask.sum()
    return torch.where(den > 0, num / den.clamp_min(1.0), 0.0)


def segmentation_loss(logits, labels, ignore_index: int = 255,
                      focal_gamma=None):
    """Cross-entropy over valid pixels. logits (B,H,W,C), labels (B,H,W)
    integers (255 = ignore); ``focal_gamma`` adds the (1-p)^gamma factor.
    The reference's one-hot dot picks the label's log-probability exactly,
    as a gather does."""
    logits = logits.float()
    valid = (labels != ignore_index).float()
    safe = torch.where(labels == ignore_index, 0, labels).long()
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, safe[..., None])[..., 0]
    ce = -ll
    if focal_gamma is not None:
        ce = ce * (1.0 - torch.exp(ll)) ** focal_gamma
    return _masked_mean(ce, valid)


def _sumpool2(x):
    """2x2 stride-2 sum pool of an NHWC tensor."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))


def _gt_sums_cascade(gt, valid, levels):
    """Yields (level, gsum, vsum) per level, each from the previous level's
    sums by one 2x2 sum pool, so the full-resolution GT is read once."""
    vm = valid[..., None].float()
    gsum = gt.float() * vm
    vsum = vm
    cur = 0
    for level in sorted(levels):
        while cur < level:
            gsum = _sumpool2(gsum)
            vsum = _sumpool2(vsum)
            cur += 1
        yield level, gsum, vsum


def _finalize_gt(gsum, vsum, level, scale_values: bool):
    gt_l = torch.where(vsum > 0, gsum / vsum.clamp_min(1.0), 0.0)
    if scale_values:
        gt_l = gt_l / (2**level)
    return gt_l, (vsum[..., 0] > 0).float()


def gt_pyramid(gt, valid, levels, scale_values: bool):
    """{level: (gt_l, valid_l)}: the valid pixels' mean over each
    2^l x 2^l cell (divided by 2^l if ``scale_values``), and whether the
    cell has any valid pixel."""
    return {level: _finalize_gt(gsum, vsum, level, scale_values)
            for level, gsum, vsum in _gt_sums_cascade(gt, valid, levels)}


def multiscale_flow_loss(flow_pyramid, gt_flow, valid=None,
                         level_weights=DEFAULT_LEVEL_WEIGHTS, robust_q=None,
                         robust_eps: float = 0.01):
    """Sum over levels of the weighted masked flow error. gt_flow is
    (B,H,W,2) at full resolution in full-resolution pixels."""
    if valid is None:
        valid = torch.ones(gt_flow.shape[:3], device=gt_flow.device)
    pyr = gt_pyramid(gt_flow, valid, flow_pyramid.keys(), scale_values=True)
    total = 0.0
    for level, flow_l in flow_pyramid.items():
        gt_l, valid_l = pyr[level]
        diff = flow_l.float() - gt_l
        if robust_q is not None:
            err = (diff.abs().sum(-1) + robust_eps) ** robust_q
        else:
            err = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        total = total + level_weights.get(level, 0.0) * _masked_mean(err,
                                                                     valid_l)
    return total


def raft_sequence_loss(iterates, gt_flow, valid=None, level: int = 3,
                       gamma: float = 0.8):
    """RAFT's sequence loss: sum over the T iterates (T, B, h, w, C), in
    level pixels, of gamma^(T-1-t) times the masked mean over valid cells
    of the L1 error against ``gt_flow`` (B, H, W, C) brought to ``level``
    by ``gt_pyramid`` (the reference's ``downsample_gt``)."""
    if valid is None:
        valid = torch.ones(gt_flow.shape[:3], device=gt_flow.device)
    gt_l, valid_l = gt_pyramid(gt_flow, valid, (level,), True)[level]
    t = iterates.shape[0]
    err = (iterates.float() - gt_l[None]).abs().sum(-1)  # (T, B, h, w)
    per_iter = (err * valid_l[None]).sum(dim=(1, 2, 3)) / valid_l.sum(
    ).clamp_min(1.0)
    weights = gamma ** torch.arange(t - 1, -1, -1, dtype=torch.float32,
                                    device=iterates.device)
    return (weights * per_iter).sum()


def berhu_loss(pred, gt, valid=None, c_frac: float = 0.2):
    """berHu: L1 below c, (d^2 + c^2) / (2c) above, c = c_frac * the batch's
    largest error. ``amax`` shares the gradient among tied maxima, as JAX's
    max does."""
    pred = pred.float()
    gt = gt.float()
    if pred.dim() == gt.dim() + 1:
        pred = pred[..., 0]
    if valid is None:
        valid = torch.ones_like(gt)
    err = (pred - gt).abs() * valid
    c = (c_frac * err.amax()).clamp_min(1e-6)
    loss = torch.where(err <= c, err, (err * err + c * c) / (2.0 * c))
    return _masked_mean(loss, valid)


def multiscale_disparity_loss(disp_pyramid, gt_disp, valid=None,
                              level_weights=DEFAULT_LEVEL_WEIGHTS):
    """Per-level berHu over the disparity pyramid, with the flow loss's
    ground-truth pyramid."""
    if gt_disp.dim() == 3:
        gt_disp = gt_disp[..., None]
    if valid is None:
        valid = torch.ones(gt_disp.shape[:3], device=gt_disp.device)
    pyr = gt_pyramid(gt_disp, valid, disp_pyramid.keys(), scale_values=True)
    total = 0.0
    for level, disp_l in disp_pyramid.items():
        gt_l, valid_l = pyr[level]
        total = total + level_weights.get(level, 0.0) * berhu_loss(
            disp_l, gt_l[..., 0], valid_l)
    return total


def joint_loss(outputs, batch, weights=None, focal_gamma=None, robust_q=None,
               photometric_weight: float = 0.0, smoothness_weight: float = 0.0,
               rmi_weight: float = 0.0, seq_gamma: float = 0.8):
    """Weighted multi-task loss; returns (total, components).

    A task contributes when the model output and its ground truth are both
    present: seg_labels (B,H,W), flow_gt (B,H,W,2) with flow_valid, disp_gt
    (B,H,W) with disp_valid. A RAFT model's ``flow_iterates`` and
    ``disp_iterates`` take the sequence loss with ``seq_gamma`` at their
    one pyramid level in place of the multi-scale terms."""
    if rmi_weight or photometric_weight or smoothness_weight:
        raise NotImplementedError(
            "the RMI, photometric and smoothness terms are not ported yet "
            "(ROADMAP A4)")
    weights = weights or {"seg": 1.0, "flow": 1.0, "disp": 1.0}
    comps = {}
    total = 0.0
    if "seg_labels" in batch and "seg_logits" in outputs:
        comps["seg"] = segmentation_loss(outputs["seg_logits"],
                                         batch["seg_labels"],
                                         focal_gamma=focal_gamma)
        total = total + weights.get("seg", 1.0) * comps["seg"]
    if "flow_gt" in batch and "flow_iterates" in outputs:
        (level,) = outputs["flow_pyramid"].keys()
        comps["flow"] = raft_sequence_loss(
            outputs["flow_iterates"], batch["flow_gt"],
            batch.get("flow_valid"), level=level, gamma=seq_gamma)
        total = total + weights.get("flow", 1.0) * comps["flow"]
    elif "flow_gt" in batch and "flow_pyramid" in outputs:
        comps["flow"] = multiscale_flow_loss(
            outputs["flow_pyramid"], batch["flow_gt"],
            batch.get("flow_valid"), robust_q=robust_q)
        total = total + weights.get("flow", 1.0) * comps["flow"]
    if "disp_gt" in batch and "disp_iterates" in outputs:
        (level,) = outputs["disp_pyramid"].keys()
        gt = batch["disp_gt"]
        comps["disp"] = raft_sequence_loss(
            outputs["disp_iterates"], gt[..., None] if gt.dim() == 3 else gt,
            batch.get("disp_valid"), level=level, gamma=seq_gamma)
        total = total + weights.get("disp", 1.0) * comps["disp"]
    elif "disp_gt" in batch and "disp_pyramid" in outputs:
        comps["disp"] = multiscale_disparity_loss(
            outputs["disp_pyramid"], batch["disp_gt"], batch.get("disp_valid"))
        total = total + weights.get("disp", 1.0) * comps["disp"]
    comps["total"] = total
    return total, comps


def uncertainty_weighted_total(comps, log_vars):
    """Kendall et al.'s homoscedastic multi-task weighting: the sum over
    the tasks present in ``comps`` of exp(-s_t) * L_t + 0.5 * s_t, with
    ``log_vars`` {task: learnable float32 scalar s_t}. The config's task
    weights do not enter it, as in the reference."""
    total = 0.0
    for task, s in log_vars.items():
        if task in comps:
            total = total + torch.exp(-s) * comps[task] + 0.5 * s
    return total
