"""Losses of the joint models, port of ``cerberusnet_tpu/train/losses.py``.

Tensors are NHWC, as the model's outputs; everything reduces in float32.
Each loss is a masked mean over valid pixels (sparse ground truth):

  * segmentation: cross-entropy with ignore index 255, optionally focal,
    optionally mixed with RMI as (1 - w) CE + w RMI (``rmi_loss``, region
    mutual information)
  * flow: per-level weighted EPE (or the robust (|.|_1 + eps)^q variant)
    over the prediction pyramid, against ground truth averaged over the
    valid pixels of each 2^l x 2^l cell and scaled by 1/2^l
  * disparity: berHu per level, with the same pyramid
  * RAFT's sequence loss, for a model that returns ``*_iterates``: the
    gamma-weighted L1 over every iterate, at the operating level, against
    the same valid-aware ground truth at that level
  * unsupervised terms for sparse ground truth: ``photometric_loss``
    (SSIM and L1 between the left frame and the temporal frame warped back
    by the flow) and ``smoothness_loss`` (edge-aware first-order flow
    smoothness)
  * joint: the weighted sum

``uncertainty_weighted_total`` replaces the weighted sum with Kendall's
weighting by learned log-variances.

Under data parallelism (``parallel/mesh.py``) each rank holds a slice of
the global batch, and every reduction over the batch goes through the
``mesh`` a loss takes: the masked means' numerator and denominator and
the plain means are sums over every rank (``DataMesh.sum``, ``mean``),
berHu's c comes from the global batch's largest error (``DataMesh.max``),
so each rank's value is the global batch's. The default mesh is one
process, whose reductions are these functions' own ops.

Under the spatial axis each rank holds a band of rows of every map, and the
reductions above run over all ranks, so they are the whole frame's. The
terms that read across rows take a halo (``parallel/halo.py``): SSIM's 3x3
windows and RMI's 3x3 regions the two rows below the band, smoothness's
row differences one, and the last band keeps the outputs whose window ends
inside the frame; their means divide by the frame's count. RMI pools each
4x4 window on the rank that holds its first row (3 rows of halo below),
so its pooled bands may differ from every level's; its region means and
covariances are sums over the frame, added over the spatial peers, so
every peer solves the same 9x9 systems. The photometric term
warps the whole frame of the second image (``warp2d``'s ``spatial``). The
ground-truth pyramid's 2x2 sum pools stay within the band: where the
frame's extent is even a band starts on an even row and holds an even
number of them (``parallel/mesh.py``'s nested bands), and an odd one
raises on every rank, as one process's reshape. The bands may differ in
height (``DataMesh.band_heights``): the means divide by the frame's count
(``DataMesh.frame_rows``), not by S times a band's.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from cerberusnet_torch.ops.warp import warp2d
from cerberusnet_torch.parallel.halo import halo_rows
from cerberusnet_torch.parallel.mesh import SINGLE

# PWC-Net multi-scale weights, levels 6..2.
DEFAULT_LEVEL_WEIGHTS: Mapping[int, float] = {6: 0.32, 5: 0.08, 4: 0.02,
                                              3: 0.01, 2: 0.005}


def _masked_mean(x, mask, mesh=SINGLE):
    """Mean of x over mask (float 0/1) on every rank; 0 if the mask is
    empty."""
    num = mesh.sum((x * mask).sum())
    den = mesh.sum(mask.sum())
    return torch.where(den > 0, num / den.clamp_min(1.0), 0.0)


def _rows_below(x, k: int, mesh, dim: int = 1):
    """A band ``x`` with the ``k`` rows below it (zeros past the frame),
    and how many outputs of a (k + 1)-row VALID window over it lie in the
    frame: all its rows, or k fewer on the last band."""
    last = mesh.spatial_rank == mesh.spatial_size - 1
    return (halo_rows(x, 0, k, mesh, dim=dim),
            x.shape[dim] - (k if last else 0))


def _frame_mean(x, rows: int, mesh):
    """The mean of a band's ``x`` over every rank, whose dimension 1
    spans ``rows`` rows over the whole frame."""
    per_row = x.shape[0] * math.prod(x.shape[2:])
    return mesh.mean(x, count=per_row * mesh.data_size * rows)


def segmentation_loss(logits, labels, ignore_index: int = 255,
                      focal_gamma=None, mesh=SINGLE):
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
    return _masked_mean(ce, valid, mesh)


def rmi_loss(logits, labels, ignore_index: int = 255, pool_stride: int = 4,
             radius: int = 3, eps: float = 5e-4, mesh=SINGLE):
    """Region mutual information (Zhao et al., NeurIPS 2019): each pixel
    with its radius x radius neighbourhood is one sample of a R = radius^2
    dimensional distribution; the loss is the log-determinant of the
    conditional covariance of the one-hot ground truth's regions given the
    predicted probabilities' regions, per (batch, class), a lower bound on
    -I(Y; P). logits (B,H,W,C), labels (B,H,W) (255 = ignore). Before the
    regions are cut the probabilities are average-pooled and the one-hot
    ground truth max-pooled by ``pool_stride`` (VALID: a remainder is
    dropped). The 9x9 solve and Cholesky run batched; a matrix that is not
    positive definite gives NaN, as JAX's Cholesky does (``cholesky_ex``:
    no raise and, on the card, no synchronisation to check)."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    valid = (labels != ignore_index).float()[..., None]
    safe = torch.where(labels == ignore_index, 0, labels).long()
    y = F.one_hot(safe, num_classes).float() * valid
    p = torch.softmax(logits, dim=-1) * valid
    p, y = p.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)  # NCHW
    if mesh.banded:
        p, heights = _pooled_band(p, pool_stride, F.avg_pool2d, mesh)
        y, _ = _pooled_band(y, pool_stride, F.max_pool2d, mesh)
        return _rmi_band(y, p, heights, radius, eps, mesh)
    if pool_stride > 1:
        p = F.avg_pool2d(p, pool_stride)
        y = F.max_pool2d(y, pool_stride)
    b, c, h, w = p.shape
    hh, ww = h - radius + 1, w - radius + 1
    r = radius * radius

    def regions(x):  # (B, C, R, N), the shifts in row-major order
        crops = [x[:, :, i:i + hh, j:j + ww] for i in range(radius)
                 for j in range(radius)]
        m = torch.stack(crops, 2).reshape(b, c, r, hh * ww)
        return m - m.mean(-1, keepdim=True)

    ym, pm = regions(y), regions(p)
    n = ym.shape[-1]
    cov_yy = ym @ ym.transpose(-1, -2) / n
    cov_yp = ym @ pm.transpose(-1, -2) / n
    cov_pp = pm @ pm.transpose(-1, -2) / n
    return _rmi_logdet(cov_yy, cov_yp, cov_pp, eps, mesh)


def _pooled_band(x, stride: int, pool, mesh):
    """``pool``'s VALID ``stride`` x ``stride`` windows of the frame on a
    band (NCHW): each window on the rank that holds its first row, with up
    to ``stride`` - 1 rows of halo below; a band that starts inside a
    window leaves its rows to the rank above, and the frame's last rows
    past its whole windows are dropped, as one process drops them.
    Returns (the pooled band, the peers' pooled heights): the pooled map's
    bands, which need not be any level's."""
    heights = mesh.band_heights(x.shape[2])
    frame = sum(heights) // stride
    starts = [sum(heights[:r]) for r in range(len(heights) + 1)]
    first = [-(-s // stride) for s in starts]  # the window starting there
    pooled = tuple(max(0, min(first[r + 1], frame) - first[r])
                   for r in range(len(heights)))
    s = mesh.spatial_rank
    skip = first[s] * stride - starts[s]
    x = halo_rows(x, 0, stride - 1, mesh)
    x = x[:, :, skip:skip + pooled[s] * stride]
    return pool(x, stride), pooled


def _rmi_band(y, p, heights: tuple, radius: int, eps: float, mesh):
    """``rmi_loss`` past its pooling on a band (NCHW) of the pooled map
    whose peers hold ``heights`` rows: the regions that start in the band
    and end in the frame, the rows below from the next bands, and the
    region means and covariances summed over the spatial peers."""
    b, c, _, w = p.shape
    ww, r = w - radius + 1, radius * radius
    frame = sum(heights)
    start = sum(heights[:mesh.spatial_rank])
    hh = max(0, min(start + heights[mesh.spatial_rank],
                    frame - radius + 1) - start)
    n = (frame - radius + 1) * ww  # the frame's regions
    y = halo_rows(y, 0, radius - 1, mesh, heights=heights)
    p = halo_rows(p, 0, radius - 1, mesh, heights=heights)

    def regions(x):  # (B, C, R, N_band), centred on the frame's means
        crops = [x[:, :, i:i + hh, j:j + ww] for i in range(radius)
                 for j in range(radius)]
        m = torch.stack(crops, 2).reshape(b, c, r, hh * ww)
        return m - mesh.spatial_sum(m.sum(-1, keepdim=True)) / n

    ym, pm = regions(y), regions(p)

    def cov(u, v):
        return mesh.spatial_sum(u @ v.transpose(-1, -2)) / n

    return _rmi_logdet(cov(ym, ym), cov(ym, pm), cov(pm, pm), eps, mesh)


def _rmi_logdet(cov_yy, cov_yp, cov_pp, eps: float, mesh):
    """RMI of the region covariances: the mean over (batch, class) of
    0.5 logdet of the conditional covariance, over the region's size."""
    r = cov_yy.shape[-1]
    eye = torch.eye(r, device=cov_yy.device)
    # sigma_{y|p} = cov_yy - cov_yp (cov_pp + eps I)^-1 cov_yp^T
    inv_term = torch.linalg.solve_ex(cov_pp + eps * eye,
                                     cov_yp.transpose(-1, -2))[0]
    sigma = cov_yy - cov_yp @ inv_term + eps * eye
    chol, info = torch.linalg.cholesky_ex(sigma)
    chol = torch.where((info == 0)[..., None, None], chol, float("nan"))
    logdet = 2.0 * torch.log(
        torch.diagonal(chol, dim1=-2, dim2=-1).clamp_min(1e-8)).sum(-1)
    # 0.5 logdet per (b, c), normalised by the region's size
    return mesh.mean(0.5 * logdet) / float(r)


def _sumpool2(x, mesh=SINGLE):
    """2x2 stride-2 sum pool of an NHWC tensor. On a band, the pairs are
    the frame's: a frame of an odd extent raises on every rank the error
    its reshape raises in one process (the bands of an even extent start
    on even rows, ``parallel/mesh.py``)."""
    b, h, w, c = x.shape
    if mesh.banded and mesh.frame_rows(h) % 2:
        frame = mesh.frame_rows(h)
        raise RuntimeError(
            f"shape '{[b, frame // 2, 2, w // 2, 2, c]}' is invalid for "
            f"input of size {b * frame * w * c} (the frame's {frame} rows "
            f"on the spatial mesh axis)")
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))


def _gt_sums_cascade(gt, valid, levels, mesh=SINGLE):
    """Yields (level, gsum, vsum) per level, each from the previous level's
    sums by one 2x2 sum pool, so the full-resolution GT is read once."""
    vm = valid[..., None].float()
    gsum = gt.float() * vm
    vsum = vm
    cur = 0
    for level in sorted(levels):
        while cur < level:
            gsum = _sumpool2(gsum, mesh)
            vsum = _sumpool2(vsum, mesh)
            cur += 1
        yield level, gsum, vsum


def _finalize_gt(gsum, vsum, level, scale_values: bool):
    gt_l = torch.where(vsum > 0, gsum / vsum.clamp_min(1.0), 0.0)
    if scale_values:
        gt_l = gt_l / (2**level)
    return gt_l, (vsum[..., 0] > 0).float()


def gt_pyramid(gt, valid, levels, scale_values: bool, mesh=SINGLE):
    """{level: (gt_l, valid_l)}: the valid pixels' mean over each
    2^l x 2^l cell (divided by 2^l if ``scale_values``), and whether the
    cell has any valid pixel. ``mesh``: ``gt`` is a band of its frame."""
    return {level: _finalize_gt(gsum, vsum, level, scale_values)
            for level, gsum, vsum in _gt_sums_cascade(gt, valid, levels,
                                                      mesh)}


def multiscale_flow_loss(flow_pyramid, gt_flow, valid=None,
                         level_weights=DEFAULT_LEVEL_WEIGHTS, robust_q=None,
                         robust_eps: float = 0.01, mesh=SINGLE):
    """Sum over levels of the weighted masked flow error. gt_flow is
    (B,H,W,2) at full resolution in full-resolution pixels."""
    if valid is None:
        valid = torch.ones(gt_flow.shape[:3], device=gt_flow.device)
    pyr = gt_pyramid(gt_flow, valid, flow_pyramid.keys(), scale_values=True,
                     mesh=mesh)
    total = 0.0
    for level, flow_l in flow_pyramid.items():
        gt_l, valid_l = pyr[level]
        diff = flow_l.float() - gt_l
        if robust_q is not None:
            err = (diff.abs().sum(-1) + robust_eps) ** robust_q
        else:
            err = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        total = total + level_weights.get(level, 0.0) * _masked_mean(
            err, valid_l, mesh)
    return total


def raft_sequence_loss(iterates, gt_flow, valid=None, level: int = 3,
                       gamma: float = 0.8, mesh=SINGLE):
    """RAFT's sequence loss: sum over the T iterates (T, B, h, w, C), in
    level pixels, of gamma^(T-1-t) times the masked mean over valid cells
    of the L1 error against ``gt_flow`` (B, H, W, C) brought to ``level``
    by ``gt_pyramid`` (the reference's ``downsample_gt``)."""
    if valid is None:
        valid = torch.ones(gt_flow.shape[:3], device=gt_flow.device)
    gt_l, valid_l = gt_pyramid(gt_flow, valid, (level,), True, mesh)[level]
    t = iterates.shape[0]
    err = (iterates.float() - gt_l[None]).abs().sum(-1)  # (T, B, h, w)
    per_iter = mesh.sum((err * valid_l[None]).sum(dim=(1, 2, 3))) / mesh.sum(
        valid_l.sum()).clamp_min(1.0)
    weights = gamma ** torch.arange(t - 1, -1, -1, dtype=torch.float32,
                                    device=iterates.device)
    return (weights * per_iter).sum()


def photometric_loss(im1, im2, flow, alpha: float = 0.85, mesh=SINGLE):
    """Unsupervised photometric term: alpha (1 - SSIM) / 2 + (1 - alpha) L1
    between ``im1`` and ``im2`` warped back by ``flow`` (which maps im1's
    pixels into im2), in float32 after the warp (which runs in im2's
    type)."""
    im2w = warp2d(im2, flow, spatial=mesh if mesh.banded else None).float()
    im1 = im1.float()
    l1 = _frame_mean((im1 - im2w).abs(), mesh.frame_rows(im1.shape[1]), mesh)
    return (alpha * (1.0 - _ssim(im1, im2w, mesh=mesh)) * 0.5
            + (1.0 - alpha) * l1)


def _ssim(a, b, c1: float = 0.01**2, c2: float = 0.03**2, mesh=SINGLE):
    """Mean SSIM with 3x3 mean-pool windows (VALID) over NHWC tensors."""

    def pool(x):
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1).permute(
            0, 2, 3, 1)

    if mesh.banded:
        rows = mesh.frame_rows(a.shape[1]) - 2
        (a, n), (b, _) = _rows_below(a, 2, mesh), _rows_below(b, 2, mesh)
    mu_a, mu_b = pool(a), pool(b)
    var_a = pool(a * a) - mu_a**2
    var_b = pool(b * b) - mu_b**2
    cov = pool(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    if mesh.banded:
        return _frame_mean((num / den).narrow(1, 0, n), rows, mesh)
    return mesh.mean(num / den)


def smoothness_loss(field, image, mesh=SINGLE):
    """First-order edge-aware smoothness: the mean of |d field| exp(-|d
    image|) along x plus along y, |d image| averaged over the channels."""
    field = field.float()
    image = image.float()

    def grad_x(x):
        return x[:, :, 1:] - x[:, :, :-1]

    def grad_y(x):
        return x[:, 1:] - x[:, :-1]

    wx = torch.exp(-grad_x(image).abs().mean(-1, keepdim=True))
    along_x = _frame_mean(grad_x(field).abs() * wx,
                          mesh.frame_rows(field.shape[1]), mesh)
    if mesh.banded:
        rows = mesh.frame_rows(field.shape[1]) - 1
        (field, n), (image, _) = (_rows_below(field, 1, mesh),
                                  _rows_below(image, 1, mesh))
    wy = torch.exp(-grad_y(image).abs().mean(-1, keepdim=True))
    along_y = grad_y(field).abs() * wy
    if mesh.banded:
        return along_x + _frame_mean(along_y.narrow(1, 0, n), rows, mesh)
    return along_x + mesh.mean(along_y)


def berhu_loss(pred, gt, valid=None, c_frac: float = 0.2, mesh=SINGLE):
    """berHu: L1 below c, (d^2 + c^2) / (2c) above, c = c_frac * the
    (global) batch's largest error. ``amax`` shares the gradient among tied
    maxima, as JAX's max does."""
    pred = pred.float()
    gt = gt.float()
    if pred.dim() == gt.dim() + 1:
        pred = pred[..., 0]
    if valid is None:
        valid = torch.ones_like(gt)
    err = (pred - gt).abs() * valid
    c = (c_frac * mesh.max(err)).clamp_min(1e-6)
    loss = torch.where(err <= c, err, (err * err + c * c) / (2.0 * c))
    return _masked_mean(loss, valid, mesh)


def multiscale_disparity_loss(disp_pyramid, gt_disp, valid=None,
                              level_weights=DEFAULT_LEVEL_WEIGHTS,
                              mesh=SINGLE):
    """Per-level berHu over the disparity pyramid, with the flow loss's
    ground-truth pyramid."""
    if gt_disp.dim() == 3:
        gt_disp = gt_disp[..., None]
    if valid is None:
        valid = torch.ones(gt_disp.shape[:3], device=gt_disp.device)
    pyr = gt_pyramid(gt_disp, valid, disp_pyramid.keys(), scale_values=True,
                     mesh=mesh)
    total = 0.0
    for level, disp_l in disp_pyramid.items():
        gt_l, valid_l = pyr[level]
        total = total + level_weights.get(level, 0.0) * berhu_loss(
            disp_l, gt_l[..., 0], valid_l, mesh=mesh)
    return total


def joint_loss(outputs, batch, weights=None, focal_gamma=None, robust_q=None,
               photometric_weight: float = 0.0, smoothness_weight: float = 0.0,
               rmi_weight: float = 0.0, seq_gamma: float = 0.8,
               mesh=SINGLE):
    """Weighted multi-task loss; returns (total, components).

    A task contributes when the model output and its ground truth are both
    present: seg_labels (B,H,W), flow_gt (B,H,W,2) with flow_valid, disp_gt
    (B,H,W) with disp_valid. A RAFT model's ``flow_iterates`` and
    ``disp_iterates`` take the sequence loss with ``seq_gamma`` at their
    one pyramid level in place of the multi-scale terms. ``rmi_weight`` w
    makes the seg term (1 - w) CE + w RMI (``comps["rmi"]`` the RMI);
    ``photometric_weight`` and ``smoothness_weight`` add the unsupervised
    terms on the full-resolution ``flow`` and the batch's ``left`` (and
    ``temporal``) frames, ``comps["photometric"]`` and
    ``comps["smoothness"]``. ``mesh`` makes every term the global
    batch's under data parallelism."""
    weights = weights or {"seg": 1.0, "flow": 1.0, "disp": 1.0}
    comps = {}
    total = 0.0
    if "seg_labels" in batch and "seg_logits" in outputs:
        comps["seg"] = segmentation_loss(outputs["seg_logits"],
                                         batch["seg_labels"],
                                         focal_gamma=focal_gamma, mesh=mesh)
        if rmi_weight:
            comps["rmi"] = rmi_loss(outputs["seg_logits"], batch["seg_labels"],
                                    mesh=mesh)
            comps["seg"] = ((1.0 - rmi_weight) * comps["seg"]
                            + rmi_weight * comps["rmi"])
        total = total + weights.get("seg", 1.0) * comps["seg"]
    if "flow_gt" in batch and "flow_iterates" in outputs:
        (level,) = outputs["flow_pyramid"].keys()
        comps["flow"] = raft_sequence_loss(
            outputs["flow_iterates"], batch["flow_gt"],
            batch.get("flow_valid"), level=level, gamma=seq_gamma, mesh=mesh)
        total = total + weights.get("flow", 1.0) * comps["flow"]
    elif "flow_gt" in batch and "flow_pyramid" in outputs:
        comps["flow"] = multiscale_flow_loss(
            outputs["flow_pyramid"], batch["flow_gt"],
            batch.get("flow_valid"), robust_q=robust_q, mesh=mesh)
        total = total + weights.get("flow", 1.0) * comps["flow"]
    if "disp_gt" in batch and "disp_iterates" in outputs:
        (level,) = outputs["disp_pyramid"].keys()
        gt = batch["disp_gt"]
        comps["disp"] = raft_sequence_loss(
            outputs["disp_iterates"], gt[..., None] if gt.dim() == 3 else gt,
            batch.get("disp_valid"), level=level, gamma=seq_gamma, mesh=mesh)
        total = total + weights.get("disp", 1.0) * comps["disp"]
    elif "disp_gt" in batch and "disp_pyramid" in outputs:
        comps["disp"] = multiscale_disparity_loss(
            outputs["disp_pyramid"], batch["disp_gt"], batch.get("disp_valid"),
            mesh=mesh)
        total = total + weights.get("disp", 1.0) * comps["disp"]
    if photometric_weight and "flow" in outputs and "temporal" in batch:
        comps["photometric"] = photometric_loss(
            batch["left"], batch["temporal"], outputs["flow"], mesh=mesh)
        total = total + photometric_weight * comps["photometric"]
    if smoothness_weight and "flow" in outputs and "left" in batch:
        comps["smoothness"] = smoothness_loss(outputs["flow"], batch["left"],
                                              mesh=mesh)
        total = total + smoothness_weight * comps["smoothness"]
    comps["total"] = total
    return total, comps


def uncertainty_weighted_total(comps, log_vars):
    """Kendall et al.'s homoscedastic multi-task weighting: the sum over
    the tasks present in ``comps`` of exp(-s_t) * L_t + 0.5 * s_t, with
    ``log_vars`` {task: learnable float32 scalar s_t}. The config's task
    weights do not enter it, as in the reference. Under data parallelism it
    is the global batch's because its inputs are."""
    total = 0.0
    for task, s in log_vars.items():
        if task in comps:
            total = total + torch.exp(-s) * comps[task] + 0.5 * s
    return total
