"""Evaluation metrics, port of ``cerberusnet_tpu/train/metrics.py``:
segmentation mIoU, flow EPE and Fl-all, disparity MAE and D1-all.

The accumulators are small float32 tensors on the device (a confusion
matrix and two triples of running sums). ``MetricState.update`` adds one
batch to them without a host read; ``compute`` reads them once, at the
end of an evaluation, as the reference's on-device accumulators do. Under
data parallelism each rank adds its slices (on a spatial mesh, its band of
their rows), and ``summed`` adds up every rank's state before
``compute``.
"""

from __future__ import annotations

import dataclasses

import torch

# Cityscapes trainId class names, as in cerberusnet_tpu/data/encodings.py.
CITYSCAPES_CLASS_NAMES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)

# the keys of MetricState.compute(), per_class aside
METRICS = ("miou", "flow_epe", "flow_fl_all", "disp_mae", "disp_d1_all")

# ------------------------------------------------------------- segmentation


def confusion_matrix(pred, labels, num_classes: int, ignore_index: int = 255):
    """(B,H,W) integer pred/labels -> (C, C) float32 counts[label, pred],
    ignoring ``ignore_index``: a bincount over label*C+pred weighted by the
    validity mask. A label >= C counts nowhere, as the reference's bincount
    of fixed length drops its index."""
    valid = (labels != ignore_index) & (labels < num_classes)
    idx = torch.where(valid, labels, 0) * num_classes + pred
    counts = torch.bincount(idx.reshape(-1), weights=valid.reshape(-1).float(),
                            minlength=num_classes * num_classes)
    return counts.float().reshape(num_classes, num_classes)


def iou_per_class(cm):
    """(C,C) confusion -> ((C,) IoU, (C,) present mask). IoU is 0 for
    classes absent from both ground truth and prediction."""
    tp = torch.diagonal(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    denom = tp + fp + fn
    iou = torch.where(denom > 0, tp / denom.clamp_min(1.0), 0.0)
    return iou, denom > 0


def miou_from_confusion(cm):
    """Mean IoU over the classes present in ground truth or prediction."""
    iou, present = iou_per_class(cm)
    n = present.sum().clamp_min(1)
    return torch.where(present, iou, 0.0).sum() / n


# --------------------------------------------------------------------- flow


def flow_error_sums(pred, gt, valid=None):
    """(epe_sum, outlier_sum, count) over the valid pixels. EPE is
    ||pred - gt||_2; an outlier (KITTI Fl) has EPE > 3 px and > 5% of
    ||gt||."""
    if valid is None:
        valid = torch.ones(gt.shape[:3], device=gt.device)
    valid = valid.float()
    err = ((pred.float() - gt.float()) ** 2).sum(-1).sqrt()
    mag = (gt.float() ** 2).sum(-1).sqrt()
    outlier = ((err > 3.0) & (err > 0.05 * mag)).float()
    return (err * valid).sum(), (outlier * valid).sum(), valid.sum()


# ---------------------------------------------------------------- disparity


def disparity_error_sums(pred, gt, valid=None):
    """(abs_err_sum, d1_sum, count). D1: error > 3 px and > 5% of gt (the
    KITTI-2015 convention). ``pred`` may carry a trailing axis of 1."""
    if pred.ndim == gt.ndim + 1:
        pred = pred[..., 0]
    if valid is None:
        valid = gt > 0
    valid = valid.float()
    err = (pred.float() - gt.float()).abs()
    d1 = ((err > 3.0) & (err > 0.05 * gt.abs())).float()
    return (err * valid).sum(), (d1 * valid).sum(), valid.sum()


# -------------------------------------------------------------- accumulator


@dataclasses.dataclass(frozen=True)
class MetricState:
    """Running metric state on the device."""

    confusion: torch.Tensor  # (C, C)
    flow_sums: torch.Tensor  # (3,) epe_sum, outlier_sum, count
    disp_sums: torch.Tensor  # (3,) abs_err_sum, d1_sum, count

    @classmethod
    def zeros(cls, num_classes: int = 19, device="cpu"):
        return cls(torch.zeros((num_classes, num_classes), device=device),
                   torch.zeros(3, device=device),
                   torch.zeros(3, device=device))

    def update(self, outputs, batch, ignore_index: int = 255):
        """The state with one batch added. ``batch["_sample_mask"]`` ((B,)
        float, 1 a real sample, 0 padding) leaves out the samples that
        ``data.loader.pad_batch`` appended to the last eval batch."""
        new = self
        smask = batch.get("_sample_mask")
        if "seg_labels" in batch and "seg_logits" in outputs:
            pred = outputs["seg_logits"].argmax(-1)
            labels = batch["seg_labels"]
            if smask is not None:
                labels = torch.where(smask[:, None, None] > 0, labels,
                                     ignore_index)
            cm = confusion_matrix(pred, labels, self.confusion.shape[0],
                                  ignore_index)
            new = dataclasses.replace(new, confusion=new.confusion + cm)
        if "flow_gt" in batch and "flow" in outputs:
            valid = batch.get("flow_valid")
            if valid is None:
                valid = torch.ones(batch["flow_gt"].shape[:3],
                                   device=batch["flow_gt"].device)
            if smask is not None:
                valid = valid * smask[:, None, None]
            s = flow_error_sums(outputs["flow"], batch["flow_gt"], valid)
            new = dataclasses.replace(
                new, flow_sums=new.flow_sums + torch.stack(s))
        if "disp_gt" in batch and "disp" in outputs:
            gt = batch["disp_gt"]
            valid = batch.get("disp_valid")
            if valid is None:
                valid = ((gt[..., 0] if gt.ndim == 4 else gt) > 0).float()
            if smask is not None:
                valid = valid * smask[:, None, None]
            s = disparity_error_sums(outputs["disp"], gt, valid)
            new = dataclasses.replace(
                new, disp_sums=new.disp_sums + torch.stack(s))
        return new

    def summed(self, mesh):
        """The state summed over the data mesh's ranks in one all-reduce
        (``DataMesh.sum_``): the accumulators are linear in the data, as
        the reference's are, so the sum is the whole dataset's state. The
        state itself outside a process group."""
        if not mesh.distributed:
            return self
        c = self.confusion.numel()
        flat = mesh.sum_(torch.cat([self.confusion.reshape(-1),
                                    self.flow_sums, self.disp_sums]))
        return MetricState(flat[:c].reshape(self.confusion.shape),
                           flat[c:c + 3], flat[c + 3:])

    def merge(self, other: "MetricState"):
        return MetricState(self.confusion + other.confusion,
                           self.flow_sums + other.flow_sums,
                           self.disp_sums + other.disp_sums)

    def compute(self, per_class: bool = False, class_names=None):
        """The metrics as a dict of Python floats, from one host read.
        ``per_class`` adds each class's IoU as ``iou/<name>`` (the
        Cityscapes trainId names by default), NaN for an absent class."""
        iou, present = iou_per_class(self.confusion)
        host = torch.cat([miou_from_confusion(self.confusion)[None],
                          self.flow_sums, self.disp_sums, iou,
                          present.float()]).cpu().tolist()
        miou, fs, ds = host[0], host[1:4], host[4:7]
        fcount, dcount = max(fs[2], 1.0), max(ds[2], 1.0)
        out = {
            "miou": miou,
            "flow_epe": fs[0] / fcount,
            "flow_fl_all": fs[1] / fcount,
            "disp_mae": ds[0] / dcount,
            "disp_d1_all": ds[1] / dcount,
        }
        if per_class:
            n = len(iou)
            names = CITYSCAPES_CLASS_NAMES if class_names is None else class_names
            for i, (v, p) in enumerate(zip(host[7:7 + n], host[7 + n:])):
                name = names[i] if i < len(names) else str(i)
                out[f"iou/{name}"] = v if p else float("nan")
        return out
