"""KITTI and Cityscapes benchmark-submission files, port of
``cerberusnet_tpu/eval/submission.py``. Each writer is the exact inverse of
the dataset's ground-truth decode (``data/encodings.py``):

  * KITTI flow: 16-bit RGB PNG, R = u*64 + 2^15, G = v*64 + 2^15, B = valid.
  * KITTI disparity: 16-bit gray PNG, val = disp*256 (0 = invalid).
  * Cityscapes semantics: 8-bit labelId PNG (trainIds mapped back through
    the canonical 19-class -> labelId table).

The writers take a model's outputs (``seg_logits`` / ``flow`` / ``disp``,
full resolution, NHWC; tensors on any device or numpy arrays) and write one
file per batch row through the port's PNG writer. The reference resizes to
the native resolution with OpenCV; here ``F.interpolate`` does:
"bilinear" without antialiasing for flow and disparity (OpenCV's
``INTER_LINEAR``, which quantises its coefficients: the two differ by
about 7e-4 of a unit-normal value on a 384x1248 -> 375x1242 shrink), and
labels take OpenCV's ``INTER_NEAREST`` source index, floor(i / (out /
in)) in float64 (``F.interpolate``'s "nearest" computes in / out in
float32, which puts 121 of 128 -> 242 on source 63 where OpenCV takes
64).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from cerberusnet_torch.data.encodings import (
    encode_kitti_disparity,
    encode_kitti_flow,
)
from cerberusnet_torch.data.io import write_image_u8, write_png16

# trainId (0..18) -> Cityscapes labelId: the official evaluation's mapping
# (the inverse of CITYSCAPES_LABELID_TO_TRAINID, one labelId per class)
TRAINID_TO_LABELID = np.array(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33],
    np.uint8)

# head -> the benchmark's directory, in the order the files are written
HEADS = (("flow", "flow"), ("disp", "disp_0"), ("seg_logits", "semantic"))


def to_numpy(x) -> np.ndarray:
    """A tensor (any device, any type) or array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def write_flow_png(path: str, flow: np.ndarray, valid: np.ndarray | None = None):
    """flow: (H, W, 2) float; valid: (H, W) or None (all valid)."""
    flow = np.asarray(flow, np.float32)
    if valid is None:
        valid = np.ones(flow.shape[:2], np.float32)
    write_png16(path, encode_kitti_flow(flow, np.asarray(valid)))


def write_disparity_png(path: str, disp: np.ndarray,
                        valid: np.ndarray | None = None):
    """disp: (H, W) or (H, W, 1) float; valid: (H, W) or None."""
    disp = np.asarray(disp, np.float32)
    if disp.ndim == 3:
        disp = disp[..., 0]
    if valid is None:
        valid = np.ones(disp.shape, np.float32)
    write_png16(path, encode_kitti_disparity(disp, np.asarray(valid)))


def write_seg_png(path: str, seg: np.ndarray):
    """seg: (H, W) trainIds or (H, W, C) logits -> an 8-bit labelId PNG
    (the ignore trainId 255 -> labelId 0)."""
    seg = np.asarray(seg)
    if seg.ndim == 3:
        seg = seg.argmax(-1)
    labelids = TRAINID_TO_LABELID[np.clip(seg, 0, 18).astype(np.int64)]
    labelids = np.where(seg == 255, np.uint8(0), labelids)
    write_image_u8(path, labelids)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """OpenCV's ``INTER_NEAREST`` source index of each of ``n_out``
    outputs: floor(i * (1 / (n_out / n_in))) in float64, at most n_in - 1."""
    step = 1.0 / (n_out / n_in)
    idx = np.floor(np.arange(n_out, dtype=np.float64) * step).astype(np.int64)
    return np.minimum(idx, n_in - 1)


def _to_native(head: str, arr: np.ndarray, native_hw) -> np.ndarray:
    """One prediction (H, W[, C]) at the dataset's native resolution, its
    values scaled as the benchmark reads them: flow u by the width ratio
    and v by the height ratio, disparity by the width ratio; segmentation
    resized as argmax labels (nearest)."""
    h_in, w_in = arr.shape[:2]
    h_out, w_out = native_hw
    if (h_in, w_in) == (h_out, w_out):
        return arr
    if head == "seg_logits":
        labels = arr.argmax(-1) if arr.ndim == 3 else arr
        rows, cols = (_nearest_index(n_in, n_out)
                      for n_in, n_out in ((h_in, h_out), (w_in, w_out)))
        return np.asarray(labels, np.uint8)[rows][:, cols]
    x = torch.from_numpy(np.asarray(arr, np.float32))
    x = x[..., None] if x.dim() == 2 else x
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(h_out, w_out),
                        mode="bilinear", align_corners=False, antialias=False)
    out = out[0].permute(1, 2, 0).numpy()
    out = out[..., 0] if arr.ndim == 2 else out
    if head == "flow":
        return out * np.asarray([w_out / w_in, h_out / h_in], np.float32)
    return out * np.float32(w_out / w_in)  # disparity: horizontal


def write_predictions(outputs, out_dir: str, names, native_hw=None):
    """One submission file per head per batch row; returns their paths.

    outputs: a forward's dict with any of seg_logits (B,H,W,C), flow
    (B,H,W,2), disp (B,H,W,1); names: the B frame stems (e.g.
    '000000_10'); native_hw: an optional (H, W) every prediction is
    resized to, its values scaled (the benchmarks grade at the native
    resolution). The layout is the benchmarks': flow/<stem>.png,
    disp_0/<stem>.png, semantic/<stem>.png."""
    b = len(names)
    made = []
    for head, sub in HEADS:
        if head not in outputs:
            continue
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        arr = to_numpy(outputs[head])
        assert arr.shape[0] == b, (head, arr.shape, b)
        for i, stem in enumerate(names):
            path = os.path.join(d, f"{stem}.png")
            row = arr[i]
            if native_hw is not None:
                row = _to_native(head, row, native_hw)
            if head == "flow":
                write_flow_png(path, row)
            elif head == "disp":
                write_disparity_png(path, row)
            else:
                write_seg_png(path, row)
            made.append(path)
    return made
