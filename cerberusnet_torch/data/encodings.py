"""Ground-truth encodings and device-side preprocessing, port of
``cerberusnet_tpu/data/encodings.py``.

On the host (numpy), right after a PNG decode: the KITTI flow and
disparity codecs and the Cityscapes maps. On the device (torch):
normalisation, resizing and the ground truth's value scaling.

* KITTI flow PNG (16-bit RGB): u = (R - 2^15)/64, v = (G - 2^15)/64,
  valid = B > 0. Sparse.
* KITTI disparity PNG (16-bit gray): disp = val/256, val == 0 invalid.
* Cityscapes: labelIds (0..33) -> 19 trainIds, ignore 255; the
  precomputed disparity d = (val - 1)/256, val > 0.
* A resize by (s_x, s_y) scales flow by (s_x, s_y) and disparity by s_x;
  labels, flow and disparity take the nearest sample, so sparse ground
  truth keeps its exact values.

The resizes are ``jax.image.resize``'s: "bilinear" is torch's bilinear on
the half-pixel grid, antialiased along an axis it shrinks (without
antialias a downscale differs); "nearest" takes the source index
floor((i + 0.5) * in / out) computed in float32, as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics, the reference's fixed normalisation
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Cityscapes labelId -> trainId (the public 19-class mapping)
_LUT = np.full(256, 255, np.uint8)
for label_id, train_id in {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}.items():
    _LUT[label_id] = train_id
CITYSCAPES_LABELID_TO_TRAINID = _LUT

CITYSCAPES_CLASS_NAMES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)


# ------------------------------------------------------------------ host


def decode_kitti_flow(png: np.ndarray):
    """(H, W, 3) uint16 KITTI flow PNG -> (flow (H,W,2) f32, valid (H,W) f32)."""
    png = np.asarray(png)
    if png.dtype != np.uint16:
        raise ValueError(f"KITTI flow PNG must be uint16, got {png.dtype}")
    u = (png[..., 0].astype(np.float32) - 2.0**15) / 64.0
    v = (png[..., 1].astype(np.float32) - 2.0**15) / 64.0
    valid = (png[..., 2] > 0).astype(np.float32)
    return np.stack([u, v], axis=-1) * valid[..., None], valid


def encode_kitti_flow(flow: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Inverse of decode_kitti_flow (writes the fixtures)."""
    u16 = np.zeros(flow.shape[:2] + (3,), np.uint16)
    u16[..., 0] = np.clip(flow[..., 0] * 64.0 + 2.0**15, 0, 65535).astype(np.uint16)
    u16[..., 1] = np.clip(flow[..., 1] * 64.0 + 2.0**15, 0, 65535).astype(np.uint16)
    u16[..., 2] = (valid > 0).astype(np.uint16)
    return u16


def decode_kitti_disparity(png: np.ndarray):
    """(H, W) uint16 KITTI disparity PNG -> (disp (H,W) f32, valid (H,W) f32)."""
    png = np.asarray(png)
    if png.dtype != np.uint16:
        raise ValueError(f"KITTI disparity PNG must be uint16, got {png.dtype}")
    valid = (png > 0).astype(np.float32)
    return png.astype(np.float32) / 256.0, valid


def encode_kitti_disparity(disp: np.ndarray, valid: np.ndarray) -> np.ndarray:
    out = np.clip(disp * 256.0, 0, 65535).astype(np.uint16)
    return np.where(valid > 0, np.maximum(out, 1), 0).astype(np.uint16)


def labelids_to_trainids(labels: np.ndarray) -> np.ndarray:
    """Cityscapes labelId image -> trainId image (255 = ignore)."""
    return CITYSCAPES_LABELID_TO_TRAINID[np.asarray(labels, np.uint8)]


def trainids_to_labelids(train_ids: np.ndarray) -> np.ndarray:
    """The labelId of each trainId (the first in the table), 0
    ('unlabeled') for 255; writes the fixtures."""
    inverse = np.zeros(256, np.uint8)
    for label_id in range(255, -1, -1):
        t = _LUT[label_id]
        if t != 255:
            inverse[t] = label_id
    return inverse[np.asarray(train_ids, np.uint8)]


def decode_cityscapes_disparity(png: np.ndarray):
    """Cityscapes precomputed disparity PNG: d = (val - 1) / 256, val > 0."""
    png = np.asarray(png)
    valid = (png > 0).astype(np.float32)
    disp = np.where(png > 0, (png.astype(np.float32) - 1.0) / 256.0, 0.0)
    return disp.astype(np.float32), valid


def encode_cityscapes_disparity(disp: np.ndarray, valid: np.ndarray):
    """Inverse of decode_cityscapes_disparity (writes the fixtures)."""
    val = np.clip(np.round(np.asarray(disp) * 256.0) + 1, 1, 65535)
    return np.where(valid > 0, val, 0).astype(np.uint16)


# ---------------------------------------------------------------- device


def resize_bilinear(x, out_hw):
    """(B, H, W, C) float -> (B, *out_hw, C): ``jax.image.resize``'s
    "bilinear", separable, antialiased along an axis it shrinks. Along an
    axis it keeps or grows, the antialiased filter is the plain bilinear
    one, which the card computes to float32 rounding; torch's antialiased
    kernel on the card strays about 2e-5 from the CPU's there, so it runs
    only where it is needed: one call when both axes shrink or neither
    does, else one call an axis."""
    (h, w), (oh, ow) = x.shape[1:3], tuple(out_hw)
    y = x.permute(0, 3, 1, 2)
    if (oh < h) == (ow < w):
        y = F.interpolate(y, size=(oh, ow), mode="bilinear",
                          align_corners=False, antialias=oh < h)
    else:
        for size, shrinks in (((oh, w), oh < h), ((oh, ow), ow < w)):
            y = F.interpolate(y, size=size, mode="bilinear",
                              align_corners=False, antialias=shrinks)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x, out_hw):
    """(B, H, W, ...) of any type -> (B, *out_hw, ...): ``jax.image.resize``'s
    "nearest", source index floor((i + 0.5) * in / out) in float32."""
    for dim, n in ((1, out_hw[0]), (2, out_hw[1])):
        m = x.shape[dim]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device)
                    + 0.5) * m / n).floor().long()
            x = x.index_select(dim, idx)
    return x


def preprocess_image(img_u8, out_hw=None):
    """uint8 (B, H, W, 3) -> normalised float32 NHWC, resized to
    ``out_hw`` when given and different."""
    x = img_u8.float() / 255.0
    if out_hw is not None and tuple(out_hw) != tuple(x.shape[1:3]):
        x = resize_bilinear(x, out_hw)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x - mean) / std


def resize_flow(flow, valid, out_hw):
    """Flow (B, H, W, 2) and valid (B, H, W) to ``out_hw``, the values
    scaled by (s_x, s_y)."""
    b, h, w, _ = flow.shape
    sy, sx = out_hw[0] / h, out_hw[1] / w
    scale = torch.tensor([sx, sy], dtype=torch.float32, device=flow.device)
    return resize_nearest(flow, out_hw) * scale, resize_nearest(valid, out_hw)


def resize_disparity(disp, valid, out_hw):
    """Disparity (B, H, W) and valid to ``out_hw``, the values scaled by
    s_x."""
    sx = out_hw[1] / disp.shape[2]
    return resize_nearest(disp, out_hw) * sx, resize_nearest(valid, out_hw)


def resize_labels(labels, out_hw):
    return resize_nearest(labels, out_hw)
