"""Synthetic stereo/temporal dataset: a copy of ``SyntheticPerceptionDataset``
in ``cerberusnet_tpu/data/synthetic.py`` (numpy only), so the same
``(seed, idx)`` gives the same arrays in both packages.

Each sample is a geometrically consistent triplet: a smooth scene image as
the left view, a right view shifted by a smooth disparity field, a
temporal frame warped by a smooth flow field, segmentation labels that are
a fixed function of the scene's colour, and dense or sparse ground truth.
The reference's KITTI fixture writer is not copied (ROADMAP A6).
"""

from __future__ import annotations

import numpy as np


def _smooth_field(rng, h, w, channels, scale, smoothness=8):
    """Low-frequency random field: nearest-upsampled coarse noise, then a
    box blur."""
    ch, cw = max(h // smoothness, 1), max(w // smoothness, 1)
    coarse = rng.randn(ch, cw, channels).astype(np.float32) * scale
    ys = np.linspace(0, ch - 1, h)
    xs = np.linspace(0, cw - 1, w)
    y0 = np.clip(ys.astype(int), 0, ch - 1)
    x0 = np.clip(xs.astype(int), 0, cw - 1)
    field = coarse[y0][:, x0]
    k = 5
    pad = np.pad(field, ((k, k), (k, k), (0, 0)), mode="edge")
    out = np.zeros_like(field)
    for dy in (-k, 0, k):
        for dx in (-k, 0, k):
            out += pad[k + dy : k + dy + h, k + dx : k + dx + w]
    return out / 9.0


class SyntheticPerceptionDataset:
    """Samples {left, right, temporal (H,W,3 uint8), seg_labels (H,W uint8),
    flow_gt (H,W,2 f32), flow_valid, disp_gt (H,W f32), disp_valid}."""

    def __init__(self, length: int = 16, hw=(256, 512), num_classes: int = 19,
                 max_disp: float = 48.0, max_flow: float = 10.0,
                 sparse: bool = False, seed: int = 0):
        self.length = length
        self.hw = hw
        self.num_classes = num_classes
        self.max_disp = max_disp
        self.max_flow = max_flow
        self.sparse = sparse
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        rng = np.random.RandomState(self.seed * 100003 + idx)
        h, w = self.hw

        base = _smooth_field(rng, h, w, 3, 1.0, smoothness=4)
        base = (base - base.min()) / (np.ptp(base) + 1e-6)
        left = (base * 255).astype(np.uint8)

        disp = np.abs(_smooth_field(rng, h, w, 1, self.max_disp / 3))[..., 0]
        disp = np.clip(disp, 0.0, self.max_disp).astype(np.float32)
        flow = _smooth_field(rng, h, w, 2, self.max_flow / 3).astype(np.float32)

        xs = np.arange(w)[None, :].repeat(h, 0).astype(np.float32)
        ys = np.arange(h)[:, None].repeat(w, 1).astype(np.float32)

        def sample(img, sx, sy):
            ix = np.clip(sx, 0, w - 1).astype(int)
            iy = np.clip(sy, 0, h - 1).astype(int)
            return img[iy, ix]

        # rectified stereo: right(x) == left(x + d)
        right = sample(left, xs + disp, ys).astype(np.uint8)
        # flow anchored at left, by inverse sampling: temporal(y) =
        # left(y - flow(y)), exact to first order for smooth fields
        temporal = sample(left, xs - flow[..., 0], ys - flow[..., 1]
                          ).astype(np.uint8)

        # labels: quantised luminance and red/blue contrast of the scene
        lum = base @ np.array([0.299, 0.587, 0.114], np.float32)
        contrast = (base[..., 0] - base[..., 2]) * 0.5 + 0.5
        score = np.clip(0.75 * lum + 0.25 * contrast, 0.0, 1.0)
        seg = np.minimum((score * self.num_classes).astype(np.int64),
                         self.num_classes - 1).astype(np.uint8)

        if self.sparse:
            mask = (rng.rand(h, w) < 0.3).astype(np.float32)
        else:
            mask = np.ones((h, w), np.float32)

        return {
            "left": left,
            "right": right,
            "temporal": temporal,
            "seg_labels": seg,
            "flow_gt": flow * mask[..., None],
            "flow_valid": mask,
            "disp_gt": disp * mask,
            "disp_valid": mask,
        }
