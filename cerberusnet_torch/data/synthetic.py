"""Synthetic stereo/temporal dataset: a copy of ``SyntheticPerceptionDataset``
in ``cerberusnet_tpu/data/synthetic.py`` (numpy only), so the same
``(seed, idx)`` gives the same arrays in both packages.

Each sample is a geometrically consistent triplet: a smooth scene image as
the left view, a right view shifted by a smooth disparity field, a
temporal frame warped by a smooth flow field, segmentation labels that are
a fixed function of the scene's colour, and dense or sparse ground truth.

``write_kitti_fixture`` writes samples in the KITTI-2015 layout with
16-bit ground truth (a copy of the reference's writer, through the port's
PNG writer), ``write_cityscapes_fixture`` in the Cityscapes layout
(labelIds and the 16-bit disparity): the datasets of ``data/kitti.py`` and
``data/cityscapes.py`` read them back.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from cerberusnet_torch.data import encodings


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


def _each(fn, n: int, workers: int):
    """fn(i) for i < n on ``workers`` threads (numpy and zlib drop the
    GIL); raises the first error."""
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        for _ in pool.map(fn, range(n)):
            pass


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

    # -- fixture writers -----------------------------------------------------

    def write_kitti_fixture(self, root: str, n: int = 2, workers: int = 1):
        """Writes the first ``n`` samples under ``root`` in the KITTI-2015
        layout: left as image_2/_10, temporal as image_2/_11 (KITTI's flow
        maps _10 -> _11), right as image_3/_10, and the 16-bit flow_occ and
        disp_occ_0 ground truth anchored at _10; ``workers`` threads make
        and write the samples."""
        from cerberusnet_torch.data import io as data_io

        for sub in ("image_2", "image_3", "flow_occ", "disp_occ_0"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)

        def write(i):
            s = self[i]
            name, name11 = f"{i:06d}_10.png", f"{i:06d}_11.png"
            data_io.write_image_u8(os.path.join(root, "image_2", name),
                                   s["left"])
            data_io.write_image_u8(os.path.join(root, "image_2", name11),
                                   s["temporal"])
            data_io.write_image_u8(os.path.join(root, "image_3", name),
                                   s["right"])
            data_io.write_png16(
                os.path.join(root, "flow_occ", name),
                encodings.encode_kitti_flow(s["flow_gt"], s["flow_valid"]))
            data_io.write_png16(
                os.path.join(root, "disp_occ_0", name),
                encodings.encode_kitti_disparity(s["disp_gt"],
                                                 s["disp_valid"]))

        _each(write, n, workers)

    def write_cityscapes_fixture(self, root: str, n: int = 2,
                                 split: str = "train", workers: int = 1):
        """Writes the first ``n`` samples under ``root`` in the Cityscapes
        layout of ``split`` (city "synthcity", sequence 000000, frame i):
        leftImg8bit, rightImg8bit, gtFine labelIds (each trainId's
        labelId) and the 16-bit disparity, ``workers`` threads making and
        writing them. No sequence package, so the dataset's temporal frame
        is the left one."""
        from cerberusnet_torch.data import io as data_io

        city = "synthcity"

        def write(i):
            s = self[i]
            base = f"{city}_000000_{i:06d}"
            for kind, suffix, img, save in (
                    ("leftImg8bit", "leftImg8bit", s["left"],
                     data_io.write_image_u8),
                    ("rightImg8bit", "rightImg8bit", s["right"],
                     data_io.write_image_u8),
                    ("gtFine", "gtFine_labelIds",
                     encodings.trainids_to_labelids(s["seg_labels"]),
                     data_io.write_image_u8),
                    ("disparity", "disparity",
                     encodings.encode_cityscapes_disparity(
                         s["disp_gt"], s["disp_valid"]),
                     data_io.write_png16)):
                d = os.path.join(root, kind, split, city)
                os.makedirs(d, exist_ok=True)
                save(os.path.join(d, f"{base}_{suffix}.png"), img)

        _each(write, n, workers)
