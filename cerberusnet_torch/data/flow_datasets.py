"""The PWC-Net lineage's flow and stereo training sets, port of
``cerberusnet_tpu/data/flow_datasets.py``: MPI-Sintel, FlyingChairs and
FlyingThings3D.

The flow head's canonical schedule is FlyingChairs -> FlyingThings3D ->
Sintel or KITTI. Each returns the reference's sample dict with its types:
uint8 (H, W, 3) frames, flow anchored at ``left`` toward ``temporal`` as
float32 (H, W, 2), and a float32 valid mask, all ones for dense ground
truth, so the masked losses and metrics treat dense and sparse ground
truth alike. Files: Middlebury ``.flo`` (Sintel, FlyingChairs), ``.pfm``
(FlyingThings3D's flow and disparity, rows top-down, the flow's third
channel dropped) and FlyingChairs' binary ``.ppm`` frames, read by
``data/io.py``.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from cerberusnet_torch.data import io as data_io


def _ones_valid(arr: np.ndarray) -> np.ndarray:
    return np.ones(arr.shape[:2], np.float32)


class SintelDataset:
    """MPI-Sintel optical flow (clean or final pass).

    Layout::

      root/training/{clean,final}/<scene>/frame_%04d.png   frames 1..N
      root/training/flow/<scene>/frame_%04d.flo            t -> t+1, 1..N-1
      root/training/invalid/<scene>/frame_%04d.png         nonzero = invalid

    One sample per pair of consecutive frames (frame b = a + 1). The test
    split has no flow or invalid directories; its samples carry the frames
    alone."""

    def __init__(self, root: str, split: str = "training",
                 render_pass: str = "clean"):
        self.base = os.path.join(root, split)
        img_root = os.path.join(self.base, render_pass)
        if not os.path.isdir(img_root):
            raise FileNotFoundError(f"no {render_pass}/ under {self.base}")
        self.render_pass = render_pass
        self.pairs = []  # (scene, frame index), the next frame present
        for scene in sorted(os.listdir(img_root)):
            frames = sorted(glob(os.path.join(img_root, scene, "frame_*.png")))
            for a, b in zip(frames, frames[1:]):
                ia = int(os.path.basename(a)[6:10])
                ib = int(os.path.basename(b)[6:10])
                if ib == ia + 1:
                    self.pairs.append((scene, ia))

    def __len__(self):
        return len(self.pairs)

    def _p(self, kind: str, scene: str, idx: int, ext: str) -> str:
        return os.path.join(self.base, kind, scene, f"frame_{idx:04d}.{ext}")

    def __getitem__(self, i: int):
        scene, t = self.pairs[i]
        sample = {
            "left": data_io.read_image_u8(
                self._p(self.render_pass, scene, t, "png")),
            "temporal": data_io.read_image_u8(
                self._p(self.render_pass, scene, t + 1, "png")),
        }
        flo = self._p("flow", scene, t, "flo")
        if os.path.exists(flo):
            flow = data_io.read_flo(flo)
            sample["flow_gt"] = flow
            invalid = self._p("invalid", scene, t, "png")
            if os.path.exists(invalid):
                sample["flow_valid"] = (
                    data_io.read_image_gray_u8(invalid) == 0
                ).astype(np.float32)
            else:
                sample["flow_valid"] = _ones_valid(flow)
        return sample


class FlyingChairsDataset:
    """FlyingChairs (22k synthetic pairs with dense ``.flo`` ground truth).

    Layout: ``root/data/NNNNN_img1.ppm, NNNNN_img2.ppm, NNNNN_flow.flo``
    (5-digit ids), or those files in ``root`` itself. A split file (the
    public ``FlyingChairs_train_val.txt``, found in ``root`` when not given:
    one '1' = train or '2' = val per id, in id order) keeps the chosen
    split. A flag is read by its id, not by the file's position among those
    present, and an id past the file's end raises."""

    def __init__(self, root: str, split: str = "train",
                 split_file: str | None = None):
        data_dir = os.path.join(root, "data")
        if not os.path.isdir(data_dir):
            data_dir = root
        self.data_dir = data_dir
        ids = sorted(os.path.basename(p)[:5]
                     for p in glob(os.path.join(data_dir, "*_flow.flo")))
        if split_file is None:
            cand = os.path.join(root, "FlyingChairs_train_val.txt")
            split_file = cand if os.path.exists(cand) else None
        if split_file is not None:
            # DataConfig's default split is "training": both spellings train
            want = "1" if split in ("train", "training") else "2"
            with open(split_file) as f:
                flags = [ln.strip() for ln in f if ln.strip()]
            kept = []
            for sid in ids:
                pos = int(sid) - 1
                if pos < 0 or pos >= len(flags):
                    raise ValueError(
                        f"id {sid} outside split file ({len(flags)} rows) — "
                        f"data dir and {os.path.basename(split_file)} "
                        f"disagree")
                if flags[pos] == want:
                    kept.append(sid)
            ids = kept
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int):
        sid = self.ids[i]

        def p(suffix):
            return os.path.join(self.data_dir, f"{sid}_{suffix}")

        flow = data_io.read_flo(p("flow.flo"))
        return {
            "left": data_io.read_image_u8(p("img1.ppm")),
            "temporal": data_io.read_image_u8(p("img2.ppm")),
            "flow_gt": flow,
            "flow_valid": _ones_valid(flow),
        }


class FlyingThings3DDataset:
    """FlyingThings3D (SceneFlow): stereo pairs with dense flow and dense
    disparity, every ground truth of the joint model but segmentation.

    Layout (the official release)::

      root/frames_cleanpass/TRAIN/A/0000/left/0006.png      (+ right/)
      root/optical_flow/TRAIN/A/0000/into_future/left/
           OpticalFlowIntoFuture_0006_L.pfm                 (u, v, unused)
      root/disparity/TRAIN/A/0000/left/0006.pfm             positive disp

    One sample per pair of consecutive left frames of a sequence. A
    non-finite flow or one of 1000 px or more, and a disparity that is
    non-finite, not positive or 1000 px or more, is masked invalid (and
    zeroed), not clipped."""

    MAX_FLOW = 1000.0
    MAX_DISP = 1000.0

    # the release has TRAIN/ and TEST/ alone; DataConfig's spellings map
    # onto them
    _SPLITS = {"train": "TRAIN", "training": "TRAIN",
               "val": "TEST", "test": "TEST", "validation": "TEST"}

    def __init__(self, root: str, split: str = "TRAIN",
                 render_pass: str = "frames_cleanpass"):
        self.root = root
        self.split = self._SPLITS.get(split.lower(), split.upper())
        self.render_pass = render_pass
        img_root = os.path.join(root, render_pass, self.split)
        if not os.path.isdir(img_root):
            raise FileNotFoundError(
                f"no {render_pass}/{self.split} under {root}")
        self.pairs = []  # (subset, sequence, frame index)
        for subset in sorted(os.listdir(img_root)):
            for seq in sorted(os.listdir(os.path.join(img_root, subset))):
                frames = sorted(glob(
                    os.path.join(img_root, subset, seq, "left", "*.png")))
                for a, b in zip(frames, frames[1:]):
                    ia = int(os.path.splitext(os.path.basename(a))[0])
                    ib = int(os.path.splitext(os.path.basename(b))[0])
                    if ib == ia + 1:
                        self.pairs.append((subset, seq, ia))

    def __len__(self):
        return len(self.pairs)

    def _img(self, subset, seq, cam, idx):
        return os.path.join(self.root, self.render_pass, self.split, subset,
                            seq, cam, f"{idx:04d}.png")

    def __getitem__(self, i: int):
        subset, seq, t = self.pairs[i]
        sample = {
            "left": data_io.read_image_u8(self._img(subset, seq, "left", t)),
            "right": data_io.read_image_u8(self._img(subset, seq, "right", t)),
            "temporal": data_io.read_image_u8(
                self._img(subset, seq, "left", t + 1)),
        }
        flow_pfm = os.path.join(
            self.root, "optical_flow", self.split, subset, seq, "into_future",
            "left", f"OpticalFlowIntoFuture_{t:04d}_L.pfm")
        if os.path.exists(flow_pfm):
            flow = data_io.read_pfm(flow_pfm)[..., :2]
            finite = np.isfinite(flow).all(-1) & (
                np.abs(flow).max(-1) < self.MAX_FLOW)
            sample["flow_gt"] = np.where(finite[..., None], flow,
                                         0.0).astype(np.float32)
            sample["flow_valid"] = finite.astype(np.float32)
        disp_pfm = os.path.join(self.root, "disparity", self.split, subset,
                                seq, "left", f"{t:04d}.pfm")
        if os.path.exists(disp_pfm):
            disp = data_io.read_pfm(disp_pfm)
            finite = np.isfinite(disp) & (disp > 0) & (disp < self.MAX_DISP)
            sample["disp_gt"] = np.where(finite, disp, 0.0).astype(np.float32)
            sample["disp_valid"] = finite.astype(np.float32)
        return sample
