"""Cityscapes dataset, port of ``cerberusnet_tpu/data/cityscapes.py``.

Layout (the standard package):
  root/leftImg8bit/{split}/{city}/{city}_{seq}_{frame}_leftImg8bit.png
  root/rightImg8bit/...                      (stereo pair)
  root/gtFine/{split}/{city}/..._gtFine_labelIds.png   (labelIds)
  root/disparity/{split}/{city}/..._disparity.png      (16-bit)
  root/leftImg8bit_sequence/...              (optional, the previous frame)

labelIds map to the 19 trainIds (ignore 255); the disparity decodes as
(val - 1)/256. The temporal frame is the previous sequence frame when the
sequence package has it, else the left image itself (Cityscapes has no
flow ground truth). A sample's ``decoder`` names the PNG decoders that
read it, as the KITTI dataset's.
"""

from __future__ import annotations

import os
from glob import glob

from cerberusnet_torch.data import encodings
from cerberusnet_torch.data import io as data_io
from cerberusnet_torch.data.kitti import decoder_of


class CityscapesDataset:
    def __init__(self, root: str, split: str = "train"):
        self.root = root
        self.split = split
        pattern = os.path.join(root, "leftImg8bit", split, "*",
                               "*_leftImg8bit.png")
        self.left_paths = sorted(glob(pattern))
        if not self.left_paths:
            raise FileNotFoundError(f"no Cityscapes images under {pattern}")

    def __len__(self):
        return len(self.left_paths)

    def _sibling(self, left_path: str, kind: str, suffix: str):
        rel = os.path.relpath(left_path, os.path.join(self.root, "leftImg8bit"))
        return os.path.join(self.root, kind,
                            rel.replace("_leftImg8bit.png", suffix))

    def __getitem__(self, idx: int):
        lp = self.left_paths[idx]
        used: list = []
        sample = {"left": data_io.read_image_u8(lp, used)}

        rp = self._sibling(lp, "rightImg8bit", "_rightImg8bit.png")
        if os.path.exists(rp):
            sample["right"] = data_io.read_image_u8(rp, used)

        city, seq, frame, _ = os.path.basename(lp).split("_")
        prev_path = os.path.join(
            self.root, "leftImg8bit_sequence", self.split, city,
            f"{city}_{seq}_{int(frame) - 1:06d}_leftImg8bit.png")
        sample["temporal"] = (data_io.read_image_u8(prev_path, used)
                              if os.path.exists(prev_path)
                              else sample["left"])

        gt = self._sibling(lp, "gtFine", "_gtFine_labelIds.png")
        if os.path.exists(gt):
            sample["seg_labels"] = encodings.labelids_to_trainids(
                data_io.read_image_gray_u8(gt, used))

        dp = self._sibling(lp, "disparity", "_disparity.png")
        if os.path.exists(dp):
            disp, valid = encodings.decode_cityscapes_disparity(
                data_io.read_png16(dp, used))
            sample["disp_gt"] = disp
            sample["disp_valid"] = valid
        sample["decoder"] = decoder_of(used)
        return sample
