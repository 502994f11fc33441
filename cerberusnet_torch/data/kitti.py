"""KITTI-2015 stereo and flow dataset, port of
``cerberusnet_tpu/data/kitti.py``.

Layout (the scene-flow training split):
  root/image_2/XXXXXX_10.png, XXXXXX_11.png   left camera, frames t, t+1
  root/image_3/XXXXXX_10.png                  right camera, frame t
  root/flow_occ/XXXXXX_10.png                 16-bit flow GT (t -> t+1)
  root/disp_occ_0/XXXXXX_10.png               16-bit disparity GT (frame t)

A sample: left = image_2/_10 (where the ground truth is anchored),
temporal = image_2/_11 (flow maps left -> temporal), right = image_3/_10
when present, flow_gt/flow_valid and disp_gt/disp_valid when present, and
``decoder``: "native" when the native decoder read every PNG of the
sample, else "zlib" or "native+zlib".
"""

from __future__ import annotations

import os
from glob import glob

from cerberusnet_torch.data import encodings
from cerberusnet_torch.data import io as data_io


def decoder_of(decoded_by: list) -> str:
    """The ``decoder`` entry of a sample from the decoders its reads used."""
    return "+".join(sorted(set(decoded_by)))


class Kitti2015Dataset:
    def __init__(self, root: str, split: str = "training"):
        self.root = os.path.join(root, split) if split else root
        if not os.path.isdir(os.path.join(self.root, "image_2")):
            # a directory holding image_2/ itself
            if os.path.isdir(os.path.join(root, "image_2")):
                self.root = root
            else:
                raise FileNotFoundError(f"no image_2/ under {self.root}")
        self.ids = sorted(
            os.path.basename(p)[:6]
            for p in glob(os.path.join(self.root, "image_2", "*_10.png")))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int):
        sid = self.ids[idx]
        used: list = []

        def p(sub, frame):
            return os.path.join(self.root, sub, f"{sid}_{frame}.png")

        sample = {
            "left": data_io.read_image_u8(p("image_2", "10"), used),
            "temporal": data_io.read_image_u8(p("image_2", "11"), used),
        }
        right = p("image_3", "10")
        if os.path.exists(right):
            sample["right"] = data_io.read_image_u8(right, used)
        flow_path = p("flow_occ", "10")
        if os.path.exists(flow_path):
            flow, valid = encodings.decode_kitti_flow(
                data_io.read_png16(flow_path, used))
            sample["flow_gt"] = flow
            sample["flow_valid"] = valid
        disp_path = p("disp_occ_0", "10")
        if os.path.exists(disp_path):
            disp, valid = encodings.decode_kitti_disparity(
                data_io.read_png16(disp_path, used))
            sample["disp_gt"] = disp
            sample["disp_valid"] = valid
        sample["decoder"] = decoder_of(used)
        return sample
