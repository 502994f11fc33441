"""Batching and device preprocessing, port of ``make_preprocess_fn`` in
``cerberusnet_tpu/data/loader.py`` (and ``preprocess_image`` of
``data/encodings.py``) for the case where the input already has the
working size.

``DataLoader`` yields numpy batch dicts in the reference loader's order
(``shuffle``, ``drop_last``, ``seed``; epoch e, counted from 1 by each
iteration, shuffles with ``np.random.RandomState(seed + e)``), loading
synchronously; ``pad_batch`` pads a partial eval batch and masks its
padding. ``batches`` stacks a dataset's first samples in order.
``preprocess`` uploads a batch in its own types and converts it on the
device: images from uint8 to float32, /255, ImageNet mean and std, then the
compute type; labels to int64; flow, disparity and the valid masks to
float32. Resizing, and the worker pool and prefetch of the reference's
loader, are not ported yet (ROADMAP A6): an input of another size than
``hw`` raises.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

# ImageNet statistics, as in cerberusnet_tpu/data/encodings.py.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

IMAGE_KEYS = ("left", "right", "temporal")


def pad_batch(batch: dict, target_bs: int):
    """Pads a (possibly partial) batch to ``target_bs`` samples by repeating
    the last sample; returns (padded batch, sample mask), the mask (target_bs,)
    float32, 1.0 for a real sample and 0.0 for padding. Evaluation uses it
    with drop_last=False, so every sample counts and none counts twice."""
    n = len(next(iter(batch.values())))
    if n > target_bs:
        raise ValueError(f"batch of {n} exceeds target {target_bs}")
    mask = np.zeros((target_bs,), np.float32)
    mask[:n] = 1.0
    if n == target_bs:
        return batch, mask
    pad = target_bs - n
    out = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
           for k, v in batch.items()}
    return out, mask


def collate(samples):
    """Stacks a list of sample dicts into one batch dict (shared keys)."""
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    return {k: np.stack([s[k] for s in samples]) for k in sorted(keys)}


def batches(dataset, batch_size: int, count: int | None = None):
    """The first ``count`` (default: all) full batches of ``dataset``, in
    order, as a list of numpy batch dicts."""
    n = len(dataset) // batch_size
    count = n if count is None else count
    if count > n:
        raise ValueError(f"{count} batches of {batch_size} asked of a dataset "
                         f"of {len(dataset)} samples")
    return list(itertools.islice(DataLoader(dataset, batch_size), count))


class DataLoader:
    """Batches of ``dataset`` as numpy dicts, in the order of the
    reference's ``DataLoader``; each iteration is one epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        self._epoch += 1
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        for i in range(len(self)):
            part = idx[i * self.batch_size:(i + 1) * self.batch_size]
            yield collate([self.dataset[int(j)] for j in part])


def preprocess(batch, hw, dtype: torch.dtype, device) -> dict:
    """A numpy (or torch) batch dict -> normalised tensors on ``device``."""
    hw = tuple(hw)
    if tuple(batch["left"].shape[1:3]) != hw:
        raise NotImplementedError(
            f"input size {tuple(batch['left'].shape[1:3])} differs from "
            f"data.hw {hw}: resizing is not ported yet (ROADMAP A6)")

    def put(v, dt):
        # upload in the array's own type (uint8 images and labels are a
        # quarter and an eighth of their converted size), convert on the
        # device
        return torch.as_tensor(v).to(device).to(dt)

    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)
    out = {}
    for k in IMAGE_KEYS:
        if k in batch:
            x = put(batch[k], torch.float32) / 255.0
            out[k] = ((x - mean) / std).to(dtype)
    if "seg_labels" in batch:
        out["seg_labels"] = put(batch["seg_labels"], torch.int64)
    if "flow_gt" in batch:
        out["flow_gt"] = put(batch["flow_gt"], torch.float32)
        out["flow_valid"] = (put(batch["flow_valid"], torch.float32)
                             if "flow_valid" in batch else
                             torch.ones(out["flow_gt"].shape[:3], device=device))
    if "disp_gt" in batch:
        out["disp_gt"] = put(batch["disp_gt"], torch.float32)
        out["disp_valid"] = (put(batch["disp_valid"], torch.float32)
                             if "disp_valid" in batch else
                             (out["disp_gt"] > 0).float())
    return out
