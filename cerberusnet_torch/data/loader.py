"""Batching and device preprocessing, port of ``cerberusnet_tpu/data/loader.py``
(``DataLoader``, ``pad_batch``, ``collate`` and ``make_preprocess_fn``).

``DataLoader`` yields numpy batch dicts in the reference loader's order
(``shuffle``, ``drop_last``, ``seed``; epoch e, counted from 1 by each
iteration, shuffles with ``np.random.RandomState(seed + e)``). As the
reference's, a producer thread decodes each batch's samples on a pool of
``num_workers`` threads (the decoders drop the GIL) and queues up to
``prefetch`` batches ahead of the consumer; a consumer that leaves early
stops it, and an error in a worker reaches the consumer. Under data
parallelism (``mesh``, ``parallel/mesh.py``) ``batch_size`` is the global
batch's: every rank shuffles alike and decodes only its own rows of each
global batch, so the ranks' batches together are the single process's,
in order. With
``pin_memory`` the producer copies each numeric array into page-locked
memory, so ``to_device`` uploads it without blocking the host: the torch
form of the reference's ``device_put`` in its producer. ``pad_batch`` pads
a partial evaluation batch and masks its padding; ``batches`` takes a
dataset's first batches in order.

``to_device`` uploads a batch in its own types (uint8 images are a
quarter of their float size); ``preprocess`` converts it on the device as
``make_preprocess_fn`` does: images from uint8 to float32, /255, resized
(bilinear) to ``hw`` when they have another size, ImageNet mean and std,
then the compute type; labels resized (nearest) to int64; flow, disparity
and their valid masks resized (nearest) to float32 with their values
scaled.
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cerberusnet_torch.data import encodings
from cerberusnet_torch.parallel.mesh import SINGLE

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


def _pinned(batch: dict) -> dict:
    """The batch with each numeric array copied into page-locked memory."""
    return {k: torch.from_numpy(v).pin_memory()
            if v.dtype.kind in "biuf" else v for k, v in batch.items()}


class DataLoader:
    """Batches of ``dataset`` as numpy dicts (or, with ``pin_memory``,
    dicts of page-locked tensors), in the order of the reference's
    ``DataLoader``; each iteration is one epoch.

    With a ``mesh`` of N data ranks each batch is this rank's samples of the
    global batch of ``batch_size`` (which N must divide), whole frames (a
    spatial mesh's peers decode the same samples, and each keeps its band
    after preprocessing), and every rank yields as many batches. Without ``drop_last`` the last global batch is padded
    to ``batch_size`` by repeating its last sample before it is sliced,
    and each batch carries ``"_sample_mask"`` ((B / N,) float32, 0 for the
    padding), as the reference pads and then shards."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = True, seed: int = 0,
                 prefetch: int = 2, pin_memory: bool = False, mesh=SINGLE):
        self.rows = mesh.shard(batch_size)
        self.mesh = mesh
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        for i in range(len(self)):
            yield idx[i * self.batch_size:(i + 1) * self.batch_size]

    def _rank_parts(self):
        """(this rank's indices, its sample mask or None) per batch."""
        for part in self._batch_indices():
            if self.mesh.data_size == 1:
                yield part, None
                continue
            n = len(part)
            part = np.concatenate([part, np.repeat(part[-1:],
                                                   self.batch_size - n)])
            mask = (np.arange(self.batch_size) < n).astype(np.float32)
            yield part[self.rows], (None if self.drop_last
                                    else mask[self.rows])

    def __iter__(self):
        self._epoch += 1
        parts = list(self._rank_parts())
        pool = ThreadPoolExecutor(self.num_workers)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item):
            # gives up when the consumer has left and nothing drains the queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    pass

        def produce():
            try:
                for part, mask in parts:
                    if stop.is_set():
                        return
                    batch = collate(list(pool.map(
                        self.dataset.__getitem__, (int(j) for j in part))))
                    if mask is not None:
                        batch["_sample_mask"] = mask
                    put(_pinned(batch) if self.pin_memory else batch)
                put(done)
            except Exception as e:  # handed to the consumer, raised there
                put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            producer.join()
            pool.shutdown(wait=True)


def to_device(batch: dict, device) -> dict:
    """The batch's numeric arrays as tensors on ``device`` in their own
    types (a page-locked tensor uploads without blocking the host); other
    entries (a sample's ``decoder`` names) stay on the host."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype.kind not in "biuf":
            out[k] = v
        else:
            out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    return out


def preprocess(batch, hw, dtype: torch.dtype, device) -> dict:
    """A numpy (or torch) batch dict -> normalised tensors on ``device``,
    every spatial entry at ``hw``."""
    hw = tuple(hw)
    batch = to_device(batch, device)
    out = {}
    for k in IMAGE_KEYS:
        if k in batch:
            out[k] = encodings.preprocess_image(batch[k], hw).to(dtype)
    if "seg_labels" in batch:
        out["seg_labels"] = encodings.resize_labels(
            batch["seg_labels"].long(), hw)
    if "flow_gt" in batch:
        flow = batch["flow_gt"].float()
        valid = (batch["flow_valid"].float() if "flow_valid" in batch
                 else torch.ones(flow.shape[:3], device=flow.device))
        out["flow_gt"], out["flow_valid"] = encodings.resize_flow(
            flow, valid, hw)
    if "disp_gt" in batch:
        disp = batch["disp_gt"].float()
        valid = (batch["disp_valid"].float() if "disp_valid" in batch
                 else (disp > 0).float())
        out["disp_gt"], out["disp_valid"] = encodings.resize_disparity(
            disp, valid, hw)
    return out
