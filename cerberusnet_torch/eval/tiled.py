"""Tiled (sliding-window) inference for frames larger than one pass, port
of ``cerberusnet_tpu/eval/tiled.py``.

The image is cut into overlapping windows of one shape, the model runs on
each (one after another, or all in one forward at batch B x tiles with
``batch_tiles``), and the outputs are blended back with separable
triangular windows, strictly positive so no seam gets zero weight. Seg
logits, flow and disparity blend linearly: flow and disparity values do
not depend on where a tile starts. The reference caches one jitted
forward per function; eager PyTorch needs no counterpart, and every tile
has the same shape.
"""

from __future__ import annotations

import numpy as np
import torch


def _starts(full: int, tile: int, stride: int):
    """Window starts covering [0, full), the last window flush."""
    if tile >= full:
        return [0]
    s = list(range(0, full - tile, stride))
    s.append(full - tile)
    return s


def _tri_window(n: int):
    ramp = np.minimum(np.arange(1, n + 1),
                      np.arange(n, 0, -1)).astype(np.float32)
    return ramp / ramp.max()


def _slice_leaves(tree, lo: int, hi: int):
    """Rows [lo, hi) of every tensor in a nested dict of outputs (the
    pyramids are dicts by level)."""
    if isinstance(tree, dict):
        return {k: _slice_leaves(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi] if isinstance(tree, torch.Tensor) else tree


def tiled_forward(forward, batch, tile_hw, overlap: float = 0.25,
                  batch_tiles: bool = False):
    """``forward`` over overlapping tiles, blended.

    forward: ``forward(batch) -> outputs dict`` (the trainer's forward);
    batch: dict of (B, H, W, 3) inputs (left / right / temporal ...);
    tile_hw: (th, tw), the window the model takes; overlap: the fraction
    of a tile shared with its neighbour (0..0.9); batch_tiles: every
    window in one forward at batch B x tiles (the same arithmetic, one
    call; tiles times the activation memory).

    Returns the blended full-resolution ``seg_logits`` / ``flow`` /
    ``disp`` (float32)."""
    th, tw = tile_hw
    ref = next(iter(batch.values()))
    b, h, w = ref.shape[:3]
    sy = max(int(th * (1 - overlap)), 1)
    sx = max(int(tw * (1 - overlap)), 1)
    wmask = torch.from_numpy(np.outer(_tri_window(min(th, h)),
                                      _tri_window(min(tw, w))))
    wmask = wmask.to(ref.device)[None, :, :, None]  # (1, th, tw, 1)
    positions = [(y0, x0) for y0 in _starts(h, th, sy)
                 for x0 in _starts(w, tw, sx)]

    def tile(v, y0, x0):
        return v[:, y0:y0 + th, x0:x0 + tw]

    outs = None
    if batch_tiles and len(positions) > 1:
        big = forward({k: torch.cat([tile(v, *p) for p in positions])
                       for k, v in batch.items()})
        outs = [_slice_leaves(big, i * b, (i + 1) * b)
                for i in range(len(positions))]

    total: dict = {}
    weight = torch.zeros((1, h, w, 1), dtype=torch.float32, device=ref.device)
    for ti, (y0, x0) in enumerate(positions):
        if outs is not None:
            out = outs[ti]
        else:
            out = forward({k: tile(v, y0, x0) for k, v in batch.items()})
        tile(weight, y0, x0).add_(wmask)
        for key in ("seg_logits", "flow", "disp"):
            if key not in out:
                continue
            o = out[key].float() * wmask
            if key not in total:
                total[key] = torch.zeros((b, h, w, o.shape[-1]),
                                         dtype=torch.float32,
                                         device=ref.device)
            tile(total[key], y0, x0).add_(o)
    return {k: v / weight for k, v in total.items()}
