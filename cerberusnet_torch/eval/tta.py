"""Test-time augmentation (multi-scale and horizontal flip), port of
``cerberusnet_tpu/eval/tta.py``.

Predictions are averaged over resized and mirrored inputs, each brought
back by its task's inverse:

  * seg logits: resized back to the base resolution; un-flipped.
  * flow: resized back and its (u, v) values scaled by the inverse scale
    factors (flow is in pixels); un-flipping negates u.
  * disparity: resized back, its values / s_x.

Seg and flow are anchored at the left camera, so their mirrored pass
takes mirror(left), mirror(right) and mirror(temporal) without swapping
the stereo pair. A mirrored stereo pair is geometric only with the views
swapped, and even then the un-flipped result is the right view's
disparity, an approximation of the left's; so a disparity's mirrored pass
is opt-in (``disp_flip="swap"``) and ``"skip"`` (scales alone) is the
default.

The resizes are ``encodings.resize_bilinear``, ``jax.image.resize``'s
"bilinear" (antialiased along an axis it shrinks), computed in float32.
Tensors are NHWC, as the port's models take and return them. A scale at
which a model cannot run raises the model's error: CerberusNet's warp
refuses a frame whose sides are not multiples of 64, as the reference's
does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cerberusnet_torch.data.encodings import resize_bilinear


def _resize(x, hw):
    """x (B, H, W, C) resized to ``hw`` in float32, back in x's type."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return resize_bilinear(x.float(), hw).to(x.dtype)


def _flip_batch(batch, swap_stereo: bool):
    """Every input mirrored; the stereo pair swapped with ``swap_stereo``."""
    out = {k: v.flip(2) for k, v in batch.items()}
    if swap_stereo and "left" in out and "right" in out:
        out["left"], out["right"] = out["right"], out["left"]
    return out


def _one_pass(forward, batch, scale, base_hw, *, flip, swap_stereo, keep):
    """One forward at ``scale`` (mirrored if ``flip``); the predictions in
    ``keep`` (None: all) brought back to ``base_hw``, float32."""
    h, w = base_hw
    sh, sw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    fed = {k: _resize(v, (sh, sw)) for k, v in batch.items()}
    if flip:
        fed = _flip_batch(fed, swap_stereo)
    out = forward(fed)

    acc = {}
    if "seg_logits" in out and (keep is None or "seg_logits" in keep):
        seg = out["seg_logits"].float()
        if flip:
            seg = seg.flip(2)
        acc["seg_logits"] = _resize(seg, (h, w))
    if "flow" in out and (keep is None or "flow" in keep):
        flow = out["flow"].float()
        if flip:
            flow = flow.flip(2) * flow.new_tensor([-1.0, 1.0])
        acc["flow"] = _resize(flow, (h, w)) * flow.new_tensor([w / sw, h / sh])
    if "disp" in out and (keep is None or "disp" in keep):
        disp = out["disp"].float()
        if flip:
            disp = disp.flip(2)
        acc["disp"] = _resize(disp, (h, w)) * (w / sw)
    return acc


def tta_forward(forward, batch, scales: Sequence[float] = (1.0,),
                flip: bool = False, disp_flip: str = "skip"):
    """The predictions averaged over ``scales`` x {identity, mirror}.

    forward: ``forward(batch) -> outputs dict`` (the trainer's forward);
    batch: dict of (B, H, W, 3) inputs (left / right / temporal ...);
    disp_flip: "skip" (disparity averages over the scales alone; exact) or
    "swap" (a swapped-pair mirrored pass: the right view's disparity, an
    approximation). Returns the averaged full-resolution ``seg_logits`` /
    ``flow`` / ``disp`` the model produces, float32. With flip on,
    seg and flow average over 2 len(scales) passes, disparity over
    len(scales) (2 len(scales) with "swap")."""
    if disp_flip not in ("skip", "swap"):
        raise ValueError(
            f"disp_flip must be 'skip' or 'swap', got {disp_flip!r}")
    base_hw = tuple(next(iter(batch.values())).shape[1:3])
    total, counts = {}, {}

    def add(acc):
        for k, v in acc.items():
            total[k] = v if k not in total else total[k] + v
            counts[k] = counts.get(k, 0) + 1

    for s in scales:
        acc = _one_pass(forward, batch, s, base_hw, flip=False,
                        swap_stereo=False, keep=None)
        add(acc)
        if not flip:
            continue
        produces = set(acc)
        # left-anchored tasks: mirrored, the stereo pair not swapped
        if produces & {"seg_logits", "flow"}:
            add(_one_pass(forward, batch, s, base_hw, flip=True,
                          swap_stereo=False, keep={"seg_logits", "flow"}))
        # disparity: the swapped-pair mirrored pass, opt-in
        if "disp" in produces and disp_flip == "swap":
            add(_one_pass(forward, batch, s, base_hw, flip=True,
                          swap_stereo=True, keep={"disp"}))
    return {k: v / counts[k] for k, v in total.items()}
