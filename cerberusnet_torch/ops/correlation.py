"""Correlation cost volumes: 2-D for optical flow, 1-D for stereo disparity.

Port of ``cerberusnet_tpu/ops/correlation.py`` with the same semantics, on
NHWC tensors (B, H, W, C):

  2-D:  corr(x, o) = (1/C) * sum_c f1_c(x) * f2_c(x + dilation*o),
        o in {-d..d}^2, output channel k = (o_y + d) * (2d+1) + (o_x + d)
  1-D:  corr(x, k) = (1/C) * sum_c f1_c(y, x) * f2_c(y, x - dilation*k),
        k in {0..D} (the right image sampled to the LEFT)

f2 samples outside the frame contribute zero. Products and sums run in
float32 whatever the input type; each map is divided by C, then cast once
to the input type.

Dispatch: a CUDA tensor goes to the hand-written kernel
(``ops/cuda/correlation.py``) or the call raises; a CPU tensor goes to the
plain version below. ``impl="plain"`` asks for the plain version on any
device, as a yardstick for the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cerberusnet_torch.ops.cuda import correlation as cuda_correlation

IMPLS = (None, "plain")


def _correlation2d_plain(f1, f2, max_disp: int, dilation: int = 1):
    """One shifted multiply-sum per displacement (``_correlation2d_pure``)."""
    b, h, w, c = f1.shape
    d = max_disp * dilation
    f1f = f1.float()
    f2p = F.pad(f2.float(), (0, 0, d, d, d, d))
    maps = []
    for dy in range(0, 2 * d + 1, dilation):
        for dx in range(0, 2 * d + 1, dilation):
            shifted = f2p[:, dy : dy + h, dx : dx + w, :]
            maps.append(((f1f * shifted).sum(-1) / c).to(f1.dtype))
    return torch.stack(maps, dim=-1)


def _correlation1d_plain(f1, f2, max_disp: int, dilation: int = 1):
    """One shifted multiply-sum per displacement (``_correlation1d_pure``)."""
    b, h, w, c = f1.shape
    dmax = max_disp * dilation
    f1f = f1.float()
    f2p = F.pad(f2.float(), (0, 0, dmax, 0))
    maps = []
    for k in range(0, dmax + 1, dilation):
        shifted = f2p[:, :, dmax - k : dmax - k + w, :]
        maps.append(((f1f * shifted).sum(-1) / c).to(f1.dtype))
    return torch.stack(maps, dim=-1)


def _dispatch(f1, f2, impl):
    if f1.shape != f2.shape:
        raise ValueError(f"f1/f2 shape mismatch: {tuple(f1.shape)} vs "
                         f"{tuple(f2.shape)}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return impl == "plain" or f1.device.type == "cpu"


def correlation2d(f1, f2, max_disp: int = 4, dilation: int = 1,
                  impl: str | None = None):
    """2-D correlation. (B,H,W,C) x2 -> (B,H,W,(2*max_disp+1)**2)."""
    if _dispatch(f1, f2, impl):
        return _correlation2d_plain(f1, f2, max_disp, dilation)
    return cuda_correlation.corr2d_fwd(f1, f2, max_disp, dilation)


def correlation1d(f1, f2, max_disp: int = 24, dilation: int = 1,
                  impl: str | None = None):
    """1-D epipolar correlation. (B,H,W,C) x2 -> (B,H,W,max_disp+1).

    ``f1`` holds the left-image features and ``f2`` the right-image ones."""
    if _dispatch(f1, f2, impl):
        return _correlation1d_plain(f1, f2, max_disp, dilation)
    return cuda_correlation.corr1d_fwd(f1, f2, max_disp, dilation)
