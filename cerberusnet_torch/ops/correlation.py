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

Their gradients, for the cost volume's gradient g (the formulas of
``cerberusnet_tpu/ops/pallas/correlation.py``), are

  2-D:  df1(x) = (1/C) * sum_o g(x, o) * f2(x + o)
        df2(y) = (1/C) * sum_o g(y - o, o) * f1(y - o)
  1-D:  df1(x) = (1/C) * sum_k g(x, k) * f2(x - k)
        df2(x) = (1/C) * sum_k g(x + k, k) * f1(x + k)

with offsets scaled by the dilation, out-of-frame terms zero, sums in
float32, one division by C and one cast.

Dispatch: a CUDA tensor goes through the operators ``cerberus::corr2d_fwd``
/ ``cerberus::corr1d_fwd`` (``ops/library.py``), whose forward and backward
are the hand-written kernels (``ops/cuda/correlation.py``), or the call
raises; a CPU tensor goes to the plain forward below, and autograd
differentiates it. ``impl="plain"`` asks
for the plain forward on any device, as a yardstick for the kernels.

On a spatial mesh (``spatial``, ``parallel/mesh.py``) f1 and f2 are a
rank's band of rows. ``correlation2d`` reads f2 up to max_disp * dilation
rows away: it runs on f2 with that many rows of halo from the neighbouring
bands (``parallel/halo.py``; zeros outside the frame, as the plain op's
padding) and f1 padded alike with zeros, and keeps the band's rows of the
cost volume. The kernels stay as they are: K3's gradient of the halo rows
goes back to their owners with the halo's backward. ``correlation1d``
reads along W alone, so it runs on the band as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cerberusnet_torch.ops import library
from cerberusnet_torch.parallel.halo import halo_rows

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
            maps.append((f1f * shifted).sum(-1))
    # the division and the rounding are elementwise, so once over the
    # stack: the values of one a map, and a third fewer nodes in an
    # exported program
    return (torch.stack(maps, dim=-1) / c).to(f1.dtype)


def _correlation1d_plain(f1, f2, max_disp: int, dilation: int = 1):
    """One shifted multiply-sum per displacement (``_correlation1d_pure``)."""
    b, h, w, c = f1.shape
    dmax = max_disp * dilation
    f1f = f1.float()
    f2p = F.pad(f2.float(), (0, 0, dmax, 0))
    maps = []
    for k in range(0, dmax + 1, dilation):
        shifted = f2p[:, :, dmax - k : dmax - k + w, :]
        maps.append((f1f * shifted).sum(-1))
    return (torch.stack(maps, dim=-1) / c).to(f1.dtype)


def _correlation2d_bwd_f1_plain(g, f2, max_disp: int, dilation: int = 1):
    """df1(x) = (1/C) sum_o g(x, o) f2(x + o): one shifted multiply-add per
    displacement (the plain version of ``corr2d_bwd_f1``)."""
    b, h, w, c = f2.shape
    d = max_disp * dilation
    gf = g.float()
    f2p = F.pad(f2.float(), (0, 0, d, d, d, d))
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=f2.device)
    k = 0
    for dy in range(0, 2 * d + 1, dilation):
        for dx in range(0, 2 * d + 1, dilation):
            acc += gf[..., k : k + 1] * f2p[:, dy : dy + h, dx : dx + w, :]
            k += 1
    return (acc / c).to(f2.dtype)


def _correlation2d_bwd_f2_plain(g, f1, max_disp: int, dilation: int = 1):
    """df2(y) = (1/C) sum_o g(y - o, o) f1(y - o): g and f1 padded by the
    window radius and read at (2d - dy, 2d - dx) (the plain version of
    ``corr2d_bwd_f2``)."""
    b, h, w, c = f1.shape
    d = max_disp * dilation
    gp = F.pad(g.float(), (0, 0, d, d, d, d))
    f1p = F.pad(f1.float(), (0, 0, d, d, d, d))
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=f1.device)
    k = 0
    for dy in range(0, 2 * d + 1, dilation):
        for dx in range(0, 2 * d + 1, dilation):
            ys = slice(2 * d - dy, 2 * d - dy + h)
            xs = slice(2 * d - dx, 2 * d - dx + w)
            acc += gp[:, ys, xs, k : k + 1] * f1p[:, ys, xs, :]
            k += 1
    return (acc / c).to(f1.dtype)


def _correlation1d_bwd_f1_plain(g, f2, max_disp: int, dilation: int = 1):
    """df1(x) = (1/C) sum_k g(x, k) f2(x - k) (the plain version of
    ``corr1d_bwd_f1``)."""
    b, h, w, c = f2.shape
    dmax = max_disp * dilation
    gf = g.float()
    f2p = F.pad(f2.float(), (0, 0, dmax, 0))
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=f2.device)
    for i, k in enumerate(range(0, dmax + 1, dilation)):
        acc += gf[..., i : i + 1] * f2p[:, :, dmax - k : dmax - k + w, :]
    return (acc / c).to(f2.dtype)


def _correlation1d_bwd_f2_plain(g, f1, max_disp: int, dilation: int = 1):
    """df2(x) = (1/C) sum_k g(x + k, k) f1(x + k): g and f1 padded on the
    right (the plain version of ``corr1d_bwd_f2``)."""
    b, h, w, c = f1.shape
    dmax = max_disp * dilation
    gp = F.pad(g.float(), (0, 0, 0, dmax))
    f1p = F.pad(f1.float(), (0, 0, 0, dmax))
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=f1.device)
    for i, k in enumerate(range(0, dmax + 1, dilation)):
        acc += gp[:, :, k : k + w, i : i + 1] * f1p[:, :, k : k + w, :]
    return (acc / c).to(f1.dtype)


def _correlation2d_bwd_plain(g, f1, f2, max_disp: int, dilation: int = 1):
    """(df1, df2) of the 2-D op for the cost volume's gradient g."""
    return (_correlation2d_bwd_f1_plain(g, f2, max_disp, dilation),
            _correlation2d_bwd_f2_plain(g, f1, max_disp, dilation))


def _correlation1d_bwd_plain(g, f1, f2, max_disp: int, dilation: int = 1):
    """(df1, df2) of the 1-D op for the cost volume's gradient g."""
    return (_correlation1d_bwd_f1_plain(g, f2, max_disp, dilation),
            _correlation1d_bwd_f2_plain(g, f1, max_disp, dilation))


def _dispatch(f1, f2, impl):
    if f1.shape != f2.shape:
        raise ValueError(f"f1/f2 shape mismatch: {tuple(f1.shape)} vs "
                         f"{tuple(f2.shape)}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return impl == "plain" or f1.device.type == "cpu"


def correlation2d(f1, f2, max_disp: int = 4, dilation: int = 1,
                  impl: str | None = None, spatial=None):
    """2-D correlation. (B,H,W,C) x2 -> (B,H,W,(2*max_disp+1)**2).
    ``spatial``: f1 and f2 are bands of rows of that mesh."""
    if spatial is not None:
        reach, hb = max_disp * dilation, f1.shape[1]
        f2 = halo_rows(f2, reach, reach, spatial, dim=1)
        f1 = F.pad(f1, (0, 0, 0, 0, reach, reach))
        return correlation2d(f1, f2, max_disp, dilation, impl).narrow(
            1, reach, hb)
    if _dispatch(f1, f2, impl):
        return _correlation2d_plain(f1, f2, max_disp, dilation)
    return library.corr2d_fwd(f1, f2, max_disp, dilation)


def correlation1d(f1, f2, max_disp: int = 24, dilation: int = 1,
                  impl: str | None = None):
    """1-D epipolar correlation. (B,H,W,C) x2 -> (B,H,W,max_disp+1).

    ``f1`` holds the left-image features and ``f2`` the right-image ones."""
    if _dispatch(f1, f2, impl):
        return _correlation1d_plain(f1, f2, max_disp, dilation)
    return library.corr1d_fwd(f1, f2, max_disp, dilation)
