"""Bilinear backward warping, port of ``cerberusnet_tpu/ops/warp.py``.

  warp(f, w)(x) = sum_{q in N4(x + w(x))} bilinear_weight(q, x + w(x)) * f(q)

Each of the four corners is masked on its own: a corner outside the frame
contributes zero (the flownet2 ``resample2d`` convention). Weights and the
sum are float32; the output has the input's type. Tensors are NHWC and the
flow's channels are (u, v) = (x, y) displacements in pixels.

The four corner gathers follow the JAX formulation rather than
``grid_sample``: with ``align_corners=True`` that op maps a one-pixel-wide
map through (w - 1) = 0 and ignores the flow there, where the reference
does not.

On a spatial mesh (``spatial``, ``parallel/mesh.py``) f and the flow are a
rank's band of rows, and a flow may point at any row: ``warp2d`` samples
the whole frame of f, gathered from the band's peers (``parallel/halo.py``;
its backward sums their gradients and keeps the band's), at the band's own
rows offset by its first. ``warp1d`` reads each output row's own row (its
vertical flow is 0), so it runs on the band as it is.
"""

from __future__ import annotations

import torch

from cerberusnet_torch.parallel.halo import gather_rows


def warp2d(f, flow, spatial=None):
    """out(x) = f(x + flow(x)), bilinear. f (B,H,W,C), flow (B,H,W,2);
    ``spatial``: both are bands of rows of that mesh."""
    want = (*f.shape[:3], 2)
    if tuple(flow.shape) != want:
        raise ValueError(f"flow shape {tuple(flow.shape)} != {want}")
    row0 = 0
    if spatial is not None:
        row0 = spatial.band_start(f.shape[1])
        f = gather_rows(f, spatial, dim=1)
    b, h, w, c = f.shape
    hb = flow.shape[1]
    fl = flow.float()
    xs = torch.arange(w, dtype=torch.float32, device=flow.device) + fl[..., 0]
    rows = torch.arange(hb, dtype=torch.float32, device=flow.device)
    if row0:
        rows = rows + row0
    ys = rows[:, None] + fl[..., 1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    # gather in f's own type and widen after: the same values, half the bytes
    flat = f.reshape(b, h * w, c)
    out = torch.zeros((b, hb, w, c), dtype=torch.float32, device=f.device)
    for dy in (0, 1):
        for dx in (0, 1):
            ix = x0i + dx
            iy = y0i + dy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            wgt = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy)
            wgt = torch.where(valid, wgt, 0.0)
            idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            corner = torch.gather(
                flat, 1, idx.reshape(b, hb * w, 1).expand(b, hb * w, c))
            out = out + wgt[..., None] * corner.reshape(b, hb, w, c).float()
    return out.to(f.dtype)


def warp1d(f, disp):
    """Horizontal warp for stereo: out(x) = f(x - disp(x)).

    Positive disparity samples to the LEFT. ``disp`` is (B,H,W,1) or
    (B,H,W); the flow is (-disp, 0)."""
    if disp.dim() == f.dim():
        disp = disp[..., 0]
    flow = torch.stack([-disp, torch.zeros_like(disp)], dim=-1)
    return warp2d(f, flow)
