"""Shared model building blocks, port of ``cerberusnet_tpu/models/common.py``.

Modules take and return NCHW tensors; the model keeps them in
``torch.channels_last``, so the NHWC view the correlation kernels read costs
nothing. LeakyReLU(0.1) follows every conv block, as in the reference.

The spatial mesh axis (``parallel/mesh.py``): ``set_spatial(model, mesh)``
gives every module of a model that reads across image rows (its class has
a ``spatial`` attribute) the mesh that splits the rows into bands, one a
rank. Such a module then runs on its band with the rows it reads across
taken from the neighbouring bands (``parallel/halo.py``): a convolution's
H padding becomes a halo of as many rows, zeros at the frame's top and
bottom (``band_conv``, and the stride-2 block's row below), and a bilinear
resize keeps its band of the frame's output, reading the rows it needs
edge-filled (``upsample2x``, ``upsample_to``; one row each side at an
integer ratio). Without a mesh (``spatial`` None,
one process) every module runs its own padding, as before the axis
existed.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cerberusnet_torch.parallel.halo import halo_rows


# LeakyReLU's slope as the reference multiplies a bf16 input by it, 0.1
# rounded to bf16 (flax's ``negative_slope * x``; with float32's 0.1 about
# a tenth of a bf16 block's outputs differed)
BF16_SLOPE = float(torch.tensor(0.1, dtype=torch.bfloat16))


def leaky(x):
    return F.leaky_relu(x, BF16_SLOPE if x.dtype == torch.bfloat16 else 0.1)


def set_spatial(model: nn.Module, mesh) -> nn.Module:
    """Gives every module of ``model`` that reads across rows the mesh
    ``mesh`` when it splits rows over more than one rank, else None (each
    module's own padding). Returns the model."""
    band = mesh if mesh is not None and mesh.banded else None
    for m in model.modules():
        if hasattr(type(m), "spatial"):
            m.spatial = band
    return model


def _band_resize(x, rows: int, width: int, spatial, factor: int = 0,
                 heights: tuple = ()):
    """Bilinear resize of a band of ``x`` to ``width`` columns and
    ``rows`` rows, the whole frame's resize cut to this rank's band.

    ``factor`` f, or a frame f times as tall as ``x``'s whose every band is
    f times the peer's at ``x``'s level: the band with one edge-filled row
    each side, resized to f times as many rows, keeps the f rows of each of
    its own (``heights``: the peers' bands of ``x``'s map, by default its
    level's). Else ``rows`` is this rank's band at another level of the
    frame, and output row j samples (j + 0.5) h / h' - 0.5 of the frame's h
    rows (h' the target frame's; clamped at its edges, as ``F.interpolate``
    and ``jax.image.resize`` upsample): the rows it reads come through
    ``halo_rows`` ("edge"), weighed by the frame's scale in float32
    (float64 for a float64 ``x``), which the result is rounded from once."""
    hb = x.shape[2]
    if not factor:
        src = spatial.band_heights(hb)
        dst = spatial.band_heights(rows)
        hs, s0 = sum(src), spatial.band_start(hb)
        hd, d0 = sum(dst), spatial.band_start(rows)
        # every peer's band f times its own, or every peer the general way
        if all(b * hs == a * hd for a, b in zip(src, dst)) and hd % hs == 0:
            factor = hd // hs
    if factor:
        y = F.interpolate(halo_rows(x, 1, 1, spatial, "edge",
                                    heights=heights),
                          size=(factor * (hb + 2), width), mode="bilinear",
                          align_corners=False)
        return y.narrow(2, factor, rows)

    def source(j):  # the frame row output row j reads first
        return max(math.floor((j + 0.5) * (hs / hd) - 0.5), 0)

    # one halo for every peer (an exchange takes pieces of one shape): the
    # most rows any band reads above and below its own
    top = bottom = 0
    for r in range(spatial.spatial_size):
        a, b = sum(src[:r]), sum(dst[:r])
        top = max(top, a - source(b))
        bottom = max(bottom, min(source(b + dst[r] - 1) + 1, hs - 1)
                     - (a + src[r] - 1))
    pos = torch.arange(d0, d0 + rows, dtype=torch.float64)
    pos = ((pos + 0.5) * (hs / hd) - 0.5).clamp_min(0.0)
    lo = pos.floor().long()
    hi = (lo + 1).clamp_max(hs - 1)
    work = torch.promote_types(x.dtype, torch.float32)
    y = halo_rows(x, top, bottom, spatial, "edge").to(work)
    lam = (pos - lo).to(device=x.device, dtype=work)[:, None]
    lo, hi = ((i - s0 + top).to(x.device) for i in (lo, hi))
    y = (y.index_select(2, lo) * (1.0 - lam) + y.index_select(2, hi) * lam)
    y = F.interpolate(y, size=(rows, width), mode="bilinear",
                      align_corners=False).to(x.dtype)
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y


def upsample2x(x, spatial=None, heights: tuple = ()):
    """Bilinear x2 on the half-pixel grid with edge clamp: upsampling equal
    to ``jax.image.resize(..., "bilinear")``. ``spatial``: ``x`` is a band
    of that mesh, of the peers' ``heights`` (by default its level's); the
    result is the band of twice its rows of the frame's x2."""
    if spatial is not None:
        return _band_resize(x, 2 * x.shape[2], 2 * x.shape[3], spatial, 2,
                            heights)
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def upsample_to(x, hw, spatial=None):
    """Bilinear resize to ``hw`` (with ``spatial``: this rank's band of
    rows at a level of the frame)."""
    if spatial is not None:
        return _band_resize(x, hw[0], hw[1], spatial)
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def band_conv(conv: nn.Conv2d, x, spatial=None):
    """``conv(x)``; with ``spatial``, on a band: the rows the convolution
    pads in H come from the neighbouring bands (zeros at the frame's
    borders), and the convolution's own forward (the one QAT and int8
    interception replace) runs with its H padding off for the call."""
    return band_convs((conv,), x, spatial)[0]


def band_convs(convs, x, spatial=None):
    """``[conv(x) for conv in convs]``, convolutions of one H padding; with
    ``spatial``, on a band, as ``band_conv`` does, the halo taken once for
    all of them."""
    if spatial is None:
        return [conv(x) for conv in convs]
    (ph,) = {conv.padding[0] for conv in convs}
    x = halo_rows(x, ph, ph, spatial)
    out = []
    for conv in convs:
        pw = conv.padding[1]
        conv.padding = (0, pw)
        try:
            out.append(conv(x))
        finally:
            conv.padding = (ph, pw)
    return out


def same_pads(size: int, kernel: int, stride: int):
    """(before, after) padding of XLA's "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class FlaxConv2d(nn.Conv2d):
    """``nn.Conv2d`` that rounds as the reference's ``nn.Conv`` in a type
    narrower than float32: the product is rounded to the input's type,
    then the bias added in it (two roundings; with the bias fused, which
    rounds once, 13-39% of the encoder's bf16 ConvBlock outputs and 21% of
    RAFT's ``context_proj``'s differed from flax's,
    scripts/raft_bf16_op_compare.py)."""

    def forward(self, x):
        return self.rounded_forward(x, self.weight, self.bias)

    def rounded_forward(self, x, weight, bias):
        if x.dtype.itemsize >= 4:
            return self._conv_forward(x, weight, bias)
        return self._conv_forward(x, weight, None) + bias[:, None, None]


class ConvBlock(nn.Module):
    """Conv 3x3 with "SAME" padding + LeakyReLU(0.1), the conv rounding as
    flax's (``FlaxConv2d``).

    A stride-2 block pads as XLA does, (0, 1) on an even extent and (1, 1)
    on an odd one, so it pads explicitly; a stride-1 block pads
    symmetrically inside the conv. On a band (``spatial``) the stride-2
    block's row below is the next band's first (``parallel/mesh.py``'s
    nested bands), and at an odd extent rank 0 pads the frame's zero row
    above; the stride-1 block's ``dilation`` rows each side are its
    neighbours'."""

    spatial = None

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = FlaxConv2d(in_channels, features, 3, stride=stride,
                               padding=dilation if stride == 1 else 0,
                               dilation=dilation)

    def forward(self, x):
        if self.stride == 1:
            return leaky(band_conv(self.conv, x, self.spatial))
        pw = same_pads(x.shape[3], 3, self.stride)
        sp = self.spatial
        if sp is None:
            ph = same_pads(x.shape[2], 3, self.stride)
        elif self.stride == 2:
            odd = sp.frame_rows(x.shape[2]) % 2
            x = halo_rows(x, 0, 1, sp)
            ph = (int(odd and sp.spatial_rank == 0), 0)
        else:
            raise ValueError(f"a stride-{self.stride} block on a band")
        return leaky(self.conv(F.pad(x, (*pw, *ph))))


class DenseEstimator(nn.Module):
    """DenseNet trunk: each conv block sees the concatenation of the input
    and every earlier block's output; returns the final stack. Equal by
    construction to the reference's ``FusedDenseEstimator``."""

    def __init__(self, in_channels: int,
                 channels: Sequence[int] = (128, 128, 96, 64, 32)):
        super().__init__()
        self.blocks = nn.ModuleList()
        cin = in_channels
        for ch in channels:
            self.blocks.append(ConvBlock(cin, ch))
            cin += ch
        self.out_channels = cin

    def forward(self, x):
        for block in self.blocks:
            x = torch.cat([x, block(x)], dim=1)
        return x


class ContextNetwork(nn.Module):
    """Dilated refinement: conv blocks with the given dilations, then a
    plain 3x3 conv to ``out_channels``."""

    spatial = None

    def __init__(self, in_channels: int, out_channels: int = 2,
                 channels: Sequence[int] = (128, 128, 128, 96, 64, 32),
                 dilations: Sequence[int] = (1, 2, 4, 8, 16, 1)):
        super().__init__()
        self.blocks = nn.ModuleList()
        cin = in_channels
        for ch, dil in zip(channels, dilations):
            self.blocks.append(ConvBlock(cin, ch, dilation=dil))
            cin = ch
        self.out = nn.Conv2d(cin, out_channels, 3, padding=1)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return band_conv(self.out, x, self.spatial)


def nhwc(x):
    """NHWC tensor of an NCHW one: a free view of a channels_last tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x):
    """NCHW view of an NHWC-contiguous tensor, in channels_last."""
    return x.permute(0, 3, 1, 2)
