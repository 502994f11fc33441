"""Shared model building blocks, port of ``cerberusnet_tpu/models/common.py``.

Modules take and return NCHW tensors; the model keeps them in
``torch.channels_last``, so the NHWC view the correlation kernels read costs
nothing. LeakyReLU(0.1) follows every conv block, as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def leaky(x):
    return F.leaky_relu(x, 0.1)


def upsample2x(x):
    """Bilinear x2 on the half-pixel grid with edge clamp: upsampling equal
    to ``jax.image.resize(..., "bilinear")``."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def upsample_to(x, hw):
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def same_pads(size: int, kernel: int, stride: int):
    """(before, after) padding of XLA's "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """Conv 3x3 with "SAME" padding + LeakyReLU(0.1).

    A stride-2 block pads (0, 1) on an even extent, as XLA does, so it pads
    explicitly; a stride-1 block pads symmetrically inside the conv."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(in_channels, features, 3, stride=stride,
                              padding=dilation if stride == 1 else 0,
                              dilation=dilation)

    def forward(self, x):
        if self.stride != 1:
            ph = same_pads(x.shape[2], 3, self.stride)
            pw = same_pads(x.shape[3], 3, self.stride)
            x = F.pad(x, (*pw, *ph))
        return leaky(self.conv(x))


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
        return self.out(x)


def nhwc(x):
    """NHWC tensor of an NCHW one: a free view of a channels_last tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x):
    """NCHW view of an NHWC-contiguous tensor, in channels_last."""
    return x.permute(0, 3, 1, 2)
