"""Shared pyramid encoder, port of ``PyramidEncoder`` in
``cerberusnet_tpu/models/encoder.py`` (its default branch: plain convs).

Six levels; each is a stride-2 conv block then two stride-1 conv blocks.
``blocks[3*i + j]`` is the reference's ``ConvBlock_{3*i + j}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cerberusnet_torch.models.common import ConvBlock, nchw


class PyramidEncoder(nn.Module):
    def __init__(self, channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 in_channels: int = 3):
        super().__init__()
        self.channels = tuple(channels)
        self.blocks = nn.ModuleList()
        cin = in_channels
        for ch in self.channels:
            self.blocks.append(ConvBlock(cin, ch, stride=2))
            self.blocks.append(ConvBlock(ch, ch))
            self.blocks.append(ConvBlock(ch, ch))
            cin = ch

    def forward(self, x):
        """(B, 3, H, W) image -> list of 6 feature maps, levels 1..6."""
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i % 3 == 2:
                feats.append(x)
        return feats

    def encode(self, *frames):
        """NHWC frames (B, H, W, 3) -> one pyramid (list of NCHW maps,
        levels 1..6) per frame. The frames run as one batch in the
        encoder's type; the reference encodes them one at a time or
        batched, with the same arithmetic per sample."""
        b = frames[0].shape[0]
        x = torch.cat(frames, dim=0).to(self.blocks[0].conv.weight.dtype)
        feats = self(nchw(x.contiguous()))
        return [[f[i * b : (i + 1) * b] for f in feats]
                for i in range(len(frames))]
