"""Shared pyramid encoder, port of ``PyramidEncoder`` in
``cerberusnet_tpu/models/encoder.py``.

Six levels; each is a stride-2 conv block then two stride-1 conv blocks.
``blocks[3*i + j]`` is the reference's ``ConvBlock_{3*i + j}``.

``pallas_levels=N`` runs the first N levels through ``encoder_level``, one
fused kernel per level (K9; its backward K10 with ``pallas_grad="pallas"``,
the plain recompute with ``"xla"``), with the same blocks' weights: the
parameters and the math are those of the plain levels.

On a spatial mesh (``spatial``, ``models/common.py``'s ``set_spatial``)
the levels run through their ``ConvBlock``s alone, each on its band with
its halo; a fused level cannot take a halo, so it raises there, and the
trainer turns the fused levels off under the spatial axis, as the
reference does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cerberusnet_torch.models.common import ConvBlock, nchw, nhwc
from cerberusnet_torch.ops.encoder_level import encoder_level


class PyramidEncoder(nn.Module):
    spatial = None

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 in_channels: int = 3, pallas_levels: int = 0,
                 pallas_grad: str = "xla"):
        super().__init__()
        self.channels = tuple(channels)
        self.fused_levels = min(max(pallas_levels, 0), len(self.channels))
        self.pallas_grad = pallas_grad
        self.blocks = nn.ModuleList()
        cin = in_channels
        for ch in self.channels:
            self.blocks.append(ConvBlock(cin, ch, stride=2))
            self.blocks.append(ConvBlock(ch, ch))
            self.blocks.append(ConvBlock(ch, ch))
            cin = ch

    def forward(self, x):
        """(B, 3, H, W) image -> list of 6 feature maps, levels 1..6."""
        if self.fused_levels and self.spatial is not None:
            raise ValueError("fused encoder levels (pallas_levels) take no "
                             "halo: set pallas_levels=0 on a spatial mesh")
        feats = []
        for i in range(self.fused_levels):
            convs = [b.conv for b in self.blocks[3 * i : 3 * i + 3]]
            params = [t for c in convs for t in (c.weight.permute(2, 3, 1, 0),
                                                 c.bias)]
            x = nchw(encoder_level(nhwc(x), *params, grad=self.pallas_grad))
            feats.append(x)
        first = 3 * self.fused_levels
        for i, block in enumerate(self.blocks[first:], first):
            x = block(x)
            if i % 3 == 2:
                feats.append(x)
        return feats

    def encode(self, *frames):
        """NHWC frames (B, H, W, 3) -> one pyramid (list of NCHW maps,
        levels 1..6) per frame. The frames run as one batch in the
        encoder's type; the reference encodes them one at a time or
        batched, with the same arithmetic per sample."""
        return self.encode_stacked(torch.cat(frames, dim=0), len(frames))

    def encode_stacked(self, x, n: int):
        """``n`` NHWC frames stacked along the batch, (n B, H, W, 3) ->
        one pyramid per frame, as ``encode``."""
        b = x.shape[0] // n
        x = x.to(self.blocks[0].conv.weight.dtype)
        feats = self(nchw(x.contiguous()))
        return [[f[i * b : (i + 1) * b] for f in feats] for i in range(n)]
