"""FPN segmentation head, port of ``SegmentationHead`` in
``cerberusnet_tpu/models/segmentation.py``.

1x1 lateral convs project levels 6..2 to ``fpn_channels``; a top-down path
upsamples, adds and smooths with a conv block per level; one more conv block
and a 3x3 classifier give the logits at level 2, resized to full resolution
in one bilinear step. The classifier runs in float32 whatever the trunk's
type, so the logits keep full precision.

``laterals[i]`` is the reference's ``Conv_i`` (levels 6..2), ``smooth[i]``
its ``ConvBlock_i``, ``final`` its ``ConvBlock_4`` and ``classifier`` its
``Conv_5``.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from cerberusnet_torch.models.common import ConvBlock, leaky, upsample_to

SEG_LEVELS = (6, 5, 4, 3, 2)


class SegmentationHead(nn.Module):
    def __init__(self, encoder_channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 num_classes: int = 19, fpn_channels: int = 96):
        super().__init__()
        self.laterals = nn.ModuleList(
            nn.Conv2d(encoder_channels[level - 1], fpn_channels, 1)
            for level in SEG_LEVELS)
        self.smooth = nn.ModuleList(
            ConvBlock(fpn_channels, fpn_channels) for _ in SEG_LEVELS[1:])
        self.final = ConvBlock(fpn_channels, fpn_channels)
        self.classifier = nn.Conv2d(fpn_channels, num_classes, 3, padding=1)

    def forward(self, feats, out_hw):
        """feats: pyramid list (levels 1..6) -> (B, classes, H, W) float32."""
        x = leaky(self.laterals[0](feats[SEG_LEVELS[0] - 1]))
        for i, level in enumerate(SEG_LEVELS[1:]):
            lat = leaky(self.laterals[i + 1](feats[level - 1]))
            x = self.smooth[i](upsample_to(x, lat.shape[2:]) + lat)
        x = self.final(x)
        cls = self.classifier
        logits = F.conv2d(x.float(), cls.weight.float(), cls.bias.float(),
                          padding=1)
        return upsample_to(logits, out_hw)
