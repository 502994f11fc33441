"""Segmentation heads and the single-task ``SegNet``, port of
``cerberusnet_tpu/models/segmentation.py``.

``SegmentationHead`` (FPN): 1x1 lateral convs project levels 6..2 to
``fpn_channels``; a top-down path upsamples, adds and smooths with a conv
block per level; one more conv block and a 3x3 classifier give the logits
at level 2, resized to full resolution in one bilinear step.
``laterals[i]`` is the reference's ``Conv_i`` (levels 6..2), ``smooth[i]``
its ``ConvBlock_i``, ``final`` its ``ConvBlock_4`` and ``classifier`` its
``Conv_5``.

``ASPPSegmentationHead`` (DeepLab's atrous pyramid): on level 3, four
dilated conv blocks (rates 1, 6, 12, 18, the reference's ``ConvBlock_0..3``,
``branches`` here) and an image-pooled 1x1 branch (``pool``, ``Conv_0``),
concatenated and projected by a 1x1 conv (``project``, ``Conv_1``); a
48-channel 1x1 skip from level 2 (``skip``, ``Conv_2``) joins the
projection upsampled to level 2; two conv blocks (``refine``,
``ConvBlock_4`` and ``_5``) and a 3x3 classifier (``classifier``,
``Conv_3``) give the logits, resized to full resolution.

Either head's classifier runs in float32 whatever the trunk's type, so the
logits keep full precision; the other convs round as the reference's
``nn.Conv`` in bf16 (``FlaxConv2d``: the product, then the bias).

On a spatial mesh (``spatial``, ``models/common.py``'s ``set_spatial``) a
head runs on its band of rows: the conv blocks, the 3x3 classifier and the
resizes take their halos (ASPP's rate-18 branch 18 rows, more than a
level-3 band may hold, from as many bands as it reaches), and ASPP's image
mean is the band's sum added over the spatial peers, over the frame's
pixel count.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cerberusnet_torch.models.common import (
    ConvBlock,
    FlaxConv2d,
    band_conv,
    leaky,
    nhwc,
    upsample_to,
)
from cerberusnet_torch.models.encoder import PyramidEncoder

ENCODER_CHANNELS = (16, 32, 64, 96, 128, 196)
SEG_LEVELS = (6, 5, 4, 3, 2)
SEG_HEADS = ("fpn", "aspp")


def _classify(classifier: nn.Conv2d, x, out_hw, spatial=None):
    """The 3x3 classifier in its own type (float32: the models keep it so
    whatever theirs), resized to ``out_hw``."""
    return upsample_to(band_conv(classifier, x.to(classifier.weight.dtype),
                                 spatial), out_hw, spatial)


class SegmentationHead(nn.Module):
    spatial = None

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 num_classes: int = 19, fpn_channels: int = 96):
        super().__init__()
        self.laterals = nn.ModuleList(
            FlaxConv2d(encoder_channels[level - 1], fpn_channels, 1)
            for level in SEG_LEVELS)
        self.smooth = nn.ModuleList(
            ConvBlock(fpn_channels, fpn_channels) for _ in SEG_LEVELS[1:])
        self.final = ConvBlock(fpn_channels, fpn_channels)
        self.classifier = nn.Conv2d(fpn_channels, num_classes, 3, padding=1)

    def forward(self, feats, out_hw):
        """feats: pyramid list (levels 1..6) -> (B, classes, H, W) float32."""
        sp = self.spatial
        x = leaky(self.laterals[0](feats[SEG_LEVELS[0] - 1]))
        for i, level in enumerate(SEG_LEVELS[1:]):
            lat = leaky(self.laterals[i + 1](feats[level - 1]))
            x = self.smooth[i](upsample_to(x, lat.shape[2:], sp) + lat)
        return _classify(self.classifier, self.final(x), out_hw, sp)


class ASPPSegmentationHead(nn.Module):
    spatial = None

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 num_classes: int = 19, channels: int = 128,
                 rates: Sequence[int] = (1, 6, 12, 18), level: int = 3,
                 skip_level: int = 2, skip_channels: int = 48):
        super().__init__()
        self.level, self.skip_level = level, skip_level
        cin = encoder_channels[level - 1]
        self.branches = nn.ModuleList(
            ConvBlock(cin, channels, dilation=r) for r in rates)
        self.pool = FlaxConv2d(cin, channels, 1)
        self.project = FlaxConv2d((len(rates) + 1) * channels, channels, 1)
        self.skip = FlaxConv2d(encoder_channels[skip_level - 1],
                               skip_channels, 1)
        self.refine = nn.ModuleList([
            ConvBlock(channels + skip_channels, channels),
            ConvBlock(channels, channels)])
        self.classifier = nn.Conv2d(channels, num_classes, 3, padding=1)

    def forward(self, feats, out_hw):
        """feats: pyramid list (levels 1..6) -> (B, classes, H, W) float32."""
        sp = self.spatial
        x = feats[self.level - 1]
        branches = [branch(x) for branch in self.branches]
        # image-level context: the global mean, a 1x1 conv, broadcast back
        pooled = leaky(self.pool(self._image_mean(x)))
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        y = leaky(self.project(torch.cat(branches, dim=1)))
        skip = leaky(self.skip(feats[self.skip_level - 1]))
        y = torch.cat([upsample_to(y, skip.shape[2:], sp), skip], dim=1)
        for block in self.refine:
            y = block(y)
        return _classify(self.classifier, y, out_hw, sp)

    def _image_mean(self, x):
        """The mean over the frame's pixels, (B, C, 1, 1); on a band, the
        float32 sums of the spatial peers' bands over the frame's count."""
        if self.spatial is None:
            return x.mean(dim=(2, 3), keepdim=True)
        sp = self.spatial
        total = sp.spatial_sum(x.float().sum(dim=(2, 3), keepdim=True))
        return (total / (sp.frame_rows(x.shape[2]) * x.shape[3])).to(
            x.dtype)


def make_seg_head(kind: str, encoder_channels: Sequence[int],
                  num_classes: int, fpn_channels: int) -> nn.Module:
    """The segmentation head ``kind`` names: "fpn" or "aspp" (which has
    its own widths and ignores ``fpn_channels``, as the reference's)."""
    if kind == "fpn":
        return SegmentationHead(encoder_channels, num_classes, fpn_channels)
    if kind == "aspp":
        return ASPPSegmentationHead(encoder_channels, num_classes)
    raise ValueError(f"unknown seg head {kind!r} (expected 'fpn' | 'aspp')")


class SegNet(nn.Module):
    """Encoder + segmentation head (single task). ``encoder`` and
    ``segmentation`` are the reference's ``PyramidEncoder_0`` and its
    head's ``SegmentationHead_0`` or ``ASPPSegmentationHead_0``. Its
    forward returns {"seg_logits": (B, H, W, classes) float32}, the dict
    the reference's ``build_model`` makes of its ``SegNet``'s logits."""

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 num_classes: int = 19, fpn_channels: int = 96,
                 seg_head: str = "fpn", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.segmentation = make_seg_head(seg_head, encoder_channels,
                                          num_classes, fpn_channels)
        self.to(dtype=dtype, memory_format=torch.channels_last)
        self.segmentation.classifier.float()

    def forward(self, image):
        (feats,) = self.encoder.encode(image)
        return {"seg_logits": nhwc(self.segmentation(feats,
                                                     image.shape[1:3]))}
