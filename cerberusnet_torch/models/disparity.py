"""Stereo-disparity decoder, port of ``DisparityDecoder`` in
``cerberusnet_tpu/models/disparity.py``.

The 1-D epipolar form of the flow decoder's loop (``CoarseToFineDecoder``):
per level the right features are warped horizontally by the upsampled
disparity (sampling to the left), then correlated with the left features
over k in 0..D_l with D_l = max(max_disp_full // 2**l, 4), i.e. 5, 5, 7,
13 and 25 channels at levels 6..2; the estimate has one channel.

On a spatial mesh the correlation and the warp need no halo: both read
along a row alone (the warp's vertical flow is 0), so each runs on the
band as it is; the loop's other ops take theirs in ``CoarseToFineDecoder``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cerberusnet_torch.models.encoder import PyramidEncoder
from cerberusnet_torch.models.flow import (
    LEVELS,
    CoarseToFineDecoder,
    nhwc_outputs,
)
from cerberusnet_torch.ops.correlation import correlation1d
from cerberusnet_torch.ops.warp import warp1d


class DisparityDecoder(CoarseToFineDecoder):
    """Consumes left/right feature pyramids, emits left-image disparity."""

    output = "disp"

    def __init__(self, encoder_channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 max_disp_full: int = 96,
                 est_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 ctx_channels: Sequence[int] = (128, 128, 128, 96, 64, 32),
                 corr_impl: str | None = None, **arithmetic):
        self.max_disp_full = max_disp_full
        super().__init__(encoder_channels, 1,
                         [self.level_max_disp(l) + 1 for l in LEVELS],
                         est_channels, ctx_channels, corr_impl, **arithmetic)

    def level_max_disp(self, level: int) -> int:
        return max(self.max_disp_full // (2**level), 4)

    def correlate(self, level, f1, f2):
        # along W alone: a band's rows need no other band's
        return correlation1d(f1, f2, self.level_max_disp(level),
                             impl=self.corr_impl)

    def warp(self, f2, up):
        # a horizontal warp: each output row reads its own row
        return warp1d(f2, up)


class StereoNet(nn.Module):
    """Encoder + disparity decoder (single task), port of ``StereoNet`` in
    ``cerberusnet_tpu/models/disparity.py``. ``encoder`` and ``disparity``
    are the reference's ``PyramidEncoder_0`` and ``DisparityDecoder_0``; a
    frame whose sides are not multiples of 64 raises, as ``FlowNet``.
    ``arithmetic`` (``fused``, ``est_input``, ``distribute_outputs``,
    ``upfeat_impl``, ``upsample_impl``) goes to the decoder
    (``CoarseToFineDecoder``)."""

    def __init__(self, encoder_channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 max_disp_full: int = 96,
                 est_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 ctx_channels: Sequence[int] = (128, 128, 128, 96, 64, 32),
                 corr_impl: str | None = None,
                 dtype: torch.dtype = torch.float32, **arithmetic):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.disparity = DisparityDecoder(encoder_channels, max_disp_full,
                                          est_channels, ctx_channels,
                                          corr_impl=corr_impl, **arithmetic)
        self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, left, right):
        """(B,H,W,3) x2 -> {"disp": (B,H,W,1), "disp_pyramid": {level:
        ...}} in the model's type, as the reference returns them."""
        return nhwc_outputs(self.disparity(*self.encoder.encode(left, right)))
