"""Optical-flow decoder, port of ``FlowDecoder`` in
``cerberusnet_tpu/models/flow.py``, and the coarse-to-fine loop it shares
with the disparity decoder.

Coarse to fine over pyramid levels 6..2. At each level:
  1. up = 2 * upsample2x(estimate of the level above)   (none at level 6)
  2. f2 warped by up
  3. cost = LeakyReLU(correlation(f1, warped f2)): for flow the 2-D
     correlation with d=4, 81 channels
  4. DenseEstimator over cat([cost, f1, up, up_feat]), a 3x3 conv to the
     estimate's channels, plus up
  5. level 2 only: a dilated ContextNetwork adds a residual; other levels
     make the next level's up_feat with a 4x4 stride-2 transposed conv.
Estimates are in pixels at each level's own resolution; the full-resolution
estimate is the level-2 one upsampled by two x2 steps and scaled by 4.

On a spatial mesh (``spatial``, ``models/common.py``'s ``set_spatial``)
each rank runs the loop on its band of rows: the upsamplings and the 3x3
predictors take a halo of one row, the transposed conv one row of input
each side (its output cut to the band), the flow decoder's correlation
f2 haloed by its reach and its warp the whole frame of f2
(``ops/correlation.py``, ``ops/warp.py``). Where the frame's upsampled
flow misses the next level's frame (an H that is no multiple of 64), every
rank raises the warp's ValueError, as one process does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cerberusnet_torch.models.common import (
    ContextNetwork,
    DenseEstimator,
    band_conv,
    leaky,
    nchw,
    nhwc,
    upsample2x,
)
from cerberusnet_torch.parallel.halo import halo_rows
from cerberusnet_torch.models.encoder import PyramidEncoder
from cerberusnet_torch.ops.correlation import correlation2d
from cerberusnet_torch.ops.warp import warp2d

LEVELS = (6, 5, 4, 3, 2)
UP_FEAT_CHANNELS = 2


class CoarseToFineDecoder(nn.Module):
    """The loop shared by the flow and disparity decoders. A subclass sets
    ``output`` (the result's key) and gives ``correlate`` and ``warp`` on
    NHWC tensors.

    Per level index i (level 6 first): ``estimators[i]`` is the reference's
    ``DenseEstimator_i``, ``predictors[i]`` its ``Conv_i`` and
    ``upfeats[i]`` its ``ConvTranspose_i``; ``context`` is
    ``ContextNetwork_0``."""

    output = ""
    spatial = None

    def __init__(self, encoder_channels: Sequence[int], out_channels: int,
                 cost_channels: Sequence[int], est_channels: Sequence[int],
                 ctx_channels: Sequence[int], corr_impl: str | None):
        super().__init__()
        self.corr_impl = corr_impl
        self.estimators = nn.ModuleList()
        self.predictors = nn.ModuleList()
        self.upfeats = nn.ModuleList()
        for i, (level, nk) in enumerate(zip(LEVELS, cost_channels)):
            extra = 0 if i == 0 else out_channels + UP_FEAT_CHANNELS
            est = DenseEstimator(nk + encoder_channels[level - 1] + extra,
                                 est_channels)
            self.estimators.append(est)
            self.predictors.append(
                nn.Conv2d(est.out_channels, out_channels, 3, padding=1))
            if level != LEVELS[-1]:
                self.upfeats.append(nn.ConvTranspose2d(
                    est.out_channels, UP_FEAT_CHANNELS, 4, stride=2, padding=1))
        self.context = ContextNetwork(self.estimators[-1].out_channels,
                                      out_channels, ctx_channels)

    def correlate(self, level: int, f1, f2):
        raise NotImplementedError

    def warp(self, f2, up):
        raise NotImplementedError

    def upfeat(self, i: int, x):
        """``upfeats[i]`` (4x4, stride 2, padding 1); on a band, of the
        band with one row of its neighbours each side (output row 2j + k -
        1 reads input row j), the output cut to the band's rows."""
        if self.spatial is None:
            return self.upfeats[i](x)
        y = self.upfeats[i](halo_rows(x, 1, 1, self.spatial))
        return y.narrow(2, 2, 2 * x.shape[2])

    def forward(self, feats1, feats2):
        """Two pyramids (lists of NCHW maps, levels 1..6) -> {output:
        (B,C,H,W) at full resolution, output + "_pyramid": {level:
        (B,C,H/2^l,W/2^l)}}."""
        pyramid = {}
        est = up_feat = None
        sp = self.spatial
        for i, level in enumerate(LEVELS):
            f1, f2 = feats1[level - 1], feats2[level - 1]
            if est is None:
                f2w = nhwc(f2)
                inputs = []
            else:
                up = 2.0 * upsample2x(est, sp)
                if sp is not None:
                    _check_frames(up, f2, est.shape[2], sp)
                f2w = self.warp(nhwc(f2), nhwc(up))
                inputs = [up, up_feat]
            cost = leaky(nchw(self.correlate(level, nhwc(f1), f2w)))
            x = self.estimators[i](torch.cat([cost, f1] + inputs, dim=1))
            est = band_conv(self.predictors[i], x, sp)
            if inputs:
                est = est + up
            if level == LEVELS[-1]:
                est = est + self.context(x)
            else:
                up_feat = leaky(self.upfeat(i, x))
            pyramid[level] = est
        full = 4.0 * upsample2x(upsample2x(est, sp), sp)
        return {self.output: full, f"{self.output}_pyramid": pyramid}


def _check_frames(up, f2, coarse: int, spatial):
    """Raises the warp's ValueError, on every rank, where the frame of the
    flow upsampled from a band of ``coarse`` rows misses the frame of
    ``f2``'s level (an H that is no multiple of 64, ROADMAP C10): the
    bands' own shapes may agree on some ranks."""
    b, _, h, w = f2.shape
    up_rows, rows = 2 * spatial.frame_rows(coarse), spatial.frame_rows(h)
    if up_rows != rows:
        raise ValueError(f"flow shape {(b, up_rows, up.shape[3], 2)} != "
                         f"{(b, rows, w, 2)}")


class FlowDecoder(CoarseToFineDecoder):
    """Consumes two feature pyramids, emits flow (u, v) from the first
    frame into the second."""

    output = "flow"

    def __init__(self, encoder_channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 max_disp: int = 4,
                 est_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 ctx_channels: Sequence[int] = (128, 128, 128, 96, 64, 32),
                 corr_impl: str | None = None):
        self.max_disp = max_disp
        super().__init__(encoder_channels, 2,
                         [(2 * max_disp + 1) ** 2] * len(LEVELS),
                         est_channels, ctx_channels, corr_impl)

    def correlate(self, level, f1, f2):
        return correlation2d(f1, f2, self.max_disp, impl=self.corr_impl,
                             spatial=self.spatial)

    def warp(self, f2, up):
        return warp2d(f2, up, spatial=self.spatial)


class FlowNet(nn.Module):
    """Encoder + flow decoder (single task), port of ``FlowNet`` in
    ``cerberusnet_tpu/models/flow.py``. ``encoder`` and ``flow`` are the
    reference's ``PyramidEncoder_0`` and ``FlowDecoder_0``. A frame whose
    sides are not multiples of 64 raises in the warp, as in the reference:
    a level's upsampled flow then misses the next level's extent."""

    def __init__(self, encoder_channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 max_disp: int = 4,
                 est_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 ctx_channels: Sequence[int] = (128, 128, 128, 96, 64, 32),
                 corr_impl: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.flow = FlowDecoder(encoder_channels, max_disp, est_channels,
                                ctx_channels, corr_impl=corr_impl)
        self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, im1, im2):
        """(B,H,W,3) x2 -> {"flow": (B,H,W,2), "flow_pyramid": {level:
        ...}} in the model's type, as the reference returns them."""
        return nhwc_outputs(self.flow(*self.encoder.encode(im1, im2)))


def nhwc_outputs(out: dict) -> dict:
    """A decoder's NCHW outputs (maps and {level: map} pyramids) as NHWC."""
    return {k: ({l: nhwc(t) for l, t in v.items()} if isinstance(v, dict)
                else nhwc(v)) for k, v in out.items()}
