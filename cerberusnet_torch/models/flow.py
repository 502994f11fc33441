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
each rank runs the loop on its band of rows: the upsamplings, the 3x3
predictors and the up-feature conv (in its subpixel form, a 3x3 conv)
take a halo of one row, the flow decoder's correlation
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
    FlaxConv2d,
    conv_over_components,
    depth_to_space,
    leaky,
    nchw,
    nhwc,
    subpixel,
    upsample2x,
)
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
    ``ContextNetwork_0``.

    The reference's arithmetic knobs, with its defaults: ``fused`` computes
    the estimator and its predictor as ``FusedDenseEstimator`` (the
    predictor an extra conv of the trunk's stack); ``est_input`` feeds it
    one concatenated input ("concat") or the cost volume as a component of
    its own ("split"); ``distribute_outputs`` (with ``fused``) keeps the
    stack as components, so the context network's first conv and the
    up-feature conv sum one product a component (the up-feature conv in
    its subpixel form, a 3x3 conv, joins the trunk's convs beside the
    predictor); ``upsample_impl``
    ("resize" or "phase") is the reference's bilinear x2 of the estimate
    (``models/common.py``'s ``upsample2x``). In bf16 each choice rounds
    otherwise; the parameters are the same. The up-feature conv is
    computed in its subpixel form at every setting (``estimate``), which
    rounds as the transposed conv does: ``upfeat_impl`` ("subpixel" or
    "convt", the reference's choice between two XLA lowerings of one
    rounding) has no effect."""

    output = ""
    spatial = None

    def __init__(self, encoder_channels: Sequence[int], out_channels: int,
                 cost_channels: Sequence[int], est_channels: Sequence[int],
                 ctx_channels: Sequence[int], corr_impl: str | None,
                 fused: bool = True, est_input: str = "concat",
                 distribute_outputs: bool = True,
                 upfeat_impl: str = "subpixel",
                 upsample_impl: str = "resize"):
        super().__init__()
        if est_input not in ("concat", "split"):
            raise ValueError(f"unknown est_input {est_input!r} (expected "
                             "'concat' | 'split')")
        if upfeat_impl not in ("subpixel", "convt"):
            raise ValueError(f"unknown upfeat_impl {upfeat_impl!r} "
                             "(expected 'subpixel' | 'convt')")
        if upsample_impl not in ("resize", "phase"):
            raise ValueError(f"unknown upsample_impl {upsample_impl!r} "
                             "(expected 'resize' | 'phase')")
        self.corr_impl = corr_impl
        self.upsample_impl = upsample_impl
        self.fused = fused
        self.est_input = est_input
        self.distribute_outputs = distribute_outputs
        self.estimators = nn.ModuleList()
        self.predictors = nn.ModuleList()
        self.upfeats = nn.ModuleList()
        for i, (level, nk) in enumerate(zip(LEVELS, cost_channels)):
            extra = 0 if i == 0 else out_channels + UP_FEAT_CHANNELS
            est = DenseEstimator(nk + encoder_channels[level - 1] + extra,
                                 est_channels, fused)
            self.estimators.append(est)
            self.predictors.append(
                FlaxConv2d(est.out_channels, out_channels, 3, padding=1))
            if level != LEVELS[-1]:
                self.upfeats.append(nn.ConvTranspose2d(
                    est.out_channels, UP_FEAT_CHANNELS, 4, stride=2, padding=1))
        self.context = ContextNetwork(self.estimators[-1].out_channels,
                                      out_channels, ctx_channels)

    def correlate(self, level: int, f1, f2):
        raise NotImplementedError

    def warp(self, f2, up):
        raise NotImplementedError

    def estimate(self, i: int, cost, f1, inputs):
        """(the stack, a tensor or a list of components; the predictor's
        output; the next level's up-feature, None at the last level) of
        level index i's estimator. The up-feature conv is computed in its
        subpixel form (``subpixel``: a 3x3 conv, then ``depth_to_space``),
        the product then the bias. With ``distribute_outputs`` it reads
        the stack's components as the predictor does (the reference's
        ``conv_transpose_subpixel``), so it joins the fused trunk's convs
        as one more extra; else it is one conv over the concatenated
        stack (flax's ``nn.ConvTranspose``)."""
        distribute = self.fused and self.distribute_outputs
        if self.fused and self.est_input == "split":
            x = [cost, torch.cat([f1] + inputs, dim=1)]
        else:
            x = torch.cat([cost, f1] + inputs, dim=1)
        extras = [self.predictors[i]]
        up = subpixel(self.upfeats[i]) if i < len(self.upfeats) else None
        if up is not None and (distribute or not self.fused):
            extras.append(up)
        stack, outs = self.estimators[i](x, extras,
                                         concat_stack=not distribute)
        if up is not None:
            y = outs[1] if len(outs) > 1 else conv_over_components(
                [stack], *up, spatial=self.spatial)
            up = leaky(depth_to_space(y))
        return stack, outs[0], up

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
                up = 2.0 * upsample2x(est, sp, impl=self.upsample_impl)
                if sp is not None:
                    _check_frames(up, f2, est.shape[2], sp)
                f2w = self.warp(nhwc(f2), nhwc(up))
                inputs = [up, up_feat]
            cost = leaky(nchw(self.correlate(level, nhwc(f1), f2w)))
            x, est, up_feat = self.estimate(i, cost, f1, inputs)
            if inputs:
                est = est + up
            if level == LEVELS[-1]:
                est = est + self.context(x)
            pyramid[level] = est
        impl = self.upsample_impl
        full = 4.0 * upsample2x(upsample2x(est, sp, impl=impl), sp,
                                impl=impl)
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
                 corr_impl: str | None = None, **arithmetic):
        self.max_disp = max_disp
        super().__init__(encoder_channels, 2,
                         [(2 * max_disp + 1) ** 2] * len(LEVELS),
                         est_channels, ctx_channels, corr_impl, **arithmetic)

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
    a level's upsampled flow then misses the next level's extent.
    ``arithmetic`` (``fused``, ``est_input``, ``distribute_outputs``,
    ``upfeat_impl``, ``upsample_impl``) goes to the decoder
    (``CoarseToFineDecoder``)."""

    def __init__(self, encoder_channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 max_disp: int = 4,
                 est_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 ctx_channels: Sequence[int] = (128, 128, 128, 96, 64, 32),
                 corr_impl: str | None = None,
                 dtype: torch.dtype = torch.float32, **arithmetic):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.flow = FlowDecoder(encoder_channels, max_disp, est_channels,
                                ctx_channels, corr_impl=corr_impl,
                                **arithmetic)
        self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, im1, im2):
        """(B,H,W,3) x2 -> {"flow": (B,H,W,2), "flow_pyramid": {level:
        ...}} in the model's type, as the reference returns them."""
        return nhwc_outputs(self.flow(*self.encoder.encode(im1, im2)))


def nhwc_outputs(out: dict) -> dict:
    """A decoder's NCHW outputs (maps and {level: map} pyramids) as NHWC."""
    return {k: ({l: nhwc(t) for l, t in v.items()} if isinstance(v, dict)
                else nhwc(v)) for k, v in out.items()}
