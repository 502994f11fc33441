"""The dilated-cost-volume (DCV) family, port of
``cerberusnet_tpu/models/dcv_flow.py``: ``DCVFlowDecoder``, ``DCVFlowNet``,
``DCVStereoDecoder``, ``DCVStereoNet`` and the joint ``CerberusDCV``.

A DCV decoder works at one pyramid level (3 by default) and warps nothing:
  1. cost volumes of the two feature maps at several dilations, each
     followed by LeakyReLU: the 2-D correlation with d=4 (81 channels) at
     dilations 1, 2, 4, 8 for flow, the 1-D one with D=4 (5 channels) at
     dilations 1, 2, 3 for stereo
  2. a DenseEstimator over cat([volume for each dilation] + [f1]), a 3x3
     conv to the estimate's channels, plus a ContextNetwork's residual
  3. full resolution: ``level`` rounds of 2 * upsample2x
The pyramid holds the one level's estimate. ``fused`` (the reference's
default) computes the estimator and predictor as its
``FusedDenseEstimator`` does, each volume and f1 a component of their own
whose bf16 products are summed in bf16 (``models/common.py``'s
``fused_dense``); ``fused=False`` concatenates them and runs one conv a
block, as its ``DenseEstimator``. The parameters are the same either way;
the context network reads the concatenated stack in both, as there.

Inputs and outputs are NHWC, as in the reference; inside, NCHW tensors in
``torch.channels_last``, as ``CerberusNet`` runs them.

On a spatial mesh (``spatial``, ``models/common.py``'s ``set_spatial``) a
decoder runs on its band of the level's rows: the 2-D correlation takes f2
with a halo of its reach, max_disp x dilation rows (32 at dilation 8, more
than a band may hold, from as many bands as it reaches; ``correlation2d``'s
``spatial``), the 1-D one reads along W alone and runs on the band as it
is, the estimator's and context network's blocks and the 3x3 predictor
take their halos, and the upsamplings one edge-filled row each side.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cerberusnet_torch.models.common import (
    ContextNetwork,
    DenseEstimator,
    FlaxConv2d,
    leaky,
    nchw,
    nhwc,
    upsample2x,
)
from cerberusnet_torch.models.encoder import PyramidEncoder
from cerberusnet_torch.models.flow import nhwc_outputs
from cerberusnet_torch.models.segmentation import make_seg_head
from cerberusnet_torch.ops.correlation import correlation1d, correlation2d

ENCODER_CHANNELS = (16, 32, 64, 96, 128, 196)
EST_CHANNELS = (128, 96, 64, 32)
CTX_CHANNELS = (96, 64, 32)


class DCVDecoder(nn.Module):
    """The single-level decoder shared by flow and stereo. A subclass sets
    ``output`` (the result's key) and gives ``correlate`` on NHWC tensors.

    ``estimator`` is the reference's ``DenseEstimator_0``, ``predictor``
    its ``Conv_0`` and ``context`` its ``ContextNetwork_0``; ``fused`` as
    the module's doc says."""

    output = ""
    spatial = None

    def __init__(self, feat_channels: int, out_channels: int,
                 cost_channels: int, level: int, max_disp: int,
                 dilations: Sequence[int], est_channels: Sequence[int],
                 ctx_channels: Sequence[int], corr_impl: str | None,
                 fused: bool = True):
        super().__init__()
        self.level = level
        self.max_disp = max_disp
        self.dilations = tuple(dilations)
        self.corr_impl = corr_impl
        self.estimator = DenseEstimator(
            len(self.dilations) * cost_channels + feat_channels, est_channels,
            fused)
        self.predictor = FlaxConv2d(self.estimator.out_channels,
                                    out_channels, 3, padding=1)
        self.context = ContextNetwork(self.estimator.out_channels,
                                      out_channels, ctx_channels)

    def correlate(self, dilation: int, f1, f2):
        raise NotImplementedError

    def forward(self, feats1, feats2):
        """Two pyramids (lists of NCHW maps, levels 1..6) -> {output:
        (B,C,H,W) at full resolution, output + "_pyramid": {level:
        (B,C,H/2^l,W/2^l)}}."""
        f1 = feats1[self.level - 1]
        a, b = nhwc(f1), nhwc(feats2[self.level - 1])
        volumes = [leaky(nchw(self.correlate(r, a, b))) for r in self.dilations]
        x, (est,) = self.estimator(volumes + [f1], [self.predictor])
        est = est + self.context(x)
        full = est
        # on a band, the peers' rows of each x2 map: twice the last's (off
        # the pyramid's extents where H is no multiple of 2^level)
        heights = () if self.spatial is None else self.spatial.band_heights(
            est.shape[2])
        for _ in range(self.level):
            full = 2.0 * upsample2x(full, self.spatial, heights)
            heights = tuple(2 * h for h in heights)
        return {self.output: full, f"{self.output}_pyramid": {self.level: est}}


class DCVFlowDecoder(DCVDecoder):
    """2-D cost volumes of (f1, f2) at each dilation; emits flow (u, v)."""

    output = "flow"

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 level: int = 3, max_disp: int = 4,
                 dilations: Sequence[int] = (1, 2, 4, 8),
                 est_channels: Sequence[int] = EST_CHANNELS,
                 ctx_channels: Sequence[int] = CTX_CHANNELS,
                 corr_impl: str | None = None, fused: bool = True):
        super().__init__(encoder_channels[level - 1], 2,
                         (2 * max_disp + 1) ** 2, level, max_disp, dilations,
                         est_channels, ctx_channels, corr_impl, fused)

    def correlate(self, dilation, f1, f2):
        return correlation2d(f1, f2, self.max_disp, dilation,
                             impl=self.corr_impl, spatial=self.spatial)


class DCVStereoDecoder(DCVDecoder):
    """1-D cost volumes of (left, right) at each dilation, the right image
    sampled to the left; emits the left image's disparity."""

    output = "disp"

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 level: int = 3, max_disp: int = 4,
                 dilations: Sequence[int] = (1, 2, 3),
                 est_channels: Sequence[int] = EST_CHANNELS,
                 ctx_channels: Sequence[int] = CTX_CHANNELS,
                 corr_impl: str | None = None, fused: bool = True):
        super().__init__(encoder_channels[level - 1], 1, max_disp + 1, level,
                         max_disp, dilations, est_channels, ctx_channels,
                         corr_impl, fused)

    def correlate(self, dilation, f1, f2):
        # along W alone: a band's rows need no other band's
        return correlation1d(f1, f2, self.max_disp, dilation,
                             impl=self.corr_impl)


class DCVFlowNet(nn.Module):
    """Encoder + DCV flow decoder (single task). ``encoder`` and ``flow``
    are the reference's ``PyramidEncoder_0`` and ``DCVFlowDecoder_0``."""

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 level: int = 3, max_disp: int = 4,
                 dilations: Sequence[int] = (1, 2, 4, 8),
                 est_channels: Sequence[int] = EST_CHANNELS,
                 ctx_channels: Sequence[int] = CTX_CHANNELS,
                 corr_impl: str | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = True):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.flow = DCVFlowDecoder(encoder_channels, level, max_disp,
                                   dilations, est_channels, ctx_channels,
                                   corr_impl, fused)
        self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, im1, im2):
        """(B,H,W,3) x2 -> {"flow": (B,H,W,2), "flow_pyramid": {level:
        ...}} in the model's type, as the reference returns them."""
        return nhwc_outputs(self.flow(*self.encoder.encode(im1, im2)))


class DCVStereoNet(nn.Module):
    """Encoder + DCV stereo decoder (single task). ``encoder`` and
    ``disparity`` are the reference's ``PyramidEncoder_0`` and
    ``DCVStereoDecoder_0``."""

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 level: int = 3, max_disp: int = 4,
                 dilations: Sequence[int] = (1, 2, 3),
                 est_channels: Sequence[int] = EST_CHANNELS,
                 ctx_channels: Sequence[int] = CTX_CHANNELS,
                 corr_impl: str | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = True):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.disparity = DCVStereoDecoder(encoder_channels, level, max_disp,
                                          dilations, est_channels,
                                          ctx_channels, corr_impl, fused)
        self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, left, right):
        """(B,H,W,3) x2 -> {"disp": (B,H,W,1), "disp_pyramid": {level:
        ...}} in the model's type, as the reference returns them."""
        return nhwc_outputs(self.disparity(*self.encoder.encode(left, right)))


class CerberusDCV(nn.Module):
    """The joint three-head model on the DCV decoders: one shared encoder,
    the DCV stereo (left, right) and flow (left, temporal) heads and the
    segmentation head of ``seg_head`` (left). ``encoder``, ``disparity``,
    ``flow`` and ``segmentation`` are the reference's ``PyramidEncoder_0``,
    ``DCVStereoDecoder_0``, ``DCVFlowDecoder_0`` and
    ``SegmentationHead_0`` (or ``ASPPSegmentationHead_0``); the
    segmentation classifier stays float32."""

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 num_classes: int = 19, level: int = 3,
                 flow_max_disp: int = 4,
                 flow_dilations: Sequence[int] = (1, 2, 4, 8),
                 disp_max_disp: int = 4,
                 disp_dilations: Sequence[int] = (1, 2, 3),
                 est_channels: Sequence[int] = EST_CHANNELS,
                 ctx_channels: Sequence[int] = CTX_CHANNELS,
                 fpn_channels: int = 96, seg_head: str = "fpn",
                 corr_impl: str | None = None,
                 dtype: torch.dtype = torch.float32, fused: bool = True):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.disparity = DCVStereoDecoder(encoder_channels, level,
                                          disp_max_disp, disp_dilations,
                                          est_channels, ctx_channels,
                                          corr_impl, fused)
        self.flow = DCVFlowDecoder(encoder_channels, level, flow_max_disp,
                                   flow_dilations, est_channels, ctx_channels,
                                   corr_impl, fused)
        self.segmentation = make_seg_head(seg_head, encoder_channels,
                                          num_classes, fpn_channels)
        self.to(dtype=dtype, memory_format=torch.channels_last)
        self.segmentation.classifier.float()

    def forward(self, left, right, temporal):
        """left/right/temporal: (B, H, W, 3) frames. Returns a dict:
          seg_logits    (B, H, W, classes) float32
          flow          (B, H, W, 2) float32, left -> temporal
          disp          (B, H, W, 1) float32, left image
          flow_pyramid  {level: (B, H/2^l, W/2^l, 2)} for the one level
          disp_pyramid  {level: (B, H/2^l, W/2^l, 1)} for the one level
        """
        f_left, f_right, f_temporal = self.encoder.encode(left, right,
                                                          temporal)
        disp = nhwc_outputs(self.disparity(f_left, f_right))
        flow = nhwc_outputs(self.flow(f_left, f_temporal))
        seg = self.segmentation(f_left, left.shape[1:3])
        return {
            "seg_logits": nhwc(seg),
            "flow": flow["flow"].float(),
            "disp": disp["disp"].float(),
            "flow_pyramid": flow["flow_pyramid"],
            "disp_pyramid": disp["disp_pyramid"],
        }
