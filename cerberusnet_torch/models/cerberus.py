"""CerberusNet, the joint three-headed model: port of ``CerberusNet`` in
``cerberusnet_tpu/models/cerberus.py`` (default configuration).

One shared pyramid encoder runs once over the batch [left; right; temporal]
and feeds the disparity head (left, right), the flow head (left, temporal)
and the segmentation head (left).

Inputs and outputs are NHWC, as in the reference. Inside, the model runs
NCHW tensors in ``torch.channels_last`` in the type given at construction;
the segmentation classifier alone stays float32.

On a spatial mesh (``models/common.py``'s ``set_spatial``) the frames are
a rank's band of rows: the encoder, both decoders and the head take their
halos, and the outputs are the band's (the segmentation resized to the
band's rows). The fused encoder levels take no halo (the trainer turns
them off under the axis).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from cerberusnet_torch.models.common import nhwc
from cerberusnet_torch.models.disparity import DisparityDecoder
from cerberusnet_torch.models.encoder import PyramidEncoder
from cerberusnet_torch.models.flow import FlowDecoder
from cerberusnet_torch.models.segmentation import make_seg_head


class CerberusNet(nn.Module):
    """``encoder``, ``disparity``, ``flow`` and ``segmentation`` are the
    reference's ``PyramidEncoder_0``, ``DisparityDecoder_0``,
    ``FlowDecoder_0`` and ``SegmentationHead_0`` (``ASPPSegmentationHead_0``
    with ``seg_head="aspp"``). ``corr_impl="plain"``
    runs the plain correlations on any device (a yardstick for the
    kernels); None runs the CUDA kernels on a GPU. ``pallas_levels`` and
    ``pallas_grad`` go to the encoder (``PyramidEncoder``): the first N
    levels as fused kernels.

    ``stacked_input=True`` (the reference's producer-stacked signature)
    makes the forward take one (3B, H, W, 3) tensor holding [left; right;
    temporal] along the batch: the encoder's batch as it is, with the
    same weights and arithmetic.

    ``fused``, ``est_input``, ``distribute_outputs``, ``upfeat_impl`` and
    ``upsample_impl`` are the reference's decoder arithmetic, with its
    defaults; both decoders take them (``models/flow.py``'s
    ``CoarseToFineDecoder``)."""

    def __init__(self, encoder_channels: Sequence[int] = (16, 32, 64, 96, 128, 196),
                 num_classes: int = 19, max_disp_full: int = 96,
                 flow_max_disp: int = 4,
                 est_channels: Sequence[int] = (128, 128, 96, 64, 32),
                 ctx_channels: Sequence[int] = (128, 128, 128, 96, 64, 32),
                 fpn_channels: int = 96, seg_head: str = "fpn",
                 corr_impl: str | None = None,
                 dtype: torch.dtype = torch.float32, pallas_levels: int = 0,
                 pallas_grad: str = "xla", stacked_input: bool = False,
                 fused: bool = True, est_input: str = "concat",
                 distribute_outputs: bool = True,
                 upfeat_impl: str = "subpixel",
                 upsample_impl: str = "resize"):
        super().__init__()
        self.stacked_input = stacked_input
        self.encoder = PyramidEncoder(encoder_channels,
                                      pallas_levels=pallas_levels,
                                      pallas_grad=pallas_grad)
        arithmetic = dict(corr_impl=corr_impl, fused=fused,
                          est_input=est_input,
                          distribute_outputs=distribute_outputs,
                          upfeat_impl=upfeat_impl,
                          upsample_impl=upsample_impl)
        self.disparity = DisparityDecoder(encoder_channels, max_disp_full,
                                          est_channels, ctx_channels,
                                          **arithmetic)
        self.flow = FlowDecoder(encoder_channels, flow_max_disp, est_channels,
                                ctx_channels, **arithmetic)
        self.segmentation = make_seg_head(seg_head, encoder_channels,
                                          num_classes, fpn_channels)
        self.to(dtype=dtype, memory_format=torch.channels_last)
        self.segmentation.classifier.float()

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.blocks[0].conv.weight.dtype

    def forward(self, left, right=None, temporal=None):
        """left/right/temporal: (B, H, W, 3) frames (with ``stacked_input``,
        ``left`` alone: the (3B, H, W, 3) stack). Returns a dict:
          seg_logits    (B, H, W, classes) float32
          flow          (B, H, W, 2) float32, left -> temporal
          disp          (B, H, W, 1) float32, left image
          flow_pyramid  {level: (B, H/2^l, W/2^l, 2)} for levels 6..2
          disp_pyramid  {level: (B, H/2^l, W/2^l, 1)} for levels 6..2
        """
        if self.stacked_input:
            if right is not None or temporal is not None:
                raise ValueError(
                    "stacked_input=True takes one (3B,H,W,3) tensor")
            if left.shape[0] % 3 != 0:
                raise ValueError(
                    "stacked_input=True expects a (3B,H,W,3) tensor whose "
                    f"leading dim is divisible by 3, got {tuple(left.shape)}")
            f_left, f_right, f_temporal = self.encoder.encode_stacked(left, 3)
        elif right is None or temporal is None:
            raise ValueError(
                "right/temporal are required unless stacked_input=True "
                "(pass one (3B,H,W,3) tensor in that mode)")
        else:
            f_left, f_right, f_temporal = self.encoder.encode(left, right,
                                                              temporal)
        disp = self.disparity(f_left, f_right)
        flow = self.flow(f_left, f_temporal)
        seg = self.segmentation(f_left, left.shape[1:3])
        return {
            "seg_logits": nhwc(seg),
            "flow": nhwc(flow["flow"]).float(),
            "disp": nhwc(disp["disp"]).float(),
            "flow_pyramid": {l: nhwc(v) for l, v in flow["flow_pyramid"].items()},
            "disp_pyramid": {l: nhwc(v) for l, v in disp["disp_pyramid"].items()},
        }
