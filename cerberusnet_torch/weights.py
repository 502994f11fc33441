"""Weights for the port: loading the reference's flax parameters, and an
initialiser with flax's defaults.

``load_flax_params(module, params)`` takes the flax ``variables["params"]``
tree (numpy or array leaves) of the matching reference module and fills a
port module in place: a whole ``CerberusNet``, ``CerberusDCV``,
``DCVFlowNet``, ``DCVStereoNet``, ``CerberusRAFT``, ``RAFTFlowNet``,
``RAFTStereoNet``, ``FlowNet``, ``StereoNet`` or ``SegNet``, or one of their
parts (``PyramidEncoder``, ``FlowDecoder``, ``DisparityDecoder``,
``DCVFlowDecoder``, ``DCVStereoDecoder``, ``RAFTFlowDecoder``,
``RAFTStereoDecoder``, ``SegmentationHead``, ``ASPPSegmentationHead``). A RAFT decoder's update block has one parameter tree
whether the reference scans or unrolls its iterations. Layouts:
  * flax Conv kernel HWIO -> torch Conv2d weight OIHW
  * flax ConvTranspose kernel (kh, kw, cin, cout) -> torch ConvTranspose2d
    weight (cin, cout, kh, kw) of the spatially flipped kernel; with
    stride 2 and padding 1 it equals flax's "SAME" transposed conv
Every parameter of the module must be filled, or it raises.

``init_params(module, generator)`` draws what flax's initialisers draw
(lecun-normal kernels, zero biases) from a seeded ``torch.Generator``, so
the model runs at realistic activation scales without the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.dcv_flow import (
    CerberusDCV,
    DCVDecoder,
    DCVFlowNet,
    DCVStereoNet,
)
from cerberusnet_torch.models.disparity import StereoNet
from cerberusnet_torch.models.encoder import PyramidEncoder
from cerberusnet_torch.models.flow import CoarseToFineDecoder, FlowNet
from cerberusnet_torch.models.raft import (
    CerberusRAFT,
    RAFTDecoder,
    RAFTFlowNet,
    RAFTStereoNet,
)
from cerberusnet_torch.models.segmentation import (
    ASPPSegmentationHead,
    SegmentationHead,
    SegNet,
)

# flax's truncated normal is cut at +-2 std and rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _fill(param: torch.Tensor, value: np.ndarray, done: set):
    src = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit a parameter "
                         f"of shape {tuple(param.shape)}")
    param.copy_(src)
    done.add(id(param))


def _conv(conv: nn.Conv2d, p, done):
    _fill(conv.weight, np.asarray(p["kernel"]).transpose(3, 2, 0, 1), done)
    _fill(conv.bias, np.asarray(p["bias"]), done)


def _conv_transpose(conv: nn.ConvTranspose2d, p, done):
    k = np.asarray(p["kernel"])[::-1, ::-1]
    _fill(conv.weight, k.transpose(2, 3, 0, 1), done)
    _fill(conv.bias, np.asarray(p["bias"]), done)


def _blocks(blocks, p, done):
    for j, block in enumerate(blocks):
        _conv(block.conv, p[f"ConvBlock_{j}"]["Conv_0"], done)


def _decoder(dec, p, done):
    for i, est in enumerate(dec.estimators):
        _blocks(est.blocks, p[f"DenseEstimator_{i}"], done)
        _conv(dec.predictors[i], p[f"Conv_{i}"], done)
    for i, up in enumerate(dec.upfeats):
        _conv_transpose(up, p[f"ConvTranspose_{i}"], done)
    ctx = p["ContextNetwork_0"]
    _blocks(dec.context.blocks, ctx, done)
    _conv(dec.context.out, ctx["Conv_0"], done)


def _dcv_decoder(dec, p, done):
    _blocks(dec.estimator.blocks, p["DenseEstimator_0"], done)
    _conv(dec.predictor, p["Conv_0"], done)
    ctx = p["ContextNetwork_0"]
    _blocks(dec.context.blocks, ctx, done)
    _conv(dec.context.out, ctx["Conv_0"], done)


def _raft_decoder(dec, p, done):
    _conv(dec.corr_proj, p["corr_proj"], done)
    _conv(dec.context_proj, p["context_proj"], done)
    update, pu = dec.update, p["update"]
    for part, names in (("motion", ("convc1", "convc2", "convf1", "convf2",
                                    "conv")),
                        ("gru", ("convz", "convr", "convq"))):
        for name in names:
            _conv(getattr(getattr(update, part), name), pu[part][name], done)
    for name in ("flow_head1", "flow_head2", "mask_head1", "mask_head2"):
        _conv(getattr(update, name), pu[name], done)


def _segmentation(seg, p, done):
    for i, lat in enumerate(seg.laterals):
        _conv(lat, p[f"Conv_{i}"], done)
    _blocks(seg.smooth, p, done)
    _conv(seg.final.conv, p[f"ConvBlock_{len(seg.smooth)}"]["Conv_0"], done)
    _conv(seg.classifier, p[f"Conv_{len(seg.laterals)}"], done)


def _aspp(seg, p, done):
    _blocks(seg.branches, p, done)
    _conv(seg.pool, p["Conv_0"], done)
    _conv(seg.project, p["Conv_1"], done)
    _conv(seg.skip, p["Conv_2"], done)
    n = len(seg.branches)
    for j, block in enumerate(seg.refine):
        _conv(block.conv, p[f"ConvBlock_{n + j}"]["Conv_0"], done)
    _conv(seg.classifier, p["Conv_3"], done)


# a whole model's parts, by the port's attribute; the reference names each
# part by its class, which the port's part shares, as "<class>_0"
_PARTS = {
    CerberusNet: ("encoder", "disparity", "flow", "segmentation"),
    CerberusDCV: ("encoder", "disparity", "flow", "segmentation"),
    CerberusRAFT: ("encoder", "flow", "disparity", "segmentation"),
    DCVFlowNet: ("encoder", "flow"),
    DCVStereoNet: ("encoder", "disparity"),
    RAFTFlowNet: ("encoder", "flow"),
    RAFTStereoNet: ("encoder", "disparity"),
    FlowNet: ("encoder", "flow"),
    StereoNet: ("encoder", "disparity"),
    SegNet: ("encoder", "segmentation"),
}


def _load(module, p, done):
    parts = _PARTS.get(type(module))
    if parts:
        for attr in parts:
            part = getattr(module, attr)
            _load(part, p[f"{type(part).__name__}_0"], done)
    elif isinstance(module, DCVDecoder):
        _dcv_decoder(module, p, done)
    elif isinstance(module, RAFTDecoder):
        _raft_decoder(module, p, done)
    elif isinstance(module, PyramidEncoder):
        _blocks(module.blocks, p, done)
    elif isinstance(module, CoarseToFineDecoder):
        _decoder(module, p, done)
    elif isinstance(module, SegmentationHead):
        _segmentation(module, p, done)
    elif isinstance(module, ASPPSegmentationHead):
        _aspp(module, p, done)
    else:
        raise TypeError(f"no flax mapping for {type(module).__name__}")


@torch.no_grad()
def load_flax_params(module: nn.Module, params) -> nn.Module:
    """Fills ``module`` in place from a flax param tree; returns it."""
    done: set = set()
    _load(module, params, done)
    missed = [n for n, t in module.named_parameters() if id(t) not in done]
    if missed:
        raise ValueError(f"parameters not in the flax tree: {missed}")
    return module


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """lecun-normal kernels and zero biases, as flax initialises them,
    drawn in float32 on the CPU from ``generator`` (so one seed gives the
    same weights on any device and in any type); returns ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):  # (cin, cout, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:  # (cout, cin, kh, kw)
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            draw = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            w.copy_(draw)
            m.bias.zero_()
    return module
