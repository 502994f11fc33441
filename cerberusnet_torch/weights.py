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

``load_torch_cerberus(model, state_dict)`` fills a port ``CerberusNet``
(FPN head) from the ``state_dict`` of ``tools/torch_baseline.py``'s
``TorchCerberus``, the architecture's PyTorch mirror in the reference
repository: both hold OIHW convolutions and (cin, cout, kh, kw) transposed
convolutions, so the map renames and copies; every parameter must be
filled from a key of the same shape and every key used, or it raises.
``torch_cerberus_state_dict(model)`` is its inverse: the mirror's
state_dict of a port CerberusNet.

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


# The walk below visits each conv of a port module with its subtree of the
# flax tree: ``visit(conv, p)``. Loading copies the subtree's kernel and
# bias; ``flax_conv_paths`` hands it a _FlaxPath and records the path.


def _conv(conv: nn.Module, p, visit):
    visit(conv, p)


def _blocks(blocks, p, visit):
    for j, block in enumerate(blocks):
        _conv(block.conv, p[f"ConvBlock_{j}"]["Conv_0"], visit)


def _decoder(dec, p, visit):
    for i, est in enumerate(dec.estimators):
        _blocks(est.blocks, p[f"DenseEstimator_{i}"], visit)
        _conv(dec.predictors[i], p[f"Conv_{i}"], visit)
    for i, up in enumerate(dec.upfeats):
        _conv(up, p[f"ConvTranspose_{i}"], visit)
    ctx = p["ContextNetwork_0"]
    _blocks(dec.context.blocks, ctx, visit)
    _conv(dec.context.out, ctx["Conv_0"], visit)


def _dcv_decoder(dec, p, visit):
    _blocks(dec.estimator.blocks, p["DenseEstimator_0"], visit)
    _conv(dec.predictor, p["Conv_0"], visit)
    ctx = p["ContextNetwork_0"]
    _blocks(dec.context.blocks, ctx, visit)
    _conv(dec.context.out, ctx["Conv_0"], visit)


def _raft_decoder(dec, p, visit):
    _conv(dec.corr_proj, p["corr_proj"], visit)
    _conv(dec.context_proj, p["context_proj"], visit)
    update, pu = dec.update, p["update"]
    for part, names in (("motion", ("convc1", "convc2", "convf1", "convf2",
                                    "conv")),
                        ("gru", ("convz", "convr", "convq"))):
        for name in names:
            _conv(getattr(getattr(update, part), name), pu[part][name], visit)
    for name in ("flow_head1", "flow_head2", "mask_head1", "mask_head2"):
        _conv(getattr(update, name), pu[name], visit)


def _segmentation(seg, p, visit):
    for i, lat in enumerate(seg.laterals):
        _conv(lat, p[f"Conv_{i}"], visit)
    _blocks(seg.smooth, p, visit)
    _conv(seg.final.conv, p[f"ConvBlock_{len(seg.smooth)}"]["Conv_0"], visit)
    _conv(seg.classifier, p[f"Conv_{len(seg.laterals)}"], visit)


def _aspp(seg, p, visit):
    _blocks(seg.branches, p, visit)
    _conv(seg.pool, p["Conv_0"], visit)
    _conv(seg.project, p["Conv_1"], visit)
    _conv(seg.skip, p["Conv_2"], visit)
    n = len(seg.branches)
    for j, block in enumerate(seg.refine):
        _conv(block.conv, p[f"ConvBlock_{n + j}"]["Conv_0"], visit)
    _conv(seg.classifier, p["Conv_3"], visit)


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


def _load(module, p, visit):
    parts = _PARTS.get(type(module))
    if parts:
        for attr in parts:
            part = getattr(module, attr)
            _load(part, p[f"{type(part).__name__}_0"], visit)
    elif isinstance(module, DCVDecoder):
        _dcv_decoder(module, p, visit)
    elif isinstance(module, RAFTDecoder):
        _raft_decoder(module, p, visit)
    elif isinstance(module, PyramidEncoder):
        _blocks(module.blocks, p, visit)
    elif isinstance(module, CoarseToFineDecoder):
        _decoder(module, p, visit)
    elif isinstance(module, SegmentationHead):
        _segmentation(module, p, visit)
    elif isinstance(module, ASPPSegmentationHead):
        _aspp(module, p, visit)
    else:
        raise TypeError(f"no flax mapping for {type(module).__name__}")


@torch.no_grad()
def load_flax_params(module: nn.Module, params) -> nn.Module:
    """Fills ``module`` in place from a flax param tree; returns it."""
    done: set = set()

    def fill(conv, p):
        k = np.asarray(p["kernel"])
        if isinstance(conv, nn.ConvTranspose2d):
            k = k[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            k = k.transpose(3, 2, 0, 1)
        _fill(conv.weight, k, done)
        _fill(conv.bias, np.asarray(p["bias"]), done)

    _load(module, params, fill)
    missed = [n for n, t in module.named_parameters() if id(t) not in done]
    if missed:
        raise ValueError(f"parameters not in the flax tree: {missed}")
    return module


class _FlaxPath:
    """A stand-in for a flax tree that records the keys it is read by."""

    def __init__(self, path=()):
        self.path = path

    def __getitem__(self, key):
        return _FlaxPath((*self.path, key))


def flax_conv_paths(module: nn.Module) -> dict:
    """{qualified name of each conv of ``module``: the path of its flax
    module in the reference's tree}, e.g. ``"encoder.blocks.0.conv"`` ->
    ``("PyramidEncoder_0", "ConvBlock_0", "Conv_0")``, by the walk that
    ``load_flax_params`` takes; the paths key the reference's calibration
    scales and ``quant`` entries."""
    names = {id(m): n for n, m in module.named_modules()}
    paths = {}

    def record(conv, p):
        paths[names[id(conv)]] = p.path

    _load(module, _FlaxPath(), record)
    return paths


# TorchCerberus's pyramid levels, in the order the port's lists hold them
_TORCH_LEVELS = ("6", "5", "4", "3", "2")
# an encoder stage's Sequential: the padded strided conv, then two convs
_TORCH_STAGE = {"0": 0, "2": 1, "4": 2}
_TORCH_HEADS = {"flow": "flow", "disp": "disparity"}


def torch_cerberus_name(key: str, names) -> str:
    """The port CerberusNet's parameter name for a ``TorchCerberus``
    state_dict key; ``names`` are the port model's parameter names (a
    context network's last conv is its ``out``)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "enc" and parts[1] == "stages":
        block = 3 * int(parts[2]) + _TORCH_STAGE[parts[3]]
        return f"encoder.blocks.{block}.conv.{leaf}"
    if parts[0] in _TORCH_HEADS:
        head = _TORCH_HEADS[parts[0]]
        if parts[1] == "est" and parts[3] == "convs":
            k = _TORCH_LEVELS.index(parts[2])
            return f"{head}.estimators.{k}.blocks.{parts[4]}.conv.{leaf}"
        if parts[1] == "est" and parts[3] == "pred":
            return f"{head}.predictors.{_TORCH_LEVELS.index(parts[2])}.{leaf}"
        if parts[1] == "upfeat":
            return f"{head}.upfeats.{_TORCH_LEVELS.index(parts[2])}.{leaf}"
        if parts[1] == "ctx":  # net.{2j}: conv j, a LeakyReLU between
            block = f"{head}.context.blocks.{int(parts[3]) // 2}.conv.{leaf}"
            return block if block in names else f"{head}.context.out.{leaf}"
    if parts[0] == "seg":
        if parts[1] == "lat":
            k = _TORCH_LEVELS.index(parts[2])
            return f"segmentation.laterals.{k}.{leaf}"
        if parts[1] == "smooth":
            k = _TORCH_LEVELS[1:].index(parts[2])
            return f"segmentation.smooth.{k}.conv.{leaf}"
        if parts[1] == "final":
            return f"segmentation.final.conv.{leaf}"
        if parts[1] == "cls":
            return f"segmentation.classifier.{leaf}"
    raise ValueError(f"{key!r} is no TorchCerberus parameter")


@torch.no_grad()
def load_torch_cerberus(model: CerberusNet, state_dict) -> CerberusNet:
    """Fills ``model`` in place from a ``TorchCerberus`` state_dict;
    returns it."""
    if not isinstance(model, CerberusNet) or not isinstance(
            model.segmentation, SegmentationHead):
        raise TypeError("TorchCerberus maps onto CerberusNet with the FPN "
                        f"head, not {type(model).__name__}")
    params = dict(model.named_parameters())
    done: set = set()
    for key, value in state_dict.items():
        name = torch_cerberus_name(key, params)
        if name not in params:
            raise ValueError(f"{key!r} maps to {name!r}, which the model "
                             "does not have")
        _fill(params[name], value.detach().float().cpu().numpy(), done)
    missed = [n for n, t in params.items() if id(t) not in done]
    if missed:
        raise ValueError(f"parameters not in the state_dict: {missed}")
    return model


def torch_cerberus_state_dict(model: CerberusNet) -> dict:
    """The ``TorchCerberus`` state_dict (float32 CPU copies) holding the
    weights of a port ``CerberusNet`` with the FPN head."""
    params = dict(model.named_parameters())
    # an encoder stage's padded strided conv is the Sequential's "0.1"
    stage = {0: "0.1", 1: "2", 2: "4"}
    out = {}
    for name, p in params.items():
        parts = name.split(".")
        leaf = parts[-1]
        if parts[0] == "encoder":
            b = int(parts[2])
            key = f"enc.stages.{b // 3}.{stage[b % 3]}.{leaf}"
        elif parts[0] == "segmentation":
            kind = parts[1]
            if kind == "laterals":
                key = f"seg.lat.{_TORCH_LEVELS[int(parts[2])]}.{leaf}"
            elif kind == "smooth":
                key = f"seg.smooth.{_TORCH_LEVELS[1 + int(parts[2])]}.{leaf}"
            else:
                key = f"seg.{'cls' if kind == 'classifier' else kind}.{leaf}"
        else:
            head = "disp" if parts[0] == "disparity" else parts[0]
            kind = parts[1]
            if kind == "context":
                j = (int(parts[3]) if parts[2] == "blocks" else
                     len(getattr(model, parts[0]).context.blocks))
                key = f"{head}.ctx.net.{2 * j}.{leaf}"
            else:
                level = _TORCH_LEVELS[int(parts[2])]
                key = {"estimators": f"{head}.est.{level}.convs.{parts[-3]}",
                       "predictors": f"{head}.est.{level}.pred",
                       "upfeats": f"{head}.upfeat.{level}"}[kind] + f".{leaf}"
        if torch_cerberus_name(key, params) != name:
            raise ValueError(f"{name!r} has no TorchCerberus key")
        out[key] = p.detach().float().cpu().clone()
    return out


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
