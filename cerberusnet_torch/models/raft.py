"""The RAFT family, port of ``cerberusnet_tpu/models/raft.py``: the
all-pairs correlation ops, ``ConvGRU``, ``MotionEncoder``, ``UpdateBlock``,
``RAFTFlowDecoder``, ``RAFTStereoDecoder`` and the models ``RAFTFlowNet``,
``RAFTStereoNet`` and the joint ``CerberusRAFT``.

A RAFT decoder works at one pyramid level (3 by default):
  1. a 1x1 projection of both feature maps, and their all-pairs
     correlation, one batched matrix product (2-D for flow, every pixel
     against every pixel; 1-D for stereo, against its own row), divided by
     sqrt(C) and accumulated in float32 whatever the model's type; average
     pooling of the target grid gives a pyramid of ``corr_levels`` volumes
  2. from frame 1's features, the GRU's hidden state (tanh) and a context
     (ReLU)
  3. ``iters`` weight-tied updates: look the pyramid up in a (2r+1) window
     around the current estimate (bilinear, zero outside the frame), encode
     it with the estimate, step the GRU, add the predicted delta (float32)
  4. convex upsampling of the last estimate by the last update's mask.
The family runs no hand kernel: its products are plain ``torch.matmul``.
The iterations are a Python loop: the reference's ``unroll_iters`` (its
choice between ``nn.scan`` and an unrolled loop over one parameter tree)
has no counterpart here.

Inputs and outputs are NHWC, as in the reference; inside, convolutions take
NCHW tensors in ``torch.channels_last``, and the volumes, the lookups and
the estimates are float32 NHWC tensors, as the reference keeps them.

On a spatial mesh (``spatial``, ``models/common.py``'s ``set_spatial``) a
decoder runs on its band of the level's rows. Its "SAME" convolutions
take halos of k // 2 rows (``band_conv``: the 3x3 ``context_proj``, the
GRU's, the motion encoder's 3x3s and 5x5 ``convf1``, the heads' 3x3s; the
1x1s none), and the convex upsampling's edge-padded 3x3 neighbourhood one
edge-filled row each side. The flow decoder correlates its band of f1 with
the whole f2 at the level (the features gathered from the peers before
``corr_proj``, ``gather_rows``), so the pyramid's pooling of the frame-2
grid and the lookup read a whole frame, at absolute rows (the grid starts
at the band's first row). The stereo volume correlates each row with its
own row and needs no exchange; the iterates stay on the band.

The weights a decoder uses more than once (``corr_proj`` on both frames,
the update block at every iteration) are ``TiedConv2d``s, which cast their
parameters to the input's type at each use. A model is built in one type;
the trainer puts them back in float32 (``keep_tied_float32``), so the
gradients of their uses sum in float32, as the reference's float32
parameters, cast by each call, sum them; held in bf16, each iteration's
share would be rounded into a bf16 sum. Served, they stay in the model's
type and the casts do nothing.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cerberusnet_torch.models.common import (
    FlaxConv2d,
    band_conv,
    band_convs,
    leaky,
    nchw,
    nhwc,
    sigmoid,
    tanh,
)
from cerberusnet_torch.models.encoder import PyramidEncoder
from cerberusnet_torch.models.segmentation import make_seg_head
from cerberusnet_torch.parallel.halo import gather_rows, halo_rows

ENCODER_CHANNELS = (16, 32, 64, 96, 128, 196)
LOOKUPS = ("gather", "onehot")


def _check_impl(impl: str, what: str):
    # ModelConfig.raft_lookup reaches here unvalidated: a typo must raise
    if impl not in LOOKUPS:
        raise ValueError(
            f"{what} impl must be 'gather' or 'onehot', got {impl!r}")


# ------------------------------------------------------------ 2-D ops


def allpairs_correlation(f1, f2):
    """(B, h, w, C) x (B, h2, w2, C) -> (B, h*w, h2, w2) float32:
    corr[b, n, y2, x2] = <f1[b, n], f2[b, y2, x2]> / sqrt(C). The product
    runs on float32 operands (a bf16 value is exact in float32), so a bf16
    model gets the float32 accumulation, as the reference asks with
    ``preferred_element_type``."""
    b, h, w, c = f1.shape
    h2, w2 = f2.shape[1:3]
    a = f1.reshape(b, h * w, c).float()
    bb = f2.reshape(b, h2 * w2, c).float()
    corr = torch.matmul(a, bb.transpose(1, 2)) / math.sqrt(c)
    return corr.reshape(b, h * w, h2, w2)


def correlation_pyramid(corr, num_levels: int):
    """Average-pools the last two dims (the frame-2 grid) 2x2 num_levels - 1
    times; an odd extent drops its last row or column ("VALID"), so an
    extent of 1 pools to an empty level, as in the reference. A list of
    (B, N, hk, wk) volumes."""
    pyramid = [corr]
    for _ in range(num_levels - 1):
        x = pyramid[-1]
        b, n, h, w = x.shape
        h, w = h // 2, w // 2
        x = x[..., :2 * h, :2 * w].reshape(b, n, h, 2, w, 2)
        pyramid.append(x.sum(dim=(3, 5)) * 0.25)
    return pyramid


def _interp_matrix(pos, size: int, radius: int):
    """(B, N) positions -> (B, N, 2r+1, size) float32: the bilinear weight
    of grid cell j for the sample at pos + (d - r). A cell outside
    [0, size-1] never equals a corner, which gives zero outside the frame."""
    pos = pos.float()
    x0 = torch.floor(pos)
    f = (pos - x0)[..., None, None]
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32,
                           device=pos.device)
    base = x0[..., None, None] + offsets[:, None]
    cells = torch.arange(size, dtype=torch.float32, device=pos.device)
    is0 = (cells == base).float()
    is1 = (cells == base + 1.0).float()
    return is0 * (1.0 - f) + is1 * f


def _corr_lookup_onehot(pyramid, coords, radius: int):
    """The window sample is linear in the volume: A_y @ vol @ A_x^T per
    query, two batched products of the interpolation matrices."""
    b, h, w, _ = coords.shape
    n, p = h * w, 2 * radius + 1
    cf = coords.float().reshape(b, n, 2)
    outs = []
    for k, vol in enumerate(pyramid):
        hk, wk = vol.shape[2], vol.shape[3]
        ay = _interp_matrix(cf[..., 1] / 2.0**k, hk, radius)  # (B, N, P, hk)
        ax = _interp_matrix(cf[..., 0] / 2.0**k, wk, radius)  # (B, N, P, wk)
        rows = torch.matmul(ay, vol.float())  # (B, N, P, wk)
        out = torch.matmul(rows, ax.transpose(2, 3))  # (B, N, P(dy), P(dx))
        outs.append(out.reshape(b, n, p * p))
    return torch.cat(outs, dim=-1).reshape(b, h, w, -1)


def corr_lookup(pyramid, coords, radius: int, impl: str = "gather"):
    """Samples each pyramid level in a (2r+1)^2 window around ``coords``.

    pyramid: (B, N, hk, wk) volumes; coords: (B, h, w, 2) absolute (x, y)
    positions in level-0 pixels of the frame-2 grid. Returns (B, h, w,
    levels * (2r+1)^2) float32, the window in ``meshgrid(..., "xy")`` ravel
    order (x fastest). Bilinear, zero outside the frame. ``impl="gather"``
    reads four corners a sample by ``torch.gather`` on the flattened rows;
    ``"onehot"`` is the same function as two products."""
    _check_impl(impl, "corr_lookup")
    if impl == "onehot":
        return _corr_lookup_onehot(pyramid, coords, radius)
    b, h, w, _ = coords.shape
    n, p = h * w, 2 * radius + 1
    r = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=coords.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    delta = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # (P*P, 2)
    cf = coords.float().reshape(b, n, 1, 2)
    outs = []
    for k, vol in enumerate(pyramid):
        hk, wk = vol.shape[2], vol.shape[3]
        if hk * wk == 0:  # an empty level reads zero, as in the reference
            outs.append(cf.new_zeros(b, n, p * p))
            continue
        pts = cf / 2.0**k + delta  # (B, N, P*P, 2)
        xs, ys = pts[..., 0], pts[..., 1]
        x0, y0 = torch.floor(xs), torch.floor(ys)
        wx, wy = xs - x0, ys - y0
        flat = vol.reshape(b * n, hk * wk).float()

        def corner(cx, cy):
            inb = (cx >= 0) & (cx <= wk - 1) & (cy >= 0) & (cy <= hk - 1)
            xi = cx.clamp(0, wk - 1).long()
            yi = cy.clamp(0, hk - 1).long()
            idx = (yi * wk + xi).reshape(b * n, p * p)
            return flat.gather(1, idx).reshape(b, n, p * p) * inb

        outs.append(corner(x0, y0) * (1 - wx) * (1 - wy)
                    + corner(x0 + 1, y0) * wx * (1 - wy)
                    + corner(x0, y0 + 1) * (1 - wx) * wy
                    + corner(x0 + 1, y0 + 1) * wx * wy)
    return torch.cat(outs, dim=-1).reshape(b, h, w, -1)


# ------------------------------------------------------------ 1-D ops


def allpairs_correlation_1d(f1, f2):
    """(B, h, w, C) x2 -> (B, h*w, w) float32: every pixel against every
    pixel of its own row, / sqrt(C), float32 as ``allpairs_correlation``."""
    b, h, w, c = f1.shape
    corr = torch.matmul(f1.float(), f2.float().transpose(2, 3)) / math.sqrt(c)
    return corr.reshape(b, h * w, w)


def correlation_pyramid_1d(corr, num_levels: int):
    """Average-pools the last dim (the candidates) by 2, num_levels - 1
    times ("VALID", an extent of 1 pools to an empty level); a list of
    (B, N, wk) volumes."""
    pyramid = [corr]
    for _ in range(num_levels - 1):
        x = pyramid[-1]
        b, n, w = x.shape
        w //= 2
        pyramid.append(x[..., :2 * w].reshape(b, n, w, 2).sum(dim=3) * 0.5)
    return pyramid


def corr_lookup_1d(pyramid, coords_x, radius: int, impl: str = "gather"):
    """Samples each level in a (2r+1) window around ``coords_x`` (B, h, w),
    absolute x positions in the right image; (B, h, w, levels*(2r+1))
    float32, linear, zero outside the row. ``impl`` as ``corr_lookup``."""
    _check_impl(impl, "corr_lookup_1d")
    b, h, w = coords_x.shape
    n, p = h * w, 2 * radius + 1
    outs = []
    if impl == "onehot":
        cf = coords_x.float().reshape(b, n)
        for k, vol in enumerate(pyramid):
            ax = _interp_matrix(cf / 2.0**k, vol.shape[2], radius)
            outs.append(torch.matmul(ax, vol.float()[..., None])[..., 0])
        return torch.cat(outs, dim=-1).reshape(b, h, w, -1)
    delta = torch.arange(-radius, radius + 1, dtype=torch.float32,
                         device=coords_x.device)
    cf = coords_x.float().reshape(b, n, 1)
    for k, vol in enumerate(pyramid):
        wk = vol.shape[2]
        if wk == 0:  # an empty level reads zero, as in the reference
            outs.append(cf.new_zeros(b, n, p))
            continue
        xs = cf / 2.0**k + delta  # (B, N, P)
        x0 = torch.floor(xs)
        wx = xs - x0
        flat = vol.reshape(b * n, wk).float()

        def corner(cx):
            inb = (cx >= 0) & (cx <= wk - 1)
            xi = cx.clamp(0, wk - 1).long().reshape(b * n, p)
            return flat.gather(1, xi).reshape(b, n, p) * inb

        outs.append(corner(x0) * (1 - wx) + corner(x0 + 1) * wx)
    return torch.cat(outs, dim=-1).reshape(b, h, w, -1)


# ------------------------------------------------------- grid, upsample


def base_grid(b: int, h: int, w: int, device=None, row0: int = 0):
    """(B, h, w, 2) float32 grid of absolute (x, y) pixel positions, its
    rows from ``row0``."""
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1).expand(b, h, w, 2)


def convex_upsample(flow, mask, factor: int, spatial=None):
    """RAFT's convex upsampling: each fine pixel is a convex combination
    of its coarse pixel's 3x3 neighbourhood (edge-padded).

    flow: (B, h, w, C) in coarse pixels; mask: (B, h, w, factor^2 * 9)
    logits, softmaxed over the 9 taps in float32. Returns (B, h*factor,
    w*factor, C) float32 in fine pixels (values scaled by ``factor``).
    ``spatial``: both are bands of that mesh, whose row above and below
    come from the neighbouring bands (the frame's edge rows at its
    borders)."""
    b, h, w, c = flow.shape
    m = mask.float().reshape(b, h, w, factor * factor, 9).softmax(dim=-1)
    x = nchw(flow.float() * factor)
    if spatial is None:
        fp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    else:
        fp = F.pad(halo_rows(x, 1, 1, spatial, "edge"), (1, 1, 0, 0),
                   mode="replicate")
    fp = fp.permute(0, 2, 3, 1)
    neigh = torch.stack([fp[:, i:i + h, j:j + w, :]
                         for i in range(3) for j in range(3)], dim=3)
    up = torch.matmul(m, neigh)  # (B, h, w, f*f, C)
    up = up.reshape(b, h, w, factor, factor, c).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(b, h * factor, w * factor, c)


# -------------------------------------------------------------- blocks


class TiedConv2d(FlaxConv2d):
    """A convolution whose parameters are cast to the input's type at each
    use (no copy when they are of that type); kept float32
    (``keep_tied_float32``), the gradients of its uses sum in float32.
    It rounds as ``FlaxConv2d`` (with the bias fused, 12-34% of the update
    block's bf16 conv outputs differed from JAX's)."""

    def forward(self, x):
        return self.rounded_forward(x, self.weight.to(x.dtype),
                                    self.bias.to(x.dtype))


def keep_tied_float32(module: nn.Module):
    """Puts every ``TiedConv2d`` of ``module`` in float32; returns it."""
    for m in module.modules():
        if isinstance(m, TiedConv2d):
            m.float()
    return module


def _conv(cin: int, cout: int, k: int, cls=TiedConv2d):
    """A "SAME" convolution of an odd kernel at stride 1."""
    return cls(cin, cout, k, padding=k // 2)


class ConvGRU(nn.Module):
    """3x3 convolutional GRU cell: ``convz``, ``convr``, ``convq``; its
    gates round as flax's (``models/common.py``'s ``sigmoid``, ``tanh``)."""

    spatial = None

    def __init__(self, hidden: int, input_channels: int):
        super().__init__()
        self.convz = _conv(hidden + input_channels, hidden, 3)
        self.convr = _conv(hidden + input_channels, hidden, 3)
        self.convq = _conv(hidden + input_channels, hidden, 3)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z, r = (sigmoid(y) for y in band_convs(
            (self.convz, self.convr), hx, self.spatial))
        q = tanh(band_conv(self.convq, torch.cat([r * h, x], dim=1),
                                 self.spatial))
        return (1.0 - z) * h + z * q


class MotionEncoder(nn.Module):
    """Encodes (lookup, current estimate) into 80 motion channels and
    appends the estimate."""

    out_channels = 80
    spatial = None

    def __init__(self, corr_channels: int, pred_channels: int):
        super().__init__()
        self.convc1 = _conv(corr_channels, 96, 1)
        self.convc2 = _conv(96, 64, 3)
        self.convf1 = _conv(pred_channels, 64, 5)
        self.convf2 = _conv(64, 32, 3)
        self.conv = _conv(64 + 32, self.out_channels, 3)

    def forward(self, corr, flow):
        sp = self.spatial
        c = leaky(band_conv(self.convc2, leaky(self.convc1(corr)), sp))
        f = leaky(band_conv(self.convf1, flow, sp))
        f = leaky(band_conv(self.convf2, f, sp))
        out = leaky(band_conv(self.conv, torch.cat([c, f], dim=1), sp))
        return torch.cat([out, flow], dim=1)


class UpdateBlock(nn.Module):
    """One refinement step: motion encoder, GRU, the delta of the estimate
    (``flow_head1/2``; 2 channels for flow, 1 for disparity) and the
    upsampling mask's logits (``mask_head1/2``)."""

    spatial = None

    def __init__(self, hidden: int, context: int, corr_channels: int,
                 upsample_factor: int, pred_channels: int = 2):
        super().__init__()
        self.motion = MotionEncoder(corr_channels, pred_channels)
        self.gru = ConvGRU(hidden, context + MotionEncoder.out_channels
                           + pred_channels)
        self.flow_head1 = _conv(hidden, 128, 3)
        self.flow_head2 = _conv(128, pred_channels, 3)
        self.mask_head1 = _conv(hidden, 128, 3)
        self.mask_head2 = _conv(128, upsample_factor**2 * 9, 1)

    def forward(self, hidden, corr_feat, field, context):
        """hidden, context: NCHW in the model's type; corr_feat, field: NHWC
        float32. Returns (hidden, delta NHWC float32, mask NCHW in the
        model's type)."""
        dtype = context.dtype
        motion = self.motion(nchw(corr_feat.to(dtype)), nchw(field.to(dtype)))
        hidden = self.gru(hidden, torch.cat([context, motion], dim=1))
        flow1, mask1 = band_convs((self.flow_head1, self.mask_head1), hidden,
                                  self.spatial)
        delta = band_conv(self.flow_head2, leaky(flow1), self.spatial)
        mask = self.mask_head2(leaky(mask1))
        return hidden, nhwc(delta).float(), mask


# ------------------------------------------------------------ decoders


class RAFTDecoder(nn.Module):
    """The iterative decoder shared by flow and stereo. A subclass sets
    ``output`` (the result's key) and ``channels`` (the estimate's) and
    gives ``volume`` (the pyramid of the two frames' NCHW features at the
    level, through ``corr_proj``), ``grid`` and ``lookup``. ``corr_proj``,
    ``context_proj`` and ``update`` are the reference's parameters of those
    names."""

    output = ""
    channels = 0
    spatial = None

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 level: int = 3, fdim: int = 128, hdim: int = 96,
                 cdim: int = 64, corr_levels: int = 4, radius: int = 4,
                 iters: int = 12, lookup_impl: str = "onehot"):
        super().__init__()
        _check_impl(lookup_impl, "lookup")
        self.level, self.hdim = level, hdim
        self.corr_levels, self.radius, self.iters = corr_levels, radius, iters
        self.lookup_impl = lookup_impl
        feat = encoder_channels[level - 1]
        self.corr_proj = _conv(feat, fdim, 1)
        self.context_proj = _conv(feat, hdim + cdim, 3, FlaxConv2d)
        self.update = UpdateBlock(hdim, cdim, self.corr_channels(),
                                  2**level, self.channels)

    def corr_channels(self) -> int:
        raise NotImplementedError

    def volume(self, f1, f2):
        raise NotImplementedError

    def project(self, f):
        """``corr_proj`` of NCHW features, NHWC."""
        return nhwc(self.corr_proj(f))

    def grid(self, b: int, h: int, w: int, device):
        raise NotImplementedError

    def lookup(self, pyramid, grid, field):
        raise NotImplementedError

    def forward(self, feats1, feats2):
        """Two pyramids (lists of NCHW maps, levels 1..6) -> {output: (B, H,
        W, C) float32 at full resolution, output + "_pyramid": {level: (B,
        h, w, C) float32}, output + "_iterates": (iters, B, h, w, C)
        float32}."""
        f1 = feats1[self.level - 1]
        pyramid = self.volume(f1, feats2[self.level - 1])
        ctx = band_conv(self.context_proj, f1, self.spatial)
        hidden = tanh(ctx[:, :self.hdim])
        context = torch.relu(ctx[:, self.hdim:])
        b, _, h, w = f1.shape
        grid = self.grid(b, h, w, f1.device)
        field = torch.zeros((b, h, w, self.channels), dtype=torch.float32,
                            device=f1.device)
        fields = []
        for _ in range(self.iters):
            corr_feat = self.lookup(pyramid, grid, field)
            hidden, delta, mask = self.update(hidden, corr_feat, field,
                                              context)
            field = field + delta
            fields.append(field)
        up = convex_upsample(field, nhwc(mask), 2**self.level, self.spatial)
        return {self.output: up, f"{self.output}_pyramid": {self.level: field},
                f"{self.output}_iterates": torch.stack(fields)}


class RAFTFlowDecoder(RAFTDecoder):
    """All-pairs 2-D volume of (f1, f2); emits flow (u, v), sampling at
    grid + flow."""

    output = "flow"
    channels = 2

    def corr_channels(self):
        return self.corr_levels * (2 * self.radius + 1) ** 2

    def volume(self, f1, f2):
        if self.spatial is not None:  # the whole frame of f2
            f2 = nchw(gather_rows(nhwc(f2), self.spatial, dim=1))
        return correlation_pyramid(
            allpairs_correlation(self.project(f1), self.project(f2)),
            self.corr_levels)

    def grid(self, b, h, w, device):
        row0 = 0 if self.spatial is None else self.spatial.band_start(h)
        return base_grid(b, h, w, device, row0)

    def lookup(self, pyramid, grid, field):
        return corr_lookup(pyramid, grid + field, self.radius,
                           impl=self.lookup_impl)


class RAFTStereoDecoder(RAFTDecoder):
    """Per-row all-pairs 1-D volume of (left, right); emits the left
    image's disparity, sampling the right image at x - d."""

    output = "disp"
    channels = 1

    def corr_channels(self):
        return self.corr_levels * (2 * self.radius + 1)

    def volume(self, f1, f2):
        # each row against its own row: a band's rows need no other band's
        return correlation_pyramid_1d(
            allpairs_correlation_1d(self.project(f1), self.project(f2)),
            self.corr_levels)

    def grid(self, b, h, w, device):
        return base_grid(b, h, w, device)[..., 0]

    def lookup(self, pyramid, grid, field):
        return corr_lookup_1d(pyramid, grid - field[..., 0], self.radius,
                              impl=self.lookup_impl)


# -------------------------------------------------------------- models


class RAFTFlowNet(nn.Module):
    """Encoder + RAFT flow decoder (single task). ``encoder`` and ``flow``
    are the reference's ``PyramidEncoder_0`` and ``RAFTFlowDecoder_0``;
    ``decoder`` holds ``RAFTDecoder``'s keywords."""

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 dtype: torch.dtype = torch.float32, **decoder):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.flow = RAFTFlowDecoder(encoder_channels, **decoder)
        self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, im1, im2):
        """(B,H,W,3) x2 -> {"flow", "flow_pyramid", "flow_iterates"}."""
        return self.flow(*self.encoder.encode(im1, im2))


class RAFTStereoNet(nn.Module):
    """Encoder + RAFT-Stereo decoder (single task). ``encoder`` and
    ``disparity`` are the reference's ``PyramidEncoder_0`` and
    ``RAFTStereoDecoder_0``."""

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 dtype: torch.dtype = torch.float32, **decoder):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.disparity = RAFTStereoDecoder(encoder_channels, **decoder)
        self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, left, right):
        """(B,H,W,3) x2 -> {"disp", "disp_pyramid", "disp_iterates"}."""
        return self.disparity(*self.encoder.encode(left, right))


class CerberusRAFT(nn.Module):
    """The joint three-head model on the iterative decoders: one shared
    encoder, RAFT flow (left, temporal), RAFT-Stereo (left, right) and the
    segmentation head of ``seg_head`` (left). ``encoder``, ``flow``,
    ``disparity`` and ``segmentation`` are the reference's
    ``PyramidEncoder_0``, ``RAFTFlowDecoder_0``, ``RAFTStereoDecoder_0`` and
    ``SegmentationHead_0`` (or ``ASPPSegmentationHead_0``); the
    segmentation classifier stays float32. ``decoder`` holds the keywords both decoders take."""

    def __init__(self, encoder_channels: Sequence[int] = ENCODER_CHANNELS,
                 num_classes: int = 19, fpn_channels: int = 96,
                 seg_head: str = "fpn", dtype: torch.dtype = torch.float32,
                 **decoder):
        super().__init__()
        self.encoder = PyramidEncoder(encoder_channels)
        self.flow = RAFTFlowDecoder(encoder_channels, **decoder)
        self.disparity = RAFTStereoDecoder(encoder_channels, **decoder)
        self.segmentation = make_seg_head(seg_head, encoder_channels,
                                          num_classes, fpn_channels)
        self.to(dtype=dtype, memory_format=torch.channels_last)
        self.segmentation.classifier.float()

    def forward(self, left, right, temporal):
        """left/right/temporal: (B, H, W, 3) frames. Returns a dict:
          seg_logits     (B, H, W, classes) float32
          flow, disp     (B, H, W, 2), (B, H, W, 1) float32
          flow_pyramid, disp_pyramid    {level: (B, h, w, C)} float32
          flow_iterates, disp_iterates  (iters, B, h, w, C) float32
        """
        f_left, f_right, f_temporal = self.encoder.encode(left, right,
                                                          temporal)
        flow = self.flow(f_left, f_temporal)
        disp = self.disparity(f_left, f_right)
        seg = self.segmentation(f_left, left.shape[1:3])
        return {"seg_logits": nhwc(seg), **flow, **disp}
