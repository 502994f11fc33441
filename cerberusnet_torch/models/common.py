"""Shared model building blocks, port of ``cerberusnet_tpu/models/common.py``.

Modules take and return NCHW tensors; the model keeps them in
``torch.channels_last``, so the NHWC view the correlation kernels read costs
nothing. LeakyReLU(0.1) follows every conv block, as in the reference.

The spatial mesh axis (``parallel/mesh.py``): ``set_spatial(model, mesh)``
gives every module of a model that reads across image rows (its class has
a ``spatial`` attribute) the mesh that splits the rows into bands, one a
rank. Such a module then runs on its band with the rows it reads across
taken from the neighbouring bands (``parallel/halo.py``): a convolution's
H padding becomes a halo of as many rows, zeros at the frame's top and
bottom (``band_conv``, and the stride-2 block's row below), and a bilinear
resize keeps its band of the frame's output, reading the rows it needs
edge-filled (``upsample2x``, ``upsample_to``; one row each side at an
integer ratio) and rounding as the frame's resize rounds. Without a mesh
(``spatial`` None, one process) every module runs its own padding, as
before the axis existed.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cerberusnet_torch.parallel.halo import halo_rows


# LeakyReLU's slope as the reference multiplies a bf16 input by it, 0.1
# rounded to bf16 (flax's ``negative_slope * x``; with float32's 0.1 about
# a tenth of a bf16 block's outputs differed)
BF16_SLOPE = float(torch.tensor(0.1, dtype=torch.bfloat16))


def leaky(x):
    return F.leaky_relu(x, BF16_SLOPE if x.dtype == torch.bfloat16 else 0.1)


class _Sigmoid(torch.autograd.Function):
    """flax's ``nn.sigmoid`` in a type narrower than float32, as XLA
    computes it there: 1 / (1 + exp(-x)), each op rounded to the type; its
    backward g (y (1 - y)), each product rounded (``torch.sigmoid`` rounds
    once: 29-41% of the GRU gates' bf16 outputs differed from flax's,
    ``scripts/raft_bf16_op_compare.py``)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


class _Tanh(torch.autograd.Function):
    """``torch.tanh`` (whose bf16 outputs are flax's) with the backward XLA
    computes for ``jnp.tanh``: a = g (1 - y), then a + a y, each op rounded
    to the type (autograd's ``tanh_backward`` rounds once)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        a = g * (1.0 - y)
        return a + a * y


def sigmoid(x):
    """The logistic function, rounding as flax's ``nn.sigmoid`` forward and
    backward (``_Sigmoid``); in float32 and float64 ``torch.sigmoid``."""
    return torch.sigmoid(x) if x.dtype.itemsize >= 4 else _Sigmoid.apply(x)


def tanh(x):
    """tanh, rounding as ``jnp.tanh`` forward and backward (``_Tanh``); in
    float32 and float64 ``torch.tanh``."""
    return torch.tanh(x) if x.dtype.itemsize >= 4 else _Tanh.apply(x)


def set_spatial(model: nn.Module, mesh) -> nn.Module:
    """Gives every module of ``model`` that reads across rows the mesh
    ``mesh`` when it splits rows over more than one rank, else None (each
    module's own padding). Returns the model."""
    band = mesh if mesh is not None and mesh.banded else None
    for m in model.modules():
        if hasattr(type(m), "spatial"):
            m.spatial = band
    return model


def _band_resize(x, rows: int, width: int, spatial, factor: int = 0,
                 heights: tuple = (), impl: str = "resize"):
    """Bilinear resize of a band of ``x`` to ``width`` columns and
    ``rows`` rows, the whole frame's resize cut to this rank's band.

    ``factor`` f, or a frame f times as tall as ``x``'s whose every band is
    f times the peer's at ``x``'s level: the band with one edge-filled row
    each side, resized to f times as many rows, keeps the f rows of each of
    its own (``heights``: the peers' bands of ``x``'s map, by default its
    level's). Else ``rows`` is this rank's band at another level of the
    frame, and output row j samples (j + 0.5) h / h' - 0.5 of the frame's h
    rows (h' the target frame's; clamped at its edges, as ``F.interpolate``
    and ``jax.image.resize`` upsample): the rows it reads come through
    ``halo_rows`` ("edge"), weighed by the frame's scale in float32
    (float64 for a float64 ``x``), which the result is rounded from once.
    In a narrower type the band rounds as ``_resize`` rounds the frame:
    each axis contracted alone and rounded, in the frame's order
    (``_band_rows``). ``impl="phase"`` (f = 2): the reference's
    ``upsample2x_phase`` on the band, H then W, in every type."""
    hb = x.shape[2]
    src = tuple(heights) or spatial.band_heights(hb)
    dst = (tuple(factor * b for b in src) if factor
           else spatial.band_heights(rows))
    hs, hd = sum(src), sum(dst)
    s0 = sum(src[:spatial.spatial_rank])
    # every peer's band f times its own, or every peer the general way
    if not factor and all(b * hs == a * hd for a, b in zip(src, dst)) \
            and hd % hs == 0:
        factor = hd // hs
    if impl == "phase":
        y = _up2_phase(halo_rows(x, 1, 1, spatial, "edge", heights=src), 2)
        return _layout_of(_up2_phase(y.narrow(2, 2, rows), 3), x)
    if x.dtype.itemsize < 4:
        w, ww = x.shape[3], width
        if hs * w * hd + hd * w * ww <= hs * w * ww + hs * hd * ww:
            y = _resize_axis(_band_rows(x, src, dst, spatial), 3, ww)
        else:
            y = _band_rows(x, src, dst, spatial, ww)
        return _layout_of(y, x)
    if factor:
        return _interpolate_rows(
            halo_rows(x, 1, 1, spatial, "edge", heights=src), factor, width)

    def source(j):  # the frame row output row j reads first
        return max(math.floor((j + 0.5) * (hs / hd) - 0.5), 0)

    top, bottom = _halo_extent(src, dst, spatial, lambda b, n: (
        source(b), min(source(b + n - 1) + 1, hs - 1)))
    d0 = sum(dst[:spatial.spatial_rank])
    pos = torch.arange(d0, d0 + rows, dtype=torch.float64)
    pos = ((pos + 0.5) * (hs / hd) - 0.5).clamp_min(0.0)
    lo = pos.floor().long()
    hi = (lo + 1).clamp_max(hs - 1)
    work = torch.promote_types(x.dtype, torch.float32)
    y = halo_rows(x, top, bottom, spatial, "edge").to(work)
    lam = (pos - lo).to(device=x.device, dtype=work)[:, None]
    lo, hi = ((i - s0 + top).to(x.device) for i in (lo, hi))
    y = (y.index_select(2, lo) * (1.0 - lam) + y.index_select(2, hi) * lam)
    y = F.interpolate(y, size=(rows, width), mode="bilinear",
                      align_corners=False).to(x.dtype)
    return _layout_of(y, x)


def _layout_of(y, x):
    """``y`` in ``x``'s memory format (channels last or contiguous)."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y


def _interpolate_rows(y, f: int, width: int):
    """A band ``y`` with one edge-filled row of halo each side,
    interpolated to f times as many rows and ``width`` columns, f rows of
    each of its own kept: its band of the frame's resize where every band
    is f times its peer's."""
    hb = y.shape[2] - 2
    y = F.interpolate(y, size=(f * (hb + 2), width), mode="bilinear",
                      align_corners=False)
    return y.narrow(2, f, f * hb)


def _halo_extent(src: tuple, dst: tuple, spatial, reads):
    """(top, bottom): the most frame rows any peer's band of ``dst`` reads
    above and below its band of ``src`` (one halo for every peer: an
    exchange takes pieces of one shape); ``reads(b, n)`` gives the first
    and last frame rows that output rows b .. b + n - 1 read."""
    top = bottom = 0
    for r in range(spatial.spatial_size):
        a = sum(src[:r])
        first, last = reads(sum(dst[:r]), dst[r])
        top = max(top, a - first)
        bottom = max(bottom, last - (a + src[r] - 1))
    return top, bottom


def _band_rows(x, src: tuple, dst: tuple, spatial, width: int = 0):
    """This rank's band of ``_resize_axis(frame, 2, sum(dst))``, the frame
    whose peers' bands of rows are ``src`` (``x`` this rank's), cut to the
    peers' bands ``dst``: a power-of-2 factor f between every band and its
    peer's is ``_interpolate_rows``; else the frame's weights
    (``_resize_weights``) rounded to ``x``'s type, of the output rows of
    the band and the frame rows they read (those beyond the frame's edges
    weigh 0), the products summed in float32 and rounded to the type.
    ``width``: the frame resized along W to ``width`` columns first; that
    contraction is row-local, so it runs after the halo exchange, which
    moves the narrower rows."""
    hs, hd = sum(src), sum(dst)

    def along_w(y):
        return _resize_axis(y, 3, width) if width else y

    if src == dst:
        return along_w(x)
    f = hd // hs
    if all(b == f * a for a, b in zip(src, dst)) and f & (f - 1) == 0:
        y = along_w(halo_rows(x, 1, 1, spatial, "edge", heights=src))
        return _interpolate_rows(y, f, y.shape[3])
    weights = _resize_weights(hs, hd)

    def reads(b, n):
        rows = np.flatnonzero(weights[:, b:b + n].any(1))
        return int(rows[0]), int(rows[-1])

    top, bottom = _halo_extent(src, dst, spatial, reads)
    rank = spatial.spatial_rank
    first = sum(src[:rank]) - top  # the frame row of the halo's first

    def band_weights():
        n = top + src[rank] + bottom
        w = np.zeros((n, dst[rank]), np.float32)
        lo, hi = max(first, 0), min(first + n, hs)
        d0 = sum(dst[:rank])
        w[lo - first:hi - first] = weights[lo:hi, d0:d0 + dst[rank]]
        return w

    w = _device_matrix(("band", src, dst, rank), band_weights, x)
    y = along_w(halo_rows(x, top, bottom, spatial, "edge", heights=src))
    return (w.t() @ y.float()).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s linear
    kernel along one axis (its ``compute_weight_mat``, antialiased)."""
    inv = np.float32(n_in / n_out)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), 1 - dist / max(inv, np.float32(1)))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


_RESIZE_MATRICES: dict = {}


def _device_matrix(key, weights, x):
    """``weights()`` (a float32 array) rounded to ``x``'s type, as float32
    on ``x``'s device, kept by (``key``, type, device) so that a forward
    copies nothing from the host (none is kept while a tracer runs the
    forward)."""
    key = (key, x.dtype, x.device)
    w = _RESIZE_MATRICES.get(key)
    if w is None:
        with torch.inference_mode(False):
            w = torch.from_numpy(weights()).to(x.dtype).to(
                device=x.device, dtype=torch.float32)
        if type(x) is torch.Tensor and not torch.compiler.is_compiling():
            _RESIZE_MATRICES[key] = w
    return w


def _resize_matrix(n_in: int, n_out: int, x):
    """``_resize_weights`` as ``_device_matrix`` keeps it."""
    return _device_matrix((n_in, n_out),
                          lambda: _resize_weights(n_in, n_out), x)


def _resize_axis(x, dim: int, n: int):
    """``x`` resized along ``dim`` (2: H, 3: W) to ``n``, as one
    contraction of the reference's einsum in ``x``'s type: the weights
    rounded to the type, the products summed in float32, the sums rounded
    to the type. A power-of-2 ratio's weights are exact, and the
    interpolation computes the same sums."""
    m = x.shape[dim]
    if m == n:
        return x
    if n % m == 0 and (n // m) & (n // m - 1) == 0:
        size = (n, x.shape[3]) if dim == 2 else (x.shape[2], n)
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)
    w = _resize_matrix(m, n, x)
    y = x.float()
    return (y @ w if dim == 3 else w.t() @ y).to(x.dtype)


def _resize(x, hw):
    """Bilinear resize of a whole frame to ``hw``, as
    ``jax.image.resize(..., "bilinear")``: in float32 one interpolation; in
    a narrower type as the reference rounds there. Its separable einsum
    contracts one axis, rounds to the type, then the other, the axis first
    whose path costs fewer operations (H on a tie; where a map has one row
    or column the orders agree). Rounded once, the FPN head's bf16
    top-down sums differed from the reference's
    (``scripts/pwc_bf16_op_compare.py`` holds them op by op)."""
    hw = tuple(hw)
    if x.dtype.itemsize >= 4:
        return F.interpolate(x, size=hw, mode="bilinear",
                             align_corners=False)
    (h, w), (hh, ww) = x.shape[2:], hw
    if h * w * hh + hh * w * ww <= h * w * ww + h * hh * ww:
        return _resize_axis(_resize_axis(x, 2, hh), 3, ww)
    return _resize_axis(_resize_axis(x, 3, ww), 2, hh)


def _up2_phase(x, dim: int):
    """x2 along ``dim`` as the reference's ``_up2_phase_dim``: y[2q] =
    0.25 x[q-1] + 0.75 x[q], y[2q+1] = 0.75 x[q] + 0.25 x[q+1], edges
    clamped, each product and sum in ``x``'s type."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    y = torch.stack([0.25 * prev + 0.75 * x, 0.75 * x + 0.25 * nxt],
                    dim + 1)
    shape = list(x.shape)
    shape[dim] *= 2
    return y.reshape(shape)


def upsample2x(x, spatial=None, heights: tuple = (), impl: str = "resize"):
    """Bilinear x2 on the half-pixel grid with edge clamp: upsampling equal
    to ``jax.image.resize(..., "bilinear")``, rounding as it does
    (``_resize``), or with ``impl="phase"`` as the reference's
    ``upsample2x_phase`` (H, then W; in bf16 it rounds otherwise).
    ``spatial``: ``x`` is a band of that mesh, of the peers' ``heights``
    (by default its level's); the result is the band of twice its rows of
    the frame's x2, rounded as the frame's (``_band_resize``)."""
    if spatial is not None:
        return _band_resize(x, 2 * x.shape[2], 2 * x.shape[3], spatial, 2,
                            heights, impl)
    if impl == "phase":
        return _up2_phase(_up2_phase(x, 2), 3)
    return _resize(x, (2 * x.shape[2], 2 * x.shape[3]))


def upsample_to(x, hw, spatial=None):
    """Bilinear resize to ``hw`` (``_resize``; with ``spatial``: this
    rank's band of rows at a level of the frame, rounded as the frame's,
    ``_band_resize``)."""
    if spatial is not None:
        return _band_resize(x, hw[0], hw[1], spatial)
    return _resize(x, hw)


def band_conv(conv: nn.Conv2d, x, spatial=None):
    """``conv(x)``; with ``spatial``, on a band: the rows the convolution
    pads in H come from the neighbouring bands (zeros at the frame's
    borders), and the convolution's own forward (the one QAT and int8
    interception replace) runs with its H padding off for the call."""
    return band_convs((conv,), x, spatial)[0]


def band_convs(convs, x, spatial=None):
    """``[conv(x) for conv in convs]``, convolutions of one H padding; with
    ``spatial``, on a band, as ``band_conv`` does, the halo taken once for
    all of them."""
    if spatial is None:
        return [conv(x) for conv in convs]
    (ph,) = {conv.padding[0] for conv in convs}
    x = halo_rows(x, ph, ph, spatial)
    out = []
    for conv in convs:
        pw = conv.padding[1]
        conv.padding = (0, pw)
        try:
            out.append(conv(x))
        finally:
            conv.padding = (ph, pw)
    return out


def same_pads(size: int, kernel: int, stride: int):
    """(before, after) padding of XLA's "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class FlaxConv2d(nn.Conv2d):
    """``nn.Conv2d`` that rounds as the reference's ``nn.Conv`` in a type
    narrower than float32: the product is rounded to the input's type,
    then the bias added in it (two roundings; with the bias fused, which
    rounds once, 13-39% of the encoder's bf16 ConvBlock outputs and 21% of
    RAFT's ``context_proj``'s differed from flax's,
    scripts/raft_bf16_op_compare.py)."""

    def forward(self, x):
        return self.rounded_forward(x, self.weight, self.bias)

    def rounded_forward(self, x, weight, bias):
        if x.dtype.itemsize >= 4:
            return self._conv_forward(x, weight, bias)
        return self._conv_forward(x, weight, None) + bias[:, None, None]


class ConvBlock(nn.Module):
    """Conv 3x3 with "SAME" padding + LeakyReLU(0.1), the conv rounding as
    flax's (``FlaxConv2d``).

    A stride-2 block pads as XLA does, (0, 1) on an even extent and (1, 1)
    on an odd one, so it pads explicitly; a stride-1 block pads
    symmetrically inside the conv. On a band (``spatial``) the stride-2
    block's row below is the next band's first (``parallel/mesh.py``'s
    nested bands), and at an odd extent rank 0 pads the frame's zero row
    above; the stride-1 block's ``dilation`` rows each side are its
    neighbours'."""

    spatial = None

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = FlaxConv2d(in_channels, features, 3, stride=stride,
                               padding=dilation if stride == 1 else 0,
                               dilation=dilation)

    def forward(self, x):
        if self.stride == 1:
            return leaky(band_conv(self.conv, x, self.spatial))
        pw = same_pads(x.shape[3], 3, self.stride)
        sp = self.spatial
        if sp is None:
            ph = same_pads(x.shape[2], 3, self.stride)
        elif self.stride == 2:
            odd = sp.frame_rows(x.shape[2]) % 2
            x = halo_rows(x, 0, 1, sp)
            ph = (int(odd and sp.spatial_rank == 0), 0)
        else:
            raise ValueError(f"a stride-{self.stride} block on a band")
        return leaky(self.conv(F.pad(x, (*pw, *ph))))


def conv_same(x, weight, dilation: int = 1, spatial=None):
    """The stride-1 "SAME" convolution of ``x`` with the OIHW ``weight`` (an
    odd square kernel), no bias; with ``spatial``, on a band, the rows it
    pads in H from the neighbouring bands (``band_conv``'s halo)."""
    pad = dilation * (weight.shape[2] // 2)
    if spatial is None:
        return F.conv2d(x, weight, None, 1, pad, dilation)
    return F.conv2d(halo_rows(x, pad, pad, spatial), weight, None, 1,
                    (0, pad), dilation)


def conv_over_components(comps, weight, bias, dilation: int = 1,
                         spatial=None):
    """``conv_same(cat(comps), weight) + bias`` as the reference's
    ``conv_over_components`` computes it: one product a component against
    its slice of the input axis, the products summed in their type in
    component order, then the bias added."""
    acc, off = None, 0
    for c in comps:
        n = c.shape[1]
        y = conv_same(c, weight[:, off:off + n], dilation, spatial)
        acc = y if acc is None else acc + y
        off += n
    return acc + bias.view(-1, 1, 1)


def subpixel(upconv: nn.ConvTranspose2d):
    """(weight, bias) of the 3x3 stride-1 "SAME" conv whose output, put
    through ``depth_to_space``, is ``upconv``'s (4x4, stride 2, padding 1):
    the reference's ``conv_transpose_subpixel``. Per axis, output 2q reads
    inputs q - 1 and q through the transposed kernel's taps 3 and 1, output
    2q + 1 inputs q and q + 1 through taps 2 and 0; padded with a zero tap
    each side and flipped, the kernel holds phase 0's window at its odd
    taps and phase 1's at its even ones. Output channels phase-major,
    (rh, rw, c), the bias tiled."""
    w = F.pad(upconv.weight, (1, 1, 1, 1)).flip(2, 3)  # (cin, cout, 6, 6)
    phases = [w[:, :, 1 - rh::2, 1 - rw::2] for rh in (0, 1) for rw in (0, 1)]
    return (torch.cat(phases, 1).transpose(0, 1),
            upconv.bias.repeat(4))


def depth_to_space(y):
    """(B, 4C, H, W), channels phase-major (rh, rw, c) -> (B, C, 2H, 2W),
    in ``torch.channels_last`` as the models' maps are (one copy of a
    channels-last ``y``; in NCHW the next concatenation and convs would
    each copy it back)."""
    b, c4, h, w = y.shape
    c = c4 // 4
    y = y.permute(0, 2, 3, 1).reshape(b, h, w, 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)
    return y.permute(0, 3, 1, 2)


def fused_dense(inputs, convs, extras=(), spatial=None):
    """The reference's ``FusedDenseEstimator`` arithmetic. ``inputs``: the
    trunk's input components (NCHW); ``convs``: (weight, bias) of the
    trunk's 3x3 convs, conv i reading the inputs and the outputs of convs
    0..i-1; ``extras``: (weight, bias) of 3x3 convs reading all of them
    (the predictor, the subpixel up-feature conv). Each component is
    convolved once, against the output-axis concatenation of the slices of
    the convs that read it (a suffix of the convs, so their partial
    products are summed in one add a component, in their type, in
    component order); then a trunk conv adds its bias and LeakyReLU, an
    extra conv its bias. Returns (the trunk's outputs, the extra convs'
    outputs)."""
    comps = list(inputs)
    n0, n_est = len(comps), len(convs)
    convs = list(convs) + list(extras)
    # each conv's weight cut into its slices of the components it reads
    widths = [c.shape[1] for c in comps] + [w.shape[0] for w, _ in
                                            convs[:n_est]]
    slices = [torch.split(w, widths[:n0 + min(k, n_est)], dim=1)
              for k, (w, _) in enumerate(convs)]
    # acc: the partial sums of convs[held:], channel after channel
    acc, held, ys = None, 0, []
    for j in range(n0 + n_est):
        c = comps[j] if j < n0 else ys[j - n0]
        first = max(j - n0 + 1, 0)  # the first conv that reads component j
        if first == len(convs):  # the last output, with no extra to read it
            continue
        out = conv_same(c, torch.cat([s[j] for s in slices[first:]]),
                        spatial=spatial)
        if acc is not None:  # the finished convs' channels leave
            done = sum(w.shape[0] for w, _ in convs[held:first])
            out = acc[:, done:] + out
        acc, held = out, first
        if n0 - 1 <= j < n0 - 1 + n_est:  # conv j - n0 + 1 has all it reads
            weight, bias = convs[j - n0 + 1]
            ys.append(leaky(acc[:, :weight.shape[0]] + bias.view(-1, 1, 1)))
    outs, at = [], sum(w.shape[0] for w, _ in convs[held:n_est])
    for weight, bias in convs[n_est:]:
        outs.append(acc[:, at:at + weight.shape[0]] + bias.view(-1, 1, 1))
        at += weight.shape[0]
    return ys, outs


class DenseEstimator(nn.Module):
    """DenseNet trunk: each conv block sees the concatenation of the input
    and every earlier block's output; the final stack is the input of the
    caller's predictor (``extras``), context network and up-feature conv.

    ``fused=True`` computes it as the reference's default
    ``FusedDenseEstimator`` does (``fused_dense``): the bf16 products of
    each component summed in bf16, which rounds otherwise than one conv
    over the concatenation. ``fused=False`` is the reference's
    ``DenseEstimator`` and its predictor ``nn.Conv``, each block and the
    predictor one conv over the concatenated stack, rounding as flax's
    (``FlaxConv2d``). The parameters are the same either way."""

    spatial = None

    def __init__(self, in_channels: int,
                 channels: Sequence[int] = (128, 128, 96, 64, 32),
                 fused: bool = True):
        super().__init__()
        self.fused = fused
        self.blocks = nn.ModuleList()
        cin = in_channels
        for ch in channels:
            self.blocks.append(ConvBlock(cin, ch))
            cin += ch
        self.out_channels = cin

    def forward(self, x, extras=(), concat_stack: bool = True):
        """``x``: the input, one tensor or a list of components of its
        channels; ``extras``: 3x3 convs over the final stack (modules or
        (weight, bias) pairs, the product then the bias). Returns (the stack,
        concatenated or, with ``concat_stack=False`` in the fused form, a
        list of its components; the extra convs' outputs)."""
        comps = list(x) if isinstance(x, (list, tuple)) else [x]
        if self.fused:
            ys, outs = fused_dense(
                comps, [(b.conv.weight, b.conv.bias) for b in self.blocks],
                [(e.weight, e.bias) if isinstance(e, nn.Module) else e
                 for e in extras], self.spatial)
            comps += ys
            return (torch.cat(comps, dim=1) if concat_stack else comps), outs
        x = torch.cat(comps, dim=1) if len(comps) > 1 else comps[0]
        for block in self.blocks:
            x = torch.cat([x, block(x)], dim=1)
        return x, [band_conv(e, x, self.spatial) if isinstance(e, nn.Module)
                   else conv_over_components([x], *e, spatial=self.spatial)
                   for e in extras]


class ContextNetwork(nn.Module):
    """Dilated refinement: conv blocks with the given dilations, then a
    plain 3x3 conv to ``out_channels``, rounding as flax's. The input may
    be a list of components of the stack's channels (the fused estimator's
    with ``distribute_outputs``): the first conv is then the reference's
    ``conv_over_components``, a product a component summed in their type,
    then the bias and LeakyReLU."""

    spatial = None

    def __init__(self, in_channels: int, out_channels: int = 2,
                 channels: Sequence[int] = (128, 128, 128, 96, 64, 32),
                 dilations: Sequence[int] = (1, 2, 4, 8, 16, 1)):
        super().__init__()
        self.blocks = nn.ModuleList()
        cin = in_channels
        for ch, dil in zip(channels, dilations):
            self.blocks.append(ConvBlock(cin, ch, dilation=dil))
            cin = ch
        self.out = FlaxConv2d(cin, out_channels, 3, padding=1)

    def first(self, x):
        """The first block's output, of a tensor or a list of components."""
        if not isinstance(x, (list, tuple)):
            return self.blocks[0](x)
        conv = self.blocks[0].conv
        return leaky(conv_over_components(x, conv.weight, conv.bias,
                                          conv.dilation[0], self.spatial))

    def forward(self, x):
        x = self.first(x)
        for block in self.blocks[1:]:
            x = block(x)
        return band_conv(self.out, x, self.spatial)


def nhwc(x):
    """NHWC tensor of an NCHW one: a free view of a channels_last tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x):
    """NCHW view of an NHWC-contiguous tensor, in channels_last."""
    return x.permute(0, 3, 1, 2)
