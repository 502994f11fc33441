"""One fused pyramid-encoder level: port of
``cerberusnet_tpu/ops/pallas/encoder_level.py``.

A level is a stride-2 3x3 SAME conv (on an even extent it pads (0, 1):
output p reads input rows 2p..2p+2) and two stride-1 3x3 SAME convs, each
followed by LeakyReLU(0.1). As in the reference, x is NHWC (B, H, W, C),
the kernels HWIO (3, 3, C, F) and (3, 3, F, F), the biases (F,), and the
output NHWC (B, H/2, W/2, F); the kernels and biases are cast to x's type.

Dispatch: ``encoder_level`` takes the plain version below for a CPU tensor,
and autograd differentiates it. For a CUDA tensor it goes through the
operator ``cerberus::encoder_level_fwd`` (``ops/library.py``), whose
forward is the hand-written kernel K9 (``ops/cuda/encoder_level.py``), or
the call raises. Its backward is the reverse-sweep kernel K10
(``cerberus::encoder_level_bwd``) with ``grad="pallas"``; with ``grad="xla"`` it
recomputes the level with the plain convs and differentiates them, as the
reference's ``_enc_bwd`` does. The two gradients are the same math.

The reference falls back from its reverse-sweep kernel to that recompute
wherever the kernel would not fit the TPU's 16 MB of VMEM
(``_bwd_fits_vmem``); at the train shape of a 512x1024 step it does so at
level 1 (W/4 = 256 column groups, 4C = 12 lanes, batch 6). That is a limit
of the TPU, with the same math either way: the port runs K10 at every
level and batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cerberusnet_torch.ops import library

GRADS = library.LEVEL_GRADS


def _conv_block(x, k, b, stride: int):
    """leaky(SAME conv(x) + b) on NCHW x with an HWIO kernel."""
    if stride == 2:
        x = F.pad(x, (0, 1, 0, 1))  # SAME, stride 2, even extent
    y = F.conv2d(x, k.permute(3, 2, 0, 1).to(x.dtype), b.to(x.dtype),
                 stride=stride, padding=0 if stride == 2 else 1)
    return F.leaky_relu(y, 0.1)


def encoder_level_plain(x, k1, b1, k2, b2, k3, b3):
    """The level as three plain convolutions (``encoder_level_xla``)."""
    y = x.permute(0, 3, 1, 2)
    y = _conv_block(y, k1, b1, 2)
    y = _conv_block(y, k2, b2, 1)
    y = _conv_block(y, k3, b3, 1)
    return y.permute(0, 2, 3, 1).contiguous()


def encoder_level_bwd_plain(x, y3, g, k1, b1, k2, b2, k3, b3):
    """(dx, dk1, db1, dk2, db2, dk3, db3) of the level for the output's
    gradient g: the plain level recomputed and differentiated. ``y3`` (the
    level's output, which the reverse-sweep kernel reads for its last mask)
    is not needed here. Each gradient has its input's type."""
    del y3
    # torch.func rather than autograd: it also differentiates inside an
    # operator's implementation, below autograd
    y, vjp = torch.func.vjp(encoder_level_plain, x, k1, b1, k2, b2, k3, b3)
    return vjp(g.to(y.dtype))


def _takes_plain(x) -> bool:
    """A CPU tensor takes the plain level (``utils/flops.py``'s
    ``plain_operators`` routes it through the operator instead)."""
    return x.device.type == "cpu"


def encoder_level(x, k1, b1, k2, b2, k3, b3, *, grad: str = "xla"):
    """One pyramid level, (B,H,W,C) -> (B,H/2,W/2,F); needs H%2==0 and
    W%4==0, as the reference does."""
    if grad not in GRADS:
        raise ValueError(f"unknown grad {grad!r}; expected one of {GRADS}")
    if x.shape[1] % 2 or x.shape[2] % 4:
        raise ValueError(f"encoder level needs H%2==0, W%4==0: "
                         f"{tuple(x.shape)}")
    if _takes_plain(x):
        return encoder_level_plain(x, k1, b1, k2, b2, k3, b3)
    # the casts and copies stay outside the operator, so autograd carries
    # the gradients back through them
    params = [t.to(x.dtype).contiguous() for t in (k1, b1, k2, b2, k3, b3)]
    return library.encoder_level_fwd(x.contiguous(), *params, grad)
