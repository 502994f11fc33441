"""The hand-written kernels as PyTorch operators, namespace ``cerberus``.

Each operator runs one kernel wrapper of ``ops/cuda/correlation.py`` or
``ops/cuda/encoder_level.py``:

  cerberus::corr2d_fwd(f1, f2, max_disp, dilation)      K1, K7 (dilated)
  cerberus::corr2d_bwd_f1(g, f2, max_disp, dilation)    K2
  cerberus::corr2d_bwd_f2(g, f1, max_disp, dilation)    K3
  cerberus::corr1d_fwd(f1, f2, max_disp, dilation)      K4, K8 (dilated)
  cerberus::corr1d_bwd_f1(g, f2, max_disp, dilation)    K5
  cerberus::corr1d_bwd_f2(g, f1, max_disp, dilation)    K6
  cerberus::encoder_level_fwd(x, k1, b1, k2, b2, k3, b3, grad)        K9
  cerberus::encoder_level_bwd(x, y3, g, k1, b1, k2, b2, k3, b3,
                              need_dx) -> (dx, dk1, db1, dk2, db2, dk3, db3)
                                                                       K10

Every operator has a fake implementation, which gives the output's shape
and type from the inputs' and touches no device, so ``torch.export`` and
fake-tensor tracing pass through the kernels: an exported program holds
the operators, and calling it launches the kernels, which count their
launches in their wrappers as an eager call does. The forwards carry
their gradients (``register_autograd``): the correlations' are the
backward operators; the level's is K10 with ``grad="pallas"``, or the
plain level recomputed and differentiated with ``grad="xla"``. The
implementations look the wrappers up in their modules at each call, so a
wrapper replaced there (a check that holds a kernel to its plain version,
a control that zeroes it) is the one that runs.

The operators take any device; a wrapper refuses a tensor that is not on
a CUDA device. ``ops/correlation.py`` and ``ops/encoder_level.py`` send a
CPU tensor to their plain versions instead. A process that loads an
exported program imports this module (which imports no model code) before
calling it.
"""

from __future__ import annotations

import torch
from torch import Tensor

from cerberusnet_torch.ops.cuda import correlation as cuda_correlation
from cerberusnet_torch.ops.cuda import encoder_level as cuda_level

LEVEL_GRADS = ("xla", "pallas")


# ---------------------------------------------------------- correlations


def _corr_channels(kind: str, max_disp: int) -> int:
    return (2 * max_disp + 1) ** 2 if kind == "2d" else max_disp + 1


def _define_correlation(kind: str):
    """The forward and two backward operators of the ``kind`` ("2d" or
    "1d") correlation, the forward's gradient wired to the backwards."""
    fwd_name, bwd1_name, bwd2_name = (f"corr{kind}_fwd", f"corr{kind}_bwd_f1",
                                      f"corr{kind}_bwd_f2")

    @torch.library.custom_op(f"cerberus::{fwd_name}", mutates_args=())
    def fwd(f1: Tensor, f2: Tensor, max_disp: int, dilation: int) -> Tensor:
        return getattr(cuda_correlation, fwd_name)(
            f1.contiguous(), f2.contiguous(), max_disp, dilation)

    @fwd.register_fake
    def _(f1, f2, max_disp, dilation):
        return f1.new_empty((*f1.shape[:3], _corr_channels(kind, max_disp)))

    def backward_op(name):
        @torch.library.custom_op(f"cerberus::{name}", mutates_args=())
        def bwd(g: Tensor, f: Tensor, max_disp: int, dilation: int) -> Tensor:
            return getattr(cuda_correlation, name)(
                g.contiguous(), f.contiguous(), max_disp, dilation)

        @bwd.register_fake
        def _(g, f, max_disp, dilation):
            return torch.empty_like(f, memory_format=torch.contiguous_format)

        return bwd

    bwd_f1, bwd_f2 = backward_op(bwd1_name), backward_op(bwd2_name)

    def setup_context(ctx, inputs, output):
        f1, f2, ctx.max_disp, ctx.dilation = inputs
        ctx.save_for_backward(f1, f2)

    def backward(ctx, g):
        """(df1, df2) from the backward kernels; a gradient nobody needs is
        not computed."""
        f1, f2 = ctx.saved_tensors
        df1 = df2 = None
        if ctx.needs_input_grad[0]:
            df1 = bwd_f1(g, f2, ctx.max_disp, ctx.dilation)
        if ctx.needs_input_grad[1]:
            df2 = bwd_f2(g, f1, ctx.max_disp, ctx.dilation)
        return df1, df2, None, None

    fwd.register_autograd(backward, setup_context=setup_context)
    return fwd, bwd_f1, bwd_f2


corr2d_fwd, corr2d_bwd_f1, corr2d_bwd_f2 = _define_correlation("2d")
corr1d_fwd, corr1d_bwd_f1, corr1d_bwd_f2 = _define_correlation("1d")


# ------------------------------------------------------ encoder level


@torch.library.custom_op("cerberus::encoder_level_fwd", mutates_args=())
def encoder_level_fwd(x: Tensor, k1: Tensor, b1: Tensor, k2: Tensor,
                      b2: Tensor, k3: Tensor, b3: Tensor,
                      grad: str) -> Tensor:
    """One fused level, NHWC x and HWIO kernels of x's type; ``grad`` picks
    its backward (``LEVEL_GRADS``)."""
    return cuda_level.level_fwd(
        *(t.contiguous() for t in (x, k1, b1, k2, b2, k3, b3)))


@encoder_level_fwd.register_fake
def _(x, k1, b1, k2, b2, k3, b3, grad):
    b, h, w, _ = x.shape
    return x.new_empty((b, h // 2, w // 2, k1.shape[-1]))


@torch.library.custom_op("cerberus::encoder_level_bwd", mutates_args=())
def encoder_level_bwd(
        x: Tensor, y3: Tensor, g: Tensor, k1: Tensor, b1: Tensor, k2: Tensor,
        b2: Tensor, k3: Tensor, b3: Tensor, need_dx: bool,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The level's reverse sweep: dx in x's type (an empty tensor unless
    ``need_dx``) and the kernels' and biases' gradients in float32."""
    dx, *grads = cuda_level.level_bwd(
        *(t.contiguous() for t in (x, y3, g, k1, b1, k2, b2, k3, b3)),
        need_dx=need_dx)
    # an operator's outputs may not share storage: the tensor-core sweep's
    # gradients are views of one sum
    grads = [t.clone() if t._base is not None else t for t in grads]
    return (x.new_empty(0) if dx is None else dx, *grads)


@encoder_level_bwd.register_fake
def _(x, y3, g, k1, b1, k2, b2, k3, b3, need_dx):
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    return (dx if need_dx else x.new_empty(0),
            *(torch.empty(t.shape, dtype=torch.float32, device=t.device)
              for t in (k1, b1, k2, b2, k3, b3)))


def _level_setup(ctx, inputs, output):
    x, k1, b1, k2, b2, k3, b3, ctx.grad = inputs
    ctx.save_for_backward(x, k1, b1, k2, b2, k3, b3,
                          *((output,) if ctx.grad == "pallas" else ()))


def _level_backward(ctx, g):
    x, *params = ctx.saved_tensors
    if ctx.grad == "pallas":
        *params, y3 = params
        need_dx = ctx.needs_input_grad[0]
        dx, *grads = encoder_level_bwd(x, y3, g.to(x.dtype), *params, need_dx)
        grads = [dx if need_dx else None, *grads]
    else:
        from cerberusnet_torch.ops.encoder_level import (
            encoder_level_bwd_plain,
        )
        grads = encoder_level_bwd_plain(x, None, g, *params)
    grads = [None if d is None else d.to(t.dtype)
             for d, t in zip(grads, (x, *params))]
    return (*grads, None)


encoder_level_fwd.register_autograd(_level_backward,
                                    setup_context=_level_setup)
