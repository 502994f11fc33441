"""Post-training int8 quantization (PTQ): port of
``cerberusnet_tpu/quant/ptq.py``, the counterpart of the reference's
TensorRT int8 engine build.

The scheme is the reference's (TensorRT's default):
  * weights: per-output-channel symmetric int8 from the float32 kernels,
    ``scale_w = max(absmax_k, 1e-12) / 127``;
  * activations: per-tensor symmetric int8, ``in_scale = max(absmax,
    1e-12) / 127``, the absmax gathered by running calibration batches
    through the model;
  * only ``nn.Conv2d`` layers quantize. Transposed convolutions,
    correlations, warps and resizes stay in the compute type.

The three phases, with the model's own modules (no model change):

  1. ``calibrate(model, batches)`` -> ``{conv name: input absmax}``: the
     batches run through the unmodified model with a hook on every
     ``nn.Conv2d`` that takes its input's absmax, max-reduced over calls
     and batches. A conv's name is its qualified module name
     (``weights.flax_conv_paths`` maps it to the reference's flax path).
  2. ``quantize(model, scales)`` adds the reference's ``quant`` entries to
     each calibrated conv in place, as buffers: ``kernel_q`` (int8, OIHW),
     ``scale_w`` (O,) and ``in_scale`` (), all from float32. ``strip``
     replaces the quantized convs' float weights by empty tensors (of the
     same type), freeing their memory; such a model runs only through
     ``quantized_apply``.
  3. ``quant_interception(model)`` is a context manager under which each
     conv with ``quant`` entries runs int8 (``_int8_conv``);
     ``quantized_apply(model, *inputs)`` calls the model under it. Export
     the quantized model under it like any other forward
     (``export/aot.py``).

An int8 conv: the input is quantized, x_q = clip(round(x / s_x), -127,
127), the product runs int8 x int8 -> int32, and the epilogue is acc *
(s_x * s_w) + bias in float32, cast to the type the conv computes in, its
input's (the segmentation classifier's is float32; a RAFT model's tied
float32 convs compute in the model's type). ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the int8 weights and a conv's int32 sums
equal the reference's. The reference runs the product through XLA's convolution
with an int32 result; here it is im2col (the taps of the zero-padded NHWC
input side by side, in the kernel's (ky, kx, c) order) and
``torch._int_mm`` (cuBLASLt on the tensor cores on a GPU). ``_int_mm``
asks on a GPU for more than 16 rows and for a reduction and a width that
are multiples of 8, so the stem's 27 taps, the flow head's 2 outputs, the
disparity head's 1 and the classifier's 19 are padded with zeros.
``simulate=True`` is its plain version: the same quantization and
epilogue around a float32 convolution.

Convs quantize only with zero padding given as numbers and one group
(``_unsupported_conv_attrs``); any other falls back to its float forward.
The port pads explicitly (``models/common.py``), where the reference
passes "SAME": both are zero padding, and quantize.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

QMAX = 127.0


# ---------------------------------------------------------------------------
# phase 1: calibration
# ---------------------------------------------------------------------------


def _convs(model: nn.Module):
    """(qualified name, module) of every nn.Conv2d of ``model``."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, nn.Conv2d)]


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[tuple]) -> dict:
    """Runs each batch as ``model(*batch)``; returns ``{conv name: input
    absmax}`` (floats), max-reduced over calls and batches."""
    absmax: dict = {}

    def hook(name):
        def take(module, args):
            a = args[0].detach().float().abs().amax()
            absmax[name] = (torch.maximum(absmax[name], a) if name in absmax
                            else a)
        return take

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in _convs(model)]
    try:
        for batch in batches:
            model(*batch)
    finally:
        for h in handles:
            h.remove()
    if not absmax:
        raise ValueError("calibration saw no nn.Conv2d calls")
    return {n: float(v) for n, v in absmax.items()}


# ---------------------------------------------------------------------------
# phase 2: weight quantization
# ---------------------------------------------------------------------------


def quantize_kernel(kernel: torch.Tensor):
    """(int8 kernel, per-output-channel scale) of an OIHW kernel, computed
    in float32."""
    kernel = kernel.detach().float()
    kmax = kernel.abs().amax(dim=(1, 2, 3))
    scale_w = torch.clamp_min(kmax, 1e-12) / QMAX
    kq = torch.clamp(torch.round(kernel / scale_w.view(-1, 1, 1, 1)),
                     -QMAX, QMAX).to(torch.int8)
    return kq, scale_w


@torch.no_grad()
def quantize(model: nn.Module, scales: dict, *, skip: Sequence[str] = (),
             strip: bool = False, weights: dict | None = None) -> nn.Module:
    """Adds the ``quant`` buffers to each conv of ``scales`` (a
    ``calibrate`` result) in place and returns ``model``.

    skip:    substrings of conv names: matching convs stay float.
    strip:   replaces each quantized conv's float weight by an empty
             tensor of its type.
    weights: {conv name: float32 OIHW kernel} to quantize in place of the
             conv's own weight (a bf16 model's float32 masters, which the
             reference quantizes).
    """
    targets = []
    for name, absmax in sorted(scales.items()):
        if any(s in name for s in skip):
            continue
        conv = model.get_submodule(name)
        if conv.weight.dim() != 4:
            continue  # only spatial convs (a stripped one has no kernel)
        targets.append((name, conv, absmax))
    if not targets:
        raise ValueError("no convs quantized (all skipped?)")
    for name, conv, absmax in targets:
        kernel = conv.weight if weights is None else weights[name]
        kq, scale_w = quantize_kernel(kernel.to(conv.weight.device))
        conv.register_buffer("kernel_q", kq)
        conv.register_buffer("scale_w", scale_w)
        conv.register_buffer("in_scale", torch.tensor(
            max(absmax, 1e-12) / QMAX, dtype=torch.float32,
            device=conv.weight.device))
        if strip:
            conv.weight = nn.Parameter(conv.weight.new_empty(0),
                                       requires_grad=False)
    return model


def quantized_convs(model: nn.Module) -> list:
    """Names of the convs of ``model`` that carry ``quant`` entries."""
    return [n for n, m in _convs(model) if hasattr(m, "kernel_q")]


# ---------------------------------------------------------------------------
# phase 3: quantized inference
# ---------------------------------------------------------------------------


def _unsupported_conv_attrs(conv: nn.Conv2d) -> list:
    """What of ``conv`` the int8 path does not carry out; such a conv runs
    its float forward."""
    reasons = []
    if conv.padding_mode != "zeros":
        reasons.append(f"padding_mode={conv.padding_mode!r}")
    if isinstance(conv.padding, str):
        reasons.append(f"padding={conv.padding!r}")
    if conv.groups != 1:
        reasons.append(f"groups={conv.groups}")
    return reasons


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def int8_conv2d(x: torch.Tensor, kq: torch.Tensor, stride, padding,
                dilation) -> torch.Tensor:
    """int32 sums of an int8 NCHW input with an int8 OIHW kernel, zero
    padding, one group: im2col and ``torch._int_mm``. Returns an NCHW view
    of NHWC-contiguous int32 sums."""
    b, c, h, w = x.shape
    o, _, kh, kw = kq.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))
    taps = [xp[:, i * dh : i * dh + sh * (ho - 1) + 1 : sh,
               j * dw : j * dw + sw * (wo - 1) + 1 : sw, :]
            for i in range(kh) for j in range(kw)]
    k = kh * kw * c
    if _ceil8(k) > k:  # the reduction's zero padding, in the same copy
        taps.append(xp.new_zeros((b, ho, wo, _ceil8(k) - k)))
    m = b * ho * wo
    cols = torch.cat(taps, dim=-1).reshape(m, _ceil8(k))
    if m <= 16:
        cols = F.pad(cols, (0, 0, 0, 17 - m))
    wm = F.pad(kq.permute(0, 2, 3, 1).reshape(o, k),
               (0, _ceil8(k) - k, 0, _ceil8(o) - o))
    acc = torch._int_mm(cols, wm.t())[:m, :o]
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def _int8_conv(conv: nn.Conv2d, x: torch.Tensor, simulate: bool = False):
    """``conv`` on ``x`` with its ``quant`` entries: int8 x int8 -> int32
    and the float32 epilogue; ``simulate=True`` runs the quantized values
    through a float32 convolution instead (the plain version)."""
    s_x, s_w = conv.in_scale, conv.scale_w
    xq = torch.clamp(torch.round(x.float() / s_x), -QMAX, QMAX)
    if simulate:
        acc = F.conv2d(xq, conv.kernel_q.float(), None, conv.stride,
                       conv.padding, conv.dilation)
    else:
        acc = int8_conv2d(xq.to(torch.int8), conv.kernel_q, conv.stride,
                          conv.padding, conv.dilation).float()
    out = acc * (s_x * s_w).view(1, -1, 1, 1)
    if conv.bias is not None:
        out = out + conv.bias.float().view(1, -1, 1, 1)
    return out.to(x.dtype)


@contextlib.contextmanager
def quant_interception(model: nn.Module, simulate: bool = False):
    """Within the block, every conv of ``model`` with ``quant`` entries
    runs int8 (``simulate``: its plain version); the others run as they
    are. Exporting or calling the model under it bakes in the int8
    graph."""
    swapped = []
    for _, conv in _convs(model):
        if hasattr(conv, "kernel_q") and not _unsupported_conv_attrs(conv):
            conv.forward = (lambda x, conv=conv:
                            _int8_conv(conv, x, simulate))
            swapped.append(conv)
    try:
        yield model
    finally:
        for conv in swapped:
            del conv.forward


def quantized_apply(model: nn.Module, *inputs, simulate: bool = False,
                    **kwargs):
    """``model(*inputs)`` with its quantized convs running int8."""
    with quant_interception(model, simulate):
        return model(*inputs, **kwargs)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def flat_outputs(out, prefix: str = "") -> dict:
    """An output dict (pyramids nested by level) as {"a/b": tensor}."""
    if not isinstance(out, dict):
        return {prefix or "out": out}
    flat = {}
    for k, v in out.items():
        flat.update(flat_outputs(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else {f"{prefix}{k}": v})
    return flat


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref|| in float64."""
    a, ref = a.double(), ref.double()
    return float(torch.linalg.vector_norm(a - ref)
                 / (torch.linalg.vector_norm(ref) + 1e-12))


@torch.no_grad()
def quantization_error(model: nn.Module, qmodel: nn.Module, batch: tuple, *,
                       simulate: bool = False,
                       reduce_fn: Callable | None = None):
    """Per-output relative L2 error of ``qmodel`` (``model`` quantized)
    against ``model`` on one batch."""
    ref = flat_outputs(model(*batch))
    got = flat_outputs(quantized_apply(qmodel, *batch, simulate=simulate))
    errs = {k: rel_l2(got[k], ref[k]) for k in ref}
    return reduce_fn(errs) if reduce_fn else errs
