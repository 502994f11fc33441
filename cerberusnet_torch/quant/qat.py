"""Quantization-aware training (QAT): port of
``cerberusnet_tpu/quant/qat.py``, int8 fake quantization with
straight-through estimators on the convs that PTQ quantizes
(``ptq._unsupported_conv_attrs`` applies as it is).

  * weights: per-output-channel symmetric fake quantization with the scale
    taken from the live kernel at each call and detached; the gradient
    passes straight through the round (STE);
  * activations: per-tensor symmetric fake quantization against a fixed
    absmax (the EMA of a conv's input ranges, seeded from
    ``ptq.calibrate``) or, for a conv with no seed, the live absmax,
    detached. Every call also records the absmax it observed, for
    ``update_ema``.

The ranges are a dict {conv name: float32 absmax tensor} (the reference's
``quant_ema`` collection). A loop::

    ema = qat.init_ema(ptq.calibrate(model, batches))
    for batch in data:
        out, observed = qat.qat_apply(model, ema, *inputs)
        ... loss, backward, optimizer step ...
        ema = qat.update_ema(ema, observed)
    qat.finalize(model, ema)                   # -> the ptq quant entries
    out = ptq.quantized_apply(model, *inputs)  # the int8 path

The fake-quant convolution runs in float32 on the conv's own weight (the
bf16 cast of the masters in a bf16 model; the reference reads its float32
parameters) and casts its output to the type of its input, the type the
conv computes in.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from cerberusnet_torch.quant import ptq
from cerberusnet_torch.quant.ptq import QMAX, _convs, _unsupported_conv_attrs


def _ste_round_clip(x, scale):
    """Symmetric fake quantization with a straight-through gradient."""
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX) * scale
    return x + (q - x).detach()


def _fake_quant_conv(conv: nn.Conv2d, x, absmax=None):
    """``conv`` on ``x`` with its input and kernel fake-quantized: the
    convolution and bias only, as ``ptq._int8_conv``. ``absmax`` is the
    input's range, None for the live one."""
    kernel = conv.weight.float()
    kmax = torch.clamp_min(kernel.detach().abs().amax(dim=(1, 2, 3)), 1e-12)
    kq = _ste_round_clip(kernel, (kmax / QMAX).view(-1, 1, 1, 1))
    xf = x.float()
    if absmax is None:  # no seed for this conv: the live range, detached
        absmax = torch.clamp_min(xf.detach().abs().amax(), 1e-12)
    else:
        absmax = torch.clamp_min(absmax.float(), 1e-12)
    xq = _ste_round_clip(xf, absmax / QMAX)
    out = F.conv2d(xq, kq, None, conv.stride, conv.padding, conv.dilation)
    if conv.bias is not None:
        out = out + conv.bias.float().view(1, -1, 1, 1)
    return out.to(x.dtype)


def fake_quantized(conv: nn.Conv2d) -> bool:
    """Whether QAT fake-quantizes ``conv`` (and PTQ quantizes it)."""
    return conv.weight.dim() == 4 and not _unsupported_conv_attrs(conv)


@contextlib.contextmanager
def qat_interception(model: nn.Module, ema: dict | None = None):
    """Within the block every conv of ``model`` that ``fake_quantized``
    takes runs fake-quantized against ``ema`` ({name: absmax}). Yields a
    dict that fills with {name: the input absmax observed}, max-reduced
    over the conv's calls (for ``update_ema``)."""
    ema = ema or {}
    observed: dict = {}

    def forward(name, conv):
        def call(x):
            a = x.detach().float().abs().amax()
            observed[name] = (torch.maximum(observed[name], a)
                              if name in observed else a)
            return _fake_quant_conv(conv, x, ema.get(name))
        return call

    swapped = []
    for name, conv in _convs(model):
        if fake_quantized(conv):
            conv.forward = forward(name, conv)
            swapped.append(conv)
    try:
        yield observed
    finally:
        for conv in swapped:
            del conv.forward


def qat_apply(model: nn.Module, ema: dict | None, *inputs, **kwargs):
    """``model(*inputs)`` with fake-quant convs; returns ``(out,
    observed)``, the observed absmaxes for ``update_ema``.
    Differentiable."""
    with qat_interception(model, ema) as observed:
        out = model(*inputs, **kwargs)
    return out, observed


def init_ema(scales: dict, device=None) -> dict:
    """The ranges {name: float32 absmax tensor} from a ``ptq.calibrate``
    result."""
    return {name: torch.tensor(v, dtype=torch.float32, device=device)
            for name, v in scales.items()}


@torch.no_grad()
def update_ema(ema: dict, observed: dict, momentum: float = 0.99) -> dict:
    """The ranges after one step's observations: momentum * range + (1 -
    momentum) * observed. Ranges not observed this step survive; a conv
    without one adopts its observed value."""
    new = dict(ema)
    for name, obs in observed.items():
        obs = obs.float()
        prev = ema.get(name)
        new[name] = (momentum * prev + (1.0 - momentum) * obs
                     if prev is not None else obs)
    return new


def finalize(model: nn.Module, ema: dict, *, skip=(), strip: bool = False,
             weights: dict | None = None) -> nn.Module:
    """QAT -> deployable int8: ``ptq.quantize`` of ``model`` with the
    trained ranges ``ema``."""
    if not ema:
        raise ValueError("no QAT ranges (seed them with init_ema and tick "
                         "them with update_ema during training)")
    scales = {name: float(v) for name, v in ema.items()}
    return ptq.quantize(model, scales, skip=skip, strip=strip,
                        weights=weights)
