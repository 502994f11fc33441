"""The port's FLOP count and the card's peaks: the counterpart of
``tools/mfu.py`` (which counts the JAX package's XLA programs).

``count(call, device)`` runs one call under ``torch.utils.flop_counter.
FlopCounterMode`` and returns its FLOPs. Convolutions and matrix products
count as the mode counts them: every tap, ``2·M·N·K``. The ``cerberus::``
operators (``ops/library.py``) carry the formulas registered here
(``register_flop_formula``), the analytic counts the kernels' bounds use:
a correlation's multiply-adds with its second operand in frame (an
out-of-frame product is zero by definition, so none is needed), times two,
for a forward and for each backward alike; a fused encoder level's three
convolutions with their in-image taps, and its reverse sweep's recompute,
input and weight gradients. The mode does not look inside an operator, so
the count is the same whether it runs its kernel (a CUDA tensor) or its
plain version (``plain_operators()``).

A model on the CPU sends its correlations and levels to the plain versions
without the operators, which the mode would count as zero; ``count`` runs
a CPU call under ``plain_operators()``, which routes it through the
operators, so the card's count and the CPU's agree.

``PEAKS`` are the published dense peaks of the cards the port runs on, by
the name ``nvidia-smi`` reports; the float32 peak is the CUDA cores' (TF32
off, as the port's float32 runs set it).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import (
    FlopCounterMode,
    flop_registry,
    register_flop_formula,
)

from cerberusnet_torch.ops import correlation as corr
from cerberusnet_torch.ops import encoder_level as enc
from cerberusnet_torch.ops import library  # noqa: F401  the operators
from cerberusnet_torch.ops.cuda import correlation as cuda_correlation
from cerberusnet_torch.ops.cuda import encoder_level as cuda_level

# (name as nvidia-smi reports it, device memory bytes/s, float32 FLOP/s on
# the CUDA cores, bf16 FLOP/s on the tensor cores): NVIDIA data sheets,
# dense
PEAKS = (
    ("H100 PCIe", 2.0e12, 51.2e12, 756.0e12),
    ("H100 NVL", 3.9e12, 60.0e12, 835.5e12),
    ("H100", 3.35e12, 67.0e12, 989.4e12),  # SXM (HBM3)
)


def card_peaks(name: str):
    """{"bytes": bytes/s, "f32": FLOP/s, "bf16": FLOP/s} of the card called
    ``name``, or None."""
    for key, bw, f32, bf16 in PEAKS:
        if key in name:
            return {"bytes": bw, "f32": f32, "bf16": bf16}
    return None


def in_frame(n, offsets):
    """Pixels of a line of n whose sample at each offset lies in the frame,
    summed over the offsets."""
    return sum(max(n - abs(o), 0) for o in offsets)


def corr2d_flops(b, h, w, c, d, dil):
    """Multiply-adds of the 2-D correlation with f2 in frame, times two:
    an out-of-frame product is zero by definition, so none is needed."""
    offsets = [o * dil for o in range(-d, d + 1)]
    return 2 * b * c * in_frame(h, offsets) * in_frame(w, offsets)


def corr1d_flops(b, h, w, c, d, dil):
    return 2 * b * h * c * in_frame(w, [k * dil for k in range(d + 1)])


def level_flops(b, h, w, c, f):
    """(FLOPs of a level's three convolutions, FLOPs of one of its two
    stride-1 convolutions), counting only taps whose input lies in the
    image (a SAME-padding product is zero)."""
    h2, w2 = h // 2, w // 2
    entry = (3 * h2 - 1) * (3 * w2 - 1) * c  # stride 2 pads (0, 1)
    inner = (3 * h2 - 2) * (3 * w2 - 2) * f  # stride 1 pads (1, 1)
    return 2 * b * f * (entry + 2 * inner), 2 * b * f * inner


def level_bwd_flops(b, h, w, c, f, need_dx=True):
    """FLOPs of a level's reverse sweep: the recompute of its first two
    convolutions, three weight gradients and the input gradients (the
    entry convolution's only where ``need_dx``)."""
    fwd, inner = level_flops(b, h, w, c, f)
    return 3 * fwd - inner - (0 if need_dx else fwd - 2 * inner)


def _register(op, formula):
    if op not in flop_registry:
        register_flop_formula(op)(formula)


def _corr_formula(flops_of):
    def formula(a_shape, f_shape, max_disp, dilation, *args, out_shape=None,
                **kwargs):
        return flops_of(*f_shape, max_disp, dilation)
    return formula


def _level_fwd_formula(x_shape, k1_shape, *args, out_shape=None, **kwargs):
    return level_flops(*x_shape, k1_shape[-1])[0]


def _level_bwd_formula(x_shape, y3_shape, g_shape, k1_shape, b1, k2, b2, k3,
                       b3, need_dx, *args, out_shape=None, **kwargs):
    return level_bwd_flops(*x_shape, k1_shape[-1], need_dx)


for _name, _flops_of in (("corr2d", corr2d_flops), ("corr1d", corr1d_flops)):
    for _suffix in ("fwd", "bwd_f1", "bwd_f2"):
        _register(getattr(torch.ops.cerberus, f"{_name}_{_suffix}"),
                  _corr_formula(_flops_of))
_register(torch.ops.cerberus.encoder_level_fwd, _level_fwd_formula)
_register(torch.ops.cerberus.encoder_level_bwd, _level_bwd_formula)


def _level_bwd_plain(x, y3, g, k1, b1, k2, b2, k3, b3, need_dx=True):
    """``level_bwd``'s outputs from the plain level, differentiated by hand
    with ``torch.nn.grad`` (``torch.func`` cannot run inside an operator
    under a dispatch mode): dx (None unless ``need_dx``) and float32 kernel
    and bias gradients. Same math as ``encoder_level_bwd_plain``."""
    del y3
    a = x.permute(0, 3, 1, 2)
    saved = []
    for (k, b), stride in zip(((k1, b1), (k2, b2), (k3, b3)), (2, 1, 1)):
        a_in = F.pad(a, (0, 1, 0, 1)) if stride == 2 else a
        w = k.permute(3, 2, 0, 1).to(a.dtype)
        pad = 0 if stride == 2 else 1
        z = F.conv2d(a_in, w, b.to(a.dtype), stride=stride, padding=pad)
        saved.append((a_in, w, z, stride, pad))
        a = F.leaky_relu(z, 0.1)
    da = g.permute(0, 3, 1, 2).to(a.dtype)
    grads = []
    for i, (a_in, w, z, stride, pad) in reversed(list(enumerate(saved))):
        dz = torch.where(z > 0, da, da * 0.1)
        dk = torch.nn.grad.conv2d_weight(a_in, w.shape, dz, stride, pad)
        grads[:0] = [dk.permute(2, 3, 1, 0).float(), dz.sum((0, 2, 3)).float()]
        if i or need_dx:
            da = torch.nn.grad.conv2d_input(a_in.shape, w, dz, stride, pad)
    dx = da[:, :, :x.shape[1], :x.shape[2]].permute(0, 2, 3, 1).contiguous()
    return (dx if need_dx else None, *grads)


@contextlib.contextmanager
def plain_operators():
    """Within it, every kernel's wrapper is its plain version and tensors
    on any device go through the ``cerberus::`` operators: the card's path,
    with no kernel launched and no launch counted."""
    plain = {cuda_correlation: {
        "corr2d_fwd": corr._correlation2d_plain,
        "corr1d_fwd": corr._correlation1d_plain,
        "corr2d_bwd_f1": corr._correlation2d_bwd_f1_plain,
        "corr2d_bwd_f2": corr._correlation2d_bwd_f2_plain,
        "corr1d_bwd_f1": corr._correlation1d_bwd_f1_plain,
        "corr1d_bwd_f2": corr._correlation1d_bwd_f2_plain},
        cuda_level: {"level_fwd": enc.encoder_level_plain,
                     "level_bwd": _level_bwd_plain}}
    dispatch = corr._dispatch
    plain[corr] = {"_dispatch": lambda f1, f2, impl: (
        dispatch(f1, f2, impl) and impl == "plain")}
    plain[enc] = {"_takes_plain": lambda x: False}
    saved = {m: {n: getattr(m, n) for n in fns} for m, fns in plain.items()}
    try:
        for m, fns in plain.items():
            for n, fn in fns.items():
                setattr(m, n, fn)
        yield
    finally:
        for m, fns in saved.items():
            for n, fn in fns.items():
                setattr(m, n, fn)


def count(call, device) -> int:
    """FLOPs of ``call()`` (a forward, or a whole train step with its
    backward) on ``device``, by ``FlopCounterMode``; on the CPU under
    ``plain_operators()``."""
    cpu = torch.device(device).type == "cpu"
    with (plain_operators() if cpu else contextlib.nullcontext()), \
            FlopCounterMode(display=False) as mode:
        call()
    return mode.get_total_flops()
