"""``train.debug_nans``: stop at the first operator whose output holds a NaN.

The reference sets ``jax_debug_nans``, which raises ``FloatingPointError``
at the first primitive whose output holds a NaN, in the forward or the
backward; an inf does not trip it. ``DebugNans`` is a
``TorchDispatchMode`` that checks the floating outputs of every ATen and
custom operator (the kernels' operators of ``ops/library.py`` too) that
runs while it is active, the backward's included, and raises
``FloatingPointError`` naming the operator. An inf passes, as there. The
allocations (``ALLOCATIONS``) are not checked: their outputs are memory
no operator has written yet (the backward of a slice allocates its
gradient so, then fills it), which may hold any bit pattern.

Unlike the reference's flag, which is global to the process, the trainer
enters the mode around its own steps and evaluations only. Each check
reads a flag back from the device, so a step under it waits for the device
after every operator.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


ALLOCATIONS = (torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided)


class DebugNans(TorchDispatchMode):
    """Raises FloatingPointError at the first operator output with a
    NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in ALLOCATIONS:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out
