"""The reference's bf16 estimator and head convolutions against the port's,
op by op, shared by ``tests/test_torch_fused_estimator.py`` and
``scripts/pwc_bf16_op_compare.py``.

``capture`` runs a JAX model once, jitted, and keeps the input and output
of every call of the modules in ``CAPTURED`` (by module path). The
``*_ops`` functions then run each op of the port alone on the captured
inputs and return ``{op: (port, reference)}`` NHWC float32 arrays, the
reference being the captured output:

* ``estimator_ops``: each trunk conv y1..yn and the predictor of one
  estimator; in the fused form each conv is one ``fused_dense`` of the
  captured components it reads, its predecessors' outputs included, so
  no error compounds from one to the next; ``control=True`` adds
  ``naive y<k>``,
  each trunk conv as one conv over the concatenated stack (the arithmetic
  of the reference's ``fused=False``) against the fused outputs;
* ``pwc_decoder_ops``: those of every level of a flow or disparity
  decoder, with the up-feature conv (after its LeakyReLU; where the stack
  stays components, its subpixel form as one more extra of the fused
  trunk, from the reference's components) and, at level 2, the context
  network's first conv (after its LeakyReLU) and last conv;
* ``dcv_decoder_ops``: the same for a DCV decoder's one level;
* ``fpn_ops`` / ``aspp_ops``: the segmentation heads' 1x1 convs, the
  resizes and adds between them, the float32 classifier and the final
  resize.

``widths`` gives the channel widths of an estimator's or a context
network's input (one entry a component), to hold the components a port
decoder hands them to the reference's.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cerberusnet_torch.models.common import (
    depth_to_space,
    fused_dense,
    leaky,
    subpixel,
    upsample_to,
)

BF16 = jnp.bfloat16
CAPTURED = ("FusedDenseEstimator", "DenseEstimator", "ContextNetwork",
            "ConvBlock", "Conv", "ConvTranspose", "SegmentationHead",
            "ASPPSegmentationHead")
# the PWC decoders' levels, coarse to fine
LEVELS = (6, 5, 4, 3, 2)


def capture(model, params, *inputs):
    """(outputs, {module path: (args, output)}) of ``model.apply`` jitted,
    for every call with an input of a module whose class is in
    ``CAPTURED``."""
    paths = []

    def run(p, *x):
        calls = []

        def keep(fn, args, kwargs, ctx):
            out = fn(*args, **kwargs)
            if (ctx.method_name == "__call__" and args
                    and type(ctx.module).__name__ in CAPTURED):
                calls.append((jax.tree.map(
                    lambda a: a if isinstance(a, jax.Array) else None,
                    args), out))
                if len(paths) < len(calls):  # traced once
                    paths.append(tuple(ctx.module.path))
            return out

        with nn.intercept_methods(keep):
            out = model.apply({"params": p}, *x)
        return out, calls

    out, calls = jax.jit(run)(params, *inputs)
    return out, dict(zip(paths, calls))


def to_torch(x):
    """An NHWC JAX array as an NCHW tensor of its type (bf16 or float32)."""
    a = np.array(jnp.asarray(x, jnp.float32))
    t = torch.from_numpy(a).permute(0, 3, 1, 2)
    return t.to(torch.bfloat16) if x.dtype == BF16 else t


def to_numpy(t):
    """An NCHW tensor as an NHWC float32 array."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def ref(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.maximum(x, 2.0**-126)))
    return 2.0 ** (e - 7)


def compare(got, want) -> dict:
    """The share of elements that differ and the largest difference in bf16
    units in the last place of the larger value (at least a thousandth of
    the tensor's largest: a sum that cancels to near 0 has no scale)."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    d = got - want
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       1e-3 * np.abs(want).max())
    return {"differ": float((d != 0).mean()),
            "max_ulp": float((np.abs(d) / ulp(scale)).max()),
            "elements": int(d.size)}


def widths(x) -> list:
    """The channel widths of a stack's components (NHWC arrays or NCHW
    tensors; one tensor is one component)."""
    if not isinstance(x, (list, tuple)):
        x = [x]
    return [int(c.shape[1] if isinstance(c, torch.Tensor) else c.shape[-1])
            for c in x]


def _components(stack, widths):
    """A stack (a list of components, or one tensor) as components of the
    given widths."""
    if isinstance(stack, (list, tuple)):
        return list(stack)
    cuts = np.cumsum(widths)[:-1].tolist()
    return jnp.split(stack, cuts, axis=-1)


def _port_stack(stack):
    if isinstance(stack, (list, tuple)):
        return [to_torch(c) for c in stack]
    return to_torch(stack)


@torch.no_grad()
def estimator_ops(cap, prefix, est, pred, i: int, control: bool = False):
    """{op: (port, reference)} of estimator ``est`` (the reference's
    ``DenseEstimator_<i>`` under ``prefix``) and its predictor ``pred``
    (``Conv_<i>``), in the port estimator's form (``est.fused``)."""
    name = f"DenseEstimator_{i}"
    widths = [b.conv.out_channels for b in est.blocks]
    ops = {}
    if est.fused:
        args, (stack, (want,)) = cap[prefix + (name,)]
        inputs = list(args[0])
        ys = _components(stack, [c.shape[-1] for c in inputs] + widths)[
            len(inputs):]
        tin, tys = [to_torch(c) for c in inputs], [to_torch(y) for y in ys]
        for k, (conv, y) in enumerate(zip(_trunk(est), ys)):
            (g,), _ = fused_dense(tin + tys[:k], [conv])
            ops[f"y{k + 1}"] = (to_numpy(g), ref(y))
            if control:
                x = torch.cat(tin + tys[:k], dim=1)
                ops[f"naive y{k + 1}"] = (to_numpy(est.blocks[k](x)), ref(y))
        _, (p,) = fused_dense(tin + tys, [], [(pred.weight, pred.bias)])
        ops["predictor"] = (to_numpy(p), ref(want))
        return ops
    for k, block in enumerate(est.blocks):
        (x,), out = cap[prefix + (name, f"ConvBlock_{k}")]
        ops[f"y{k + 1}"] = (to_numpy(block(to_torch(x))), ref(out))
    (x,), out = cap[prefix + (f"Conv_{i}",)]
    ops["predictor"] = (to_numpy(pred(to_torch(x))), ref(out))
    return ops


def _trunk(est):
    return [(b.conv.weight, b.conv.bias) for b in est.blocks]


def _stack(cap, prefix, est, i: int):
    """The reference's final stack of estimator i (a list of components
    where the fused form keeps them)."""
    if est.fused:
        return cap[prefix + (f"DenseEstimator_{i}",)][1][0]
    return cap[prefix + (f"Conv_{i}",)][0][0]


@torch.no_grad()
def context_ops(cap, prefix, ctx, stack):
    """The context network's first conv (after LeakyReLU) on the
    reference's ``stack`` and its last conv on the reference's input."""
    path = prefix + ("ContextNetwork_0",)
    want = cap[path + ("ConvBlock_1",)][0][0]
    ops = {"context_first": (to_numpy(ctx.first(_port_stack(stack))),
                             ref(want))}
    (x,), out = cap[path + ("Conv_0",)]
    ops["context_out"] = (to_numpy(ctx.out(to_torch(x))), ref(out))
    return ops


@torch.no_grad()
def pwc_decoder_ops(cap, prefix, dec, control: bool = False,
                    levels=LEVELS, convt=None) -> dict:
    """{level: {op: (port, reference)}} of the port's flow or disparity
    decoder ``dec`` against the reference's under ``prefix``, at
    ``levels``. ``convt``: (the reference's ``conv_transpose_over_
    components``, the decoder's parameters) to add, where the stack is
    kept as components, the up-feature conv against the reference's
    other lowering run alone (``upfeat_vs_convt``), and the reference's
    two lowerings against each other (``subpixel_vs_convt``)."""
    out = {}
    for i, level in enumerate(LEVELS):
        if level not in levels:
            continue
        est = dec.estimators[i]
        ops = estimator_ops(cap, prefix, est, dec.predictors[i], i, control)
        stack = _stack(cap, prefix, est, i)
        if level == LEVELS[-1]:
            ops.update(context_ops(cap, prefix, dec.context, stack))
        else:
            # the subpixel conv over the stack's components, or over the
            # concatenated stack as one
            comps = _port_stack(stack)
            _, (sub,) = fused_dense(
                comps if isinstance(comps, list) else [comps], [],
                [subpixel(dec.upfeats[i])])
            got = to_numpy(leaky(depth_to_space(sub)))
            # the reference's up-feature: the last channels of the next
            # estimator's input
            nxt = prefix + (f"DenseEstimator_{i + 1}",)
            want = (cap[nxt][0][0][-1] if est.fused
                    else cap[nxt + ("ConvBlock_0",)][0][0])
            ops["upfeat"] = (got, ref(want[..., -got.shape[-1]:]))
            if convt is not None and isinstance(stack, (list, tuple)):
                fn, p = convt
                k = p[f"ConvTranspose_{i}"]
                alone = jax.jit(lambda s, k, b: nn.leaky_relu(
                    fn(s, k, b, (2, 2), BF16), 0.1))(
                        list(stack), k["kernel"], k["bias"])
                ops["upfeat_vs_convt"] = (got, ref(alone))
                ops["subpixel_vs_convt"] = (ref(want[..., -got.shape[-1]:]),
                                            ref(alone))
        out[level] = ops
    return out


@torch.no_grad()
def dcv_decoder_ops(cap, prefix, dec, control: bool = False) -> dict:
    """{op: (port, reference)} of the port's DCV decoder ``dec`` against
    the reference's under ``prefix``: the estimator with its volumes and
    f1 as components, the predictor and the context network."""
    ops = estimator_ops(cap, prefix, dec.estimator, dec.predictor, 0,
                        control)
    ops.update(context_ops(cap, prefix, dec.context,
                           _stack(cap, prefix, dec.estimator, 0)))
    return ops


@torch.no_grad()
def fpn_ops(cap, head, prefix=("SegmentationHead_0",)) -> dict:
    """The FPN head's laterals (levels 6..2), each top-down step (the
    upsampled map plus the next lateral), the classifier and the final
    resize, fed the reference's inputs."""
    ops = {}
    lats = []
    for k, conv in enumerate(head.laterals):
        (x,), out = cap[prefix + (f"Conv_{k}",)]
        ops[f"lateral_{LEVELS[k]}"] = (to_numpy(conv(to_torch(x))), ref(out))
        lats.append(leaky(to_torch(out)))
    x = lats[0]
    for k in range(len(head.smooth)):
        (want,), out = cap[prefix + (f"ConvBlock_{k}",)]
        got = upsample_to(x, lats[k + 1].shape[2:]) + lats[k + 1]
        ops[f"topdown_{LEVELS[k + 1]}"] = (to_numpy(got), ref(want))
        x = to_torch(out)
    ops.update(_classify_ops(cap, prefix, head.classifier, "Conv_5"))
    return ops


@torch.no_grad()
def aspp_ops(cap, head, prefix=("ASPPSegmentationHead_0",)) -> dict:
    """The ASPP head's image mean, pooled, projecting and skip 1x1s, the
    projection's resize beside the skip, the classifier and the final
    resize, fed the reference's inputs."""
    ops = {}
    (x,), _ = cap[prefix + ("ConvBlock_0",)]
    (pooled,), _ = cap[prefix + ("Conv_0",)]
    ops["image_mean"] = (to_numpy(head._image_mean(to_torch(x))),
                         ref(pooled))
    outs = {}
    for name, conv in (("Conv_0", head.pool), ("Conv_1", head.project),
                       ("Conv_2", head.skip)):
        (x,), out = cap[prefix + (name,)]
        ops[{"Conv_0": "pool", "Conv_1": "project", "Conv_2": "skip"}[
            name]] = (to_numpy(conv(to_torch(x))), ref(out))
        outs[name] = leaky(to_torch(out))
    skip = outs["Conv_2"]
    got = torch.cat([upsample_to(outs["Conv_1"], skip.shape[2:]), skip], 1)
    (want,), _ = cap[prefix + ("ConvBlock_4",)]
    ops["upsample_skip"] = (to_numpy(got), ref(want))
    ops.update(_classify_ops(cap, prefix, head.classifier, "Conv_3"))
    return ops


def _classify_ops(cap, prefix, classifier, name):
    (x,), logits = cap[prefix + (name,)]
    got = classifier(to_torch(x).float())
    _, full = cap[prefix]
    return {"classifier": (to_numpy(got), ref(logits)),
            "resize": (to_numpy(upsample_to(to_torch(logits),
                                            full.shape[1:3])), ref(full))}
