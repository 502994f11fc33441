#!/usr/bin/env python3
"""Where the port's bf16 RAFT first rounds otherwise than the JAX package:
each convolution before the update block (the shared encoder's eighteen
ConvBlocks, ``corr_proj`` and ``context_proj``) and each op of the flow
decoder's first iterations, from the volume lookup through the motion
encoder, the GRU and the flow head, fed the same inputs in both packages
on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/raft_bf16_op_compare.py [--seeds 3] [--iters 3]
        [--no-excess-precision]

The tiny ``cerberus_raft`` experiment of tests/jax_pairs.py in bfloat16
(encoder (8, 12, 16, 16, 16, 16), fdim/hdim/cdim 16/16/8, 64x64, batch 2
of the synthetic dataset), one set of random float32 parameters a seed for
both packages. The JAX model runs once, jitted and unrolled, with its
intermediates captured (each conv's output, the motion encoder's, the
GRU's, each update's). Then every op of iteration t is computed alone in
both packages from JAX's captured inputs (an activation of a captured
conv output is taken in bf16, as either package computes it alone):

* ``ConvBlock_<n>`` (iteration "encoder"), for each of the three frames
  the encoder takes: block n's output (conv, bias, LeakyReLU) from block
  n - 1's captured output (the preprocessed frame for block 0);
  ``corr_proj`` on the captured level features of the left and temporal
  frames, ``context_proj`` on the left's;
* ``lookup``: the pyramid of the all-pairs volume of the captured
  ``corr_proj`` outputs, sampled at grid + flow (float32);
* the motion encoder's ``convc1``, ``convc2``, ``convf1``, ``convf2``,
  ``conv``; the GRU's ``convz``, ``convr``, ``convq``, its gates
  ``sigmoid(convz)``, ``sigmoid(convr)``, ``tanh(convq)`` (each side's own
  from the captured conv output; ``gate_*_torch`` with ``torch.sigmoid`` /
  ``torch.tanh``, the port's form before its gates rounded as flax's) and
  its update ``(1 - z) h + z q``;
  ``flow_head1``, ``flow_head2``; the decoder's ``hidden_init``, ``tanh``
  of ``context_proj``'s first channels (iteration "init").

The backward, op by op (``bwd.`` rows): JAX's cotangent of the
experiment's loss (``joint_loss`` with the sequence terms) is captured at
the output of each call of the flow decoder's modules (a zero added there
through flax's ``intercept_methods``, its gradient taken with the
parameters'). Each update-block convolution and the GRU cell then run
their backward alone on JAX's captured inputs and that cotangent:
``jax.vjp`` of the flax module and ``torch.autograd.grad`` of the port's
(float32 weights, cast to bf16 at the use, as either trainer keeps them):
``bwd.<conv>.dx`` / ``.kernel`` / ``.bias``, ``bwd.gru.dh`` / ``.dx`` /
``.<conv>.kernel`` / ``.<conv>.bias`` (``.dh_torch_gates`` /
``.dx_torch_gates`` with torch's own gates); ``bwd.<conv>.dy`` the cotangent at
the output of a conv whose only reader is the next conv through
LeakyReLU; the hidden state's ``tanh`` (``bwd.hidden_init``) on the GRU's
first ``dh``; ``bwd.volume.df1`` / ``.df2`` the all-pairs volume's
backward, the iterations' ``convc1`` input cotangents through the
lookups, the pyramid and the product to the two ``corr_proj`` outputs.
Where JAX's model gives the same cotangent, ``model_vs_jax`` holds it
against JAX's op alone. ``bwd.sum.<conv>.kernel`` / ``.bias`` (iteration
"all") hold the update block's tied weights' gradients, summed over the
iterations: ``port_vs_jax`` the port's sum of its ops' gradients against
JAX's of its ops', ``model_vs_jax`` JAX's whole-model gradient against
that sum. Two views of JAX's gradient program itself: ``grad_fwd.<op>``
its forward values against the forward program's (``model_vs_jax``), and
``cot_bf16_exact.<module>`` the ``share`` of its cotangents at a module's
output that are bf16 values (below 1 where XLA keeps float32 between
ops under its default excess precision).

One JSON line an (seed, iteration, op): ``port_vs_jax`` compares the port's
op with JAX's op run alone, ``model_vs_jax`` JAX's value inside its jitted
model with JAX's op run alone (what XLA's fusion changes around the op);
each gives the share of elements that differ, the largest difference in
bf16 units in the last place of the larger value, and the sign share
(|mean sign| of the differences: 0 where they cancel, 1 where every one
points the same way). A last line sums the shares per op over the seeds.

A measurement for the port's record (ROADMAP C7), not a test.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

if "--no-excess-precision" in sys.argv:  # before JAX reads its flags
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_allow_excess_precision=false").strip()

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cerberusnet_torch.models import raft as tr  # noqa: E402
from cerberusnet_torch.models.common import leaky as port_leaky  # noqa: E402
from cerberusnet_torch.models.common import sigmoid, tanh  # noqa: E402
from cerberusnet_torch.train.config import ExperimentConfig  # noqa: E402
from cerberusnet_torch.train.trainer import build_model  # noqa: E402
from cerberusnet_torch.weights import load_flax_params  # noqa: E402
from cerberusnet_tpu.data.loader import collate, make_preprocess_fn  # noqa: E402
from cerberusnet_tpu.data.synthetic import SyntheticPerceptionDataset  # noqa: E402
from cerberusnet_tpu.models import raft as jr  # noqa: E402
from cerberusnet_tpu.train import losses as jl  # noqa: E402
from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig  # noqa: E402
from cerberusnet_tpu.train.trainer import build_model as jax_build_model  # noqa: E402
from tests.jax_pairs import RAFT_HW, draw_params, raft_config_dict  # noqa: E402

BF16 = jnp.bfloat16
# the update block's convs: (name, path under "update", kernel size)
CONVS = {"convc1": ("motion", 1), "convc2": ("motion", 3),
         "convf1": ("motion", 5), "convf2": ("motion", 3),
         "conv": ("motion", 3), "convz": ("gru", 3), "convr": ("gru", 3),
         "convq": ("gru", 3), "flow_head1": (None, 3),
         "flow_head2": (None, 3)}
# (conv, the conv fed LeakyReLU of its output alone)
LEAKY_PAIRS = (("convc1", "convc2"), ("convf1", "convf2"),
               ("flow_head1", "flow_head2"))


def ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.maximum(x, 2.0**-126)))
    return 2.0 ** (e - 7)


def compare(got, want) -> dict:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    d = got - want
    nz = d != 0
    # in units of the larger value's last place (at least a thousandth of
    # the tensor's largest: a sum that cancels to near 0 has no scale)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                       1e-3 * np.abs(want).max())
    return {"differ": float(nz.mean()),
            "max_ulp": float((np.abs(d) / ulp(scale)).max()),
            "sign_share": float(abs(np.sign(d[nz]).mean())) if nz.any()
            else 0.0}


def leaky(x):
    return jnp.where(x > 0, x, x * jnp.asarray(0.1, x.dtype))


def to_torch(x):
    """An NHWC JAX array as an NCHW tensor of its type."""
    a = np.asarray(jnp.asarray(x, jnp.float32))
    t = torch.from_numpy(a).permute(0, 3, 1, 2)
    return t.to(torch.bfloat16 if x.dtype == BF16 else torch.float32)


def to_numpy(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def jax_conv(params, feat, k, x):
    return jax.jit(lambda p, v: nn.Conv(feat, (k, k), padding="SAME",
                                        dtype=BF16).apply({"params": p}, v))(
        params, x)


def encoder_ops(cap, jp, port, ins, level):
    """{op: comparisons} of the convolutions before the update block, each
    fed JAX's captured input (``ins``: the frames the encoder takes)."""
    from cerberusnet_tpu.models.common import ConvBlock

    enc, penc = cap["PyramidEncoder_0"], jp["PyramidEncoder_0"]
    ops = {}
    for n, block in enumerate(port.encoder.blocks):
        name = f"ConvBlock_{n}"
        out = enc[name]["__call__"]
        rows = []
        for c, frame in enumerate(ins):
            x = (frame.astype(BF16) if n == 0
                 else enc[f"ConvBlock_{n - 1}"]["__call__"][c])
            want = jax.jit(lambda p, v, f=out[c].shape[-1], s=block.stride:
                           ConvBlock(f, stride=s, dtype=BF16).apply(
                               {"params": p}, v))(penc[name], x)
            with torch.no_grad():
                got = to_numpy(block(to_torch(x)))
            rows.append((compare(got, want), compare(out[c], want)))
        ops[name] = {"port_vs_jax": merge([r[0] for r in rows]),
                     "model_vs_jax": merge([r[1] for r in rows])}
    last = f"ConvBlock_{3 * level - 1}"
    feats = enc[last]["__call__"]
    dec = port.flow
    cap, jp = cap["RAFTFlowDecoder_0"], jp["RAFTFlowDecoder_0"]
    for name, k, frames in (("corr_proj", 1, (0, 2)),
                            ("context_proj", 3, (0,))):
        mod = getattr(dec, name)
        rows = []
        for i, c in enumerate(frames):
            x = feats[c]
            model = cap[name]["__call__"][i]
            want = jax_conv(jp[name], model.shape[-1], k, x)
            with torch.no_grad():
                got = to_numpy(mod(to_torch(x)))
            rows.append((compare(got, want), compare(model, want)))
        ops[name] = {"port_vs_jax": merge([r[0] for r in rows]),
                     "model_vs_jax": merge([r[1] for r in rows])}
    return ops


def merge(parts: list) -> dict:
    """``compare``'s results of equal-sized tensors as one."""
    return {"differ": float(np.mean([p["differ"] for p in parts])),
            "max_ulp": max(p["max_ulp"] for p in parts),
            "sign_share": float(np.mean([p["sign_share"] for p in parts]))}


def jax_cotangents(forward, params, prep, cfg):
    """(JAX's gradient of the experiment's loss, {"<path>#<call>": its
    cotangent at the output of that call of a module of the flow decoder
    (the path under ``RAFTFlowDecoder_0``)}, {the same key: that output's
    value in this program}), from one jitted program."""
    probe, seen, shapes, values = {}, {}, {}, {}

    def interceptor(fn, args, kwargs, ctx):
        out = fn(*args, **kwargs)
        path = ctx.module.scope.path
        if (ctx.method_name != "__call__" or not path
                or path[0] != "RAFTFlowDecoder_0"
                or not isinstance(out, jax.Array)):
            return out
        n = seen.get(path, 0)
        seen[path] = n + 1
        key = f"{'/'.join(path[1:])}#{n}"
        shapes[key] = out.shape
        values[key] = out
        return out + probe[key].astype(out.dtype) if key in probe else out

    def loss(p, zeros):
        probe.clear()
        probe.update(zeros)
        seen.clear()
        values.clear()
        with nn.intercept_methods(interceptor):
            total = jl.joint_loss(forward({"params": p}, prep), prep,
                                  weights=cfg.loss.weights,
                                  seq_gamma=cfg.loss.seq_gamma)[0]
        return total, dict(values)

    jax.eval_shape(loss, params, {})
    zeros = {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}
    (grads, cots), vals = jax.jit(jax.grad(loss, argnums=(0, 1),
                                           has_aux=True))(params, zeros)
    return grads, cots, vals


@contextlib.contextmanager
def torch_gates():
    """The port's RAFT gates as ``torch.sigmoid`` and ``torch.tanh`` (their
    form before they rounded as flax's) while it is entered."""
    kept = tr.sigmoid, tr.tanh
    tr.sigmoid, tr.tanh = torch.sigmoid, torch.tanh
    try:
        yield
    finally:
        tr.sigmoid, tr.tanh = kept


def torch_vjp(fn, inputs, params, ct):
    """(the input cotangents, the parameters' gradients) of ``fn`` at
    ``inputs`` (NHWC JAX arrays) for the cotangent ``ct``, NHWC and in
    flax's layouts."""
    ins = [to_torch(x).requires_grad_() for x in inputs]
    out = fn(*ins)
    grads = torch.autograd.grad(out, ins + list(params),
                                to_torch(ct.astype(BF16)))
    dins = [to_numpy(g) for g in grads[:len(ins)]]
    return dins, [flax_layout(g) for g in grads[len(ins):]]


def flax_layout(g):
    """A port parameter's gradient in flax's layout (a conv weight's
    (out, in, kh, kw) as (kh, kw, in, out))."""
    g = g.float()
    return (g.permute(2, 3, 1, 0) if g.dim() == 4 else g).numpy()


def backward_rows(seed, cfg, params, prep, port, inputs, captured_out,
                  hiddens, context, motions, ctx, iters, volume):
    """The ``bwd.`` rows of the module docstring."""
    _, forward, _ = jax_build_model(cfg.model)
    jgrads, cots, vals = jax_cotangents(forward, params, prep, cfg)
    jp = params["RAFTFlowDecoder_0"]["update"]
    jg = jgrads["RAFTFlowDecoder_0"]["update"]
    upd = tr.keep_tied_float32(port).flow.update
    m = cfg.model
    rows, sums = [], {}

    def row(t, op, got, want):
        rows.append({"seed": seed, "iter": t, "op": op,
                     "port_vs_jax": compare(got, want)})

    def module(where, name):
        return upd if where is None else getattr(upd, where)

    for t in range(iters):
        for name, (where, _) in CONVS.items():
            path = f"update/{where}/{name}" if where else f"update/{name}"
            rows.append({"seed": seed, "iter": t, "op": f"grad_fwd.{name}",
                         "model_vs_jax": compare(vals[f"{path}#{t}"],
                                                 captured_out(name, t))})
        rows.append({"seed": seed, "iter": t, "op": "grad_fwd.gru",
                     "model_vs_jax": compare(vals[f"update/gru#{t}"],
                                             hiddens[t + 1])})
        for key in [k for k in cots if k.endswith(f"#{t}")]:
            c = np.asarray(cots[key], np.float32)
            rows.append({"seed": seed, "iter": t,
                         "op": f"cot_bf16_exact.{key.split('#')[0]}",
                         "share": float(np.mean(c == np.asarray(
                             jnp.asarray(c, BF16), np.float32)))})
    dh0, lookup_cts = None, []
    for t in range(iters):
        for name, (where, k) in CONVS.items():
            path = f"update/{where}/{name}" if where else f"update/{name}"
            ct = cots[f"{path}#{t}"].astype(BF16)
            x = inputs[name][t]
            sub = jp if where is None else jp[where]
            feat = ct.shape[-1]
            _, vjp = jax.vjp(lambda p, v, f=feat, k=k: nn.Conv(
                f, (k, k), padding="SAME", dtype=BF16).apply(
                    {"params": p}, v), sub[name], x)
            dp, dx = jax.jit(vjp)(ct)
            conv = getattr(module(where, name), name)
            (tdx,), (tdw, tdb) = torch_vjp(conv, [x], [conv.weight,
                                                      conv.bias], ct)
            row(t, f"bwd.{name}.dx", tdx, dx)
            if name == "convc1":  # the lookup's cotangent, as float32
                lookup_cts.append(dx.astype(jnp.float32))
            row(t, f"bwd.{name}.kernel", tdw, dp["kernel"])
            row(t, f"bwd.{name}.bias", tdb, dp["bias"])
            for leaf, tg, g in (("kernel", tdw, dp["kernel"]),
                                ("bias", tdb, dp["bias"])):
                acc = sums.setdefault((where, name, leaf), [0, 0])
                acc[0] = acc[0] + tg.astype(np.float32)
                acc[1] = acc[1] + np.asarray(g, np.float32)
        # the GRU cell alone
        h, x = hiddens[t], jnp.concatenate([context, motions[t]], -1)
        ct = cots[f"update/gru#{t}"].astype(BF16)
        _, vjp = jax.vjp(lambda p, h, x: jr.ConvGRU(
            m.raft_hdim, dtype=BF16).apply({"params": p}, h, x),
            jp["gru"], h, x)
        dp, dh, dx = jax.jit(vjp)(ct)
        gru = upd.gru
        convs = (gru.convz, gru.convr, gru.convq)
        (tdh, tdx), tps = torch_vjp(gru, [h, x], [q for c in convs
                                                  for q in (c.weight, c.bias)],
                                    ct)
        row(t, "bwd.gru.dh", tdh, dh)
        row(t, "bwd.gru.dx", tdx, dx)
        with torch_gates():
            (odh, odx), _ = torch_vjp(gru, [h, x], [], ct)
        row(t, "bwd.gru.dh_torch_gates", odh, dh)
        row(t, "bwd.gru.dx_torch_gates", odx, dx)
        # the motion encoder's output reaches only the GRU: JAX's cotangent
        # there inside its model against its GRU's alone
        rows[-3]["model_vs_jax"] = compare(
            cots[f"update/motion#{t}"], dx[..., context.shape[-1]:])
        # a conv fed by LeakyReLU of another's output, the only use of it:
        # the cotangent at that output (through leaky), alone and in JAX's
        # model
        for prev, name in LEAKY_PAIRS:
            where, k = CONVS[name]
            path = f"update/{where}/{name}" if where else f"update/{name}"
            ppath = path.replace(name, prev)
            y = captured_out(prev, t)
            ct = cots[f"{path}#{t}"].astype(BF16)
            sub = jp if where is None else jp[where]
            _, vjp = jax.vjp(lambda v, p=sub[name], f=ct.shape[-1], k=k:
                             nn.Conv(f, (k, k), padding="SAME",
                                     dtype=BF16).apply({"params": p},
                                                       leaky(v)), y)
            (want,) = jax.jit(vjp)(ct)
            conv = getattr(module(where, name), name)
            (got,), _ = torch_vjp(lambda v, c=conv: c(port_leaky(v)), [y], [],
                                  ct)
            row(t, f"bwd.{prev}.dy", got, want)
            rows[-1]["model_vs_jax"] = compare(cots[f"{ppath}#{t}"], want)
        for i, name in enumerate(("convz", "convr", "convq")):
            row(t, f"bwd.gru.{name}.kernel", tps[2 * i], dp[name]["kernel"])
            row(t, f"bwd.gru.{name}.bias", tps[2 * i + 1], dp[name]["bias"])
        if t == 0:
            dh0 = dh
    # the hidden state's tanh, on the GRU's first dh
    hdim = m.raft_hdim
    _, vjp = jax.vjp(jnp.tanh, ctx[..., :hdim])
    (want,) = jax.jit(vjp)(dh0)
    (got,), _ = torch_vjp(tanh, [ctx[..., :hdim]], [], dh0)
    row("init", "bwd.hidden_init", got, want)
    rows += volume_rows(seed, m, volume, lookup_cts, cots)
    if iters < m.raft_iters:  # the sums need every iteration
        return rows
    for (where, name, leaf), (tsum, jsum) in sums.items():
        node = jg if where is None else jg[where]
        rows.append({"seed": seed, "iter": "all",
                     "op": f"bwd.sum.{name}.{leaf}",
                     "port_vs_jax": compare(tsum, jsum),
                     "model_vs_jax": compare(node[name][leaf], jsum)})
    return rows


def volume_rows(seed, m, volume, lookup_cts, cots):
    """``bwd.volume.df1`` / ``.df2``: the all-pairs volume's backward, the
    iterations' lookups' cotangents (JAX's ``convc1`` input cotangents
    alone, as float32) through the lookups, the pyramid and the product
    to the two ``corr_proj`` outputs, in both packages; ``model_vs_jax``
    JAX's cotangent there inside its model against its own alone."""
    g1, g2, coords_at = volume
    n = len(lookup_cts)

    def jax_volume(a, b):
        pyr = jr.correlation_pyramid(jr.allpairs_correlation(a, b),
                                     m.raft_corr_levels)
        return [jr.corr_lookup(pyr, c, m.raft_radius, impl=m.raft_lookup)
                for c in coords_at[:n]]

    _, vjp = jax.vjp(jax_volume, g1, g2)
    want = jax.jit(vjp)(lookup_cts)
    a, b = (torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_() for g in (g1, g2))
    pyr = tr.correlation_pyramid(tr.allpairs_correlation(a, b),
                                 m.raft_corr_levels)
    outs = [tr.corr_lookup(pyr, torch.from_numpy(np.asarray(c)),
                           m.raft_radius, impl=m.raft_lookup)
            for c in coords_at[:n]]
    got = torch.autograd.grad(outs, [a, b], [
        torch.from_numpy(np.array(c)) for c in lookup_cts])
    out = []
    for i, name in enumerate(("df1", "df2")):
        r = {"seed": seed, "iter": "all", "op": f"bwd.volume.{name}",
             "port_vs_jax": compare(got[i].float().numpy(), want[i])}
        if n == m.raft_iters:
            r["model_vs_jax"] = compare(cots[f"corr_proj#{i}"], want[i])
        out.append(r)
    return out


def run(seed: int, iters: int):
    raw = raft_config_dict()
    raw["model"].update(dtype="bfloat16", raft_unroll=True)
    cfg = JaxConfig.from_dict(raw)
    model, _, _ = jax_build_model(cfg.model)
    ds = SyntheticPerceptionDataset(length=2, hw=RAFT_HW, num_classes=19,
                                    seed=seed)
    prep = make_preprocess_fn(RAFT_HW)(collate([ds[0], ds[1]]))
    ins = [prep[k] for k in ("left", "right", "temporal")]
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *ins)
    params = draw_params(shapes["params"], seed + 20)
    _, state = jax.jit(lambda p, *x: model.apply(
        {"params": p}, *x, capture_intermediates=True,
        mutable=["intermediates"]))(params, *ins)
    cap = state["intermediates"]["RAFTFlowDecoder_0"]
    jp = params["RAFTFlowDecoder_0"]
    port, _ = build_model(ExperimentConfig.from_dict(raw).model, "plain",
                          torch.bfloat16)
    load_flax_params(port, params)
    dec = port.flow
    m = cfg.model
    hdim = m.raft_hdim

    def captured(name, t):
        where = CONVS[name][0]
        node = cap["update"] if where is None else cap["update"][where]
        return node[name]["__call__"][t]

    def port_conv(name, x):
        where = CONVS[name][0]
        mod = dec.update if where is None else getattr(dec.update, where)
        with torch.no_grad():
            return to_numpy(getattr(mod, name)(to_torch(x)))

    inputs = {}

    def op_conv(name, x, t):
        inputs.setdefault(name, []).append(x)
        where, k = CONVS[name]
        sub = jp["update"] if where is None else jp["update"][where]
        want = jax_conv(sub[name], captured(name, t).shape[-1], k, x)
        return {"port_vs_jax": compare(port_conv(name, x), want),
                "model_vs_jax": compare(captured(name, t), want)}

    g1, g2 = cap["corr_proj"]["__call__"]
    ctx = cap["context_proj"]["__call__"][0]
    hidden = jax.jit(lambda c: jnp.tanh(c[..., :hdim]))(ctx)
    context = jax.jit(lambda c: nn.relu(c[..., hdim:]))(ctx)
    b, h, w, _ = g1.shape
    grid = jr.base_grid(b, h, w)
    flow = jnp.zeros((b, h, w, 2), jnp.float32)
    pyr_j = jr.correlation_pyramid(jr.allpairs_correlation(g1, g2),
                                   m.raft_corr_levels)
    with torch.no_grad():
        pyr_t = tr.correlation_pyramid(tr.allpairs_correlation(
            torch.from_numpy(np.asarray(g1.astype(jnp.float32))).to(
                torch.bfloat16),
            torch.from_numpy(np.asarray(g2.astype(jnp.float32))).to(
                torch.bfloat16)), m.raft_corr_levels)
    rows = [{"seed": seed, "iter": "encoder", "op": op, **res}
            for op, res in encoder_ops(state["intermediates"], params, port,
                                       ins, m.raft_level).items()]
    with torch.no_grad():
        init = to_numpy(tanh(to_torch(ctx)[:, :hdim]))
    rows.append({"seed": seed, "iter": "init", "op": "hidden_init",
                 "port_vs_jax": compare(init, hidden)})
    hiddens, motions = [hidden], []
    coords_at = []
    for t in range(iters):
        coords = grid + flow
        coords_at.append(coords)
        cf = jr.corr_lookup(pyr_j, coords, m.raft_radius, impl=m.raft_lookup)
        with torch.no_grad():
            cf_t = tr.corr_lookup(pyr_t, torch.from_numpy(np.asarray(coords)),
                                  m.raft_radius, impl=m.raft_lookup)
        ops = {"lookup": {"port_vs_jax": compare(cf_t.numpy(), cf)}}
        cfb, fb = cf.astype(BF16), flow.astype(BF16)
        ops["convc1"] = op_conv("convc1", cfb, t)
        ops["convc2"] = op_conv("convc2", leaky(captured("convc1", t)), t)
        ops["convf1"] = op_conv("convf1", fb, t)
        ops["convf2"] = op_conv("convf2", leaky(captured("convf1", t)), t)
        ops["conv"] = op_conv("conv", jnp.concatenate(
            [leaky(captured("convc2", t)), leaky(captured("convf2", t))],
            -1), t)
        motion = cap["update"]["motion"]["__call__"][t]
        hx = jnp.concatenate([hidden, context, motion], -1)
        ops["convz"] = op_conv("convz", hx, t)
        ops["convr"] = op_conv("convr", hx, t)
        z = jax.nn.sigmoid(captured("convz", t))
        r = jax.nn.sigmoid(captured("convr", t))
        ops["convq"] = op_conv("convq", jnp.concatenate(
            [r * hidden, context, motion], -1), t)
        q = jnp.tanh(captured("convq", t))
        for gate, conv, jf, tf, own in (
                ("z", "convz", jax.nn.sigmoid, sigmoid, torch.sigmoid),
                ("r", "convr", jax.nn.sigmoid, sigmoid, torch.sigmoid),
                ("q", "convq", jnp.tanh, tanh, torch.tanh)):
            c = captured(conv, t)
            want = jax.jit(jf)(c)
            ops[f"gate_{gate}"] = {"port_vs_jax": compare(
                to_numpy(tf(to_torch(c))), want)}
            ops[f"gate_{gate}_torch"] = {"port_vs_jax": compare(
                to_numpy(own(to_torch(c))), want)}
        want = jax.jit(lambda z, h, q: (1.0 - z) * h + z * q)(z, hidden, q)
        with torch.no_grad():
            zt, ht, qt = (to_torch(v) for v in (z, hidden, q))
            got = to_numpy((1.0 - zt) * ht + zt * qt)
        new_hidden = cap["update"]["gru"]["__call__"][t]
        ops["gru_update"] = {"port_vs_jax": compare(got, want),
                             "model_vs_jax": compare(new_hidden, want)}
        ops["flow_head1"] = op_conv("flow_head1", new_hidden, t)
        ops["flow_head2"] = op_conv("flow_head2",
                                    leaky(captured("flow_head1", t)), t)
        for op, res in ops.items():
            rows.append({"seed": seed, "iter": t, "op": op, **res})
        hidden = new_hidden
        hiddens.append(hidden)
        motions.append(motion)
        flow = flow + cap["update"]["__call__"][t][1]
    rows += backward_rows(seed, cfg, params, prep, port, inputs, captured,
                          hiddens, context, motions, ctx, iters,
                          (g1, g2, coords_at))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--no-excess-precision", action="store_true",
                    help="JAX with --xla_allow_excess_precision=false")
    args = ap.parse_args()
    total = {}
    for seed in range(args.seeds):
        for row in run(seed, args.iters):
            print(json.dumps(row), flush=True)
            acc = total.setdefault(row["op"], {})
            for side in ("port_vs_jax", "model_vs_jax"):
                if side in row:
                    acc.setdefault(side, []).append(row[side]["differ"])
    print(json.dumps({"mean_differ": {
        op: {side: float(np.mean(v)) for side, v in acc.items()}
        for op, acc in total.items()}}))


if __name__ == "__main__":
    main()
