#!/usr/bin/env python3
"""Where the port's bf16 PWC, DCV and segmentation heads round otherwise
than the JAX package: each op of the estimators, their predictors, the
up-feature convs, the context networks and the segmentation heads, fed
the same inputs in both packages on the CPU; and how far the whole
CerberusNet's bf16 outputs sit from each other and from float32.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/pwc_bf16_op_compare.py [--hw 512 1024] [--end-to-end-hw 64 128] [--skip-ops]

Default widths, random float32 parameters drawn from ``--params-seed`` (3)
as the port's tests draw them (``tests/jax_pairs.py``), frames of uniform
noise from ``--frames-seed`` (2), ``corr_impl="pure"``.

Ops (``--hw``, the served 512x1024 by default): JAX's bf16 CerberusNet
(FPN head) and CerberusDCV (ASPP head) run once each, jitted, at the
reference's default arithmetic (``fused=True``: ``est_input="concat"``,
``distribute_outputs=True``, ``upfeat_impl="subpixel"``) and at
``fused=False``, with the calls of their estimators, convs and heads
captured. Each op of the port then runs alone on JAX's captured inputs
(``tests/estimator_pairs.py``) and is held to JAX's captured output: the
trunk convs y1..y5 (the fused form from the reference's components, its
predecessors' outputs included), the predictor, the up-feature conv after
LeakyReLU (``upfeat_vs_convt``: against the reference's other lowering,
``conv_transpose_over_components``, run alone; ``subpixel_vs_convt``: the
reference's two lowerings against each other), the context network's
first conv after LeakyReLU and its last conv; ``naive y<k>`` (the fused
form only) is each trunk conv computed as one conv over the concatenated
stack, the port's arithmetic before it followed the fused form; the flow
estimate's x2 upsampling in both ``upsample_impl`` forms, each against
JAX's run alone; the FPN laterals, top-down sums, classifier and final
resize, the ASPP head's image mean, 1x1s, projection resize beside the
skip, classifier and final resize. One JSON line an op: the share of
elements that differ and the largest difference in bf16 units in the
last place of the larger value (``tests/estimator_pairs.py``'s
``compare``; the classifier and the final resize are float32, where
``differ`` counts any difference; ``hw`` is the op's map). A ``summary``
line gives each op's largest share over the levels, and ``within``
whether every bf16 op of the port but the naive control is within 0.5%.

End to end (``--end-to-end-hw``, 64x128 by default): relative L2
distances, with the share of elements that differ, between JAX's float32
CerberusNet, its bf16 one at the default and at ``fused=False``, and the
port's bf16 ones at the same two settings, for flow, flow_pyramid[6],
disp and seg_logits. Run from a checkout whose port lacks the ``fused``
argument, it measures the port's one form against them (the ops need
this checkout's port).

A measurement for the port's record (ROADMAP C16), not a test.
"""

from __future__ import annotations

import argparse
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.dcv_flow import CerberusDCV
from cerberusnet_torch.weights import load_flax_params
from cerberusnet_tpu.models import CerberusDCV as JaxCerberusDCV
from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from tests.jax_pairs import draw_params

BF16 = jnp.bfloat16
FORMS = {"default": {}, "unfused": {"fused": False}}
BOUND = 0.005
E2E_KEYS = ("flow", "flow_pyramid[6]", "disp", "seg_logits")


def frames(hw, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(1, *hw, 3).astype(np.float32) for _ in range(3)]


def params_of(model, imgs, seed):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(i) for i in imgs])["params"]
    return draw_params(shapes, seed)


def port_model(cls, params, dtype, **kw):
    model = cls(dtype=dtype, **kw)
    load_flax_params(model, params)
    return model.eval()


def flat(out) -> dict:
    res = {}
    for key, v in out.items():
        for level, x in (v.items() if isinstance(v, dict) else [(None, v)]):
            res[key if level is None else f"{key}[{level}]"] = (
                x.detach().float().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(jnp.asarray(x, jnp.float32)))
    return res


def op_rows(args):
    """One dict an (model, form, part, level, op)."""
    from cerberusnet_tpu.models.common import (
        conv_transpose_over_components, upsample2x as jax_up2)
    from cerberusnet_torch.models.common import upsample2x
    from tests import estimator_pairs as ep

    hw = tuple(args.hw)
    imgs = frames(hw, args.frames_seed)
    rows = []
    for name, jcls, pcls, kw in (
            ("CerberusNet", JaxCerberusNet, CerberusNet, {}),
            ("CerberusDCV", JaxCerberusDCV, CerberusDCV,
             {"seg_head": "aspp"})):
        params = params_of(jcls(corr_impl="pure", **kw), imgs,
                           args.params_seed)
        for form, knobs in FORMS.items():
            jm = jcls(corr_impl="pure", dtype=BF16, **kw, **knobs)
            out, cap = ep.capture(jm, params, *[jnp.asarray(i)
                                                for i in imgs])
            port = port_model(pcls, params, torch.bfloat16, corr_impl="plain",
                              **kw, **knobs)
            parts = {}
            if name == "CerberusNet":
                for dec_name, dec in (("FlowDecoder_0", port.flow),
                                      ("DisparityDecoder_0",
                                       port.disparity)):
                    convt = (conv_transpose_over_components,
                             params[dec_name]) if form == "default" else None
                    for level, ops in ep.pwc_decoder_ops(
                            cap, (dec_name,), dec, control=form == "default",
                            convt=convt).items():
                        parts[dec_name, level] = ops
                parts["SegmentationHead_0", None] = ep.fpn_ops(
                    cap, port.segmentation)
                parts["FlowDecoder_0", "upsample"] = upsample_ops(
                    out["flow_pyramid"], jax_up2, upsample2x, ep)
            else:
                for dec_name, dec in (("DCVFlowDecoder_0", port.flow),
                                      ("DCVStereoDecoder_0",
                                       port.disparity)):
                    parts[dec_name, 3] = ep.dcv_decoder_ops(
                        cap, (dec_name,), dec, control=form == "default")
                parts["ASPPSegmentationHead_0", None] = ep.aspp_ops(
                    cap, port.segmentation)
            for (part, level), ops in parts.items():
                for op, (got, want) in ops.items():
                    rows.append({"model": name, "form": form, "part": part,
                                 "level": level, "op": op,
                                 "hw": list(got.shape[1:3]),
                                 **ep.compare(got, want)})
    return rows


def upsample_ops(pyramid, jax_up2, port_up2, ep):
    """2 x upsample2x of the flow estimate of each level but the last, in
    both forms, JAX's run alone against the port's."""
    ops = {}
    for level in (6, 5, 4, 3):
        x = pyramid[level]
        for impl in ("resize", "phase"):
            want = jax.jit(lambda v: 2.0 * jax_up2(v, impl=impl))(x)
            with torch.no_grad():
                got = 2.0 * port_up2(ep.to_torch(x), impl=impl)
            ops[f"upsample_{impl}_{level}"] = (ep.to_numpy(got), ep.ref(want))
    return ops


def summary(rows) -> dict:
    worst = {}
    for r in rows:
        key = f"{r['model']}/{r['form']}/{r['part']}/{r['op']}"
        worst[key] = max(worst.get(key, 0.0), r["differ"])
    # the control, the reference against itself, and the float32 ops
    skip = ("naive", "subpixel_vs_convt", "/classifier", "/resize")
    within = all(v <= BOUND for k, v in worst.items()
                 if not any(m in k for m in skip))
    return {"summary": worst, "within": within, "bound": BOUND}


def end_to_end(args):
    """{key: {pair: (relative L2, share differing)}} at the end-to-end
    size."""
    hw = tuple(args.end_to_end_hw)
    imgs = frames(hw, args.frames_seed)
    jin = [jnp.asarray(i) for i in imgs]
    params = params_of(JaxCerberusNet(corr_impl="pure"), imgs,
                       args.params_seed)

    def jax_run(**kw):
        m = JaxCerberusNet(corr_impl="pure", **kw)
        return flat(jax.jit(lambda p, *x: m.apply({"params": p}, *x))(
            params, *jin))

    def port_run(**kw):
        m = port_model(CerberusNet, params, torch.bfloat16,
                       corr_impl="plain", **kw)
        with torch.no_grad():
            return flat(m(*[torch.from_numpy(i) for i in imgs]))

    runs = {"jax_f32": jax_run(), "jax_bf16": jax_run(dtype=BF16),
            "jax_bf16_unfused": jax_run(dtype=BF16, fused=False),
            "port_bf16": port_run()}
    if "fused" in inspect.signature(CerberusNet).parameters:
        runs["port_bf16_unfused"] = port_run(fused=False)
    pairs = [("jax_bf16", "jax_f32"), ("port_bf16", "jax_f32"),
             ("port_bf16", "jax_bf16"), ("port_bf16", "jax_bf16_unfused")]
    if "port_bf16_unfused" in runs:
        pairs.append(("port_bf16_unfused", "jax_bf16_unfused"))
    res = {}
    for key in E2E_KEYS:
        res[key] = {}
        for a, b in pairs:
            x, y = runs[a][key].astype(np.float64), runs[b][key].astype(
                np.float64)
            res[key][f"{a} vs {b}"] = (
                float(np.linalg.norm(x - y) / np.linalg.norm(y)),
                float((x != y).mean()))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--end-to-end-hw", type=int, nargs=2, default=(64, 128))
    ap.add_argument("--params-seed", type=int, default=3)
    ap.add_argument("--frames-seed", type=int, default=2)
    ap.add_argument("--skip-ops", action="store_true",
                    help="the end-to-end distances alone")
    args = ap.parse_args()
    torch.set_num_threads(min(torch.get_num_threads(), 8))
    print(json.dumps({"end_to_end": end_to_end(args),
                      "hw": list(args.end_to_end_hw)}), flush=True)
    if args.skip_ops:
        return
    rows = op_rows(args)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps(summary(rows)))


if __name__ == "__main__":
    main()
