"""The reference's default estimator arithmetic in the port
(``models/common.py``: ``fused_dense``, ``conv_over_components``,
``subpixel``, ``depth_to_space``, ``DenseEstimator(fused=...)``,
``ContextNetwork``; ``models/flow.py``'s ``CoarseToFineDecoder``), held
op by op to the JAX package in bf16 on the CPU.

* Each op of a flow decoder at tiny widths, fed the reference's captured
  bf16 inputs (``tests/estimator_pairs.py``): the trunk convs y1..y3 (in
  the fused form each from the reference's components, its predecessors'
  outputs included), the predictor, the up-feature conv after its
  LeakyReLU, and the context network's first conv (after LeakyReLU) and
  last conv, at levels 4..2 (8x8 to 32x32 maps) of a random bf16 feature
  pyramid of a 128x128 frame. Three forms: ``fused=True`` with one
  concatenated input and the stack kept as components (the reference's
  default), ``fused=True`` with the cost volume a component of its own
  and the stack concatenated, and ``fused=False``. Each op differs from
  the reference's in at most 0.5% of elements (two libraries'
  accumulation orders alone differ in 0-0.07%,
  ``scripts/raft_bf16_op_compare.py``). The port decoder's own forward
  hands each estimator and the context network the components the
  reference's does.
* The control: each trunk conv after the first computed as one conv over
  the concatenated stack (the port's arithmetic before the fused form)
  against the fused reference differs in more than 0.5%.
* The DCV flow decoder's estimator, with its two volumes and f1 as
  components, its predictor and context network, within the same bound.
* int8 export of a ``fused=True`` config rebuilds the naive estimators:
  its calibration sees as many conv calls as a ``fused=False`` config's,
  and the int8 forward matches its simulated plain version within 1e-5
  relative L2.

The whole models in float32 at ``fused=False`` are held to the JAX
package within 1e-4 in ``tests/test_torch_single_task.py`` beside the JAX
runs they share; at ``fused=True`` in ``tests/test_torch_model.py``,
``test_torch_dcv.py`` and ``test_torch_single_task.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from cerberusnet_tpu.models.dcv_flow import DCVFlowDecoder as JaxDCVFlow
from cerberusnet_tpu.models.flow import FlowDecoder as JaxFlowDecoder
from cerberusnet_torch.models.dcv_flow import DCVFlowDecoder
from cerberusnet_torch.models.flow import FlowDecoder
from cerberusnet_torch.quant.ptq import quantized_apply
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import load_flax_params
from tests.estimator_pairs import (
    BF16,
    LEVELS,
    capture,
    compare,
    dcv_decoder_ops,
    pwc_decoder_ops,
    to_torch,
    widths,
)
from tests.jax_pairs import draw_params

ENC = (8, 12, 16, 16, 16, 16)
DEC = dict(est_channels=(16, 16, 12), ctx_channels=(16, 16))
SIDE = 128  # the frame whose pyramid the features are
COMPARED = (4, 3, 2)  # the levels of 8x8 maps and more
BOUND = 0.005  # the share of elements an op may differ in
FORMS = {"fused-concat-components": dict(),
         "fused-split-stack": dict(est_input="split",
                                   distribute_outputs=False),
         "naive": dict(fused=False)}


def pyramid(seed=0):
    rng = np.random.RandomState(seed)
    return [jnp.asarray(0.5 * rng.randn(1, SIDE >> l, SIDE >> l, c), BF16)
            for l, c in zip(range(1, 7), ENC)]


def port_decoder(cls, params, **kw):
    dec = load_flax_params(cls(ENC, corr_impl="plain", **kw), params)
    return dec.to(dtype=torch.bfloat16,
                  memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def flow_runs():
    """Per form: the JAX flow decoder's captured calls (bf16, max_disp 1,
    one compile) and the port's decoder of the same parameters."""
    feats, cache = pyramid(), {}

    def get(form):
        if form not in cache:
            jdec = JaxFlowDecoder(max_disp=1, corr_impl="purev", dtype=BF16,
                                  **DEC, **FORMS[form])
            shapes = jax.eval_shape(jdec.init, jax.random.PRNGKey(0), feats,
                                    feats)["params"]
            params = draw_params(shapes, 1)
            _, cap = capture(jdec, params, feats, feats)
            cache[form] = feats, cap, port_decoder(
                FlowDecoder, params, max_disp=1, **DEC, **FORMS[form])
        return cache[form]

    return get


@pytest.mark.parametrize("form", list(FORMS))
def test_decoder_ops_match_jax(flow_runs, form):
    _, cap, dec = flow_runs(form)
    ops = pwc_decoder_ops(cap, (), dec, levels=COMPARED)
    names = {"y1", "y2", "y3", "predictor"}
    assert set(ops[4]) == set(ops[3]) == names | {"upfeat"}
    assert set(ops[2]) == names | {"context_first", "context_out"}
    for level, level_ops in ops.items():
        for op, (got, want) in level_ops.items():
            share = compare(got, want)["differ"]
            assert share <= BOUND, (form, level, op, share)


def test_naive_rounding_exceeds_the_bound(flow_runs):
    """The control: the fused reference's trunk convs y2, y3 as one conv
    over the concatenated stack."""
    _, cap, dec = flow_runs("fused-concat-components")
    ops = pwc_decoder_ops(cap, (), dec, control=True,
                          levels=COMPARED)
    for level, level_ops in ops.items():
        for op in ("naive y2", "naive y3"):
            share = compare(*level_ops[op])["differ"]
            assert share > BOUND, (level, op, share)


@pytest.mark.parametrize("form", list(FORMS))
def test_decoder_hands_on_the_reference_components(flow_runs, form):
    """The port decoder's forward on the same features: each estimator's
    and the context network's input has the reference's components."""
    feats, cap, dec = flow_runs(form)
    got = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: got.append(widths(args[0])))
        for m in [*dec.estimators, dec.context]]
    try:
        with torch.no_grad():
            out = dec([to_torch(f) for f in feats],
                      [to_torch(f) for f in feats])
    finally:
        for h in hooks:
            h.remove()
    want = [widths(cap[(f"DenseEstimator_{i}",)][0][0])
            for i in range(len(LEVELS))]
    want.append(widths(cap[("ContextNetwork_0",)][0][0]))
    assert got == want
    assert torch.isfinite(out["flow"]).all()


def test_dcv_estimator_with_volumes_as_components():
    feats = pyramid(1)
    kw = dict(max_disp=1, dilations=(1, 2), est_channels=(16, 12),
              ctx_channels=(16, 16))
    jdec = JaxDCVFlow(corr_impl="purev", dtype=BF16, **kw)
    shapes = jax.eval_shape(jdec.init, jax.random.PRNGKey(0), feats,
                            feats)["params"]
    params = draw_params(shapes, 2)
    _, cap = capture(jdec, params, feats, feats)
    args = cap[("DenseEstimator_0",)][0][0]
    assert widths(args) == [9, 9, ENC[2]]  # two volumes and f1
    ops = dcv_decoder_ops(cap, (),
                          port_decoder(DCVFlowDecoder, params, **kw))
    assert set(ops) == {"y1", "y2", "predictor", "context_first",
                        "context_out"}
    for op, (got, want) in ops.items():
        share = compare(got, want)["differ"]
        assert share <= BOUND, (op, share)


def tiny_config(fused: bool) -> ExperimentConfig:
    return ExperimentConfig.from_dict({
        "name": "tiny-int8",
        "model": {"variant": "cerberus", "fused": fused, "fpn_channels": 16,
                  "encoder_channels": list(ENC),
                  **{k: list(v) for k, v in DEC.items()}},
        "data": {"dataset": "synthetic", "hw": [64, 64], "batch_size": 1,
                 "num_workers": 1, "synthetic_length": 2},
        "optim": {"schedule": "constant"},
        "train": {"num_data_devices": 1}})


def test_int8_export_calibrates_every_conv_of_the_naive_form():
    calls, models = {}, {}
    for fused in (True, False):
        seen = []
        hook = nn.modules.module.register_module_forward_pre_hook(
            lambda m, args: seen.append(m) if isinstance(m, nn.Conv2d)
            else None)
        try:
            model = Trainer(tiny_config(fused), device="cpu").deploy_model(
                quant="int8")
        finally:
            hook.remove()
        calls[fused], models[fused] = len(seen), model
        assert not any(e.fused for e in model.flow.estimators)
    assert calls[True] == calls[False] > 0
    batch = tuple(torch.from_numpy(np.random.RandomState(3).rand(
        1, 64, 64, 3).astype(np.float32)) for _ in range(3))
    with torch.no_grad():
        out = quantized_apply(models[True], *batch)
        sim = quantized_apply(models[True], *batch, simulate=True)
    for head in ("seg_logits", "flow", "disp"):
        err = torch.linalg.norm(out[head] - sim[head]) / torch.linalg.norm(
            sim[head])
        assert err <= 1e-5, (head, float(err))
