"""The port's RAFT family (cerberusnet_torch.models.raft) and its sequence
loss against the JAX package, on the CPU.

* The ops at float32 within 1e-5 relative (of the largest magnitude):
  ``allpairs_correlation`` (also on bf16 features, whose volume both
  packages accumulate in float32) and its 1-D form, the pyramids at odd
  extents, both lookups of both dimensions against JAX's same ``impl`` at
  integer positions, a spread of 2.5 and one of 50 (mostly outside the
  frame), ``base_grid`` and ``convex_upsample``; the port's onehot lookup
  against its gather one as ``tests/test_raft.py`` holds JAX's.
* ``RAFTFlowNet``, ``RAFTStereoNet`` and ``CerberusRAFT`` at tiny widths
  (encoder (8, 12, 16, 16, 16, 16), fdim/hdim/cdim 16/16/8, 3 iterations,
  64x64), loaded from random flax parameters with ``load_flax_params``,
  against the JAX models in their scan and unrolled forms with both
  lookups: every output, pyramid and iterate within 1e-5 of the largest
  JAX magnitude in float32; in bfloat16 within twice JAX's own bf16
  distance from its float32 output plus 1e-3 (the same relative measure;
  the two packages round their bf16 convolutions apart, so their bf16
  outputs sit as far from each other as from float32).
* ``raft_sequence_loss`` (levels 3 and 4, dense and sparse ground truth)
  and ``joint_loss`` with iterates: values within 1e-6 relative, input
  gradients within 1e-5 relative L2.
* One train step of a tiny ``cerberus_raft`` experiment (one-cycle
  schedule) against the JAX ``Trainer``'s from the same weights and batch:
  loss components within 1e-5 relative, every updated master within 1e-4
  relative L2.
* One bf16 step of that experiment (SGD, which gives the gradients back)
  against the JAX Trainer's bf16 and float32 steps: loss components within
  twice JAX's bf16 distance from float32 plus 1e-5 relative; the whole
  gradient's distance from float32 within twice JAX's plus 1e-3, and each
  module's within 1.5 times JAX's farthest module (see the test for why);
  the tied kernels' gradients float32 sums of bf16 terms, as flax's.
* trace_forward's RAFT stages on a CPU profile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.data.synthetic import (
    SyntheticPerceptionDataset as JaxSynthetic,
)
from cerberusnet_tpu.data.loader import collate as jax_collate
from cerberusnet_tpu.models import raft as jr
from cerberusnet_tpu.train import losses as jl
from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
from cerberusnet_tpu.train.trainer import Trainer as JaxTrainer
from cerberusnet_torch.entry import entry
from cerberusnet_torch.models import raft as tr
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train import losses as tl
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import load_flax_params
from tests.jax_pairs import RAFT_HW as HW
from tests.jax_pairs import TINY_RAFT as TINY
from tests.jax_pairs import (
    draw_params,
    numpy_tree,
    port_masters,
    raft_config_dict,
)
from tests.test_torch_train import rel

F32_RTOL = 1e-5
LOOKUPS = ("gather", "onehot")


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def assert_rel_max(got, want, tol=F32_RTOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: relative max error {err} > {tol}"


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["2d", "1d"])
def test_allpairs_correlation_matches_jax(op, dtype):
    rng = np.random.RandomState(0)
    f1, f2 = (rng.randn(2, 5, 7, 24).astype(np.float32) for _ in range(2))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jfn, tfn = ((jr.allpairs_correlation, tr.allpairs_correlation)
                if op == "2d" else
                (jr.allpairs_correlation_1d, tr.allpairs_correlation_1d))
    want = jfn(jnp.asarray(f1, jdt), jnp.asarray(f2, jdt))
    got = tfn(t(f1, tdt), t(f2, tdt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_rel_max(got.numpy(), want, what=f"{op} {dtype}")


@pytest.mark.parametrize("op", ["2d", "1d"])
def test_correlation_pyramid_matches_jax(op):
    rng = np.random.RandomState(1)
    # odd extents: "VALID" pooling drops the last row and column
    shape = (2, 35, 5, 7) if op == "2d" else (2, 35, 11)
    corr = rng.randn(*shape).astype(np.float32)
    jfn, tfn = ((jr.correlation_pyramid, tr.correlation_pyramid)
                if op == "2d" else
                (jr.correlation_pyramid_1d, tr.correlation_pyramid_1d))
    want = jfn(jnp.asarray(corr), 3)
    got = tfn(t(corr), 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_rel_max(g.numpy(), w, what=op)


def lookup_inputs(op, spread, seed=2):
    """A 3-level pyramid of a (1, 4, 5) query grid and sample positions
    around the base grid: integer ones (spread 0) or uniform within
    +-spread."""
    rng = np.random.RandomState(seed)
    b, h, w = 1, 4, 5
    if op == "2d":
        corr = rng.randn(b, h * w, h, w).astype(np.float32)
        pos = np.asarray(jr.base_grid(b, h, w))
    else:
        corr = rng.randn(b, h * w, w).astype(np.float32)
        pos = np.broadcast_to(np.arange(w, dtype=np.float32), (b, h, w))
    if spread:
        pos = pos + rng.uniform(-spread, spread, pos.shape)
    return corr, pos.astype(np.float32)


def lookup_pair(op, impl, corr, pos, radius):
    """(JAX's lookup, the port's) on the same pyramid and positions."""
    if op == "2d":
        want = jr.corr_lookup(jr.correlation_pyramid(jnp.asarray(corr), 3),
                              jnp.asarray(pos), radius, impl=impl)
        got = tr.corr_lookup(tr.correlation_pyramid(t(corr), 3), t(pos),
                             radius, impl=impl)
    else:
        want = jr.corr_lookup_1d(
            jr.correlation_pyramid_1d(jnp.asarray(corr), 3),
            jnp.asarray(pos), radius, impl=impl)
        got = tr.corr_lookup_1d(tr.correlation_pyramid_1d(t(corr), 3),
                                t(pos), radius, impl=impl)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("spread", [0.0, 2.5, 50.0])
@pytest.mark.parametrize("impl", LOOKUPS)
@pytest.mark.parametrize("op", ["2d", "1d"])
def test_lookup_matches_jax(op, impl, spread):
    corr, pos = lookup_inputs(op, spread)
    got, want = lookup_pair(op, impl, corr, pos, radius=2)
    p = 5 if op == "2d" else 1
    assert got.shape == (1, 4, 5, 3 * 5 * p)
    if spread == 50.0:  # most windows lie outside the frame: zeros
        assert (want == 0).mean() > 0.5
    assert_rel_max(got, want, what=f"{op} {impl} spread {spread}")


@pytest.mark.parametrize("impl", LOOKUPS)
@pytest.mark.parametrize("op", ["2d", "1d"])
def test_empty_volume_level_reads_zero_as_jax(op, impl):
    """A 4x4 latent with 4 volume levels: "VALID" pooling leaves the fourth
    level (of 4, 2, 1 and then 0 cells along each pooled extent) empty,
    which both packages' lookups read as zero features."""
    rng = np.random.RandomState(4)
    b, h, w, radius, levels = 1, 4, 4, 4, 4
    if op == "2d":
        corr = rng.randn(b, h * w, h, w).astype(np.float32)
        pos = np.asarray(jr.base_grid(b, h, w))
        jpyr, jlook = jr.correlation_pyramid, jr.corr_lookup
        tpyr, tlook = tr.correlation_pyramid, tr.corr_lookup
    else:
        corr = rng.randn(b, h * w, w).astype(np.float32)
        pos = np.broadcast_to(np.arange(w, dtype=np.float32), (b, h, w))
        jpyr, jlook = jr.correlation_pyramid_1d, jr.corr_lookup_1d
        tpyr, tlook = tr.correlation_pyramid_1d, tr.corr_lookup_1d
    pos = (pos + rng.uniform(-2.5, 2.5, pos.shape)).astype(np.float32)
    pyr = tpyr(t(corr), levels)
    assert [v.shape[2:] for v in pyr][-1] == ((0, 0) if op == "2d" else (0,))
    want = np.asarray(jlook(jpyr(jnp.asarray(corr), levels), jnp.asarray(pos),
                            radius, impl=impl))
    got = tlook(pyr, t(pos), radius, impl=impl).numpy()
    window = (2 * radius + 1) ** (2 if op == "2d" else 1)
    assert got.shape == want.shape == (b, h, w, levels * window)
    assert np.isfinite(want).all()
    assert not got[..., 3 * window:].any() and not want[..., 3 * window:].any()
    assert_rel_max(got, want, what=f"{op} {impl}")


@pytest.mark.parametrize("spread", [2.5, 50.0])
@pytest.mark.parametrize("op", ["2d", "1d"])
def test_port_onehot_equals_gather(op, spread):
    corr, pos = lookup_inputs(op, spread, seed=7)
    fn = tr.corr_lookup if op == "2d" else tr.corr_lookup_1d
    pyr = (tr.correlation_pyramid if op == "2d"
           else tr.correlation_pyramid_1d)(t(corr), 3)
    got = fn(pyr, t(pos), 3, impl="onehot").numpy()
    want = fn(pyr, t(pos), 3, impl="gather").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_unknown_lookup_raises():
    corr, pos = lookup_inputs("2d", 1.0)
    with pytest.raises(ValueError, match="'gather' or 'onehot'"):
        tr.corr_lookup(tr.correlation_pyramid(t(corr), 2), t(pos), 1,
                       impl="one-hot")
    corr, pos = lookup_inputs("1d", 1.0)
    with pytest.raises(ValueError, match="'gather' or 'onehot'"):
        tr.corr_lookup_1d([t(corr)], t(pos), 1, impl="scatter")
    with pytest.raises(ValueError, match="'gather' or 'onehot'"):
        tr.RAFTFlowDecoder(lookup_impl="onehot ")


@pytest.mark.parametrize("factor,channels", [(2, 2), (8, 1)])
def test_base_grid_and_convex_upsample_match_jax(factor, channels):
    np.testing.assert_array_equal(tr.base_grid(2, 3, 5).numpy(),
                                  np.asarray(jr.base_grid(2, 3, 5)))
    rng = np.random.RandomState(3)
    flow = rng.randn(2, 3, 5, channels).astype(np.float32)
    mask = 3 * rng.randn(2, 3, 5, factor * factor * 9).astype(np.float32)
    want = jr.convex_upsample(jnp.asarray(flow), jnp.asarray(mask), factor)
    got = tr.convex_upsample(t(flow), t(mask), factor)
    assert got.dtype == torch.float32
    assert_rel_max(got.numpy(), want, what=f"factor {factor}")
    # a bf16 mask is softmaxed in float32
    want16 = jr.convex_upsample(jnp.asarray(flow),
                                jnp.asarray(mask, jnp.bfloat16), factor)
    got16 = tr.convex_upsample(t(flow), t(mask, torch.bfloat16), factor)
    assert_rel_max(got16.numpy(), want16, what="bf16 mask")


# --------------------------------------------------------------- models


def frames(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.rand(1, *HW, 3).astype(np.float32) for _ in range(n)]


def random_params(model, imgs, seed):
    """A flax param tree for ``model`` with numpy values drawn at realistic
    scales (kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.01))."""
    return draw_params(jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        *[jnp.asarray(i) for i in imgs])["params"], seed)


def flat(out):
    """Output dict -> {name: float32 numpy array}, pyramids by level."""
    res = {}
    for key, v in out.items():
        for level, x in (v.items() if isinstance(v, dict) else [(None, v)]):
            name = key if level is None else f"{key}[{level}]"
            res[name] = (x.detach().float().numpy()
                         if isinstance(x, torch.Tensor)
                         else np.asarray(x, np.float32))
    return res


# name: (frames it takes, extra keywords, output keys)
MODELS = {
    "RAFTFlowNet": (2, {}, ["flow", "flow_iterates", "flow_pyramid[3]"]),
    "RAFTStereoNet": (2, {}, ["disp", "disp_iterates", "disp_pyramid[3]"]),
    "CerberusRAFT": (3, {"fpn_channels": 16},
                     ["disp", "disp_iterates", "disp_pyramid[3]", "flow",
                      "flow_iterates", "flow_pyramid[3]", "seg_logits"]),
}
FORMS = {"scan": False, "unrolled": True}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def model_params(name):
    """Random flax parameters for ``name``: their tree is the same in
    every type, so one draw serves both."""
    n, extra, _ = MODELS[name]
    return random_params(getattr(jr, name)(**TINY, **extra),
                         frames(1, n), 2)


def jax_reference(name, dtype):
    """``model_params(name)`` and the JAX model's outputs on ``frames(1,
    n)`` in ``dtype``, in both forms with both lookups: one compile for the
    four."""
    n, extra, _ = MODELS[name]
    imgs = [jnp.asarray(i) for i in frames(1, n)]
    models = {(form, impl): getattr(jr, name)(
        unroll_iters=unroll, lookup_impl=impl, dtype=DTYPES[dtype][0],
        **TINY, **extra) for form, unroll in FORMS.items() for impl in LOOKUPS}
    params = model_params(name)
    run = jax.jit(lambda p, *x: {k: m.apply({"params": p}, *x)
                                 for k, m in models.items()})
    return params, {k: flat(v) for k, v in run(params, *imgs).items()}


@pytest.fixture(scope="module")
def reference():
    """jax_reference, computed once per (model, dtype) for the module."""
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            cache[name, dtype] = jax_reference(name, dtype)
        return cache[name, dtype]
    return get


def port_model(name, dtype, impl):
    _, extra, _ = MODELS[name]
    return getattr(tr, name)(lookup_impl=impl, dtype=DTYPES[dtype][1],
                             **TINY, **extra).eval()


@pytest.mark.parametrize("impl", LOOKUPS)
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(reference, name, dtype, form, impl):
    n, _, keys = MODELS[name]
    params, outs = reference(name, dtype)
    want = outs[form, impl]
    port = load_flax_params(port_model(name, dtype, impl), params)
    with torch.no_grad():
        got = flat(port(*[torch.from_numpy(i) for i in frames(1, n)]))
    assert sorted(got) == sorted(want) == keys
    assert want["flow_iterates" if "flow" in want else "disp_iterates"
                ].shape[0] == TINY["iters"]
    f32 = reference(name, "float32")[1][form, impl]
    for key in keys:
        scale = np.abs(f32[key]).max()
        assert scale > 1e-2, (key, scale)  # the weights' scale shows
        err = np.abs(got[key] - want[key]).max() / scale
        if dtype == "float32":
            tol = F32_RTOL
        else:  # JAX's own bf16 spread from float32, twice, plus 1e-3
            tol = 2 * np.abs(want[key] - f32[key]).max() / scale + 1e-3
        assert err <= tol, f"{name} {dtype} {form} {impl} {key}: {err} > {tol}"


# --------------------------------------------------------------- losses


def sequence_inputs(sparse, level, seed=4):
    rng = np.random.RandomState(seed)
    b, h, w = 2, 32, 48
    valid = ((rng.rand(b, h, w) < 0.3) if sparse
             else np.ones((b, h, w))).astype(np.float32)
    iterates = rng.randn(5, b, h >> level, w >> level, 2).astype(np.float32)
    gt = (rng.randn(b, h, w, 2) * 8 * valid[..., None]).astype(np.float32)
    return iterates, gt, valid


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("level", [3, 4])
def test_raft_sequence_loss_matches_jax(level, sparse):
    iterates, gt, valid = sequence_inputs(sparse, level)
    for g, w in zip(tl.gt_pyramid(t(gt), t(valid), (level,), True)[level],
                    jl.downsample_gt(jnp.asarray(gt), jnp.asarray(valid),
                                     level, True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)

    def jax_loss(it):
        return jl.raft_sequence_loss(it, jnp.asarray(gt), jnp.asarray(valid),
                                     level=level, gamma=0.7)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(iterates))
    it = t(iterates).requires_grad_()
    got = tl.raft_sequence_loss(it, t(gt), t(valid), level=level, gamma=0.7)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    got.backward()
    assert rel(it.grad.numpy(), want_grad) <= 1e-5


@pytest.mark.parametrize("sparse", [False, True])
def test_joint_loss_with_iterates_matches_jax(sparse):
    """The sequence terms replace the multi-scale ones for a RAFT model's
    outputs; segmentation is unchanged."""
    rng = np.random.RandomState(5)
    flow_it, flow_gt, valid = sequence_inputs(sparse, 3, seed=5)
    disp_it = np.abs(rng.randn(5, 2, 4, 6, 1)).astype(np.float32)
    out = {"seg_logits": rng.randn(2, 32, 48, 5).astype(np.float32),
           "flow_iterates": flow_it, "flow_pyramid": {3: flow_it[-1]},
           "disp_iterates": disp_it, "disp_pyramid": {3: disp_it[-1]}}
    labels = rng.randint(0, 5, (2, 32, 48)).astype(np.int32)
    batch = {"seg_labels": labels, "flow_gt": flow_gt, "flow_valid": valid,
             "disp_gt": (rng.rand(2, 32, 48) * 20 * valid).astype(np.float32),
             "disp_valid": valid}
    weights = {"seg": 1.0, "flow": 0.5, "disp": 2.0}

    def jax_total(o):
        return jl.joint_loss(o, jax.tree.map(jnp.asarray, batch),
                             weights=weights, seq_gamma=0.8)

    (_, jcomps), jgrads = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, out))
    tout = jax.tree.map(lambda a: t(a).requires_grad_(), out)
    tbatch = {k: torch.from_numpy(v).long() if k == "seg_labels" else t(v)
              for k, v in batch.items()}
    total, comps = tl.joint_loss(tout, tbatch, weights=weights,
                                 seq_gamma=0.8)
    assert sorted(comps) == sorted(jcomps) == ["disp", "flow", "seg",
                                               "total"]
    for k, v in jcomps.items():
        assert float(comps[k]) == pytest.approx(float(v), rel=1e-6), k
    total.backward()
    for key in ("flow_iterates", "disp_iterates", "seg_logits"):
        assert rel(tout[key].grad.numpy(), jgrads[key]) <= 1e-5, key
    # the pyramids feed nothing: the iterates carry the loss
    assert tout["flow_pyramid"][3].grad is None
    assert tout["disp_pyramid"][3].grad is None


# ------------------------------------------------ one train step vs JAX


@pytest.fixture(scope="module")
def raft_step():
    """One train step of the tiny experiment in the JAX Trainer and in the
    port's from the same random weights (flax's initial biases are zero,
    and AdamW's first update is +-lr wherever a gradient is not zero, so
    near-zero gradients would take their sign from rounding), on the same
    batch: (the JAX Trainer's initial tree, JAX comps, JAX masters after,
    port comps, port trainer)."""
    jt = JaxTrainer(JaxConfig.from_dict(raft_config_dict()))
    init_tree = numpy_tree(jt.state.params)
    init = draw_params(jt.state.params, 6)
    jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, init))
    ds = JaxSynthetic(length=2, hw=HW, num_classes=19)
    batch = jax_collate([ds[0], ds[1]])
    jcomps = {k: float(v) for k, v in jt.train_step(batch).items()}
    after = numpy_tree(jt.state.params)
    port = Trainer(ExperimentConfig.from_dict(raft_config_dict()),
                   device="cpu")
    port.load_masters(port_masters(port.config, init))
    comps = {k: float(v) for k, v in port.train_step(batch).items()}
    return init_tree, jcomps, port_masters(port.config, after), comps, port


def test_param_names_match_a_jax_init_tree(raft_step):
    """The port's names against the JAX Trainer's tree, a real
    ``jax.jit(model.init)`` of the scanned CerberusRAFT, which has the
    unrolled one's structure: every port parameter filled and every flax
    leaf used; a missing part raises."""
    params = raft_step[0]
    unrolled = jax.eval_shape(
        jr.CerberusRAFT(unroll_iters=True, fpn_channels=16, **TINY).init,
        jax.random.PRNGKey(0), *[jnp.asarray(i) for i in frames(0, 3)])
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(unrolled["params"]))
    dec = params["RAFTFlowDecoder_0"]
    assert sorted(dec) == ["context_proj", "corr_proj", "update"]
    assert sorted(dec["update"]) == ["flow_head1", "flow_head2", "gru",
                                     "mask_head1", "mask_head2", "motion"]
    port = load_flax_params(tr.CerberusRAFT(fpn_channels=16, **TINY), params)
    n_flax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_flax
    dec = dict(dec)
    dec["update"] = {k: v for k, v in dec["update"].items() if k != "gru"}
    with pytest.raises(KeyError):
        load_flax_params(tr.CerberusRAFT(fpn_channels=16, **TINY),
                         {**params, "RAFTFlowDecoder_0": dec})


def test_train_step_losses_match_jax(raft_step):
    _, want, _, got, _ = raft_step
    assert sorted(got) == sorted(want) == ["disp", "flow", "seg", "total"]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k


def test_train_step_masters_match_jax(raft_step):
    _, _, want, _, port = raft_step
    assert sorted(port.masters) == sorted(want)
    assert any(n.startswith("flow.update.gru.") for n in want)
    for name, m in port.masters.items():
        assert rel(m.numpy(), want[name].numpy()) <= 1e-4, name


# ------------------------------------------- one bf16 train step vs JAX

# SGD's first step is p1 = p0 - lr g (the momentum trace starts at g); at
# lr 1024 the float32 p1 holds g to about 2^-24 |p0| / 1024, far below a
# bf16 gradient's spread
SGD_LR = 1024.0
# the weights a decoder uses more than once: corr_proj on both frames, the
# update block at every iteration
TIED = (".corr_proj.", ".update.")


def module_of(name):
    """A gradient's module, its name's first three parts, as chip_smoke.py's
    train_raft groups them (flow.update.gru, encoder.blocks.3, ...)."""
    return ".".join(name.split(".")[:3])


@pytest.fixture(scope="module")
def raft_bf16_step():
    """One SGD step of the tiny experiment in bf16 and in float32 in the
    JAX Trainer, from raft_step's weights and batch, each step's gradients
    read back from it; and the port's bf16 and float32 gradients and loss
    components from the same weights and batch. {(package, dtype): (loss
    components, {port name: float64 gradient})}."""
    ds = JaxSynthetic(length=2, hw=HW, num_classes=19)
    batch = jax_collate([ds[0], ds[1]])
    out = {}
    for dtype in ("bfloat16", "float32"):
        raw = raft_config_dict()
        raw["model"]["dtype"] = dtype
        raw["optim"] = {"optimizer": "sgd", "lr": SGD_LR,
                        "schedule": "constant", "grad_clip": 0.0}
        jt = JaxTrainer(JaxConfig.from_dict(raw))
        init = draw_params(jt.state.params, 6)
        jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, init))
        comps = {k: float(v) for k, v in jt.train_step(batch).items()}
        port = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
        p0 = port_masters(port.config, init)
        p1 = port_masters(port.config, numpy_tree(jt.state.params))
        out["jax", dtype] = comps, {
            n: (p0[n].double() - p1[n].double()).numpy() / SGD_LR for n in p0}
        port.load_masters(p0)
        comps, grads = port.loss_and_grads(batch)
        out["port", dtype] = ({k: float(v) for k, v in comps.items()},
                              {n: g.double().numpy() for n, g in grads.items()})
    return out


def test_bf16_train_step_losses_match_jax(raft_bf16_step):
    """Each loss component of the port's bf16 step within twice JAX's own
    bf16 distance from its float32 value, plus 1e-5 relative."""
    jax16, jax32 = raft_bf16_step["jax", "bfloat16"][0], raft_bf16_step[
        "jax", "float32"][0]
    port16 = raft_bf16_step["port", "bfloat16"][0]
    assert sorted(port16) == sorted(jax16) == ["disp", "flow", "seg", "total"]
    for k, v in jax16.items():
        tol = 2 * abs(v - jax32[k]) + 1e-5 * abs(jax32[k])
        assert abs(port16[k] - v) <= tol, (k, port16[k], v, tol)


def test_bf16_train_step_gradients_match_jax(raft_bf16_step):
    """The port's bf16 gradients against the float32 ones, beside JAX's
    bf16 gradients against its float32 ones (relative L2; the float32
    gradients of the two packages agree to 1e-5 here). Whole, the port's
    stands within twice JAX's distance plus 1e-3. By module (module_of;
    the mask heads, whose gradients are zero in every run, left out), no
    module of the port's stands further than 1.5 times JAX's own farthest
    module in this step. At 64x64 a module's weight gradient is a sum over
    few pixels that often cancels, and it magnifies its terms' rounding by
    its condition number: single modules of either package read 0.1-0.4
    (scripts/raft_bf16_grad_spread.py), so a module's bound is the
    reference's own worst; a lost gradient path reads 1."""
    j16, j32 = (raft_bf16_step["jax", d][1] for d in ("bfloat16", "float32"))
    p16, p32 = (raft_bf16_step["port", d][1] for d in ("bfloat16", "float32"))
    assert sorted(p16) == sorted(j16) == sorted(p32) == sorted(j32)

    def cat(g, names):
        return np.concatenate([g[n].ravel() for n in names])

    names = sorted(j32)
    assert rel(cat(p32, names), cat(j32, names)) <= 1e-5
    whole = {"jax": rel(cat(j16, names), cat(j32, names)),
             "port": rel(cat(p16, names), cat(j32, names))}
    assert whole["port"] <= 2 * whole["jax"] + 1e-3, whole
    modules = {}
    for mod in sorted({module_of(n) for n in names}):
        members = [n for n in names if module_of(n) == mod]
        if not np.any(cat(j32, members)):
            assert ".mask_head" in mod and not np.any(cat(p16, members))
            continue
        modules[mod] = (rel(cat(j16, members), cat(j32, members)),
                        rel(cat(p16, members), cat(j32, members)))
    assert len(modules) == 46
    limit = 1.5 * max(j for j, _ in modules.values())
    far = {m: r for m, r in modules.items() if not r[1] <= limit}
    assert not far, (limit, far)


@pytest.fixture(scope="module")
def raft_bf16_grads_step(raft_bf16_step):
    """raft_bf16_step's SGD step with ``optim.grads_dtype="bfloat16"`` on
    the bf16 model, in the JAX Trainer (the gradients of bf16 casts of its
    float32 leaves) and in the port: {package: {port name: float64
    gradient}}, beside raft_bf16_step's float32 gradients."""
    ds = JaxSynthetic(length=2, hw=HW, num_classes=19)
    batch = jax_collate([ds[0], ds[1]])
    raw = raft_config_dict()
    raw["model"]["dtype"] = "bfloat16"
    raw["optim"] = {"optimizer": "sgd", "lr": SGD_LR, "schedule": "constant",
                    "grad_clip": 0.0, "grads_dtype": "bfloat16"}
    jt = JaxTrainer(JaxConfig.from_dict(raw))
    init = draw_params(jt.state.params, 6)
    jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, init))
    jt.train_step(batch)
    port = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    p0 = port_masters(port.config, init)
    p1 = port_masters(port.config, numpy_tree(jt.state.params))
    port.load_masters(p0)
    _, grads = port.loss_and_grads(batch)
    return {"jax": {n: (p0[n].double() - p1[n].double()).numpy() / SGD_LR
                    for n in p0},
            "port": {n: g.double().numpy() for n, g in grads.items()}}


def test_bf16_gradients_dtype_step_matches_jax(raft_bf16_step,
                                               raft_bf16_grads_step):
    """optim.grads_dtype="bfloat16" on CerberusRAFT: every port gradient a
    bf16 value, as the reference's gradients of bf16 leaves are; against
    the float32 step's gradients, the whole within twice JAX's distance
    plus 1e-3 and each module within 1.5 times JAX's farthest module, the
    rule of test_bf16_train_step_gradients_match_jax."""
    j32 = raft_bf16_step["jax", "float32"][1]
    jg, pg = raft_bf16_grads_step["jax"], raft_bf16_grads_step["port"]
    assert sorted(pg) == sorted(jg) == sorted(j32)
    for n, g in pg.items():
        g32 = torch.from_numpy(g).float()
        assert torch.equal(g32, g32.bfloat16().float()), n

    def cat(g, names):
        return np.concatenate([g[n].ravel() for n in names])

    names = sorted(j32)
    whole = {"jax": rel(cat(jg, names), cat(j32, names)),
             "port": rel(cat(pg, names), cat(j32, names))}
    assert whole["port"] <= 2 * whole["jax"] + 1e-3, whole
    modules = {}
    for mod in sorted({module_of(n) for n in names}):
        members = [n for n in names if module_of(n) == mod]
        if not np.any(cat(j32, members)):
            assert not np.any(cat(pg, members)), mod
            continue
        modules[mod] = (rel(cat(jg, members), cat(j32, members)),
                        rel(cat(pg, members), cat(j32, members)))
    assert len(modules) == 46
    limit = 1.5 * max(j for j, _ in modules.values())
    far = {m: r for m, r in modules.items() if not r[1] <= limit}
    assert not far, (limit, far)


@pytest.mark.parametrize("kernel,cin,cout", [(1, 36, 96), (3, 96, 64),
                                               (5, 2, 64), (3, 120, 16)])
def test_bf16_tied_conv_rounds_as_flax(kernel, cin, cout):
    """A bf16 ``TiedConv2d`` (the update block's convolutions; the shapes
    of convc1, convc2, convf1 and the GRU's at the tiny widths) against
    flax's ``nn.Conv(dtype=bfloat16)`` on the same bf16 input: the product
    rounded to bf16, then the bf16 bias added (ROADMAP C7; a bias fused
    into the product's float32 sum rounds once, and 12-34% of the outputs
    of the update block's convolutions differed from JAX's,
    scripts/raft_bf16_op_compare.py). Only the order of the products'
    sums may differ: at most 0.5% of the outputs."""
    import flax.linen as fnn

    rng = np.random.RandomState(kernel + cin)
    x = jnp.asarray(rng.randn(2, 8, 8, cin), jnp.float32).astype(jnp.bfloat16)
    params = {"kernel": (rng.randn(kernel, kernel, cin, cout)
                         / np.sqrt(kernel * kernel * cin)).astype(np.float32),
              "bias": (0.1 * rng.randn(cout)).astype(np.float32)}
    want = jax.jit(lambda p, v: fnn.Conv(
        cout, (kernel, kernel), padding="SAME", dtype=jnp.bfloat16).apply(
            {"params": p}, v))(params, x)
    conv = tr.TiedConv2d(cin, cout, kernel, padding=kernel // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            params["kernel"].transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(params["bias"]))
        got = conv(torch.from_numpy(np.asarray(x, np.float32)).permute(
            0, 3, 1, 2).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.mean(got != np.asarray(want, np.float32)) <= 5e-3


@pytest.mark.parametrize("stride,cin,cout", [(2, 3, 8), (1, 8, 8),
                                              (2, 12, 16), (1, 16, 24)])
def test_bf16_conv_block_rounds_as_flax(stride, cin, cout):
    """A bf16 ``ConvBlock`` (the shared encoder's, and the decoders' and
    heads') against flax's ``ConvBlock(dtype=bfloat16)``, and at stride 1
    a bf16 ``FlaxConv2d`` (RAFT's ``context_proj``) against flax's
    ``nn.Conv``, on the same bf16 input: the product rounded to bf16, then
    the bf16 bias added (ROADMAP C7; with the bias fused 13-39% of the
    encoder's block outputs and 21% of context_proj's differed from
    JAX's, scripts/raft_bf16_op_compare.py). Only the order of the
    products' sums may differ: at most 0.5% of the outputs."""
    import flax.linen as fnn

    from cerberusnet_tpu.models.common import ConvBlock as JaxConvBlock
    from cerberusnet_torch.models.common import ConvBlock, FlaxConv2d

    rng = np.random.RandomState(stride + cin)
    x = jnp.asarray(rng.randn(2, 10, 12, cin), jnp.float32).astype(
        jnp.bfloat16)
    params = {"kernel": (rng.randn(3, 3, cin, cout)
                         / np.sqrt(9 * cin)).astype(np.float32),
              "bias": (0.1 * rng.randn(cout)).astype(np.float32)}
    xt = torch.from_numpy(np.asarray(x, np.float32)).permute(
        0, 3, 1, 2).bfloat16()
    kernel = torch.from_numpy(params["kernel"].transpose(3, 2, 0, 1).copy())
    pairs = [(JaxConvBlock(cout, stride=stride, dtype=jnp.bfloat16),
              ConvBlock(cin, cout, stride=stride))]
    if stride == 1:
        pairs.append((fnn.Conv(cout, (3, 3), padding="SAME",
                               dtype=jnp.bfloat16),
                      FlaxConv2d(cin, cout, 3, padding=1)))
    for jmod, mod in pairs:
        want = jax.jit(lambda p, v, m=jmod: m.apply(
            {"params": p if m is not jmod or not isinstance(
                m, JaxConvBlock) else {"Conv_0": p}}, v))(params, x)
        conv = getattr(mod, "conv", mod).to(torch.bfloat16)
        with torch.no_grad():
            conv.weight.copy_(kernel)
            conv.bias.copy_(torch.from_numpy(params["bias"]))
            got = mod(xt)
        assert got.dtype == torch.bfloat16
        got = got.float().permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert np.mean(got != np.asarray(want, np.float32)) <= 5e-3, jmod


# the GRU's gates: (port function, flax's, torch's own)
GATES = {"sigmoid": ("sigmoid", jax.nn.sigmoid, torch.sigmoid),
         "tanh": ("tanh", jnp.tanh, torch.tanh)}
# the update block's gate input at the tiny widths: (batch, h, w, hdim)
GATE_SHAPE = (2, 8, 8, 16)


def gate_inputs(seed):
    """A conv output's scale of pre-activations and a cotangent, bf16."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(2.0 * rng.randn(*GATE_SHAPE), jnp.bfloat16)
    g = jnp.asarray(rng.randn(*GATE_SHAPE), jnp.bfloat16)
    return x, g


def bits(a):
    """A bf16 array's or tensor's values as a writable float32 array."""
    return np.array(a.float() if isinstance(a, torch.Tensor)
                    else jnp.asarray(a, jnp.float32), np.float32)


@pytest.mark.parametrize("gate", list(GATES))
def test_bf16_gate_rounds_as_flax(gate):
    """``models/common.py``'s ``sigmoid`` and ``tanh`` (the GRU's gates and
    the decoders' hidden state, ROADMAP C7) in bf16 against flax's
    ``nn.sigmoid`` / ``jnp.tanh`` and their ``jax.vjp``, every element
    bit-equal: XLA computes the sigmoid as 1 / (1 + exp(-x)) rounding each
    op, and the backwards as g (y (1 - y)) and a = g (1 - y), a + a y
    (with torch's own gates 29-41% of the GRU's sigmoid outputs and 35-70%
    of its cotangents differed, scripts/raft_bf16_op_compare.py)."""
    from cerberusnet_torch.models import common

    name, jf, _ = GATES[gate]
    x, g = gate_inputs(3)
    y, vjp = jax.vjp(jf, x)
    (dx,) = jax.jit(vjp)(g)
    xt = torch.tensor(bits(x)).bfloat16().requires_grad_()
    yt = getattr(common, name)(xt)
    (dxt,) = torch.autograd.grad(yt, xt, torch.from_numpy(bits(g)).bfloat16())
    assert yt.dtype == dxt.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(yt.detach()), bits(y))
    np.testing.assert_array_equal(bits(dxt), bits(dx))


@pytest.mark.parametrize("gate", list(GATES))
def test_float32_gate_is_torchs(gate):
    """In float32 (and float64) the gates are torch's own, with autograd's
    backward: every float32 test is unmoved."""
    from cerberusnet_torch.models import common

    name, _, own = GATES[gate]
    x, g = gate_inputs(4)
    for dtype in (torch.float32, torch.float64):
        xt = torch.from_numpy(bits(x)).to(dtype).requires_grad_()
        gt = torch.from_numpy(bits(g)).to(dtype)
        y = getattr(common, name)(xt)
        (dx,) = torch.autograd.grad(y, xt, gt)
        (want,) = torch.autograd.grad(own(xt), xt, gt)
        assert torch.equal(y, own(xt)) and torch.equal(dx, want)


def test_bf16_conv_gru_backward_rounds_as_flax():
    """One bf16 ``ConvGRU`` cell's backward at the tiny widths (hidden 16,
    input 8 + 82 channels) against ``jax.vjp`` of flax's on the same
    inputs, weights (float32, cast at the use) and cotangent: the
    cotangents of h and x differ only by the order of the convolutions'
    sums, at most 0.5% of their elements (0% in
    scripts/raft_bf16_op_compare.py's ``bwd.gru.dh`` / ``.dx``); the
    kernels' gradients are JAX's rounded to bf16 there (XLA's CPU
    convolution hands its float32 sums on unrounded under its default
    excess precision, ROADMAP C7), and each bias gradient is its gate's
    pre-activation cotangents summed over the pixels and rounded once, no
    farther from their float64 sum than JAX's (which XLA's CPU accumulates
    in bf16)."""
    hidden, inp = 16, 90
    rng = np.random.RandomState(5)
    h = jnp.asarray(np.tanh(rng.randn(2, 8, 8, hidden)), jnp.bfloat16)
    x = jnp.asarray(rng.randn(2, 8, 8, inp), jnp.bfloat16)
    ct = jnp.asarray(0.1 * rng.randn(2, 8, 8, hidden), jnp.bfloat16)
    jgru = jr.ConvGRU(hidden, dtype=jnp.bfloat16)
    params = draw_params(jax.eval_shape(jgru.init, jax.random.PRNGKey(0),
                                        h, x)["params"], 6)
    _, vjp = jax.vjp(lambda p, a, b: jgru.apply({"params": p}, a, b),
                     params, h, x)
    dp, dh, dx = jax.jit(vjp)(ct)
    gru = tr.ConvGRU(hidden, inp)
    with torch.no_grad():
        for name in ("convz", "convr", "convq"):
            conv = getattr(gru, name)
            conv.weight.copy_(torch.from_numpy(
                params[name]["kernel"].transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(params[name]["bias"]))

    def nchw(a):
        return torch.from_numpy(bits(a)).permute(0, 3, 1, 2).bfloat16()

    # each gate's pre-activation cotangent, which its bias gradient sums
    pre = {}

    def keep(name):
        def hook(module, args, out):
            out.register_hook(lambda g: pre.__setitem__(name, g))
        return hook

    for name in ("convz", "convr", "convq"):
        getattr(gru, name).register_forward_hook(keep(name))
    ht, xt = nchw(h).requires_grad_(), nchw(x).requires_grad_()
    out = gru(ht, xt)
    convs = [getattr(gru, n) for n in ("convz", "convr", "convq")]
    grads = torch.autograd.grad(out, [ht, xt] + [c.weight for c in convs]
                                + [c.bias for c in convs], nchw(ct))
    for got, want in ((grads[0], dh), (grads[1], dx)):
        got = got.float().permute(0, 2, 3, 1).numpy()
        assert np.mean(got != bits(want)) <= 5e-3
    for i, name in enumerate(("convz", "convr", "convq")):
        kernel = grads[2 + i].permute(2, 3, 1, 0).numpy()
        want = bits(jnp.asarray(dp[name]["kernel"], jnp.bfloat16))
        assert np.mean(kernel != want) <= 5e-3, name
        exact = pre[name].double().sum((0, 2, 3)).numpy()
        got = grads[5 + i].numpy()
        np.testing.assert_allclose(got, exact, rtol=2.0**-8, atol=0,
                                   err_msg=name)
        assert (np.linalg.norm(got - exact) <= np.linalg.norm(
            np.asarray(dp[name]["bias"], np.float64) - exact)), name


def test_bf16_tied_weight_gradients_sum_in_float32(raft_bf16_step):
    """keep_tied_float32 as flax's per-call casts: in the bf16 step a kernel
    used once (context_proj) gets its bf16 convolution's gradient, bf16
    values; a kernel used at every iteration or on both frames gets the
    float32 sum of its uses' bf16 gradients, which are not all bf16 values
    (a one-element bias's sum may be one by chance)."""
    p16 = raft_bf16_step["port", "bfloat16"][1]

    def bf16_valued(g):
        g32 = torch.from_numpy(g).float()
        return torch.equal(g32, g32.bfloat16().float())

    for dec in ("flow", "disparity"):
        assert bf16_valued(p16[f"{dec}.context_proj.weight"])
        tied = [n for n in p16 if n.startswith(dec) and n.endswith(".weight")
                and any(k in n for k in TIED) and ".mask_head" not in n]
        assert len(tied) == 11
        assert not any(bf16_valued(p16[n]) for n in tied), [
            n for n in tied if bf16_valued(p16[n])]


# -------------------------------------------------- variants and entries


def decoders_of(variant):
    return {"cerberus_raft": ("flow", "disparity"), "raft": ("flow",),
            "raft_stereo": ("disparity",)}[variant]


@pytest.mark.parametrize("variant,keys,comps", [
    ("cerberus_raft", ("left", "right", "temporal"),
     ["disp", "flow", "seg", "total"]),
    ("raft", ("left", "temporal"), ["flow", "total"]),
    ("raft_stereo", ("left", "right"), ["disp", "total"]),
])
def test_trainer_builds_each_raft_variant(variant, keys, comps):
    raw = raft_config_dict()
    # level 4 of 128x128: an 8x8 grid, four volume levels down to 1x1
    raw["model"].update(variant=variant, raft_level=4, raft_iters=2,
                        raft_lookup="gather", dtype="bfloat16")
    raw["data"]["hw"] = [128, 128]
    trainer = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    assert trainer.input_keys == keys
    decoders = [m for m in trainer.model.modules()
                if isinstance(m, tr.RAFTDecoder)]
    assert decoders and all((d.level, d.iters, d.lookup_impl)
                            == (4, 2, "gather") for d in decoders)
    # the weights used at every iteration and on both frames stay float32
    # in the bf16 model, so their uses' gradients sum in float32
    for d in decoders:
        assert d.update.gru.convz.weight.dtype == torch.float32
        assert d.corr_proj.bias.dtype == torch.float32
        assert d.context_proj.weight.dtype == torch.bfloat16
    batch = {k: np.stack([v, trainer.dataset[1][k]])
             for k, v in trainer.dataset[0].items()}
    before = {n: m.clone() for n, m in trainer.masters.items()}
    got = trainer.train_step(batch)
    assert sorted(got) == comps
    assert all(torch.isfinite(v) for v in got.values())
    # Every master moves but the biases of what the loss does not reach,
    # drawn as 0 and so without weight decay: the upsampling masks' (the
    # sequence loss supervises the iterates, not the upsampled field, so
    # the mask heads get no gradient, in the reference too) and, without
    # the segmentation head, the encoder levels above the operating one.
    still = [n for n, m in trainer.masters.items()
             if torch.equal(m, before[n])]
    unused = [f"encoder.blocks.{i}.conv.bias" for i in range(12, 18)
              if variant != "cerberus_raft"]
    assert still == unused + [f"{d}.update.{h}.bias"
                              for d in decoders_of(variant)
                              for h in ("mask_head1", "mask_head2")]


def test_trace_files_raft_operators_by_stage():
    """trace_forward's RAFT stages on a CPU profile of a tiny step: the
    ranges wrap the module's functions only inside ``raft_ranges``, and
    each matrix product is filed under its stage, the backward's through
    the autograd node's sequence number."""
    from torch.profiler import ProfilerActivity, profile

    from cerberusnet_torch import trace_forward as trf

    model = tr.CerberusRAFT(fpn_channels=16, **TINY)
    imgs = [torch.from_numpy(i) for i in frames(0, 3)]
    saved = tr.corr_lookup
    with trf.raft_ranges(expect=True) as calls, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        assert tr.corr_lookup is not saved
        out = model(*imgs)
        (out["flow"].sum() + out["disp_iterates"].sum()).backward()
    assert tr.corr_lookup is saved
    assert calls == {"allpairs_correlation": 1, "allpairs_correlation_1d": 1,
                     "correlation_pyramid": 1, "correlation_pyramid_1d": 1,
                     "corr_lookup": 3, "corr_lookup_1d": 3,
                     "convex_upsample": 2}
    events = prof.events()
    stage_of = trf.stage_finder(events)
    products = {}
    for e in events:
        if e.name in ("aten::bmm", "aten::mm"):
            stage = stage_of(e)
            products[stage] = products.get(stage, 0) + 1
    # 2 volumes; 2 products a level, 4 levels, 3 iterations (flow) and 1 a
    # level (stereo); 1 convex upsampling each. The backward takes 2 a
    # product, but 1 at the first iteration, whose positions (the grid,
    # zero flow) need no gradient: 72 - 12.
    assert products == {"raft_allpairs": 2, "raft_lookup": 36,
                        "raft_upsample": 2, "raft_allpairs backward": 4,
                        "raft_lookup backward": 60,
                        "raft_upsample backward": 2}, products


def test_trace_ranges_name_a_stage_function_never_called():
    """With ``expect``, raft_ranges raises naming the stage functions a run
    did not call through the module: here the 1-D ones, which a flow-only
    model never reaches (as a caller that bound a function by name would
    not), and puts the module's functions back all the same."""
    from cerberusnet_torch import trace_forward as trf

    model = tr.RAFTFlowNet(**TINY)
    imgs = [torch.from_numpy(i) for i in frames(0, 2)]
    saved = tr.corr_lookup_1d
    with pytest.raises(RuntimeError, match="'allpairs_correlation_1d', "
                       "'correlation_pyramid_1d', 'corr_lookup_1d'"):
        with trf.raft_ranges(expect=True) as calls, torch.no_grad():
            model(*imgs)
    assert tr.corr_lookup_1d is saved
    assert calls["corr_lookup"] == 3 and calls["corr_lookup_1d"] == 0


def test_trace_moves_a_stage_kernels_out_of_their_name_category():
    """kernel_table on a made-up profile: a product under a lookup range
    and its backward move from "convolution" (a cuBLAS name) to the
    stage; a convolution outside any range stays; a range's own device
    span is not a kernel."""
    from types import SimpleNamespace

    from cerberusnet_torch import trace_forward as trf

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def op(name, parent=None, seq=-1, kernels=()):
        return SimpleNamespace(
            name=name, cpu_parent=parent, sequence_nr=seq, device_type=cpu,
            kernels=[SimpleNamespace(name=k, duration=us)
                     for k, us in kernels])

    def kernel(name, us, annotation=False):
        return SimpleNamespace(name=name, device_type=cuda,
                               device_time_total=us, cpu_parent=None,
                               sequence_nr=-1, kernels=[],
                               is_user_annotation=annotation)

    lookup = op("raft_lookup")
    node = op("autograd::engine::evaluate_function: BmmBackward0", seq=5)
    events = [lookup, op("aten::bmm", lookup, 5, [("nvjet_gemm", 10.0)]),
              op("aten::cudnn_convolution", None, 6, [("cudnn_conv", 20.0)]),
              node, op("aten::bmm", node, -1, [("nvjet_gemm", 30.0)]),
              kernel("nvjet_gemm", 10.0), kernel("cudnn_conv", 20.0),
              kernel("nvjet_gemm", 30.0), kernel("raft_lookup", 10.0, True)]
    assert trf.kernel_table(events) == {
        ("raft_lookup", "nvjet_gemm"): [1, 0.01],
        ("raft_lookup backward", "nvjet_gemm"): [1, 0.03],
        ("convolution", "cudnn_conv"): [1, 0.02]}


def test_entry_serves_cerberus_raft_on_cpu():
    forward, imgs = entry(device="cpu", dtype=torch.float32, hw=(128, 256),
                          variant="cerberus_raft", raft_level=4,
                          raft_iters=2, raft_lookup="gather")
    out = forward(*imgs)
    assert tuple(out["seg_logits"].shape) == (1, 128, 256, 19)
    assert tuple(out["flow"].shape) == (1, 128, 256, 2)
    assert tuple(out["disp"].shape) == (1, 128, 256, 1)
    assert tuple(out["flow_iterates"].shape) == (2, 1, 8, 16, 2)
    assert tuple(out["disp_pyramid"][4].shape) == (1, 8, 16, 1)
    assert all(torch.isfinite(v).all() for k, v in out.items()
               if not k.endswith("_pyramid"))
    # as served, every weight is in the model's type but the classifier's
    served = tr.CerberusRAFT(dtype=torch.bfloat16)
    assert {n for n, p in served.named_parameters()
            if p.dtype != torch.bfloat16} == {
                "segmentation.classifier.weight",
                "segmentation.classifier.bias"}
    with pytest.raises(ValueError, match="no correlation kernel"):
        entry(device="cpu", variant="cerberus_raft", corr_impl="plain")
    with pytest.raises(ValueError, match="pallas_levels"):
        entry(device="cpu", variant="cerberus_raft", pallas_levels=3)
