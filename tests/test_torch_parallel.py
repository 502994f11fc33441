"""Data parallelism (``cerberusnet_torch/parallel/mesh.py``) on the CPU:
two gloo ranks against the JAX package's ``make_mesh(2, 1)`` on the same
global batch, and against one port process.

The ranks are spawned once for the module (``tests/dp_ranks.py``'s
``suite``, which imports no JAX) while the test process computes the JAX
side from the same weights and batches, and the tests read their
results. Every
global batch is built so that a naive per-rank mean fails: rank 0's half
has 90% of its flow and disparity pixels valid and 10% of its labels
ignored (255), rank 1's half 10% and 60%, and berHu's largest error lies
in rank 1's half. The plain means (photometric, smoothness, RMI) are
exact under a naive average too, since the slices are equal; the masked
means and berHu's maximum are not, and their control shows it.

Tolerances: the losses' values within 1e-5 of JAX's and their input
gradients within 1e-5 relative L2 (float32 summation order); the JAX
test's (tests/test_parallel.py) for the DP gradients of SegNet, FlowNet
and StereoNet (loss rtol 2e-5, gradients rtol 3e-4, atol 2e-6); the
single-process parity rules of tests/test_torch_train.py for the
Trainer's step against the JAX Trainer's with two devices (components
1e-5, gradients and masters 1e-4 relative L2), also with
``optim.accum_steps=2`` (the masters after two calls); with
``optim.grads_dtype="bfloat16"`` the gradients within one bf16 ulp (2^-7)
of relative L2, tests/test_torch_fit.py's rule; 1e-5 against one port
process.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from cerberusnet_tpu.data.loader import collate as jax_collate
from cerberusnet_tpu.data.synthetic import (
    SyntheticPerceptionDataset as JaxSynthetic,
)
from cerberusnet_tpu.models import FlowNet as JaxFlowNet
from cerberusnet_tpu.models import SegNet as JaxSegNet
from cerberusnet_tpu.models import StereoNet as JaxStereoNet
from cerberusnet_tpu.parallel import make_mesh as jax_make_mesh
from cerberusnet_tpu.parallel import replicated_sharding
from cerberusnet_tpu.parallel import shard_batch as jax_shard_batch
from cerberusnet_tpu.train import losses as jl
from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
from cerberusnet_tpu.train.config import OptimConfig as JaxOptimConfig
from cerberusnet_tpu.train.trainer import Trainer as JaxTrainer
from cerberusnet_tpu.train.trainer import build_optimizer as jax_optimizer
from cerberusnet_torch.data.loader import DataLoader
from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset
from cerberusnet_torch.parallel import DataMesh, launch, shard_batch
from cerberusnet_torch.parallel.mesh import SINGLE
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from tests import dp_ranks
from tests.jax_pairs import draw_params, numpy_tree, port_masters
from tests.test_torch_train import tiny_config_dict

N = 2
B = 4  # the global batch
HW = (64, 64)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def sparse_valid(rng, b, h, w):
    """A validity mask with 90% of rank 0's pixels valid and 10% of rank
    1's, those in its top quarter alone (KITTI's ground truth leaves whole
    regions empty, so a coarse level's cells are empty too)."""
    frac = np.repeat([0.9, 0.1], b // 2)[:, None, None]
    valid = rng.rand(b, h, w) < frac
    valid[b // 2:, h // 4:] = False
    return valid.astype(np.float32)


def ignored(rng, labels):
    """``labels`` with 10% of rank 0's and 60% of rank 1's set to 255."""
    b, h, w = labels.shape
    frac = np.repeat([0.1, 0.6], b // 2)[:, None, None]
    labels = labels.copy()
    labels[rng.rand(b, h, w) < frac] = 255
    return labels


def skewed(batch, seed=0):
    """The batch with rank 0's half mostly valid and rank 1's mostly not
    (flow and disparity), and labels ignored on 10% and 60% of them."""
    rng = np.random.RandomState(seed)
    out = dict(batch)
    b, h, w = batch["left"].shape[:3]
    valid = sparse_valid(rng, b, h, w)
    out["flow_valid"] = valid
    out["flow_gt"] = batch["flow_gt"] * valid[..., None]
    out["disp_valid"] = valid
    out["disp_gt"] = batch["disp_gt"] * valid
    out["seg_labels"] = ignored(rng, batch["seg_labels"])
    return out


def synthetic_batch(length=B, seed=0):
    ds = JaxSynthetic(length=length, hw=HW, num_classes=19, seed=seed)
    return jax_collate([ds[i] for i in range(length)])


def config(**sections):
    """tiny_config_dict (JAX's fast "purev" correlations, the port's plain
    ones) at the global batch, on two ranks, with ``sections`` merged."""
    raw = tiny_config_dict("purev")
    raw["data"].update(batch_size=B, synthetic_length=B)
    raw["train"].update(num_data_devices=N)
    for name, values in sections.items():
        raw[name] = {**raw[name], **values}
    return raw


def single(raw):
    """The same experiment in one process."""
    return {**raw, "train": {**raw["train"], "num_data_devices": 1}}


# ------------------------------------------------------------- losses


def loss_inputs(seed=0):
    """The global batch of every loss: a 3-level pyramid at 32x64, the
    RAFT iterates (batch first, 3 of them at level 3), full-resolution
    flow and disparity, frames, logits; rank 1's logits three times as
    large and berHu's largest error in its half."""
    rng = np.random.RandomState(seed)
    b, h, w = B, 32, 64
    valid = sparse_valid(rng, b, h, w)
    labels = ignored(rng, rng.randint(0, 5, (b, h, w)))
    logits = rng.randn(b, h, w, 5).astype(np.float32)
    logits[b // 2:] *= 3
    disp = (rng.rand(b, h, w) * 20).astype(np.float32)
    big = tuple(np.argwhere(valid[b - 1])[0])
    disp[(b - 1, *big)] += 200.0
    pyr = {l: (rng.rand(b, h >> l, w >> l, 1) * 3).astype(np.float32)
           for l in (2, 3, 4)}
    pyr[2][b - 1, big[0] >> 2, big[1] >> 2, 0] += 200.0
    return {
        "seg_logits": logits, "seg_labels": labels.astype(np.int32),
        "flow_pyramid": {l: rng.randn(b, h >> l, w >> l, 2).astype(np.float32)
                         for l in (2, 3, 4)},
        "flow_gt": (rng.randn(b, h, w, 2) * 8).astype(np.float32)
        * valid[..., None],
        "flow_valid": valid,
        "disp_pyramid": pyr, "disp": disp,
        "disp_gt": (rng.rand(b, h, w) * 20).astype(np.float32) * valid,
        "disp_valid": valid,
        "iterates": rng.randn(b, 3, h >> 3, w >> 3, 2).astype(np.float32),
        "flow": rng.randn(b, h, w, 2).astype(np.float32),
        "left": rng.rand(b, h, w, 3).astype(np.float32),
        "temporal": rng.rand(b, h, w, 3).astype(np.float32),
    }


# name: JAX's loss of the inputs
JAX_LOSSES = {
    "segmentation": lambda x: jl.segmentation_loss(x["seg_logits"],
                                                   x["seg_labels"]),
    "segmentation_focal": lambda x: jl.segmentation_loss(
        x["seg_logits"], x["seg_labels"], focal_gamma=2.0),
    "multiscale_flow": lambda x: jl.multiscale_flow_loss(
        x["flow_pyramid"], x["flow_gt"], x["flow_valid"]),
    "multiscale_flow_robust": lambda x: jl.multiscale_flow_loss(
        x["flow_pyramid"], x["flow_gt"], x["flow_valid"], robust_q=0.4),
    "multiscale_disparity": lambda x: jl.multiscale_disparity_loss(
        x["disp_pyramid"], x["disp_gt"], x["disp_valid"]),
    "berhu": lambda x: jl.berhu_loss(x["disp"], x["disp_gt"],
                                     x["disp_valid"]),
    "raft_sequence": lambda x: jl.raft_sequence_loss(
        jnp.swapaxes(x["iterates"], 0, 1), x["flow_gt"], x["flow_valid"],
        level=3, gamma=0.8),
    "photometric": lambda x: jl.photometric_loss(x["left"], x["temporal"],
                                                 x["flow"]),
    "smoothness": lambda x: jl.smoothness_loss(x["flow"], x["left"]),
    "rmi": lambda x: jl.rmi_loss(x["seg_logits"], x["seg_labels"]),
}
# the losses whose naive per-rank mean differs from the global one
MASKED = ("segmentation", "segmentation_focal", "multiscale_flow",
          "multiscale_flow_robust", "multiscale_disparity", "berhu",
          "raft_sequence")


@pytest.fixture(scope="module")
def jax_losses():
    """{name: (value, gradient of the differentiated input)} of JAX's
    losses on the global batch."""
    x = loss_inputs()
    out = {}
    for name, fn in JAX_LOSSES.items():
        key = dp_ranks.LOSSES[name][0]

        def of(v, key=key, fn=fn):
            return fn({**x, key: v})

        value, grad = jax.jit(jax.value_and_grad(of))(
            jax.tree.map(jnp.asarray, x[key]))
        out[name] = (float(value), numpy_tree(grad))
    return out


# --------------------------------------------------- models (JAX mesh)

JAX_MODELS = {
    "SegNet": lambda: JaxSegNet(encoder_channels=dp_ranks.TINY_ENC,
                                num_classes=5, fpn_channels=16),
    "FlowNet": lambda: JaxFlowNet(encoder_channels=dp_ranks.TINY_ENC,
                                  corr_impl="purev", **dp_ranks.DEC),
    "StereoNet": lambda: JaxStereoNet(encoder_channels=dp_ranks.TINY_ENC,
                                      corr_impl="purev", **dp_ranks.DEC),
}


def model_batch(seed):
    rng = np.random.RandomState(seed)
    b, (h, w) = B, HW
    valid = sparse_valid(rng, b, h, w)
    labels = ignored(rng, rng.randint(0, 5, (b, h, w)))
    return {
        "left": rng.rand(b, h, w, 3).astype(np.float32),
        "right": rng.rand(b, h, w, 3).astype(np.float32),
        "temporal": rng.rand(b, h, w, 3).astype(np.float32),
        "seg_labels": labels.astype(np.int32),
        "flow_gt": (rng.rand(b, h, w, 2) * 4 - 2).astype(np.float32)
        * valid[..., None],
        "flow_valid": valid,
        "disp_gt": (rng.rand(b, h, w) * 8).astype(np.float32) * valid,
        "disp_valid": valid,
    }


def model_specs():
    """{model: (random flax parameters, batch)} of the JAX test's models."""
    out = {}
    for i, (name, make) in enumerate(JAX_MODELS.items()):
        batch = model_batch(i)
        keys = dp_ranks.MODELS[name][1]
        shapes = jax.eval_shape(make().init, jax.random.PRNGKey(i),
                                *(batch[k][:1] for k in keys))["params"]
        out[name] = (draw_params(shapes, i), batch)
    return out


def jax_model_grads(specs):
    """{model: (params, batch, loss, gradients by the port's names)}: the
    JAX test's models, value and gradient on the make_mesh(2, 1) mesh, the
    batch sharded over 'data' and the parameters replicated."""
    mesh = jax_make_mesh(N, 1)
    out = {}
    for name, make in JAX_MODELS.items():
        model = make()
        params, batch = specs[name]
        keys = dp_ranks.MODELS[name][1]

        def loss_fn(p, bd, model=model, name=name, keys=keys):
            out = model.apply({"params": p}, *(bd[k] for k in keys))
            if name == "SegNet":
                return jl.segmentation_loss(out, bd["seg_labels"])
            if name == "FlowNet":
                return jl.multiscale_flow_loss(out["flow_pyramid"],
                                               bd["flow_gt"], bd["flow_valid"])
            return jl.multiscale_disparity_loss(
                out["disp_pyramid"], bd["disp_gt"], bd["disp_valid"])

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.device_put(params, replicated_sharding(mesh)),
            jax_shard_batch(batch, mesh))
        ref = dp_ranks.load_flax_params(dp_ranks.MODELS[name][0](),
                                        numpy_tree(grads))
        out[name] = (params, batch, float(loss),
                     {n: p.detach().numpy() for n, p in
                      ref.named_parameters()})
    return out


# ------------------------------------------------ trainer (JAX Trainer)


def trainer_start():
    """The JAX Trainer with num_data_devices=2 (uncertainty weighting, no
    augmentation), its random initial weights and a skewed batch: (JAX
    trainer, port config, initial flax tree, batch, initial masters by the
    port's names)."""
    raw = config(loss={"uncertainty_weighting": True})
    jt = JaxTrainer(JaxConfig.from_dict(raw))
    assert jt.mesh.shape["data"] == N
    init = draw_params(jt.state.params, 7)
    cfg = ExperimentConfig.from_dict(raw)
    masters = {k: v.numpy() for k, v in port_masters(cfg, init).items()}
    return jt, raw, init, skewed(synthetic_batch()), masters


def trainer_step_refs(start):
    """One step of ``trainer_start``'s JAX Trainer from its weights on its
    batch: its preprocessing of the batch sharded on its mesh, the
    gradient of its loss and one update of its optimizer (its
    ``train_step`` less the jit that fuses them, which would compile the
    model once more). Returns (port config, batch, initial masters,
    components, gradients, masters after, gradients with
    ``optim.grads_dtype="bfloat16"``, masters after two calls with
    ``optim.accum_steps=2``, the first on ``batch`` and the second on
    ``second_batch()``), the trees by the port's names."""
    jt, raw, init, batch, masters = start
    prep = jt.preprocess(jax_shard_batch(batch, jt.mesh))
    params = jax.device_put(init, replicated_sharding(jt.mesh))
    value_and_grad = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))
    (_, comps), grads = value_and_grad(params, prep)

    def update(p, g):
        upd, _ = jt.tx.update(g, jt.tx.init(p), p)
        return optax.apply_updates(p, upd)

    after = jax.jit(update)(params, grads)
    # grads_dtype="bfloat16": the JAX step's gradient of the bf16 cast
    p16 = jax.tree.map(lambda v: v.astype(jnp.bfloat16)
                       if v.dtype == jnp.float32 else v, params)
    g16 = jax.tree.map(lambda g: g.astype(jnp.float32),
                       jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
                           p16, prep)[1])
    # accum_steps=2: optax.MultiSteps over two calls, an update at the second
    tx = jax_optimizer(JaxOptimConfig(**{**raw["optim"], "accum_steps": 2}))
    (_, _), grads2 = value_and_grad(params, jt.preprocess(
        jax_shard_batch(second_batch(), jt.mesh)))

    def two_calls(p, g1, g2):
        state = tx.init(p)
        u1, state = tx.update(g1, state, p)
        p = optax.apply_updates(p, u1)
        u2, _ = tx.update(g2, state, p)
        return optax.apply_updates(p, u2)

    accum = jax.jit(two_calls)(params, grads, grads2)
    cfg = ExperimentConfig.from_dict(raw)
    np_tree = lambda d: {k: v.numpy() for k, v in d.items()}  # noqa: E731
    return (raw, batch, masters,
            {k: float(v) for k, v in comps.items()},
            np_tree(port_masters(cfg, numpy_tree(grads))),
            np_tree(port_masters(cfg, numpy_tree(after))),
            np_tree(port_masters(cfg, numpy_tree(g16))),
            np_tree(port_masters(cfg, numpy_tree(accum))))


def second_batch():
    """The accumulation case's second global batch."""
    return skewed(synthetic_batch(seed=1), 1)


# ------------------------------------------------------------ the ranks


AUGMENT = {"crop_hw": [48, 48], "flip_lr_prob": 0.5, "brightness": 0.1,
           "contrast": 0.2}


def augmented_batches():
    """Two global batches without disparity (a flip skips batches with
    it)."""
    out = []
    for seed in (0, 1):
        b = skewed(synthetic_batch(seed=seed), seed)
        out.append({k: v for k, v in b.items() if not k.startswith("disp")})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the two ranks' results of ``dp_ranks.suite``, ``jax_model_grads``,
    ``trainer_step_refs``): the ranks run while the test process computes
    the JAX side from the same weights and batches."""
    specs = model_specs()
    start = trainer_start()
    _, raw, _, batch, masters = start
    payload = {
        "losses": loss_inputs(),
        "models": {name: {"model": name, "params": numpy_tree(params),
                          "batch": batch_}
                   for name, (params, batch_) in specs.items()},
        "trainer_step": {"raw": raw, "batch": batch, "masters": masters},
        "trainer_bf16": {"raw": {**raw, "optim": {
            **raw["optim"], "grads_dtype": "bfloat16"}}, "batch": batch,
            "masters": masters},
        "trainer_accum": {"raw": {**raw, "optim": {
            **raw["optim"], "accum_steps": 2}},
            "batches": [batch, second_batch()], "masters": masters},
        "augmented": {"raw": config(data=AUGMENT),
                      "batches": augmented_batches()},
        "evaluate": {"raw": config(data={"eval_split": "val",
                                         "synthetic_length": 5})},
        "checkpoint": {"raw": config(), "batch": batch,
                       "dir": str(tmp_path_factory.mktemp("dp_ckpt"))},
        "pallas_levels": {"raw": config(model={"pallas_levels": 3})},
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, dp_ranks.suite, N, args=(payload,),
                            timeout=dp_ranks.RANKS_TIMEOUT_S)
        models = jax_model_grads(specs)
        step = trainer_step_refs(start)
        return ranks.result(), models, step


@pytest.fixture(scope="module")
def ranks(world):
    return world[0]


@pytest.fixture(scope="module")
def jax_models(world):
    return world[1]


@pytest.fixture(scope="module")
def jax_trainer_step(world):
    return world[2]


# ---------------------------------------------------------------- tests


def test_shard_batch_takes_each_ranks_rows():
    batch = {"left": np.arange(8)[:, None], "seg_labels": np.arange(8)}
    got = [shard_batch(batch, DataMesh(r, 4)) for r in range(4)]
    for r, part in enumerate(got):
        np.testing.assert_array_equal(part["seg_labels"], [2 * r, 2 * r + 1])
        assert part["left"].shape == (2, 1)
    for k, v in shard_batch(batch, SINGLE).items():
        np.testing.assert_array_equal(v, batch[k])


def test_shard_batch_raises_the_references_error():
    with pytest.raises(ValueError, match="not divisible by the data-parallel"
                                         " mesh axis \\(4 devices\\)"):
        shard_batch({"left": np.zeros((6, 2))}, DataMesh(0, 4))


@pytest.mark.parametrize("shuffle,drop_last,length", [
    (False, True, 9), (True, True, 9), (True, False, 9), (False, False, 5)])
def test_loader_ranks_together_are_one_process(shuffle, drop_last, length):
    """Each rank decodes its rows of every global batch; the ranks'
    batches together are the single process's, in order, the last one
    padded by its last sample and masked."""
    ds = SyntheticPerceptionDataset(length=length, hw=(8, 8))
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3, num_workers=1)
    want = list(DataLoader(ds, B, **kw))
    got = [list(DataLoader(ds, B, mesh=DataMesh(r, N), **kw))
           for r in range(N)]
    assert len(got[0]) == len(got[1]) == len(want)
    for i, w in enumerate(want):
        left = np.concatenate([g[i]["left"] for g in got])
        n = len(w["left"])
        np.testing.assert_array_equal(left[:n], w["left"])
        np.testing.assert_array_equal(left[n:], np.repeat(
            w["left"][-1:], B - n, axis=0))
        if drop_last:
            assert "_sample_mask" not in got[0][i]
        else:
            mask = np.concatenate([g[i]["_sample_mask"] for g in got])
            np.testing.assert_array_equal(mask, np.arange(B) < n)


def test_loader_refuses_a_batch_the_ranks_do_not_divide():
    ds = SyntheticPerceptionDataset(length=4, hw=(8, 8))
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(ds, 3, mesh=DataMesh(0, N))


def test_ranks_ran(ranks):
    assert [(r["rank"], r["size"]) for r in ranks] == [(0, N), (1, N)]


@pytest.mark.parametrize("name", list(JAX_LOSSES))
def test_loss_on_two_ranks_is_jaxs_on_the_global_batch(name, jax_losses,
                                                       ranks):
    """Each rank's value is the global batch's; its gradient with respect
    to its own rows is N times the global gradient's rows
    (``parallel/mesh.py``'s convention: the parameters' gradients are then
    averaged over the ranks)."""
    want, want_grad = jax_losses[name]
    rows = [slice(0, B // N), slice(B // N, B)]
    for r, res in enumerate(ranks):
        value, grad = res["losses"][name]
        assert value == pytest.approx(want, rel=1e-5), (r, value, want)
        if isinstance(grad, dict):
            pairs = [(grad[lv], want_grad[lv]) for lv in want_grad]
        else:
            pairs = [(grad, want_grad)]
        for g, w in pairs:
            assert rel(g / N, w[rows[r]]) <= 1e-5, (r, rel(g / N, w[rows[r]]))


@pytest.mark.parametrize("name", MASKED)
def test_naive_per_rank_mean_fails(name, jax_losses):
    """The control: the mean of each rank's own loss (the port's function
    on one rank's rows, no mesh) is not the global batch's."""
    key, fn = dp_ranks.LOSSES[name]
    x = loss_inputs()
    naive = np.mean([float(fn(SINGLE, dp_ranks.torch_tree(
        {k: v for k, v in x.items()}, rows))) for rows in (
        slice(0, B // N), slice(B // N, B))])
    want = jax_losses[name][0]
    assert abs(naive - want) > 1e-3 * abs(want), (name, naive, want)


def test_sum_backward_sums_the_ranks_gradients(ranks):
    """``DataMesh.sum``'s backward is the all-reduce of the upstream
    gradients: each rank's gradient of the same global loss is N times
    its share."""
    for res in ranks:
        np.testing.assert_array_equal(res["convention"]["sum_grad"],
                                      np.full(3, float(N)))


def test_max_shares_its_gradient_among_ties_across_ranks(ranks):
    """JAX's max shares the gradient among tied maxima: 3 on both ranks,
    each gets half (times N)."""
    want = [np.array([0.0, 1.0]), np.array([1.0, 0.0])]
    for res, w in zip(ranks, want):
        assert res["convention"]["max"] == 3.0
        np.testing.assert_array_equal(res["convention"]["max_grad"],
                                      w * 0.5 * N)


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_dp_gradients_match_jax_mesh(name, jax_models, ranks):
    """The ranks' all-reduced gradients are the JAX make_mesh(2, 1) run's
    (tests/test_parallel.py's models and tolerances)."""
    _, _, want_loss, want = jax_models[name]
    for res in ranks:
        loss, grads = res["models"][name]
        assert loss == pytest.approx(want_loss, rel=2e-5)
        assert sorted(grads) == sorted(want)
        for n, g in grads.items():
            np.testing.assert_allclose(g, want[n], rtol=3e-4, atol=2e-6,
                                       err_msg=n)


class TestTrainerStepAgainstJaxTwoDevices:
    def test_loss_components(self, jax_trainer_step, ranks):
        want = jax_trainer_step[3]
        assert sorted(want) == ["disp", "flow", "seg", "total"]
        for res in ranks:
            got = res["trainer_step"]["comps"]
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k

    def test_gradients(self, jax_trainer_step, ranks):
        want = jax_trainer_step[4]
        for res in ranks:
            grads = res["trainer_step"]["grads"]
            assert sorted(grads) == sorted(want)
            for n, g in grads.items():
                assert rel(g, want[n]) <= 1e-4, n

    def test_masters_after_one_step(self, jax_trainer_step, ranks):
        want = jax_trainer_step[5]
        for res in ranks:
            for n, m in res["trainer_step"]["masters"].items():
                assert rel(m, want[n]) <= 1e-4, n
        for n, m in ranks[0]["trainer_step"]["masters"].items():
            np.testing.assert_array_equal(
                m, ranks[1]["trainer_step"]["masters"][n], err_msg=n)

    def test_each_ranks_own_gradients_fail_the_check(self, jax_trainer_step,
                                                     ranks):
        """The control: a rank's gradient before the all-reduce (its rows'
        share, N times) is not the global one, nor is it halved."""
        want = jax_trainer_step[4]
        for res in ranks:
            own = res["trainer_step"]["own_grads"]
            for scale in (1.0, 1.0 / N):
                worst = max(rel(scale * g, want[n]) for n, g in own.items())
                assert worst > 1e-2, worst


def test_augmented_steps_match_one_process(ranks):
    """Flip, crop and jitter drawn for the global batch on every rank, each
    keeping its rows: two steps' losses and the masters after them are one
    process's."""
    tr = Trainer(ExperimentConfig.from_dict(single(config(data=AUGMENT))),
                 device="cpu")
    want = [{k: float(v) for k, v in tr.train_step(b).items()}
            for b in augmented_batches()]
    for res in ranks:
        got = res["augmented"]
        for g, w in zip(got["comps"], want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-5), k
        for n, m in got["masters"].items():
            assert rel(m, tr.masters[n].numpy()) <= 1e-5, n


def test_evaluate_with_a_partial_batch_matches_one_process(ranks):
    """5 held-out samples in global batches of 4: the second holds one
    sample, padded before it is sliced, so rank 1 holds padding alone."""
    raw = config(data={"eval_split": "val", "synthetic_length": 5})
    want = Trainer(ExperimentConfig.from_dict(single(raw)),
                   device="cpu").evaluate()
    for res in ranks:
        got = res["evaluate"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k] == pytest.approx(w, rel=1e-5, abs=1e-7), k


def test_checkpoint_written_once_and_restored_on_every_rank(ranks):
    paths = [res["checkpoint"]["path"] for res in ranks]
    assert paths[1] is None and paths[0].endswith("ckpt_00000001.pt")
    for res in ranks:
        ck = res["checkpoint"]
        assert ck["files"] == ["ckpt_00000001.pt"]
        assert ck["step"] == 1
        for n, m in ck["masters"].items():
            np.testing.assert_array_equal(ck["resumed"][n], m, err_msg=n)


def test_fused_levels_are_off_under_two_ranks(ranks):
    """As the reference turns pallas_levels off under a data mesh of more
    than one device (one process keeps them:
    test_torch_train.py's test_fused_encoder_levels_are_supported)."""
    for res in ranks:
        assert res["pallas_levels"] == {"config": 0, "fused": 0}


def test_cli_trains_on_two_ranks(tmp_path, monkeypatch):
    """``train.num_data_devices: 2`` makes the CLI spawn two ranks (gloo on
    the CPU) that fit one epoch; rank 0 alone writes the checkpoint and
    the log row."""
    import json

    from cerberusnet_torch import cli

    raw = config(model={"dtype": "float32"},
                 data={"synthetic_length": 2 * B},
                 train={"ckpt_dir": str(tmp_path / "ckpt")})
    path = tmp_path / "dp.json"
    path.write_text(json.dumps(raw))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch threads
    assert cli.main(["--config", str(path), "--device", "cpu"]) == 0
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ckpt_00000002.pt", "train_log.csv"]
    rows = (tmp_path / "ckpt" / "train_log.csv").read_text().splitlines()
    assert len(rows) == 2  # the header and epoch 0


def test_launch_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed:(.|\n)*"
                                           "ArithmeticError: rank 1 fails"):
        launch(dp_ranks.fail_on, N, args=(1,), timeout=120)


def test_launch_raises_when_the_ranks_overrun():
    with pytest.raises(TimeoutError, match="did not end within 2 s"):
        launch(dp_ranks.sleep, N, args=(60,), timeout=2)


class TestTrainerOptionsAgainstJaxTwoDevices:
    """The data-parallel step's options against the JAX Trainer's
    two-device step."""

    def test_bf16_gradients(self, jax_trainer_step, ranks):
        """grads_dtype="bfloat16": each rank's all-reduced gradients (the
        mean of the ranks' bf16-rounded ones) within one bf16 ulp of
        relative L2 of JAX's bf16-mode gradients, as one process's are
        (tests/test_torch_fit.py); and they are not the float32 ones."""
        want = jax_trainer_step[6]
        for res in ranks:
            grads = res["trainer_bf16"]["grads"]
            assert sorted(grads) == sorted(want)
            for n, g in grads.items():
                assert rel(g, want[n]) <= 2**-7, (n, rel(g, want[n]))
            f32 = res["trainer_step"]["grads"]
            assert any(not np.array_equal(g, f32[n])
                       for n, g in grads.items())

    def test_accumulation_masters_after_two_calls(self, jax_trainer_step,
                                                  ranks):
        """accum_steps=2: no master moves at the first call; after the
        second they are the JAX MultiSteps update of the two calls' mean
        gradient, equal on both ranks."""
        want = jax_trainer_step[7]
        for res in ranks:
            got = res["trainer_accum"]
            for n, m in got["first"].items():
                np.testing.assert_array_equal(
                    m, jax_trainer_step[2][n], err_msg=n)
            for n, m in got["masters"].items():
                assert rel(m, want[n]) <= 1e-4, (n, rel(m, want[n]))
        for n, m in ranks[0]["trainer_accum"]["masters"].items():
            np.testing.assert_array_equal(
                m, ranks[1]["trainer_accum"]["masters"][n], err_msg=n)
