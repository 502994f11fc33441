"""The rest of the spatial mesh axis on the CPU: CerberusDCV, the RAFT
family and bands of unequal heights (``cerberusnet_torch/parallel/mesh.py``'s
band rule, ``parallel/halo.py``), image rows split over 4 gloo ranks seen
as a 1 x 4 and a 2 x 2 (data x spatial) mesh, against the JAX package's
``make_mesh(1, 4)`` / ``make_mesh(2, 2)`` on the conftest's 8 fake
devices, and against one port process.

The ranks are spawned once for the module (``tests/dp_ranks.py``'s
``dcv_raft_suite``, which imports no JAX) while the test process compiles
the JAX side, one mesh a model (a sharded JAX compile of these takes about
25 s on the CPU).

Models (``dp_ranks.DCV_RAFT_MODELS``; B = 2). The DCV nets at the tiny
encoder and estimator widths with a context network deep enough for its
dilation-16 block: at 256 x 64 a level-3 band holds 8 rows on 4 ranks, so
the 2-D correlation's 32-row reach at dilation 8 and the context
network's 16-row halo cross bands. The RAFT nets at tests/jax_pairs.py's
tiny widths with 2 iterations over 2 volume levels of radius 2. Unequal
bands: at 320 x 64 the coarsest level's 5 rows split 2/1/1/1 on 1 x 4
(bands of 128/64/64/64 rows) and 3/2 on 2 x 2.

Against JAX's sharded run (the reference's tests/test_parallel.py
tolerances: loss rtol 2e-5, gradients rtol 3e-4 / atol 2e-6; JAX's
correlations "purev"): CerberusDCV at 256 x 64 on 1 x 4 and 2 x 2,
CerberusRAFT at 256 x 64 on 2 x 2 (two data ranks: with the CerberusDCV
case ROADMAP C12's DCV and RAFT item), CerberusNet at 320 x 64 on 1 x 4
(unequal bands). Against one port process (its parameters and batch in
float64), each rank's float32 loss within 1e-5 relative and each
parameter's all-reduced gradient within 1e-5 relative L2: every DCV and
RAFT variant on both meshes, and CerberusDCV, CerberusRAFT and CerberusNet
on unequal bands. The halo primitives on unequal bands (16/8/8/8 rows of a
40-row frame): values against slicing the padded frame and ``gradcheck``
in float64. The trainer of the tiny CerberusDCV and CerberusRAFT on the
unequal bands of 1 x 4 (one step from the same masters, then ``evaluate``
of 3 held-out samples in batches of 2) against one process: loss
components and masters within 1e-5 relative, metrics within 1e-5. A mesh
of one is bit-equal to no mesh for each DCV and RAFT model.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from cerberusnet_tpu.models import CerberusDCV as JaxCerberusDCV
from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_tpu.models import CerberusRAFT as JaxCerberusRAFT
from cerberusnet_tpu.parallel import make_mesh as jax_make_mesh
from cerberusnet_tpu.parallel import replicated_sharding
from cerberusnet_tpu.parallel import shard_batch as jax_shard_batch
from cerberusnet_tpu.train import losses as jl
from cerberusnet_torch.data.loader import batches
from cerberusnet_torch.models.common import set_spatial
from cerberusnet_torch.parallel import launch
from cerberusnet_torch.parallel.mesh import SINGLE, DataMesh, make_mesh
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from tests import dp_ranks
from tests.jax_pairs import numpy_tree
from tests.test_torch_spatial import (
    flax_tree,
    model_batch,
    one_process_trainer,
    rel,
)
from tests.test_torch_train import tiny_config_dict

N = dp_ranks.SPATIAL_RANKS
HW = (256, 64)
UNEQUAL_HW = (dp_ranks.UNEQUAL_H, 64)
LEVELS = len(dp_ranks.TINY_ENC)
MESHES = [f"{d}x{s}" for d, s in dp_ranks.SPATIAL_MESHES]
# every DCV and RAFT variant on equal bands; the joint models on unequal
EQUAL = [n for n in dp_ranks.DCV_RAFT_MODELS if n != "CerberusNet"]
UNEQUAL = ["CerberusDCV", "CerberusRAFT", "CerberusNet"]

# the JAX side: (model, kind of bands) -> (the JAX model, its meshes)
JAX_MODELS = {
    ("CerberusDCV", "models"): (lambda: JaxCerberusDCV(
        encoder_channels=dp_ranks.TINY_ENC, num_classes=5, fpn_channels=16,
        corr_impl="purev", **dp_ranks.DCV_DEC), ("1x4", "2x2")),
    ("CerberusRAFT", "models"): (lambda: JaxCerberusRAFT(
        encoder_channels=dp_ranks.TINY_ENC, num_classes=5, fpn_channels=16,
        **dp_ranks.RAFT_DEC), ("2x2",)),
    ("CerberusNet", "unequal"): (lambda: JaxCerberusNet(
        encoder_channels=dp_ranks.TINY_ENC, num_classes=5, fpn_channels=16,
        corr_impl="purev", **dp_ranks.DEC), ("1x4",)),
}
JAX_CASES = [(name, kind, m) for (name, kind), (_, meshes)
             in JAX_MODELS.items() for m in meshes]


# the trainers' models: their widths as the models' above
TRAINER_MODELS = {
    "cerberus_dcv": {"est_channels": list(dp_ranks.DCV_DEC["est_channels"]),
                     "ctx_channels": list(dp_ranks.DCV_DEC["ctx_channels"])},
    "cerberus_raft": {f"raft_{k}": v for k, v in dp_ranks.RAFT_DEC.items()},
}


def trainer_payload(variant):
    """The tiny ``variant`` at 320 x 64 (batch 2, 3 held-out samples):
    its config, its initial masters and one batch."""
    raw = tiny_config_dict()
    raw["model"].update(variant=variant, num_classes=5,
                        **TRAINER_MODELS[variant])
    raw["data"].update(hw=list(UNEQUAL_HW), batch_size=2,
                       synthetic_length=3, eval_split="val")
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    return {"raw": raw, "masters": dp_ranks.as_numpy(tr.masters),
            "batch": batches(tr.dataset, 2, 1)[0]}


def specs():
    """{"models": {name: spec} at 256 x 64, "unequal": {name: spec} at
    320 x 64}, each spec a model name, random flax parameters and a
    batch."""
    out = {"models": {}, "unequal": {}}
    for kind, names, hw, seed in (("models", EQUAL, HW, 30),
                                  ("unequal", UNEQUAL, UNEQUAL_HW, 40)):
        for i, name in enumerate(names):
            make = dp_ranks.DCV_RAFT_MODELS[name][0]
            out[kind][name] = {"model": name,
                               "batch": model_batch(seed + i, hw=hw),
                               "params": flax_tree(make(), seed + i)}
    return out


def jax_value_and_grads(spec_tree):
    """{(model, kind, mesh): (loss, gradients by the port's names)} of the
    JAX models on their meshes, the batch sharded over ('data', 'spatial')
    and the parameters replicated."""
    out = {}
    for (name, kind), (make, meshes) in JAX_MODELS.items():
        model = make()
        keys = dp_ranks.DCV_RAFT_MODELS[name][1]
        spec = spec_tree[kind][name]

        def loss_fn(p, bd, model=model, keys=keys):
            out = model.apply({"params": p}, *(bd[k] for k in keys))
            return jl.joint_loss(out, bd)[0]

        fn = jax.jit(jax.value_and_grad(loss_fn))
        for m in meshes:
            mesh = jax_make_mesh(*map(int, m.split("x")))
            loss, grads = fn(
                jax.device_put(spec["params"], replicated_sharding(mesh)),
                jax_shard_batch(spec["batch"], mesh))
            ref = dp_ranks.load_flax_params(
                dp_ranks.DCV_RAFT_MODELS[name][0](), numpy_tree(grads))
            out[(name, kind, m)] = (float(loss), {
                n: p.detach().numpy() for n, p in ref.named_parameters()})
    return out


@pytest.fixture(scope="module")
def world():
    """(specs, the ranks' results, the JAX side, the trainers' payloads):
    the ranks run while the test process computes the JAX side."""
    spec_tree = specs()
    payload = {**spec_tree, "coarsest_rows": HW[0] // 2**LEVELS,
               "trainers": {v: trainer_payload(v) for v in TRAINER_MODELS}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, dp_ranks.dcv_raft_suite, N,
                            args=(payload,),
                            timeout=dp_ranks.RANKS_TIMEOUT_S)
        jax_side = jax_value_and_grads(spec_tree)
        return spec_tree, ranks.result(), jax_side, payload["trainers"]


@pytest.fixture(scope="module")
def one_process(world):
    """The port's one process on the same models and batches, its
    parameters and batch in float64 (the losses, and RAFT's volumes,
    lookups and estimates, in float32 as the port keeps them): a whole
    frame's float32 gradient sums round farther from the exact values
    than the bands' (up to 9.3e-6 relative L2 for an encoder bias against
    1.1e-6-1.8e-6 for the ranks' at 320 x 64), so the float32 process
    would be the noisier side of the comparison."""
    return {kind: {name: dp_ranks.model_grads(
        SINGLE, spec, dp_ranks.DCV_RAFT_MODELS, torch.float64)
        for name, spec in specs_.items()}
        for kind, specs_ in world[0].items()}


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("name,kind,mesh", JAX_CASES)
def test_models_match_the_jax_mesh(name, kind, mesh, world):
    """Each rank's loss and all-reduced gradients are the JAX run's under
    the same mesh (tests/test_parallel.py's tolerances)."""
    want_loss, want = world[2][(name, kind, mesh)]
    for res in world[1]:
        loss, grads = res[mesh][kind][name]
        assert loss == pytest.approx(want_loss, rel=2e-5)
        assert sorted(grads) == sorted(want)
        for n, g in grads.items():
            np.testing.assert_allclose(g, want[n], rtol=3e-4, atol=2e-6,
                                       err_msg=n)


def _held_to_one_process(got, want):
    want_loss, want_grads = want
    loss, grads = got
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert sorted(grads) == sorted(want_grads)
    for n, g in grads.items():
        assert rel(g, want_grads[n]) <= 1e-5, (n, rel(g, want_grads[n]))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", EQUAL)
def test_models_match_one_process(name, mesh, world, one_process):
    for res in world[1]:
        _held_to_one_process(res[mesh]["models"][name],
                             one_process["models"][name])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", UNEQUAL)
def test_unequal_bands_match_one_process(name, mesh, world, one_process):
    for res in world[1]:
        _held_to_one_process(res[mesh]["unequal"][name],
                             one_process["unequal"][name])


def test_unequal_bands_are_the_rule(world):
    """The coarsest level's 5 rows: 2/1/1/1 on 1 x 4, 3/2 on 2 x 2."""
    assert [r["1x4"]["rows"] for r in world[1]] == [
        [0, 128], [128, 192], [192, 256], [256, 320]]
    assert [r["2x2"]["rows"] for r in world[1]] == [[0, 192], [192, 320]] * 2


@pytest.mark.parametrize("variant", list(TRAINER_MODELS))
def test_trainer_on_unequal_bands_matches_one_process(variant, world):
    tp = world[3][variant]
    comps, masters, metrics = one_process_trainer(tp["raw"], tp["masters"],
                                                  tp["batch"])
    for res in world[1]:
        got = res["trainers"][variant]
        assert sorted(got["comps"]) == sorted(comps)
        for k, w in comps.items():
            assert got["comps"][k] == pytest.approx(w, rel=1e-5), k
        for n, m in got["masters"].items():
            assert rel(m, masters[n]) <= 1e-5, (n, rel(m, masters[n]))
        assert sorted(got["evaluate"]) == sorted(metrics)
        for k, w in metrics.items():
            assert got["evaluate"][k] == pytest.approx(w, rel=1e-5,
                                                       abs=1e-7), k


# ------------------------------------------------------------- the bands


@pytest.mark.parametrize("coarsest,spatial,want", [
    (5, 4, (2, 1, 1, 1)), (6, 4, (2, 2, 1, 1)), (8, 2, (4, 4)),
    (4, 4, (1, 1, 1, 1)), (7, 2, (4, 3))])
def test_band_rule_at_every_level(coarsest, spatial, want):
    """The first R mod S ranks take one coarsest row more; a level with f
    rows a coarsest one splits alike, and each rank reads the split back
    from its own band's height."""
    for f in (1, 2, 8, 64):
        h = coarsest * f
        starts = np.cumsum((0,) + want)[:-1] * f
        for s in range(spatial):
            mesh = DataMesh(rank=s, size=spatial, spatial_size=spatial,
                            coarsest_rows=coarsest)
            rows = mesh.rows(h)
            assert (rows.start, rows.stop) == (starts[s],
                                               starts[s] + want[s] * f)
            hb = rows.stop - rows.start
            assert mesh.band_heights(hb) == tuple(r * f for r in want)
            assert mesh.band_start(hb) == starts[s]
            assert mesh.frame_rows(hb) == h


def test_band_rule_refuses_rows_off_the_levels():
    mesh = DataMesh(rank=1, size=4, spatial_size=4, coarsest_rows=5)
    with pytest.raises(ValueError, match="coarsest"):
        mesh.rows(96)
    with pytest.raises(ValueError, match="band of 3 rows"):
        DataMesh(rank=0, size=4, spatial_size=4,
                 coarsest_rows=5).band_heights(3)


@pytest.mark.parametrize("coarsest", [0, 3])
def test_spatial_mesh_needs_a_coarsest_row_a_rank(coarsest):
    """A spatial mesh is made only with the coarsest level's rows, at least
    one a rank; a mesh of one needs none."""
    with pytest.raises(ValueError, match="coarsest_rows"):
        DataMesh(rank=0, size=4, spatial_size=4, coarsest_rows=coarsest)
    assert DataMesh(rank=0, size=4).rows(96) == slice(0, 96)


# ------------------------------------------------------------------ halo

HALO_KEYS = [f"halo {t} {b} {f}" for t, b, f in dp_ranks.HALO_CASES] + [
    "gather nhwc"]


@pytest.mark.parametrize("case", HALO_KEYS)
def test_halo_on_unequal_bands_is_the_padded_frames_rows(case, world):
    for res in world[1]:
        assert res["halo"][case]["values"], case


@pytest.mark.parametrize("case", HALO_KEYS)
def test_halo_on_unequal_bands_gradcheck(case, world):
    for res in world[1]:
        assert res["halo"][case]["gradcheck"], case


# ---------------------------------------------------------- mesh of one


@pytest.mark.parametrize("name", EQUAL)
def test_a_mesh_of_one_is_bit_equal_to_no_mesh(name, world):
    """set_spatial with one process's mesh leaves every module's own
    padding: the forward and backward are bit for bit a copy's built
    without it."""
    spec = world[0]["models"][name]
    make, keys = dp_ranks.DCV_RAFT_MODELS[name]
    batch = dp_ranks.torch_tree({k: v[:1, :128] for k, v in
                                 spec["batch"].items()})
    runs = []
    for mesh in (None, make_mesh(0, "cpu", 1)):
        model = dp_ranks.load_flax_params(make(), spec["params"])
        if mesh is not None:
            set_spatial(model, mesh)
        out = model(*(batch[k] for k in keys))
        dp_ranks.model_loss(name, out, batch, SINGLE).backward()
        runs.append([t.detach() for t in _leaves(out)]
                    + [p.grad for p in model.parameters()
                       if p.grad is not None])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _leaves(out):
    for v in out.values():
        yield from (v.values() if isinstance(v, dict) else (v,))
