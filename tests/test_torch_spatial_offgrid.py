"""The spatial mesh axis at an H that is no multiple of 2^6 on the CPU
(``cerberusnet_torch/parallel/mesh.py``'s nested bands over XLA's "SAME"
extents, ``models/common.py``'s band resize at any ratio): image rows
split over 4 gloo ranks seen as a 1 x 4 and a 2 x 2 (data x spatial) mesh,
against the JAX package's ``make_mesh(1, 4)`` / ``make_mesh(2, 2)`` on the
conftest's 8 fake devices, and against one port process.

The ranks are spawned once for the module (``tests/dp_ranks.py``'s
``offgrid_suite``, which imports no JAX) while the test process compiles
the JAX side, one model a mesh (a sharded JAX compile of these takes
20-40 s on the CPU).

The bands. At 368 rows the extents are 368/184/92/46/23/12/6: on 2 ranks
the coarsest 6 split 3/3, level 4's 23 rows 11/12 (rank 1 starts on row 11,
under the stride-2 block's top pad) and the frame 176/192. The rule is
checked at H in {200, 288, 368, 400} under S in {2, 4} wherever S divides
H and H // 64 >= S (the reference's guard); at every H that is a multiple
of 64 (tests/test_torch_spatial.py's and test_torch_spatial_dcv_raft.py's)
each level's band is f times its coarsest rows, as before.

Models (``dp_ranks.OFFGRID_MODELS``: every DCV and RAFT variant and SegNet
with either head, tests/test_torch_spatial_dcv_raft.py's tiny widths; B =
2). Against one port process in float64 on both sides, the loss within
1e-5 relative and each parameter's all-reduced gradient within 1e-5
relative L2, at 288 x 64 and 368 x 64 on both meshes and at 200 x 64 on
2 x 2. The ranks run float64 there because a float32 gradient of the RAFT
models can step over a kink of the loss: CerberusRAFT's at 288 x 64 (seed
50) moved 1.39e-3 relative on 2 x 2 in float32, and one process's float64
gradient moves the same 1.39e-3 when its left frame is scaled by 1 + 1e-5
noise, while the float64 ranks are within 2.8e-8 of it
(scripts/spatial_float32_kink.py). Against JAX's
sharded run in float32 (the reference's tests/test_parallel.py
tolerances: loss rtol 2e-5, gradients rtol 3e-4 / atol 2e-6; JAX's
correlations "purev"): CerberusDCV at 288 x 64 on 1 x 4 and CerberusRAFT
at 368 x 64 on 2 x 2.

The band resize: the FPN's ratios 4 -> 7, 7 -> 13 and 13 -> 25 at 200 rows
on 2 x 2 and 12 -> 23 at 368 rows on 1 x 4, on the ranks' own bands,
against the whole frame's ``F.interpolate`` cut to the band (float64) and
by ``gradcheck``; in bf16 (``dp_ranks.BF16_RESIZES``: those ratios, x2 on
and off the grid in both forms and x4, each at a width below and above
the height), bit for bit against the whole frame's ``_resize`` (or phase
form) cut to the band and against JAX's resize sharded over the mesh. The trainers of the tiny CerberusDCV and CerberusRAFT at
200 x 64 on 2 x 2 (one step from the same masters, then ``evaluate`` of 3
held-out samples) against one process. The refusals: H not divisible by S
and the reference's guard raise before any rank is made; CerberusDCV and
CerberusRAFT at 202 x 64 raise on every rank the error one
process raises (the ground truth's 2x2 pool of 101 rows); CerberusNet,
FlowNet and StereoNet at 352 x 64 raise the warp's ValueError on every rank
(ROADMAP C10).

RMI across the bands (``train/losses.py``'s ``_pooled_band``: each 4x4
window pooled on the rank holding its first row): SegNet with either head
and ``rmi_weight`` 0.5 at 202 x 64 on 2 x 2 (bands of 74/128 rows, the
second starting inside a window) and at 288 x 64 on 1 x 4 against one
float64 process, loss within 1e-5 relative and gradients within 1e-5
relative L2; the RMI term alone at 202 x 64 on 2 x 2 against JAX's
``rmi_loss`` sharded over ``make_mesh(1, 2)`` at tests/test_parallel.py's
tolerances.
"""

import concurrent.futures
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.models import CerberusDCV as JaxCerberusDCV
from cerberusnet_tpu.models import CerberusRAFT as JaxCerberusRAFT
from cerberusnet_tpu.parallel import make_mesh as jax_make_mesh
from cerberusnet_tpu.parallel import replicated_sharding
from cerberusnet_tpu.parallel import shard_batch as jax_shard_batch
from cerberusnet_tpu.train import losses as jl
from cerberusnet_torch.data.loader import batches
from cerberusnet_torch.parallel import launch
from cerberusnet_torch.parallel.mesh import (
    SINGLE,
    DataMesh,
    level_extents,
    nested_bands,
)
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer, check_spatial_mesh
from tests import dp_ranks
from tests.jax_pairs import numpy_tree
from tests.test_torch_spatial import (
    flax_tree,
    loss_inputs,
    model_batch,
    one_process_trainer,
    rel,
    spatial_config,
    spatial_raw,
)
from tests.test_torch_train import tiny_config_dict

N = dp_ranks.SPATIAL_RANKS
LEVELS = len(dp_ranks.TINY_ENC)
W = 64
# (H, S) where S divides H and H // 64 >= S
SETTINGS = [(h, s) for h in (200, 288, 368, 400) for s in (2, 4)
            if h % s == 0 and h // 2**LEVELS >= s]
# the frames and spatial extents of the earlier spatial suites and of
# chip_smoke.py's train_spatial parts (a) and (c)
GRID_SETTINGS = [(256, 2), (256, 4), (320, 2), (320, 4), (384, 4),
                 (512, 2)]
MODEL_CASES = [(h, f"{d}x{s}", name)
               for h, shapes in dp_ranks.OFFGRID_MESHES.items()
               for d, s in shapes for name in dp_ranks.OFFGRID_MODELS]
RESIZE_CASES = [(h, f"{a} {b}") for h, (_, pairs)
                in dp_ranks.OFFGRID_RESIZES.items() for a, b in pairs]
BF16_RESIZE_CASES = [(h, a, b, w, form)
                     for h, (_, pairs) in dp_ranks.BF16_RESIZES.items()
                     for a, b in pairs for w in dp_ranks.BF16_RESIZE_WIDTHS
                     for form in dp_ranks.bf16_resize_forms(a, b, w)]
REFUSED = [f"{name} {h}" for h, _, names in dp_ranks.OFFGRID_REFUSED
           for name in names]
VARIANTS = ("cerberus_dcv", "dcv_flow", "dcv_stereo", "cerberus_raft",
            "raft", "raft_stereo", "seg")

# the JAX side: (model, H, mesh) -> the JAX model
JAX_MODELS = {
    ("CerberusDCV", 288, "1x4"): lambda: JaxCerberusDCV(
        encoder_channels=dp_ranks.TINY_ENC, num_classes=5, fpn_channels=16,
        corr_impl="purev", **dp_ranks.DCV_DEC),
    ("CerberusRAFT", 368, "2x2"): lambda: JaxCerberusRAFT(
        encoder_channels=dp_ranks.TINY_ENC, num_classes=5, fpn_channels=16,
        **dp_ranks.RAFT_DEC),
}
# the trainers' models: their widths as the models' above
TRAINER_MODELS = {
    "cerberus_dcv": {"est_channels": list(dp_ranks.DCV_DEC["est_channels"]),
                     "ctx_channels": list(dp_ranks.DCV_DEC["ctx_channels"])},
    "cerberus_raft": {f"raft_{k}": v for k, v in dp_ranks.RAFT_DEC.items()},
}
TRAINER_HW = (200, W)
RMI_WEIGHT = 0.5
RMI_CASES = [(h, name) for h, (_, names) in dp_ranks.OFFGRID_RMI.items()
             for name in names]


def mesh_of(rank, spatial, h):
    return DataMesh(rank=rank, size=spatial, spatial_size=spatial,
                    extents=level_extents(h, LEVELS))


def trainer_payload(variant):
    """The tiny ``variant`` at 200 x 64 (batch 2, 3 held-out samples):
    its config, its initial masters and one batch."""
    raw = tiny_config_dict()
    raw["model"].update(variant=variant, num_classes=5,
                        **TRAINER_MODELS[variant])
    raw["data"].update(hw=list(TRAINER_HW), batch_size=2,
                       synthetic_length=3, eval_split="val")
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    return {"raw": raw, "masters": dp_ranks.as_numpy(tr.masters),
            "batch": batches(tr.dataset, 2, 1)[0]}


def spec(name, seed, h, models=dp_ranks.OFFGRID_MODELS):
    return {"model": name, "batch": model_batch(seed, hw=(h, W)),
            "params": flax_tree(models[name][0](), seed)}


def specs():
    """{"models": {h: {name: spec}}, "refused": {"name h": spec}, "rmi":
    {h: {name: spec}}, "rmi_term": the RMI term's inputs}, each spec a
    model name, random flax parameters and a batch (RMI's with its
    ``rmi_weight``)."""
    models = {h: {name: spec(name, 50 + i, h)
                  for i, name in enumerate(dp_ranks.OFFGRID_MODELS)}
              for h in dp_ranks.OFFGRID_MESHES}
    refused = {f"{name} {h}": spec(name, 80 + i, h,
                                   dp_ranks.OFFGRID_REFUSED_MODELS)
               for h, _, names in dp_ranks.OFFGRID_REFUSED
               for i, name in enumerate(names)}
    rmi = {h: {name: {**spec(name, 90 + i, h), "rmi_weight": RMI_WEIGHT}
               for i, name in enumerate(names)}
           for h, (_, names) in dp_ranks.OFFGRID_RMI.items()}
    term = loss_inputs(seed=3, h=dp_ranks.OFFGRID_RMI_TERM[0], w=W)
    return {"models": models, "refused": refused, "rmi": rmi,
            "rmi_term": {k: term[k] for k in ("seg_logits", "seg_labels")}}


def jax_rmi_term(inputs):
    """(value, gradient with respect to the logits) of JAX's ``rmi_loss``
    with its inputs sharded over ``make_mesh(1, 2)``."""
    mesh = jax_make_mesh(1, 2)
    x = jax_shard_batch(inputs, mesh)
    value, grad = jax.jit(jax.value_and_grad(jl.rmi_loss))(
        x["seg_logits"], x["seg_labels"])
    return float(value), np.asarray(grad)


def jax_value_and_grads(spec_tree):
    """{(model, H, mesh): (loss, gradients by the port's names)} of the
    JAX models on their meshes, the batch sharded over ('data',
    'spatial') and the parameters replicated."""
    out = {}
    for (name, h, m), make in JAX_MODELS.items():
        model = make()
        keys = dp_ranks.OFFGRID_MODELS[name][1]
        sp = spec_tree["models"][h][name]

        def loss_fn(p, bd, model=model, keys=keys):
            out = model.apply({"params": p}, *(bd[k] for k in keys))
            return jl.joint_loss(out, bd)[0]

        mesh = jax_make_mesh(*map(int, m.split("x")))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.device_put(sp["params"], replicated_sharding(mesh)),
            jax_shard_batch(sp["batch"], mesh))
        ref = dp_ranks.load_flax_params(
            dp_ranks.OFFGRID_MODELS[name][0](), numpy_tree(grads))
        out[(name, h, m)] = (float(loss), {
            n: p.detach().numpy() for n, p in ref.named_parameters()})
    return out


def jax_bf16_resizes():
    """{(H, hs, hd, w, form): JAX's bf16 resize of the case's frame with its
    rows sharded over the H's (data, spatial) mesh, NCHW float32}:
    ``jax.image.resize`` bilinear, and ``upsample2x_phase`` for the phase
    form; one program an H."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from cerberusnet_tpu.models.common import upsample2x_phase

    out = {}
    for h, (shape, _) in dp_ranks.BF16_RESIZES.items():
        rows = NamedSharding(jax_make_mesh(*shape), P("data", "spatial"))
        cases = [c for c in BF16_RESIZE_CASES if c[0] == h]

        def resize(v, case):
            _, _, hd, w, form = case
            v = jax.lax.with_sharding_constraint(v, rows)
            if form == "phase":
                y = upsample2x_phase(v)
            else:
                ww = dp_ranks.bf16_resize_forms(case[1], hd, w)[form][1]
                y = jax.image.resize(v, (v.shape[0], hd, ww, v.shape[3]),
                                     "bilinear")
            return jax.lax.with_sharding_constraint(y, rows)

        frames = [jnp.asarray(dp_ranks.bf16_resize_input(c[1], c[3]).float()
                              .permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
                  for c in cases]
        ys = jax.jit(lambda xs, cases=cases: [
            resize(x, c) for x, c in zip(xs, cases)])(frames)
        for c, y in zip(cases, ys):
            out[c] = np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2)
    return out


def one_process_side(spec_tree):
    """The port's one process in float64 on the same models, its
    refusals, and SegNet with RMI."""
    def grads(tree):
        return {h: {name: dp_ranks.model_grads(
            SINGLE, sp, dp_ranks.OFFGRID_MODELS, torch.float64)
            for name, sp in by_name.items()} for h, by_name in tree.items()}

    refused = {k: dp_ranks.refusal(SINGLE, sp,
                                   dp_ranks.OFFGRID_REFUSED_MODELS)
               for k, sp in spec_tree["refused"].items()}
    return grads(spec_tree["models"]), refused, grads(spec_tree["rmi"])


@pytest.fixture(scope="module")
def world():
    """(specs, the ranks' results, the JAX side, the trainers' payloads,
    one process's side): the ranks run while the test process computes
    the JAX side and then one process's."""
    spec_tree = specs()
    trainers = {v: trainer_payload(v) for v in TRAINER_MODELS}
    payload = {**spec_tree, "trainers": trainers,
               "jax": [(h, tuple(map(int, m.split("x"))), name)
                       for name, h, m in JAX_MODELS]}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, dp_ranks.offgrid_suite, N,
                            args=(payload,),
                            timeout=dp_ranks.RANKS_TIMEOUT_S)
        jax_side = jax_value_and_grads(spec_tree)
        jax_side["rmi_term"] = jax_rmi_term(spec_tree["rmi_term"])
        jax_side["bf16_resize"] = jax_bf16_resizes()
        one = one_process_side(spec_tree)
        return spec_tree, ranks.result(), jax_side, trainers, one


@pytest.fixture(scope="module")
def one_process(world):
    return world[4]


# ------------------------------------------------------------- the bands


@pytest.mark.parametrize("h,spatial", SETTINGS)
def test_bands_tile_every_level(h, spatial):
    """Every rank holds at least one row at every level, the bands tile
    each level's extent, and each rank reads its split back from its own
    band's height."""
    extents = level_extents(h, LEVELS)
    for rank in range(spatial):
        mesh = mesh_of(rank, spatial, h)
        for extent, heights in zip(extents, mesh.bands):
            assert min(heights) >= 1 and sum(heights) == extent
            rows = mesh.rows(extent)
            hb = rows.stop - rows.start
            assert hb == heights[rank]
            assert mesh.band_heights(hb) == heights
            assert mesh.band_start(hb) == rows.start
            assert mesh.frame_rows(hb) == extent


@pytest.mark.parametrize("h,spatial", SETTINGS)
def test_a_stride2_window_is_the_band_and_a_row_below(h, spatial):
    """Output row o of a stride-2 "SAME" block reads input rows 2o - pt ..
    2o - pt + 2 (pt = 1 at an odd extent): a band's outputs read its input
    band and the row below, and rank 0 the zero row above at an odd
    extent."""
    extents = level_extents(h, LEVELS)
    for rank in range(spatial):
        mesh = mesh_of(rank, spatial, h)
        for fine, coarse in zip(extents, extents[1:]):
            out, inp = mesh.rows(coarse), mesh.rows(fine)
            pt = fine % 2
            first, last = 2 * out.start - pt, 2 * (out.stop - 1) - pt + 2
            assert (first, last) == (inp.start - (pt if rank == 0 else 0),
                                     inp.stop)


@pytest.mark.parametrize("h,spatial", SETTINGS)
def test_the_frame_band_is_8x_the_level3_band(h, spatial):
    """Where H is a multiple of 8 the convex x8 upsampling's and the ground
    truth's 2x2 pools' bands are aligned: every extent the cascade pools
    to level 3 is even, so each band at levels 0-2 starts on an even row
    and holds an even number, and the frame band is 8 times level 3's."""
    extents = level_extents(h, LEVELS)
    for rank in range(spatial):
        mesh = mesh_of(rank, spatial, h)
        for extent in extents[:3]:
            rows = mesh.rows(extent)
            assert extent % 2 == 0
            assert rows.start % 2 == 0 and (rows.stop - rows.start) % 2 == 0
        full, l3 = mesh.rows(h), mesh.rows(extents[3])
        assert (full.start, full.stop) == (8 * l3.start, 8 * l3.stop)


@pytest.mark.parametrize("h,spatial", GRID_SETTINGS)
def test_bands_on_the_grid_are_multiples_of_the_coarsest(h, spatial):
    """At an H that is a multiple of 2^6 the nested bands are the earlier
    rule's: each level's band f = 2^(6 - l) times its coarsest rows, the
    first R mod S ranks a coarsest row more."""
    extents = level_extents(h, LEVELS)
    q, extra = divmod(extents[-1], spatial)
    coarsest = [q + (s < extra) for s in range(spatial)]
    assert nested_bands(extents, spatial) == tuple(
        tuple(r * (e // extents[-1]) for r in coarsest) for e in extents)
    for rank in range(spatial):
        grid = DataMesh(rank=rank, size=spatial, spatial_size=spatial,
                        coarsest_rows=extents[-1])
        assert grid.bands == mesh_of(rank, spatial, h).bands


def test_the_examples_of_the_rule():
    """368 on 2 ranks: 176/192 rows, level 4 split 11/12; 400 on 4:
    80/128/128/64; 200 on 2: 72/128."""
    bands = nested_bands(level_extents(368, LEVELS), 2)
    assert bands[0] == (176, 192) and bands[4] == (11, 12)
    assert nested_bands(level_extents(400, LEVELS), 4)[0] == (80, 128, 128,
                                                              64)
    assert nested_bands(level_extents(200, LEVELS), 2)[0] == (72, 128)


def test_a_mesh_refuses_bands_whose_height_names_no_level():
    """A band is looked up by its height in its rank's table: a frame of 3
    rows over a coarsest level of 2 gives rank 0 one row at both levels,
    and the mesh refuses it; extents that disagree with coarsest_rows are
    refused too (200 // 2^6 = 3, where the frame's coarsest extent is 4)."""
    with pytest.raises(ValueError, match="does not name its level"):
        DataMesh(rank=0, size=2, spatial_size=2, extents=(3, 2))
    with pytest.raises(ValueError, match="not the coarsest"):
        DataMesh(rank=0, size=2, spatial_size=2, coarsest_rows=3,
                 extents=level_extents(200, LEVELS))


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_variant_passes_the_checks_off_the_grid(variant):
    """The variants the reference trains at these H pass the port's check
    and guard, which give the mesh the frame's extents."""
    for h, spatial in SETTINGS:
        cfg = spatial_config(variant, spatial, (h, W))
        cfg.check_supported()
        assert check_spatial_mesh(cfg) == level_extents(h, LEVELS)


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("h", [256, 200])
def test_h_not_divisible_by_s_raises(h):
    """The reference's ``device_put`` places H / S rows a device: an H
    that 3 ranks do not divide raises before any rank is made."""
    with pytest.raises(ValueError, match="should be divisible by 3"):
        Trainer(spatial_config("cerberus_dcv", 3, (h, W)), device="cpu")


def test_the_guard_refuses_200_rows_on_4_ranks():
    """The reference's guard: 200 // 64 = 3 coarsest rows < 4 ranks."""
    with pytest.raises(ValueError, match="exceeds the coarsest"):
        Trainer(spatial_config("cerberus_raft", 4, (200, W)), device="cpu")


@pytest.mark.parametrize("case", REFUSED)
def test_refused_settings_raise_as_one_process(case, world, one_process):
    """Every rank raises the error one process raises (the ground truth's
    2x2 pool of an odd extent; the warp's shape check), of the same
    kind."""
    want = one_process[1][case]
    assert want is not None
    for res in world[1]:
        got = res["refused"][case]
        assert got is not None and got[0] == want[0], (got, want)
        if want[0] == "RuntimeError":  # the rank's batch, the frame's rows
            shape = [re.search(r"shape '\[\d+, (.*)\]' is invalid for input",
                               m).group(1) for m in (want[1], got[1])]
            assert shape[0] == shape[1], (got, want)
        else:
            assert got[1] == want[1]


# ----------------------------------------------------------- band resize


@pytest.mark.parametrize("h,pair", RESIZE_CASES)
def test_band_resize_is_the_frames_cut_to_the_band(h, pair, world):
    for res in world[1]:
        got = res["resize"][h][pair]
        assert got["values"] <= 1e-12, got
        assert got["gradcheck"], got


@pytest.mark.parametrize("h,hs,hd,w,form", BF16_RESIZE_CASES)
def test_bf16_band_resize_is_the_frames_cut_to_the_band(h, hs, hd, w, form,
                                                         world):
    """In bf16 each rank's band is, bit for bit, the port's whole-frame
    resize (``_resize``, or ``upsample2x``'s phase form) cut to the band,
    and that frame is JAX's resize with the rows sharded over the same
    mesh (ROADMAP C16: computed in float32 and rounded once, the band
    differed in 17-49% of its elements)."""
    from cerberusnet_torch.models.common import _resize, upsample2x

    shape = dp_ranks.BF16_RESIZES[h][0]
    x = dp_ranks.bf16_resize_input(hs, w)
    _, ww = dp_ranks.bf16_resize_forms(hs, hd, w)[form]
    frame = (upsample2x(x, impl="phase") if form == "phase"
             else _resize(x, (hd, ww))).float().numpy()
    np.testing.assert_array_equal(
        frame, world[2]["bf16_resize"][h, hs, hd, w, form])
    for r, res in enumerate(world[1]):
        mesh = DataMesh(rank=r, size=N, spatial_size=shape[1],
                        extents=level_extents(h, LEVELS))
        np.testing.assert_array_equal(
            res["bf16_resize"][h][f"{hs} {hd} {w} {form}"],
            frame[:, :, mesh.rows(hd)], err_msg=f"rank {r}")


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("name,h,mesh", list(JAX_MODELS))
def test_models_match_the_jax_mesh(name, h, mesh, world):
    """Each rank's loss and all-reduced gradients are the JAX run's under
    the same mesh (tests/test_parallel.py's tolerances)."""
    want_loss, want = world[2][(name, h, mesh)]
    for res in world[1]:
        loss, grads = res["jax"][f"{name} {h} {mesh}"]
        assert loss == pytest.approx(want_loss, rel=2e-5)
        assert sorted(grads) == sorted(want)
        for n, g in grads.items():
            np.testing.assert_allclose(g, want[n], rtol=3e-4, atol=2e-6,
                                       err_msg=n)


@pytest.mark.parametrize("h,mesh,name", MODEL_CASES)
def test_models_match_one_process(h, mesh, name, world, one_process):
    want_loss, want = one_process[0][h][name]
    for res in world[1]:
        loss, grads = res[f"{h} {mesh}"]["models"][name]
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert sorted(grads) == sorted(want)
        for n, g in grads.items():
            assert rel(g, want[n]) <= 1e-5, (n, rel(g, want[n]))


# -------------------------------------------------------- RMI on bands


@pytest.mark.parametrize("h,name", RMI_CASES)
def test_rmi_across_bands_matches_one_process(h, name, world, one_process):
    """SegNet's loss with RMI on the bands (at 202 rows a pool window
    straddles two bands) is one float64 process's, and the check passes
    the setting."""
    shape = dp_ranks.OFFGRID_RMI[h][0]
    raw = spatial_raw("seg", shape[1], (h, W))
    raw["loss"]["rmi_weight"] = RMI_WEIGHT
    ExperimentConfig.from_dict(raw).check_supported()
    want_loss, want = one_process[2][h][name]
    for res in world[1]:
        loss, grads = res["rmi"][h][name]
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert sorted(grads) == sorted(want)
        for n, g in grads.items():
            assert rel(g, want[n]) <= 1e-5, (n, rel(g, want[n]))


def test_rmi_term_matches_the_jax_mesh(world):
    """The RMI term alone: each rank's value is JAX's sharded one, and its
    gradient with respect to its band N times the frame's rows there
    (tests/test_parallel.py's tolerances)."""
    want, want_grad = world[2]["rmi_term"]
    h, shape = dp_ranks.OFFGRID_RMI_TERM
    for r, res in enumerate(world[1]):
        value, grad = res["rmi_term"]
        assert value == pytest.approx(want, rel=2e-5), (r, value, want)
        mesh = DataMesh(rank=r, size=N, spatial_size=shape[1],
                        extents=level_extents(h, LEVELS))
        band = want_grad[mesh.shard(len(want_grad)), mesh.rows(h)]
        np.testing.assert_allclose(grad / N, band, rtol=3e-4, atol=2e-6)


def test_the_ranks_hold_the_rules_bands(world):
    """368 on 1 x 4: 112/128/64/64 rows; on 2 x 2: 176/192; 200 on 2 x 2:
    72/128."""
    rows = {k: [r[k]["rows"] for r in world[1]]
            for k in ("368 1x4", "368 2x2", "200 2x2")}
    assert rows["368 1x4"] == [[0, 112], [112, 240], [240, 304],
                               [304, 368]]
    assert rows["368 2x2"] == [[0, 176], [176, 368]] * 2
    assert rows["200 2x2"] == [[0, 72], [72, 200]] * 2


@pytest.mark.parametrize("variant", list(TRAINER_MODELS))
def test_trainer_step_matches_one_process(variant, world):
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
