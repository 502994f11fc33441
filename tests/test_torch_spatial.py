"""The spatial mesh axis (``cerberusnet_torch/parallel/mesh.py``,
``parallel/halo.py``) on the CPU: image rows split over 4 gloo ranks, seen
as a 1 x 4 and a 2 x 2 (data x spatial) mesh, against the JAX package's
``make_mesh(1, 4)`` and ``make_mesh(2, 2)`` on the conftest's 8 fake
devices, and against one port process.

The ranks are spawned once for the module (``tests/dp_ranks.py``'s
``spatial_suite``, which imports no JAX) while the test process computes
the JAX side; the tests read both.

Models (tests/test_parallel.py's tiny widths, B = 2 at 256 x 64, so a
level-3 band holds 8 rows on 4 ranks and ASPP's rate-18 branch reaches
three bands away). Against JAX, each model under the reference's own
sharding and tolerances (tests/test_parallel.py: loss rtol 2e-5, gradients
rtol 3e-4 / atol 2e-6), JAX's correlations "purev": CerberusNet (its three
heads, FPN) on 1 x 4; FlowNet and StereoNet on 2 x 2; SegNet with the FPN
and the ASPP head on both. Against one port process, every model (the
joint model with the ASPP head too) on both meshes: the loss within 1e-5,
each parameter's gradient within 1e-5 relative L2. The batch's validity
and ignored labels differ by band (the top rows mostly valid, the bottom
rows mostly not), so a per-band mean is not the frame's.

The losses: each term alone on 1 x 4 against one process; a rank's
gradient with respect to its band is 4 times the frame's (the mesh's
convention). The halo primitives: values against slicing the padded frame
and ``torch.autograd.gradcheck`` in float64. The trainer (tiny CerberusNet
with RMI, the photometric and smoothness terms and uncertainty weighting):
one step and ``evaluate`` (3 held-out samples in batches of 2) on both
meshes against one
process (components and masters within 1e-5 relative, metrics within
1e-5), a checkpoint written once and restored on every rank.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_tpu.models import FlowNet as JaxFlowNet
from cerberusnet_tpu.models import SegNet as JaxSegNet
from cerberusnet_tpu.models import StereoNet as JaxStereoNet
from cerberusnet_tpu.parallel import make_mesh as jax_make_mesh
from cerberusnet_tpu.parallel import replicated_sharding
from cerberusnet_tpu.parallel import shard_batch as jax_shard_batch
from cerberusnet_tpu.train import losses as jl
from cerberusnet_torch.data.loader import batches
from cerberusnet_torch.models.common import set_spatial
from cerberusnet_torch.parallel import launch
from cerberusnet_torch.parallel.halo import gather_rows, halo_rows
from cerberusnet_torch.parallel.mesh import SINGLE, data_ranks, make_mesh
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import flax_conv_paths
from tests import dp_ranks
from tests.jax_pairs import numpy_tree
from tests.test_torch_train import tiny_config_dict

N = dp_ranks.SPATIAL_RANKS
B = 2
HW = (256, 64)
MESHES = [f"{d}x{s}" for d, s in dp_ranks.SPATIAL_MESHES]
# the settings refused as ROADMAP A11c until the axis took them all
A11C_SETTINGS = [("cerberus_dcv", (256, 64)), ("cerberus_raft", (256, 64)),
                 ("raft", (256, 64)), ("cerberus", (320, 64))]

# the JAX side: model -> the mesh it runs on (each model once, both
# meshes used: a JAX compile of these takes 3-35 s on the CPU)
JAX_MODELS = {
    "CerberusNet": (lambda: JaxCerberusNet(
        encoder_channels=dp_ranks.TINY_ENC, num_classes=5, fpn_channels=16,
        corr_impl="purev", **dp_ranks.DEC), ("1x4",)),
    "FlowNet": (lambda: JaxFlowNet(encoder_channels=dp_ranks.TINY_ENC,
                                   corr_impl="purev", **dp_ranks.DEC),
                ("2x2",)),
    "StereoNet": (lambda: JaxStereoNet(encoder_channels=dp_ranks.TINY_ENC,
                                       corr_impl="purev", **dp_ranks.DEC),
                  ("2x2",)),
    "SegNet": (lambda: JaxSegNet(encoder_channels=dp_ranks.TINY_ENC,
                                 num_classes=5, fpn_channels=16), ("2x2",)),
    "SegNetASPP": (lambda: JaxSegNet(encoder_channels=dp_ranks.TINY_ENC,
                                     num_classes=5, fpn_channels=16,
                                     seg_head="aspp"), ("1x4",)),
}
JAX_CASES = [(name, m) for name, (_, meshes) in JAX_MODELS.items()
             for m in meshes]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def banded_valid(rng, b, h, w):
    """90% of the top quarter's pixels valid, 20% of the rest, none of the
    bottom quarter's: each band of 4 sees another share."""
    frac = np.where(np.arange(h) < h // 4, 0.9, 0.2)[None, :, None]
    valid = rng.rand(b, h, w) < frac
    valid[:, 3 * h // 4:] = False
    return valid.astype(np.float32)


def model_batch(seed, b=B, hw=HW):
    rng = np.random.RandomState(seed)
    h, w = hw
    valid = banded_valid(rng, b, h, w)
    labels = rng.randint(0, 5, (b, h, w))
    labels[(rng.rand(b, h, w) < np.linspace(0.1, 0.7, h)[None, :, None])] = 255
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


def jax_loss(name, out, bd):
    if name.startswith("SegNet"):
        return jl.segmentation_loss(out, bd["seg_labels"])
    if name == "FlowNet":
        return jl.multiscale_flow_loss(out["flow_pyramid"], bd["flow_gt"],
                                       bd["flow_valid"])
    if name == "StereoNet":
        return jl.multiscale_disparity_loss(out["disp_pyramid"],
                                            bd["disp_gt"], bd["disp_valid"])
    return jl.joint_loss(out, bd)[0]


def flax_tree(model, seed):
    """Random parameters for ``model`` as the reference's flax tree (by
    ``flax_conv_paths``), at draw_params's scales: kernels ~ N(0,
    1/fan_in), biases ~ N(0, 0.01)."""
    rng = np.random.RandomState(seed)
    tree = {}
    for name, path in flax_conv_paths(model).items():
        conv = model.get_submodule(name)
        w = conv.weight.detach().numpy()
        shape = (w.shape[2], w.shape[3], w.shape[0], w.shape[1]) if isinstance(
            conv, torch.nn.ConvTranspose2d) else w.transpose(2, 3, 1, 0).shape
        leaf = tree
        for key in path:
            leaf = leaf.setdefault(key, {})
        leaf["kernel"] = (rng.randn(*shape) / np.sqrt(
            np.prod(shape[:-1]))).astype(np.float32)
        leaf["bias"] = (0.1 * rng.randn(w.shape[1] if isinstance(
            conv, torch.nn.ConvTranspose2d) else w.shape[0])).astype(
                np.float32)
    return tree


def model_specs():
    """{model: {"model", "params" (a flax tree of numpy), "batch"}} of
    every model of ``dp_ranks.SPATIAL_MODELS``."""
    return {name: {"model": name, "batch": model_batch(i),
                   "params": flax_tree(make(), i)}
            for i, (name, (make, _)) in enumerate(
                dp_ranks.SPATIAL_MODELS.items())}


def jax_value_and_grads(specs):
    """{(model, mesh): (loss, gradients by the port's names)} of the JAX
    models on their meshes, the batch sharded over ('data', 'spatial') and
    the parameters replicated."""
    out = {}
    for name, meshes in ((n, m) for n, (_, m) in JAX_MODELS.items()):
        model = JAX_MODELS[name][0]()
        keys = dp_ranks.SPATIAL_MODELS[name][1]
        spec = specs[name]

        def loss_fn(p, bd, model=model, name=name, keys=keys):
            return jax_loss(name, model.apply({"params": p},
                                              *(bd[k] for k in keys)), bd)

        fn = jax.jit(jax.value_and_grad(loss_fn))
        for m in meshes:
            mesh = jax_make_mesh(*map(int, m.split("x")))
            loss, grads = fn(jax.device_put(spec["params"],
                                            replicated_sharding(mesh)),
                             jax_shard_batch(spec["batch"], mesh))
            ref = dp_ranks.load_flax_params(
                dp_ranks.SPATIAL_MODELS[name][0](), numpy_tree(grads))
            out[(name, m)] = (float(loss), {
                n: p.detach().numpy() for n, p in ref.named_parameters()})
    return out


def loss_inputs(seed=0, b=B, h=64, w=32):
    """The losses' inputs at 64 x 32 (a level-4 band of one row on 4
    ranks): a pyramid of levels 2-4, full-resolution flow, disparity,
    frames and logits, validity and ignored labels that differ by band,
    berHu's largest error in the last band."""
    rng = np.random.RandomState(seed)
    valid = banded_valid(rng, b, h, w)
    labels = rng.randint(0, 5, (b, h, w))
    labels[rng.rand(b, h, w) < np.linspace(0.1, 0.7, h)[None, :, None]] = 255
    disp = (rng.rand(b, h, w) * 20).astype(np.float32)
    disp[b - 1, h - 20, 3] += 200.0
    valid[b - 1, h - 20, 3] = 1.0
    pyr = {lv: (rng.rand(b, h >> lv, w >> lv, 1) * 3).astype(np.float32)
           for lv in (2, 3, 4)}
    return {
        "seg_logits": rng.randn(b, h, w, 5).astype(np.float32)
        * np.linspace(1, 3, h)[None, :, None, None].astype(np.float32),
        "seg_labels": labels.astype(np.int32),
        "flow_pyramid": {lv: rng.randn(b, h >> lv, w >> lv, 2).astype(
            np.float32) for lv in (2, 3, 4)},
        "flow_gt": (rng.randn(b, h, w, 2) * 8).astype(np.float32)
        * valid[..., None],
        "flow_valid": valid,
        "disp_pyramid": pyr, "disp": disp,
        "disp_gt": (rng.rand(b, h, w) * 20).astype(np.float32) * valid,
        "disp_valid": valid,
        "flow": rng.randn(b, h, w, 2).astype(np.float32),
        "left": rng.rand(b, h, w, 3).astype(np.float32),
        "temporal": rng.rand(b, h, w, 3).astype(np.float32),
    }


def trainer_raw():
    """The tiny CerberusNet at 256 x 64, batch 2, with every loss term the
    spatial axis changes, and 3 held-out samples (a partial batch)."""
    raw = tiny_config_dict()
    raw["data"].update(hw=list(HW), batch_size=B, synthetic_length=3,
                       eval_split="val")
    raw["loss"].update(rmi_weight=0.5, photometric_weight=0.1,
                       smoothness_weight=0.1, uncertainty_weighting=True)
    return raw


def one_process_trainer(raw, masters, batch):
    """One process's step from ``masters`` and its evaluation with 3
    held-out samples."""
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    tr.load_masters({k: torch.from_numpy(v) for k, v in masters.items()})
    comps = tr.train_step(batch)
    return ({k: float(v) for k, v in comps.items()},
            dp_ranks.as_numpy(tr.masters), tr.evaluate())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(specs, the ranks' results, the JAX side, the trainer's payload,
    ``one_process_side``): the ranks run while the test process computes
    the JAX side and then one process's."""
    specs = model_specs()
    raw = trainer_raw()
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    batch = batches(tr.dataset, B, 1)[0]
    trainer_payload = {"raw": raw, "batch": batch,
                       "masters": dp_ranks.as_numpy(tr.masters),
                       "dir": str(tmp_path_factory.mktemp("spatial_ckpt"))}
    del tr
    payload = {"models": specs, "trainer": trainer_payload,
               "coarsest_rows": HW[0] // 2**len(dp_ranks.TINY_ENC),
               "losses": loss_inputs(),
               "built": {f"{v} {hw[0]}": spatial_raw(v, N, hw)
                         for v, hw in A11C_SETTINGS}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, dp_ranks.spatial_suite, N,
                            args=(payload,),
                            timeout=dp_ranks.RANKS_TIMEOUT_S)
        jax_side = jax_value_and_grads(specs)
        one = one_process_side(specs, trainer_payload)
        return specs, ranks.result(), jax_side, trainer_payload, one


def one_process_side(specs, tp):
    """The port's one process on the same models, losses and trainer."""
    models = {name: dp_ranks.model_grads(SINGLE, spec)
              for name, spec in specs.items()}
    x = loss_inputs()
    losses = {name: dp_ranks.spatial_loss(name, SINGLE, x)
              for name in dp_ranks.SPATIAL_LOSSES}
    return models, losses, one_process_trainer(tp["raw"], tp["masters"],
                                               tp["batch"])


@pytest.fixture(scope="module")
def one_process(world):
    return world[4]


# ------------------------------------------------------------------ ranks


def test_ranks_hold_their_coordinates(world):
    ranks = world[1]
    assert [r["rank"] for r in ranks] == list(range(N))
    assert [r["1x4"]["coords"] for r in ranks] == [[0, s] for s in range(N)]
    assert [r["2x2"]["coords"] for r in ranks] == [[0, 0], [0, 1], [1, 0],
                                                   [1, 1]]


@pytest.mark.parametrize("name,mesh", JAX_CASES)
def test_models_match_the_jax_mesh(name, mesh, world):
    """Each rank's loss and all-reduced gradients are the JAX run's under
    the same mesh (tests/test_parallel.py's tolerances)."""
    want_loss, want = world[2][(name, mesh)]
    for res in world[1]:
        loss, grads = res[mesh]["models"][name]
        assert loss == pytest.approx(want_loss, rel=2e-5)
        assert sorted(grads) == sorted(want)
        for n, g in grads.items():
            np.testing.assert_allclose(g, want[n], rtol=3e-4, atol=2e-6,
                                       err_msg=n)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(dp_ranks.SPATIAL_MODELS))
def test_models_match_one_process(name, mesh, world, one_process):
    want_loss, want = one_process[0][name]
    for res in world[1]:
        loss, grads = res[mesh]["models"][name]
        assert loss == pytest.approx(want_loss, rel=1e-5)
        for n, g in grads.items():
            assert rel(g, want[n]) <= 1e-5, (n, rel(g, want[n]))


# ----------------------------------------------------------------- losses


@pytest.mark.parametrize("name", list(dp_ranks.SPATIAL_LOSSES))
def test_each_loss_on_four_bands_is_one_process(name, world, one_process):
    """Each rank's value is the frame's; its gradient with respect to its
    band is N times the frame's rows there."""
    want, want_grad = one_process[1][name]
    for r, res in enumerate(world[1]):
        value, grad = res["losses"][name]
        assert value == pytest.approx(want, rel=1e-5), (r, value, want)
        pairs = ([(grad[lv], want_grad[lv]) for lv in want_grad]
                 if isinstance(grad, dict) else [(grad, want_grad)])
        for g, w in pairs:
            hb = w.shape[1] // N
            band = w[:, r * hb:(r + 1) * hb]
            assert rel(g / N, band) <= 1e-5, (r, rel(g / N, band))


@pytest.mark.parametrize("name", ["segmentation", "multiscale_flow",
                                  "multiscale_disparity", "berhu", "rmi"])
def test_naive_per_band_mean_fails(name, one_process):
    """The control: the mean of each band's own loss (the port's function
    on one band, no mesh) is not the frame's."""
    key, fn = dp_ranks.SPATIAL_LOSSES[name]
    x = loss_inputs()
    naive = np.mean([float(fn(SINGLE, dp_ranks.band_tree(
        x, _FakeBand(r)))) for r in range(N)])
    want = one_process[1][name][0]
    assert abs(naive - want) > 1e-3 * abs(want), (name, naive, want)


class _FakeBand:
    """A mesh-like view of band ``r`` of N for ``band_tree`` alone."""

    def __init__(self, r):
        self.r = r

    def shard(self, n):
        return slice(0, n)

    def band(self, batch):
        return {k: v[:, self.rows(v.shape[1])] if v.ndim >= 3 else v
                for k, v in batch.items()}

    def rows(self, h):
        return slice(self.r * h // N, (self.r + 1) * h // N)


# ------------------------------------------------------------------- halo

HALO_KEYS = [f"halo {t} {b} {f}" for t, b, f in dp_ranks.HALO_CASES] + [
    "gather nhwc"]


@pytest.mark.parametrize("case", HALO_KEYS)
def test_halo_values_are_the_padded_frames_rows(case, world):
    for res in world[1]:
        assert res["halo"][case]["values"], case


@pytest.mark.parametrize("case", HALO_KEYS)
def test_halo_gradcheck(case, world):
    for res in world[1]:
        assert res["halo"][case]["gradcheck"], case


@pytest.mark.parametrize("fill", ["zero", "edge"])
def test_halo_on_a_mesh_of_one_is_the_padding(fill):
    x = torch.randn(2, 3, 5, 4)
    got = halo_rows(x, 7, 2, SINGLE, fill)
    mode = "constant" if fill == "zero" else "replicate"
    want = F.pad(x, (0, 0, 7, 2), mode=mode)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert gather_rows(x, SINGLE) is x


# ---------------------------------------------------------------- trainer


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_step_and_evaluate_match_one_process(mesh, world,
                                                     one_process):
    comps, masters, metrics = one_process[2]
    for res in world[1]:
        got = res[mesh]["trainer"]
        assert sorted(got["comps"]) == sorted(comps)
        for k, w in comps.items():
            assert got["comps"][k] == pytest.approx(w, rel=1e-5), k
        for n, m in got["masters"].items():
            assert rel(m, masters[n]) <= 1e-5, (n, rel(m, masters[n]))
        assert sorted(got["evaluate"]) == sorted(metrics)
        for k, w in metrics.items():
            assert got["evaluate"][k] == pytest.approx(w, rel=1e-5,
                                                       abs=1e-7), k


def test_checkpoint_written_once_and_restored_on_every_rank(world):
    paths = [res["1x4"]["trainer"]["path"] for res in world[1]]
    assert paths[0].endswith("ckpt_00000001.pt")
    assert paths[1:] == [None] * (N - 1)
    for res in world[1]:
        t = res["1x4"]["trainer"]
        assert t["files"] == ["ckpt_00000001.pt"] and t["step"] == 1
        for n, m in t["masters"].items():
            np.testing.assert_array_equal(t["resumed"][n], m, err_msg=n)


def test_fused_levels_are_off_under_the_spatial_axis(world):
    for res in world[1]:
        assert res["pallas_levels"] == [0, 0]


# ---------------------------------------------------------- mesh of one


@pytest.mark.parametrize("name", list(dp_ranks.SPATIAL_MODELS))
def test_a_mesh_of_one_is_bit_equal_to_no_mesh(name, world):
    """set_spatial with one process's mesh leaves every module's own
    padding: the forward and backward are bit for bit a copy's built
    without it."""
    spec = world[0][name]
    make, keys = dp_ranks.SPATIAL_MODELS[name]
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


# --------------------------------------------------------------- refusals


def spatial_raw(variant="cerberus", spatial=2, hw=(256, 64), **model):
    raw = tiny_config_dict()
    raw["model"].update(variant=variant, **model)
    raw["data"]["hw"] = list(hw)
    raw["train"]["num_spatial_devices"] = spatial
    return raw


def spatial_config(variant="cerberus", spatial=2, hw=(256, 64), **model):
    return ExperimentConfig.from_dict(spatial_raw(variant, spatial, hw,
                                                  **model))


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("variant,head", [
    ("cerberus", "fpn"), ("cerberus", "aspp"), ("flow", "fpn"),
    ("stereo", "fpn"), ("seg", "fpn"), ("seg", "aspp")])
def test_the_pwc_family_passes_the_check(variant, head, spatial):
    spatial_config(variant, spatial, seg_head=head).check_supported()


@pytest.mark.parametrize("variant,hw", A11C_SETTINGS)
def test_unported_spatial_settings_name_a11c(variant, hw, world):
    """The settings the check refused as ROADMAP A11c until it was ported
    (CerberusDCV, the RAFT family, an H not a multiple of 64 S) pass it,
    and each of the 4 ranks builds its Trainer on them, with its band of
    the rule's (320 rows: the coarsest level's 5 split 2/1/1/1)."""
    spatial_config(variant, N, hw).check_supported()
    bands = [0, 128, 192, 256, 320] if hw[0] == 320 else [0, 64, 128, 192,
                                                          256]
    for s, res in enumerate(world[1]):
        assert res["built"][f"{variant} {hw[0]}"] == {
            "variant": variant, "rows": bands[s:s + 2]}


def test_trainer_rejects_degenerate_spatial_mesh():
    """The reference's guard (tests/test_parallel.py): at 64 x 64 the
    coarsest level has one row, fewer than 4 spatial ranks."""
    with pytest.raises(ValueError, match="spatial"):
        Trainer(spatial_config(spatial=4, hw=(64, 64)), device="cpu")


def test_the_cli_starts_data_times_spatial_ranks():
    assert data_ranks(1, "cpu", 4) == 4
    assert data_ranks(2, "cuda:0", 2) == 4
    assert data_ranks(0, "cpu", 2) == 2
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="num_spatial_devices"):
            data_ranks(2, "cuda", 2)
