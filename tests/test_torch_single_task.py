"""The port's single-task models and ASPP segmentation head against the
JAX package, on the CPU, and a Trainer step of each config they unlock.

* ``SegNet`` with the FPN and the ASPP head, ``FlowNet``, ``StereoNet``
  and the three joint models with ``seg_head="aspp"``, at tiny widths
  (the RAFT decoder as ``tests/test_torch_raft.py`` sizes it) on 64x64
  frames, loaded from random flax parameters with ``load_flax_params``:
  JAX's outputs and the gradients of one scalar (each output against a
  fixed random cotangent) with respect to every parameter, from one
  compile (JAX's correlations "purev", its fastest to compile). float32:
  every output within 1e-4 of max(max|JAX|, 1) (test_torch_model.py's
  rule), every module's gradient (its names' first three parts) within
  1e-4 relative L2. bfloat16, each held to JAX's float32: an output within
  twice JAX's own bf16 distance plus 1e-3 (test_torch_raft.py's rule), the
  whole gradient within twice JAX's plus 1e-3 and each module's within 1.5
  times JAX's farthest module (test_torch_raft.py's bf16-step rule). The
  joint models' encoders and decoders have their gradient tests in
  test_torch_model.py, test_torch_dcv.py and test_torch_raft.py, and the
  ASPP head its own through SegNet here, so the joint models with the
  ASPP head are held by their outputs alone (a forward compiles in a
  fraction of a gradient's time).
* ``FlowNet`` and ``StereoNet`` raise the same ValueError as the JAX
  models at 64x200, a width that is no multiple of 64.
* ``load_flax_params`` fills every parameter of each model from the JAX
  tree and uses every leaf; the joint models' ASPP head is named
  ``ASPPSegmentationHead_0``.
* One ``Trainer`` step of each of the six configs the slice unlocks
  (``flow_kitti``, ``stereo_kitti``, ``seg_cityscapes``,
  ``seg_aspp_cityscapes``, ``dcv_flow_kitti``, ``raft_kitti``) at tiny
  widths on fixtures the port's writers make in the test, at a frame size
  the preprocessing resizes; and ``entry()``'s single-task variants.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.models import CerberusDCV as JaxCerberusDCV
from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_tpu.models import FlowNet as JaxFlowNet
from cerberusnet_tpu.models import SegNet as JaxSegNet
from cerberusnet_tpu.models import StereoNet as JaxStereoNet
from cerberusnet_tpu.models.raft import CerberusRAFT as JaxCerberusRAFT
from cerberusnet_torch.data.loader import batches
from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset
from cerberusnet_torch.entry import REPO_ROOT, entry
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.dcv_flow import (
    CerberusDCV,
    DCVFlowNet,
    DCVStereoNet,
)
from cerberusnet_torch.models.disparity import StereoNet
from cerberusnet_torch.models.flow import FlowNet
from cerberusnet_torch.models.raft import CerberusRAFT, keep_tied_float32
from cerberusnet_torch.models.segmentation import (
    ASPPSegmentationHead,
    SegNet,
)
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import load_flax_params
from tests.jax_pairs import draw_params

ENC = (8, 12, 16, 16, 16, 16)
DEC = dict(est_channels=(16, 16, 12), ctx_channels=(16, 16))
RAFT = dict(fdim=16, hdim=16, cdim=8, iters=2)
HW = (64, 64)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _seg(head):
    return dict(encoder_channels=ENC, num_classes=7, fpn_channels=16,
                seg_head=head)


# name: (frames taken, JAX model of a JAX dtype, port model of a torch dtype)
MODELS = {
    "SegNet_fpn": (1, lambda d: JaxSegNet(dtype=d, **_seg("fpn")),
                   lambda d: SegNet(dtype=d, **_seg("fpn"))),
    "SegNet_aspp": (1, lambda d: JaxSegNet(dtype=d, **_seg("aspp")),
                    lambda d: SegNet(dtype=d, **_seg("aspp"))),
    "FlowNet": (2, lambda d: JaxFlowNet(encoder_channels=ENC,
                                        corr_impl="purev", dtype=d, **DEC),
                lambda d: FlowNet(encoder_channels=ENC, dtype=d, **DEC)),
    "StereoNet": (2, lambda d: JaxStereoNet(encoder_channels=ENC,
                                            corr_impl="purev", dtype=d, **DEC),
                  lambda d: StereoNet(encoder_channels=ENC, dtype=d, **DEC)),
    "CerberusNet_aspp": (
        3, lambda d: JaxCerberusNet(corr_impl="purev", dtype=d,
                                    **_seg("aspp"), **DEC),
        lambda d: CerberusNet(dtype=d, **_seg("aspp"), **DEC)),
    "CerberusDCV_aspp": (
        3, lambda d: JaxCerberusDCV(corr_impl="purev", dtype=d,
                                    **_seg("aspp"), **DEC),
        lambda d: CerberusDCV(dtype=d, **_seg("aspp"), **DEC)),
    "CerberusRAFT_aspp": (
        3, lambda d: JaxCerberusRAFT(dtype=d, **_seg("aspp"), **RAFT),
        # the trainer's form: weights used more than once stay float32
        lambda d: keep_tied_float32(CerberusRAFT(dtype=d, **_seg("aspp"),
                                                 **RAFT))),
}


def frames(n, hw=HW, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(1, *hw, 3).astype(np.float32) for _ in range(n)]


def flatten(out):
    """An output dict (or the JAX SegNet's logits) -> {name: array}, the
    pyramids by level."""
    if not isinstance(out, dict):
        out = {"seg_logits": out}
    res = {}
    for key, v in out.items():
        for level, x in (v.items() if isinstance(v, dict) else [(None, v)]):
            res[key if level is None else f"{key}[{level}]"] = x
    return res


def flat(out):
    """flatten's arrays as float32 numpy."""
    return {k: (x.detach().float().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x, np.float32))
            for k, x in flatten(out).items()}


def module_of(name):
    return ".".join(name.split(".")[:3])


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def reference():
    """Per (model, dtype): the random flax parameters, the cotangents, and
    the JAX model's outputs and parameter gradients (mapped to the port's
    names) of sum_k <output_k, cotangent_k>. One compile each."""
    cache = {}

    def get(name, dtype, grads=True):
        if (name, dtype) in cache:
            return cache[name, dtype]
        n, jax_model, port_model = MODELS[name]
        imgs = [jnp.asarray(i) for i in frames(n)]
        model = jax_model(DTYPES[dtype][0])
        if ("params", name) not in cache:
            shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                    *imgs)["params"]
            out_shapes = jax.eval_shape(
                lambda p: flatten(model.apply({"params": p}, *imgs)), shapes)
            rng = np.random.RandomState(9)
            cache["params", name] = (draw_params(shapes, 3), {
                k: rng.randn(*s.shape).astype(np.float32)
                for k, s in out_shapes.items()})
        params, cot = cache["params", name]

        def loss(p):
            out = flatten(model.apply({"params": p}, *imgs))
            total = sum(jnp.vdot(out[k].astype(jnp.float32), cot[k])
                        for k in sorted(out))
            return total, out

        if not grads:
            out = jax.jit(lambda p: loss(p)[1])(params)
            cache[name, dtype] = (params, cot, flat(out), None)
            return cache[name, dtype]
        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        named = dict(load_flax_params(port_model(torch.float32),
                                      jax.tree.map(np.array, g))
                     .named_parameters())
        cache[name, dtype] = (params, cot, flat(out), {
            n: p.detach().numpy() for n, p in named.items()})
        return cache[name, dtype]

    return get


def port_run(name, dtype, params, cot, grads=True):
    """The port's outputs and float32 parameter gradients of the same
    scalar (outputs alone without ``grads``)."""
    n, _, port_model = MODELS[name]
    model = load_flax_params(port_model(DTYPES[dtype][1]), params)
    out = flatten(model(*[torch.from_numpy(i) for i in frames(n)]))
    if not grads:
        return {k: v.float().numpy() for k, v in out.items()}, None
    total = sum((out[k].float() * torch.from_numpy(cot[k])).sum()
                for k in sorted(out))
    total.backward()
    # the encoder levels above the ASPP head's get none, and JAX zeros
    grads = {k: (p.grad.float() if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)).numpy()
             for k, p in model.named_parameters()}
    return {k: v.detach().float().numpy() for k, v in out.items()}, grads


SINGLE = ("SegNet_fpn", "SegNet_aspp", "FlowNet", "StereoNet")
JOINT = ("CerberusNet_aspp", "CerberusDCV_aspp", "CerberusRAFT_aspp")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", JOINT)
def test_joint_model_with_aspp_head_matches_jax(reference, name, dtype):
    params, cot, want32, _ = reference(name, "float32", grads=False)
    want = reference(name, dtype, grads=False)[2]
    with torch.no_grad():
        got = port_run(name, dtype, params, cot, grads=False)[0]
    assert sorted(got) == sorted(want32)
    assert got["seg_logits"].shape == (1, *HW, 7)
    for k in want32:
        if dtype == "float32":
            err = np.abs(got[k] - want[k]).max() / max(
                np.abs(want[k]).max(), 1)
            assert err <= 1e-4, (k, err)
        else:
            jax_gap, port_gap = rel(want[k], want32[k]), rel(got[k],
                                                             want32[k])
            assert port_gap <= 2 * jax_gap + 1e-3, (k, port_gap, jax_gap)


# the naive estimators (fused=False): model, the joint model whose JAX
# run and parameters it takes, the frames it reads (left, right, temporal)
UNFUSED = {
    "CerberusNet": (lambda: CerberusNet(fused=False, **_seg("aspp"), **DEC),
                    "CerberusNet_aspp", (0, 1, 2)),
    "CerberusDCV": (lambda: CerberusDCV(fused=False, **_seg("aspp"), **DEC),
                    "CerberusDCV_aspp", (0, 1, 2)),
    "FlowNet": (lambda: FlowNet(encoder_channels=ENC, fused=False, **DEC),
                "CerberusNet_aspp", (0, 2)),
    "StereoNet": (lambda: StereoNet(encoder_channels=ENC, fused=False,
                                    **DEC), "CerberusNet_aspp", (0, 1)),
    "DCVFlowNet": (lambda: DCVFlowNet(encoder_channels=ENC, fused=False,
                                      **DEC), "CerberusDCV_aspp", (0, 2)),
    "DCVStereoNet": (lambda: DCVStereoNet(encoder_channels=ENC, fused=False,
                                          **DEC), "CerberusDCV_aspp",
                     (0, 1)),
}


@pytest.mark.parametrize("name", list(UNFUSED))
def test_unfused_float32_outputs_match_jax(reference, name):
    """The models with ``fused=False`` (each estimator conv and predictor
    one conv over the concatenated stack) against the JAX joint model's
    float32 outputs (its fused form, which its own tests hold to its naive
    one within 1e-5) within 1e-4: the joint models whole, each single-task
    model on the frames and with the parameters of its head there."""
    make, joint, takes = UNFUSED[name]
    params, _, want, _ = reference(joint, "float32", grads=False)
    model = load_flax_params(make().eval(), params)
    imgs = frames(3)
    with torch.no_grad():
        got = flat(model(*[torch.from_numpy(imgs[i]) for i in takes]))
    assert got and set(got) <= set(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1)
        assert err <= 1e-4, (name, k, err)


@pytest.mark.parametrize("name", SINGLE)
def test_float32_outputs_and_gradients_match_jax(reference, name):
    params, cot, want, jgrads = reference(name, "float32")
    got, grads = port_run(name, "float32", params, cot)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1)
        assert err <= 1e-4, (k, err)
    assert sorted(grads) == sorted(jgrads)
    for mod in sorted({module_of(n) for n in grads}):
        members = sorted(n for n in grads if module_of(n) == mod)
        a = np.concatenate([grads[n].ravel() for n in members])
        b = np.concatenate([jgrads[n].ravel() for n in members])
        assert rel(a, b) <= 1e-4, (mod, rel(a, b))


@pytest.mark.parametrize("name", SINGLE)
def test_bfloat16_outputs_and_gradients_match_jax(reference, name):
    params, cot, want32, j32 = reference(name, "float32")
    _, _, want16, j16 = reference(name, "bfloat16")
    got, grads = port_run(name, "bfloat16", params, cot)
    assert sorted(got) == sorted(want16)
    for k in want32:
        jax_gap, port_gap = rel(want16[k], want32[k]), rel(got[k], want32[k])
        assert port_gap <= 2 * jax_gap + 1e-3, (k, port_gap, jax_gap)
    names = sorted(j32)
    assert sorted(grads) == names

    def cat(g, members):
        return np.concatenate([g[n].ravel() for n in members])

    whole = {"jax": rel(cat(j16, names), cat(j32, names)),
             "port": rel(cat(grads, names), cat(j32, names))}
    assert whole["port"] <= 2 * whole["jax"] + 1e-3, whole
    modules = {}
    for mod in sorted({module_of(n) for n in names}):
        members = [n for n in names if module_of(n) == mod]
        if np.any(cat(j32, members)):
            modules[mod] = (rel(cat(j16, members), cat(j32, members)),
                            rel(cat(grads, members), cat(j32, members)))
    limit = 1.5 * max(j for j, _ in modules.values())
    far = {m: r for m, r in modules.items() if not r[1] <= limit}
    assert not far, (limit, far)


@pytest.mark.parametrize("name", ["CerberusNet_aspp", "CerberusDCV_aspp",
                                  "CerberusRAFT_aspp", "SegNet_aspp"])
def test_aspp_head_named_and_filled_from_jax(reference, name):
    params = reference(name, "float32", grads=name in SINGLE)[0]
    assert "ASPPSegmentationHead_0" in params
    head = params["ASPPSegmentationHead_0"]
    assert sorted(head) == [*(f"ConvBlock_{i}" for i in range(6)),
                            *(f"Conv_{i}" for i in range(4))]
    model = load_flax_params(MODELS[name][2](torch.float32), params)
    assert isinstance(model.segmentation, ASPPSegmentationHead)
    assert model.segmentation.classifier.weight.dtype == torch.float32
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(params))


@pytest.mark.parametrize("name", ["FlowNet", "StereoNet"])
def test_width_not_a_multiple_of_64_raises_in_both(name):
    n, jax_model, port_model = MODELS[name]
    imgs = frames(n, (64, 200))
    jmodel = jax_model(jnp.float32)
    with pytest.raises(ValueError) as jax_error:
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                       *[jnp.asarray(i) for i in imgs])
    with pytest.raises(ValueError) as port_error:
        port_model(torch.float32)(*[torch.from_numpy(i) for i in imgs])
    assert str(port_error.value) == str(jax_error.value)
    assert "!=" in str(port_error.value)


# ------------------------------------------------- the configs' steps

TINY = {"encoder_channels": list(ENC), "fpn_channels": 16,
        "est_channels": [16, 16, 12], "ctx_channels": [16, 16],
        "raft_fdim": 16, "raft_hdim": 16, "raft_cdim": 8, "raft_iters": 2}
UNLOCKED = {
    # config: (its frames' fixture size, the working size, loss components)
    "flow_kitti": ((70, 140), [64, 128], ["flow", "total"]),
    "stereo_kitti": ((70, 140), [64, 128], ["disp", "total"]),
    "seg_cityscapes": ((96, 160), [64, 128], ["seg", "total"]),
    "seg_aspp_cityscapes": ((96, 160), [64, 128], ["seg", "total"]),
    "dcv_flow_kitti": ((70, 140), [64, 128], ["flow", "total"]),
    "raft_kitti": ((70, 140), [64, 128], ["flow", "total"]),
}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """{dataset: root} of 4-sample KITTI (sparse ground truth) and
    Cityscapes (train and val) fixtures the port's writers made."""
    root = tmp_path_factory.mktemp("fixtures")
    SyntheticPerceptionDataset(length=4, hw=UNLOCKED["flow_kitti"][0],
                               sparse=True).write_kitti_fixture(
        str(root / "kitti" / "training"), 4)
    cs = SyntheticPerceptionDataset(length=4, hw=UNLOCKED["seg_cityscapes"][0])
    for split in ("train", "val"):
        cs.write_cityscapes_fixture(str(root / "cityscapes"), 4, split)
    return {"kitti": str(root / "kitti"),
            "cityscapes": str(root / "cityscapes")}


@pytest.mark.parametrize("config", list(UNLOCKED))
def test_unlocked_config_takes_a_trainer_step(config, fixtures):
    _, hw, comps = UNLOCKED[config]
    raw = json.loads((REPO_ROOT / "configs" / f"{config}.json").read_text())
    ExperimentConfig.from_dict(raw).check_supported()
    raw["model"].update(TINY)
    raw["data"].update(root=fixtures[raw["data"]["dataset"]], hw=hw,
                       batch_size=2, num_workers=2)
    if raw["data"].get("crop_hw"):  # 384x768 of 512x1024, as 48x96
        raw["data"]["crop_hw"] = [48, 96]
    raw["train"]["ckpt_dir"] = ""
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    assert len(tr.dataset) == 4
    batch = batches(tr.dataset, 2, 1)[0]
    assert list(batch["decoder"]) == ["native", "native"]
    got, grads = tr.loss_and_grads(batch)
    assert sorted(got) == comps
    assert all(torch.isfinite(v) for v in got.values())
    assert all(torch.isfinite(g).all() for g in grads.values())
    # every part the loss reaches has a gradient
    parts = {n.split(".")[0] for n, g in grads.items() if g.any()}
    assert parts == {n.split(".")[0] for n in grads}, parts
    tr.apply_grads(grads)
    assert tr.step == 1
    if config == "seg_aspp_cityscapes":
        assert tr.augment_config.enabled and tr.eval_dataset is not None
        assert isinstance(tr.model.segmentation, ASPPSegmentationHead)


@pytest.mark.parametrize("variant,keys", [
    ("flow", ["flow", "flow_pyramid"]), ("stereo", ["disp", "disp_pyramid"]),
    ("seg", ["seg_logits"])])
def test_entry_serves_single_task_models_on_cpu(variant, keys):
    forward, imgs = entry(device="cpu", dtype=torch.float32, hw=(64, 128),
                          variant=variant,
                          seg_head="aspp" if variant == "seg" else "fpn")
    out = forward(*imgs)
    assert sorted(out) == keys
    assert all(torch.isfinite(v).all() for k, v in out.items()
               if not k.endswith("_pyramid"))
    with pytest.raises(ValueError, match="seg_head does not apply"):
        entry(device="cpu", variant="flow", seg_head="aspp")
    with pytest.raises(ValueError, match="no correlation kernel"):
        entry(device="cpu", variant="seg", corr_impl="plain")
