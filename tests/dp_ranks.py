"""Rank bodies of ``tests/test_torch_parallel.py``,
``tests/test_torch_spatial.py``, ``tests/test_torch_spatial_dcv_raft.py``
and ``tests/test_torch_spatial_offgrid.py``:
importable functions that ``cerberusnet_torch.parallel.launch`` runs in
spawned ranks. They import
torch and the port only (a rank never imports JAX); what they are held
against is computed in the test process and handed in as numpy.

``suite``, ``spatial_suite``, ``dcv_raft_suite`` and ``offgrid_suite``
run every case of their test file in one spawn, so each file spawns its
ranks once: each case is a function of (mesh, its payload) that returns
numpy arrays and floats."""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.common import (
    set_spatial,
    upsample2x,
    upsample_to,
)
from cerberusnet_torch.models.dcv_flow import (
    CerberusDCV,
    DCVFlowNet,
    DCVStereoNet,
)
from cerberusnet_torch.models.disparity import StereoNet
from cerberusnet_torch.models.flow import FlowNet
from cerberusnet_torch.models.raft import (
    CerberusRAFT,
    RAFTFlowNet,
    RAFTStereoNet,
)
from cerberusnet_torch.models.segmentation import SegNet
from cerberusnet_torch.parallel.halo import gather_rows, halo_rows
from cerberusnet_torch.parallel.mesh import (
    level_extents,
    make_mesh,
    shard_batch,
    shard_samples,
)
from cerberusnet_torch.train import losses as tl
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import load_flax_params

TINY_ENC = (8, 12, 16, 16, 16, 16)
DEC = dict(est_channels=(16, 16, 12), ctx_channels=(16, 16))

# name: (the input differentiated, the loss of a mesh and the inputs)
LOSSES = {
    "segmentation": ("seg_logits", lambda m, x: tl.segmentation_loss(
        x["seg_logits"], x["seg_labels"], mesh=m)),
    "segmentation_focal": ("seg_logits", lambda m, x: tl.segmentation_loss(
        x["seg_logits"], x["seg_labels"], focal_gamma=2.0, mesh=m)),
    "multiscale_flow": ("flow_pyramid", lambda m, x: tl.multiscale_flow_loss(
        x["flow_pyramid"], x["flow_gt"], x["flow_valid"], mesh=m)),
    "multiscale_flow_robust": (
        "flow_pyramid", lambda m, x: tl.multiscale_flow_loss(
            x["flow_pyramid"], x["flow_gt"], x["flow_valid"], robust_q=0.4,
            mesh=m)),
    "multiscale_disparity": (
        "disp_pyramid", lambda m, x: tl.multiscale_disparity_loss(
            x["disp_pyramid"], x["disp_gt"], x["disp_valid"], mesh=m)),
    "berhu": ("disp", lambda m, x: tl.berhu_loss(
        x["disp"], x["disp_gt"], x["disp_valid"], mesh=m)),
    "raft_sequence": ("iterates", lambda m, x: tl.raft_sequence_loss(
        x["iterates"].transpose(0, 1), x["flow_gt"], x["flow_valid"],
        level=3, gamma=0.8, mesh=m)),
    "photometric": ("flow", lambda m, x: tl.photometric_loss(
        x["left"], x["temporal"], x["flow"], mesh=m)),
    "smoothness": ("flow", lambda m, x: tl.smoothness_loss(
        x["flow"], x["left"], mesh=m)),
    "rmi": ("seg_logits", lambda m, x: tl.rmi_loss(
        x["seg_logits"], x["seg_labels"], mesh=m)),
}

# the JAX test's models (tests/test_parallel.py), by name: (model, inputs)
MODELS = {
    "SegNet": (lambda: SegNet(encoder_channels=TINY_ENC, num_classes=5,
                              fpn_channels=16), ("left",)),
    "FlowNet": (lambda: FlowNet(encoder_channels=TINY_ENC, **DEC),
                ("left", "temporal")),
    "StereoNet": (lambda: StereoNet(encoder_channels=TINY_ENC, **DEC),
                  ("left", "right")),
}
# and tests/test_torch_spatial.py's: the ASPP head and the joint model
SPATIAL_MODELS = {
    **MODELS,
    "SegNetASPP": (lambda: SegNet(encoder_channels=TINY_ENC, num_classes=5,
                                  fpn_channels=16, seg_head="aspp"),
                   ("left",)),
    "CerberusNet": (lambda: CerberusNet(
        encoder_channels=TINY_ENC, num_classes=5, fpn_channels=16, **DEC),
        ("left", "right", "temporal")),
    "CerberusNetASPP": (lambda: CerberusNet(
        encoder_channels=TINY_ENC, num_classes=5, fpn_channels=16,
        seg_head="aspp", **DEC), ("left", "right", "temporal")),
}


def torch_tree(tree, rows=slice(None), grad=False):
    """numpy arrays (and {level: array} dicts) -> tensors of ``rows``
    (integers int64); with ``grad`` the float ones require gradients."""
    if isinstance(tree, dict):
        return {k: torch_tree(v, rows, grad) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree[rows]))
    if t.dtype.is_floating_point:
        return t.requires_grad_(grad)
    return t.long()


def loss_value_and_grad(name, mesh, inputs, rows):
    """(value, gradient of the differentiated input's ``rows``) of
    ``LOSSES[name]`` on this rank's rows."""
    key, fn = LOSSES[name]
    x = {k: torch_tree(v, rows, grad=(k == key)) for k, v in inputs.items()}
    value = fn(mesh, x)
    value.backward()
    g = x[key]
    grad = ({lv: t.grad.numpy() for lv, t in g.items()}
            if isinstance(g, dict) else g.grad.numpy())
    return float(value.detach()), grad


def as_numpy(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def model_loss(name, out, batch, mesh, rmi_weight=0.0):
    """The loss a model of ``SPATIAL_MODELS`` is held to: its head's, the
    joint loss for CerberusNet; ``rmi_weight`` w makes SegNet's (1 - w) CE
    + w RMI, as ``joint_loss``'s."""
    if name.startswith("SegNet"):
        ce = tl.segmentation_loss(out["seg_logits"], batch["seg_labels"],
                                  mesh=mesh)
        if not rmi_weight:
            return ce
        return (1.0 - rmi_weight) * ce + rmi_weight * tl.rmi_loss(
            out["seg_logits"], batch["seg_labels"], mesh=mesh)
    if name == "FlowNet":
        return tl.multiscale_flow_loss(out["flow_pyramid"], batch["flow_gt"],
                                       batch["flow_valid"], mesh=mesh)
    if name == "StereoNet":
        return tl.multiscale_disparity_loss(
            out["disp_pyramid"], batch["disp_gt"], batch["disp_valid"],
            mesh=mesh)
    return tl.joint_loss(out, batch, mesh=mesh)[0]


def model_grads(mesh, spec, models=None, dtype=torch.float32):
    """The loss and the parameters' gradients of a ``models`` entry
    (``SPATIAL_MODELS`` by default) on this rank's rows (and, on a spatial
    mesh, its band), all-reduced as the trainer does; ``dtype``: the
    model's parameters and the batch's floats; the spec's ``rmi_weight``
    goes to ``model_loss``."""
    make, keys = (models or SPATIAL_MODELS)[spec["model"]]
    model = set_spatial(load_flax_params(make(), spec["params"]).to(dtype),
                        mesh)
    batch = {k: v.to(dtype) if v.dtype.is_floating_point else v
             for k, v in torch_tree(shard_batch(spec["batch"], mesh)).items()}
    out = model(*(batch[k] for k in keys))
    loss = model_loss(spec["model"], out, batch, mesh,
                      spec.get("rmi_weight", 0.0))
    loss.backward()
    names = [n for n, _ in model.named_parameters()]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in model.parameters()]
    mesh.mean_grads(grads)
    return float(loss.detach()), dict(zip(names, (g.numpy() for g in grads)))


def trainer(raw, ckpt_dir=None):
    if ckpt_dir is not None:
        raw = {**raw, "train": {**raw["train"], "ckpt_dir": ckpt_dir}}
    return Trainer(ExperimentConfig.from_dict(raw), device="cpu")


def trainer_step(mesh, p):
    """One step of the JAX-paired experiment: the global loss components,
    the all-reduced gradients, this rank's own gradients before the
    all-reduce, and the masters after the update."""
    tr = trainer(p["raw"])
    tr.load_masters({k: torch.from_numpy(v) for k, v in p["masters"].items()})
    batch = shard_batch(p["batch"], mesh)
    _, own = tr._rank_loss_and_grads(batch)
    own = as_numpy(own)
    comps, grads = tr.loss_and_grads(batch)
    tr.apply_grads(grads)
    return {"comps": {k: float(v) for k, v in comps.items()},
            "grads": as_numpy(grads), "own_grads": own,
            "masters": as_numpy(tr.masters)}


def trainer_bf16(mesh, p):
    """The all-reduced gradients of one step with bf16 gradients."""
    tr = trainer(p["raw"])
    tr.load_masters({k: torch.from_numpy(v) for k, v in p["masters"].items()})
    return {"grads": as_numpy(tr.loss_and_grads(shard_batch(p["batch"],
                                                            mesh))[1])}


def trainer_accum(mesh, p):
    """Two calls with accum_steps=2: the masters after each."""
    tr = trainer(p["raw"])
    tr.load_masters({k: torch.from_numpy(v) for k, v in p["masters"].items()})
    first, second = (shard_batch(b, mesh) for b in p["batches"])
    tr.train_step(first)
    out = {"first": {n: m.clone().numpy() for n, m in tr.masters.items()}}
    tr.train_step(second)
    return {**out, "masters": as_numpy(tr.masters)}


def augmented_steps(mesh, p):
    """Two augmented steps on this rank's rows of two global batches: the
    loss components of each and the masters after them."""
    tr = trainer(p["raw"])
    comps = [{k: float(v) for k, v in tr.train_step(
        shard_batch(b, mesh)).items()} for b in p["batches"]]
    return {"comps": comps, "masters": as_numpy(tr.masters)}


def evaluate(mesh, p):
    return trainer(p["raw"]).evaluate()


def checkpoint(mesh, p):
    """A step, a checkpoint, the files there; then a resumed trainer's
    step and masters."""
    tr = trainer(p["raw"], p["dir"])
    tr.train_step(shard_batch(p["batch"], mesh))
    path = tr.save_checkpoint()
    mesh.barrier()
    files = sorted(os.listdir(p["dir"]))
    resumed = trainer(p["raw"], p["dir"])
    return {"path": path, "files": files, "step": resumed.step,
            "masters": as_numpy(tr.masters),
            "resumed": as_numpy(resumed.masters)}


def pallas_levels(mesh, p):
    tr = trainer(p["raw"])
    return {"config": tr.config.model.pallas_levels,
            "fused": tr.model.encoder.fused_levels}


def convention(mesh):
    """The gradient convention of ``DataMesh.sum`` and ``max``: the rank's
    gradient of a global sum (N times its share), and of a global max with
    one tie across the ranks."""
    x = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
    mesh.sum(x.sum()).backward()
    y = torch.tensor([[1.0, 3.0], [3.0, 2.0]][mesh.rank], requires_grad=True)
    top = mesh.max(y)
    top.backward()
    return {"sum_grad": x.grad.numpy(), "max": float(top),
            "max_grad": y.grad.numpy()}


def suite(p):
    """Every case of the test file on this rank."""
    torch.set_num_threads(1)
    mesh = make_mesh(2, "cpu")
    rows = mesh.shard(len(p["losses"]["seg_logits"]))
    return {
        "rank": mesh.rank, "size": mesh.size,
        "losses": {name: loss_value_and_grad(name, mesh, p["losses"], rows)
                   for name in LOSSES},
        "convention": convention(mesh),
        "models": {name: model_grads(mesh, spec)
                   for name, spec in p["models"].items()},
        "trainer_step": trainer_step(mesh, p["trainer_step"]),
        "trainer_bf16": trainer_bf16(mesh, p["trainer_bf16"]),
        "trainer_accum": trainer_accum(mesh, p["trainer_accum"]),
        "augmented": augmented_steps(mesh, p["augmented"]),
        "evaluate": evaluate(mesh, p["evaluate"]),
        "checkpoint": checkpoint(mesh, p["checkpoint"]),
        "pallas_levels": pallas_levels(mesh, p["pallas_levels"]),
    }


def fail_on(rank):
    """Raises on ``rank``; the others wait at a barrier it never
    reaches."""
    mesh = make_mesh(0, "cpu")
    if mesh.rank == rank:
        raise ArithmeticError(f"rank {rank} fails on purpose")
    mesh.barrier()


def sleep(seconds):
    time.sleep(seconds)


# ------------------------------------------------------- the spatial axis

SPATIAL_RANKS = 4
# a test module's spawn's bound, about 4x its ranks' time under Tier-1's
# six workers on an idle 8-core machine (35-100 s), so a stuck rank fails
# its module and leaves the suite its clock
RANKS_TIMEOUT_S = 420
# (data, spatial) shapes of the 4 ranks
SPATIAL_MESHES = ((1, 4), (2, 2))
# tests/test_torch_spatial.py's losses: each term of the joint loss alone,
# SSIM as well (RAFT's sequence loss is not ported to the spatial axis)
SPATIAL_LOSSES = {
    **{k: v for k, v in LOSSES.items() if k != "raft_sequence"},
    "ssim": ("left", lambda m, x: tl._ssim(x["left"], x["temporal"],
                                           mesh=m)),
}


def band_tree(tree, mesh, grad_key=None):
    """Tensors of this rank's samples and band of rows of numpy arrays
    (``shard_batch``'s rule, within {level: array} dicts too); the entry
    ``grad_key`` requires gradients."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = {lv: torch_tree(a, grad=k == grad_key) for lv, a in
                      shard_batch(v, mesh).items()}
        else:
            out[k] = torch_tree(shard_batch({k: v}, mesh)[k],
                                grad=k == grad_key)
    return out


def spatial_loss(name, mesh, inputs):
    """(value, gradient of the differentiated input's band) of
    ``SPATIAL_LOSSES[name]`` on this rank's band."""
    key, fn = SPATIAL_LOSSES[name]
    x = band_tree(inputs, mesh, key)
    value = fn(mesh, x)
    value.backward()
    g = x[key]
    grad = ({lv: t.grad.numpy() for lv, t in g.items()}
            if isinstance(g, dict) else g.grad.numpy())
    return float(value.detach()), grad


class _Replicated(torch.autograd.Function):
    """A tensor held alike by every spatial peer: the identity, whose
    gradient is the peers' mean (each peer's is S times its share, the
    mesh's convention)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.mesh.spatial_group)
        return g / ctx.mesh.spatial_size, None


# halo cases: (top, bottom, fill); 18 rows over bands of 8
HALO_CASES = ((18, 18, "zero"), (18, 3, "edge"), (1, 1, "edge"),
              (0, 1, "zero"), (20, 0, "edge"))
HALO_H = 32


def halo_checks(mesh, h=HALO_H):
    """``halo_rows`` and ``gather_rows`` against slicing the whole frame of
    ``h`` rows (values) and ``gradcheck`` in float64 of the whole frame's
    function ``x -> the peers' outputs, gathered``, which every peer
    computes alike. The bands are ``mesh.rows``', equal or not."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, 1, h, 1), dtype=torch.float64, generator=gen)
    rows = mesh.rows(h)
    hb = rows.stop - rows.start
    out = {}
    for top, bottom, fill in HALO_CASES:
        if fill == "zero":
            padded = torch.nn.functional.pad(x, (0, 0, top, bottom))
        else:
            padded = x[:, :, torch.arange(-top, h + bottom).clamp(0, h - 1)]

        def fn(a, top=top, bottom=bottom, fill=fill):
            band = _Replicated.apply(a, mesh)[:, :, rows]
            out = halo_rows(band, top, bottom, mesh, fill)
            # every peer's output padded to the tallest, in its own slot of
            # a stack that the peers' sum fills
            tall = max(mesh.split(h)) + top + bottom
            out = torch.nn.functional.pad(out, (0, 0, 0, tall - out.shape[2]))
            return mesh.spatial_sum(torch.stack([
                out if r == mesh.spatial_rank else torch.zeros_like(out)
                for r in range(mesh.spatial_size)]))

        got = halo_rows(x[:, :, rows], top, bottom, mesh, fill)
        out[f"halo {top} {bottom} {fill}"] = {
            "values": bool(torch.equal(
                got, padded[:, :, rows.start:rows.start + top + hb + bottom])),
            "gradcheck": torch.autograd.gradcheck(
                fn, (x.clone().requires_grad_(),), raise_exception=False)}
    nhwc = x.permute(0, 2, 3, 1).contiguous()

    def gathered(a):
        return gather_rows(_Replicated.apply(a, mesh)[:, rows], mesh, dim=1)

    out["gather nhwc"] = {
        "values": bool(torch.equal(gathered(nhwc), nhwc)),
        "gradcheck": torch.autograd.gradcheck(
            gathered, (nhwc.clone().requires_grad_(),),
            raise_exception=False)}
    return out


def spatial_trainer(mesh, p):
    """One step of the tiny CerberusNet's trainer on this rank's piece of
    the global batch from the given masters, and ``evaluate`` after it;
    on the 1 x 4 mesh also a checkpoint and a resumed trainer."""
    d, s = p["shape"]
    raw = {**p["raw"], "train": {**p["raw"]["train"], "num_data_devices": d,
                                 "num_spatial_devices": s}}
    tr = trainer(raw)
    tr.load_masters({k: torch.from_numpy(v) for k, v in p["masters"].items()})
    comps = tr.train_step(shard_samples(p["batch"], tr.mesh))
    out = {"mesh": [tr.mesh.data_rank, tr.mesh.spatial_rank],
           "comps": {k: float(v) for k, v in comps.items()},
           "masters": as_numpy(tr.masters), "evaluate": tr.evaluate()}
    if p.get("dir"):
        tr.config.train.ckpt_dir = p["dir"]
        out["path"] = tr.save_checkpoint()
        tr.mesh.barrier()
        out["files"] = sorted(os.listdir(p["dir"]))
        resumed = trainer(raw, p["dir"])
        out["resumed"] = as_numpy(resumed.masters)
        out["step"] = resumed.step
    return out


def spatial_suite(p):
    """Every case of tests/test_torch_spatial.py on this rank: the models
    and the trainer on the 1 x 4 and 2 x 2 meshes, the losses and the
    halo primitives on 1 x 4, and the fused levels under the axis."""
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank()}
    for shape in SPATIAL_MESHES:
        mesh = make_mesh(shape[0], "cpu", shape[1], p["coarsest_rows"])
        out[f"{shape[0]}x{shape[1]}"] = {
            "coords": [mesh.data_rank, mesh.spatial_rank],
            "models": {name: model_grads(mesh, spec)
                       for name, spec in p["models"].items()},
            "trainer": spatial_trainer(mesh, {
                **p["trainer"], "shape": shape,
                "dir": p["trainer"]["dir"] if shape == (1, 4) else None})}
        if shape == (1, 4):
            out["losses"] = {name: spatial_loss(name, mesh, p["losses"])
                             for name in SPATIAL_LOSSES}
            out["halo"] = halo_checks(mesh)
    raw = p["trainer"]["raw"]
    fused = trainer({**raw, "model": {**raw["model"], "pallas_levels": 3},
                     "train": {**raw["train"], "num_data_devices": 1,
                               "num_spatial_devices": SPATIAL_RANKS}})
    out["pallas_levels"] = [fused.config.model.pallas_levels,
                            fused.model.encoder.fused_levels]
    out["built"] = {}
    for case, raw in p["built"].items():
        tr = trainer(raw)
        rows = tr.mesh.rows(tr.config.data.hw[0])
        out["built"][case] = {"variant": tr.config.model.variant,
                              "rows": [rows.start, rows.stop]}
    return out


# ------------------------------------- the spatial axis: DCV, RAFT, bands

# the DCV decoders' estimator at the tiny widths, their context network
# deep enough for its dilation-16 block; the RAFT decoders at
# tests/jax_pairs.py's tiny widths with 2 iterations over 2 volume levels
# of radius 2
DCV_DEC = dict(est_channels=(16, 16, 12), ctx_channels=(8, 8, 8, 8, 8))
RAFT_DEC = dict(fdim=16, hdim=16, cdim=8, corr_levels=2, radius=2, iters=2)
DCV_RAFT_MODELS = {
    "DCVFlowNet": (lambda: DCVFlowNet(encoder_channels=TINY_ENC, **DCV_DEC),
                   ("left", "temporal")),
    "DCVStereoNet": (lambda: DCVStereoNet(encoder_channels=TINY_ENC,
                                          **DCV_DEC), ("left", "right")),
    "CerberusDCV": (lambda: CerberusDCV(
        encoder_channels=TINY_ENC, num_classes=5, fpn_channels=16,
        **DCV_DEC), ("left", "right", "temporal")),
    "RAFTFlowNet": (lambda: RAFTFlowNet(encoder_channels=TINY_ENC,
                                        **RAFT_DEC), ("left", "temporal")),
    "RAFTStereoNet": (lambda: RAFTStereoNet(encoder_channels=TINY_ENC,
                                            **RAFT_DEC), ("left", "right")),
    "CerberusRAFT": (lambda: CerberusRAFT(
        encoder_channels=TINY_ENC, num_classes=5, fpn_channels=16,
        **RAFT_DEC), ("left", "right", "temporal")),
    "CerberusNet": SPATIAL_MODELS["CerberusNet"],
}
# the unequal bands: the coarsest level's 5 rows of a 320-row frame
UNEQUAL_H = 320
UNEQUAL_HALO_H = 40


def dcv_raft_suite(p):
    """Every case of tests/test_torch_spatial_dcv_raft.py on this rank:
    the models of ``p["models"]`` (equal bands) and ``p["unequal"]``
    (``UNEQUAL_H`` rows) on the 1 x 4 and 2 x 2 meshes, and on the unequal
    bands of 1 x 4 the halo primitives and the trainers of
    ``p["trainers"]`` (``spatial_trainer``)."""
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank()}
    for d, s in SPATIAL_MESHES:
        key = f"{d}x{s}"
        equal = make_mesh(d, "cpu", s, p["coarsest_rows"])
        unequal = make_mesh(d, "cpu", s, UNEQUAL_H // 2**len(TINY_ENC))
        out[key] = {
            "models": {name: model_grads(equal, spec, DCV_RAFT_MODELS)
                       for name, spec in p["models"].items()},
            "unequal": {name: model_grads(unequal, spec, DCV_RAFT_MODELS)
                        for name, spec in p["unequal"].items()},
            "rows": [unequal.rows(UNEQUAL_H).start,
                     unequal.rows(UNEQUAL_H).stop]}
        if (d, s) == (1, SPATIAL_RANKS):
            out["halo"] = halo_checks(unequal, UNEQUAL_HALO_H)
            out["trainers"] = {
                v: spatial_trainer(unequal, {**tp, "shape": (d, s)})
                for v, tp in p["trainers"].items()}
    return out



# ------------------------------------------- the spatial axis off the grid

# tests/test_torch_spatial_offgrid.py's models: every DCV and RAFT variant
# and SegNet with either head
OFFGRID_MODELS = {
    **{n: m for n, m in DCV_RAFT_MODELS.items() if n != "CerberusNet"},
    "SegNet": SPATIAL_MODELS["SegNet"],
    "SegNetASPP": SPATIAL_MODELS["SegNetASPP"],
}
# H -> the (data, spatial) meshes its models run on
OFFGRID_MESHES = {288: ((1, 4), (2, 2)), 368: ((1, 4), (2, 2)),
                  200: ((2, 2),)}
# the FPN's resizes between frame extents the ranks check: H -> (mesh,
# (source rows, target rows) of the frame)
OFFGRID_RESIZES = {200: ((2, 2), ((4, 7), (7, 13), (13, 25))),
                   368: ((1, 4), ((12, 23),))}
# the bf16 band resizes the ranks hand back (held bit for bit to the whole
# frame's resize cut to the band, and to JAX's sharded one): H -> (mesh,
# (source rows, target rows) of the frame); OFFGRID_RESIZES' pairs, x2 on
# and off the grid (23 -> 46, 25 -> 50: an odd source) and x4; each at a
# width below the height and one above, which the frame's rule contracts in
# the other order
BF16_RESIZES = {200: ((2, 2), ((4, 7), (7, 13), (13, 25), (25, 50))),
                368: ((1, 4), ((12, 23), (23, 46), (46, 184), (92, 184)))}
BF16_RESIZE_WIDTHS = (3, 40)
# the settings the reference refuses: (H, mesh, models)
OFFGRID_REFUSED = ((202, (2, 2), ("CerberusDCV", "CerberusRAFT")),
                   (352, (1, 4), ("CerberusNet", "FlowNet", "StereoNet")))
OFFGRID_REFUSED_MODELS = {**OFFGRID_MODELS, **SPATIAL_MODELS}
# RMI across the bands (SegNet's loss with rmi_weight 0.5): H -> (mesh,
# models). 202 rows on 2 ranks band 74/128, so the second band starts
# inside a 4x4 pool window and the frame's last 2 rows are the pool's
# remainder; 288 on 1 x 4 bands 96/64/64/64 on the windows' edges
OFFGRID_RMI = {202: ((2, 2), ("SegNet", "SegNetASPP")),
               288: ((1, 4), ("SegNet", "SegNetASPP"))}
# the RMI term alone against JAX's sharded rmi_loss: (H, mesh)
OFFGRID_RMI_TERM = (202, (2, 2))


def offgrid_mesh(shape, h):
    """The (data, spatial) ``shape`` mesh of the ranks for frames of ``h``
    rows (``Trainer``'s extents for the tiny encoder)."""
    return make_mesh(shape[0], "cpu", shape[1],
                     extents=level_extents(h, len(TINY_ENC)))


def refusal(mesh, spec, models):
    """(the exception's type, its message) that ``model_grads`` raises."""
    try:
        model_grads(mesh, spec, models)
    except (RuntimeError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def resize_checks(mesh, h, pairs, w=3):
    """``upsample_to`` on this rank's band from each pair's source extent
    to its target's, against the whole frame's resize cut to the target
    band (values, float64), and ``gradcheck`` of the whole frame's function
    ``x -> the peers' outputs, gathered``."""
    gen = torch.Generator().manual_seed(7)
    out = {}
    for hs, hd in pairs:
        x = torch.randn((1, 2, hs, w), dtype=torch.float64, generator=gen)
        src, dst = mesh.rows(hs), mesh.rows(hd)
        rows = dst.stop - dst.start
        want = torch.nn.functional.interpolate(
            x, size=(hd, 2 * w), mode="bilinear", align_corners=False)

        def fn(a, src=src, rows=rows):
            band = _Replicated.apply(a, mesh)[:, :, src]
            y = upsample_to(band, (rows, 2 * w), mesh)
            tall = max(mesh.split(hd))
            y = torch.nn.functional.pad(y, (0, 0, 0, tall - rows))
            return mesh.spatial_sum(torch.stack([
                y if r == mesh.spatial_rank else torch.zeros_like(y)
                for r in range(mesh.spatial_size)]))

        got = upsample_to(x[:, :, src], (rows, 2 * w), mesh)
        out[f"{hs} {hd}"] = {
            "values": float((got - want[:, :, dst]).abs().max()),
            "gradcheck": torch.autograd.gradcheck(
                fn, (x.clone().requires_grad_(),), raise_exception=False)}
    return out


def bf16_resize_input(hs, w):
    """The bf16 frame (batch 2, 2 channels, ``hs`` x ``w``) of a band
    resize case, the same on every rank and in the test process."""
    gen = torch.Generator().manual_seed(100 * hs + w)
    return torch.randn((2, 2, hs, w), dtype=torch.float64,
                       generator=gen).to(torch.bfloat16)


def bf16_resize_forms(hs, hd, w):
    """{form: (the call on a band of ``mesh``, the output's width)} of a
    case: ``upsample2x`` and its phase form at x2, else ``upsample_to``
    (x4: four times the width, else twice)."""
    if hd == 2 * hs:
        return {"resize": (lambda x, m, rows: upsample2x(x, m), 2 * w),
                "phase": (lambda x, m, rows: upsample2x(x, m, impl="phase"),
                          2 * w)}
    ww = 4 * w if hd == 4 * hs else 2 * w
    return {"resize": (lambda x, m, rows, ww=ww: upsample_to(x, (rows, ww),
                                                             m), ww)}


def bf16_resize_bands(mesh, pairs):
    """{"hs hd w form": this rank's band of the bf16 resize, float32} of
    each case of ``BF16_RESIZES``."""
    out = {}
    for hs, hd in pairs:
        for w in BF16_RESIZE_WIDTHS:
            x = bf16_resize_input(hs, w)
            dst = mesh.rows(hd)
            for form, (fn, _) in bf16_resize_forms(hs, hd, w).items():
                y = fn(x[:, :, mesh.rows(hs)], mesh, dst.stop - dst.start)
                assert y.dtype == torch.bfloat16
                out[f"{hs} {hd} {w} {form}"] = y.float().numpy()
    return out


def offgrid_suite(p):
    """Every case of tests/test_torch_spatial_offgrid.py on this rank: the
    models of ``p["models"][h]`` on ``OFFGRID_MESHES[h]`` in float64 and
    those of ``p["jax"]`` ((h, mesh, model) triples) in float32, the band
    resizes, the refused settings, the trainers of ``p["trainers"]`` on
    2 x 2, SegNet with RMI (``OFFGRID_RMI``, float64) and the RMI term
    alone (``OFFGRID_RMI_TERM``, float32)."""
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank(), "jax": {}}
    for h, shapes in OFFGRID_MESHES.items():
        for shape in shapes:
            mesh = offgrid_mesh(shape, h)
            rows = mesh.rows(h)
            key = f"{h} {shape[0]}x{shape[1]}"
            out[key] = {
                "rows": [rows.start, rows.stop],
                "models": {name: model_grads(mesh, spec, OFFGRID_MODELS,
                                             torch.float64)
                           for name, spec in p["models"][h].items()}}
            for jh, jshape, name in p["jax"]:
                if (jh, tuple(jshape)) == (h, shape):
                    out["jax"][f"{name} {key}"] = model_grads(
                        mesh, p["models"][h][name], OFFGRID_MODELS)
    out["resize"] = {h: resize_checks(offgrid_mesh(shape, h), h, pairs)
                     for h, (shape, pairs) in OFFGRID_RESIZES.items()}
    out["bf16_resize"] = {
        h: bf16_resize_bands(offgrid_mesh(shape, h), pairs)
        for h, (shape, pairs) in BF16_RESIZES.items()}
    out["refused"] = {}
    for h, shape, names in OFFGRID_REFUSED:
        mesh = offgrid_mesh(shape, h)
        for name in names:
            out["refused"][f"{name} {h}"] = refusal(
                mesh, p["refused"][f"{name} {h}"], OFFGRID_REFUSED_MODELS)
    out["trainers"] = {v: spatial_trainer(None, {**tp, "shape": (2, 2)})
                       for v, tp in p["trainers"].items()}
    out["rmi"] = {
        h: {name: model_grads(offgrid_mesh(shape, h), p["rmi"][h][name],
                              OFFGRID_MODELS, torch.float64)
            for name in names}
        for h, (shape, names) in OFFGRID_RMI.items()}
    h, shape = OFFGRID_RMI_TERM
    out["rmi_term"] = spatial_loss("rmi", offgrid_mesh(shape, h),
                                   p["rmi_term"])
    return out
