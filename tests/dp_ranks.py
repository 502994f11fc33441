"""Rank bodies of ``tests/test_torch_parallel.py``: importable functions
that ``cerberusnet_torch.parallel.launch`` runs in spawned ranks. They
import torch and the port only (a rank never imports JAX); what they are
held against is computed in the test process and handed in as numpy.

``suite`` runs every case in one spawn, so the test file spawns its ranks
once: each case is a function of (mesh, its payload) that returns numpy
arrays and floats."""

import os
import time

import numpy as np
import torch

from cerberusnet_torch.models.disparity import StereoNet
from cerberusnet_torch.models.flow import FlowNet
from cerberusnet_torch.models.segmentation import SegNet
from cerberusnet_torch.parallel.mesh import make_mesh, shard_batch
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


def model_grads(mesh, spec):
    """The loss and the parameters' gradients of a ``MODELS`` entry on this
    rank's rows, all-reduced as the trainer does."""
    make, keys = MODELS[spec["model"]]
    model = load_flax_params(make(), spec["params"])
    batch = torch_tree(shard_batch(spec["batch"], mesh))
    out = model(*(batch[k] for k in keys))
    if spec["model"] == "SegNet":
        loss = tl.segmentation_loss(out["seg_logits"], batch["seg_labels"],
                                    mesh=mesh)
    elif spec["model"] == "FlowNet":
        loss = tl.multiscale_flow_loss(out["flow_pyramid"], batch["flow_gt"],
                                       batch["flow_valid"], mesh=mesh)
    else:
        loss = tl.multiscale_disparity_loss(
            out["disp_pyramid"], batch["disp_gt"], batch["disp_valid"],
            mesh=mesh)
    loss.backward()
    names = [n for n, _ in model.named_parameters()]
    grads = [p.grad for p in model.parameters()]
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
