#!/usr/bin/env python3
"""How far a bf16 CerberusRAFT's gradients stand from its float32 ones, in
the JAX package and in the port, on the CPU, and why a module's reading can
be large.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/raft_bf16_grad_spread.py [--seeds 5]
        [--no-excess-precision] [--no-mkldnn]

The tiny ``cerberus_raft`` experiment of tests/jax_pairs.py (encoder (8,
12, 16, 16, 16, 16), fdim/hdim/cdim 16/16/8, 3 iterations, 64x64, batch 2
of the synthetic dataset), one set of random float32 parameters per seed
for both types of both packages, and the experiment's loss (``joint_loss``
with the sequence terms). For each seed:

* one JSON line a module (the parameter names' first three parts, as
  ``chip_smoke.py``'s ``train_raft`` groups them; modules whose float32
  gradient is zero, the upsampling masks' heads, left out): the relative L2
  distance of the bf16 gradient from the float32 one in JAX and in the
  port, and the port's float32 distance from JAX's;
* one line a decoder (``flow``, ``disparity``): the same distance for the
  cotangents of its two ``corr_proj`` outputs (the all-pairs product's
  inputs), whose sums over the pixels make ``corr_proj``'s gradient, in
  both packages; and ``kappa``, the condition number of the bias
  gradient's sum (the norm of the per-channel sums of the cotangents'
  magnitudes over the norm of their sums, in the port's float32), by which
  a sum magnifies the relative error of its terms; and each package's
  ``coherence``, the same ratio inverted for the cotangents' bf16 errors
  (the norm of the errors' per-channel sums over that of the sums of
  their magnitudes): near 1 where the errors of a channel share a sign
  and survive its sum, near 1/sqrt(pixels) where they are independent.

A last line gives each package's largest module reading.

``--no-excess-precision`` runs JAX with XLA's
``--xla_allow_excess_precision=false``: on the CPU, XLA otherwise drops
bf16 roundings between operations it computes in float32, so its bf16
reads closer to float32 than bf16 arithmetic does. ``--no-mkldnn`` runs
the port's CPU convolutions without oneDNN (``torch.backends.mkldnn``):
the same roundings in other summation orders, which shows how far the
readings move with the order of a sum alone.

A measurement for the port's record (PERF.md, the limit of
``chip_smoke.py``'s ``train_raft``), not a test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if "--no-excess-precision" in sys.argv:  # before JAX reads its flags
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_allow_excess_precision=false").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cerberusnet_torch.models import raft as tr  # noqa: E402
from cerberusnet_torch.train.config import ExperimentConfig  # noqa: E402
from cerberusnet_torch.train.trainer import Trainer  # noqa: E402
from cerberusnet_tpu.data.loader import collate, make_preprocess_fn  # noqa: E402
from cerberusnet_tpu.data.synthetic import SyntheticPerceptionDataset  # noqa: E402
from cerberusnet_tpu.models import raft as jr  # noqa: E402
from cerberusnet_tpu.train import losses as jl  # noqa: E402
from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig  # noqa: E402
from cerberusnet_tpu.train.trainer import build_model as jax_build_model  # noqa: E402
from tests.jax_pairs import RAFT_HW, draw_params, port_masters, raft_config_dict  # noqa: E402

# the all-pairs op of each decoder, by the port's decoder name
ALLPAIRS = {"flow": "allpairs_correlation",
            "disparity": "allpairs_correlation_1d"}
# a zero added to each all-pairs input while set: its gradient is the
# input's cotangent
PROBE = {}


def probed(module, name, to):
    """Replaces ``module.name`` (an all-pairs op, which the decoders call
    through their module) with one that adds PROBE's zeros to its inputs."""
    fn = getattr(module, name)

    def call(f1, f2):
        if name not in PROBE:
            return fn(f1, f2)
        e1, e2 = PROBE[name]
        return fn(f1 + to(e1, f1), f2 + to(e2, f2))
    setattr(module, name, call)


for _name in ALLPAIRS.values():
    probed(jr, _name, lambda e, f: e.astype(f.dtype))
    probed(tr, _name, lambda e, f: e.to(f.dtype))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def gradients(dtype, seed):
    """(JAX's, the port's) gradients by port name for ``seed``'s weights
    and batch, the model in ``dtype``, each with the cotangents of the
    decoders' projections ({all-pairs op: (input 1's, input 2's)})."""
    raw = raft_config_dict()
    raw["model"]["dtype"] = dtype
    cfg = JaxConfig.from_dict(raw)
    model, forward, _ = jax_build_model(cfg.model)
    ds = SyntheticPerceptionDataset(length=2, hw=RAFT_HW, num_classes=19,
                                    seed=seed)
    batch = collate([ds[0], ds[1]])
    prep = make_preprocess_fn(RAFT_HW)(batch)
    PROBE.clear()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *[prep[k] for k in ("left", "right", "temporal")])
    params = draw_params(shapes["params"], seed + 20)
    b, (h, w) = len(ds), RAFT_HW
    level = cfg.model.raft_level
    zeros = np.zeros((b, h >> level, w >> level, cfg.model.raft_fdim),
                     np.float32)

    def loss(p, probe):
        PROBE.update(probe)
        return jl.joint_loss(forward({"params": p}, prep), prep,
                             weights=cfg.loss.weights,
                             seq_gamma=cfg.loss.seq_gamma)[0]

    probe = {n: (jnp.asarray(zeros), jnp.asarray(zeros))
             for n in ALLPAIRS.values()}
    jgrads, jprobe = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, probe)
    PROBE.clear()
    trainer = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    trainer.load_masters(port_masters(trainer.config, params))
    tprobe = {n: (torch.zeros(zeros.shape, requires_grad=True),
                  torch.zeros(zeros.shape, requires_grad=True))
              for n in ALLPAIRS.values()}
    PROBE.update(tprobe)
    _, tgrads = trainer.loss_and_grads(batch)
    PROBE.clear()
    jgrads = port_masters(trainer.config, jax.tree.map(np.asarray, jgrads))
    return (({n: g.numpy() for n, g in jgrads.items()},
             {n: tuple(np.asarray(e) for e in v) for n, v in jprobe.items()}),
            ({n: g.numpy() for n, g in tgrads.items()},
             {n: tuple(e.grad.numpy() for e in v) for n, v in tprobe.items()}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--no-excess-precision", action="store_true",
                    help="JAX with --xla_allow_excess_precision=false")
    ap.add_argument("--no-mkldnn", action="store_true",
                    help="the port's CPU convolutions without oneDNN")
    args = ap.parse_args()
    torch.backends.mkldnn.enabled = not args.no_mkldnn
    largest = {"jax": 0.0, "port": 0.0}
    for seed in range(args.seeds):
        (j32, jc32), (t32, tc32) = gradients("float32", seed)
        (j16, jc16), (t16, tc16) = gradients("bfloat16", seed)

        def module(name):
            return ".".join(name.split(".")[:3])

        for mod in sorted({module(n) for n in t32}):
            names = [n for n in t32 if module(n) == mod]

            def cat(g):
                return np.concatenate([g[n].ravel() for n in names])

            if not np.any(cat(t32)):
                continue
            row = {"seed": seed, "module": mod,
                   "jax_bf16_vs_f32": rel_l2(cat(j16), cat(j32)),
                   "port_bf16_vs_f32": rel_l2(cat(t16), cat(t32)),
                   "port_f32_vs_jax_f32": rel_l2(cat(t32), cat(j32))}
            largest["jax"] = max(largest["jax"], row["jax_bf16_vs_f32"])
            largest["port"] = max(largest["port"], row["port_bf16_vs_f32"])
            print(json.dumps(row), flush=True)
        for dec, op in ALLPAIRS.items():
            g = np.concatenate(tc32[op]).astype(np.float64)

            def sums(x):  # (net, gross) of the per-channel sums
                return (np.linalg.norm(x.sum(axis=(0, 1, 2))),
                        np.linalg.norm(np.abs(x).sum(axis=(0, 1, 2))))

            net, gross = sums(g)
            row = {"seed": seed, "cotangents_of": f"{dec}.corr_proj outputs",
                   "port_f32_vs_jax_f32": rel_l2(
                       g, np.concatenate(jc32[op])),
                   "kappa_bias_sum": gross / net}
            for pkg, c16, c32 in (("jax", jc16, jc32), ("port", tc16, tc32)):
                err = (np.concatenate(c16[op]).astype(np.float64)
                       - np.concatenate(c32[op]))
                e_net, e_gross = sums(err)
                row[f"{pkg}_bf16_vs_f32"] = rel_l2(
                    np.concatenate(c16[op]), np.concatenate(c32[op]))
                row[f"{pkg}_coherence"] = e_net / e_gross
            print(json.dumps(row), flush=True)
    print(json.dumps({"largest_bf16_vs_f32": largest}))


if __name__ == "__main__":
    main()
