#!/usr/bin/env python3
"""How far a bf16 CerberusNet's gradients stand from its float32 ones, in
the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/bf16_grad_spread.py [--seeds 5]

Both models at the tiny widths of tests/test_torch_encoder_level.py, 64x64
frames, batch 1, the first three encoder levels fused (``pallas_levels=3``,
``pallas_grad="pallas"``; JAX's kernels in interpret mode, as its own
tests run them on the CPU; the port's plain versions, as on any CPU
tensor), plain correlations (JAX ``corr_impl="pure"``). One set of random
float32 parameters serves both types of both models. The loss is a fixed
random weighting of the three heads. For each seed (frames, weights) and
type, the gradient reaching each tapped input is read through an additive
zero probe: the inputs of fused levels 1-3 (level 1's is the three frames
stacked, as the encoder sees them) and both inputs of the disparity
decoder's 1-D correlation at each of its five levels. Prints one JSON line
per model and tap: the relative L2 distance of the bf16 gradient from the
float32 one, per seed and the median.

A measurement for the port's record (PERF.md, ROADMAP.md C4), not a test.
"""

from __future__ import annotations

import argparse
import json
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cerberusnet_torch.models.disparity as t_disp
import cerberusnet_torch.models.encoder as t_enc
import cerberusnet_tpu.models.disparity as j_disp
import cerberusnet_tpu.ops.pallas.encoder_level as j_level
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.weights import load_flax_params
from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet

TINY = dict(encoder_channels=(8, 12, 16, 16, 16, 16),
            est_channels=(16, 16, 12), ctx_channels=(16, 16),
            fpn_channels=16)
HW = (64, 64)
HEADS = ("flow", "disp", "seg_logits")
FUSED = dict(pallas_levels=3, pallas_grad="pallas")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def random_params(model, frames, seed):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(f) for f in frames])["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Taps:
    """Wraps the fused level and the 1-D correlation of one package so that
    the i-th call of a forward adds probe i to its tapped input; a forward
    with no probes records each tapped input's shape and type instead."""

    def __init__(self, level_mod, corr_mod, add):
        self.sites = [(level_mod, "encoder_level"), (corr_mod, "correlation1d")]
        self.saved = [getattr(m, a) for m, a in self.sites]
        self.add = add
        self.reset(None)

    def reset(self, probes):
        self.probes, self.names, self.shapes = probes, [], []
        self.calls = {"level": 0, "corr": 0}

    def tap(self, name, x):
        i = len(self.names)
        self.names.append(name)
        if self.probes is None:
            self.shapes.append((tuple(x.shape), x.dtype))
            return x
        return self.add(x, self.probes[i])

    def __enter__(self):
        level, corr = self.saved

        def fused(x, *args, **kw):
            self.calls["level"] += 1
            n = self.calls["level"]
            return level(self.tap(f"encoder level {n} dx", x), *args, **kw)

        def corr1d(f1, f2, *args, **kw):
            self.calls["corr"] += 1
            n = self.calls["corr"]
            return corr(self.tap(f"corr1d call {n} df1", f1),
                        self.tap(f"corr1d call {n} df2", f2), *args, **kw)

        for (mod, attr), fn in zip(self.sites, (fused, corr1d)):
            setattr(mod, attr, fn)
        return self

    def __exit__(self, *exc):
        for (mod, attr), fn in zip(self.sites, self.saved):
            setattr(mod, attr, fn)


def jax_grads(params, frames, weights, dtype):
    """{tap: gradient} of the JAX model in ``dtype``."""
    model = JaxCerberusNet(corr_impl="pure", dtype=dtype, **FUSED, **TINY)
    params = jax.tree.map(jnp.asarray, params)
    frames = [jnp.asarray(f) for f in frames]
    with Taps(j_level, j_disp, lambda x, p: x + p) as taps:
        jax.eval_shape(lambda: model.apply({"params": params}, *frames))
        names, shapes = taps.names, taps.shapes

        def loss(probes):
            taps.reset(probes)
            out = model.apply({"params": params}, *frames)
            return sum((out[k].astype(jnp.float32) * weights[k]).sum()
                       for k in HEADS)

        grads = jax.jit(jax.grad(loss))([jnp.zeros(s, d) for s, d in shapes])
    return dict(zip(names, (np.asarray(g, np.float32) for g in grads)))


def torch_grads(params, frames, weights, dtype):
    """{tap: gradient} of the port's model in ``dtype`` (plain versions)."""
    model = load_flax_params(CerberusNet(dtype=dtype, **FUSED, **TINY),
                             params)
    frames = [torch.from_numpy(f).to(dtype) for f in frames]
    with Taps(t_enc, t_disp, lambda x, p: x + p) as taps:
        with torch.no_grad():
            model(*frames)
        names = taps.names
        probes = [torch.zeros(s, dtype=d, requires_grad=True)
                  for s, d in taps.shapes]
        taps.reset(probes)
        out = model(*frames)
    loss = sum((out[k].float() * torch.from_numpy(weights[k])).sum()
               for k in HEADS)
    loss.backward()
    return {n: p.grad.float().numpy() for n, p in zip(names, probes)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=5)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.RandomState(0)
    frames0 = [rng.randn(1, *HW, 3).astype(np.float32) for _ in range(3)]
    params = random_params(
        JaxCerberusNet(corr_impl="pure", **FUSED, **TINY), frames0, 10)
    dist = {"jax": {}, "torch": {}}
    for seed in range(args.seeds):
        rng = np.random.RandomState(100 + seed)
        frames = [rng.randn(1, *HW, 3).astype(np.float32) for _ in range(3)]
        out_shapes = {"flow": (1, *HW, 2), "disp": (1, *HW, 1),
                      "seg_logits": (1, *HW, 19)}
        weights = {k: rng.randn(*s).astype(np.float32)
                   for k, s in out_shapes.items()}
        for which, grads_of, types in (
                ("jax", jax_grads, (jnp.bfloat16, jnp.float32)),
                ("torch", torch_grads, (torch.bfloat16, torch.float32))):
            low, full = (grads_of(params, frames, weights, t) for t in types)
            for name, g in full.items():
                dist[which].setdefault(name, []).append(
                    rel_l2(low[name], g))
    for which, taps in dist.items():
        for name, values in taps.items():
            print(json.dumps({"model": which, "tap": name,
                              "bf16_vs_f32_rel_l2": values,
                              "median": statistics.median(values)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
