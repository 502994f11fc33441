#!/usr/bin/env python3
"""Why tests/test_torch_spatial_offgrid.py holds float64 ranks to a float64
process: a float32 gradient of a RAFT model on bands can step over a kink
of the loss that one process's does not.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/spatial_float32_kink.py [--model CerberusRAFT] [--h 288] [--mesh 2x2] [--seed 50]

The tiny model of ``tests/dp_ranks.py``'s ``OFFGRID_MODELS`` at H x 64 with
the test file's seeded parameters and batch, on 4 gloo ranks of the
(data, spatial) mesh and in one process. One JSON line each: the ranks'
loss and largest gradient distance (relative L2, the worst parameter)
from one float64 process with the ranks in float32 and in float64; then
one float64 process whose left frame is scaled by 1 + eps N(0, 1) noise,
for eps in 1e-7, 1e-6, 1e-5, against the unscaled one. A distance that
jumps between two eps where the rest grows linearly is a kink crossed.

A measurement for the port's record (PERF.md §6), not a test.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def ranks_body(spec, h, shape, dtype):
    from tests import dp_ranks

    torch.set_num_threads(1)
    mesh = dp_ranks.offgrid_mesh(shape, h)
    return dp_ranks.model_grads(mesh, spec, dp_ranks.OFFGRID_MODELS, dtype)


def main():
    from cerberusnet_torch.parallel import launch
    from cerberusnet_torch.parallel.mesh import SINGLE
    from tests import dp_ranks
    from tests.test_torch_spatial import flax_tree, model_batch, rel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="CerberusRAFT")
    ap.add_argument("--h", type=int, default=288)
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--seed", type=int, default=50)
    args = ap.parse_args()
    models = dp_ranks.OFFGRID_MODELS
    spec = {"model": args.model,
            "batch": model_batch(args.seed, hw=(args.h, 64)),
            "params": flax_tree(models[args.model][0](), args.seed)}
    shape = tuple(map(int, args.mesh.split("x")))
    loss64, want = dp_ranks.model_grads(SINGLE, spec, models, torch.float64)

    def worst(grads):
        return max((rel(g, want[n]), n) for n, g in grads.items())

    for dtype in (torch.float32, torch.float64):
        loss, grads = launch(ranks_body, 4, args=(spec, args.h, shape, dtype),
                             timeout=600)[0]
        dist, name = worst(grads)
        print(json.dumps({"ranks": str(dtype)[6:], "mesh": args.mesh,
                          "loss": loss, "one_process_loss": loss64,
                          "worst_rel_l2": dist, "parameter": name}),
              flush=True)
    rng = np.random.RandomState(0)
    for eps in (1e-7, 1e-6, 1e-5):
        left = spec["batch"]["left"]
        scaled = (left * (1 + eps * rng.randn(*left.shape))).astype(
            left.dtype)
        _, grads = dp_ranks.model_grads(
            SINGLE, {**spec, "batch": {**spec["batch"], "left": scaled}},
            models, torch.float64)
        dist, name = worst(grads)
        print(json.dumps({"one_process_left_scaled_by": eps,
                          "worst_rel_l2": dist, "parameter": name}),
              flush=True)


if __name__ == "__main__":
    main()
