"""K10's gradients against a float64 witness, over seeds: what moves them.

    python3 -m cerberusnet_torch.level_witness [--seeds N]

The reverse sweep ``encoder_level_bwd`` (K10, ``csrc/encoder_level.cu``) is
checked in ``chip_smoke.py`` against the plain level (cuDNN) on the same
inputs. Where the level's LeakyReLU masks come out differently in two
computations (a pre-activation close to 0 rounds to either side), the
gradient moves by 0.9 of its value at that pixel, and these moves, not the
rounding of the products, set the distance between two correct reverse
sweeps. To tell them from a fault, every case here reports the relative L2
distance of each gradient (dx, dk1..dk3, db1..db3) to the float64 plain
level (``encoder_level_bwd_plain`` in float64 on the card, the witness):

- ``kernel``: K10 on the case's inputs;
- ``plain_f32``: the float32 plain level on the same values;
- ``plain_bf16`` (bfloat16 cases): the bfloat16 plain level;
- ``f32_with_f64_masks``: the float32 plain level differentiated with the
  masks of the float64 forward (``masked_bwd``): the float32 plain level's
  distance without its mask flips;

and, per conv of the level, the pre-activations whose sign differs from
the float64 forward's (``flips``: float32 and, for bfloat16 cases,
bfloat16 plain forwards).

Cases (``CASES``): float32 at the three level shapes of ``pallas_levels=3``
at batch 6 and at the four odd shapes of ``chip_smoke.py``, bfloat16 at the
two level-1 odd shapes (F = 8 runs the CUDA-core kernel, F = 16 the
tensor-core one), each drawn from ``torch.Generator("cuda")`` seeded 0, 1,
...; and ``replay_draws``: the inputs an earlier ``chip_smoke.py`` drew for
its level checks, when one generator fed every check of its kernels
phase, on which two K10 checks failed a fixed float32 limit. One JSON
line per case and seed.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from cerberusnet_torch.ops import encoder_level as elv
from cerberusnet_torch.ops.cuda import encoder_level as cl

GRADS = ("dx", "dk1", "db1", "dk2", "db2", "dk3", "db3")
# (label, B, H, W, C, F, dtype)
LEVEL_SHAPES = ((1, 6, 512, 1024, 3, 16), (2, 6, 256, 512, 16, 32),
                (3, 6, 128, 256, 32, 64))
ODD_SHAPES = ((0, 1, 72, 16, 3, 8), (0, 1, 72, 16, 3, 16),
              (0, 1, 70, 100, 16, 32), (0, 1, 74, 92, 32, 64))
# (B, H, W, C, F) of the bfloat16 cases: chip_smoke.py holds K10 in
# bfloat16 to the witness only at these, the shapes swept here
BF16_SHAPES = tuple(s[1:] for s in ODD_SHAPES[:2])
CASES = ([(*s, torch.float32) for s in LEVEL_SHAPES + ODD_SHAPES]
         + [(*s, torch.bfloat16) for s in ODD_SHAPES[:2]])
SEEDS = 8


def draw(b, h, w, c, f, dt, gen):
    """x, the six parameters and g as chip_smoke.py's level checks draw
    them (x unit normal, kernels N(0, 1 / (9 Cin)), biases N(0, 0.01),
    g unit normal), in the working type."""
    x = torch.randn((b, h, w, c), generator=gen, device="cuda")
    params = []
    for cin in (c, f, f):
        params.append(torch.randn((3, 3, cin, f), generator=gen,
                                  device="cuda") / (9 * cin) ** 0.5)
        params.append(0.1 * torch.randn((f,), generator=gen, device="cuda"))
    x, params = x.to(dt), [p.to(dt) for p in params]
    g = torch.randn((b, h // 2, w // 2, f), generator=gen,
                    device="cuda").to(dt)
    return x, params, g


def preacts(x, params):
    """The level's three pre-activations (NCHW), in x's type."""
    y, out = x.permute(0, 3, 1, 2), []
    for stride, k, b in zip((2, 1, 1), params[0::2], params[1::2]):
        if stride == 2:
            y = F.pad(y, (0, 1, 0, 1))
        pre = F.conv2d(y, k.permute(3, 2, 0, 1).to(y.dtype), b.to(y.dtype),
                       stride=stride, padding=0 if stride == 2 else 1)
        out.append(pre)
        y = F.leaky_relu(pre, 0.1)
    return out


def masked_bwd(x, g, params, masks):
    """The plain level's gradients with each LeakyReLU's slope taken from
    ``masks`` (the pre-activations whose sign decides it), not from its own
    pre-activation."""
    inputs = [t.detach().requires_grad_() for t in (x, *params)]
    with torch.enable_grad():
        y = inputs[0].permute(0, 3, 1, 2)
        for i, stride in enumerate((2, 1, 1)):
            k, b = inputs[1 + 2 * i], inputs[2 + 2 * i]
            if stride == 2:
                y = F.pad(y, (0, 1, 0, 1))
            pre = F.conv2d(y, k.permute(3, 2, 0, 1), b, stride=stride,
                           padding=0 if stride == 2 else 1)
            slope = torch.where(masks[i] > 0, 1.0, 0.1).to(pre.dtype)
            y = pre * slope
        y = y.permute(0, 2, 3, 1)
        return torch.autograd.grad(y, inputs, g.to(y.dtype))


# unit roundoff of each working type
UNIT_ROUNDOFF = {torch.float32: 2.0**-24, torch.bfloat16: 2.0**-9}


def flippable(x, params, u, spread):
    """The float64 forward's pre-activations, each negated where its
    magnitude lies below u A (A: the sum of its terms' magnitudes, from
    float64 |inputs| and |weights|), times sqrt(n) if ``spread`` (n: the
    conv's terms, bias included; the statistical size of a sum's rounding
    in a type of unit roundoff u): the pre-activations whose sign that
    type may give either way. Also their count per conv."""
    y, out, counts = x.permute(0, 3, 1, 2), [], []
    for stride, k, b in zip((2, 1, 1), params[0::2], params[1::2]):
        if stride == 2:
            y = F.pad(y, (0, 1, 0, 1))
        kk, pad = k.permute(3, 2, 0, 1), 0 if stride == 2 else 1
        pre = F.conv2d(y, kk, b, stride=stride, padding=pad)
        mag = F.conv2d(y.abs(), kk.abs(), b.abs(), stride=stride, padding=pad)
        scale = (9 * k.shape[2] + 1) ** 0.5 if spread else 1.0
        near = pre.abs() < scale * u * mag
        out.append(torch.where(near, -pre, pre))
        counts.append(int(near.sum()))
        y = F.leaky_relu(pre, 0.1)
    return out, counts


def flip_bound(x, g, params, u, spread):
    """What mask flips alone can move the gradients in a type of unit
    roundoff u: the float64 level differentiated with every flippable
    mask flipped, as distances to the float64 witness, and the count."""
    x64, g64 = x.double(), g.double()
    p64 = [p.double() for p in params]
    masks, counts = flippable(x64, p64, u, spread)
    flipped = masked_bwd(x64, g64, p64, masks)
    return distances(flipped, witness(x, g, params)), counts


def k10_limits(x, g, params, ref=None):
    """{grad: limit} on K10's relative L2 distance to the float64 witness:
    1.5 x the float32 plain level's distance with float64's masks (its
    rounding) + 1e-6 in float32, 1.5 x the bfloat16 plain level's distance
    + 1e-3 in bfloat16, each + what the type's mask flips alone can move
    that gradient (flip_bound); and the parts. Which pre-activations may
    flip: in float32 those within the statistical rounding of a sum of n
    terms, sqrt(n) u A; in bfloat16, where the sums run in float32 and
    each input was rounded once to bfloat16, those within u A."""
    dt = x.dtype
    ref = witness(x, g, params) if ref is None else ref
    bound, counts = flip_bound(x, g, params, UNIT_ROUNDOFF[dt],
                               dt == torch.float32)
    if dt == torch.float32:
        pre64 = preacts(x.double(), [p.double() for p in params])
        base = distances(masked_bwd(x, g, params, pre64), ref)
        limits = {n: 1.5 * base[n] + bound[n] + 1e-6 for n in GRADS}
    else:
        base = distances(elv.encoder_level_bwd_plain(x, None, g, *params),
                         ref)
        limits = {n: 1.5 * base[n] + bound[n] + 1e-3 for n in GRADS}
    return limits, {"rounding": base, "flip_bound": bound,
                    "flippable": counts}


def rel_l2(a, ref):
    return ((a.double() - ref).norm() / ref.norm().clamp_min(1e-300)).item()


def witness(x, g, params):
    """The float64 plain level's gradients of these inputs."""
    return elv.encoder_level_bwd_plain(
        x.double(), None, g.double(), *[p.double() for p in params])


def distances(grads, ref):
    return {n: rel_l2(v, r) for n, v, r in zip(GRADS, grads, ref)}


def case_report(x, params, g):
    """Every distance to the float64 witness of one K10 case."""
    dt = x.dtype
    y3 = cl.level_fwd(x, *params)
    kernel = cl.level_bwd(x, y3, g, *params)
    x32, p32 = x.float(), [p.float() for p in params]
    ref = witness(x, g, params)
    pre64 = preacts(x.double(), [p.double() for p in params])
    plain32 = elv.encoder_level_bwd_plain(x32, None, g.float(), *p32)
    dist = {"kernel": distances(kernel, ref),
            "plain_f32": distances(plain32, ref),
            "f32_with_f64_masks": distances(
                masked_bwd(x32, g.float(), p32, pre64), ref)}
    flips = {"f32": [int(((a > 0) != (b > 0)).sum()) for a, b in
                     zip(preacts(x32, p32), pre64)]}
    # chip_smoke.py's check until this module: the kernel against the
    # float32 plain level (and the bfloat16 plain level's distance to it)
    to_f32 = {"kernel": distances(kernel, [v.double() for v in plain32])}
    if dt == torch.bfloat16:
        plain16 = elv.encoder_level_bwd_plain(x, None, g, *params)
        dist["plain_bf16"] = distances(plain16, ref)
        to_f32["plain_bf16"] = distances(plain16,
                                         [v.double() for v in plain32])
        flips["bf16"] = [int(((a > 0) != (b > 0)).sum()) for a, b in
                         zip(preacts(x, params), pre64)]
    limits, parts = k10_limits(x, g, params, ref)
    dist_k = dist["kernel"]
    return {"ok": all(dist_k[n] <= limits[n] for n in GRADS),
            "limits": limits, "limit_parts": parts,
            "y3_flips": int(((y3.permute(0, 3, 1, 2) > 0)
                             != (pre64[2] > 0)).sum()),
            "design": "tensor cores" if cl.uses_tensor_cores(
                dt, x.shape[-1], params[0].shape[-1]) else "cuda cores",
            "pre_activations": [p.numel() for p in pre64],
            "rel_l2_to_f64": dist, "rel_l2_to_plain_f32": to_f32,
            "flips": flips}


# That earlier chip_smoke.py's kernels phase drew every check's inputs,
# its odd correlation shape's included, from one generator seeded 0, in
# this order, before the level checks.
REPLAY_CORR = (  # (wrapper, is the 2-D op, batches, is a backward)
    ("corr2d_fwd", True, (1, 2), False), ("corr1d_fwd", False, (1, 2), False),
    ("corr2d_bwd_f1", True, (2,), True), ("corr2d_bwd_f2", True, (2,), True),
    ("corr1d_bwd_f1", False, (2,), True), ("corr1d_bwd_f2", False, (2,), True))
REPLAY_ODD = ((3, 37, 20),)
REPLAY_LEVELS = [("fwd", b, s) for b in (3, 6) for s in LEVEL_SHAPES]
REPLAY_LEVELS += [("bwd", 6, s) for s in LEVEL_SHAPES]
REPLAY_LEVELS += [(kind, 1, s) for s in ODD_SHAPES for kind in ("fwd", "bwd")]


def replay_draws():
    """Yields (kind, shape, dtype, x, params, g) of each level check of
    that chip_smoke.py in its order, drawn as it drew them."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    hw, chans = (512, 1024), (16, 32, 64, 96, 128, 196)
    for name, two_d, batches, backward in REPLAY_CORR:
        dils = {"corr2d": (1, 2, 4, 8), "corr1d": (1, 2, 3)}[name[:6]]

        def nk(d):
            return (2 * d + 1) ** 2 if two_d else d + 1

        def disp(level):
            return 4 if two_d else max(96 // 2**level, 4)

        def shape(b, level):
            return (b, hw[0] >> level, hw[1] >> level, chans[level - 1])

        cases = [(b, disp(lv), shape(b, lv)) for b in batches
                 for lv in (6, 5, 4, 3, 2) for _ in range(2)]
        cases.append((2, disp(2), shape(2, 2)))
        cases += [(b, 4, shape(b, 3)) for b in batches for _ in dils
                  for _ in range(2)]
        if not backward:
            cases += [(b, 4, (b, *odd)) for b in batches for odd in REPLAY_ODD
                      for _ in ({"corr2d": (1, 3), "corr1d": (1,)}[name[:6]])
                      for _ in range(2)]
        for _, d, s in cases:
            torch.randn((*s[:3], nk(d)) if backward else s, generator=gen,
                        device="cuda")
            torch.randn(s, generator=gen, device="cuda")
    for kind, b, (label, _, h, w, c, f) in REPLAY_LEVELS:
        for dt in (torch.bfloat16, torch.float32):
            x, params, g = draw(b, h, w, c, f, dt, gen)
            yield kind, (label, b, h, w, c, f), dt, x, params, g


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=SEEDS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("level_witness: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.cuda.get_device_name(0)
    failed = []

    def report(draw_name, shape, dt, x, params, g):
        line = {"draw": draw_name, "shape": list(shape),
                "dtype": str(dt)[6:], "device": device,
                **case_report(x, params, g)}
        print(json.dumps(line), flush=True)
        if not line["ok"]:
            failed.append([draw_name, list(shape), line["dtype"]])

    for kind, shape, dt, x, params, g in replay_draws():
        if kind == "bwd":
            report("replay", shape, dt, x, params, g)
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for label, b, h, w, c, f, dt in CASES:
            x, params, g = draw(b, h, w, c, f, dt, gen)
            report(f"seed {seed}", (label, b, h, w, c, f), dt, x, params, g)
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
