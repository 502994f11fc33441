"""The port's bench timing (cerberusnet_torch/utils/benchutil.py) with a
stand-in clock, against the JAX package's (cerberusnet_tpu/utils/
benchutil.py) where they share a contract, and the port's FLOP count
(cerberusnet_torch/utils/flops.py) against its analytic formulas on the
CPU.

The stand-in clock advances by a fixed amount per call of the timed
function and by a per-block constant at each mark, so a two-point slope is
exactly the per-call amount (the amounts are binary fractions, so the
arithmetic is exact)."""

import itertools

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from cerberusnet_torch.ops import library  # noqa: F401  the operators
from cerberusnet_torch.ops.cuda import correlation as cc
from cerberusnet_torch.ops.cuda import encoder_level as cl
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.utils import benchutil, flops
from cerberusnet_tpu.utils import benchutil as jax_benchutil

PER_CALL = 0.25
PER_MARK = 3.0


class StandIn:
    """A host clock that the timed function advances by ``per_call`` and
    every read by ``per_mark``."""

    def __init__(self, per_call=PER_CALL, per_mark=PER_MARK):
        self.t, self.per_call, self.per_mark = 0.0, per_call, per_mark
        self.calls = 0

    def now(self):
        self.t += self.per_mark
        return self.t

    def fn(self):
        self.t += self.per_call
        self.calls += 1
        return torch.ones(2)


@pytest.mark.parametrize("iters", [(2, 7), (2, 12), (1, 33)])
def test_two_point_rounds_exact_slope(iters):
    clock = StandIn()
    slopes = benchutil.time_fn_two_point_rounds(
        clock.fn, (), iters=iters, rounds=3,
        clock=benchutil.HostClock(now=clock.now), floor=0.0)
    assert slopes == [PER_CALL] * 3
    n1, n2 = iters
    assert clock.calls == (n1 + n2) * (1 + 3)  # a warmup of each, 3 rounds


def test_between_runs_before_each_round_outside_its_blocks():
    """``between`` runs once before each round; the clock time it takes
    is in no slope."""
    clock = StandIn()
    marks = []

    def between():
        marks.append(clock.calls)
        clock.t += 100.0  # a slow call between rounds

    slopes = benchutil.time_fn_two_point_rounds(
        clock.fn, (), iters=(2, 7), rounds=3,
        clock=benchutil.HostClock(now=clock.now), floor=0.0,
        between=between)
    assert slopes == [PER_CALL] * 3
    # after the warmup's 2 + 7 calls, and after each round's
    assert marks == [9, 18, 27]


def test_two_point_best_and_floor_subtracted():
    clock = StandIn()
    host = benchutil.HostClock(now=clock.now)
    assert benchutil.time_fn_two_point(clock.fn, (), iters=(2, 12),
                                       clock=host, floor=0.0) == PER_CALL
    # one block's time is n * PER_CALL plus one mark's PER_MARK: the floor
    # taken off once leaves the work
    assert benchutil.time_fn(clock.fn, (), iters=8, clock=host,
                             floor=PER_MARK) == PER_CALL


def test_each_output_reduced_on_its_call():
    clock = StandIn()
    seen = []

    def reduce_out(out):
        seen.append(out)
        return out.sum()

    run = benchutil._block_of_calls(clock.fn, (), reduce_out)(5)
    assert float(run()) == 10.0 and len(seen) == 5


class Scripted:
    """A host clock reading the given block durations in order; each block
    reads it twice (start, end)."""

    def __init__(self, durations):
        times = itertools.accumulate(
            itertools.chain.from_iterable((0.0, d) for d in durations))
        self.times = iter(times)

    def now(self):
        return next(self.times)


def rounds_of(durations, **kw):
    clock = benchutil.HostClock(now=Scripted(durations).now)
    return benchutil.time_fn_two_point_rounds(
        lambda: torch.zeros(()), (), iters=(2, 4), rounds=3, clock=clock,
        floor=0.0, **kw)


def test_non_positive_slopes_dropped():
    # rounds: (n1, n2) block times; slopes 1.0, -0.5 (dropped), 2.0
    assert rounds_of([1.0, 3.0, 2.0, 1.0, 1.0, 5.0]) == [1.0, 2.0]


@pytest.mark.parametrize("durations", [
    [1.0, 3.0, 2.0, 1.0, 2.0, 2.0],  # one positive, one negative, one zero
    [3.0, 1.0, 2.0, 2.0, 4.0, 1.0],  # none positive
])
def test_fewer_than_two_positive_slopes_raise(durations):
    with pytest.raises(benchutil.FloorLimitedTiming) as e:
        rounds_of(durations)
    assert e.value.iters == 2


@pytest.mark.parametrize("floor,raises", [(0.4, False), (0.4999, False),
                                          (0.5, True), (0.6, True)])
def test_slope_within_min_ratio_of_floor_raises(floor, raises):
    """Slopes of 1.0 and 2.0 a call against SLOPE_MIN_RATIO x the floor:
    at or under it raises."""
    clock = benchutil.HostClock(now=Scripted([1.0, 3.0, 1.0, 5.0, 1.0,
                                              3.0]).now)

    def run():
        return benchutil.time_fn_two_point_rounds(
            lambda: torch.zeros(()), (), iters=(2, 4), rounds=3,
            clock=clock, floor=floor)

    assert benchutil.SLOPE_MIN_RATIO == 2.0
    if raises:
        with pytest.raises(benchutil.FloorLimitedTiming):
            run()
    else:
        assert run() == [1.0, 2.0, 1.0]


def test_time_fn_lengthens_a_floor_limited_block():
    clock = StandIn(per_call=0.25, per_mark=0.0)
    host = benchutil.HostClock(now=clock.now)
    # 8 calls: 2.0 s <= 2 x a 1.0 s floor, so the block grows to 32 calls
    assert benchutil.time_fn(clock.fn, (), iters=8, clock=host, floor=1.0,
                             min_ratio=2.0) == (32 * 0.25 - 1.0) / 32
    with pytest.raises(benchutil.FloorLimitedTiming):
        benchutil.time_fn(clock.fn, (), iters=8, clock=host, floor=1.0,
                          min_ratio=2.0, max_iters=8)


def test_roundtrip_floor_on_the_host_clock():
    clock = StandIn(per_call=0.0, per_mark=2.0)
    host = benchutil.HostClock(now=clock.now)
    assert benchutil.roundtrip_floor(calls=4, clock=host) == 2.0 / 4


def test_stats_as_the_jax_bench():
    st = benchutil.stats([0.02, 0.025, 0.04], batch=2)
    assert st == {"fps": 80.0, "fps_band": [50.0, 100.0], "rounds": 3}


GRID = [(best, floor, iters, ratio)
        for best in (0.0, 1e-3, 0.01, 0.0123, 2.5)
        for floor in (0.0, 1e-4, 5e-3, 0.01)
        for iters in (1, 10, 1280) for ratio in (1.0, 2.0)]


@pytest.mark.parametrize("best,floor,iters,ratio", GRID)
def test_per_iter_seconds_parity(best, floor, iters, ratio):
    """The same arithmetic, the same raise, the same fields and message."""
    try:
        want = jax_benchutil.per_iter_seconds(best, floor, iters, ratio)
    except jax_benchutil.FloorLimitedTiming as e:
        with pytest.raises(benchutil.FloorLimitedTiming) as got:
            benchutil.per_iter_seconds(best, floor, iters, ratio)
        assert (got.value.best, got.value.floor, got.value.iters) == (
            e.best, e.floor, e.iters)
        assert str(got.value) == str(e)
    else:
        assert benchutil.per_iter_seconds(best, floor, iters, ratio) == want


# ------------------------------------------------------------- FLOPs


def test_conv_counts_every_tap():
    x, k = torch.randn(2, 5, 9, 11), torch.randn(7, 5, 3, 3)
    with FlopCounterMode(display=False) as mode:
        F.conv2d(x, k, padding=1)
    assert mode.get_total_flops() == 2 * 2 * 7 * 9 * 11 * 5 * 3 * 3


CORR_CASES = [("2d", 4, 1), ("2d", 4, 2), ("1d", 6, 1), ("1d", 4, 3)]


@pytest.mark.parametrize("kind,d,dil", CORR_CASES)
@pytest.mark.parametrize("op", ["fwd", "bwd_f1", "bwd_f2"])
def test_correlation_operators_count_their_formula(kind, d, dil, op):
    b, h, w, c = 2, 7, 13, 5
    nk = (2 * d + 1) ** 2 if kind == "2d" else d + 1
    f = torch.randn(b, h, w, c)
    a = torch.randn(b, h, w, c if op == "fwd" else nk)
    fn = getattr(torch.ops.cerberus, f"corr{kind}_{op}")
    before = cc.launches()
    with flops.plain_operators(), FlopCounterMode(display=False) as mode:
        fn(a, f, d, dil)
    want = (flops.corr2d_flops if kind == "2d" else flops.corr1d_flops)(
        b, h, w, c, d, dil)
    assert mode.get_total_flops() == want
    assert cc.launches() == before  # the plain versions launch nothing


def level_tensors(b, h, w, c, f, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen)
    params = [torch.randn(s, generator=gen) for s in (
        (3, 3, c, f), (f,), (3, 3, f, f), (f,), (3, 3, f, f), (f,))]
    return x, params


@pytest.mark.parametrize("need_dx", [True, False])
def test_level_operators_count_their_formula(need_dx):
    b, h, w, c, f = 2, 8, 16, 3, 8
    x, params = level_tensors(b, h, w, c, f)
    y3 = torch.randn(b, h // 2, w // 2, f)
    before = cl.launches()
    with flops.plain_operators(), FlopCounterMode(display=False) as mode:
        torch.ops.cerberus.encoder_level_fwd(x, *params, "pallas")
    fwd, inner = flops.level_flops(b, h, w, c, f)
    assert mode.get_total_flops() == fwd
    with flops.plain_operators(), FlopCounterMode(display=False) as mode:
        torch.ops.cerberus.encoder_level_bwd(x, y3, y3, *params, need_dx)
    assert mode.get_total_flops() == flops.level_bwd_flops(b, h, w, c, f,
                                                           need_dx)
    assert flops.level_bwd_flops(b, h, w, c, f) == 3 * fwd - inner
    assert cl.launches() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_level_backward_equals_the_ports(dtype):
    """plain_operators' level backward (by hand, torch.nn.grad) against
    encoder_level_bwd_plain (torch.func.vjp), the same math."""
    from cerberusnet_torch.ops.encoder_level import encoder_level_bwd_plain

    x, params = level_tensors(2, 8, 16, 4, 8, seed=3)
    x, params = x.to(dtype), [p.to(dtype) for p in params]
    g = torch.randn(2, 4, 8, 8).to(dtype)
    want = encoder_level_bwd_plain(x, None, g, *params)
    got = flops._level_bwd_plain(x, None, g, *params)
    rtol = 1e-5 if dtype == torch.float32 else 2.0**-7
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.float(), b_.float(), rtol=rtol,
                                   atol=rtol * b_.float().abs().max().item())
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert flops._level_bwd_plain(x, None, g, *params, need_dx=False)[0] \
        is None


def test_plain_operators_restore_the_wrappers():
    from cerberusnet_torch.ops import correlation as corr
    from cerberusnet_torch.ops import encoder_level as enc

    names = [(cc, n) for n in cc.KERNELS] + [
        (cl, "level_fwd"), (cl, "level_bwd"), (corr, "_dispatch"),
        (enc, "_takes_plain")]
    before = [getattr(m, n) for m, n in names]
    with flops.plain_operators():
        assert all(getattr(m, n) is not f for (m, n), f in zip(names, before))
    assert [getattr(m, n) for m, n in names] == before


def test_cpu_forward_counts_its_correlations():
    """A CPU forward goes through the operators under count(): its FLOPs are
    the convolutions' plus the analytic counts of its 5 + 5 correlations;
    without them the correlations count nothing."""
    from cerberusnet_torch.entry import entry

    forward, frames = entry(device="cpu", dtype=torch.float32, hw=(64, 64),
                            model_kw={"encoder_channels": (8, 12, 16, 16, 16,
                                                           16),
                                      "est_channels": (16, 16, 12),
                                      "ctx_channels": (16, 16),
                                      "fpn_channels": 16})
    with FlopCounterMode(display=False) as mode:
        forward(*frames)
    convs = mode.get_total_flops()
    with flops.plain_operators(), FlopCounterMode(display=False) as mode:
        forward(*frames)
    by_op = {str(k): v for k, v in mode.get_flop_counts()["Global"].items()}
    assert set(by_op) == {"aten.convolution", "cerberus.corr2d_fwd",
                          "cerberus.corr1d_fwd"}
    assert by_op["aten.convolution"] == convs
    assert flops.count(lambda: forward(*frames), "cpu") == sum(
        by_op.values()) > convs


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 67.0e12, 989.4e12)),
    ("NVIDIA H100 PCIe", (2.0e12, 51.2e12, 756.0e12)),
    ("NVIDIA H100 NVL", (3.9e12, 60.0e12, 835.5e12)),
])
def test_card_peaks(name, want):
    peaks = flops.card_peaks(name)
    assert (peaks["bytes"], peaks["f32"], peaks["bf16"]) == want
    assert flops.card_peaks("NVIDIA A100-SXM4-80GB") is None
