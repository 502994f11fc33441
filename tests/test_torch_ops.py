"""The port's ops (cerberusnet_torch.ops) against the JAX reference.

The same numpy inputs go through the JAX functions (the pure formulation,
and the Pallas kernels in interpret mode on the CPU) and through the port's
plain versions, which a CPU tensor selects. Tolerances: float32 differs
only by summation order (rtol 1e-5, atol 1e-6); bfloat16 outputs are summed
in float32 and rounded once on both sides, so they agree within one bf16
ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.ops.correlation import (
    _correlation1d_pure,
    _correlation2d_pure,
)
from cerberusnet_tpu.ops.pallas.correlation import (
    correlation1d_pallas,
    correlation2d_pallas,
)
from cerberusnet_tpu.ops.warp import warp1d as jax_warp1d
from cerberusnet_tpu.ops.warp import warp2d as jax_warp2d
from cerberusnet_torch.ops import library
from cerberusnet_torch.ops.correlation import (
    _correlation1d_bwd_f1_plain,
    _correlation1d_bwd_f2_plain,
    _correlation1d_bwd_plain,
    _correlation1d_plain,
    _correlation2d_bwd_f1_plain,
    _correlation2d_bwd_f2_plain,
    _correlation2d_bwd_plain,
    _correlation2d_plain,
    correlation1d,
    correlation2d,
)
from cerberusnet_torch.ops.cuda import correlation as cuda_correlation
from cerberusnet_torch.ops.warp import warp1d, warp2d
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401



DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def bf16_ulp(x):
    mag = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_close(got, want, dtype, extra_atol=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        gap = np.abs(got - want)
        limit = np.maximum(bf16_ulp(got), bf16_ulp(want)) + extra_atol
        assert np.all(gap <= limit), (
            f"more than one bf16 ulp apart: max gap {gap.max()}")


def pair(rng, shape, dtype):
    """Two feature maps as (jax, torch) pairs holding identical values."""
    _, jdt, tdt = DTYPES[dtype]
    out = []
    for _ in range(2):
        a = rng.randn(*shape).astype(np.float32)
        j = jnp.asarray(a, jdt)
        out.append((j, torch.from_numpy(np.array(j, np.float32)).to(tdt)))
    return out


# (op, shape, max_disp, dilation): d=4 at 81 channels, D in {4, 24}, odd
# heights, dilation 2
CASES = [
    ("2d", (2, 11, 13, 8), 4, 1),
    ("2d", (1, 9, 20, 6), 3, 2),
    ("1d", (2, 7, 12, 8), 4, 1),
    ("1d", (1, 5, 30, 8), 24, 1),
    ("1d", (1, 9, 21, 5), 6, 2),
]
OPS = {
    "2d": (correlation2d, _correlation2d_pure, correlation2d_pallas),
    "1d": (correlation1d, _correlation1d_pure, correlation1d_pallas),
}


def _params():
    for op, shape, d, dil in CASES:
        for dtype in DTYPES:
            refs = ("pure", "pallas") if dil == 1 else ("pure",)
            for ref in refs:
                yield pytest.param(op, shape, d, dil, dtype, ref,
                                   id=f"{op}-{shape}-d{d}-dil{dil}-{dtype}-{ref}")


@pytest.mark.parametrize("op,shape,max_disp,dilation,dtype,ref", _params())
def test_correlation_matches_jax(op, shape, max_disp, dilation, dtype, ref):
    port, pure, pallas = OPS[op]
    (j1, t1), (j2, t2) = pair(np.random.RandomState(0), shape, dtype)
    if ref == "pure":
        want = pure(j1, j2, max_disp, dilation)
    else:
        want = pallas(j1, j2, max_disp, True)
    got = port(t1, t2, max_disp, dilation)
    assert got.dtype == DTYPES[dtype][2]
    nk = (2 * max_disp + 1) ** 2 if op == "2d" else max_disp + 1
    assert tuple(got.shape) == shape[:3] + (nk,)
    assert_close(got.float().numpy(), want, dtype)


def np_corr2d(f1, f2, d):
    """Literal loop transcription of the 2-D correlation's definition."""
    b, h, w, c = f1.shape
    k = 2 * d + 1
    out = np.zeros((b, h, w, k * k), np.float32)
    for bi in range(b):
        for y in range(h):
            for x in range(w):
                for oy in range(-d, d + 1):
                    for ox in range(-d, d + 1):
                        yy, xx = y + oy, x + ox
                        if 0 <= yy < h and 0 <= xx < w:
                            out[bi, y, x, (oy + d) * k + (ox + d)] = (
                                np.dot(f1[bi, y, x], f2[bi, yy, xx]) / c)
    return out


def np_corr1d(f1, f2, dmax):
    """Literal loop transcription of the 1-D correlation's definition."""
    b, h, w, c = f1.shape
    out = np.zeros((b, h, w, dmax + 1), np.float32)
    for bi in range(b):
        for y in range(h):
            for x in range(w):
                for k in range(dmax + 1):
                    if x - k >= 0:
                        out[bi, y, x, k] = np.dot(f1[bi, y, x],
                                                  f2[bi, y, x - k]) / c
    return out


class TestGolden:
    def test_2d_vs_numpy(self):
        rng = np.random.RandomState(1)
        f1, f2 = (rng.randn(2, 6, 7, 3).astype(np.float32) for _ in range(2))
        got = correlation2d(torch.from_numpy(f1), torch.from_numpy(f2), 2)
        np.testing.assert_allclose(got.numpy(), np_corr2d(f1, f2, 2),
                                   rtol=1e-5, atol=1e-6)

    def test_1d_vs_numpy(self):
        rng = np.random.RandomState(2)
        f1, f2 = (rng.randn(2, 5, 9, 3).astype(np.float32) for _ in range(2))
        got = correlation1d(torch.from_numpy(f1), torch.from_numpy(f2), 4)
        np.testing.assert_allclose(got.numpy(), np_corr1d(f1, f2, 4),
                                   rtol=1e-5, atol=1e-6)

    def test_channel_ordering(self):
        # an impulse in f2 at (y+1, x+2) lands in channel (1+d)(2d+1)+(2+d)
        # with value 1/C
        d = 4
        f1 = torch.zeros(1, 12, 12, 2)
        f2 = torch.zeros_like(f1)
        f1[0, 5, 5] = 1.0
        f2[0, 6, 7] = 1.0
        out = correlation2d(f1, f2, d)
        k = (1 + d) * (2 * d + 1) + (2 + d)
        assert out[0, 5, 5, k].item() == pytest.approx(1.0)
        out[0, 5, 5, k] = 0.0
        assert torch.all(out == 0.0)

    def test_1d_direction(self):
        # corr(x, k) correlates f1(x) with f2(x - k)
        f1 = torch.zeros(1, 4, 8, 1)
        f2 = torch.zeros_like(f1)
        f1[0, 2, 5] = 1.0
        f2[0, 2, 3] = 1.0
        out = correlation1d(f1, f2, 4)
        assert out[0, 2, 5, 2].item() == pytest.approx(1.0)
        out[0, 2, 5, 2] = 0.0
        assert torch.all(out == 0.0)

    @pytest.mark.parametrize("op", ["2d", "1d"])
    def test_bf16_in_f32_accumulation(self, op):
        # bf16 in, bf16 out, equal within one ulp to the f32 result on the
        # same (bf16-representable) values: the sum is f32, rounded once
        port = OPS[op][0]
        rng = np.random.RandomState(3)
        f1, f2 = (torch.from_numpy(rng.randn(1, 8, 10, 64).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(2))
        got = port(f1, f2, 2)
        assert got.dtype == torch.bfloat16
        want = port(f1.float(), f2.float(), 2)
        assert_close(got.float().numpy(), want.numpy(), "bfloat16")


class TestWarp:
    def _both(self, f, flow):
        want = np.asarray(jax_warp2d(jnp.asarray(f), jnp.asarray(flow)))
        got = warp2d(torch.from_numpy(f), torch.from_numpy(flow)).numpy()
        return got, want

    def test_fractional_flow_out_of_frame(self):
        rng = np.random.RandomState(4)
        f = rng.randn(2, 7, 9, 3).astype(np.float32)
        # fractional, large enough that many corners leave the frame
        flow = (rng.randn(2, 7, 9, 2) * 4).astype(np.float32)
        xs = np.arange(9) + flow[..., 0]
        assert np.any((xs < 0) | (xs > 8))
        got, want = self._both(f, flow)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_one_pixel_wide(self):
        # at W=1 the x-flow still moves samples out of the frame
        rng = np.random.RandomState(5)
        f = rng.randn(1, 6, 1, 2).astype(np.float32)
        flow = (rng.rand(1, 6, 1, 2) * 1.6 - 0.8).astype(np.float32)
        got, want = self._both(f, flow)
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert not np.allclose(got, f)

    def test_half_pixel_average(self):
        f = np.zeros((1, 4, 4, 1), np.float32)
        f[0, 1, 1] = 4.0
        f[0, 1, 2] = 8.0
        flow = np.zeros((1, 4, 4, 2), np.float32)
        flow[..., 0] = 0.5
        got, _ = self._both(f, flow)
        assert got[0, 1, 1, 0] == pytest.approx(6.0)

    def test_warp1d_matches_jax(self):
        rng = np.random.RandomState(6)
        f = rng.randn(1, 5, 11, 4).astype(np.float32)
        disp = (rng.rand(1, 5, 11, 1) * 6).astype(np.float32)
        want = np.asarray(jax_warp1d(jnp.asarray(f), jnp.asarray(disp)))
        got = warp1d(torch.from_numpy(f), torch.from_numpy(disp)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_disparity_samples_left(self):
        f = torch.zeros(1, 3, 8, 1)
        f[0, 1, 2] = 5.0
        out = warp1d(f, torch.full((1, 3, 8, 1), 3.0))
        assert out[0, 1, 5, 0].item() == pytest.approx(5.0)

    def test_bf16_keeps_type(self):
        rng = np.random.RandomState(7)
        f = torch.from_numpy(rng.randn(1, 6, 7, 3).astype(np.float32))
        flow = torch.from_numpy((rng.randn(1, 6, 7, 2) * 2).astype(np.float32))
        got = warp2d(f.to(torch.bfloat16), flow.to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        want = warp2d(f.to(torch.bfloat16).float(),
                      flow.to(torch.bfloat16).float())
        assert_close(got.float().numpy(), want.numpy(), "bfloat16")


BWD_OPS = {
    "2d": (_correlation2d_bwd_plain, _correlation2d_plain),
    "1d": (_correlation1d_bwd_plain, _correlation1d_plain),
}


def cotangent(rng, shape, nk, dtype):
    _, jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(rng.randn(*shape[:3], nk).astype(np.float32), jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


@pytest.mark.parametrize("op,shape,max_disp,dilation,dtype,ref", _params())
def test_correlation_backward_matches_jax_vjp(op, shape, max_disp, dilation,
                                              dtype, ref):
    """(df1, df2) of the plain backward against jax.vjp of the reference,
    for the same random cotangent: f32 to summation order, bf16 to one ulp
    (both sum in f32 and round once) plus 1e-6 for the sum order."""
    _, pure, pallas = OPS[op]
    bwd, _ = BWD_OPS[op]
    rng = np.random.RandomState(10)
    (j1, t1), (j2, t2) = pair(rng, shape, dtype)
    nk = (2 * max_disp + 1) ** 2 if op == "2d" else max_disp + 1
    jg, tg = cotangent(rng, shape, nk, dtype)
    if ref == "pure":
        _, vjp = jax.vjp(lambda a, b: pure(a, b, max_disp, dilation), j1, j2)
    else:
        _, vjp = jax.vjp(lambda a, b: pallas(a, b, max_disp, True), j1, j2)
    want = vjp(jg)
    got = bwd(tg, t1, t2, max_disp, dilation)
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[dtype][2]
        assert_close(g.float().numpy(), w, dtype, extra_atol=1e-6)


@pytest.mark.parametrize("op,shape,max_disp,dilation",
                         [pytest.param(*c, id=f"{c[0]}-{c[1]}-d{c[2]}-dil{c[3]}")
                          for c in CASES])
def test_correlation_backward_matches_autograd(op, shape, max_disp, dilation):
    """The plain backward equals torch autograd of the plain forward (f32)."""
    bwd, fwd = BWD_OPS[op]
    rng = np.random.RandomState(11)
    f1, f2 = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
              .requires_grad_() for _ in range(2))
    out = fwd(f1, f2, max_disp, dilation)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    want = torch.autograd.grad(out, (f1, f2), g)
    got = bwd(g, f1.detach(), f2.detach(), max_disp, dilation)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


PLAIN_KERNELS = {
    "corr2d_fwd": _correlation2d_plain,
    "corr1d_fwd": _correlation1d_plain,
    "corr2d_bwd_f1": _correlation2d_bwd_f1_plain,
    "corr2d_bwd_f2": _correlation2d_bwd_f2_plain,
    "corr1d_bwd_f1": _correlation1d_bwd_f1_plain,
    "corr1d_bwd_f2": _correlation1d_bwd_f2_plain,
}


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """The CUDA wrappers, counters included, with each launch replaced by
    the kernel's plain version, so the operators run on CPU
    tensors. A launch checks that its operands are NHWC-contiguous, as the
    kernels need."""

    def launch(name, a, f, max_disp, dilation, nk, out_channels):
        assert a.is_contiguous() and f.is_contiguous(), name
        assert a.shape[-1] == nk, name
        out = PLAIN_KERNELS[name](a, f, max_disp, dilation)
        assert out.shape[-1] == out_channels, name
        return out

    monkeypatch.setattr(cuda_correlation, "_launch", launch)
    cuda_correlation.reset_launches()
    yield
    cuda_correlation.reset_launches()


@pytest.mark.parametrize("op,dilation", [("2d", 1), ("2d", 2), ("1d", 1),
                                         ("1d", 2)])
class TestAutogradFunction:
    """The operators cerberus::corr2d_fwd / corr1d_fwd, the ops' path for
    CUDA tensors: the forward and both gradients go through the kernel
    wrappers."""

    FUNCS = {"2d": (library.corr2d_fwd, _correlation2d_plain, 3),
             "1d": (library.corr1d_fwd, _correlation1d_plain, 6)}

    def _inputs(self, op):
        rng = np.random.RandomState(12)
        shape = (2, 7, 11, 5)
        return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
                .requires_grad_() for _ in range(2)]

    def test_gradients_equal_plain_autograd(self, op, dilation,
                                            kernels_on_cpu):
        fn, plain, d = self.FUNCS[op]
        f1, f2 = self._inputs(op)
        out = fn(f1, f2, d, dilation)
        ref = plain(f1, f2, d, dilation)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        # a gradient laid out as the model's consumer leaves it: a channel
        # slice of a wider channels_last tensor, not NHWC-contiguous
        wide = torch.randn(*out.shape[:3], 2 * out.shape[-1] + 3)
        g = wide[..., 1 : 1 + 2 * out.shape[-1] : 2]
        assert not g.is_contiguous()
        got = torch.autograd.grad(out, (f1, f2), g)
        want = torch.autograd.grad(ref, (f1, f2), g)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)

    def test_counters_rise_once_per_call(self, op, dilation, kernels_on_cpu):
        fn, _, d = self.FUNCS[op]
        f1, f2 = self._inputs(op)
        for call in (1, 2):
            out = fn(f1, f2, d, dilation)
            out.square().sum().backward()
            counts = cuda_correlation.launches()
            for name, n in counts.items():
                assert n == (call if name.startswith(f"corr{op}") else 0), (
                    name, counts)

    def test_only_the_needed_gradient(self, op, dilation, kernels_on_cpu):
        fn, _, d = self.FUNCS[op]
        f1, f2 = self._inputs(op)
        out = fn(f1.detach(), f2, d, dilation)
        out.sum().backward()
        counts = cuda_correlation.launches()
        assert counts[f"corr{op}_bwd_f1"] == 0
        assert counts[f"corr{op}_bwd_f2"] == 1

    def test_inference_mode_forward(self, op, dilation, kernels_on_cpu):
        fn, plain, d = self.FUNCS[op]
        f1, f2 = (t.detach() for t in self._inputs(op))
        with torch.inference_mode():
            out = fn(f1, f2, d, dilation)
        torch.testing.assert_close(out, plain(f1, f2, d, dilation))
        assert cuda_correlation.launches()[f"corr{op}_fwd"] == 1


class TestDispatch:
    def test_cpu_tensors_launch_no_kernel(self):
        f = torch.randn(1, 6, 8, 4, requires_grad=True)
        correlation2d(f, f, 2).sum().backward()
        correlation1d(f, f, 4).sum().backward()
        correlation2d(f, f, 2, impl="plain")
        assert set(cuda_correlation.launches().values()) == {0}

    @pytest.mark.parametrize("kernel", cuda_correlation.KERNELS)
    def test_kernel_wrapper_refuses_cpu_tensors(self, kernel):
        f = torch.randn(1, 6, 8, 4)
        with pytest.raises(ValueError, match="CUDA device"):
            getattr(cuda_correlation, kernel)(f, f, 2)
        assert getattr(cuda_correlation, f"{kernel}_launches") == 0

    def test_rejects_mismatch_and_unknown_impl(self):
        with pytest.raises(ValueError, match="mismatch"):
            correlation2d(torch.zeros(1, 4, 4, 2), torch.zeros(1, 4, 5, 2))
        with pytest.raises(ValueError, match="impl"):
            correlation1d(torch.zeros(1, 4, 4, 2), torch.zeros(1, 4, 4, 2),
                          impl="pallas")
