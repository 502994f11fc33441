"""The tensor-core design of the correlation kernels (csrc/correlation.cu,
bfloat16), held on the CPU where the kernels cannot run.

The forwards (``corr2d_tc_fwd_kernel``, ``corr1d_tc_fwd_kernel``,
``emulate``): an emulation in float32 of the kernels' decomposition, with
the tile constants read from the source. A block owns a run of T tiles of
``kTcTile`` pixels of each of its residue classes of columns (pixels
x = 0 mod dil, 1 mod dil, ...: all of them, or a group of them where their
runs would exceed a block's shared memory) of R output rows of one residue
class of rows (2-D: y, y + dil, ...) and a group of G window rows. It
stages the R f1 runs and the f2 runs, with their halos, of the R + G - 1
window rows those rows share, of its classes only, class by class,
channels zero-padded to a multiple of 16, columns outside the frame
zero-filled and rows outside the frame skipped. For each (tile, class,
window row) it forms the band product S = F1 (16 x C16) F2^T (C16 x ncols)
over n8 column tiles in groups of min(ncols / 8 rounded up,
``kTcNtGroup``) (columns past the window clamped to its last), and
extracts the band: the 2-D op's displacement ox of pixel i is S[i, i + ox],
the 1-D op's k is S[i, i + D - k]; outputs of a skipped window row are
zero. The result must equal the plain versions (``_correlation2d_plain``,
``_correlation1d_plain``) and the JAX package's ``correlation2d`` /
``correlation1d`` (pure path) within 1e-6 of the largest output: both sum
the same float32 products in another order. The shapes are small and odd
(C = 20 and 32, W = 37 and 48, H = 3, below the 2-D window's height) at
dilations 1-3, the 2-D op at dilation 8 on one wide row, and both at
C = 196 on a narrow frame in class groups at dilations 3, 14, 15 and 25;
the block splits (T, G, R, classes) take the values the launch plan
chooses between.

The 2-D backwards (``corr2d_tc_bwd_f1_kernel``, ``corr2d_tc_bwd_f2_kernel``)
likewise (``emulate_bwd``): a block owns R output rows of one residue
class of rows, a run of ``kTcTile`` pixels of each residue class of columns
and a group of 8 NT channels (NT up to ``kTcBwdNtMax``), and walks the
R + 2d window rows those rows share; for each (row, class) whose window
row oy a staged row is, it adds the band product A (16 x k, k the 16 + 2d
window columns padded to a multiple of 16) times the staged window (k x
8 NT, the columns past the window clamped to its last) to accumulators
kept across the window rows, and scales once by 1/C at the end. df1's A
is A[i, j] = g(x_i, oy (2d + 1) + j - i), df2's (the gather) A[i, j] =
g(x_j, oy (2d + 1) + 2d - (j - i)) on the source row, both for
0 <= j - i <= 2d. A block computes up to ``kTcMaxWarps`` residue classes
of columns and stages the window and g of only those. The result must
equal ``_correlation2d_bwd_f1_plain`` / ``_f2_plain`` and ``jax.vjp`` of
the JAX package's ``correlation2d`` (pure path) within 1e-6 of the largest
output, at C = 20 and 21, W = 37, H = 3 and 7, dilations 1, 2, 3, 8 and
25.

The 1-D backwards (``corr1d_tc_bwd_f1_kernel``, ``corr1d_tc_bwd_f2_kernel``,
``emulate_bwd1d``): one window row, so a block owns one row, a run of T
tiles of each of its residue classes and a group of 8 NT channels, and a
tile's gradient is one band product: df1's A[i, j] = g(x_i, D - (j - i)),
df2's A[i, j] = g(x_j, j - i), for 0 <= j - i <= D. Held to
``_correlation1d_bwd_f1_plain`` / ``_f2_plain`` and ``jax.vjp`` of the
JAX package's ``correlation1d`` (pure path) within 1e-6 of the largest
output, at C = 20 and 21, W = 37 and 48, H = 3, D = 4, 12 and 24,
dilations 1, 2, 3 and 25.
"""


import functools
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cerberusnet_torch import level_phases, trace_forward
from cerberusnet_torch.ops import build
from cerberusnet_torch.ops.correlation import (
    _correlation1d_bwd_f1_plain,
    _correlation1d_bwd_f2_plain,
    _correlation1d_plain,
    _correlation2d_bwd_f1_plain,
    _correlation2d_bwd_f2_plain,
    _correlation2d_plain,
)
from cerberusnet_torch.ops.cuda import correlation as cc
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_tpu.ops.correlation import correlation1d as jax_corr1d
from cerberusnet_tpu.ops.correlation import correlation2d as jax_corr2d



SOURCE = (build.CSRC_DIR / "correlation.cu").read_text()


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


TILE = constant("kTcTile")
NT_GROUP = constant("kTcNtGroup")
MAX_TILES = constant("kTcMaxTiles")
BWD_NT_MAX = constant("kTcBwdNtMax")
MAX_WARPS = constant("kTcMaxWarps")
RTOL = 1e-6


def emulate(f1, f2, disp, dil, two_d, T, G, R=1, ncls=None):
    """The kernel's blocks, one after another, in float32. A block computes
    ``ncls`` residue classes of columns (by default all of them) and stages
    only theirs."""
    b, h, w, c = f1.shape
    c16 = -(-c // 16) * 16
    nx = 2 * disp + 1 if two_d else 1
    k_out = nx * nx if two_d else disp + 1
    ncols = TILE + (2 * disp if two_d else disp)
    nt_all = -(-ncols // 8)
    per_class = T * TILE
    nwin = per_class + ncols - TILE
    run = per_class * dil
    vdil = dil if two_d else 1  # residue classes of rows
    ncls = ncls or dil
    # the channel tail is zero in shared memory
    f1p = F.pad(f1.float(), (0, c16 - c))
    f2p = F.pad(f2.float(), (0, c16 - c))
    out = torch.full((b, h, w, k_out), float("nan"))
    u = torch.arange(ncls)[:, None]

    def stage(img_row, xs, cls0, n):
        """Columns m < n of the classes cls0 + u, u < ncls, column m of
        class cls0 + u the pixel xs + cls0 + u + dil m: (ncls, n, C16) rows;
        outside the frame zero."""
        x = xs + cls0 + u + dil * torch.arange(n)[None]
        inside = (x >= 0) & (x < w)
        return img_row[x.clamp(0, w - 1)] * inside[..., None]

    class_rows = -(-h // vdil)
    for bi, cy, m0, x0, oy0, cls0 in itertools.product(
            range(b), range(vdil), range(0, class_rows, R), range(0, w, run),
            range(0, nx, G), range(0, dil, ncls)):
        # R output rows of one residue class; window row wr of row r is
        # staged row r + wr
        ys = [cy + vdil * (m0 + r) for r in range(R)]
        npix = min(run, w - x0)
        nrows = min(G, nx - oy0)
        kout = nrows * nx if two_d else k_out
        a_s = {r: stage(f1p[bi, y], x0, cls0, per_class)
               for r, y in enumerate(ys) if y < h}
        b_s = {}
        for s in range(R + nrows - 1):
            yy = cy + vdil * (m0 + s + (oy0 - disp if two_d else 0))
            if 0 <= yy < h:  # rows outside are not staged
                b_s[s] = stage(f2p[bi, yy], x0 - disp * dil, cls0, nwin)
        # the run's pixels of the block's classes
        mine = [q for q in range(npix) if cls0 <= q % dil < cls0 + ncls]
        for r in a_s:
            outs = torch.full((run, kout), float("nan"))
            for wr, cl, t in itertools.product(range(nrows), range(ncls),
                                               range(T)):
                cls = cls0 + cl
                if cls >= dil:  # past the last class
                    continue
                p = [t * TILE * dil + cls + dil * i for i in range(TILE)]
                if r + wr not in b_s:
                    outs[p, wr * nx:(wr + 1) * nx] = 0.0
                    continue
                a = a_s[r][cl, t * TILE:(t + 1) * TILE]
                slab = b_s[r + wr][cl, t * TILE:]
                band_from(a, slab, p, outs, wr, two_d, nx, disp, c, ncols,
                          nt_all)
            cols = [x0 + q for q in mine]
            if two_d:
                out[bi, ys[r], cols, oy0 * nx:oy0 * nx + kout] = outs[mine]
            else:
                out[bi, ys[r], cols] = outs[mine]
    return out


def band_from(a, slab, p, outs, wr, two_d, nx, disp, c, ncols, nt_all):
    """One warp's item: S over n8 tiles in groups, then its band."""
    i = torch.arange(TILE)[:, None]
    p = torch.tensor(p)[:, None]
    nt = min(nt_all, NT_GROUP)  # the kernel's template argument
    for n0 in range(0, nt_all, nt):
        n = torch.arange(8 * n0, 8 * (n0 + nt))  # the last group may pass
        s = a @ slab[n.clamp(max=ncols - 1)].T  # (16, 8 nt), float32 sums
        o = n - i if two_d else i + disp - n
        band = (o >= 0) & (o < (nx if two_d else disp + 1))
        col = wr * nx + o if two_d else o
        outs[p.expand_as(o)[band], col[band]] = s[band] / c


def inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def jax_reference(two_d, shape, disp, dil, seed):
    f1, f2 = inputs(shape, seed)
    fn = jax_corr2d if two_d else jax_corr1d
    out = fn(jnp.asarray(f1), jnp.asarray(f2), disp, impl="pure",
             dilation=dil)
    return torch.from_numpy(np.array(out))


def check(two_d, shape, disp, dil, splits, seed=0):
    f1, f2 = (torch.from_numpy(v) for v in inputs(shape, seed))
    plain = (_correlation2d_plain if two_d else _correlation1d_plain)(
        f1, f2, disp, dil)
    ref = jax_reference(two_d, shape, disp, dil, seed)
    scale = RTOL * ref.abs().max().item()
    assert (plain - ref).abs().max().item() <= scale
    for split in splits:
        got = emulate(f1, f2, disp, dil, two_d, *split)
        assert not torch.isnan(got).any(), split  # every output written
        assert (got - plain).abs().max().item() <= scale, split
        assert (got - ref).abs().max().item() <= scale, split


# (C, W) pairs: 40-byte pixel rows (8-byte aligned) and 64-byte ones
WIDTHS = [(20, 37), (32, 48)]


@pytest.mark.parametrize("dil", [1, 2, 3])
@pytest.mark.parametrize("c,w", WIDTHS)
def test_corr2d_tiles(c, w, dil):
    # H = 3 rows: most window rows of d = 4 lie outside the frame; (T, G, R):
    # G = 9 (one block per run), 5 (two groups, the last short) and 1; R = 2
    # and 4 rows of a residue class per block, past the frame's last row
    check(True, (2, 3, w, c), 4, dil,
          [(1, 9, 1), (1, 5, 1), (1, 1, 1), (1, 9, 2), (1, 9, 4)])


@pytest.mark.parametrize("G", [9, 2])
def test_corr2d_tiles_dilation_8_on_one_wide_row(G):
    # W = 150 at dilation 8: runs of 128 pixels, the second cut at 22; the
    # halo of 32 columns each side lies partly outside the frame
    check(True, (1, 1, 150, 20), 4, 8, [(1, G, 1)])


def test_corr2d_tiles_row_runs():
    # 4 rows a block over 7 rows at dilation 2: classes of 4 and 3 rows
    check(True, (1, 7, 21, 20), 4, 2, [(1, 9, 4), (1, 9, 2)])


@pytest.mark.parametrize("dil", [1, 2, 3])
@pytest.mark.parametrize("disp", [4, 6])
@pytest.mark.parametrize("c,w", WIDTHS)
def test_corr1d_tiles(c, w, disp, dil):
    check(False, (2, 3, w, c), disp, dil,
          [(1, 1), (2, 1), (MAX_TILES, 1)])


@pytest.mark.parametrize("two_d", [True, False])
@pytest.mark.parametrize("dil,ncls", [(3, 2), (14, 7), (15, 8), (25, 13)])
def test_fwd_tiles_class_groups(two_d, dil, ncls):
    # C = 196 (level 6's width) at dilations where every class's runs
    # would exceed a block's shared memory: blocks of ncls classes (the
    # plan's; at dilation 3 a split the plan never takes there), the last
    # group short at 3, 15 and 25, each staging only its own
    check(two_d, (1, 2, 40, 196), 4, dil, [(1, 1, 1, ncls)])


def test_band_needs_more_than_one_column_group():
    # a window wider than kTcNtGroup n8 tiles (1-D, D = 33: 49 columns):
    # two passes over the channels
    disp = 8 * NT_GROUP - TILE + 1
    assert -(-(TILE + disp) // 8) > NT_GROUP
    check(False, (1, 2, 48, 20), disp, 1, [(1, 1), (MAX_TILES, 1)])


def pixels(img_row, xs):
    """img_row (W, ...) at columns xs; outside the frame zero."""
    w = img_row.shape[0]
    inside = (xs >= 0) & (xs < w)
    return img_row[xs.clamp(0, w - 1)] * inside[..., None]


def g_stride(k, dil, ncls):
    """bf16 between one window column of a class and the next in a staged
    run of g: ncls 2K bytes rounded up to bytes congruent to dil 2K mod
    16."""
    return (ncls * 2 * k + ((dil - ncls) * 2 * k) % 16) // 2


def stage_g(img_row, x_start, n, dil, ncls, gcol):
    """g of the classes cls0 + u, u < ncls, window columns m < n (column m
    of class cls0 + u the pixel x_start + u + dil m), flat as the kernel's
    shared memory holds it: column m of class cls0 + u at m gcol + u K."""
    k = img_row.shape[-1]
    flat = torch.zeros(n * gcol + ncls * k)
    rows = pixels(img_row, x_start + torch.arange(ncls)[:, None]
                  + dil * torch.arange(n)[None])
    for m in range(n):
        flat[m * gcol:m * gcol + ncls * k] = rows[:, m].reshape(-1)
    return flat


def band_a(flat, at, band):
    """A[i, j] = flat[at[i, j]] in the band, 0 elsewhere."""
    return torch.where(band, flat[at.clamp(0, flat.numel() - 1)],
                       torch.zeros(()))


def emulate_bwd(g, f, disp, dil, gather, nt, R, ncls=None):
    """The tensor-core backward's blocks, one after another, in float32:
    df1 from (g, f2), or df2 (``gather``) from (g, f1). A block computes
    ``ncls`` residue classes of columns (by default as many as a block has
    warps for) and stages only theirs; its g sits in a flat buffer as the
    kernel's shared memory holds it, window column m of class cls0 + u at
    m gcol + u K."""
    b, h, w, c = f.shape
    nx = 2 * disp + 1
    k = nx * nx
    ncols = TILE + 2 * disp  # window columns of a tile, also per class
    kpad = -(-ncols // 16) * 16
    nc = 8 * nt
    groups = -(-(-(-c // 8)) // nt)
    ncls = ncls or min(dil, MAX_WARPS)
    gcol = g_stride(k, dil, ncls)
    fp = F.pad(f.float(), (0, groups * nc - c))  # channels past C are zero
    g = g.float()
    run = TILE * dil
    out = torch.full((b, h, w, c), float("nan"))
    i = torch.arange(TILE)[:, None]
    j = torch.arange(kpad)[None, :]
    o = j - i
    band = (o >= 0) & (o <= 2 * disp)
    cols = torch.arange(kpad).clamp(max=ncols - 1)
    u = torch.arange(ncls)[:, None]
    for bi, cy, m0, x0, cg, cls0 in itertools.product(
            range(b), range(dil), range(0, -(-h // dil), R), range(0, w, run),
            range(groups), range(0, dil, ncls)):
        chans = slice(cg * nc, (cg + 1) * nc)
        ys = [cy + dil * (m0 + r) for r in range(R)]
        # df1: the g of the output rows' tile pixels of the block's classes
        g_runs = {r: stage_g(g[bi, y], x0 + cls0, TILE, dil, ncls, gcol)
                  for r, y in enumerate(ys) if y < h}
        acc = {(r, cls): torch.zeros((TILE, nc)) for r in g_runs
               for cls in range(cls0, min(cls0 + ncls, dil))}
        xw0 = x0 - disp * dil
        for s_ in range(R + 2 * disp):
            yy = cy + dil * (m0 + s_ - disp)
            if not 0 <= yy < h:
                continue  # not staged, no products
            # (class, window column, channel)
            win = pixels(fp[bi, yy, :, chans],
                         xw0 + cls0 + u + dil * torch.arange(ncols)[None])
            g_slab = stage_g(g[bi, yy], xw0 + cls0, ncols, dil, ncls, gcol)
            for r, cls in acc:
                oy = r + 2 * disp - s_ if gather else s_ - r
                if not 0 <= oy <= 2 * disp:
                    continue
                base = (cls - cls0) * k + oy * nx
                if gather:  # g of window pixel j at displacement 2d - o
                    a = band_a(g_slab, base + 2 * disp + gcol * j - o, band)
                else:  # g of tile pixel i at displacement o
                    a = band_a(g_runs[r], base + gcol * i + o, band)
                acc[(r, cls)] += a @ win[cls - cls0, cols]
        for (r, cls), sums in acc.items():
            for ii in range(TILE):
                x = x0 + cls + dil * ii
                if x < w:
                    out[bi, ys[r], x, cg * nc:min((cg + 1) * nc, c)] = (
                        sums[ii, :min(nc, c - cg * nc)] / c)
    return out


@functools.lru_cache(maxsize=None)
def jax_vjp_reference(shape, disp, dil, seed):
    """(df1, df2) of the JAX package's pure correlation2d for the
    cotangent g."""
    f1, f2, g = bwd_inputs(shape, disp, seed)
    _, vjp = jax.vjp(
        lambda a, b: jax_corr2d(a, b, disp, impl="pure", dilation=dil),
        jnp.asarray(f1), jnp.asarray(f2))
    return tuple(torch.from_numpy(np.array(v)) for v in vjp(jnp.asarray(g)))


def bwd_inputs(shape, disp, seed):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    g = rng.standard_normal((*shape[:3], (2 * disp + 1) ** 2)).astype(
        np.float32)
    return f1, f2, g


def check_bwd(shape, disp, dil, splits, seed=0):
    f1, f2, g = (torch.from_numpy(v) for v in bwd_inputs(shape, disp, seed))
    refs = jax_vjp_reference(shape, disp, dil, seed)
    plains = (_correlation2d_bwd_f1_plain(g, f2, disp, dil),
              _correlation2d_bwd_f2_plain(g, f1, disp, dil))
    for gather, f, plain, ref in zip((False, True), (f2, f1), plains, refs):
        scale = RTOL * ref.abs().max().item()
        assert (plain - ref).abs().max().item() <= scale
        for split in splits:
            got = emulate_bwd(g, f, disp, dil, gather, *split)
            assert not torch.isnan(got).any(), split  # every output written
            assert (got - plain).abs().max().item() <= scale, (gather, split)
            assert (got - ref).abs().max().item() <= scale, (gather, split)


@pytest.mark.parametrize("dil", [1, 2, 3])
@pytest.mark.parametrize("c", [20, 21])
def test_corr2d_bwd_tiles(c, dil):
    # H = 3 rows, W = 37: most window rows outside the frame, a ragged run;
    # (NT, R): channel groups of 16 (two, the second partly past C), 32
    # and the most, 64; 1, 2 and 4 rows a block, past the frame's last row
    check_bwd((2, 3, 37, c), 4, dil, [(2, 1), (4, 2), (BWD_NT_MAX, 4)])


def test_corr2d_bwd_tiles_dilation_8_on_one_wide_row():
    # runs of 128 pixels, the second cut at 22; the halo of 32 columns each
    # side lies partly outside the frame
    check_bwd((1, 1, 150, 20), 4, 8, [(2, 1), (BWD_NT_MAX, 2)])


def test_corr2d_bwd_tiles_row_runs():
    # 4 rows a block over 7 rows at dilation 2: classes of 4 and 3 rows
    check_bwd((1, 7, 21, 20), 4, 2, [(2, 4), (4, 2)])


def test_corr2d_bwd_tiles_class_groups():
    # blocks that compute some of the residue classes of columns and stage
    # only theirs: at dilation 25 the first block 16 classes (one a warp),
    # the second the last 9; at dilation 3 groups of 2 and 1
    check_bwd((1, 3, 37, 21), 4, 25, [(2, 1)])
    check_bwd((2, 3, 37, 20), 4, 3, [(2, 1, 2), (BWD_NT_MAX, 2, 1)])


def emulate_bwd1d(g, f, disp, dil, gather, nt, T, ncls=None):
    """The 1-D tensor-core backward's blocks, one after another, in
    float32: df1 from (g, f2), or df2 (``gather``) from (g, f1). A block
    owns one row, a run of T tiles of ``kTcTile`` pixels of each of its
    ``ncls`` residue classes of columns (by default as many as a block has
    warps for) and a group of 8 NT channels; it stages the window (16 T + D
    pixels of each class, from D dil pixels left of the run for df1, from
    the run for df2) and g (df1: the tiles' pixels; df2: the window's) of
    only its classes. A tile's df (16 x 8 NT) is one band product A (16 x
    k, k the 16 + D window columns padded to a multiple of 16) times the
    tile's window (the columns past it clamped to its last): df1's A[i, j]
    = g(x_i, D - (j - i)), df2's (the gather) A[i, j] = g(x_j, j - i), for
    0 <= j - i <= D; scaled once by 1/C."""
    b, h, w, c = f.shape
    k = disp + 1
    ncols = TILE + disp  # window columns of a tile
    kpad = -(-ncols // 16) * 16
    nwin = TILE * (T - 1) + ncols  # window columns of a class
    nc = 8 * nt
    groups = -(-(-(-c // 8)) // nt)
    ncls = ncls or min(dil, MAX_WARPS)
    gcol = g_stride(k, dil, ncls)
    fp = F.pad(f.float(), (0, groups * nc - c))  # channels past C are zero
    g = g.float()
    run = TILE * dil * T
    out = torch.full((b, h, w, c), float("nan"))
    i = torch.arange(TILE)[:, None]
    j = torch.arange(kpad)[None, :]
    o = j - i
    band = (o >= 0) & (o <= disp)
    cols = torch.arange(kpad).clamp(max=ncols - 1)
    u = torch.arange(ncls)[:, None]
    for bi, y, x0, cg, cls0 in itertools.product(
            range(b), range(h), range(0, w, run), range(groups),
            range(0, dil, ncls)):
        chans = slice(cg * nc, (cg + 1) * nc)
        xw0 = x0 - (0 if gather else disp) * dil  # the window's first pixel
        # (class, window column, channel)
        win = pixels(fp[bi, y, :, chans],
                     xw0 + cls0 + u + dil * torch.arange(nwin)[None])
        if gather:  # g of the window's pixels
            flat = stage_g(g[bi, y], xw0 + cls0, nwin, dil, ncls, gcol)
        else:  # g of the tiles' pixels
            flat = stage_g(g[bi, y], x0 + cls0, TILE * T, dil, ncls, gcol)
        for t, cl in itertools.product(range(T), range(ncls)):
            cls = cls0 + cl
            if cls >= dil:  # past the last class
                continue
            base = gcol * TILE * t + cl * k
            if gather:  # g of window pixel j at displacement o
                a = band_a(flat, base + gcol * j + o, band)
            else:  # g of tile pixel i at displacement D - o
                a = band_a(flat, base + disp + gcol * i - o, band)
            sums = a @ win[cl, TILE * t + cols]
            for ii in range(TILE):
                x = x0 + cls + dil * (TILE * t + ii)
                if x < w:
                    out[bi, y, x, cg * nc:min((cg + 1) * nc, c)] = (
                        sums[ii, :min(nc, c - cg * nc)] / c)
    return out


@functools.lru_cache(maxsize=None)
def jax_vjp1d_reference(shape, disp, dil, seed):
    """(df1, df2) of the JAX package's pure correlation1d for the
    cotangent g."""
    f1, f2, g = bwd1d_inputs(shape, disp, seed)
    _, vjp = jax.vjp(
        lambda a, b: jax_corr1d(a, b, disp, impl="pure", dilation=dil),
        jnp.asarray(f1), jnp.asarray(f2))
    return tuple(torch.from_numpy(np.array(v)) for v in vjp(jnp.asarray(g)))


def bwd1d_inputs(shape, disp, seed):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    g = rng.standard_normal((*shape[:3], disp + 1)).astype(np.float32)
    return f1, f2, g


def check_bwd1d(shape, disp, dil, splits, seed=0):
    f1, f2, g = (torch.from_numpy(v) for v in bwd1d_inputs(shape, disp, seed))
    refs = jax_vjp1d_reference(shape, disp, dil, seed)
    plains = (_correlation1d_bwd_f1_plain(g, f2, disp, dil),
              _correlation1d_bwd_f2_plain(g, f1, disp, dil))
    for gather, f, plain, ref in zip((False, True), (f2, f1), plains, refs):
        scale = RTOL * ref.abs().max().item()
        assert (plain - ref).abs().max().item() <= scale
        for split in splits:
            got = emulate_bwd1d(g, f, disp, dil, gather, *split)
            assert not torch.isnan(got).any(), split  # every output written
            assert (got - plain).abs().max().item() <= scale, (gather, split)
            assert (got - ref).abs().max().item() <= scale, (gather, split)


@pytest.mark.parametrize("dil", [1, 2, 3])
@pytest.mark.parametrize("disp", [4, 12, 24])
@pytest.mark.parametrize("c,w", [(20, 37), (21, 48)])
def test_corr1d_bwd_tiles(c, w, disp, dil):
    # H = 3 rows, ragged runs; (NT, T): channel groups of 16 (two, the
    # second partly past C), 32 and the most, 64; 1, 2 and kTcMaxTiles
    # tiles of a class a block, past the frame's last column
    check_bwd1d((2, 3, w, c), disp, dil,
                [(2, 1), (4, 2), (BWD_NT_MAX, MAX_TILES)])


def test_corr1d_bwd_tiles_class_groups():
    # blocks that compute some of the residue classes of columns and stage
    # only theirs: at dilation 25 the first block 16 classes (one a warp),
    # the second the last 9; at dilation 3 groups of 2 and 1
    check_bwd1d((1, 3, 37, 21), 4, 25, [(2, 1)])
    check_bwd1d((2, 3, 37, 20), 4, 3, [(2, 1, 2), (BWD_NT_MAX, 2, 1)])


def test_kernel_names_and_phase_marks():
    # trace_forward files kernels by the corr2d_/corr1d_ prefix, chip_smoke
    # reads ptxas lines by the _kernel suffix
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", SOURCE)
    assert {"corr2d_tc_fwd_kernel", "corr1d_tc_fwd_kernel",
            "corr2d_tc_bwd_f1_kernel", "corr2d_tc_bwd_f2_kernel",
            "corr1d_tc_bwd_f1_kernel", "corr1d_tc_bwd_f2_kernel"} <= set(names)
    for name in names:
        assert name.startswith(("corr2d_", "corr1d_"))
        assert name.endswith("_kernel")
        assert trace_forward.category(name) == "correlation"
    # one mark per phase in each CUDA-core kernel (k = 0, 1, 4, 5, 8, 9)
    # and in each device function of the tensor-core kernels (k = 2, 3 in
    # tc_fwd; 6, 7, 10, 11 in tc_bwd, the 2-D and 1-D backwards), whose
    # kPhase is the row
    marks = re.findall(r"PHASE_MARK\((\w+), (\d)\);", SOURCE)
    phases = list(range(len(level_phases.CORR_PHASES)))
    for k in ("0", "1", "4", "5", "8", "9"):
        assert sorted(int(p) for kk, p in marks if kk == k) == phases
    assert sorted(int(p) for kk, p in marks if kk == "kPhase") == sorted(
        2 * phases)
    for fn, rows in (("tc_fwd(", "k2d ? 2 : 3"),
                     ("tc_bwd(", "k2d ? (kF2 ? 7 : 6) : (kF2 ? 11 : 10)")):
        body = SOURCE[SOURCE.index(f"__forceinline__ void {fn}"):]
        assert f"constexpr int kPhase = {rows};" in body[:body.index("\n}\n")]
    # the rows of level_phases.CORR_KERNELS: each kernel's (wrapper, design)
    kernels = dict(enumerate(level_phases.CORR_KERNELS))
    assert kernels[8] == ("corr1d_bwd_f1", "cuda_cores")
    assert kernels[9] == ("corr1d_bwd_f2", "cuda_cores")
    assert kernels[10] == ("corr1d_bwd_f1", "tc")
    assert kernels[11] == ("corr1d_bwd_f2", "tc")
    rows = re.search(r"corr_phase_cycles\[(\d+)\]\[3\];", SOURCE)
    assert int(rows.group(1)) == len(level_phases.CORR_KERNELS) == 12
    items = re.search(r"corr_item_cycles\[(\d+)\]\[3\];", SOURCE)
    assert int(items.group(1)) == level_phases.CORR_ITEM_ROWS


def test_each_launcher_counts_its_design():
    # a check reads the design that ran from these counts: the tensor-core
    # launcher counts row "tc", the CUDA-core one "cuda_cores", each after a
    # launch that succeeded, and nothing else touches them
    rows = re.search(r"unsigned long long corr_design_launches\[(\d+)\];",
                     SOURCE)
    assert int(rows.group(1)) == len(cc.DESIGNS)
    assert SOURCE.count("++corr_design_launches") == 3
    for launcher, design in (("cudaError_t launch_tc(", "tc"),
                             ("cudaError_t launch_tc_bwd(", "tc"),
                             ("cudaError_t launch(", "cuda_cores")):
        body = SOURCE[SOURCE.index(launcher):]
        body = body[:body.index("\n}\n")]
        row = cc.DESIGNS.index(design)
        assert (f"if (err == cudaSuccess) ++corr_design_launches[{row}];"
                in body)


def test_correlation_measurement_builds():
    flags = [build.flags(d)[len(build.NVCC_FLAGS):]
             for d in level_phases.CORR_MEASUREMENT_BUILDS.values()]
    assert flags == [("-DCORR_PHASES",), ("-DCORR_PHASES", "-DCORR_SIMT"),
                     ("-DCORR_SIMT",)]
    for define in ("CORR_PHASES", "CORR_SIMT"):
        assert f"#ifdef {define}" in SOURCE
    paths = {build.library_path("correlation", d)
             for d in ((), *level_phases.CORR_MEASUREMENT_BUILDS.values())}
    assert len(paths) == 4


def test_library_name_covers_the_shared_header(tmp_path, monkeypatch):
    # both sources include csrc/ptx.cuh: an edited header names a new library
    assert '#include "ptx.cuh"' in SOURCE
    for name in ("correlation.cu", "encoder_level.cu", "ptx.cuh"):
        (tmp_path / name).write_bytes((build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = {n: build.library_path(n) for n in ("correlation",
                                                 "encoder_level")}
    (tmp_path / "ptx.cuh").write_text(
        (tmp_path / "ptx.cuh").read_text() + "\n// edited\n")
    for name, path in before.items():
        assert build.library_path(name) != path
