// Correlation cost-volume kernels for Hopper (sm_90a): forward and backward.
//
// Six kernels, all on NHWC-contiguous tensors in float32 or bfloat16. With
// o in {-d..d}^2, k = (o_y + d) * (2d + 1) + (o_x + d) for the 2-D op and
// k in 0..D for the 1-D op, and g the gradient of the cost volume:
//
//   corr2d_fwd:    out(x, k) = (1/C) * sum_c f1_c(x) * f2_c(x + dil*o)
//   corr2d_bwd_f1: df1_c(x)  = (1/C) * sum_o g(x, k) * f2_c(x + dil*o)
//   corr2d_bwd_f2: df2_c(y)  = (1/C) * sum_o g(y - dil*o, k) * f1_c(y - dil*o)
//   corr1d_fwd:    out(x, k) = (1/C) * sum_c f1_c(y, x) * f2_c(y, x - dil*k)
//   corr1d_bwd_f1: df1_c(x)  = (1/C) * sum_k g(x, k) * f2_c(y, x - dil*k)
//   corr1d_bwd_f2: df2_c(x)  = (1/C) * sum_k g(y, x + dil*k, k) * f1_c(y, x + dil*k)
//
// They replace the TPU kernels of cerberusnet_tpu/ops/pallas/correlation.py:
// _corr2d_fwd_kernel, _corr2d_bwd_f1_kernel and _corr2d_bwd_f2_kernel (host
// functions _corr2d_forward and _corr2d_vjp_bwd), and _corr1d_fwd_kernel,
// _corr1d_bwd_f1_kernel and _corr1d_bwd_f2_kernel (_corr1d_forward and
// _corr1d_vjp_bwd). At dilation > 1, as the DCV heads call them, the two
// forwards also replace _corr2d_wl_kernel and _corr1d_wl_kernel
// (_corr2d_wl_forward, _corr1d_wl_forward): the same functions, whose
// W-in-lanes layout fitted the TPU's vector lanes and is no part of what
// they compute.
//
// Samples outside the frame contribute zero; the kernels mask them while
// staging, so the host pads nothing. Products and sums run in float32, the
// sum is divided by C once and cast once to the input type, as the plain
// versions in cerberusnet_torch/ops/correlation.py do. The df2 kernels
// gather: each output pixel reads the g and f1 values of the pixels that
// sampled it, so no atomics are needed, the result does not depend on the
// order blocks run in, and no output has to be zeroed first.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 on the CUDA cores): at
// the flow head's hottest call (level 2 of a 512x1024 frame: 128x256 pixels,
// C=32, 81 displacements, bf16, batch 1) the 2-D forward must move 9.50 MB
// (both inputs read once, the output written once), 2.8 us, and do
// 0.17 GFLOP, 2.5 us: it is bound by bytes, by a small margin. The 1-D
// forward at its hottest call (same shape, 25 displacements) moves 5.83 MB,
// 1.7 us, against 0.05 GFLOP, 0.8 us: bound by bytes. A backward kernel does
// as many multiply-adds as its forward and moves g, one feature map and its
// gradient: at level 2 of a batch-2 train step 19.0 MB (5.7 us) against
// 0.33 GFLOP (4.9 us) for the 2-D ones and 11.7 MB (3.5 us) against
// 0.10 GFLOP (1.5 us) for the 1-D ones, all bound by bytes. The operation
// counts take only the products whose sample lies in the frame, since an
// out-of-frame product is zero by definition; at the coarse levels, where
// the window is large against the frame, this makes the 2-D kernels bound
// by operations.
//
// Every bf16 kernel's products run on the tensor cores (989 TFLOP/s
// bf16), where every bf16 call's operations take less time than its
// bytes.
//
// Three designs, chosen by the type and the op alone, never on a failure.
//
// (1) bfloat16 forwards: the tensor cores (corr2d_tc_fwd_kernel,
// corr1d_tc_fwd_kernel). What held the first design (3) back, measured by
// its phase clocks (level_phases.py, -DCORR_PHASES, NVIDIA H100 80GB HBM3 at
// 700 W): staging took 60-85% of its block cycles at every level and
// dilation (one scalar load, an integer division and a convert per element,
// window row after window row), the dot products 13-34% (two shared loads
// per multiply-add), the store under 6%; and one block per 32 pixels of a
// row left levels 6-5 with 8-16 blocks for 132 SMs. Here:
//  - A window row's products for 16 output pixels are one band product
//    S = F1 (16 x C) F2^T (C x ncols) on mma.sync.m16n8k16 (bf16 in,
//    float32 accumulators), ncols = 16 + 2d window columns (2-D) or 16 + D
//    (1-D); the outputs are its band, out(i, ox) = S[i, i + ox] of window
//    row oy (2-D) and out(i, k) = S[i, i + D - k] (1-D). A product of two
//    bf16 values is exact in float32 and the sums run in float32, so only
//    the order of summation differs from the plain version. The band uses
//    9 of 24 columns (2-D) to 25 of 40 (1-D, D = 24) of S; the rest costs
//    little beside a multiply-add that no longer waits on shared memory.
//    Each lane hands ldmatrix one pixel row. A warp holds NT n8 tiles of S
//    (a template argument, so the k loop has no run-time branch) and two
//    register sets: step k + 1's fragments load while step k's products run.
//  - Dilation by residue class: the pixels x = r (mod dil) sample window
//    columns of the same class, so a dilated correlation is dil undilated
//    ones on sub-lattices. A block owns a run of 16 dil pixels of a row (T
//    runs for the 1-D op) and stages it class by class, a class's pixels in
//    adjacent shared rows, so the stride costs nothing. Rows likewise: a 2-D
//    block owns R rows y, y + dil, ... of one class, whose window rows
//    overlap, and stages R + 2d window rows, not R (2d + 1). A block
//    computes every class of its run, or, where their runs would exceed a
//    block's shared memory (at C = 196 the 2-D op above dilation 13, the
//    1-D op at D = 4 above 14), the fewest equal groups of classes that
//    fit, one group a block, and stages only its own.
//  - Staging: one loop issues every copy of the block (cp.async of 16, 8 or
//    4 bytes, as the pointers and the pixel rows' 2C bytes allow; 2-byte
//    loads for odd C), then one wait. Shared rows are 2 C16 + 16 bytes (C16:
//    C rounded up to 16, the tail zero-filled), so the eight rows an
//    ldmatrix phase reads fall in distinct banks; columns outside the frame
//    are zero-filled (source size 0); window rows outside it are not staged
//    and their outputs are written as zero. Run-time divisors are magic
//    multiplies (fast_div).
//  - Work: one warp per (row, window row, class, tile) item. The band goes
//    to shared memory at its (pixel, k) place, and a row's outputs leave as
//    one contiguous run of 16-byte stores where the block owns every window
//    row. The launch plan (tc_plan) sizes R, the window-row groups G and T
//    so that the grid has one and a half to two blocks per SM; its outputs
//    are disjoint, so there are no atomics and no sum across blocks.
//  - sum / C is rounded as float32 division rounds it, without the
//    division's branches: a multiply by 1 / C where C is a power of two,
//    else by the double reciprocal, rounded once to float (exact for
//    C < 2^27: a float32 quotient a / C lies at least 2^-24 ulp / C from a
//    rounding boundary).
// What is left (PERF.md keeps the numbers): a call costs about 5 us of
// launch before any work, and staging is the largest phase that follows.
// wgmma and TMA are not used: the A and B operands are gathers of pixel
// rows that ldmatrix takes lane by lane.
//
// (2) bfloat16 backwards: the tensor cores (corr2d_tc_bwd_f1_kernel,
// corr2d_tc_bwd_f2_kernel, corr1d_tc_bwd_f1_kernel, corr1d_tc_bwd_f2_kernel,
// one device function). What held the CUDA-core backwards of (3) back, by
// their phase clocks (level_phases.py, NVIDIA H100 80GB HBM3 at 700 W): the
// 2-D ones staged for 43-68% of their block cycles (scalar loads, a
// division and a convert per element, each f2 or f1 window row staged
// again per output row), products 31-55% (two shared loads per
// multiply-add, the running sums read and written in shared memory per
// window row), the store 1-2%; the 1-D ones staged for 42-63%, products
// with their stores 36-56%; and one block per 32 pixels of a row, 16
// blocks at level 6. Here:
//  - A window row's share of a 16-pixel tile's gradient is one band
//    product on mma.sync.m16n8k16: df1 (16 x nc) += A F2win, A[i, j] =
//    g(x_i, oy nx + j - i); df2 (16 x nc) += A F1win, A[i, j] =
//    g(x_j, oy nx + 2d - (j - i)), x_j on the source row (a gather: the
//    outputs stay disjoint), for 0 <= j - i <= 2d, 0 elsewhere. k (the
//    16 + 2d window columns) is padded to a multiple of 16 with columns
//    whose A is 0. g is bf16, so A is exact and so is every product in
//    float32: only the order of summation differs from the plain version.
//    Each lane builds its A fragment from the staged g in registers; B,
//    the staged pixel rows (pixels along k, channels along n), comes
//    through ldmatrix.trans.
//    The 1-D op has one window row: a tile's df1 = A F2win, A[i, j] =
//    g(x_i, D - (j - i)), window column j the pixel 16 t + j - D of its
//    class, and df2 = A F1win, A[i, j] = g(x_j, j - i), window column j
//    the pixel 16 t + j (a gather), for 0 <= j - i <= D: one band product,
//    no walk over window rows.
//  - The accumulators stay in registers across all 2d + 1 window rows;
//    sum / C is rounded once as in (1) and stored once as bf16.
//  - Dilation by residue classes of columns and rows, as in (1); a block
//    owns R rows of a class, walks their R + 2d window rows in turn with
//    the next NB - 1 rows' copies in flight and one barrier a row, and a
//    group of 8 NT channels (blocks split C; so, within a block, do 1-4
//    warps per (row, class)), so every level has 1.5 blocks per SM. A
//    block stages the window and g of only the (up to 16) classes it
//    computes, so at d <= 16 every dilation fits a block's shared memory
//    (narrower channel groups, then fewer classes a block, where a wide
//    window would not). A 1-D block owns one row and T (up to
//    kTcMaxTiles) tiles of each of its classes, whose windows overlap: it
//    stages 16 T + D window pixels a class, not T (16 + D), once.
//  - g's pixel rows are 2K = 162 bytes (2-D), 10 to 50 (1-D): a run of
//    pixels is staged as one contiguous run, with shared and device
//    addresses congruent mod 16, by 16-byte cp.async and at most three
//    smaller copies at each end.
// Measured (PERF.md): every 2-D call 2.4-7.1x faster than (3), every 1-D
// call 1.2-2.8x; what is left in the 2-D ones is issuing the copies and
// building A (the products phase, 63-84% of the block cycles), then the
// wait for copies (13-34%); the 1-D ones wait for their one staging for
// 47-74% of their block cycles and store for 11-35%, and at levels 6-4 a
// call is the 5 us launch floor plus about 2 us.
//
// (3) float32, and bfloat16 in a -DCORR_SIMT build: the CUDA cores. TF32
// would break the float32 tolerance (1e-5). One block owns a tile of kTileW
// pixels of one output row and stages in shared memory, as float32, the
// operands the tile needs: the forward stages the f1 tile and the f2 pixels
// of the tile's window (with the horizontal halo), once per block for the 1-D
// kernel and once per window row for the 2-D kernel, so each block reads its
// inputs from device memory about once (the re-reads of an f2 row across
// neighbouring output rows come from L2). Shared rows of features are padded
// to C+1 floats so neighbouring lanes hit different banks. The forward gives
// each thread one (pixel, displacement) dot product with a C-loop of fused
// multiply-adds, collects the tile's outputs in shared memory and writes them
// back as one contiguous run. The backward kernels give each thread (pixel,
// channel) outputs, with the displacement loop inside: lanes of a warp hold
// neighbouring channels, so their feature reads are conflict-free and their g
// read is a broadcast, and their stores are contiguous. The 2-D backward
// kernels stage one window row at a time and keep the running sums in shared
// memory between rows. Rows outside the frame are skipped; columns outside it
// are staged as zeros and multiplied. The 1-D backwards store each output as
// soon as its sum is done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

// Measurement builds (cerberusnet_torch/level_phases.py), off by default.
// -DCORR_PHASES: at every PHASE_MARK(k, phase) of a kernel the block
// synchronises and its thread 0 adds the clock64() cycles since its
// previous reading to corr_phase_cycles[k][phase] (k: 0 corr2d_fwd_kernel,
// 1 corr1d_fwd_kernel, 2 corr2d_tc_fwd_kernel, 3 corr1d_tc_fwd_kernel, 4
// corr2d_bwd_f1_kernel, 5 corr2d_bwd_f2_kernel, 6 corr2d_tc_bwd_f1_kernel,
// 7 corr2d_tc_bwd_f2_kernel, 8 corr1d_bwd_f1_kernel, 9
// corr1d_bwd_f2_kernel, 10 corr1d_tc_bwd_f1_kernel, 11
// corr1d_tc_bwd_f2_kernel; phase: 0 staging (in the tensor-core
// backwards, the wait for a window row's copies that the products of the
// ones before did not hide), 1 products (and band; in the tensor-core
// backwards also issuing the next row's copies; in the CUDA-core 1-D
// backwards also the stores), 2 store). The added barriers perturb the
// kernels a little, so the build gives shares of block cycles, not times.
// In the tensor-core forwards lane 0 of warp 0 also splits each of its
// items (one band product) into corr_item_cycles[k]: 0 the products, up to
// the accumulators' arrival (ITEM_CLOCK waits on its operand), 1 the band,
// 2 the items counted.
// -DCORR_SIMT: bfloat16 runs the CUDA-core kernels, as float32 does, so
// the two designs can be timed in turns on one card.
#ifdef CORR_PHASES
__device__ unsigned long long corr_phase_cycles[12][3];
__device__ unsigned long long corr_item_cycles[4][3];
#define PHASE_BEGIN() long long phase_last_ = clock64()
#define PHASE_MARK(k, phase)                                             \
  do {                                                                   \
    __syncthreads();                                                     \
    if (threadIdx.x == 0) {                                              \
      const long long now_ = clock64();                                  \
      atomicAdd(&corr_phase_cycles[k][phase],                            \
                (unsigned long long)(now_ - phase_last_));               \
      phase_last_ = now_;                                                \
    }                                                                    \
  } while (0)
#define ITEM_CLOCK(t, v) \
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "f"(v))
#else
#define PHASE_BEGIN()
#define PHASE_MARK(k, phase) ((void)(k), (void)(phase))
#endif
#ifdef CORR_SIMT
constexpr bool kTensorCores = false;
#else
constexpr bool kTensorCores = true;
#endif

// Launches by design since the caller last zeroed them: [0] the tensor-core
// kernels, [1] the CUDA-core kernels. Each launcher counts where its launch
// succeeds, so a caller reads which design ran (ops/cuda/correlation.py
// reset_design_launches, launched_design).
extern "C" {
unsigned long long corr_design_launches[2];
}

namespace {

constexpr int kTileW = 32;                 // output pixels per block
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB a block may opt into

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// Copies n pixels of one image row, starting at column x_start, into shared
// memory as float32 rows of stride C+1. Columns outside [0, W) read as zero.
template <typename T>
__device__ void stage_row(float* dst, const T* __restrict__ row, int x_start,
                          int n, int W, int C) {
  const int stride = C + 1;
  for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
    const int q = i / C;
    const int c = i - q * C;
    const int x = x_start + q;
    float v = 0.f;
    if (x >= 0 && x < W) v = to_f32(row[(int64_t)x * C + c]);
    dst[q * stride + c] = v;
  }
}

// Copies the first n_valid of n contiguous values into shared memory as
// float32; the rest read as zero.
template <typename T>
__device__ void stage_run(float* dst, const T* __restrict__ src, int n_valid,
                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = i < n_valid ? to_f32(src[i]) : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int C) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// Writes the block's (npix, K) float32 output tile as one contiguous run.
template <typename T>
__device__ void store_tile(T* __restrict__ dst, const float* outs, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = from_f32<T>(outs[i]);
}

// ---------------------------------------------------------------- forward

// grid: (B*H, ceil(W / kTileW)); shared: f1 tile, one f2 window row, outputs.
template <typename T>
__global__ void corr2d_fwd_kernel(const T* __restrict__ f1,
                                  const T* __restrict__ f2, T* __restrict__ out,
                                  int H, int W, int C, int d, int dil) {
  extern __shared__ float smem[];
  const int nx = 2 * d + 1;
  const int K = nx * nx;
  const int R = d * dil;
  const int stride = C + 1;
  const int row = blockIdx.x;  // b * H + y
  const int y = row % H;
  const int x0 = blockIdx.y * kTileW;
  const int npix = min(kTileW, W - x0);
  float* f1s = smem;
  float* f2s = f1s + kTileW * stride;
  float* outs = f2s + (kTileW + 2 * R) * stride;
  const int64_t row_elems = (int64_t)W * C;

  PHASE_BEGIN();
  stage_row(f1s, f1 + row * row_elems, x0, kTileW, W, C);
  for (int oy = 0; oy < nx; ++oy) {
    const int yy = y + (oy - d) * dil;
    const bool in_frame = yy >= 0 && yy < H;
    __syncthreads();  // f1s staged; f2s no longer read by the last row
    if (in_frame) {
      stage_row(f2s, f2 + (row + (yy - y)) * row_elems, x0 - R, kTileW + 2 * R,
                W, C);
    }
    __syncthreads();
    PHASE_MARK(0, 0);
    for (int i = threadIdx.x; i < kTileW * nx; i += blockDim.x) {
      const int p = i % kTileW;
      const int ox = i / kTileW;
      if (p >= npix) continue;
      // f2 pixel x0 + p + (ox - d) * dil sits at window column p + ox * dil
      const float acc =
          in_frame ? dot(f1s + p * stride, f2s + (p + ox * dil) * stride, C)
                   : 0.f;
      outs[p * K + oy * nx + ox] = acc / (float)C;
    }
    PHASE_MARK(0, 1);
  }
  __syncthreads();
  store_tile(out + ((int64_t)row * W + x0) * K, outs, npix * K);
  PHASE_MARK(0, 2);
}

// grid: (B*H, ceil(W / kTileW)); shared: f1 tile, f2 row with left halo, outputs.
template <typename T>
__global__ void corr1d_fwd_kernel(const T* __restrict__ f1,
                                  const T* __restrict__ f2, T* __restrict__ out,
                                  int H, int W, int C, int D, int dil) {
  extern __shared__ float smem[];
  const int K = D + 1;
  const int R = D * dil;
  const int stride = C + 1;
  const int row = blockIdx.x;
  const int x0 = blockIdx.y * kTileW;
  const int npix = min(kTileW, W - x0);
  float* f1s = smem;
  float* f2s = f1s + kTileW * stride;
  float* outs = f2s + (kTileW + R) * stride;
  const int64_t row_off = (int64_t)row * W * C;

  PHASE_BEGIN();
  stage_row(f1s, f1 + row_off, x0, kTileW, W, C);
  stage_row(f2s, f2 + row_off, x0 - R, kTileW + R, W, C);
  __syncthreads();
  PHASE_MARK(1, 0);
  for (int i = threadIdx.x; i < kTileW * K; i += blockDim.x) {
    const int p = i % kTileW;
    const int k = i / kTileW;
    if (p >= npix) continue;
    // f2 pixel x0 + p - k * dil sits at window column p + R - k * dil
    const float acc = dot(f1s + p * stride, f2s + (p + R - k * dil) * stride, C);
    outs[p * K + k] = acc / (float)C;
  }
  PHASE_MARK(1, 1);
  __syncthreads();
  store_tile(out + ((int64_t)row * W + x0) * K, outs, npix * K);
  PHASE_MARK(1, 2);
}

// ------------------------------------------------- forward, tensor cores
//
// bfloat16 only. A window row's products for one 16-pixel tile of one
// residue class are one band product S = F1 (16 x C) F2^T (C x ncols) on
// mma.sync.m16n8k16, whose band S[i, i + j] is the output (see the note at
// the top of the file).

using bf16 = __nv_bfloat16;

constexpr int kTcTile = 16;      // pixels of one residue class in an mma tile
constexpr int kTcNtGroup = 6;    // n8 tiles of S a warp accumulates at once
constexpr int kTcMinWarps = 8;   // warps a block stages with, fewer blocks
                                 // than SMs (half that otherwise)
constexpr int kTcMaxWarps = 16;
constexpr int kTcMaxTiles = 4;   // 16-pixel tiles of a class a 1-D block owns
constexpr size_t kTcSmemBudget = 100 * 1024;  // two blocks share an SM

// n / d for 0 <= n and n * d < 2^32, from magic = ceil(2^32 / d): one wide
// multiply where a division by a run-time d would take a dependent chain
// of some twenty instructions (the staging and item loops divide per trip).
__host__ __device__ constexpr uint64_t magic(int d) {
  return ((1ull << 32) + d - 1) / d;
}
__device__ __forceinline__ int fast_div(int n, uint64_t magic) {
  return (int)(((uint64_t)(uint32_t)n * magic) >> 32);
}

// What a tensor-core block needs to know of its call.
struct TcGeom {
  int H, W, C, disp, dil;
  int K;          // outputs per pixel
  int nx;         // 2-D: window row width 2d + 1; 1-D: 1
  int ncols;      // window columns of one tile: 16 + 2d (2-D), 16 + D (1-D)
  int T;          // 16-pixel tiles of each residue class a block owns
  int G;          // window rows a block owns (2-D; 1 for 1-D)
  int R;          // output rows a block owns (2-D; 1 for 1-D)
  int nRb;        // blocks down one image's rows of a residue class
  int ncls;       // residue classes of columns a block computes
  int nclsg;      // blocks across the classes: dil / ncls rounded up
  int row_bytes;  // shared stride of a pixel row: 2 C16 + 16 bytes, C16
                  // the channels rounded up to 16
  int kchunks;    // k16 steps: C rounded up to 16, over 16
  int copy_bytes; // staging copy width: 16, 8 or 4 (cp.async), 2 (loads)
  int per_row;    // copies of one pixel row: 32 kchunks / copy_bytes
  int c_pow2;     // C is a power of two
  double inv_c;   // 1 / C
  // magic(d) of the divisors: dil, T, T * ncls, ncls, nclsg, nx, per_row,
  // nRb, the f1 pixels of a row's run a block stages (P) and its f2 pixels
  // of a window row (slab)
  uint64_t m_dil, m_T, m_Tncls, m_ncls, m_nclsg, m_nx, m_per_row, m_nRb,
      m_P, m_slab;
};

// One copy of g.copy_bytes (16, 8 or 4 bytes by cp.async; 2 by a load and a
// store) from `from` to `to`; zeros where !in.
__device__ __forceinline__ void tc_copy(unsigned char* to, const char* from,
                                        bool in, int w) {
  switch (w) {
    case 16: ptx::cp_async16(to, from, in ? 16 : 0); break;
    case 8: ptx::cp_async8(to, from, in ? 8 : 0); break;
    case 4: ptx::cp_async4(to, from, in ? 4 : 0); break;
    default:  // odd C: 2-byte rows, which no cp.async takes
      *reinterpret_cast<uint16_t*>(to) =
          in ? *reinterpret_cast<const uint16_t*>(from) : uint16_t(0);
  }
}

// grid: (blocks of R rows of one residue class of rows, runs of T*16*dil
// pixels, groups of G window rows x groups of ncls residue classes of
// columns); shared: the R f1 runs, the f2 runs (with halos) of the window
// rows they share, the outputs, each of the block's classes only. NT: the
// n8 tiles of S a warp accumulates at once, min(window columns / 8 rounded
// up, kTcNtGroup).
template <bool k2d, int NT>
__device__ __forceinline__ void tc_fwd(const bf16* __restrict__ f1,
                                       const bf16* __restrict__ f2,
                                       bf16* __restrict__ out,
                                       const TcGeom& g) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int kPhase = k2d ? 2 : 3;
  const int dil = g.dil;
  const int ncls = g.ncls;
  const int vdil = k2d ? dil : 1;                  // the rows' residue classes
  const int per_class = g.T * kTcTile;             // f1 pixels of a class
  const int nwin = per_class + g.ncols - kTcTile;  // f2 pixels of a class
  const int P = per_class * ncls;    // f1 pixels of a row's run staged
  const int slab = ncls * nwin;      // f2 pixels of a window row staged
  // blockIdx.x = (b * vdil + cy) * nRb + jr: the output rows
  // y_r = cy + vdil (R jr + r), r < R, of image b
  const int bc = fast_div(blockIdx.x, g.m_nRb);
  const int jr = blockIdx.x - bc * g.nRb;
  const int b = k2d ? fast_div(bc, g.m_dil) : bc;
  const int cy = bc - b * vdil;
  const int m0 = g.R * jr;  // the block's first row, in its class's rows
  const int x0 = blockIdx.y * per_class * dil;
  const int npix = min(per_class * dil, g.W - x0);
  // blockIdx.z = window-row group * nclsg + class group: the classes
  // cls0 .. cls0 + ncls - 1 (those below dil) of window rows oy0 on
  const int grp = fast_div(blockIdx.z, g.m_nclsg);
  const int cls0 = (blockIdx.z - grp * g.nclsg) * ncls;
  const int oy0 = grp * g.G;
  const int nrows = k2d ? min(g.G, g.nx - oy0) : 1;  // window rows per row
  const int nslab = g.R + nrows - 1;                 // f2 rows staged
  const int kout = k2d ? nrows * g.nx : g.K;  // outputs per pixel here
  const int S = g.row_bytes;
  unsigned char* f1s = tc_smem;
  unsigned char* f2s = f1s + (size_t)g.R * P * S;
  bf16* outs = reinterpret_cast<bf16*>(f2s + (size_t)nslab * slab * S);
  const char* img1 =
      reinterpret_cast<const char*>(f1 + (int64_t)b * g.H * g.W * g.C);
  const char* img2 =
      reinterpret_cast<const char*>(f2 + (int64_t)b * g.H * g.W * g.C);

  PHASE_BEGIN();
  // Staging: one loop issues every copy (the R f1 runs, then the f2 runs,
  // from x0 - disp * dil, of the nslab window rows the R rows share), then
  // one wait. Pixel q = m ncls + u of a staged run, column m of class
  // cls0 + u, goes to shared row u (pixels of a class) + m, so that a
  // residue class's pixels are adjacent rows (where the block computes
  // every class, q is the run's pixel q); columns outside the frame and the
  // channel tail are zero-filled (source size 0); rows outside the frame
  // are not staged.
  {
    const int w = g.copy_bytes;
    const int valid = g.C * 2 / w;  // the copies that hold channels
    const int n1 = g.R * P * g.per_row;
    const int n = n1 + nslab * slab * g.per_row;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const bool first = i < n1;
      const int q = fast_div(first ? i : i - n1, g.m_per_row);
      const int c = (first ? i : i - n1) - q * g.per_row;
      const int s = fast_div(q, first ? g.m_P : g.m_slab);  // run
      const int qq = q - s * (first ? P : slab);             // its pixel
      const int yy =
          cy + vdil * (m0 + s + (first ? 0 : oy0 - (k2d ? g.disp : 0)));
      if (yy < 0 || yy >= g.H) continue;  // its products are skipped
      const int m = fast_div(qq, g.m_ncls);
      const int u = qq - m * ncls;
      const int x = (first ? x0 : x0 - g.disp * dil) + cls0 + u + dil * m;
      const bool in = c < valid && x >= 0 && x < g.W;
      const char* base = first ? img1 : img2;
      const char* from =
          in ? base + ((int64_t)yy * g.W + x) * g.C * 2 + c * w : base;
      unsigned char* to =
          (first ? f1s + (size_t)s * P * S : f2s + (size_t)s * slab * S) +
          ((size_t)u * (first ? per_class : nwin) + m) * S + c * w;
      tc_copy(to, from, in, w);
    }
  }
  ptx::cp_async_wait_all();
  __syncthreads();
  PHASE_MARK(kPhase, 0);

  // one warp per (row r, window row wr, residue class, tile t) item
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nt_all = (g.ncols + 7) / 8;
  const int per_row_items = nrows * ncls * g.T;
  for (int item = warp; item < g.R * per_row_items;
       item += blockDim.x >> 5) {
    const int u = fast_div(item, g.m_Tncls);  // r * nrows + wr
    const int tc = item - u * g.T * ncls;     // (cls - cls0) * T + t
    const int cl = fast_div(tc, g.m_T);
    const int t = tc - cl * g.T;
    const int r = u / nrows;
    const int wr = u - r * nrows;
    const int yr = cy + vdil * (m0 + r);
    // past the frame or the last class: nothing is stored
    if (yr >= g.H || cls0 + cl >= dil) continue;
    // pixel i of the tile: staged pixel (t 16 + i) ncls + cl of row r's
    // run, which is its outputs' place
    const int p0 = t * kTcTile * ncls + cl;
    bf16* outs_r = outs + (size_t)r * P * kout;
    if (k2d) {
      const int yy = cy + vdil * (m0 + r + oy0 + wr - g.disp);
      if (yy < 0 || yy >= g.H) {
        for (int e = lane; e < kTcTile * g.nx; e += 32) {
          const int i = fast_div(e, g.m_nx);
          outs_r[(p0 + ncls * i) * kout + wr * g.nx + e - i * g.nx] =
              __float2bfloat16(0.f);
        }
        continue;
      }
    }
    // ldmatrix rows: A, pixel (lane & 7) + 8 ((lane >> 3) & 1) of the
    // tile, channels 8 (lane >> 4) on; B, window column (lane & 7) (+ 8
    // (lane >> 4) for the second n8 tile of an x4), channels
    // 8 ((lane >> 3) & 1) on. Row r's window row wr is staged row r + wr.
    const unsigned char* a_row =
        f1s + ((size_t)r * P + (size_t)cl * per_class + t * kTcTile +
               (lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 16;
    const unsigned char* b_class =
        f2s + ((size_t)(r + wr) * slab + (size_t)cl * nwin +
               t * kTcTile) * S + ((lane >> 3) & 1) * 16;
    // NT n8 tiles of S at a time; a group past the window reads its last
    // column again, which no band takes (2-D: ox = n - i > 2d; 1-D:
    // k = i + D - n < 0)
    for (int n0 = 0; n0 < nt_all; n0 += NT) {
      float acc[NT][4] = {};
#ifdef CORR_PHASES
      long long item_t0, item_t1, item_t2;
      ITEM_CLOCK(item_t0, 0.f);
#endif
      const unsigned char* b_row[(NT + 1) / 2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int col = (n0 + j) * 8 + (lane & 7) + (j + 1 < NT ? (lane >> 4) * 8 : 0);
        b_row[j / 2] = b_class + (size_t)min(col, g.ncols - 1) * S;
      }
      // the fragments of one k16 step: A, and two B registers per n8 tile
      auto load = [&](uint32_t(&fa)[4], uint32_t(&fb)[NT][2], int kc) {
        ptx::ldmatrix_x4(fa, a_row + kc * 32);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          if (j + 1 < NT) {
            uint32_t b[4];
            ptx::ldmatrix_x4(b, b_row[j / 2] + kc * 32);
            fb[j][0] = b[0], fb[j][1] = b[1];
            fb[j + 1][0] = b[2], fb[j + 1][1] = b[3];
          } else {
            ptx::ldmatrix_x2(fb[j], b_row[j / 2] + kc * 32);
          }
        }
      };
      auto mma = [&](const uint32_t(&fa)[4], const uint32_t(&fb)[NT][2]) {
#pragma unroll
        for (int j = 0; j < NT; ++j) ptx::mma_bf16(acc[j], fa, fb[j][0], fb[j][1]);
      };
      // two register sets: step kc + 1's fragments load while step kc's
      // products run
      uint32_t fa0[4], fb0[NT][2], fa1[4], fb1[NT][2];
      load(fa0, fb0, 0);
      for (int kc = 0; kc < g.kchunks; kc += 2) {
        if (kc + 1 < g.kchunks) load(fa1, fb1, kc + 1);
        mma(fa0, fb0);
        if (kc + 1 < g.kchunks) {
          if (kc + 2 < g.kchunks) load(fa0, fb0, kc + 2);
          mma(fa1, fb1);
        }
      }
#ifdef CORR_PHASES
      {  // a value that waits for every accumulator
        float all = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          for (int e = 0; e < 4; ++e) all += acc[j][e];
        ITEM_CLOCK(item_t1, __shfl_sync(0xffffffffu, all, 0));
      }
#endif
      // the band: accumulator e of n8 tile j holds S[i, n] with
      // i = lane / 4 + 8 (e / 2), n = 8 (n0 + j) + 2 (lane % 4) + e % 2;
      // out = sum / C rounded as float32 division rounds it (scale)
      auto band = [&](auto scale) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = (lane >> 2) + (e >> 1) * 8;
            const int n = (n0 + j) * 8 + (lane & 3) * 2 + (e & 1);
            // 2-D: window column n is displacement ox = n - i of row wr;
            // 1-D: column n is displacement k = i + D - n
            const int o = k2d ? n - i : i + g.disp - n;
            if (o >= 0 && o < (k2d ? g.nx : g.K)) {
              outs_r[(p0 + ncls * i) * kout + (k2d ? wr * g.nx : 0) + o] =
                  __float2bfloat16(scale(acc[j][e]));
            }
          }
        }
      };
      if (g.c_pow2) {  // 1 / C is exact
        const float inv = (float)g.inv_c;
        band([inv](float a) { return a * inv; });
      } else {
        // the product with the double reciprocal, rounded once to float,
        // is the float32 quotient for any C < 2^27: a quotient a / C lies
        // at least 2^-24 ulp / C from a float32 rounding boundary
        const double inv = g.inv_c;
        band([inv](float a) { return (float)((double)a * inv); });
      }
#ifdef CORR_PHASES
      ITEM_CLOCK(item_t2, 0.f);
      if (threadIdx.x == 0) {
        atomicAdd(&corr_item_cycles[kPhase][0],
                  (unsigned long long)(item_t1 - item_t0));
        atomicAdd(&corr_item_cycles[kPhase][1],
                  (unsigned long long)(item_t2 - item_t1));
        atomicAdd(&corr_item_cycles[kPhase][2], 1ull);
      }
#endif
    }
  }
  __syncthreads();
  PHASE_MARK(kPhase, 1);

  // each row's outputs: one contiguous run when the block owns every
  // window row and residue class, else each pixel's kout outputs
  for (int r = 0; r < g.R; ++r) {
    const int yr = cy + vdil * (m0 + r);
    if (yr >= g.H) break;
    const bf16* from = outs + (size_t)r * P * kout;
    bf16* dst = out + (((int64_t)b * g.H + yr) * g.W + x0) * g.K +
                (k2d ? oy0 * g.nx : 0);
    if (kout == g.K && ncls == dil) {
      const int n = npix * g.K;
      int head = 0;
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        head = n / 8 * 8;
        const uint4* from4 = reinterpret_cast<const uint4*>(from);
        uint4* to4 = reinterpret_cast<uint4*>(dst);
        for (int i = threadIdx.x; i < head / 8; i += blockDim.x) {
          to4[i] = from4[i];
        }
      }
      for (int i = head + threadIdx.x; i < n; i += blockDim.x) {
        dst[i] = from[i];
      }
    } else {
      for (int i = threadIdx.x; i < P * kout; i += blockDim.x) {
        const int q = i / kout;  // staged pixel m ncls + u
        const int m = fast_div(q, g.m_ncls);
        const int u = q - m * ncls;
        const int x = cls0 + u + dil * m;  // its column from x0
        if (cls0 + u < dil && x < npix) {
          dst[(int64_t)x * g.K + i - q * kout] = from[i];
        }
      }
    }
  }
  PHASE_MARK(kPhase, 2);
}

template <int NT>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    corr2d_tc_fwd_kernel(const bf16* __restrict__ f1,
                         const bf16* __restrict__ f2, bf16* __restrict__ out,
                         const TcGeom g) {
  tc_fwd<true, NT>(f1, f2, out, g);
}

template <int NT>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    corr1d_tc_fwd_kernel(const bf16* __restrict__ f1,
                         const bf16* __restrict__ f2, bf16* __restrict__ out,
                         const TcGeom g) {
  tc_fwd<false, NT>(f1, f2, out, g);
}

// ------------------------------------------------ backward, tensor cores
//
// bfloat16 only, either op at any dilation. A window row's share of the
// gradient of one 16-pixel tile of one residue class is one band product
// on mma.sync.m16n8k16 (see the note at the top of the file):
//   2-D df1 (16 x nc) += A (16 x ncols) F2win (ncols x nc),
//     A[i, j] = g(x_i, oy nx + j - i)
//   2-D df2 (16 x nc) += A (16 x ncols) F1win (ncols x nc),
//     A[i, j] = g(x_j, oy nx + 2d - (j - i)), x_j on the source row
// for 0 <= j - i <= 2d (A is 0 elsewhere), window column j of the tile
// the pixel 16 t + j - d of its class; the 1-D op has one window row:
//   1-D df1 (16 x nc) = A F2win, A[i, j] = g(x_i, D - (j - i)),
//     window column j the pixel 16 t + j - D of its class
//   1-D df2 (16 x nc) = A F1win, A[i, j] = g(x_j, j - i),
//     window column j the pixel 16 t + j of its class (a gather)
// for 0 <= j - i <= D. k (the window columns) is padded to a multiple of
// 16 with columns whose A is 0, and n is the block's channel group.

constexpr int kTcBwdNtMax = 8;    // n8 tiles of a block's channel group
constexpr int kTcBwdMaxRows = 8;  // output rows a block owns (2-D)
constexpr int kTcBwdBuffers = 4;  // staged window rows a block holds, at
                                  // most (fewer where they would exceed
                                  // kTcSmemBudget; 2 at the least; the
                                  // 1-D op stages its one window row once)

// What a tensor-core backward block needs to know of its call.
struct TcBwdGeom {
  int H, W, C, disp, dil;
  int K;          // (2d + 1)^2 (2-D), D + 1 (1-D)
  int nx;         // 2d + 1 (2-D), 1 (1-D)
  int span;       // the band's last offset j - i: 2d (2-D), D (1-D)
  int ncols;      // window columns of a tile: 16 + span
  int kchunks;    // k16 steps over them
  int R;          // output rows a block owns (2-D: one residue class of
                  // rows; 1-D: 1)
  int T;          // 16-pixel tiles of each class a block owns (2-D: 1)
  int nRb;        // blocks down one image's rows of a residue class
  int ncls;       // residue classes of columns a block computes
  int nclsg;      // blocks across the classes: dil / ncls rounded up
  int P;          // pixels of a row's run: 16 T dil
  int nwin;       // window columns of a class: 16 (T - 1) + ncols
  int slab;       // window pixels of a row a block stages: ncls nwin
  int gcol;       // bf16 from one window column of a class to the next in
                  // a staged g run: S / 2, S = ncls 2K rounded up to the
                  // next bytes congruent to dil 2K mod 16 (dil K if
                  // ncls = dil: one contiguous run)
  int nc;         // channels of a block's group: 8 NT wc
  int wc;         // warps that split a group's channels, NT each
  int row_bytes;  // shared stride of a pixel's group: 2 nc + 16
  int copy_bytes; // staging copy width: 16, 8 or 4 (cp.async), 2 (loads)
  int per_row;    // copies of a pixel's group: 2 nc / copy_bytes
  int feat_bytes; // one staged window row of features: slab row_bytes
  int g_bytes;    // one staged run of g: its pixels' 2K bytes, + 16
  int c_pow2;     // C is a power of two
  double inv_c;   // 1 / C
  uint64_t m_dil, m_nRb, m_per_row, m_nclsg, m_ncls;
};

// Where pixel x_start of a staged run of g lies in its buffer `buf`: the
// buffer plus the run's misalignment in device memory, so that shared and
// device addresses agree mod 16 (`row`: the image row's first pixel, kb
// its pixels' bytes).
__device__ __forceinline__ unsigned char* tc_g_base(unsigned char* buf,
                                                   const char* row,
                                                   int x_start, int kb) {
  return buf +
         ((reinterpret_cast<uintptr_t>(row) + (intptr_t)x_start * kb) & 15);
}

// Stages g of pixels x_start .. x_start + n - 1 of one image row at `base`
// (tc_g_base), 2K = kb bytes a pixel, as one contiguous run: the middle by
// 16-byte cp.async, each end by at most three copies of 8, 4 and 2 bytes
// (cp.async where aligned; a 2-byte end, at an odd pixel, by a load and a
// store). Pixels outside the frame are zero.
__device__ __forceinline__ void tc_stage_g(unsigned char* base,
                                           const char* row, int x_start,
                                           int n, int W, int kb) {
  // pixels [lo, hi) of the run lie in the frame
  const int lo = min(max(-x_start, 0), n);
  const int hi = max(min(W - x_start, n), lo);
  uint16_t* base16 = reinterpret_cast<uint16_t*>(base);
  const int half = kb / 2;
  for (int i = threadIdx.x; i < lo * half; i += blockDim.x) base16[i] = 0;
  for (int i = threadIdx.x; i < (n - hi) * half; i += blockDim.x) {
    base16[hi * half + i] = 0;
  }
  if (hi == lo) return;
  const char* src = row + (int64_t)(x_start + lo) * kb;
  unsigned char* to = base + lo * kb;
  const int nbytes = (hi - lo) * kb;
  const int head =
      min(nbytes, (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
  const int body = (nbytes - head) / 16 * 16;
  for (int i = threadIdx.x; i < body / 16; i += blockDim.x) {
    ptx::cp_async16(to + head + 16 * i, src + head + 16 * i, 16);
  }
  if (threadIdx.x < 2) {  // thread 0 the head, thread 1 the tail
    int at = threadIdx.x == 0 ? 0 : head + body;
    const int end = threadIdx.x == 0 ? head : nbytes;
    while (at < end) {
      const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(src + at);
      if ((a & 7) == 0 && end - at >= 8) {
        ptx::cp_async8(to + at, src + at, 8);
        at += 8;
      } else if ((a & 3) == 0 && end - at >= 4) {
        ptx::cp_async4(to + at, src + at, 4);
        at += 4;
      } else {
        *reinterpret_cast<uint16_t*>(to + at) =
            *reinterpret_cast<const uint16_t*>(src + at);
        at += 2;
      }
    }
  }
}

// Stages g of the classes cls0 .. cls0 + ncls - 1 of n window columns of
// one image row, column m of class cls0 + u being pixel x_start + u + dil m,
// at `base` (tc_g_base of x_start): one contiguous run where the block
// computes every class, else a run of ncls pixels per column, S = 2 gcol
// bytes apart, so shared and device addresses still agree mod 16.
__device__ __forceinline__ void tc_stage_g_classes(unsigned char* base,
                                                   const char* row,
                                                   int x_start, int n,
                                                   const TcBwdGeom& G) {
  const int kb = 2 * G.K;
  if (G.ncls == G.dil) {
    tc_stage_g(base, row, x_start, n * G.dil, G.W, kb);
  } else {
    for (int m = 0; m < n; ++m) {
      tc_stage_g(base + (size_t)m * 2 * G.gcol, row, x_start + G.dil * m,
                 G.ncls, G.W, kb);
    }
  }
}

// grid: (B vdil nRb: blocks of R rows of one residue class of rows (1-D:
// one row), runs of 16 T dil pixels, channel groups x class groups).
// Shared: NB buffers (1-D: one), each one staged window row's features
// (the run's window pixels of the block's ncls classes, class by class, the
// group's channels) and, for df2, its g of those pixels; for df1 the g of
// the R output rows' tile pixels of those classes. The block walks its
// R + 2d window rows (1-D: its one row) in turn with the next NB - 1 in
// flight, one barrier a row. Each warp owns one (row or tile, class) item
// and keeps its accumulators in registers across all window rows.
template <bool k2d, bool kF2, int NT, int NB>
__device__ __forceinline__ void tc_bwd(const bf16* __restrict__ gin,
                                       const bf16* __restrict__ f,
                                       bf16* __restrict__ out,
                                       const TcBwdGeom& G) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int kPhase = k2d ? (kF2 ? 7 : 6) : (kF2 ? 11 : 10);
  // the band's values are g at base + o (2-D df1, 1-D df2) or base - o
  constexpr bool kUp = k2d != kF2;
  const int d = k2d ? G.disp : 0;  // window rows above and below a row
  const int dil = G.dil, kb = 2 * G.K;
  const int vdil = k2d ? dil : 1;  // residue classes of rows
  const int bc = fast_div(blockIdx.x, G.m_nRb);
  const int jr = blockIdx.x - bc * G.nRb;
  const int b = k2d ? fast_div(bc, G.m_dil) : bc;
  const int cy = bc - b * vdil;
  const int m0 = G.R * jr;
  const int x0 = blockIdx.y * G.P;
  const int cg = fast_div(blockIdx.z, G.m_nclsg);
  const int cls0 = (blockIdx.z - cg * G.nclsg) * G.ncls;
  const int c_lo = cg * G.nc;
  const int nslab = G.R + 2 * d;
  // the window's first pixel: the window reaches d dil left of a tile
  // (2-D), D dil (1-D df1) or none (1-D df2, whose sources lie right)
  const int xw0 = x0 - (k2d ? G.disp : kF2 ? 0 : G.disp) * dil;
  unsigned char* feat = tc_smem;
  unsigned char* gbuf = feat + (size_t)(k2d ? NB : 1) * G.feat_bytes;
  const char* fimg =
      reinterpret_cast<const char*>(f + (int64_t)b * G.H * G.W * G.C);
  const char* gimg =
      reinterpret_cast<const char*>(gin + (int64_t)b * G.H * G.W * G.K);

  // staged window row s is image row cy + vdil (m0 + s - d), in buffer
  // s % NB
  auto stage = [&](int s) {
    const int yy = cy + vdil * (m0 + s - d);
    if (yy < 0 || yy >= G.H) return;  // its products are skipped
    const int w = G.copy_bytes;
    const int valid_ch = G.C - c_lo;
    const int slot = s % NB;
    unsigned char* buf = feat + (size_t)slot * G.feat_bytes;
    const char* img_row = fimg + (int64_t)yy * G.W * G.C * 2;
    // pixel q: window column m of class cls0 + u (past the last class,
    // a pixel no warp reads)
    for (int i = threadIdx.x; i < G.slab * G.per_row; i += blockDim.x) {
      const int q = fast_div(i, G.m_per_row);
      const int c = i - q * G.per_row;
      const int m = fast_div(q, G.m_ncls);
      const int u = q - m * G.ncls;
      const int x = xw0 + cls0 + u + dil * m;
      const bool in = c * w / 2 < valid_ch && x >= 0 && x < G.W;
      const char* from =
          in ? img_row + ((int64_t)x * G.C + c_lo) * 2 + c * w : img_row;
      tc_copy(buf + ((size_t)u * G.nwin + m) * G.row_bytes + c * w, from,
              in, w);
    }
    if (kF2) {
      const char* g_row = gimg + (int64_t)yy * G.W * kb;
      tc_stage_g_classes(
          tc_g_base(gbuf + (size_t)slot * G.g_bytes, g_row, xw0 + cls0, kb),
          g_row, xw0 + cls0, G.nwin, G);
    }
  };

  PHASE_BEGIN();
  if (!kF2) {
    for (int r = 0; r < G.R; ++r) {
      const int y = cy + vdil * (m0 + r);
      if (y < G.H) {
        const char* g_row = gimg + (int64_t)y * G.W * kb;
        tc_stage_g_classes(
            tc_g_base(gbuf + (size_t)r * G.g_bytes, g_row, x0 + cls0, kb),
            g_row, x0 + cls0, kTcTile * G.T, G);
      }
    }
  }
  for (int s = 0; s < NB - 1; ++s) {  // a copy group per window row
    if (s < nslab) stage(s);
    ptx::cp_async_commit();
  }

  // warp w owns item u = w / wc = rt ncls + class (of the block's
  // classes), rt its row r (2-D) or tile t (1-D), and its share
  // sub = w % wc of the channel group: 8 NT channels
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = warp / G.wc;
  const int sub = warp - u * G.wc;
  const int rt = u / G.ncls;
  const int r = k2d ? rt : 0;
  const int t = k2d ? 0 : rt;
  const int cls = cls0 + u - rt * G.ncls;
  const int c_w = c_lo + 8 * NT * sub;  // the warp's first channel
  const int yr = cy + vdil * (m0 + r);
  // the tile's first pixel, from x0
  const int xt = cls + dil * kTcTile * t;
  const bool active = rt < (k2d ? G.R : G.T) && cls < dil && yr < G.H &&
                      x0 + xt < G.W;
  const int i0 = lane >> 2, q2 = 2 * (lane & 3);
  // ldmatrix.trans rows: window column (lane & 7) + 8 ((lane >> 3) & 1) of
  // the k16 step, channels 8 (lane >> 4) on of an n8 pair
  const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int kcol = (lane >> 4) * 16 + 16 * NT * sub;
  float acc[NT][4] = {};

  for (int s = 0; s < nslab; ++s) {
    ptx::cp_async_wait<NB - 2>();  // window row s has landed
    __syncthreads();  // and every warp is done with window row s - 1
    PHASE_MARK(kPhase, 0);
    // row s + NB - 1 goes to row s - 1's buffer, in flight behind row s's
    // products
    if (s + NB - 1 < nslab) stage(s + NB - 1);
    ptx::cp_async_commit();
    const int yy = cy + vdil * (m0 + s - d);
    const int oy = kF2 ? r + 2 * d - s : s - r;  // 1-D: 0
    if (active && yy >= 0 && yy < G.H && oy >= 0 && oy <= 2 * d) {
      const int slot = s % NB;
      // the tile's window: columns 16 t on of its class's
      const unsigned char* fb =
          feat + (size_t)slot * G.feat_bytes +
          ((size_t)(cls - cls0) * G.nwin + kTcTile * t) * G.row_bytes + kcol;
      // A's values: df1, g of the tile's pixel i (the output row's run);
      // df2, g of the window pixel j (the source row's slab). A[i, j] =
      // gb[gcol i + o] (2-D df1), gb[gcol j - o] (2-D df2), gb[gcol i - o]
      // (1-D df1), gb[gcol j + o] (1-D df2), o = j - i
      const uint16_t* gb =
          (kF2 ? reinterpret_cast<const uint16_t*>(tc_g_base(
                     gbuf + (size_t)slot * G.g_bytes,
                     gimg + (int64_t)yy * G.W * kb, xw0 + cls0, kb)) +
                     (k2d ? oy * G.nx + 2 * d : 0)
               : reinterpret_cast<const uint16_t*>(tc_g_base(
                     gbuf + (size_t)r * G.g_bytes,
                     gimg + (int64_t)yr * G.W * kb, x0 + cls0, kb)) +
                     (k2d ? oy * G.nx : G.disp)) +
          (size_t)G.gcol * kTcTile * t + (size_t)(cls - cls0) * G.K;
      const uint16_t* ga = kF2 ? gb : gb + (size_t)G.gcol * i0;
      for (int kc = 0; kc < G.kchunks; ++kc) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // columns q2 + 8 h, q2 + 8 h + 1
#pragma unroll
          for (int v = 0; v < 2; ++v) {  // rows i0 + 8 v
            uint32_t pair = 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = kc * 16 + q2 + 8 * h + e;
              const int i = i0 + 8 * v;
              const int o = j - i;
              uint32_t val = 0;
              if (o >= 0 && o <= G.span) {
                val = ga[(kF2 ? G.gcol * j : G.gcol * 8 * v) +
                         (kUp ? o : -o)];
              }
              pair |= val << (16 * e);
            }
            a[2 * h + v] = pair;
          }
        }
        const int j = min(kc * 16 + krow, G.ncols - 1);
        const unsigned char* brow = fb + (size_t)j * G.row_bytes;
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t bf[4];
          ptx::ldmatrix_x4_trans(bf, brow + jp * 32);
          ptx::mma_bf16(acc[2 * jp], a, bf[0], bf[1]);
          ptx::mma_bf16(acc[2 * jp + 1], a, bf[2], bf[3]);
        }
      }
    }
    PHASE_MARK(kPhase, 1);
  }

  // accumulator e of n8 tile jn: pixel i0 + 8 (e / 2), channel
  // c_w + 8 jn + q2 + e % 2; out = sum / C rounded as float32 division
  // rounds it (see tc_fwd)
  if (active) {
    auto store = [&](auto scale) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int x = x0 + xt + dil * (i0 + 8 * v);
        if (x >= G.W) continue;
        bf16* px = out + (((int64_t)b * G.H + yr) * G.W + x) * G.C;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int c = c_w + 8 * jn + q2;
          const bf16 lo = __float2bfloat16(scale(acc[jn][2 * v]));
          const bf16 hi = __float2bfloat16(scale(acc[jn][2 * v + 1]));
          if (c + 1 < G.C && (G.C & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(px + c) =
                __halves2bfloat162(lo, hi);
          } else {
            if (c < G.C) px[c] = lo;
            if (c + 1 < G.C) px[c + 1] = hi;
          }
        }
      }
    };
    if (G.c_pow2) {
      const float inv = (float)G.inv_c;
      store([inv](float v) { return v * inv; });
    } else {
      const double inv = G.inv_c;
      store([inv](float v) { return (float)((double)v * inv); });
    }
  }
  PHASE_MARK(kPhase, 2);
}

template <int NT, int NB>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    corr2d_tc_bwd_f1_kernel(const bf16* __restrict__ g,
                            const bf16* __restrict__ f2,
                            bf16* __restrict__ df1, const TcBwdGeom G) {
  tc_bwd<true, false, NT, NB>(g, f2, df1, G);
}

template <int NT, int NB>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    corr2d_tc_bwd_f2_kernel(const bf16* __restrict__ g,
                            const bf16* __restrict__ f1,
                            bf16* __restrict__ df2, const TcBwdGeom G) {
  tc_bwd<true, true, NT, NB>(g, f1, df2, G);
}

// The 1-D op stages its one window row once: NB = 2 makes the walk one
// wait for that row's copies.
template <int NT>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    corr1d_tc_bwd_f1_kernel(const bf16* __restrict__ g,
                            const bf16* __restrict__ f2,
                            bf16* __restrict__ df1, const TcBwdGeom G) {
  tc_bwd<false, false, NT, 2>(g, f2, df1, G);
}

template <int NT>
__global__ void __launch_bounds__(kTcMaxWarps * 32)
    corr1d_tc_bwd_f2_kernel(const bf16* __restrict__ g,
                            const bf16* __restrict__ f1,
                            bf16* __restrict__ df2, const TcBwdGeom G) {
  tc_bwd<false, true, NT, 2>(g, f1, df2, G);
}

// --------------------------------------------------------------- backward
//
// In each backward kernel thread t owns the outputs i = t, t + blockDim, ...
// of the tile's contiguous run of npix * C values, i = p * C + c.

// df1 of the 2-D op. grid: (B*H, ceil(W / kTileW)); shared: the g tile, one
// f2 window row, the running sums.
template <typename T>
__global__ void corr2d_bwd_f1_kernel(const T* __restrict__ g,
                                     const T* __restrict__ f2,
                                     T* __restrict__ df1, int H, int W, int C,
                                     int d, int dil) {
  extern __shared__ float smem[];
  const int nx = 2 * d + 1;
  const int K = nx * nx;
  const int R = d * dil;
  const int stride = C + 1;
  const int row = blockIdx.x;  // b * H + y
  const int y = row % H;
  const int x0 = blockIdx.y * kTileW;
  const int npix = min(kTileW, W - x0);
  float* gs = smem;
  float* f2s = gs + kTileW * K;
  float* sums = f2s + (kTileW + 2 * R) * stride;
  const int64_t row_elems = (int64_t)W * C;
  const int n = npix * C;

  PHASE_BEGIN();
  stage_run(gs, g + ((int64_t)row * W + x0) * K, npix * K, kTileW * K);
  for (int i = threadIdx.x; i < n; i += blockDim.x) sums[i] = 0.f;
  for (int oy = 0; oy < nx; ++oy) {
    const int yy = y + (oy - d) * dil;
    if (yy < 0 || yy >= H) continue;  // the same for the whole block
    __syncthreads();  // gs staged; f2s no longer read by the last row
    stage_row(f2s, f2 + (row + (yy - y)) * row_elems, x0 - R, kTileW + 2 * R,
              W, C);
    __syncthreads();
    PHASE_MARK(4, 0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = i / C;
      const int c = i - p * C;
      const float* gp = gs + p * K + oy * nx;
      // f2 pixel x0 + p + (ox - d) * dil sits at window column p + ox * dil
      const float* fp = f2s + p * stride + c;
      float acc = sums[i];
      for (int ox = 0; ox < nx; ++ox) acc = fmaf(gp[ox], fp[ox * dil * stride], acc);
      sums[i] = acc;
    }
    PHASE_MARK(4, 1);
  }
  T* dst = df1 + ((int64_t)row * W + x0) * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = from_f32<T>(sums[i] / (float)C);
  }
  PHASE_MARK(4, 2);
}

// df2 of the 2-D op, a gather. grid: (B*H, ceil(W / kTileW)); shared: one
// f1 window row, the g values of that row that sampled the tile, the sums.
template <typename T>
__global__ void corr2d_bwd_f2_kernel(const T* __restrict__ g,
                                     const T* __restrict__ f1,
                                     T* __restrict__ df2, int H, int W, int C,
                                     int d, int dil) {
  extern __shared__ float smem[];
  const int nx = 2 * d + 1;
  const int K = nx * nx;
  const int R = d * dil;
  const int stride = C + 1;
  const int nw = kTileW + 2 * R;  // window columns x0 - R .. x0 + kTileW + R - 1
  const int row = blockIdx.x;
  const int y = row % H;
  const int x0 = blockIdx.y * kTileW;
  const int npix = min(kTileW, W - x0);
  float* f1s = smem;
  float* gw = f1s + nw * stride;
  float* sums = gw + nw * nx;
  const int64_t row_elems = (int64_t)W * C;
  const int n = npix * C;

  PHASE_BEGIN();
  for (int i = threadIdx.x; i < n; i += blockDim.x) sums[i] = 0.f;
  for (int oy = 0; oy < nx; ++oy) {
    const int ys = y - (oy - d) * dil;  // the row whose displacement oy lands on y
    if (ys < 0 || ys >= H) continue;  // the same for the whole block
    const int src = row + (ys - y);
    __syncthreads();  // the last row's f1s and gw are no longer read
    stage_row(f1s, f1 + src * row_elems, x0 - R, nw, W, C);
    for (int j = threadIdx.x; j < nw * nx; j += blockDim.x) {
      const int q = j / nx;
      const int ox = j - q * nx;
      const int x = x0 - R + q;
      gw[j] = x >= 0 && x < W
                  ? to_f32(g[((int64_t)src * W + x) * K + oy * nx + ox])
                  : 0.f;
    }
    __syncthreads();
    PHASE_MARK(5, 0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = i / C;
      const int c = i - p * C;
      float acc = sums[i];
      for (int ox = 0; ox < nx; ++ox) {
        // source pixel x0 + p - (ox - d) * dil sits at window column q
        const int q = p + (2 * d - ox) * dil;
        acc = fmaf(gw[q * nx + ox], f1s[q * stride + c], acc);
      }
      sums[i] = acc;
    }
    PHASE_MARK(5, 1);
  }
  T* dst = df2 + ((int64_t)row * W + x0) * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = from_f32<T>(sums[i] / (float)C);
  }
  PHASE_MARK(5, 2);
}

// df1 of the 1-D op. grid: (B*H, ceil(W / kTileW)); shared: the g tile and
// the f2 row with its left halo.
template <typename T>
__global__ void corr1d_bwd_f1_kernel(const T* __restrict__ g,
                                     const T* __restrict__ f2,
                                     T* __restrict__ df1, int H, int W, int C,
                                     int D, int dil) {
  extern __shared__ float smem[];
  const int K = D + 1;
  const int R = D * dil;
  const int stride = C + 1;
  const int row = blockIdx.x;
  const int x0 = blockIdx.y * kTileW;
  const int npix = min(kTileW, W - x0);
  float* gs = smem;
  float* f2s = gs + kTileW * K;
  const int n = npix * C;

  PHASE_BEGIN();
  stage_run(gs, g + ((int64_t)row * W + x0) * K, npix * K, kTileW * K);
  stage_row(f2s, f2 + (int64_t)row * W * C, x0 - R, kTileW + R, W, C);
  __syncthreads();
  PHASE_MARK(8, 0);
  // each output is stored as soon as its sum is done, so phase 1 holds
  // the products and the stores, and phase 2 only a barrier
  T* dst = df1 + ((int64_t)row * W + x0) * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / C;
    const int c = i - p * C;
    float acc = 0.f;
    // f2 pixel x0 + p - k * dil sits at window column p + R - k * dil
    for (int k = 0; k < K; ++k) {
      acc = fmaf(gs[p * K + k], f2s[(p + R - k * dil) * stride + c], acc);
    }
    dst[i] = from_f32<T>(acc / (float)C);
  }
  PHASE_MARK(8, 1);
  PHASE_MARK(8, 2);
}

// df2 of the 1-D op, a gather. grid: (B*H, ceil(W / kTileW)); shared: the
// f1 and g rows from the tile's first pixel to R pixels past its last.
template <typename T>
__global__ void corr1d_bwd_f2_kernel(const T* __restrict__ g,
                                     const T* __restrict__ f1,
                                     T* __restrict__ df2, int H, int W, int C,
                                     int D, int dil) {
  extern __shared__ float smem[];
  const int K = D + 1;
  const int R = D * dil;
  const int stride = C + 1;
  const int nw = kTileW + R;  // window columns x0 .. x0 + kTileW + R - 1
  const int row = blockIdx.x;
  const int x0 = blockIdx.y * kTileW;
  const int npix = min(kTileW, W - x0);
  float* f1s = smem;
  float* gw = f1s + nw * stride;
  const int n = npix * C;

  PHASE_BEGIN();
  stage_row(f1s, f1 + (int64_t)row * W * C, x0, nw, W, C);
  stage_run(gw, g + ((int64_t)row * W + x0) * K, min(nw, W - x0) * K, nw * K);
  __syncthreads();
  PHASE_MARK(9, 0);
  // each output is stored as soon as its sum is done (see df1)
  T* dst = df2 + ((int64_t)row * W + x0) * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / C;
    const int c = i - p * C;
    float acc = 0.f;
    // pixel x0 + p + k * dil sampled this one at displacement k
    for (int k = 0; k < K; ++k) {
      const int q = p + k * dil;
      acc = fmaf(gw[q * K + k], f1s[q * stride + c], acc);
    }
    dst[i] = from_f32<T>(acc / (float)C);
  }
  PHASE_MARK(9, 1);
  PHASE_MARK(9, 2);
}

// ----------------------------------------------------------------- launch

// The shared bytes and thread count of each kernel for one (C, disp, dil).
struct Shape {
  size_t shared_floats;
  int threads;
};

int clamp_threads(int n) { return n < kMaxThreads ? n : kMaxThreads; }

Shape shape_corr2d_fwd(int C, int d, int dil) {
  const int nx = 2 * d + 1;
  return {(size_t)(2 * kTileW + 2 * d * dil) * (C + 1) + (size_t)kTileW * nx * nx,
          clamp_threads(kTileW * nx)};
}

Shape shape_corr1d_fwd(int C, int D, int dil) {
  return {(size_t)(2 * kTileW + D * dil) * (C + 1) + (size_t)kTileW * (D + 1),
          clamp_threads(kTileW * (D + 1))};
}

Shape shape_corr2d_bwd_f1(int C, int d, int dil) {
  const int nx = 2 * d + 1;
  return {(size_t)kTileW * nx * nx + (size_t)(kTileW + 2 * d * dil) * (C + 1) +
              (size_t)kTileW * C,
          clamp_threads(kTileW * C)};
}

Shape shape_corr2d_bwd_f2(int C, int d, int dil) {
  const size_t nw = kTileW + 2 * d * dil;
  return {nw * (C + 1) + nw * (2 * d + 1) + (size_t)kTileW * C,
          clamp_threads(kTileW * C)};
}

Shape shape_corr1d_bwd_f1(int C, int D, int dil) {
  return {(size_t)kTileW * (D + 1) + (size_t)(kTileW + D * dil) * (C + 1),
          clamp_threads(kTileW * C)};
}

Shape shape_corr1d_bwd_f2(int C, int D, int dil) {
  const size_t nw = kTileW + D * dil;
  return {nw * (C + 1) + nw * (D + 1), clamp_threads(kTileW * C)};
}

// Launches kernel<T> over (B*H, ceil(W / kTileW)) blocks on `stream` with
// operands a and b (the two features for a forward, g and one feature for a
// backward) and returns the launch's error.
template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, T*, int, int, int, int,
                                  int),
                   Shape shape, const void* a, const void* b, void* out, int B,
                   int H, int W, int C, int disp, int dil,
                   cudaStream_t stream) {
  const size_t shared = shape.shared_floats * sizeof(float);
  if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, (W + kTileW - 1) / kTileW);
  kernel<<<grid, shape.threads, shared, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      H, W, C, disp, dil);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++corr_design_launches[1];
  return err;
}

bool bad_shape(int B, int H, int W, int C, int disp, int dil) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || disp < 0 || dil < 1;
}

// A tensor-core forward's launch: its geometry, grid, threads and shared
// bytes.
struct TcPlan {
  TcGeom g;
  dim3 grid;
  int threads;
  size_t shared;
};

size_t tc_shared(const TcGeom& g) {
  const int per_class = g.T * kTcTile;
  const int nwin = per_class + g.ncols - kTcTile;
  const size_t pix = (size_t)per_class * g.ncls;  // of a row's run
  const int kout = g.nx == 1 ? g.K : g.G * g.nx;   // outputs per pixel
  return (g.R * pix + (size_t)(g.R + g.G - 1) * g.ncls * nwin) * g.row_bytes +
         ((g.R * pix * kout * sizeof(bf16) + 15) / 16) * 16;
}

// The plan for a 2-D (k2d) or 1-D forward on a card of `sms` SMs. The 2-D
// op takes blocks of R = 4, 2 or 1 output rows of one residue class of rows
// (rows y, y + dil, ...: their window rows overlap, so R rows stage R + 2d
// window rows, not R (2d + 1)) and all window rows, the largest R that
// still gives 1.5 blocks per SM within kTcSmemBudget bytes; failing that,
// one row and its window rows split into as many groups as that takes. The
// 1-D op takes one row and up to kTcMaxTiles tiles per class, fewer while
// the grid has fewer than two blocks per SM. Then a block computes every
// residue class of columns, or, where their runs would exceed a block's
// shared memory (a large dilation at a wide C), the fewest equal groups of
// classes that fit (a block stages only its own). The blocks' outputs are
// disjoint either way. copy_bytes: the staging's copy width.
TcPlan tc_plan(int B, int H, int W, int C, int disp, int dil, bool k2d,
               int copy_bytes, int sms) {
  TcGeom g{};
  g.H = H, g.W = W, g.C = C, g.disp = disp, g.dil = dil;
  g.nx = k2d ? 2 * disp + 1 : 1;
  g.K = k2d ? g.nx * g.nx : disp + 1;
  g.ncols = kTcTile + (k2d ? 2 * disp : disp);
  g.kchunks = (C + 15) / 16;
  g.row_bytes = g.kchunks * 32 + 16;
  g.copy_bytes = copy_bytes;
  g.ncls = dil;
  g.nclsg = 1;
  const int run = kTcTile * dil;
  const int vdil = k2d ? dil : 1;
  const int class_rows = (H + vdil - 1) / vdil;
  auto blocks = [&](const TcGeom& t) {
    const int64_t runs = (W + run * t.T - 1) / (run * t.T);
    const int64_t nrb = (class_rows + t.R - 1) / t.R;
    return (int64_t)B * vdil * nrb * runs * ((t.nx + t.G - 1) / t.G) *
           t.nclsg;
  };
  g.T = 1;
  g.G = g.nx;
  g.R = 1;
  if (k2d) {
    for (int r = 4; r > 1; r /= 2) {
      TcGeom t = g;
      t.R = r;
      if (blocks(t) * 2 >= 3 * (int64_t)sms &&
          tc_shared(t) <= kTcSmemBudget) {
        g.R = r;
        break;
      }
    }
    for (int parts = 2;
         g.R == 1 && g.G > 1 &&
         (blocks(g) * 2 < 3 * (int64_t)sms || tc_shared(g) > kTcSmemBudget);
         ++parts) {
      g.G = (g.nx + parts - 1) / parts;
    }
  } else {
    const int runs_per_row = (W + run - 1) / run;
    g.T = runs_per_row < kTcMaxTiles ? runs_per_row : kTcMaxTiles;
    while (g.T > 1 &&
           (blocks(g) < 2 * (int64_t)sms || tc_shared(g) > kTcSmemBudget)) {
      g.T = (g.T + 1) / 2;
    }
  }
  // launch_tc refuses a plan that still does not fit at one class a block
  while (g.ncls > 1 && tc_shared(g) > kMaxSharedBytes) {
    ++g.nclsg;
    g.ncls = (dil + g.nclsg - 1) / g.nclsg;
  }
  g.nclsg = (dil + g.ncls - 1) / g.ncls;
  g.nRb = (class_rows + g.R - 1) / g.R;
  g.per_row = g.kchunks * 32 / copy_bytes;
  g.inv_c = 1.0 / C;
  g.c_pow2 = (C & (C - 1)) == 0;
  g.m_dil = magic(dil), g.m_T = magic(g.T), g.m_Tncls = magic(g.T * g.ncls);
  g.m_ncls = magic(g.ncls), g.m_nclsg = magic(g.nclsg);
  g.m_nx = magic(g.nx), g.m_per_row = magic(g.per_row);
  g.m_nRb = magic(g.nRb), g.m_P = magic(g.T * kTcTile * g.ncls);
  g.m_slab = magic(g.ncls * (g.T * kTcTile + g.ncols - kTcTile));
  const int64_t runs = (W + run * g.T - 1) / (run * g.T);
  // at least 4 warps to stage, 8 where blocks are fewer than SMs (each
  // block's staging then sets the time)
  const int items = g.R * g.T * g.ncls * g.G;
  const int least = blocks(g) < sms ? kTcMinWarps : kTcMinWarps / 2;
  const int warps = items < least         ? least
                    : items > kTcMaxWarps ? kTcMaxWarps
                                          : items;
  return {g,
          dim3((unsigned)(B * vdil * g.nRb), (unsigned)runs,
               (unsigned)((g.nx + g.G - 1) / g.G * g.nclsg)),
          warps * 32, tc_shared(g)};
}

// The widest copy (16, 8, 4 or 2 bytes) to which both features' addresses
// and a pixel's 2C bytes are aligned.
int copy_width(const void* a, const void* b, int C) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) | (uintptr_t)(2 * C);
  int w = 16;
  while (w > 2 && bits % w) w /= 2;
  return w;
}

// The card's SM count, asked once per process (an H100's 132 if that fails).
int sm_count() {
  static const int sms = [] {
    int device = 0, n = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess) {
      return 132;
    }
    return n;
  }();
  return sms;
}

template <bool k2d>
cudaError_t launch_tc(const void* a, const void* b, void* out, int B, int H,
                      int W, int C, int disp, int dil, cudaStream_t stream) {
  const TcPlan plan = tc_plan(B, H, W, C, disp, dil, k2d,
                              copy_width(a, b, C), sm_count());
  using Kernel = void (*)(const bf16*, const bf16*, bf16*, const TcGeom);
  // by the n8 tiles a warp holds: 2..kTcNtGroup
  static const Kernel kernels[2][kTcNtGroup - 1] = {
      {corr1d_tc_fwd_kernel<2>, corr1d_tc_fwd_kernel<3>,
       corr1d_tc_fwd_kernel<4>, corr1d_tc_fwd_kernel<5>,
       corr1d_tc_fwd_kernel<6>},
      {corr2d_tc_fwd_kernel<2>, corr2d_tc_fwd_kernel<3>,
       corr2d_tc_fwd_kernel<4>, corr2d_tc_fwd_kernel<5>,
       corr2d_tc_fwd_kernel<6>}};
  const int nt_all = (plan.g.ncols + 7) / 8;
  const int nt = nt_all < kTcNtGroup ? nt_all : kTcNtGroup;
  const Kernel kernel = kernels[k2d][nt - 2];
  if (plan.shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (plan.shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)plan.shared);
    if (err != cudaSuccess) return err;
  }
  kernel<<<plan.grid, plan.threads, plan.shared, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), plan.g);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++corr_design_launches[0];
  return err;
}

// A tensor-core backward's launch: its geometry, grid, threads, shared
// bytes, the n8 tiles of a warp's share of a block's channel group and the
// staging buffers.
struct TcBwdPlan {
  TcBwdGeom g;
  dim3 grid;
  int threads;
  size_t shared;
  int nt;
  int nbuf;
};

// The plan for a 2-D (k2d) or 1-D backward (f2: df2, the gather) on a card
// of `sms` SMs. A 2-D block owns R output rows of one residue class of rows
// (their window rows overlap: R rows walk R + 2d window rows, not
// R (2d + 1)) and one run of 16 pixels of each of its classes; a 1-D block
// owns one row and a run of T tiles of 16 pixels of each of its classes.
// A block computes up to kTcMaxWarps residue classes of columns (one warp
// per class and row or tile) and one group of 8 NT channels (df1 and df2
// are disjoint in the channels, so a split costs no sum). NT: of 8, 6, 4
// and 2, the one that computes the fewest padded channels with at least
// one and a half blocks per SM (the larger on a tie; 2 if none has them);
// then the largest R of 8, 4 and 2 (2-D) or T of kTcMaxTiles, 2 (1-D) that
// keeps them within kTcSmemBudget bytes; then as many warps to split each
// item's channels as give the block kTcMinWarps warps (staging sets a
// small block's time). Where the window is too wide for a block's shared
// memory (a large dilation or max_disp), narrower channel groups, then
// fewer classes a block, until it fits. copy_bytes: the features' staging
// copy width.
TcBwdPlan tc_bwd_plan(int B, int H, int W, int C, int disp, int dil,
                      bool k2d, bool f2, int copy_bytes, int sms) {
  TcBwdGeom g{};
  g.H = H, g.W = W, g.C = C, g.disp = disp, g.dil = dil;
  g.nx = k2d ? 2 * disp + 1 : 1;
  g.K = k2d ? g.nx * g.nx : disp + 1;
  g.span = k2d ? 2 * disp : disp;
  g.ncols = kTcTile + g.span;
  g.kchunks = (g.ncols + 15) / 16;
  g.copy_bytes = copy_bytes;
  g.R = 1;
  g.T = 1;
  auto tiles = [&](int T) {  // T tiles of each class a block
    g.T = T;
    g.P = kTcTile * T * dil;
    g.nwin = kTcTile * (T - 1) + g.ncols;
  };
  auto classes = [&](int n) {  // n residue classes of columns a block
    g.ncls = n;
    g.nclsg = (dil + n - 1) / n;
    g.slab = n * g.nwin;
    const int kb = 2 * g.K;
    const int S = n * kb + (((dil - n) * kb) & 15);
    g.gcol = S / 2;
    g.g_bytes = ((f2 ? g.nwin : kTcTile * g.T) * S + 16 + 15) / 16 * 16;
    g.feat_bytes = g.slab * g.row_bytes;
  };
  tiles(1);
  classes(dil < kTcMaxWarps ? dil : kTcMaxWarps);
  const int vdil = k2d ? dil : 1;
  const int class_rows = (H + vdil - 1) / vdil;
  const int nt8 = (C + 7) / 8;
  const int64_t want = (3 * (int64_t)sms + 1) / 2;
  auto blocks = [&](int nt, int R, int T) {
    const int64_t runs = (W + kTcTile * T * dil - 1) / (kTcTile * T * dil);
    return (int64_t)B * vdil * ((class_rows + R - 1) / R) * runs *
           ((nt8 + nt - 1) / nt) * g.nclsg;
  };
  int nt = 2, fewest = 1 << 30;
  for (int cand = kTcBwdNtMax; cand >= 2; cand -= 2) {
    const int padded = (nt8 + cand - 1) / cand * cand;
    if (blocks(cand, 1, 1) >= want && padded < fewest) {
      nt = cand, fewest = padded;
    }
  }
  auto group = [&](int n) {  // a block's channel group of n n8 tiles
    nt = n;
    g.nc = 8 * nt;
    g.row_bytes = 2 * g.nc + 16;
    g.per_row = 2 * g.nc / copy_bytes;
    g.feat_bytes = g.slab * g.row_bytes;
  };
  // the bytes of R rows (2-D) and nbuf staged window rows (1-D: one)
  auto shared = [&](int R, int nbuf) {
    const int bufs = k2d ? nbuf : 1;
    return bufs * (size_t)g.feat_bytes + (size_t)(f2 ? bufs : R) * g.g_bytes;
  };
  group(nt);
  while (shared(1, 2) > kMaxSharedBytes) {
    if (nt > 2) {
      group(nt - 2);
    } else if (g.ncls > 1) {
      classes(g.ncls - 1);
    } else {
      break;  // launch_tc_bwd refuses it
    }
  }
  if (k2d) {
    for (int R = kTcBwdMaxRows; R > 1; R /= 2) {
      if (R * g.ncls <= kTcMaxWarps && blocks(nt, R, 1) >= want &&
          shared(R, 2) <= kTcSmemBudget) {
        g.R = R;
        break;
      }
    }
  } else {
    const int runs_per_row = (W + kTcTile * dil - 1) / (kTcTile * dil);
    for (int T = kTcMaxTiles; T > 1; T /= 2) {
      if (T > runs_per_row || T * g.ncls > kTcMaxWarps ||
          blocks(nt, 1, T) < want) {
        continue;
      }
      tiles(T);
      classes(g.ncls);
      if (shared(1, 2) <= kTcSmemBudget) break;
      tiles(1);
      classes(g.ncls);
    }
  }
  g.nRb = (class_rows + g.R - 1) / g.R;
  int nbuf = kTcBwdBuffers;
  while (nbuf > 2 && (!k2d || shared(g.R, nbuf) > kTcSmemBudget)) --nbuf;
  g.inv_c = 1.0 / C;
  g.c_pow2 = (C & (C - 1)) == 0;
  g.m_dil = magic(dil), g.m_nRb = magic(g.nRb);
  g.m_per_row = magic(g.per_row), g.m_nclsg = magic(g.nclsg);
  g.m_ncls = magic(g.ncls);
  // wc warps split each item's NT n8 tiles, an even count each: the
  // fewest that give the block kTcMinWarps warps, else the most
  const int items = g.R * g.T * g.ncls;
  g.wc = 1;
  for (int wc = 2; wc <= 4 && items * g.wc < kTcMinWarps; ++wc) {
    if (nt % wc == 0 && (nt / wc) % 2 == 0 && items * wc <= kTcMaxWarps) {
      g.wc = wc;
    }
  }
  const int warps = items * g.wc < kTcMinWarps / 2 ? kTcMinWarps / 2
                                                   : items * g.wc;
  const int64_t runs = (W + g.P - 1) / g.P;
  return {g,
          dim3((unsigned)(B * vdil * g.nRb), (unsigned)runs,
               (unsigned)(((nt8 + nt - 1) / nt) * g.nclsg)),
          warps * 32, shared(g.R, nbuf), nt / g.wc, nbuf};
}

template <bool k2d, bool f2>
cudaError_t launch_tc_bwd(const void* g, const void* f, void* out, int B,
                          int H, int W, int C, int disp, int dil,
                          cudaStream_t stream) {
  const TcBwdPlan plan = tc_bwd_plan(B, H, W, C, disp, dil, k2d, f2,
                                     copy_width(f, f, C), sm_count());
  using Kernel = void (*)(const bf16*, const bf16*, bf16*, const TcBwdGeom);
  Kernel kernel;
  if constexpr (k2d) {
    // by the n8 tiles of a warp (2, 4, 6, 8) and the buffers (2, 3, 4)
#define CORR_TC_BWD(k, NT) {k<NT, 2>, k<NT, 3>, k<NT, 4>}
#define CORR_TC_BWDS(k)                                               \
  {CORR_TC_BWD(k, 2), CORR_TC_BWD(k, 4), CORR_TC_BWD(k, 6),           \
   CORR_TC_BWD(k, 8)}
    static const Kernel kernels[2][kTcBwdNtMax / 2][kTcBwdBuffers - 1] = {
        CORR_TC_BWDS(corr2d_tc_bwd_f1_kernel),
        CORR_TC_BWDS(corr2d_tc_bwd_f2_kernel)};
#undef CORR_TC_BWDS
#undef CORR_TC_BWD
    kernel = kernels[f2][plan.nt / 2 - 1][plan.nbuf - 2];
  } else {
    // by the n8 tiles of a warp (2, 4, 6, 8)
    static const Kernel kernels[2][kTcBwdNtMax / 2] = {
        {corr1d_tc_bwd_f1_kernel<2>, corr1d_tc_bwd_f1_kernel<4>,
         corr1d_tc_bwd_f1_kernel<6>, corr1d_tc_bwd_f1_kernel<8>},
        {corr1d_tc_bwd_f2_kernel<2>, corr1d_tc_bwd_f2_kernel<4>,
         corr1d_tc_bwd_f2_kernel<6>, corr1d_tc_bwd_f2_kernel<8>}};
    kernel = kernels[f2][plan.nt / 2 - 1];
  }
  if (plan.shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (plan.shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)plan.shared);
    if (err != cudaSuccess) return err;
  }
  kernel<<<plan.grid, plan.threads, plan.shared, stream>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(f),
      static_cast<bf16*>(out), plan.g);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++corr_design_launches[0];
  return err;
}

}  // namespace

// Each entry point launches on `stream` without synchronising and returns the
// cudaError_t of the launch (0 on success). is_bf16 selects bfloat16 over
// float32 for all three tensors. a and b are (f1, f2) for a forward and
// (g, f2) or (g, f1) for a backward; B, H, W, C are the features' shape.
// bfloat16 runs every kernel on the tensor cores (on the CUDA cores in a
// -DCORR_SIMT build); float32 runs everything on the CUDA cores.
#define CORR_CUDA_CORES(name)                                                \
  (is_bf16 ? launch<__nv_bfloat16>(name##_kernel<__nv_bfloat16>,             \
                                   shape_##name(C, disp, dil), a, b, out, B, \
                                   H, W, C, disp, dil, s)                    \
           : launch<float>(name##_kernel<float>, shape_##name(C, disp, dil), \
                           a, b, out, B, H, W, C, disp, dil, s))
// tc: the tensor-core kernel of the entry in bfloat16: 1 the 2-D forward,
// 0 the 1-D forward, 2 the 2-D df1, 3 the 2-D df2, 4 the 1-D df1, 5 the
// 1-D df2
#define CORR_ENTRY(name, tc)                                                 \
  extern "C" int name(const void* a, const void* b, void* out, int B, int H, \
                      int W, int C, int disp, int dil, int is_bf16,          \
                      void* stream) {                                        \
    if (bad_shape(B, H, W, C, disp, dil)) return cudaErrorInvalidValue;      \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                      \
    if (kTensorCores && is_bf16 && (tc == 0 || tc == 1)) {                   \
      return tc ? launch_tc<true>(a, b, out, B, H, W, C, disp, dil, s)       \
                : launch_tc<false>(a, b, out, B, H, W, C, disp, dil, s);     \
    }                                                                        \
    if (kTensorCores && is_bf16 && tc >= 2) {                                \
      return launch_tc_bwd<(tc <= 3), (tc == 3 || tc == 5)>(               \
          a, b, out, B, H, W, C, disp, dil, s);                              \
    }                                                                        \
    return CORR_CUDA_CORES(name);                                            \
  }

CORR_ENTRY(corr2d_fwd, 1)
CORR_ENTRY(corr1d_fwd, 0)
CORR_ENTRY(corr2d_bwd_f1, 2)
CORR_ENTRY(corr2d_bwd_f2, 3)
CORR_ENTRY(corr1d_bwd_f1, 4)
CORR_ENTRY(corr1d_bwd_f2, 5)

extern "C" const char* corr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef CORR_PHASES
// Copies corr_phase_cycles then corr_item_cycles (12 x 3 + 4 x 3 values) to
// `host`, or zeroes both.
extern "C" int corr_counters_read(void* host) {
  const cudaError_t err = cudaMemcpyFromSymbol(host, corr_phase_cycles,
                                               sizeof(corr_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(
      static_cast<char*>(host) + sizeof(corr_phase_cycles), corr_item_cycles,
      sizeof(corr_item_cycles));
}

extern "C" int corr_counters_zero() {
  static const unsigned long long zeros[12][3] = {};
  const cudaError_t err = cudaMemcpyToSymbol(corr_phase_cycles, zeros,
                                             sizeof(corr_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(corr_item_cycles, zeros,
                                 sizeof(corr_item_cycles));
}
#endif
