// Fused pyramid-encoder level for Hopper (sm_90a): forward and reverse sweep.
//
// One level of the encoder is three 3x3 convolutions, each followed by
// LeakyReLU(0.1), on NHWC-contiguous tensors in float32 or bfloat16:
//
//   y1 = leaky(conv_s2(x,  k1) + b1)   stride 2, SAME on an even extent pads
//                                      (0, 1): y1(p) reads x rows 2p..2p+2
//   y2 = leaky(conv_s1(y1, k2) + b2)   stride 1, SAME pads (1, 1)
//   y3 = leaky(conv_s1(y2, k3) + b3)
//
// x is (B, H, W, C), y1..y3 are (B, H/2, W/2, F); the kernels k1 (3,3,C,F)
// and k2, k3 (3,3,F,F) are HWIO, the biases (F,), all in the working type
// of x. Each conv's SAME padding zero-pads its own input, so a value of y1
// or y2 that lies outside the image is 0, never leaky(bias).
//
// What replaces what. The forward kernels replace _level_kernel (host
// function _level_pallas_raw) and the reverse sweeps _level_bwd_kernel
// (_level_pallas_bwd), both in cerberusnet_tpu/ops/pallas/encoder_level.py.
// The TPU kernels walked row strips in a W-folded layout that fitted the
// TPU's lanes and 16 MB of VMEM; here a block owns a tile of output pixels
// and keeps its intermediates in shared memory, as the TPU kernels kept
// theirs in VMEM.
//
// The reverse sweep, per tile of y pixels it owns: recompute y1 (tile plus
// a 3-pixel halo) and y2 (plus 2) from x, then
//   g3 = g * mask(y3)                   over the tile plus 3
//   dk3, db3 from y2 and g3             over the owned pixels only
//   g2 = convT(g3, k3) * mask(y2)       over the tile plus 2, in place of y2
//   dk2, db2 from y1 and g2             owned pixels only
//   g1 = convT(g2, k2) * mask(y1)       over the tile plus 1 before and 0
//                                       after, in place of y1
//   dk1, db1 from x and g1              owned pixels only
//   dx = entryT(g1, k1)                 the 2T x 2T input pixels it owns
// mask(y) is 1 where y > 0 and 0.1 elsewhere (the sign of a LeakyReLU output
// is that of its input; mask(0) = 0.1, as torch's leaky_relu gradient).
// Cotangents outside the image are 0: they do not exist in the true
// transpose. Numbers, in every kernel here: each value is a float32 sum of
// products plus the float32 bias, LeakyReLU in float32, rounded once to the
// working type; y1, y2 and g1..g3 are held in the working type, as the TPU
// kernels hold them; dk and db are float32.
//
// Bound on an H100 SXM. The three convolutions of a level are
// 2 * (H/2)(W/2) * 9 * F * (C + 2F) FLOP per image: at 512x1024, 1.32,
// 1.51 and 1.51 GFLOP for levels 1-3 (C = 3, 16, 32). On the tensor cores
// (989 TFLOP/s bf16) level 3 at batch 3 needs 4.5 us of operations against
// 2.8 us of bytes (x read once, y3 written once); levels 1-2 are bound by
// bytes. The reverse sweep does about 2.6x the forward's operations and
// reads x, y3 and g and writes dx.
//
// Two designs, chosen by the wrapper from the type and the widths alone,
// never on a failure:
//
// (1) bfloat16 at the widths in TC_LEVELS below (the encoder's levels 1-3:
// (C, F) = (3, 16), (16, 32), (32, 64)): tensor cores. The first design
// (kept as (2)) ran every product as a scalar fmaf on the CUDA cores, each
// multiply-add loading its operand from shared memory and its weight from
// global memory, at 3-4 TFLOP/s; wrote a float32 slot of dk1..dk3, db1..db3
// for every tile (4608 slots, about 417 MB written and summed per train
// step at batch 6); staged the input one element at a time; and recomputed
// up to (T+5)^2/T^2 = 2.64x of y1 from 8x8 tiles. Measured with
// chip_smoke.py (bf16, NVIDIA H100 80GB HBM3 at 700 W), it ran 160-330x its
// bound and 2.6-23x slower than the three cuDNN convolutions it replaces;
// this design runs within 20x its bound and each level faster than cuDNN's
// (PERF.md keeps the numbers). Here:
//  - Every product is an implicit GEMM on mma.sync.m16n8k16 (bf16 in,
//    float32 accumulators in registers). A convolution stage takes M = the
//    stage's pixels, N = F, K = 9 taps x Cin: each lane hands ldmatrix the
//    address of one pixel's row of Cin channels, so the 3x3 gather costs no
//    copy. Level 1's entry conv (C = 3) is staged as im2col rows of 27 values
//    and 5 zeros (K = 32). The transposed convolutions are the same GEMM with
//    the taps flipped; dx is one GEMM per output parity class (taps 4, 2, 2,
//    1). The weight gradients dk[tap] = in(p + tap)^T g(p) take M = Cin, N =
//    F, K = the owned pixels, with in^T and g loaded by ldmatrix.trans.
//  - B operands (the weights) are packed once per call by the wrapper into
//    mma fragment order, so each lane reads its two registers as one
//    coalesced 8-byte load through L1; nothing stages them.
//  - The reverse sweep is persistent: at most two blocks per SM (one at
//    levels 2-3, whose tile takes most of the SM's shared memory), each
//    walking a fixed run of tiles and owning one float32 slot of dk/db,
//    which the wrapper sums over blocks in a fixed order. At levels 1-2 a
//    block's dk (20 and 92 KB) stay in its registers across its tiles, each
//    warp holding the same units of work in every tile, and the slot is
//    written once at the end. Level 3's dk (369 KB) exceed an SM, so each
//    of its tiles updates the slot in place in device memory (L2 traffic).
//    No slot is touched by two blocks and there are no atomics, so the
//    result does not depend on the order blocks run in.
//  - The input patch is staged by cp.async in 16-byte pieces (level 1's
//    rows of three channels in 4-byte pieces) whose source size 0
//    zero-fills the SAME padding, and the tiles are as large as
//    shared memory allows, which cuts the halo recompute (TC_LEVELS below
//    lists the tiles). Nothing prefetches the next tile and TMA is not
//    used: where two blocks share an SM (the forward at every level, the
//    reverse sweep at level 1) one block's staging overlaps the other's
//    products, and level_phases.py measures what that is worth.
//  - Activations are kept in shared memory with each pixel's row padded by
//    16 bytes, so the eight rows an ldmatrix phase reads fall in distinct
//    banks (two-way at most for the stride-2 reads of x).
// mma.sync, not wgmma: the A operand is a gather of pixel rows, which
// ldmatrix takes lane by lane; wgmma would need the same rows copied into
// its descriptor layout first. What is left above the bound is data
// movement (staging, and the ldmatrix and L1 traffic per mma), not the
// instruction; cerberusnet_torch/level_phases.py reports each phase's share
// of the block cycles from a build with the PHASE_MARK clocks below on.
//
// (2) float32, and bfloat16 at any other widths: the CUDA cores. Each thread
// owns one output value and loops over 9 taps and the input channels; dk
// and db are written per tile as float32 partial sums of the owned pixels,
// which the wrapper sums. TF32 tensor cores would break the float32 limits
// (1e-5 forward, 2e-3 backward), and float32 is the port's witness
// precision, on no default path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

// Measurement builds (cerberusnet_torch/level_phases.py), off by default.
// -DLEVEL_PHASES: thread 0 of each tensor-core block reads clock64() at
// every PHASE_MARK(k) and adds the cycles since its previous reading to
// phase_cycles[k][phase] (k = 0 forward, 1 reverse sweep), and SLOT_BYTES
// counts the weight-gradient slot bytes the reverse sweep reads and writes.
// -DLEVEL_FWD_SMEM_PAD=n: the tensor-core forward asks for n more bytes of
// shared memory per block, so that fewer blocks share an SM.
#ifdef LEVEL_PHASES
__device__ unsigned long long phase_cycles[2][16];
__device__ unsigned long long slot_bytes[2];  // read, written
#define PHASE_BEGIN()                 \
  long long phase_last_ = clock64(); \
  int phase_ = 0
#define PHASE_RESTART() phase_ = 0
#define PHASE_MARK(k)                                                   \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      const long long now_ = clock64();                                 \
      atomicAdd(&phase_cycles[k][phase_],                               \
                (unsigned long long)(now_ - phase_last_));              \
      phase_last_ = now_;                                               \
    }                                                                   \
    ++phase_;                                                           \
  } while (0)
#define SLOT_BYTES(read, written)                                \
  do {                                                           \
    atomicAdd(&slot_bytes[0], (unsigned long long)(read));       \
    atomicAdd(&slot_bytes[1], (unsigned long long)(written));    \
  } while (0)
#else
#define PHASE_BEGIN()
#define PHASE_RESTART()
#define PHASE_MARK(k)
#define SLOT_BYTES(read, written) ((void)(read), (void)(written))
#endif
#ifndef LEVEL_FWD_SMEM_PAD
#define LEVEL_FWD_SMEM_PAD 0
#endif

namespace {

constexpr size_t kMaxSharedBytes = 232448;       // 227 KB a block may opt into
constexpr size_t kTwoBlocksBytes = 113 * 1024;   // two blocks on one SM
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kTiles[] = {16, 8, 4, 2, 1};

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float leaky(float v) {
  return v > 0.f ? v : 0.1f * v;
}
__device__ __forceinline__ float mask(float y) { return y > 0.f ? 1.f : 0.1f; }

// ============================================ (2) CUDA cores: float32 etc.

// Copies the n x n pixels of image x (H, W, C) whose top-left one is
// (y0, x0) into dst as (n, n, C); pixels outside the image read as zero.
template <typename T>
__device__ void stage_patch(T* dst, const T* __restrict__ x, int y0, int x0,
                            int n, int H, int W, int C) {
  for (int i = threadIdx.x; i < n * n * C; i += blockDim.x) {
    const int c = i % C;
    const int q = i / C;
    const int gy = y0 + q / n;
    const int gx = x0 + q % n;
    dst[i] = gy >= 0 && gy < H && gx >= 0 && gx < W
                 ? x[((int64_t)gy * W + gx) * C + c]
                 : from_f32<T>(0.f);
  }
}

// One forward conv stage: dst (n, n, F) at y pixels (py0 + ly, px0 + lx)
// from src (m, m, Cin), where dst pixel (ly, lx) tap (ky, kx) reads src
// pixel (s*ly + ky, s*lx + kx). Pixels outside the H2 x W2 image are 0.
template <typename T>
__device__ void conv_stage(T* dst, const T* src, int m,
                           const T* __restrict__ k, const T* __restrict__ bias,
                           int s, int n, int py0, int px0, int H2, int W2,
                           int Cin, int F) {
  for (int i = threadIdx.x; i < n * n * F; i += blockDim.x) {
    const int f = i % F;
    const int q = i / F;
    const int ly = q / n;
    const int lx = q % n;
    const int py = py0 + ly;
    const int px = px0 + lx;
    float v = 0.f;
    if (py >= 0 && py < H2 && px >= 0 && px < W2) {
      float acc = to_f32(bias[f]);
      for (int ky = 0; ky < 3; ++ky) {
        for (int kx = 0; kx < 3; ++kx) {
          const T* sp = src + ((s * ly + ky) * m + s * lx + kx) * Cin;
          const T* kp = k + (ky * 3 + kx) * Cin * F + f;
          for (int c = 0; c < Cin; ++c) {
            acc = fmaf(to_f32(sp[c]), to_f32(kp[c * F]), acc);
          }
        }
      }
      v = leaky(acc);
    }
    dst[i] = from_f32<T>(v);
  }
}

size_t fwd_shared_elems(int t, int C, int F) {
  const size_t nx = 2 * t + 9, n1 = t + 4, n2 = t + 2;
  return nx * nx * C + (n1 * n1 + n2 * n2) * F;
}

size_t bwd_shared_elems(int t, int C, int F) {
  const size_t nx = 2 * t + 11, n1 = t + 5, n2 = t + 3;
  return nx * nx * C + (2 * n1 * n1 + n2 * n2) * F;
}

// The largest tile whose shared memory fits `budget`, or 0.
int pick_tile(size_t (*elems)(int, int, int), int C, int F, size_t elem_bytes,
              size_t budget) {
  for (int t : kTiles) {
    if (elems(t, C, F) * elem_bytes <= budget) return t;
  }
  return 0;
}

// grid: (tiles_w, tiles_h, B). Shared: x patch (2T+9)^2 C, y1 (T+4)^2 F,
// y2 (T+2)^2 F, in the working type.
template <typename T>
__global__ void level_fwd_kernel(const T* __restrict__ x,
                                 const T* __restrict__ k1,
                                 const T* __restrict__ b1,
                                 const T* __restrict__ k2,
                                 const T* __restrict__ b2,
                                 const T* __restrict__ k3,
                                 const T* __restrict__ b3, T* __restrict__ out,
                                 int H, int W, int C, int F, int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H2 = H / 2, W2 = W / 2;
  const int r0 = blockIdx.y * t, c0 = blockIdx.x * t;
  const int b = blockIdx.z;
  const int nx = 2 * t + 9, n1 = t + 4, n2 = t + 2;
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* y1s = xs + nx * nx * C;
  T* y2s = y1s + n1 * n1 * F;

  // x rows and columns from 2(r0 - 2): y1 pixel r0 - 2 + l reads 2l + k
  stage_patch(xs, x + (int64_t)b * H * W * C, 2 * r0 - 4, 2 * c0 - 4, nx, H,
              W, C);
  __syncthreads();
  conv_stage(y1s, xs, nx, k1, b1, 2, n1, r0 - 2, c0 - 2, H2, W2, C, F);
  __syncthreads();
  // y2 pixel r0 - 1 + l reads y1 pixels r0 - 2 + l + k: local l + k
  conv_stage(y2s, y1s, n1, k2, b2, 1, n2, r0 - 1, c0 - 1, H2, W2, F, F);
  __syncthreads();
  T* ob = out + (int64_t)b * H2 * W2 * F;
  for (int i = threadIdx.x; i < t * t * F; i += blockDim.x) {
    const int f = i % F;
    const int q = i / F;
    const int ly = q / t;
    const int lx = q % t;
    const int py = r0 + ly, px = c0 + lx;
    if (py >= H2 || px >= W2) continue;
    float acc = to_f32(b3[f]);
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        const T* sp = y2s + ((ly + ky) * n2 + lx + kx) * F;
        const T* kp = k3 + (ky * 3 + kx) * F * F + f;
        for (int c = 0; c < F; ++c) {
          acc = fmaf(to_f32(sp[c]), to_f32(kp[c * F]), acc);
        }
      }
    }
    ob[((int64_t)py * W2 + px) * F + f] = from_f32<T>(leaky(acc));
  }
}

// The weight-gradient partial of one conv over the owned t x t pixels:
// dk[tap][c][f] = sum_p in(p + tap)[c] * g(p)[f], db[f] = sum_p g(p)[f].
// Owned pixel (jy, jx) reads `in` at local (s*jy + io + ky, s*jx + io + kx)
// of an (m, m, Cin) buffer and g at local (jy + go, jx + go) of an (ng, ng,
// F) buffer. g is 0 outside the image, so pixels past the image's edge add
// nothing.
template <typename T>
__device__ void weight_grad(float* __restrict__ dk, float* __restrict__ db,
                            const T* in, int m, int s, int io, const T* g,
                            int ng, int go, int t, int Cin, int F) {
  const int n = 9 * Cin * F;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int f = o % F;
    const int c = (o / F) % Cin;
    const int tap = o / (F * Cin);
    const int ky = tap / 3, kx = tap % 3;
    float acc = 0.f;
    for (int jy = 0; jy < t; ++jy) {
      for (int jx = 0; jx < t; ++jx) {
        const int q = (s * jy + io + ky) * m + s * jx + io + kx;
        const float a = to_f32(in[q * Cin + c]);
        const float b = to_f32(g[((jy + go) * ng + jx + go) * F + f]);
        acc = fmaf(a, b, acc);
      }
    }
    dk[o] = acc;
  }
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc = 0.f;
    for (int jy = 0; jy < t; ++jy) {
      for (int jx = 0; jx < t; ++jx) {
        acc += to_f32(g[((jy + go) * ng + jx + go) * F + f]);
      }
    }
    db[f] = acc;
  }
}

// One transposed stride-1 stage, in place: for local pixels (ly, lx) in
// [lo, lo + n)^2 of an (m, m, Cout) buffer `ys` holding y at y pixel
// (py0 + ly, px0 + lx), replaces y by
//   g(p)[c] = mask(y(p)[c]) * sum_{tap, f} gin(p + 1 - tap)[f] * kT[tap][f][c]
// (0 outside the image), where gin is (mg, mg, F) with y pixel p at local
// p - gorigin. kT is the conv's kernel as (3, 3, F, Cout). Each value is
// read and written by its own thread only, so the update is safe in place.
template <typename T>
__device__ void transpose_stage(T* ys, int m, int lo, int n, int py0, int px0,
                                const T* gin, int mg, int gy0, int gx0,
                                const T* __restrict__ kT, int H2, int W2,
                                int F, int Cout) {
  for (int i = threadIdx.x; i < n * n * Cout; i += blockDim.x) {
    const int c = i % Cout;
    const int q = i / Cout;
    const int ly = lo + q / n;
    const int lx = lo + q % n;
    const int py = py0 + ly, px = px0 + lx;
    T* yp = ys + (ly * m + lx) * Cout + c;
    float v = 0.f;
    if (py >= 0 && py < H2 && px >= 0 && px < W2) {
      float acc = 0.f;
      for (int ky = 0; ky < 3; ++ky) {
        for (int kx = 0; kx < 3; ++kx) {
          const T* gp =
              gin + ((py + 1 - ky - gy0) * mg + px + 1 - kx - gx0) * F;
          const T* kp = kT + (ky * 3 + kx) * F * Cout + c;
          for (int f = 0; f < F; ++f) {
            acc = fmaf(to_f32(gp[f]), to_f32(kp[f * Cout]), acc);
          }
        }
      }
      v = acc * mask(to_f32(*yp));
    }
    *yp = from_f32<T>(v);
  }
}

// grid: (tiles_w, tiles_h, B). Shared, in the working type: x patch
// (2T+11)^2 C from x pixel 2(r0 - 3); y1 then g1, (T+5)^2 F from y pixel
// r0 - 3; g3, (T+5)^2 F from r0 - 3; y2 then g2, (T+3)^2 F from r0 - 2.
// Partials: pk1 (tiles, 9, C, F), pk2 and pk3 (tiles, 9, F, F), pb1..pb3
// (tiles, F), float32. dx may be null (not wanted).
template <typename T>
__global__ void level_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y3, const T* __restrict__ g,
    const T* __restrict__ k1, const T* __restrict__ b1,
    const T* __restrict__ k2, const T* __restrict__ b2,
    const T* __restrict__ k3, const T* __restrict__ b3,
    const T* __restrict__ k1T, const T* __restrict__ k2T,
    const T* __restrict__ k3T, T* __restrict__ dx, float* __restrict__ pk1,
    float* __restrict__ pb1, float* __restrict__ pk2, float* __restrict__ pb2,
    float* __restrict__ pk3, float* __restrict__ pb3, int H, int W, int C,
    int F, int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H2 = H / 2, W2 = W / 2;
  const int r0 = blockIdx.y * t, c0 = blockIdx.x * t;
  const int b = blockIdx.z;
  const int tile = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int nx = 2 * t + 11, n1 = t + 5, n2 = t + 3;
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* y1s = xs + nx * nx * C;   // y pixels from (r0 - 3, c0 - 3)
  T* g3s = y1s + n1 * n1 * F;  // from (r0 - 3, c0 - 3)
  T* y2s = g3s + n1 * n1 * F;  // from (r0 - 2, c0 - 2)
  const int64_t img2 = (int64_t)b * H2 * W2 * F;

  stage_patch(xs, x + (int64_t)b * H * W * C, 2 * r0 - 6, 2 * c0 - 6, nx, H,
              W, C);
  // g3 = g * mask(y3), 0 outside the image
  for (int i = threadIdx.x; i < n1 * n1 * F; i += blockDim.x) {
    const int f = i % F;
    const int q = i / F;
    const int py = r0 - 3 + q / n1, px = c0 - 3 + q % n1;
    float v = 0.f;
    if (py >= 0 && py < H2 && px >= 0 && px < W2) {
      const int64_t at = img2 + ((int64_t)py * W2 + px) * F + f;
      v = to_f32(g[at]) * mask(to_f32(y3[at]));
    }
    g3s[i] = from_f32<T>(v);
  }
  __syncthreads();
  conv_stage(y1s, xs, nx, k1, b1, 2, n1, r0 - 3, c0 - 3, H2, W2, C, F);
  __syncthreads();
  // y2 pixel r0 - 2 + l reads y1 pixels r0 - 3 + l + k: local l + k
  conv_stage(y2s, y1s, n1, k2, b2, 1, n2, r0 - 2, c0 - 2, H2, W2, F, F);
  __syncthreads();

  // dk3, db3: owned pixel r0 + j reads y2 at r0 + j + k - 1 (local j + 1 + k)
  // and g3 at local j + 3
  const int64_t kk = (int64_t)9 * F * F;
  weight_grad(pk3 + tile * kk, pb3 + (int64_t)tile * F, y2s, n2, 1, 1, g3s,
              n1, 3, t, F, F);
  __syncthreads();
  // g2 over y2's whole region (y pixels r0 - 2 .. r0 + t), in place of y2
  transpose_stage(y2s, n2, 0, n2, r0 - 2, c0 - 2, g3s, n1, r0 - 3, c0 - 3,
                  k3T, H2, W2, F, F);
  __syncthreads();
  // dk2, db2: y1 at r0 + j + k - 1 (local j + 2 + k), g2 at local j + 2
  weight_grad(pk2 + tile * kk, pb2 + (int64_t)tile * F, y1s, n1, 1, 2, y2s,
              n2, 2, t, F, F);
  __syncthreads();
  // g1 over y pixels r0 - 1 .. r0 + t - 1 (local 2 .. t + 2), in place of y1
  transpose_stage(y1s, n1, 2, t + 1, r0 - 3, c0 - 3, y2s, n2, r0 - 2, c0 - 2,
                  k2T, H2, W2, F, F);
  __syncthreads();
  // dk1, db1: x at 2(r0 + j) + k (local 2j + 6 + k), g1 at local j + 3
  weight_grad(pk1 + (int64_t)tile * 9 * C * F, pb1 + (int64_t)tile * F, xs,
              nx, 2, 6, y1s, n1, 3, t, C, F);
  if (dx == nullptr) return;
  // dx at the owned input pixels 2r0 .. 2r0 + 2t - 1: x pixel i gets
  // g1(p) k1[i - 2p] for the p with i - 2p in 0..2; g1 pixel p sits at local
  // p - r0 + 3 = (i - 2r0 - k + 6) / 2
  T* dxb = dx + (int64_t)b * H * W * C;
  const int m = 2 * t;
  for (int i = threadIdx.x; i < m * m * C; i += blockDim.x) {
    const int c = i % C;
    const int q = i / C;
    const int iy = q / m, ix = q % m;
    const int gy = 2 * r0 + iy, gx = 2 * c0 + ix;
    if (gy >= H || gx >= W) continue;
    float acc = 0.f;
    for (int ky = iy & 1; ky < 3; ky += 2) {
      const int ly = (iy - ky + 6) / 2;
      for (int kx = ix & 1; kx < 3; kx += 2) {
        const int lx = (ix - kx + 6) / 2;
        const T* gp = y1s + (ly * n1 + lx) * F;
        const T* kp = k1T + (ky * 3 + kx) * F * C + c;
        for (int f = 0; f < F; ++f) {
          acc = fmaf(to_f32(gp[f]), to_f32(kp[f * C]), acc);
        }
      }
    }
    dxb[((int64_t)gy * W + gx) * C + c] = from_f32<T>(acc);
  }
}

// ================================== (1) tensor cores: bfloat16, TC_LEVELS

constexpr int kThreads = 256;  // the forward's; a reverse sweep's is THREADS

// The widths of one level and how its operands sit in shared memory.
template <int C_, int F_>
struct Widths {
  static constexpr int C = C_, F = F_;
  // C = 3: the entry conv reads im2col rows of 27 values and 5 zeros
  static constexpr bool kIm2col = C == 3;
  static constexpr int KC1 = kIm2col ? 2 : C / 16;  // k16 chunks per tap
  static constexpr int KCF = F / 16;
  static constexpr int NT = F / 8;         // n8 tiles of an F-wide output
  static constexpr int NTX = (C + 7) / 8;  // of dx's C-wide output
  // 16-pixel row blocks that share each B fragment in a convolution stage
  static constexpr int MT = F >= 32 ? 2 : 1;
  // elements per pixel row in shared memory: the operand plus 16 bytes, so
  // eight consecutive rows start in eight distinct 16-byte bank groups
  static constexpr int XS = (kIm2col ? 32 : C) + 8;
  static constexpr int FS = F + 8;
  // floats of one block's weight-gradient slot: dk1, dk2, dk3, db1..db3
  static constexpr int kSlot = 9 * C * F + 2 * 9 * F * F + 3 * F;
};

// Forward tile TH x TW: x patch (or im2col rows) and y1 in shared memory;
// y2 takes the x patch's place once y1 is done.
template <int C, int F, int TH, int TW>
struct FwdPlan {
  using L = Widths<C, F>;
  static constexpr int N1H = TH + 4, N1W = TW + 4;  // y1 from (r0-2, c0-2)
  static constexpr int N2H = TH + 2, N2W = TW + 2;  // y2 from (r0-1, c0-1)
  static constexpr int NXH = 2 * TH + 9, NXW = 2 * TW + 9;  // x from 2r0-4
  static constexpr int XE =
      L::kIm2col ? N1H * N1W * L::XS : NXH * NXW * L::XS;
  static constexpr int Y2E = N2H * N2W * L::FS;
  static constexpr int R0E = XE > Y2E ? XE : Y2E;
  static constexpr int Y1E = N1H * N1W * L::FS;
  static constexpr size_t kBytes = sizeof(bf16) * (size_t)(R0E + Y1E);
};

// Reverse-sweep tile TH x TW: x patch (or im2col rows), y1/g1, g3, y2/g2
// and a float32 scratch for the bias gradients, THREADS threads.
template <int C, int F, int TH, int TW, int THREADS>
struct BwdPlan {
  using L = Widths<C, F>;
  static constexpr int N1H = TH + 5, N1W = TW + 5;  // y1, g1, g3 from r0-3
  static constexpr int N2H = TH + 3, N2W = TW + 3;  // y2, g2 from r0-2
  static constexpr int NXH = 2 * TH + 11, NXW = 2 * TW + 11;  // x from 2r0-6
  static constexpr int XE =
      L::kIm2col ? N1H * N1W * L::XS : NXH * NXW * L::XS;
  static constexpr int Y1E = N1H * N1W * L::FS;
  static constexpr int Y2E = N2H * N2W * L::FS;
  static constexpr size_t kBytes =
      sizeof(bf16) * (size_t)(XE + 2 * Y1E + Y2E) + sizeof(float) * 3 * THREADS;
};

// An implicit GEMM over M output pixels: out(q)[n] = sum over taps t and k
// of A(q, t)[k] * Bt[k][n], where A(q, t) is the row of K = 16 KC channels
// at base_of(q) + tap_off(t) in shared memory and Bt is the packed weight
// tap wtap(t) (KC x NT fragments of 32 lanes, uint2 each). A warp's item
// is 16 MT pixels and all N = 8 NT outputs, or half of them where N = 64,
// so that a small tile's stage still has work for every warp and the
// accumulators stay in registers. B comes through L1 from L2 (the weights
// do not fit beside the tile in shared memory), so each B fragment serves
// the item's MT row blocks. epi(q, n, v, v') receives outputs n and n + 1
// of pixel q.
template <int KC, int NT, int MT, class Base, class TapOff, class WTap,
          class Epi>
__device__ __forceinline__ void gemm_rows(int M, int ntaps, Base base_of,
                                          TapOff tap_off, WTap wtap,
                                          const uint2* __restrict__ wpk,
                                          Epi epi) {
  constexpr int NS = NT >= 8 ? 2 : 1;  // items per 16 MT pixels
  constexpr int NI = NT / NS;          // n8 tiles of an item
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = (M + 16 * MT - 1) / (16 * MT) * NS;
  for (int item = warp; item < items; item += blockDim.x >> 5) {
    const int m0 = item / NS * 16 * MT, n0 = item % NS * NI;
    // ldmatrix: lanes 0-15 give rows m0..m0+15 at channels k..k+7, lanes
    // 16-31 the same rows at k+8..k+15; rows past M repeat the last one
    const bf16* row[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      row[mt] = base_of(min(m0 + 16 * mt + (lane & 15), M - 1)) +
                8 * (lane >> 4);
    }
    float acc[MT][NI][4] = {};
#pragma unroll 1
    for (int t = 0; t < ntaps; ++t) {
      const int off = tap_off(t);
      const uint2* w = wpk + (size_t)wtap(t) * (KC * NT * 32) + lane;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ptx::ldmatrix_x4(a[mt], row[mt] + off + kc * 16);
        }
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          const uint2 b = __ldg(w + (kc * NT + n0 + n) * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ptx::mma_bf16(acc[mt][n], a[mt], b.x, b.y);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = m0 + 16 * mt + (lane >> 2);
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int col = (n0 + n) * 8 + 2 * (lane & 3);
        if (r < M) epi(r, col, acc[mt][n][0], acc[mt][n][1]);
        if (r + 8 < M) epi(r + 8, col, acc[mt][n][2], acc[mt][n][3]);
      }
    }
  }
}

// Weight gradients over the NPIX owned pixels of a tile:
//   dk[t][c][f] (+)= sum_p in(p, t)[c] * g(p)[f]   for rows c < `rows`,
// where in(p, t) is the row at in_of(p) + tap_off(t) and g(p) the row at
// g_of(p), both in shared memory. M = 16 MC rows of in^T, N = F = 8 NT,
// K = the pixels; both operands come through ldmatrix.trans. The work is
// cut into units of one tap and 16 rows, each owned by one warp, whose
// float32 accumulators are acc[NT][4] of each lane (mma's d fragment).

// Adds one unit's products to acc; `off` is tap_off(t) + 16 mc.
template <int NT, int NPIX, class In, class G>
__device__ __forceinline__ void wgrad_products(float (&acc)[NT][4], int off,
                                               In in_of, G g_of) {
  const int lane = threadIdx.x & 31;
  // A (16 channels x 16 pixels): lanes 0-7 pixels k..k+7 at channels
  // c..c+7, 8-15 the same pixels at c+8.., 16-31 pixels k+8..k+15
  const int a_off = off + 8 * ((lane >> 3) & 1);
  const int a_pix = (lane & 7) + 8 * (lane >> 4);
  // B (16 pixels x 16 outputs): lanes 0-7 pixels k..k+7, 8-15 k+8..k+15,
  // at outputs n..n+7; lanes 16-31 the same at n+8..n+15
  const int b_pix = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_off = 8 * (lane >> 4);
#pragma unroll 2
  for (int k0 = 0; k0 < NPIX; k0 += 16) {
    uint32_t a[4];
    ptx::ldmatrix_x4_trans(a, in_of(k0 + a_pix) + a_off);
    const bf16* gp = g_of(k0 + b_pix) + b_off;
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ptx::ldmatrix_x4_trans(b, gp + n * 8);
      ptx::mma_bf16(acc[n], a, b[0], b[1]);
      ptx::mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// Moves unit (t, mc)'s accumulators between registers and rows c < `rows`
// of dk (ntaps, rows, F) in device memory: stores them, or with `load`
// loads them; returns the bytes moved.
template <int NT, bool load>
__device__ __forceinline__ int unit_rows(float* __restrict__ dk, int rows,
                                         int t, int mc, float (&acc)[NT][4]) {
  constexpr int F = NT * 8;
  const int lane = threadIdx.x & 31;
  const int c = mc * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int f = n * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (c + 8 * h >= rows) continue;
      float2* p = reinterpret_cast<float2*>(
          dk + ((size_t)t * rows + c + 8 * h) * F + f);
      if constexpr (load) {
        const float2 v = *p;
        acc[n][2 * h] = v.x;
        acc[n][2 * h + 1] = v.y;
      } else {
        *p = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
  }
  return 4 * F * min(16, rows - 16 * mc);
}

// In place in the block's slot (where a slot does not fit on chip): each
// warp walks its units; `first` stores the unit, a later tile loads it
// first (before the products, so that the load's latency hides behind
// them) and stores the sum. One lane per slot value keeps the order fixed.
template <int MC, int NT, int NPIX, class In, class TapOff, class G>
__device__ __forceinline__ void wgrad(int ntaps, int rows, In in_of,
                                      TapOff tap_off, G g_of,
                                      float* __restrict__ dk, bool first) {
  const int warp = threadIdx.x >> 5;
  for (int u = warp; u < ntaps * MC; u += blockDim.x >> 5) {
    const int t = u / MC, mc = u % MC;
    float acc[NT][4] = {};
    const int read = first ? 0 : unit_rows<NT, true>(dk, rows, t, mc, acc);
    wgrad_products<NT, NPIX>(acc, tap_off(t) + 16 * mc, in_of, g_of);
    const int written = unit_rows<NT, false>(dk, rows, t, mc, acc);
    if ((threadIdx.x & 31) == 0) SLOT_BYTES(read, written);
  }
}

// On chip (where a slot fits in the registers): the block's units are
// numbered across its three weight gradients (dk3, dk2, dk1) and dealt to
// the NW warps in turn, warp w holding units w + j NW in kept[j] across all
// its tiles; this call adds the products of the units [ubase, ubase +
// ntaps MC) that the caller's warp holds.
template <int MC, int NT, int NPIX, int NW, int NU, class In, class TapOff,
          class G>
__device__ __forceinline__ void wgrad_kept(float (&kept)[NU][NT][4],
                                           int ubase, int ntaps, In in_of,
                                           TapOff tap_off, G g_of) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int u = warp + j * NW - ubase;
    if (u >= 0 && u < ntaps * MC) {
      wgrad_products<NT, NPIX>(kept[j], tap_off(u / MC) + 16 * (u % MC),
                               in_of, g_of);
    }
  }
}

// Rows y0 .. y0 + NH - 1, pixels x0 .. x0 + NWP - 1 of an image x (H, W, 3)
// into raw (NH, NWP * 3) by cp.async, a pair of values (4 bytes) at a time,
// zero outside the image. x0, NWP and W are even, so a pair never straddles
// a pixel at the image's edge: it lies wholly inside or wholly outside.
// Completes at ptx::cp_async_wait_all().
template <int NTH, int NH, int NWP>
__device__ void stage_rows_c3(bf16* raw, const bf16* __restrict__ xb, int y0,
                              int x0, int H, int W) {
  constexpr int RP = NWP * 3 / 2;  // value pairs a row
  for (int i = threadIdx.x; i < NH * RP; i += NTH) {
    const int r = i / RP, e = 2 * (i - r * RP);
    const int gy = y0 + r, gx = x0 + e / 3;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* src = in ? xb + ((int64_t)gy * W + x0) * 3 + e : xb;
    ptx::cp_async4(raw + r * NWP * 3 + e, src, in ? 4 : 0);
  }
}

// Im2col rows of the stride-2 entry conv (C = 3) for NH x NW y pixels from
// the raw rows of stage_rows_c3 (NWP pixels a row, from the x pixel under
// y pixel 0's tap 0): row q holds x(2py + ky, 2px + kx)[c] at k = 3 (3ky +
// kx) + c, and zero for k >= 27; rows of S elements. The 9 values of one
// ky (3 pixels of 3 channels) lie together in both, so one thread copies
// them.
template <int NTH, int NH, int NW, int NWP, int S>
__device__ void im2col_from(bf16* dst, const bf16* raw) {
  for (int i = threadIdx.x; i < NH * NW * 3; i += NTH) {
    const int q = i / 3, ky = i - 3 * q;
    const bf16* src = raw + ((2 * (q / NW) + ky) * NWP + 2 * (q % NW)) * 3;
    bf16* d = dst + q * S + 9 * ky;
    bf16 v[9];  // all nine loads go out before the first store
#pragma unroll
    for (int e = 0; e < 9; ++e) v[e] = src[e];
#pragma unroll
    for (int e = 0; e < 9; ++e) d[e] = v[e];
    if (ky == 2) {
#pragma unroll
      for (int e = 9; e < 14; ++e) d[e] = __float2bfloat16(0.f);
    }
  }
}

// The NH x NW pixels of x (H, W, C) from (y0, x0) by cp.async, 16 bytes at
// a time, zero outside the image; rows of S elements. Completes at
// ptx::cp_async_wait_all().
template <int C, int NH, int NW, int S>
__device__ void stage_patch_async(bf16* dst, const bf16* __restrict__ xb,
                                  int y0, int x0, int H, int W) {
  constexpr int CH = C / 8;
  for (int i = threadIdx.x; i < NH * NW * CH; i += blockDim.x) {
    const int q = i / CH, k = i - q * CH;
    const int gy = y0 + q / NW, gx = x0 + q % NW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* src = in ? xb + ((int64_t)gy * W + gx) * C + 8 * k : xb;
    ptx::cp_async16(dst + q * S + 8 * k, src, in ? 16 : 0);
  }
}

// g3 = g * mask(y3) over the NH x NW y pixels from (py0, px0) of one image
// (H2, W2, F), rounded once, 0 outside the image; rows of S elements.
template <int F, int NH, int NW, int S>
__device__ void stage_g3(bf16* dst, const bf16* __restrict__ g,
                         const bf16* __restrict__ y3, int py0, int px0,
                         int H2, int W2) {
  constexpr int CH = F / 8;
  for (int i = threadIdx.x; i < NH * NW * CH; i += blockDim.x) {
    const int q = i / CH, k = i - q * CH;
    const int py = py0 + q / NW, px = px0 + q % NW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (py >= 0 && py < H2 && px >= 0 && px < W2) {
      const int64_t at = ((int64_t)py * W2 + px) * F + 8 * k;
      const uint4 gv = *reinterpret_cast<const uint4*>(g + at);
      const uint4 yv = *reinterpret_cast<const uint4*>(y3 + at);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&yv);
      __nv_bfloat162* vp = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vp[e] = __floats2bfloat162_rn(
            __low2float(gp[e]) * mask(__low2float(yp[e])),
            __high2float(gp[e]) * mask(__high2float(yp[e])));
      }
    }
    *reinterpret_cast<uint4*>(dst + q * S + 8 * k) = v;
  }
}

// Epilogue: leaky(v + bias) for pixel q of an NW-wide region whose pixel 0
// is y pixel (py0, px0), stored at row q' = (q / NW) dw + q % NW + off of
// dst; 0 outside the image.
template <int S, int NW>
__device__ __forceinline__ auto leaky_into(bf16* dst, int dw, int off,
                                           int py0, int px0, int H2, int W2,
                                           const bf16* __restrict__ bias) {
  return [=](int q, int n, float v0, float v1) {
    const int i = q / NW, j = q % NW;
    const int py = py0 + i, px = px0 + j;
    float a = 0.f, b = 0.f;
    if (py >= 0 && py < H2 && px >= 0 && px < W2) {
      a = leaky(v0 + __bfloat162float(bias[n]));
      b = leaky(v1 + __bfloat162float(bias[n + 1]));
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + (i * dw + j + off) * S + n) =
        __floats2bfloat162_rn(a, b);
  };
}

// Epilogue of a transposed stage: v * mask(y) in place of y, 0 outside the
// image; rows placed as in leaky_into.
template <int S, int NW>
__device__ __forceinline__ auto mask_into(bf16* buf, int dw, int off, int py0,
                                          int px0, int H2, int W2) {
  return [=](int q, int n, float v0, float v1) {
    const int i = q / NW, j = q % NW;
    const int py = py0 + i, px = px0 + j;
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(buf + (i * dw + j + off) * S + n);
    float a = 0.f, b = 0.f;
    if (py >= 0 && py < H2 && px >= 0 && px < W2) {
      const __nv_bfloat162 y = *p;
      a = v0 * mask(__low2float(y));
      b = v1 * mask(__high2float(y));
    }
    *p = __floats2bfloat162_rn(a, b);
  };
}

// y1 = leaky(conv_s2(x, k1) + b1) over the NH x NW y pixels from (py0,
// px0), into y1s (rows of FS, NW wide), from the x patch that starts at x
// pixel (2 py0, 2 px0) with NXW columns, or from im2col rows.
template <class L, int NH, int NW, int NXW>
__device__ __forceinline__ void entry_conv(bf16* y1s, const bf16* xs,
                                           const uint2* __restrict__ k1,
                                           const bf16* __restrict__ b1,
                                           int py0, int px0, int H2, int W2) {
  const auto epi = leaky_into<L::FS, NW>(y1s, NW, 0, py0, px0, H2, W2, b1);
  if constexpr (L::kIm2col) {
    gemm_rows<L::KC1, L::NT, L::MT>(
        NH * NW, 1, [=](int q) { return xs + q * L::XS; },
        [](int) { return 0; }, [](int) { return 0; }, k1, epi);
  } else {
    gemm_rows<L::KC1, L::NT, L::MT>(
        NH * NW, 9,
        [=](int q) { return xs + (2 * (q / NW) * NXW + 2 * (q % NW)) * L::XS; },
        [](int t) { return ((t / 3) * NXW + t % 3) * L::XS; },
        [](int t) { return t; }, k1, epi);
  }
}

// dst (NH x NW pixels, rows of FS) = epi of the stride-1 3x3 conv of src
// (rows of FS, SW wide), dst pixel (i, j) reading src (i + ky, j + kx).
template <class L, int NH, int NW, int SW, class Epi>
__device__ __forceinline__ void conv_s1(const bf16* src,
                                        const uint2* __restrict__ w, Epi epi) {
  gemm_rows<L::KCF, L::NT, L::MT>(
      NH * NW, 9, [=](int q) { return src + ((q / NW) * SW + q % NW) * L::FS; },
      [](int t) { return ((t / 3) * SW + t % 3) * L::FS; },
      [](int t) { return t; }, w, epi);
}

// grid: one block per TH x TW tile of output pixels, numbered (b tiles_h +
// tile row) tiles_w + tile column.
template <int C, int F, int TH, int TW>
__global__ void __launch_bounds__(kThreads, 2)
    tc_fwd_kernel(const bf16* __restrict__ x, const uint2* __restrict__ k1,
                  const bf16* __restrict__ b1, const uint2* __restrict__ k2,
                  const bf16* __restrict__ b2, const uint2* __restrict__ k3,
                  const bf16* __restrict__ b3, bf16* __restrict__ out, int H,
                  int W, int tiles_h, int tiles_w) {
  using P = FwdPlan<C, F, TH, TW>;
  using L = typename P::L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* y2s = xs;  // y2 takes the x patch's place
  bf16* y1s = xs + P::R0E;
  const int H2 = H / 2, W2 = W / 2;
  const int tile = blockIdx.x;
  const int b = tile / (tiles_h * tiles_w);
  const int r0 = tile / tiles_w % tiles_h * TH, c0 = tile % tiles_w * TW;
  const bf16* xb = x + (int64_t)b * H * W * C;
  PHASE_BEGIN();

  if constexpr (L::kIm2col) {
    // the raw rows go where y1 will be
    static_assert(P::NXH * (P::NXW + 1) * 3 <= P::Y1E, "raw rows");
    stage_rows_c3<kThreads, P::NXH, P::NXW + 1>(y1s, xb, 2 * r0 - 4,
                                                2 * c0 - 4, H, W);
    ptx::cp_async_wait_all();
    __syncthreads();
    PHASE_MARK(0);
    im2col_from<kThreads, P::N1H, P::N1W, P::NXW + 1, L::XS>(xs, y1s);
  } else {
    stage_patch_async<C, P::NXH, P::NXW, L::XS>(xs, xb, 2 * r0 - 4,
                                                2 * c0 - 4, H, W);
    ptx::cp_async_wait_all();
  }
  __syncthreads();
  PHASE_MARK(0);
  entry_conv<L, P::N1H, P::N1W, P::NXW>(y1s, xs, k1, b1, r0 - 2, c0 - 2, H2,
                                        W2);
  __syncthreads();
  PHASE_MARK(0);
  conv_s1<L, P::N2H, P::N2W, P::N1W>(
      y1s, k2,
      leaky_into<L::FS, P::N2W>(y2s, P::N2W, 0, r0 - 1, c0 - 1, H2, W2, b2));
  __syncthreads();
  PHASE_MARK(0);
  bf16* ob = out + (int64_t)b * H2 * W2 * F;
  conv_s1<L, TH, TW, P::N2W>(y2s, k3, [=](int q, int n, float v0, float v1) {
    const int py = r0 + q / TW, px = c0 + q % TW;
    if (py >= H2 || px >= W2) return;
    *reinterpret_cast<__nv_bfloat162*>(ob + ((int64_t)py * W2 + px) * F + n) =
        __floats2bfloat162_rn(leaky(v0 + __bfloat162float(b3[n])),
                              leaky(v1 + __bfloat162float(b3[n + 1])));
  });
  PHASE_MARK(0);
}

// Persistent: block i walks tiles sched[i] .. sched[i + 1] - 1 (numbered as
// the forward's) and owns slot i of `slots` (kSlot floats: dk1 (9, C, F),
// dk2, dk3 (9, F, F), db1, db2, db3). With KEEP the block's dk live in
// registers across its tiles (wgrad_kept) and the slot is written once at
// the end; without, each tile updates the slot in place (wgrad). db lives in
// registers either way. k3t and k2t are k3 and k2 with taps flipped as
// (tap, F out, F in), k1t is k1 as (tap, F, C), all packed; dx may be null
// (not wanted).
template <int C, int F, int TH, int TW, int MINB, int THREADS, bool KEEP>
__global__ void __launch_bounds__(THREADS, MINB)
    tc_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y3,
                  const bf16* __restrict__ g, const uint2* __restrict__ k1,
                  const bf16* __restrict__ b1, const uint2* __restrict__ k2,
                  const bf16* __restrict__ b2, const uint2* __restrict__ k3t,
                  const uint2* __restrict__ k2t,
                  const uint2* __restrict__ k1t, bf16* __restrict__ dx,
                  float* __restrict__ slots, const int* __restrict__ sched,
                  int H, int W, int tiles_h, int tiles_w) {
  using P = BwdPlan<C, F, TH, TW, THREADS>;
  using L = typename P::L;
  constexpr int NPIX = TH * TW;
  constexpr int N1W = P::N1W, N2W = P::N2W, NXW = P::NXW, FS = L::FS;
  // weight-gradient units (wgrad_kept): dk3's, then dk2's, then dk1's
  constexpr int U3 = 9 * L::KCF;
  constexpr int U1 = (L::kIm2col ? 1 : 9) * L::KC1;
  constexpr int NW = THREADS / 32;
  constexpr int NU = KEEP ? (2 * U3 + U1 + NW - 1) / NW : 1;
  constexpr int ROWS1 = L::kIm2col ? 27 : C;  // of dk1 as (taps, rows, F)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* y1s = xs + P::XE;    // y1, then g1, from y pixel (r0-3, c0-3)
  bf16* g3s = y1s + P::Y1E;  // from (r0-3, c0-3)
  bf16* y2s = g3s + P::Y1E;  // y2, then g2, from (r0-2, c0-2)
  float* red = reinterpret_cast<float*>(y2s + P::Y2E);  // [3][THREADS]
  float* dk1 = slots + (size_t)blockIdx.x * L::kSlot;
  float* dk2 = dk1 + 9 * C * F;
  float* dk3 = dk2 + 9 * F * F;
  float* db = dk3 + 9 * F * F;  // db1, db2, db3
  const int H2 = H / 2, W2 = W / 2;
  float kept[NU][L::NT][4] = {};
  float db_sum = 0.f;  // db[threadIdx.x] for threads below 3F
  PHASE_BEGIN();

  // owned pixel p = (jy, jx) = (p / TW, p % TW) at y pixel (r0 + jy, c0 + jx)
  const auto y1_at = [=](int p) {  // y1 / g1 at an owned pixel (+3)
    return y1s + ((p / TW + 3) * N1W + p % TW + 3) * FS;
  };
  // dk3: y2 at p + tap - 1 (local +1 + tap), g3 at local p + 3
  const auto y2_in = [=](int p) {
    return y2s + ((p / TW + 1) * N2W + p % TW + 1) * FS;
  };
  const auto y2_tap = [](int t) { return ((t / 3) * N2W + t % 3) * FS; };
  const auto g3_at = [=](int p) {
    return g3s + ((p / TW + 3) * N1W + p % TW + 3) * FS;
  };
  // dk2: y1 at p + tap - 1 (local +2 + tap), g2 at local p + 2
  const auto y1_in = [=](int p) {
    return y1s + ((p / TW + 2) * N1W + p % TW + 2) * FS;
  };
  const auto y1_tap = [](int t) { return ((t / 3) * N1W + t % 3) * FS; };
  const auto g2_at = [=](int p) {
    return y2s + ((p / TW + 2) * N2W + p % TW + 2) * FS;
  };
  // dk1: x at 2p + tap (local 2p + 6 + tap), or the im2col row of p
  const auto x_in = [=](int p) {
    return L::kIm2col
               ? xs + ((p / TW + 3) * N1W + p % TW + 3) * L::XS
               : xs + ((2 * (p / TW) + 6) * NXW + 2 * (p % TW) + 6) * L::XS;
  };
  const auto x_tap = [](int t) {
    return L::kIm2col ? 0 : ((t / 3) * NXW + t % 3) * L::XS;
  };
  constexpr int TAPS1 = L::kIm2col ? 1 : 9;

  for (int tile = sched[blockIdx.x]; tile < sched[blockIdx.x + 1]; ++tile) {
    [[maybe_unused]] const bool first = tile == sched[blockIdx.x];
    const int b = tile / (tiles_h * tiles_w);
    const int r0 = tile / tiles_w % tiles_h * TH, c0 = tile % tiles_w * TW;
    const bf16* xb = x + (int64_t)b * H * W * C;
    const int64_t img2 = (int64_t)b * H2 * W2 * F;
    PHASE_RESTART();

    // x (level 1: its raw rows, where y1 will be) by cp.async, while g3
    // is staged through registers
    if constexpr (L::kIm2col) {
      static_assert(P::NXH * (NXW + 1) * 3 <= P::Y1E, "raw rows");
      stage_rows_c3<THREADS, P::NXH, NXW + 1>(y1s, xb, 2 * r0 - 6,
                                              2 * c0 - 6, H, W);
    } else {
      stage_patch_async<C, P::NXH, NXW, L::XS>(xs, xb, 2 * r0 - 6,
                                               2 * c0 - 6, H, W);
    }
    stage_g3<F, P::N1H, N1W, FS>(g3s, g + img2, y3 + img2, r0 - 3, c0 - 3, H2,
                                 W2);
    ptx::cp_async_wait_all();
    __syncthreads();
    PHASE_MARK(1);
    if constexpr (L::kIm2col) {
      im2col_from<THREADS, P::N1H, N1W, NXW + 1, L::XS>(xs, y1s);
      __syncthreads();
      PHASE_MARK(1);
    }
    entry_conv<L, P::N1H, N1W, NXW>(y1s, xs, k1, b1, r0 - 3, c0 - 3, H2, W2);
    __syncthreads();
    PHASE_MARK(1);
    // y2 pixel r0 - 2 + i reads y1 pixels r0 - 3 + i + k: local i + k
    conv_s1<L, P::N2H, N2W, N1W>(
        y1s, k2, leaky_into<FS, N2W>(y2s, N2W, 0, r0 - 2, c0 - 2, H2, W2, b2));
    __syncthreads();
    PHASE_MARK(1);
    if constexpr (KEEP) {
      wgrad_kept<L::KCF, L::NT, NPIX, NW>(kept, 0, 9, y2_in, y2_tap, g3_at);
    } else {
      wgrad<L::KCF, L::NT, NPIX>(9, F, y2_in, y2_tap, g3_at, dk3, first);
    }
    __syncthreads();
    PHASE_MARK(1);
    // g2 over y2's region: g2(p) = sum_t g3(p + t - 1) k3t[t], in place of y2
    conv_s1<L, P::N2H, N2W, N1W>(
        g3s, k3t, mask_into<FS, N2W>(y2s, N2W, 0, r0 - 2, c0 - 2, H2, W2));
    __syncthreads();
    PHASE_MARK(1);
    if constexpr (KEEP) {
      wgrad_kept<L::KCF, L::NT, NPIX, NW>(kept, U3, 9, y1_in, y1_tap, g2_at);
    } else {
      wgrad<L::KCF, L::NT, NPIX>(9, F, y1_in, y1_tap, g2_at, dk2, first);
    }
    __syncthreads();
    PHASE_MARK(1);
    // g1 over y pixels from (r0 - 1, c0 - 1), (TH + 1) x (TW + 1), in place
    // of y1 (local +2): g1(p) = sum_t g2(p + t - 1) k2t[t]
    conv_s1<L, TH + 1, TW + 1, N2W>(
        y2s, k2t,
        mask_into<FS, TW + 1>(y1s, N1W, 2 * N1W + 2, r0 - 1, c0 - 1, H2, W2));
    __syncthreads();
    PHASE_MARK(1);
    if constexpr (KEEP) {
      wgrad_kept<L::KC1, L::NT, NPIX, NW>(kept, 2 * U3, TAPS1, x_in, x_tap,
                                          y1_at);
    } else {
      wgrad<L::KC1, L::NT, NPIX>(TAPS1, ROWS1, x_in, x_tap, y1_at, dk1,
                                 first);
    }
    if (dx != nullptr) {
      // one GEMM per parity class (a, e) of the owned x pixels (2(r0 + u) +
      // a, 2(c0 + v) + e): taps ky = a ? {1} : {0, 2}, likewise kx, reading
      // g1 at y pixel r0 + u + (a - ky) / 2
      bf16* dxb = dx + (int64_t)b * H * W * C;
      for (int cls = 0; cls < 4; ++cls) {
        const int a = cls >> 1, e = cls & 1;
        const int nkx = e ? 1 : 2;
        const auto ky_of = [=](int t) { return a ? 1 : 2 * (t / nkx); };
        const auto kx_of = [=](int t) { return e ? 1 : 2 * (t % nkx); };
        gemm_rows<L::KCF, L::NTX, 1>(
            NPIX, (a ? 1 : 2) * nkx, y1_at,
            [=](int t) {
              return ((a - ky_of(t)) / 2 * N1W + (e - kx_of(t)) / 2) * FS;
            },
            [=](int t) { return ky_of(t) * 3 + kx_of(t); }, k1t,
            [=](int q, int n, float v0, float v1) {
              const int gy = 2 * (r0 + q / TW) + a, gx = 2 * (c0 + q % TW) + e;
              if (gy >= H || gx >= W) return;
              bf16* d = dxb + ((int64_t)gy * W + gx) * C + n;
              if (n < C) d[0] = __float2bfloat16(v0);
              if (n + 1 < C) d[1] = __float2bfloat16(v1);
            });
      }
    }
    // db1..db3: each thread sums one output over a fixed share of the owned
    // pixels, then F threads add the shares in a fixed order
    {
      constexpr int PARTS = THREADS / F;
      const int f = threadIdx.x % F, part = threadIdx.x / F;
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int p = part; p < NPIX; p += PARTS) {
        const int jy = p / TW, jx = p % TW;
        s1 += __bfloat162float(y1s[((jy + 3) * N1W + jx + 3) * FS + f]);
        s2 += __bfloat162float(y2s[((jy + 2) * N2W + jx + 2) * FS + f]);
        s3 += __bfloat162float(g3s[((jy + 3) * N1W + jx + 3) * FS + f]);
      }
      red[threadIdx.x] = s1;
      red[THREADS + threadIdx.x] = s2;
      red[2 * THREADS + threadIdx.x] = s3;
    }
    __syncthreads();
    PHASE_MARK(1);
    if (threadIdx.x < 3 * F) {
      const int which = threadIdx.x / F, f = threadIdx.x % F;
      float s = 0.f;
      for (int part = 0; part < THREADS / F; ++part) {
        s += red[which * THREADS + part * F + f];
      }
      db_sum += s;
    }
    PHASE_MARK(1);
    // the next tile's staging touches neither `red` nor the slot
  }
  if constexpr (KEEP) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int u = warp + j * NW;
      int written = 0;
      if (u < U3) {
        written = unit_rows<L::NT, false>(dk3, F, u / L::KCF, u % L::KCF,
                                          kept[j]);
      } else if (u < 2 * U3) {
        written = unit_rows<L::NT, false>(dk2, F, (u - U3) / L::KCF,
                                          (u - U3) % L::KCF, kept[j]);
      } else if (u < 2 * U3 + U1) {
        written = unit_rows<L::NT, false>(dk1, ROWS1, (u - 2 * U3) / L::KC1,
                                          (u - 2 * U3) % L::KC1, kept[j]);
      }
      if ((threadIdx.x & 31) == 0) SLOT_BYTES(0, written);
    }
  }
  if (threadIdx.x < 3 * F) {
    db[threadIdx.x] = db_sum;
    SLOT_BYTES(0, 4);
  }
  PHASE_MARK(1);
}

template <typename K>
cudaError_t prepare(K kernel, size_t shared) {
  if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  }
  return cudaSuccess;
}

bool bad_shape(int B, int H, int W, int C, int F, int t) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || t <= 0 ||
         H % 2 || W % 2;
}

dim3 grid_of(int B, int H, int W, int t) {
  return dim3((W / 2 + t - 1) / t, (H / 2 + t - 1) / t, B);
}

// The tensor-core instantiations, one row per level: (C, F, forward tile
// rows, columns, reverse-sweep tile rows, columns, reverse-sweep blocks per
// SM, threads, and whether its weight gradients stay in registers (KEEP)).
// The wrapper reads its TC_LEVELS from these rows (ops/cuda/encoder_level.py),
// so keep one X(...) per line. Where one reverse-sweep block fills an SM it
// runs 16 warps, to hide the latency of its loads. KEEP holds a block's dk
// (20 KB at level 1, 92 KB at level 2) in its registers; level 3's (369 KB)
// does not fit, so its slot is updated in device memory.
#define TC_LEVELS(X)                    \
  X(3, 16, 16, 32, 16, 16, 2, 256, 1)   \
  X(16, 32, 16, 16, 16, 16, 1, 512, 1)  \
  X(32, 64, 8, 8, 8, 16, 1, 512, 0)

template <int C, int F, int TH, int TW>
cudaError_t launch_tc_fwd(const void* x, const void* k1, const void* b1,
                          const void* k2, const void* b2, const void* k3,
                          const void* b3, void* out, int B, int H, int W,
                          cudaStream_t s) {
  using P = FwdPlan<C, F, TH, TW>;
  const auto kernel = tc_fwd_kernel<C, F, TH, TW>;
  const size_t shared = P::kBytes + LEVEL_FWD_SMEM_PAD;
  const cudaError_t err = prepare(kernel, shared);
  if (err != cudaSuccess) return err;
  const int th = (H / 2 + TH - 1) / TH, tw = (W / 2 + TW - 1) / TW;
  kernel<<<B * th * tw, kThreads, shared, s>>>(
      (const bf16*)x, (const uint2*)k1, (const bf16*)b1, (const uint2*)k2,
      (const bf16*)b2, (const uint2*)k3, (const bf16*)b3, (bf16*)out, H, W,
      th, tw);
  return cudaGetLastError();
}

template <int C, int F, int TH, int TW, int MINB, int THREADS, bool KEEP>
cudaError_t launch_tc_bwd(const void* x, const void* y3, const void* g,
                          const void* k1, const void* b1, const void* k2,
                          const void* b2, const void* k3t, const void* k2t,
                          const void* k1t, void* dx, void* slots,
                          const void* sched, int blocks, int B, int H, int W,
                          cudaStream_t s) {
  using P = BwdPlan<C, F, TH, TW, THREADS>;
  const auto kernel = tc_bwd_kernel<C, F, TH, TW, MINB, THREADS, KEEP>;
  const cudaError_t err = prepare(kernel, P::kBytes);
  if (err != cudaSuccess) return err;
  const int th = (H / 2 + TH - 1) / TH, tw = (W / 2 + TW - 1) / TW;
  kernel<<<blocks, THREADS, P::kBytes, s>>>(
      (const bf16*)x, (const bf16*)y3, (const bf16*)g, (const uint2*)k1,
      (const bf16*)b1, (const uint2*)k2, (const bf16*)b2, (const uint2*)k3t,
      (const uint2*)k2t, (const uint2*)k1t, (bf16*)dx, (float*)slots,
      (const int*)sched, H, W, th, tw);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core tile each kernel takes for (C, F) and the element size, 0
// if none fits. The forward prefers a tile that leaves room for two blocks
// on an SM; the reverse sweep takes the largest that fits one block, since
// every tile writes a full set of weight-gradient partials.
extern "C" int encoder_level_fwd_tile(int C, int F, int elem_bytes) {
  const int t = pick_tile(fwd_shared_elems, C, F, elem_bytes, kTwoBlocksBytes);
  return t ? t : pick_tile(fwd_shared_elems, C, F, elem_bytes, kMaxSharedBytes);
}

extern "C" int encoder_level_bwd_tile(int C, int F, int elem_bytes) {
  return pick_tile(bwd_shared_elems, C, F, elem_bytes, kMaxSharedBytes);
}

// Each entry point launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). CUDA cores: is_bf16 selects
// bfloat16 over float32 for every tensor but the float32 partials; t is the
// tile that encoder_level_*_tile gave.
extern "C" int encoder_level_fwd(const void* x, const void* k1, const void* b1,
                                 const void* k2, const void* b2,
                                 const void* k3, const void* b3, void* out,
                                 int B, int H, int W, int C, int F, int t,
                                 int is_bf16, void* stream) {
  if (bad_shape(B, H, W, C, F, t)) return cudaErrorInvalidValue;
  const size_t elem = is_bf16 ? 2 : 4;
  const size_t shared = fwd_shared_elems(t, C, F) * elem;
  const dim3 grid = grid_of(B, H, W, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    using T = bf16;
    err = prepare(level_fwd_kernel<T>, shared);
    if (err != cudaSuccess) return err;
    level_fwd_kernel<T><<<grid, kFwdThreads, shared, s>>>(
        (const T*)x, (const T*)k1, (const T*)b1, (const T*)k2, (const T*)b2,
        (const T*)k3, (const T*)b3, (T*)out, H, W, C, F, t);
  } else {
    using T = float;
    err = prepare(level_fwd_kernel<T>, shared);
    if (err != cudaSuccess) return err;
    level_fwd_kernel<T><<<grid, kFwdThreads, shared, s>>>(
        (const T*)x, (const T*)k1, (const T*)b1, (const T*)k2, (const T*)b2,
        (const T*)k3, (const T*)b3, (T*)out, H, W, C, F, t);
  }
  return cudaGetLastError();
}

// kNT are the kernels as (3, 3, Cout, Cin): k1T (3,3,F,C), k2T and k3T
// (3,3,F,F). The partials hold one slot per tile, tiles numbered
// (b * tiles_h + tile_row) * tiles_w + tile_col.
extern "C" int encoder_level_bwd(
    const void* x, const void* y3, const void* g, const void* k1,
    const void* b1, const void* k2, const void* b2, const void* k3,
    const void* b3, const void* k1T, const void* k2T, const void* k3T,
    void* dx, void* pk1, void* pb1, void* pk2, void* pb2, void* pk3,
    void* pb3, int B, int H, int W, int C, int F, int t, int is_bf16,
    void* stream) {
  if (bad_shape(B, H, W, C, F, t)) return cudaErrorInvalidValue;
  const size_t elem = is_bf16 ? 2 : 4;
  const size_t shared = bwd_shared_elems(t, C, F) * elem;
  const dim3 grid = grid_of(B, H, W, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define LEVEL_BWD_LAUNCH(T)                                                   \
  err = prepare(level_bwd_kernel<T>, shared);                                 \
  if (err != cudaSuccess) return err;                                         \
  level_bwd_kernel<T><<<grid, kBwdThreads, shared, s>>>(                      \
      (const T*)x, (const T*)y3, (const T*)g, (const T*)k1, (const T*)b1,     \
      (const T*)k2, (const T*)b2, (const T*)k3, (const T*)b3, (const T*)k1T,  \
      (const T*)k2T, (const T*)k3T, (T*)dx, (float*)pk1, (float*)pb1,         \
      (float*)pk2, (float*)pb2, (float*)pk3, (float*)pb3, H, W, C, F, t);
  if (is_bf16) {
    LEVEL_BWD_LAUNCH(bf16)
  } else {
    LEVEL_BWD_LAUNCH(float)
  }
#undef LEVEL_BWD_LAUNCH
  return cudaGetLastError();
}

// Tensor cores, bfloat16: (th, tw) is the tile of TC_LEVELS for (C, F);
// any other (C, F, th, tw) is refused. The weights come packed in mma
// fragment order (the wrapper's pack_b): k1 (9 taps of C rows, or one of
// 32 im2col rows), k2, k3 (9 of F).
extern "C" int encoder_level_tc_fwd(const void* x, const void* k1,
                                    const void* b1, const void* k2,
                                    const void* b2, const void* k3,
                                    const void* b3, void* out, int B, int H,
                                    int W, int C, int F, int th, int tw,
                                    void* stream) {
  if (bad_shape(B, H, W, C, F, 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_FWD(c, f, fth, ftw, bth, btw, minb, nt, keep)                  \
  if (C == c && F == f && th == fth && tw == ftw)                           \
    return launch_tc_fwd<c, f, fth, ftw>(x, k1, b1, k2, b2, k3, b3, out, B, \
                                         H, W, s);
  TC_LEVELS(TC_FWD)
#undef TC_FWD
  return cudaErrorInvalidValue;
}

// sched (int32, blocks + 1 entries, on the device): block i walks tiles
// sched[i] .. sched[i+1] - 1 and writes slot i of `slots` (blocks x kSlot
// float32), every block at least one tile. k3t, k2t, k1t as the wrapper's
// tc_operands packs them.
extern "C" int encoder_level_tc_bwd(
    const void* x, const void* y3, const void* g, const void* k1,
    const void* b1, const void* k2, const void* b2, const void* k3t,
    const void* k2t, const void* k1t, void* dx, void* slots, const void* sched,
    int blocks, int B, int H, int W, int C, int F, int th, int tw,
    void* stream) {
  if (bad_shape(B, H, W, C, F, 1) || blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TC_BWD(c, f, fth, ftw, bth, btw, minb, nt, keep)                    \
  if (C == c && F == f && th == bth && tw == btw)                             \
    return launch_tc_bwd<c, f, bth, btw, minb, nt, keep>(                     \
        x, y3, g, k1, b1, k2, b2, k3t, k2t, k1t, dx, slots, sched, blocks, B, \
        H, W, s);
  TC_LEVELS(TC_BWD)
#undef TC_BWD
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of a tensor-core block for (C, F) in TC_LEVELS:
// the forward's (bwd = 0) or the reverse sweep's; -1 for other widths.
extern "C" int encoder_level_tc_smem(int C, int F, int bwd) {
#define TC_SMEM(c, f, fth, ftw, bth, btw, minb, nt, keep) \
  if (C == c && F == f)                                    \
    return (int)(bwd ? BwdPlan<c, f, bth, btw, nt>::kBytes \
                     : FwdPlan<c, f, fth, ftw>::kBytes);
  TC_LEVELS(TC_SMEM)
#undef TC_SMEM
  return -1;
}

// Blocks of the tensor-core forward (bwd = 0) or reverse sweep for (C, F)
// that the card keeps resident on one SM at the shared memory they launch
// with; -1 for other widths, or minus the cudaError_t of the query.
extern "C" int encoder_level_tc_blocks_per_sm(int C, int F, int bwd) {
  int n = 0;
  cudaError_t err = cudaSuccess;
#define TC_OCC(c, f, fth, ftw, bth, btw, minb, nt, keep)                     \
  if (C == c && F == f) {                                                    \
    if (bwd) {                                                               \
      const auto k = tc_bwd_kernel<c, f, bth, btw, minb, nt, keep>;          \
      const size_t shared = BwdPlan<c, f, bth, btw, nt>::kBytes;             \
      err = prepare(k, shared);                                              \
      if (err == cudaSuccess)                                                \
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, nt,       \
                                                            shared);         \
    } else {                                                                 \
      const auto k = tc_fwd_kernel<c, f, fth, ftw>;                          \
      const size_t shared =                                                  \
          FwdPlan<c, f, fth, ftw>::kBytes + LEVEL_FWD_SMEM_PAD;              \
      err = prepare(k, shared);                                              \
      if (err == cudaSuccess)                                                \
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads, \
                                                            shared);         \
    }                                                                        \
    return err == cudaSuccess ? n : -(int)err;                               \
  }
  TC_LEVELS(TC_OCC)
#undef TC_OCC
  return -1;
}

extern "C" const char* encoder_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef LEVEL_PHASES
// The counters of a measurement build: phase_cycles (2 x 16) then
// slot_bytes (2), as unsigned 64-bit values into `host`; and their reset.
extern "C" int level_counters_read(void* host) {
  cudaError_t err =
      cudaMemcpyFromSymbol(host, phase_cycles, sizeof(phase_cycles));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(
      static_cast<char*>(host) + sizeof(phase_cycles), slot_bytes,
      sizeof(slot_bytes));
}

extern "C" int level_counters_zero() {
  static const unsigned long long zero[34] = {0};
  cudaError_t err =
      cudaMemcpyToSymbol(phase_cycles, zero, sizeof(phase_cycles));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(slot_bytes, zero, sizeof(slot_bytes));
}
#endif
