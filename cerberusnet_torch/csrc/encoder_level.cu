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
// and k2, k3 (3,3,F,F) are HWIO-contiguous, the biases (F,), all in the
// working type of x. Each conv's SAME padding zero-pads its own input, so a
// value of y1 or y2 that lies outside the image is 0, never leaky(bias).
//
// level_fwd_kernel replaces _level_kernel (host function _level_pallas_raw)
// and level_bwd_kernel replaces _level_bwd_kernel (_level_pallas_bwd), both
// in cerberusnet_tpu/ops/pallas/encoder_level.py. The TPU kernels walked
// row strips in a W-folded layout that fitted the TPU's lanes and 16 MB of
// VMEM; here a block owns a square tile of output pixels and keeps its
// intermediates in shared memory, as the TPU kernels kept theirs in VMEM.
//
// Forward. One block per (image, T x T output tile). It stages the input
// patch the tile needs (2T+9 rows and columns of x, zero outside the
// image), computes y1 over the tile plus a 2-pixel halo and y2 over the
// tile plus a 1-pixel halo into shared memory, then the tile's output.
// Every value is a float32 sum of products plus the bias in float32,
// LeakyReLU in float32, rounded once to the working type: y1 and y2 are
// kept in the working type, as the TPU kernel keeps them (its scratch).
//
// Reverse sweep. One block per (image, T x T tile of y pixels it owns). It
// recomputes y1 (tile plus a 3-pixel halo) and y2 (plus 2) from x, then
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
// Cotangents outside the image are set to 0: they do not exist in the true
// transpose. g1..g3 are kept in the working type, as the TPU kernel keeps
// them; every product and sum is float32. dk and db are written per tile
// as float32 partial sums of the owned pixels, so no halo pixel counts
// twice; the wrapper sums the partials over tiles (the TPU kernel's
// per-tile outputs, summed outside it), so no atomics are needed and the
// result does not depend on the order blocks run in.
//
// Bound on an H100 SXM. The three convolutions of a level are
// 2 * (H/2)(W/2) * 9 * F * (C + 2F) FLOP per image: at 512x1024, 1.32,
// 1.51 and 1.51 GFLOP for levels 1-3 (C = 3, 16, 32). On the tensor cores
// (989 TFLOP/s bf16) level 3 at batch 3 needs 4.5 us of operations against
// 2.8 us of bytes (x read once, y3 written once); levels 1-2 are bound by
// bytes (6.6 and 5.6 us). The reverse sweep does about 2.6x the forward's
// operations and reads x, y3 and g and writes dx. These kernels run on the
// CUDA cores: each thread owns one output value and loops over 9 taps and
// the input channels, reading the staged operand from shared memory and
// the weight from global memory (L1/L2), two loads per multiply-add, and
// the halos recompute up to (T+4)^2/T^2 of the tile's y1. They are a
// simple first version, far above that bound: measured with chip_smoke.py
// (bf16, NVIDIA H100 80GB HBM3 at 700 W), the forward takes 1.1-1.5 ms a
// level at batch 3, 4-17x the three cuDNN convolutions it replaces, and the
// reverse sweep 5.3-7.1 ms a level at batch 6 (PERF.md). wgmma on staged
// tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSharedBytes = 232448;       // 227 KB a block may opt into
constexpr size_t kTwoBlocksBytes = 113 * 1024;   // two blocks on one SM
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kTiles[] = {16, 8, 4, 2, 1};

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

__device__ __forceinline__ float leaky(float v) {
  return v > 0.f ? v : 0.1f * v;
}
__device__ __forceinline__ float mask(float y) { return y > 0.f ? 1.f : 0.1f; }

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

// ---------------------------------------------------------------- forward

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

// --------------------------------------------------------------- backward

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

}  // namespace

// The tile each kernel takes for (C, F) and the element size, 0 if none
// fits. The forward prefers a tile that leaves room for two blocks on an
// SM; the reverse sweep takes the largest that fits one block, since every
// tile writes a full set of weight-gradient partials.
extern "C" int encoder_level_fwd_tile(int C, int F, int elem_bytes) {
  const int t = pick_tile(fwd_shared_elems, C, F, elem_bytes, kTwoBlocksBytes);
  return t ? t : pick_tile(fwd_shared_elems, C, F, elem_bytes, kMaxSharedBytes);
}

extern "C" int encoder_level_bwd_tile(int C, int F, int elem_bytes) {
  return pick_tile(bwd_shared_elems, C, F, elem_bytes, kMaxSharedBytes);
}

// Each entry point launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success). is_bf16 selects bfloat16
// over float32 for every tensor but the float32 partials; t is the tile
// that encoder_level_*_tile gave.
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
    using T = __nv_bfloat16;
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
    LEVEL_BWD_LAUNCH(__nv_bfloat16)
  } else {
    LEVEL_BWD_LAUNCH(float)
  }
#undef LEVEL_BWD_LAUNCH
  return cudaGetLastError();
}

extern "C" const char* encoder_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
