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
// Design against that bound. One block owns a tile of kTileW pixels of one
// output row and stages in shared memory, as float32, the operands the tile
// needs: the forward stages the f1 tile and the f2 pixels of the tile's
// window (with the horizontal halo), once per block for the 1-D kernel and
// once per window row for the 2-D kernel, so each block reads its inputs
// from device memory about once (the 2-D kernel's (2d+1) re-reads of an f2
// row across neighbouring output rows come from L2, which holds every
// level's operands). Shared rows of features are padded to C+1 floats so
// neighbouring lanes hit different banks. The forward gives each thread one
// (pixel, displacement) dot product with a C-loop of fused multiply-adds,
// collects the tile's outputs in shared memory and writes them back as one
// contiguous run, because in NHWC the outputs of a tile of one row are
// contiguous. The backward kernels give each thread (pixel, channel)
// outputs, with the displacement loop inside: lanes of a warp hold
// neighbouring channels, so their feature reads are conflict-free and
// their g read is a broadcast, and their stores are contiguous. The 2-D
// backward kernels stage one window row at a time and keep the running
// sums in shared memory between rows. Rows outside the frame are skipped;
// columns outside it are staged as zeros and multiplied.
//
// Measured against that bound (chip_smoke.py, bf16, NVIDIA H100 80GB HBM3 at
// 700 W) the forward kernels are far from it: the 2-D kernel runs 23x (level
// 2) to about 1700x (level 6) its bound, the 1-D kernel 13x to about 690x.
// Why is not measured yet. Known from the launch shape: a level gets one
// block per 32 pixels of a row, so the coarse levels launch fewer blocks
// than the card has SMs (8 blocks at level 6 for 132 SMs). Not yet told
// apart: staging, where each thread waits on one global load per loop trip,
// and the C-loop, which reads two shared operands per multiply-add. The
// backward kernels share the launch shape and run 10x (1-D, level 2) to
// about 570x (2-D, level 6) their bounds at batch 2 (PERF.md). At the DCV
// heads' level 3 (C=64, d=D=4) a dilation widens the staged window row
// (kTileW + 2*d*dil columns: 96 at dilation 8, 43.6 KB of shared memory
// for the 2-D forward) while the window rows outside the frame are
// skipped; the 2-D forward at dilation 8 takes 1.5x its dilation-1 time.
// There the 1-D forward at D=4 (160 threads a block) is slower than at
// D=12 (416 threads) on the same rows, though it computes a third of the
// products: a hint that staging, not the dot products, sets its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  }
  __syncthreads();
  store_tile(out + ((int64_t)row * W + x0) * K, outs, npix * K);
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

  stage_row(f1s, f1 + row_off, x0, kTileW, W, C);
  stage_row(f2s, f2 + row_off, x0 - R, kTileW + R, W, C);
  __syncthreads();
  for (int i = threadIdx.x; i < kTileW * K; i += blockDim.x) {
    const int p = i % kTileW;
    const int k = i / kTileW;
    if (p >= npix) continue;
    // f2 pixel x0 + p - k * dil sits at window column p + R - k * dil
    const float acc = dot(f1s + p * stride, f2s + (p + R - k * dil) * stride, C);
    outs[p * K + k] = acc / (float)C;
  }
  __syncthreads();
  store_tile(out + ((int64_t)row * W + x0) * K, outs, npix * K);
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

  stage_run(gs, g + ((int64_t)row * W + x0) * K, npix * K, kTileW * K);
  for (int i = threadIdx.x; i < n; i += blockDim.x) sums[i] = 0.f;
  for (int oy = 0; oy < nx; ++oy) {
    const int yy = y + (oy - d) * dil;
    if (yy < 0 || yy >= H) continue;  // the same for the whole block
    __syncthreads();  // gs staged; f2s no longer read by the last row
    stage_row(f2s, f2 + (row + (yy - y)) * row_elems, x0 - R, kTileW + 2 * R,
              W, C);
    __syncthreads();
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
  }
  T* dst = df1 + ((int64_t)row * W + x0) * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = from_f32<T>(sums[i] / (float)C);
  }
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
  }
  T* dst = df2 + ((int64_t)row * W + x0) * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = from_f32<T>(sums[i] / (float)C);
  }
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

  stage_run(gs, g + ((int64_t)row * W + x0) * K, npix * K, kTileW * K);
  stage_row(f2s, f2 + (int64_t)row * W * C, x0 - R, kTileW + R, W, C);
  __syncthreads();
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

  stage_row(f1s, f1 + (int64_t)row * W * C, x0, nw, W, C);
  stage_run(gw, g + ((int64_t)row * W + x0) * K, min(nw, W - x0) * K, nw * K);
  __syncthreads();
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
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int C, int disp, int dil) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || disp < 0 || dil < 1;
}

}  // namespace

// Each entry point launches on `stream` without synchronising and returns the
// cudaError_t of the launch (0 on success). is_bf16 selects bfloat16 over
// float32 for all three tensors. a and b are (f1, f2) for a forward and
// (g, f2) or (g, f1) for a backward; B, H, W, C are the features' shape.
#define CORR_ENTRY(name)                                                      \
  extern "C" int name(const void* a, const void* b, void* out, int B, int H,  \
                      int W, int C, int disp, int dil, int is_bf16,           \
                      void* stream) {                                         \
    if (bad_shape(B, H, W, C, disp, dil)) return cudaErrorInvalidValue;       \
    const Shape shape = shape_##name(C, disp, dil);                           \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    return is_bf16 ? launch<__nv_bfloat16>(name##_kernel<__nv_bfloat16>,      \
                                           shape, a, b, out, B, H, W, C,      \
                                           disp, dil, s)                      \
                   : launch<float>(name##_kernel<float>, shape, a, b, out, B, \
                                   H, W, C, disp, dil, s);                    \
  }

CORR_ENTRY(corr2d_fwd)
CORR_ENTRY(corr1d_fwd)
CORR_ENTRY(corr2d_bwd_f1)
CORR_ENTRY(corr2d_bwd_f2)
CORR_ENTRY(corr1d_bwd_f1)
CORR_ENTRY(corr1d_bwd_f2)

extern "C" const char* corr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
