// Correlation cost-volume forward kernels for Hopper (sm_90a).
//
// Two kernels, both on NHWC-contiguous tensors in float32 or bfloat16:
//
//   corr2d_fwd: out(x, k) = (1/C) * sum_c f1_c(x) * f2_c(x + dil*o),
//               o in {-d..d}^2, k = (o_y + d) * (2d + 1) + (o_x + d).
//               Replaces the TPU kernel cerberusnet_tpu/ops/pallas/correlation.py
//               _corr2d_fwd_kernel (host function _corr2d_forward).
//   corr1d_fwd: out(x, k) = (1/C) * sum_c f1_c(y, x) * f2_c(y, x - dil*k),
//               k in 0..D. Replaces _corr1d_fwd_kernel (host function
//               _corr1d_forward) in the same file.
//
// f2 samples outside the frame contribute zero; the kernels mask them while
// staging, so the host pads nothing. Products and sums run in float32, the
// sum is divided by C once and cast once to the input type, as the plain
// versions in cerberusnet_torch/ops/correlation.py do.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 on the CUDA cores): at
// the flow head's hottest call (level 2 of a 512x1024 frame: 128x256 pixels,
// C=32, 81 displacements, bf16) the 2-D kernel must move 9.50 MB (both inputs
// read once, the output written once), 2.8 us, and do 0.17 GFLOP, 2.5 us: it
// is bound by bytes, by a small margin. The 1-D kernel at its hottest call
// (same shape, 25 displacements) moves 5.83 MB, 1.7 us, against 0.05 GFLOP,
// 0.8 us: bound by bytes. The operation counts take only the products whose
// f2 sample lies in the frame, since an out-of-frame product is zero by
// definition; at the coarse levels, where the window is large against the
// frame, this makes the 2-D kernel bound by operations.
//
// Design against that bound. One block owns a tile of kTileW pixels of one
// output row. It stages the f1 tile and the f2 pixels the tile's window needs
// (with the horizontal halo) in shared memory as float32, once per block for
// the 1-D kernel and once per window row for the 2-D kernel, so each block
// reads its inputs from device memory about once (the 2-D kernel's (2d+1)
// re-reads of an f2 row across neighbouring output rows come from L2, which
// holds every level's operands). Shared rows are padded to C+1 floats so the
// 32 lanes of a warp, which handle 32 neighbouring pixels, hit 32 different
// banks. Each thread computes one (pixel, displacement) dot product with a
// C-loop of fused multiply-adds. The block collects its outputs in shared
// memory and writes them back as one contiguous run, because in NHWC the
// outputs of a tile of one row are contiguous. Rows of f2 outside the frame
// are skipped; columns outside it are staged as zeros and multiplied.
//
// Measured against that bound (chip_smoke.py, bf16, NVIDIA H100 80GB HBM3 at
// 700 W) this first version is far from it: the 2-D kernel runs 23x (level 2)
// to about 1700x (level 6) its bound, the 1-D kernel 13x to about 690x. Why is
// not measured yet. Known from the launch shape: a level gets one block per
// 32 pixels of a row, so the coarse levels launch fewer blocks than the card
// has SMs (8 blocks at level 6 for 132 SMs). Not yet told apart: staging, where
// each thread waits on one global load per loop trip, and the C-loop, which
// reads two shared operands per multiply-add.

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
                                  int W, int C, int D, int dil) {
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

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t shared_bytes) {
  if (shared_bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (shared_bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)shared_bytes);
  }
  return cudaSuccess;
}

bool bad_shape(int B, int H, int W, int C, int disp, int dil) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || disp < 0 || dil < 1;
}

template <typename T>
cudaError_t launch2d(const void* f1, const void* f2, void* out, int B, int H,
                     int W, int C, int d, int dil, cudaStream_t stream) {
  const int nx = 2 * d + 1;
  const size_t shared = sizeof(float) *
      ((size_t)(2 * kTileW + 2 * d * dil) * (C + 1) + (size_t)kTileW * nx * nx);
  cudaError_t err = prepare(corr2d_fwd_kernel<T>, shared);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (W + kTileW - 1) / kTileW);
  const int threads = kTileW * nx < kMaxThreads ? kTileW * nx : kMaxThreads;
  corr2d_fwd_kernel<T><<<grid, threads, shared, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), H, W, C, d, dil);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch1d(const void* f1, const void* f2, void* out, int B, int H,
                     int W, int C, int D, int dil, cudaStream_t stream) {
  const int K = D + 1;
  const size_t shared = sizeof(float) *
      ((size_t)(2 * kTileW + D * dil) * (C + 1) + (size_t)kTileW * K);
  cudaError_t err = prepare(corr1d_fwd_kernel<T>, shared);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (W + kTileW - 1) / kTileW);
  const int threads = kTileW * K < kMaxThreads ? kTileW * K : kMaxThreads;
  corr1d_fwd_kernel<T><<<grid, threads, shared, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), W, C, D, dil);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` without synchronising and returns the
// cudaError_t of the launch (0 on success). is_bf16 selects bfloat16 over
// float32 for all three tensors.
int corr2d_fwd(const void* f1, const void* f2, void* out, int B, int H, int W,
               int C, int max_disp, int dilation, int is_bf16, void* stream) {
  if (bad_shape(B, H, W, C, max_disp, dilation)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch2d<__nv_bfloat16>(f1, f2, out, B, H, W, C, max_disp,
                                           dilation, s)
                 : launch2d<float>(f1, f2, out, B, H, W, C, max_disp, dilation,
                                   s);
}

int corr1d_fwd(const void* f1, const void* f2, void* out, int B, int H, int W,
               int C, int max_disp, int dilation, int is_bf16, void* stream) {
  if (bad_shape(B, H, W, C, max_disp, dilation)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch1d<__nv_bfloat16>(f1, f2, out, B, H, W, C, max_disp,
                                           dilation, s)
                 : launch1d<float>(f1, f2, out, B, H, W, C, max_disp, dilation,
                                   s);
}

const char* corr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
