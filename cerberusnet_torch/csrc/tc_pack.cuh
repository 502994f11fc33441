// The tensor-core forward's weight packing for the fused encoder level
// (encoder_level.cu). Plain C++ apart from the kernel's qualifiers and
// indices, so that a test can compile it with g++.
#pragma once

#include <stdint.h>

namespace {

// The tensor-core forward's weights in mma.m16n8k16 B-fragment order,
// packed on the device from the HWIO kernels: each matrix (T, K, N) (k1 as
// 9 taps of C rows, or at C = 3 one tap of 27 im2col rows, k = 3 (3 ky +
// kx) + c; k2 and k3 as 9 taps of F rows) with K padded to a multiple of 16
// and N to 8 with zeros, as (T, K/16, N/8, 32 lanes, 4): lane 4g + q holds
// rows 2q, 2q+1, 2q+8, 2q+9 of column g of each 16 x 8 block, the first two
// in its first 32-bit register, lowest row in the low half. Both bindings
// of the forward (ops/cuda/encoder_level.py, csrc/cerberus_ops.cc) pack
// through encoder_level.cu's encoder_level_tc_fwd_pack, which launches
// tc_pack_kernel; the wrapper's pack_b packs the reverse sweep's operands
// the same way. tests/test_torch_encoder_level_gemm.py runs this kernel on
// the CPU (g++, one thread per index) against pack_b, and chip_smoke.py
// holds the two bit-equal on the card.
struct PackedMatrix {
  const uint16_t* w;  // (T, K, N) row-major, the HWIO kernel's bits
  uint16_t* out;      // (T, Kp/16, Np/8, 8, 4, 2, 2)
  int T, K, N;
};

struct TcFwdOperands {
  PackedMatrix m[3];  // k1, k2, k3
};

__host__ __device__ inline int64_t packed_elems(int T, int K, int N) {
  return (int64_t)T * ((K + 15) / 16 * 16) * ((N + 7) / 8 * 8);
}

// blockIdx.y picks the matrix; each thread writes one packed value.
__global__ void tc_pack_kernel(TcFwdOperands ops) {
  const PackedMatrix p = ops.m[blockIdx.y];
  const int KC = (p.K + 15) / 16, NT = (p.N + 7) / 8;
  const int64_t n = packed_elems(p.T, p.K, p.N);
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += (int64_t)gridDim.x * blockDim.x) {
    // o = ((((((t KC + kc) NT + nt) 8 + g) 4 + q) 2 + h) 2 + e
    const int e = o & 1, h = (o >> 1) & 1, q = (o >> 2) & 3, g = (o >> 4) & 7;
    int64_t rest = o >> 7;
    const int nt = rest % NT;
    rest /= NT;
    const int kc = rest % KC, t = rest / KC;
    const int k = 16 * kc + 8 * h + 2 * q + e, col = 8 * nt + g;
    p.out[o] = k < p.K && col < p.N
                   ? p.w[((int64_t)t * p.K + k) * p.N + col]
                   : (uint16_t)0;
  }
}

// Elements of a level's packed k1, k2 and k3 together.
inline int64_t tc_fwd_packed_elems(int C, int F) {
  return packed_elems(C == 3 ? 1 : 9, C == 3 ? 9 * C : C, F) +
         2 * packed_elems(9, F, F);
}

// The (T, K, N) matrices of a level's forward weights, packed one after
// another into `packed`: k1, then k2, then k3.
TcFwdOperands tc_fwd_operands(const void* k1, const void* k2, const void* k3,
                              void* packed, int C, int F) {
  const int t1 = C == 3 ? 1 : 9, r1 = C == 3 ? 9 * C : C;
  uint16_t* out = static_cast<uint16_t*>(packed);
  TcFwdOperands ops;
  ops.m[0] = {static_cast<const uint16_t*>(k1), out, t1, r1, F};
  out += packed_elems(t1, r1, F);
  ops.m[1] = {static_cast<const uint16_t*>(k2), out, 9, F, F};
  out += packed_elems(9, F, F);
  ops.m[2] = {static_cast<const uint16_t*>(k3), out, 9, F, F};
  return ops;
}

}  // namespace
