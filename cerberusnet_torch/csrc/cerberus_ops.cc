// The hand kernels' forwards as C++ operators of the namespace cerberus, for
// a process without Python: the C++ runner of an exported program
// (runner.cc) loads this library, and the cerberus:: operators that an
// AOTInductor package holds resolve here through the dispatcher.
//
//   cerberus::corr2d_fwd         K1, K7 (dilated)   csrc/correlation.cu
//   cerberus::corr1d_fwd         K4, K8 (dilated)   csrc/correlation.cu
//   cerberus::encoder_level_fwd  K9                 csrc/encoder_level.cu
//
// No kernel is here: each operator calls the C entry point of the
// nvcc-built library that the Python wrappers (ops/cuda/correlation.py,
// ops/cuda/encoder_level.py) call through ctypes, and does what its wrapper
// does around the call: the same checks, raising with the same facts; every
// input made contiguous (Inductor may hand over other strides); the output
// allocated with at::empty; the launch on the current CUDA stream, without
// synchronising; a raise with the library's error string when the launch
// is refused. K9's tensor-core design packs its weights into mma fragment
// order itself, in a workspace that its caller allocates, and takes its
// tiles from TC_LEVELS (tc_levels.cuh).
//
// The schemas are those that ops/library.py's custom_ops infer, copied
// character for character (tests/test_torch_runner_schema.py holds them):
// a package written from a Python process names its operators by them.
// Only the CUDA implementations are registered, so an operator called on
// another device raises; no plain version is here. The training kernels
// (K2, K3, K5, K6, K10) are not defined: no inference artifact holds them.
//
// Each operator counts its launches where the launch succeeded;
// cerberus_ops_launches(name) reads a count (-1 for an unknown name).
//
// Built with g++ against ATen's and c10-cuda's headers by
// cerberusnet_torch/export/runner.py, linked to the two kernel libraries.
// Never load it into a Python process that imported ops/library.py: both
// define the namespace cerberus.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <cstring>

#include "tc_levels.cuh"

// the C entry points of libcorrelation and libencoder_level
extern "C" {
int corr2d_fwd(const void* a, const void* b, void* out, int B, int H, int W,
               int C, int disp, int dil, int is_bf16, void* stream);
int corr1d_fwd(const void* a, const void* b, void* out, int B, int H, int W,
               int C, int disp, int dil, int is_bf16, void* stream);
const char* corr_error_string(int err);
int encoder_level_fwd(const void* x, const void* k1, const void* b1,
                      const void* k2, const void* b2, const void* k3,
                      const void* b3, void* out, int B, int H, int W, int C,
                      int F, int t, int is_bf16, void* stream);
int encoder_level_tc_fwd(const void* x, const void* k1, const void* b1,
                         const void* k2, const void* b2, const void* k3,
                         const void* b3, void* out, void* workspace, int B,
                         int H, int W, int C, int F, int th, int tw,
                         void* stream);
int64_t encoder_level_tc_fwd_workspace(int C, int F);
int encoder_level_fwd_tile(int C, int F, int elem_bytes);
const char* encoder_level_error_string(int err);
}

namespace {

std::atomic<int64_t> corr2d_fwd_launches{0};
std::atomic<int64_t> corr1d_fwd_launches{0};
std::atomic<int64_t> encoder_level_fwd_launches{0};

void* current_stream(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

bool is_kernel_type(at::ScalarType t) {
  return t == at::kFloat || t == at::kBFloat16;
}

// ---------------------------------------------------------- correlations

// ops/cuda/correlation.py _check: f is a (B,H,W,C) feature map, a the
// other one (nk == C).
void check_corr(const at::Tensor& a, const at::Tensor& f, int64_t nk,
                int64_t max_disp, int64_t dilation) {
  TORCH_CHECK_VALUE(f.is_cuda() && a.device() == f.device(),
                    "CUDA correlation needs both tensors on one CUDA device, "
                    "got ", a.device(), " and ", f.device());
  TORCH_CHECK_VALUE(is_kernel_type(f.scalar_type()) &&
                        a.scalar_type() == f.scalar_type(),
                    "CUDA correlation takes float32 or bfloat16, got ",
                    a.scalar_type(), " and ", f.scalar_type());
  TORCH_CHECK_VALUE(f.dim() == 4 && a.dim() == 4 &&
                        a.sizes().slice(0, 3).equals(f.sizes().slice(0, 3)) &&
                        a.size(3) == nk,
                    "CUDA correlation needs (B,H,W,", nk,
                    ") and (B,H,W,C) tensors, got ", a.sizes(), " and ",
                    f.sizes());
  TORCH_CHECK_VALUE(max_disp >= 0 && dilation >= 1, "bad max_disp=",
                    max_disp, " / dilation=", dilation);
}

using CorrEntry = int (*)(const void*, const void*, void*, int, int, int, int,
                          int, int, int, void*);

at::Tensor correlation(const char* name, CorrEntry entry,
                       std::atomic<int64_t>& launches, const at::Tensor& f1_in,
                       const at::Tensor& f2_in, int64_t max_disp,
                       int64_t dilation, int64_t out_channels) {
  const at::Tensor f1 = f1_in.contiguous(), f2 = f2_in.contiguous();
  check_corr(f1, f2, f2.dim() == 4 ? f2.size(3) : -1, max_disp, dilation);
  const int64_t b = f2.size(0), h = f2.size(1), w = f2.size(2),
                c = f2.size(3);
  at::Tensor out = at::empty({b, h, w, out_channels}, f2.options());
  const c10::cuda::CUDAGuard guard(f2.device());
  const int err = entry(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w,
                        c, max_disp, dilation,
                        f2.scalar_type() == at::kBFloat16, current_stream(f2));
  TORCH_CHECK(err == 0, name, " launch failed: ", corr_error_string(err),
              " (shape ", f2.sizes(), ", max_disp ", max_disp, ", dilation ",
              dilation, ", ", f2.scalar_type(), ")");
  ++launches;
  return out;
}

at::Tensor corr2d_fwd_op(const at::Tensor& f1, const at::Tensor& f2,
                         c10::SymInt max_disp, c10::SymInt dilation) {
  const int64_t d = max_disp.expect_int();
  return correlation("corr2d_fwd", corr2d_fwd, corr2d_fwd_launches, f1, f2, d,
                     dilation.expect_int(), (2 * d + 1) * (2 * d + 1));
}

at::Tensor corr1d_fwd_op(const at::Tensor& f1, const at::Tensor& f2,
                         c10::SymInt max_disp, c10::SymInt dilation) {
  const int64_t d = max_disp.expect_int();
  return correlation("corr1d_fwd", corr1d_fwd, corr1d_fwd_launches, f1, f2, d,
                     dilation.expect_int(), d + 1);
}

// ------------------------------------------------------ encoder level

// The forward tile (rows, columns) of the tensor-core kernel for (C, F),
// false for widths outside TC_LEVELS.
bool tc_forward_tile(int64_t c, int64_t f, int* th, int* tw) {
#define TC_TILE(c_, f_, fth, ftw, bth, btw, minb, nt, keep) \
  if (c == c_ && f == f_) {                                \
    *th = fth;                                             \
    *tw = ftw;                                             \
    return true;                                           \
  }
  TC_LEVELS(TC_TILE)
#undef TC_TILE
  return false;
}

// ops/cuda/encoder_level.py _check, for the forward: x (B,H,W,C), the
// kernels HWIO and the biases (F,).
void check_level(const at::Tensor& x, const at::Tensor (&p)[6]) {
  const at::Tensor& k1 = p[0];
  TORCH_CHECK_VALUE(x.dim() == 4 && k1.dim() == 4,
                    "encoder level needs x (B,H,W,C) and HWIO kernels, got ",
                    x.sizes(), " and ", k1.sizes());
  const int64_t h = x.size(1), w = x.size(2), c = x.size(3), f = k1.size(3);
  TORCH_CHECK_VALUE(h % 2 == 0 && w % 2 == 0,
                    "CUDA encoder level needs even H and W: ", x.sizes());
  const std::vector<std::vector<int64_t>> want = {
      {3, 3, c, f}, {f}, {3, 3, f, f}, {f}, {3, 3, f, f}, {f}};
  for (int i = 0; i < 6; ++i) {
    TORCH_CHECK_VALUE(p[i].sizes().equals(want[i]),
                      "encoder level kernel or bias ", i, " has shape ",
                      p[i].sizes(), ", expected ", at::IntArrayRef(want[i]));
  }
  TORCH_CHECK_VALUE(x.is_cuda(),
                    "CUDA encoder level needs every tensor on one CUDA "
                    "device, got x on ", x.device());
  for (const at::Tensor& t : p) {
    TORCH_CHECK_VALUE(t.device() == x.device(),
                      "CUDA encoder level needs every tensor on one CUDA "
                      "device, got ", x.device(), " and ", t.device());
    TORCH_CHECK_VALUE(is_kernel_type(x.scalar_type()) &&
                          t.scalar_type() == x.scalar_type(),
                      "CUDA encoder level takes float32 or bfloat16 tensors "
                      "of one type, got ", x.scalar_type(), " and ",
                      t.scalar_type());
  }
}

at::Tensor encoder_level_fwd_op(const at::Tensor& x_in, const at::Tensor& k1,
                                const at::Tensor& b1, const at::Tensor& k2,
                                const at::Tensor& b2, const at::Tensor& k3,
                                const at::Tensor& b3, c10::string_view grad) {
  // grad picks the backward in a Python process; inference has none
  (void)grad;
  const at::Tensor x = x_in.contiguous();
  const at::Tensor p[6] = {k1.contiguous(), b1.contiguous(), k2.contiguous(),
                           b2.contiguous(), k3.contiguous(), b3.contiguous()};
  check_level(x, p);
  const int64_t b = x.size(0), h = x.size(1), w = x.size(2), c = x.size(3),
                f = p[0].size(3);
  at::Tensor out = at::empty({b, h / 2, w / 2, f}, x.options());
  const c10::cuda::CUDAGuard guard(x.device());
  int th = 0, tw = 0;
  int err;
  if (x.scalar_type() == at::kBFloat16 && tc_forward_tile(c, f, &th, &tw)) {
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0,
                      "the tensor-core encoder level reads activations 16 "
                      "bytes at a time: they must start 16-byte aligned");
    // the library packs the weights into mma fragment order here
    const at::Tensor workspace = at::empty(
        {encoder_level_tc_fwd_workspace(c, f)}, x.options().dtype(at::kByte));
    err = encoder_level_tc_fwd(x.data_ptr(), p[0].data_ptr(), p[1].data_ptr(),
                               p[2].data_ptr(), p[3].data_ptr(),
                               p[4].data_ptr(), p[5].data_ptr(),
                               out.data_ptr(), workspace.data_ptr(), b, h, w,
                               c, f, th, tw, current_stream(x));
  } else {
    const int t = encoder_level_fwd_tile(c, f, x.element_size());
    TORCH_CHECK_VALUE(t > 0, "encoder level (", c, " -> ", f, " channels, ",
                      x.scalar_type(),
                      ") does not fit a block's shared memory");
    err = encoder_level_fwd(x.data_ptr(), p[0].data_ptr(), p[1].data_ptr(),
                            p[2].data_ptr(), p[3].data_ptr(), p[4].data_ptr(),
                            p[5].data_ptr(), out.data_ptr(), b, h, w, c, f, t,
                            x.scalar_type() == at::kBFloat16,
                            current_stream(x));
  }
  TORCH_CHECK(err == 0, "encoder_level_fwd launch failed: ",
              encoder_level_error_string(err), " (x ", x.sizes(), ", F ", f,
              ", ", x.scalar_type(), ")");
  ++encoder_level_fwd_launches;
  return out;
}

}  // namespace

TORCH_LIBRARY(cerberus, m) {
  m.def(
      "corr2d_fwd(Tensor f1, Tensor f2, SymInt max_disp, SymInt dilation) -> "
      "Tensor");
  m.def(
      "corr1d_fwd(Tensor f1, Tensor f2, SymInt max_disp, SymInt dilation) -> "
      "Tensor");
  m.def(
      "encoder_level_fwd(Tensor x, Tensor k1, Tensor b1, Tensor k2, Tensor "
      "b2, Tensor k3, Tensor b3, str grad) -> Tensor");
}

TORCH_LIBRARY_IMPL(cerberus, CUDA, m) {
  m.impl("corr2d_fwd", &corr2d_fwd_op);
  m.impl("corr1d_fwd", &corr1d_fwd_op);
  m.impl("encoder_level_fwd", &encoder_level_fwd_op);
}

// Launches of an operator's kernel since the library was loaded, -1 for a
// name it does not define.
extern "C" int64_t cerberus_ops_launches(const char* name) {
  if (std::strcmp(name, "corr2d_fwd") == 0) return corr2d_fwd_launches;
  if (std::strcmp(name, "corr1d_fwd") == 0) return corr1d_fwd_launches;
  if (std::strcmp(name, "encoder_level_fwd") == 0)
    return encoder_level_fwd_launches;
  return -1;
}
