// The op after_tpu_torch::snake_conv registered from C++, for processes
// without Python: the native streaming host (stream_host.cc) loads the
// AOTInductor packages of an artifact's stages, whose snake+conv nodes call
// this op through the dispatcher.
//
//   y[b,t,o] = bias[o] + sum_{j<k} sum_c snake(xpad[b, t + j*d, c]) * W[o,c,j]
//   snake(x) = x + sin^2(alpha_c * x) / (beta_c + 1e-9)
//
// The schema is the Python op's (ops/kernels/fused_conv.py:snake_conv)
// letter for letter, weight in the kernel's layout: w_k (k, O, Cw) and its
// low tf32 half w_lo.  A Python process never loads this library: there the
// op is defined by torch.library.custom_op, and two definitions would clash.
//
// - CUDA: the same checks as the Python wrapper (_launch), then the kernel
//   of fused_snake_conv.cu (fused_snake_conv_f32, the Hopper port of
//   after_tpu/ops/pallas/fused_conv.py:_kernel) on the current stream.  The
//   kernel adds one to a device counter at each launch, replays of a CUDA
//   graph included (device_counts below).  A refused launch raises.
// - CPU: the plain version, snake_conv_reference's ops in ATen: snake, zero
//   pad, conv1d.  The output is a contiguous (B, T, O) tensor, the strides
//   the op's fake promises: packaged code reads it with those strides.
// - bf16 (an artifact exported with a compute dtype): x, alpha, beta, w_k
//   and b are bf16, w_lo empty.  On the card the kernel's bf16
//   instantiation (fused_snake_conv_bf16), counted in its own two device
//   counters; on the CPU the plain bf16 version: the snake in f32 rounded
//   to bf16, the conv summed in f32, the output rounded once.
//
// Built by ops/kernels/build.py: with -DAFTER_TPU_TORCH_CUDA (and linked to
// the kernel's library) where nvcc is present, CPU-only elsewhere.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <string>
#include <utility>

#ifdef AFTER_TPU_TORCH_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include <map>
#include <mutex>

extern "C" {
int fused_snake_conv_plan(int B, int T, int C, int O, int k, int dilation,
                          int* out);
int fused_snake_conv_f32(const float* x, const float* alpha, const float* beta,
                         const float* w, const float* wlo, const float* bias,
                         float* y, float* ws, int B, int T, int C, int O,
                         int k, int dilation, int left, int Cw,
                         unsigned long long* counts, void* stream);
int fused_snake_conv_plan_bf16(int B, int T, int C, int O, int k,
                               int dilation, int* out);
int fused_snake_conv_bf16(const void* x, const void* alpha, const void* beta,
                          const void* w, const void* bias, void* y, float* ws,
                          int B, int T, int C, int O, int k, int dilation,
                          int left, int Cw, unsigned long long* counts,
                          void* stream);
}
#endif

namespace after_tpu_torch {

#ifdef AFTER_TPU_TORCH_CUDA
at::Tensor device_counts(c10::DeviceIndex device);
#endif

namespace {

std::atomic<int64_t> plain_calls{0};

// (left, right) zero pad that keeps the length (ops/conv.py:get_padding).
std::pair<int64_t, int64_t> padding(int64_t k, int64_t dilation,
                                    c10::string_view mode) {
  const int64_t total = std::max<int64_t>((k - 1) * dilation, 0);
  if (mode == "causal") return {total, 0};
  TORCH_CHECK(mode == "centered", "snake_conv: unknown padding mode ",
              std::string(mode));
  const int64_t left = (total + 1) / 2;
  return {left, total - left};
}

// ops/snake.py:snake_beta, op for op (1.0 / t is t.reciprocal() * 1.0).
at::Tensor snake_beta(const at::Tensor& x, const at::Tensor& alpha,
                      const at::Tensor& beta) {
  return x + at::reciprocal(beta + 1e-9) * 1.0 * at::square(at::sin(x * alpha));
}

at::Tensor snake_conv_cpu(const at::Tensor& x, const at::Tensor& alpha,
                          const at::Tensor& beta, const at::Tensor& w_k,
                          const at::Tensor& w_lo, const at::Tensor& b,
                          c10::SymInt dilation, c10::string_view mode) {
  const int64_t d = dilation.guard_int(__FILE__, __LINE__);
  plain_calls++;
  // fused_conv.py:torch_weight: (k, O, Cw) back to torch's (O, C, k)
  at::Tensor w = w_k.slice(2, 0, x.size(2)).permute({1, 2, 0}).contiguous();
  const auto pad = padding(w.size(2), d, mode);
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  at::Tensor a, bias = b;
  if (bf16) {
    // snake_conv_reference on bf16: the snake in f32, rounded to bf16, the
    // conv summed in f32 with the f32 bias
    a = snake_beta(x.to(at::kFloat), alpha.to(at::kFloat),
                   beta.to(at::kFloat))
            .to(at::kBFloat16)
            .to(at::kFloat);
    w = w.to(at::kFloat);
    bias = b.to(at::kFloat);
  } else {
    a = snake_beta(x, alpha, beta);
  }
  const int64_t stride = 1, no_pad = 0;
  const at::Tensor y = at::conv1d(
      at::constant_pad_nd(a.transpose(1, 2), {pad.first, pad.second}), w,
      bias, at::IntArrayRef(stride), at::IntArrayRef(no_pad),
      at::IntArrayRef(d));
  const at::Tensor out = y.transpose(1, 2).contiguous();
  return bf16 ? out.to(at::kBFloat16) : out;
}

#ifdef AFTER_TPU_TORCH_CUDA
std::mutex counts_mutex;
std::map<c10::DeviceIndex, at::Tensor> counts_by_device;

void check(const char* name, const at::Tensor& t, const at::Tensor& x,
           at::IntArrayRef shape) {
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  TORCH_CHECK(t.device() == x.device(), "snake_conv: ", name, " is on ",
              t.device(), ", x on ", x.device());
  TORCH_CHECK(t.scalar_type() == (bf16 ? at::kBFloat16 : at::kFloat),
              "snake_conv: ", name, " must be ",
              bf16 ? "bfloat16" : "float32", ", got ", t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), "snake_conv: ", name, " must be contiguous");
  TORCH_CHECK(t.sizes() == shape, "snake_conv: ", name, " has shape ",
              t.sizes(), ", expected ", shape);
}

at::Tensor snake_conv_cuda(const at::Tensor& x, const at::Tensor& alpha,
                           const at::Tensor& beta, const at::Tensor& w_k,
                           const at::Tensor& w_lo, const at::Tensor& b,
                           c10::SymInt dilation, c10::string_view mode) {
  TORCH_CHECK(x.dim() == 3 && w_k.dim() == 3,
              "snake_conv: x must be (B, T, C) and w_k (k, O, Cw); got ",
              x.sizes(), " and ", w_k.sizes());
  const int64_t d = dilation.guard_int(__FILE__, __LINE__);
  const int64_t B = x.size(0), T = x.size(1), C = x.size(2);
  const int64_t k = w_k.size(0), O = w_k.size(1), Cw = w_k.size(2);
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  // C rounded up to 16 bytes (fused_conv.py:weight_channels)
  const int64_t m = bf16 ? 8 : 4;
  TORCH_CHECK(Cw == (C + m - 1) / m * m, "snake_conv: w_k has ", Cw,
              " input channels for x's ", C,
              ": the kernel reads C rounded up to a multiple of ", m);
  check("x", x, x, {B, T, C});
  check("alpha", alpha, x, {C});
  check("beta", beta, x, {C});
  check("w_k", w_k, x, {k, O, Cw});
  if (bf16)
    check("w_lo", w_lo, x, {0});
  else
    check("w_lo", w_lo, x, {k, O, Cw});
  check("b", b, x, {O});
  TORCH_CHECK(reinterpret_cast<uintptr_t>(w_k.data_ptr()) % 16 == 0 &&
                  (bf16 ||
                   reinterpret_cast<uintptr_t>(w_lo.data_ptr()) % 16 == 0),
              "snake_conv: the kernel's weight tiles must be 16-byte aligned");
  const c10::cuda::CUDAGuard guard(x.device());
  const at::Tensor counts = device_counts(x.device().index());
  int plan[3];
  int err = bf16 ? fused_snake_conv_plan_bf16(B, T, C, O, k, d, plan)
                 : fused_snake_conv_plan(B, T, C, O, k, d, plan);
  TORCH_CHECK(err == 0, "snake_conv: no tiling for B=", B, " T=", T, " C=", C,
              " O=", O, " k=", k, " d=", d, " (CUDA error ", err, ")");
  at::Tensor y = at::empty({B, T, O}, x.options());
  // the f32 partial sums of a split channel sum, added in split order
  at::Tensor ws;
  if (plan[2] > 1)
    ws = at::empty({plan[2], B, T, O}, x.options().dtype(at::kFloat));
  const int64_t left = padding(k, d, mode).first;
  unsigned long long* const n =
      reinterpret_cast<unsigned long long*>(counts.data_ptr<int64_t>());
  void* const stream =
      at::cuda::getCurrentCUDAStream(x.device().index()).stream();
  float* const wsp = ws.defined() ? ws.data_ptr<float>() : nullptr;
  if (bf16)
    err = fused_snake_conv_bf16(x.data_ptr(), alpha.data_ptr(),
                                beta.data_ptr(), w_k.data_ptr(), b.data_ptr(),
                                y.data_ptr(), wsp, B, T, C, O, k, d, left, Cw,
                                n + 2, stream);
  else
    err = fused_snake_conv_f32(
        x.data_ptr<float>(), alpha.data_ptr<float>(), beta.data_ptr<float>(),
        w_k.data_ptr<float>(), w_lo.data_ptr<float>(), b.data_ptr<float>(),
        y.data_ptr<float>(), wsp, B, T, C, O, k, d, left, Cw, n, stream);
  TORCH_CHECK(err == 0, "snake_conv: kernel launch failed with CUDA error ",
              err, " (B=", B, " T=", T, " C=", C, " O=", O, " k=", k,
              " d=", d, " mode=", std::string(mode), ")");
  return y;
}
#endif

}  // namespace

// Calls of the plain version (the CPU implementation) in this process.
int64_t cpu_calls() { return plain_calls.load(); }

#ifdef AFTER_TPU_TORCH_CUDA
// The four int64 launch counters on a card that the kernels add to (the f32
// conv kernel's, its split sum's, then the bf16 instantiation's two), made
// at the first call: that call must
// not be inside a CUDA graph capture, since the counters must not come from
// the graph's pool.  The host makes them at load.
at::Tensor device_counts(c10::DeviceIndex device) {
  const std::lock_guard<std::mutex> lock(counts_mutex);
  auto it = counts_by_device.find(device);
  if (it != counts_by_device.end()) return it->second;
  TORCH_CHECK(c10::cuda::currentStreamCaptureStatusMayInitCtx() ==
                  c10::cuda::CaptureStatus::None,
              "snake_conv's launch counters are made at its first launch, "
              "which must not be inside a CUDA graph capture");
  at::Tensor counts = at::zeros(
      {4}, at::TensorOptions().dtype(at::kLong).device(at::kCUDA, device));
  counts_by_device.emplace(device, counts);
  return counts;
}
#endif

TORCH_LIBRARY(after_tpu_torch, m) {
  m.def(
      "snake_conv(Tensor x, Tensor alpha, Tensor beta, Tensor w_k, "
      "Tensor w_lo, Tensor b, SymInt dilation, str mode) -> Tensor");
}

TORCH_LIBRARY_IMPL(after_tpu_torch, CPU, m) {
  m.impl("snake_conv", &snake_conv_cpu);
}

#ifdef AFTER_TPU_TORCH_CUDA
TORCH_LIBRARY_IMPL(after_tpu_torch, CUDA, m) {
  m.impl("snake_conv", &snake_conv_cuda);
}
#endif

}  // namespace after_tpu_torch
