// Does CUDA-core work overlap tf32 wgmma on an H100?
//
// One block of two warpgroups per SM (132 blocks) repeats: issue one group
// of nine wgmma m64n256k8 .tf32 (A from registers, B from shared memory, as
// the snake+conv kernel's widest stage does), then an activation-like loop
// over `elems` elements (shared-memory load, sinf, tf32 split, two
// shared-memory stores, as the kernel's snake does), then wait for the MMAs.
// It prints the time per iteration of the MMAs alone, of the loop alone and
// of both; if the two overlapped, "both" would be the larger of the other
// two.  Build and run on the card, from the repository root:
//
//   nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I after_tpu_torch/csrc -o build/wgmma_overlap_probe \
//        scripts/wgmma_overlap_probe.cu && build/wgmma_overlap_probe

#include <cstdio>
#include <cstdlib>

#include "fused_snake_conv.cu"

namespace {

constexpr int kSmem = 120000;

// kMma: the wgmma group; kLoop: the activation-like loop
template <bool kMma, bool kLoop>
__global__ void __launch_bounds__(256, 1)
probe(float* out, int iters, int elems) {
  extern __shared__ __align__(1024) float sm[];
  float* const xr = sm + 8192;
  float* const act = sm + 16384;
  for (int i = threadIdx.x; i < 24576; i += 256) sm[i] = 0.001f * (i % 7);
  __syncthreads();
  float acc[128];
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t a[9][4];
  const int lane = threadIdx.x % 32;
  for (int g = 0; g < 9; ++g)
    for (int e = 0; e < 4; ++e)
      a[g][e] = __float_as_uint(sm[lane * 4 + e + g]);
  fence_acc(acc);
  for (int it = 0; it < iters; ++it) {
    if (kMma) {
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < 9; ++g)
        wgmma_tf32<256>(acc, a[g], make_desc<32>(sm + g * 64));
      wgmma_commit();
    }
    if (kLoop) {
      for (int e = threadIdx.x; e < elems; e += 256) {
        const float xv = xr[e % 4096] + 1e-7f * it;
        const float sn = sinf(xv * 1.1f);
        float hi, lo;
        split_tf32(xv + 0.9f * sn * sn, hi, lo);
        act[e % 4096] = hi;
        act[4096 + e % 4096] = lo;
      }
    }
    if (kMma) {
      wgmma_wait_all();
      fence_acc(acc);
    }
    __syncthreads();
  }
  float s = 0.f;
  for (int i = 0; i < 128; ++i) s += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = s + act[threadIdx.x];
}

template <bool kMma, bool kLoop>
float us_per_iteration(float* out, int elems) {
  const int iters = 4000;
  cudaFuncSetAttribute(probe<kMma, kLoop>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  probe<kMma, kLoop><<<132, 256, kSmem>>>(out, 10, elems);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  probe<kMma, kLoop><<<132, 256, kSmem>>>(out, iters, elems);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    exit(1);
  }
  return 1e3f * ms / iters;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  float* out;
  cudaMalloc(&out, 132 * 256 * sizeof(float));
  const float mma = us_per_iteration<true, false>(out, 0);
  printf("%s: 9 x wgmma m64n256k8 tf32 per warpgroup: %.3f us per group\n",
         prop.name, mma);
  // 1168 elements: the kernel's 256 x 8 x 3 stage (146-row window x 8
  // channels); 2336 and 4096: twice that, and a 128 x 32 window
  for (int elems : {1168, 2336, 4096}) {
    const float loop = us_per_iteration<false, true>(out, elems);
    const float both = us_per_iteration<true, true>(out, elems);
    printf("activation loop of %d elements: alone %.3f us, with the MMAs "
           "%.3f us (MMAs alone %.3f us)\n", elems, loop, both, mma);
  }
  return 0;
}
