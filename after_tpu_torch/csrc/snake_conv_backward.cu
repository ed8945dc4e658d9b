// The backward of the fused SnakeBeta + dilated 1-D convolution on Hopper's
// tensor cores (sm_90a): two implicit GEMMs in 3xTF32 on wgmma.
//
// The forward (fused_snake_conv.cu) computes, over x (B, T, C) and the weight
// W[j, o, c] in its (k, O, Cw) layout,
//
//   y[b,t,o] = bias[o] + sum_{j<k} sum_c a[b, t + j*d - left, c] * W[j,o,c]
//   a = x + s^2 / e,  s = sin(alpha_c * x),  e = beta_c + 1e-9
//
// (a zero outside [0, T); left = (k-1)d causal, ceil((k-1)d / 2) centered).
// Given g = dL/dy (B, T, O) this file computes, with co = cos(alpha_c * x):
//
//   ga[b,u,c]  = sum_j sum_o g[b, u + left - j*d, o] * W[j,o,c]
//   gx         = ga * (1 + 2 alpha s co / e)
//   galpha[c]  = sum_{b,u} ga * 2 x s co / e
//   gbeta[c]   = -sum_{b,u} ga * s^2 / e^2
//   gb[o]      = sum_{b,t} g[b,t,o]
//   gw[j,o,c]  = sum_{b,t} a[b, t + j*d - left, c] * g[b,t,o]
//
// (g zero outside [0, T)), in two kernels: dgrad (the first five) and wgrad
// (gw, in the (k, O, Cw) layout, zero past C).
//
// Replaces the VJP of the TPU kernel, after_tpu/ops/pallas/fused_conv.py:
// _fused_with_vjp.bwd (:84-103), which differentiates the lax reference:
// it recomputes the forward conv and writes the activation and the chain of
// its derivative to memory.  Here the activation and its derivative are
// computed on chip from x and never stored, and the forward is not
// recomputed: two GEMMs of the forward's size, where the plain VJP runs
// three.
//
// What bounds it: operations.  A training step of the base codec (batch
// 8 x 131072 samples, 64 convs) needs 2 x 224.1 GFLOP here against some
// 1.5 GB of traffic; 3xTF32 runs three tf32 products per multiply-add, so at
// the H100's 495 TFLOP/s no run can take less than 2.72 ms a step (the f32
// CUDA cores alone would need 6.69 ms).  Both kernels keep the tensor cores
// busy with the forward kernel's scheme: 3xTF32 (a_lo*b_hi, a_hi*b_lo,
// a_hi*b_hi, small terms first, f32 accuracy), the shifted operand from
// registers (a tap's shift j*d is not a multiple of the 8-row core matrix),
// the other from swizzled shared memory through descriptors, a ring of three
// stages so that loads run ahead of the MMAs.  The tensor cores add into
// their f32 sums without rounding to nearest, so an error that grows with
// the length of the sum (the forward's channel sums are short, these are
// long: 2304 terms in dgrad, 65536 frames in wgrad) is kept down by folding
// the MMA sums into f32 totals every few stages (kFoldD, kFoldW).
//
// dgrad: M = frames (128 a block, two warpgroups), N = C, K = O x taps.  It
// is the forward's conv applied to g with the taps reversed: the caller
// passes the weight transposed, Wt[j, c, o] = W[j, o, c], (k, C, Ow) with
// Ow >= O a multiple of 4 and zeros past O, so that tf32 wgmma reads it
// K-major (o contiguous) by TMA, and the kernel's tap j' reads Wt[k-1-j'];
// the g window of a block starts `lead` = (k-1)d - left frames before it.
// Its low tf32 half is made on chip from each staged tile.  The whole channel sum
// runs in one block, so its epilogue holds ga and finishes the job: it
// reads x, computes sin and cos once (sincosf), writes gx and adds the
// block's 128 frames into per-block partials of galpha and gbeta; the
// block of the first channel tile also sums its own 128 frames of g, staged
// anyway, into partials of gb.
//
// wgrad: M = O (128 a block), N = C, K = frames.  Both a and g hold frames
// as their strided axis, so one is transposed on chip: the threads that
// activate a stage's 32 frames of x (full-accuracy sinf, the tf32 split)
// write them frames-contiguous into the 128-byte swizzled layout that a
// descriptor reads as B, and g goes in as A from registers, its hi/lo split
// made there, each tap's shift on g.  So one activated tile serves every
// tap and all 128 output channels.  The frame sum is long and the output
// small (3 x 64 x 64 at the first stage of the codec over 65536 frames), so
// it is split over blocks (gridDim.z) to fill the card.
//
// Every cross-block sum (galpha, gbeta and gb over the dgrad blocks, gw over
// the wgrad splits) goes through per-block partials that a third kernel,
// sum_partials, adds in a fixed order: no atomics, and every launch of a
// shape, eager or replayed from a CUDA graph, gives the same bits.  Each
// kernel adds one to a device counter the caller passes, so launches
// replayed from a CUDA graph are counted as eager ones are.  A launch error
// is returned to the caller, which raises.
//
// The bf16 kernels, the backward of the forward's bf16 kernel
// (fused_snake_conv.cu: snake_conv_bf16): g, x, alpha, beta and the weight
// are bf16, and so are the five gradients.  Each is a design of its own for
// bf16 on Hopper, built from snake_conv_bf16.cuh's pieces: a producer warp
// keeps TMA loads in flight in a ring of slots that full, empty and ready
// mbarriers hand between the warps, blocks are persistent, the snake is
// f32 sine squared (a 3-part reduction and Cephes' polynomial) rounded to
// bf16 once, and g reaches the tensor cores from registers by ldmatrix at
// per-lane row addresses, so a tap's shift j*d needs no 8-row alignment.
//
// dgrad (snake_conv_dgrad_bf16) is the forward's bf16 main loop on g with
// the taps reversed, then its epilogue on each tile: x in and gx out
// through shared memory in 16-byte pieces, the snake's derivative in f32,
// gx rounded to bf16 once; the producer sums g's frames for gb from the
// slots the consumers have released.
//
// wgrad (snake_conv_wgrad_bf16): M = output channels, N = input channels
// (64 a tile), K = frames, in 64-frame chunks.  A chunk's slot holds its x
// tile (64 frames x 64 channels) and the g window its taps read (64 +
// (KT-1)d frames x 64-channel boxes), both as TMA lands them: frames as
// rows, channels contiguous, 128-byte swizzled.  Seven warps activate the
// x tile in place, and the tensor cores read it as B just so, MN-major
// (wgmma reads 16-bit operands either way): no transposed copy.  g goes in
// as A, ldmatrix .trans turning its frames x channels rows into fragments,
// each tap's shift a row offset.  The two consumer warpgroups take
// different output boxes (64 channels each) of one x tile, or, where the
// output has one box, alternate chunks, the second's sums added into the
// first's through shared memory.  Blocks walk work items (tile x split of
// the frame sum); each split's f32 slab is summed by sum_partials4, 16-byte
// loads in the fixed order.  What bounds it at the encoder's shapes (2-8
// us of work a launch): the snake, which every x tile needs again for each
// 128 output channels, the m64n64k16 MMAs, and the slabs of the split sums,
// written at the end of each item and read back (scripts/
// torch_backward_variants.py --bf16 splits them); a plan (wgrad16::
// make_plan) picks the output boxes, the warpgroups' roles and the split
// for each shape.
//
// Neither bf16 kernel folds f32 totals: each gradient is rounded to 8 bits
// once, and the float64 check holds without (scripts/torch_backward_f64.py
// --bf16).  galpha, gbeta, gb and a split gw leave the kernels as f32
// partials, summed in a fixed order (sum_partials, sum_partials4) and
// rounded once: the same bits at every launch, eager or replayed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <string.h>

#include "snake_conv_bf16.cuh"

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kRows = 128;      // dgrad: frames per block, 64 per warpgroup
constexpr int kOuts = 128;      // wgrad: output channels per block
constexpr int kFrames = 32;     // wgrad: f32 frames a chunk (one 128-byte row)
constexpr int kGStride = kOuts + 8;   // wgrad: row stride of the g window
constexpr int kSMs = 132;       // H100 SXM
constexpr int kMaxSmem = 232448;          // per block, opt-in
constexpr int kRing = 3;                  // stages in flight
// The tensor cores add each product into the f32 sums without rounding to
// nearest, so a sum's error grows with the number of MMAs added into it:
// each kernel folds its MMA sums into f32 totals kept in registers (IEEE
// adds) every few stages, dgrad every kFoldD stages (at most 96 terms of
// the channel sum), wgrad every kFoldW chunks (128 frames).
constexpr int kFoldD = 2;
constexpr int kFoldW = 4;

__host__ __device__ constexpr int act_stride(int bk) {
  return bk % 16 == 0 ? bk + 8 : bk;
}

// column of channel cc inside its group of 8: (cc, cc + 4) side by side
__device__ __forceinline__ int act_col(int cc) {
  return (cc & ~7) + ((cc & 3) << 1) + ((cc >> 2) & 1);
}

__device__ __forceinline__ float widen(float v) { return v; }

// an f32 value stored as Out (f32, or bf16 rounded to nearest once)
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// shared memory written by threads, read next by wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  const uint32_t h = to_tf32(v);
  hi = __uint_as_float(h);
  lo = __uint_as_float(to_tf32(v - hi));
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// K-major operand in the swizzled layout: rows of `row_bytes` (32, 64 or
// 128: the swizzle span), 8-row groups `8 * row_bytes` apart
template <int RowBytes>
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  constexpr uint64_t layout = RowBytes == 128 ? 1 : RowBytes == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * RowBytes >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// total += d (IEEE adds), d = 0
template <int R>
__device__ __forceinline__ void fold(float (&total)[R], float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    total[i] += d[i];
    d[i] = 0.f;
  }
  fence_acc(d);
}

// wgmma.mma_async m64nNk8 .f32.tf32.tf32, A from registers, B from shared
// memory, d += A * B

__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (BN == 32) wgmma_n32(d, a, desc_b);
  else if constexpr (BN == 64) wgmma_n64(d, a, desc_b);
  else wgmma_n128(d, a, desc_b);
}

// wgmma.mma_async m64n64k16 .f32.bf16.bf16, A from registers (4 registers
// of two bf16 each, the lower k in the low half), B MN-major from shared
// memory (trans-b 1: each K index a row of N values), d += A * B

__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// MN-major operand of 64 MN values in TMA's 128-byte swizzle: each K index
// a 128-byte row, 8-row groups 1024 bytes apart (the stride byte offset;
// the leading byte offset, between groups of 64 MN values, is unused)
__device__ __forceinline__ uint64_t desc128_mn(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// four 8x8 b16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8, and holds column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1
// (the lower in the low half) of each in r[0..3]
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// dgrad
// ---------------------------------------------------------------------------

// g, x, alpha, beta and gx are of the instance's element type (float or
// __nv_bfloat16); the partial sums are f32 in both
struct DgradParams {
  const void* g;        // (B, T, O)
  const void* x;        // (B, T, C)
  const void* alpha;
  const void* beta;
  void* gx;             // (B, T, C), or null when not wanted
  float* part;          // (B * ceil(T / 128), 2C + O) partial sums, or null
  unsigned long long* count;
  int T, C, O, k, dilation;
  int lead;             // window rows before the block's first frame
  int win;              // window rows: kRows + (k - 1) * dilation
  int groups;           // tap groups per channel chunk: k / KT
  int n_stages;         // channel chunks x tap groups
  int vec_g;            // 16-byte copies of g
  int vec_x;            // 16-byte copies of x and gx
  int need_ga;          // gx, galpha or gbeta wanted: run the epilogue
  int need_ab;          // galpha and gbeta wanted
  int need_gb;          // gb wanted
};

__host__ __device__ constexpr int weight_bytes(int bn, int bk, int kt,
                                               int elem = 4) {
  return elem * kt * bk * bn;
}

// the main loop's buffers (weight tiles hi and lo, windows split in hi and
// lo), or the epilogue's x tile, coefficients and warp sums in the same
// space, whichever is larger
size_t dgrad_smem(int bn, int bk, int kt, int win) {
  const size_t acts = (size_t)4 * 4 * win * act_stride(bk);
  const size_t main = (size_t)kRing * 2 * weight_bytes(bn, bk, kt) +
                      (size_t)kRing * 4 * win * bk + acts +
                      2 * 4 * kThreads + kRing * sizeof(uint64_t);
  const size_t epilogue = (size_t)4 * (kRows * (bn + 8) + 2 * bn + 16 * bn);
  return 1024 + (main > epilogue ? main : epilogue);   // and alignment
}

// One block: 128 frames x BN input channels, its whole sum over output
// channels and taps in stages of BK output channels x KT taps in 3xTF32
// (the weight's low half made on chip, the window split); then the
// epilogue (gx, and the block's partials of galpha, gbeta and gb).
template <int BN, int BK, int KT>
__device__ __forceinline__ void dgrad_block(const CUtensorMap* w_map,
                                            const DgradParams& p) {
  using T = float;
  constexpr int per = 4;                     // elements of a 16-byte piece
  constexpr int kq = BK / per;
  constexpr int AS = act_stride(BK);
  constexpr int WB = weight_bytes(BN, BK, KT);
  constexpr int WE = WB / 4;                 // elements of one ring slot
  constexpr int TAP = BN * BK;
  constexpr int KS = BK / 8;
  constexpr int STEPS = KT * KS;
  static_assert(kThreads % BK == 0, "a thread keeps its channel");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int xsz = p.win * BK;
  const int asz = p.win * AS;
  T* const whi = reinterpret_cast<T*>(smem);                   // [ring][WE]
  float* const wlo = whi + kRing * WE;                         // [ring][WE]
  T* const graw = whi + 2 * kRing * WE;                        // [ring][xsz]
  T* const act = graw + kRing * xsz;   // [2][hi, lo] windows
  float* const gbtmp = act + 4 * asz;                          // [2][threads]
  uint64_t* const full = reinterpret_cast<uint64_t*>(gbtmp + 2 * kThreads);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int n = p.n_stages;
  const int mb = b * gridDim.x + blockIdx.x;       // this block's partials
  const size_t stride = 2 * (size_t)p.C + p.O;
  const bool gb_block = p.need_gb && blockIdx.y == 0;
  const T* const g = static_cast<const T*>(p.g);
  const T* const gbat = g + (size_t)b * p.T * p.O;

  if (p.count != nullptr && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0)
    atomicAdd(p.count, 1ull);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage i into ring slot i % kRing: the weight tiles by TMA (thread 0),
  // the g window by every thread; one cp.async group per call
  auto issue = [&](int i) {
    if (i < n) {
      const int o0 = (i / p.groups) * BK;
      const int j0 = (i % p.groups) * KT;
      const int slot = i % kRing;
      if (tid == 0) {
        uint64_t* const bar = full + slot;
        mbar_expect(bar, WB);
#pragma unroll
        for (int jj = 0; jj < KT; ++jj) {
          const int row = (p.k - 1 - j0 - jj) * p.C + c0;
          tma_load_2d(whi + slot * WE + jj * TAP, w_map, bar, o0, row);
        }
      }
      T* const dst = graw + slot * xsz;
      if (p.vec_g) {
        for (int e = tid; e < p.win * kq; e += kThreads) {
          const int q = e % kq;
          const int r = e / kq;
          const int t = t0 - p.lead + r;
          const int o = o0 + per * q;
          const bool ok = t >= 0 && t < p.T && o < p.O;
          cp_async16(dst + r * BK + per * q,
                     ok ? gbat + (size_t)t * p.O + o : g, ok);
        }
      } else {
        for (int e = tid; e < p.win * BK; e += kThreads) {
          const int oo = e % BK;
          const int r = e / BK;
          const int t = t0 - p.lead + r;
          const int o = o0 + oo;
          const bool ok = t >= 0 && t < p.T && o < p.O;
          cp_async4(dst + e, ok ? gbat + (size_t)t * p.O + o : g, ok);
        }
      }
    }
    cp_async_commit();
  };

  // stage i's g window into buffer i & 1, split into tf32 halves; a thread
  // keeps one channel, and the first tap group's stage also sums the
  // block's own 128 frames of it (gb).  It also makes the low tf32 half of
  // stage i's weight tiles, element by element in their swizzled layout:
  // the tensor cores read the top 19 bits of w as its high half, lo =
  // tf32(w - them).
  auto activate = [&](int i) {
    {
      const float* const wh = whi + (i % kRing) * WE;
      float* const wl = wlo + (i % kRing) * WE;
      for (int e = tid; e < WE; e += kThreads) {
        const float v = wh[e];
        wl[e] = __uint_as_float(
            to_tf32(v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u)));
      }
      fence_async_shared();
    }
    const int cc = tid % BK;
    const T* const xr = graw + (i % kRing) * xsz;
    T* const ah = act + (i & 1) * 2 * asz;
    const int col = act_col(cc);
    float gsum = 0.f;
#pragma unroll 2
    for (int r = tid / BK; r < p.win; r += kThreads / BK) {
      const T v = xr[r * BK + cc];
      float hi, lo;
      split_tf32(v, hi, lo);
      ah[r * AS + col] = hi;
      ah[asz + r * AS + col] = lo;
      if (r >= p.lead && r < p.lead + kRows) gsum += v;
    }
    if (gb_block && i % p.groups == 0) gbtmp[(i & 1) * kThreads + tid] = gsum;
  };

  // the sums of stage i's channels over the block's frames, in thread order
  auto flush_gb = [&](int i) {
    if (gb_block && i % p.groups == 0 && tid < BK) {
      const int o = (i / p.groups) * BK + tid;
      if (o < p.O) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < kThreads / BK; ++m)
          s += gbtmp[(i & 1) * kThreads + tid + m * BK];
        p.part[mb * stride + 2 * p.C + o] = s;
      }
    }
  };

  const int lane = tid % 32;
  const int row0 = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + lane / 4;
  const int tig = lane % 4;

  float acc[BN / 2], tot[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = tot[e] = 0.f;
  fence_acc(acc);

  // all fragments of stage i in registers, then its 3 x STEPS MMAs in one
  // group, small terms first
  auto mma = [&](int i) {
    const int j0 = (i % p.groups) * KT;
    const T* const bh = whi + (i % kRing) * WE;
    {
      const float* const ah = act + (i & 1) * 2 * asz;
      const float* const alo = ah + asz;
      uint32_t fh[STEPS][4], fl[STEPS][4];
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int off = (row0 + (j0 + u / KS) * p.dilation) * AS +
                        8 * (u % KS) + 2 * tig;
        const float2 h0 = *reinterpret_cast<const float2*>(ah + off);
        const float2 h1 = *reinterpret_cast<const float2*>(ah + off + 8 * AS);
        const float2 l0 = *reinterpret_cast<const float2*>(alo + off);
        const float2 l1 = *reinterpret_cast<const float2*>(alo + off + 8 * AS);
        fh[u][0] = __float_as_uint(h0.x);
        fh[u][1] = __float_as_uint(h1.x);
        fh[u][2] = __float_as_uint(h0.y);
        fh[u][3] = __float_as_uint(h1.y);
        fl[u][0] = __float_as_uint(l0.x);
        fl[u][1] = __float_as_uint(l1.x);
        fl[u][2] = __float_as_uint(l0.y);
        fl[u][3] = __float_as_uint(l1.y);
      }
      const float* const bl = wlo + (i % kRing) * WE;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const int off = (u / KS) * TAP + 8 * (u % KS);
        const uint64_t dh = make_desc<BK * 4>(bh + off);
        const uint64_t dl = make_desc<BK * 4>(bl + off);
        wgmma_tf32<BN>(acc, fl[u], dh);
        wgmma_tf32<BN>(acc, fh[u], dl);
        wgmma_tf32<BN>(acc, fh[u], dh);
      }
    }
    wgmma_commit();
  };

  issue(0);
  issue(1);
  cp_async_wait_prev();
  __syncthreads();
  mbar_wait(full, 0);
  activate(0);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    flush_gb(i);
    mma(i);
    issue(i + 2);
    if (i + 1 < n) {
      cp_async_wait_prev();
      __syncthreads();
      mbar_wait(full + (i + 1) % kRing, ((i + 1) / kRing) & 1);
      activate(i + 1);
    }
    wgmma_wait_all();
    fence_acc(acc);
    if ((i + 1) % kFoldD == 0 || i + 1 == n) fold(tot, acc);
    __syncthreads();
  }
  if (!p.need_ga) return;

  // epilogue: tot[4q + 2h + e] is ga at frame t0 + row0 + 8h, channel c0 + 8q
  // + 2 tig + e.  The block's x tile comes into shared memory by coalesced
  // copies while the ring is free, gx goes back in its place and out the
  // same way; galpha's and gbeta's terms are summed over the thread's 2 frames,
  // its warp's 8 lanes of a column (shuffles) and the 8 warps (shared
  // memory), in fixed orders
  constexpr int XS = BN + 8;     // row stride: float2 reads of a half-warp
                                 // hit distinct banks
  float* const xs = reinterpret_cast<float*>(smem);   // [kRows][XS]
  float* const coef = xs + kRows * XS;                 // [alpha, 1 / e][BN]
  float* const red = coef + 2 * BN;                    // [warp][2][BN]
  const int warp = tid / 32;
  const T* const x = static_cast<const T*>(p.x);
  const T* const xb = x + (size_t)b * p.T * p.C;
  T* const gxb = p.gx == nullptr
                     ? nullptr
                     : static_cast<T*>(p.gx) + (size_t)b * p.T * p.C;
  const T* const alpha = static_cast<const T*>(p.alpha);
  const T* const beta = static_cast<const T*>(p.beta);
  if (p.vec_x) {
    for (int e = tid; e < kRows * BN / 4; e += kThreads) {
      const int q = e % (BN / 4);
      const int r = e / (BN / 4);
      const int t = t0 + r;
      const int c = c0 + 4 * q;
      const bool ok = t < p.T && c < p.C;
      cp_async16(xs + r * XS + 4 * q, ok ? xb + (size_t)t * p.C + c : x, ok);
    }
  } else {
    for (int e = tid; e < kRows * BN; e += kThreads) {
      const int cc = e % BN;
      const int r = e / BN;
      const int t = t0 + r;
      const int c = c0 + cc;
      const bool ok = t < p.T && c < p.C;
      cp_async4(xs + r * XS + cc, ok ? xb + (size_t)t * p.C + c : x, ok);
    }
  }
  cp_async_commit();
  for (int c = tid; c < BN; c += kThreads) {
    const bool live = c0 + c < p.C;
    coef[c] = live ? widen(__ldg(alpha + c0 + c)) : 0.f;
    coef[BN + c] = live ? 1.0f / (widen(__ldg(beta + c0 + c)) + 1e-9f) : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = 8 * q + 2 * tig;
    float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      float2* const at = reinterpret_cast<float2*>(xs + r * XS + col);
      const float2 xv = *at;
      const float xe[2] = {xv.x, xv.y};
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // past C alpha and 1 / e are 0 (and x is): no term; past T no term
        const float al = coef[col + e];
        const float ib = coef[BN + col + e];
        const float ga = tot[4 * q + 2 * h + e];
        float sn, co;
        sincosf(xe[e] * al, &sn, &co);
        out[e] = ga * (1.0f + 2.0f * al * sn * co * ib);
        if (t0 + r < p.T) {
          pa[e] += ga * (2.0f * xe[e] * sn * co * ib);
          pb[e] += ga * (sn * sn * ib * ib);
        }
      }
      *at = make_float2(out[0], out[1]);
    }
    if (p.need_ab) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int m = 4; m < 32; m *= 2) {
          pa[e] += __shfl_xor_sync(0xffffffffu, pa[e], m);
          pb[e] += __shfl_xor_sync(0xffffffffu, pb[e], m);
        }
        if (lane < 4) {
          red[(warp * 2) * BN + col + e] = pa[e];
          red[(warp * 2 + 1) * BN + col + e] = pb[e];
        }
      }
    }
  }
  __syncthreads();
  if (gxb != nullptr) {
    if (p.vec_x) {
      float* const gxf = gxb;
      for (int e = tid; e < kRows * BN / 4; e += kThreads) {
        const int q = e % (BN / 4);
        const int r = e / (BN / 4);
        const int t = t0 + r;
        const int c = c0 + 4 * q;
        if (t < p.T && c < p.C)
          *reinterpret_cast<float4*>(gxf + (size_t)t * p.C + c) =
              *reinterpret_cast<const float4*>(xs + r * XS + 4 * q);
      }
    } else {
      for (int e = tid; e < kRows * BN; e += kThreads) {
        const int cc = e % BN;
        const int r = e / BN;
        const int t = t0 + r;
        const int c = c0 + cc;
        if (t < p.T && c < p.C) put(gxb + (size_t)t * p.C + c, xs[r * XS + cc]);
      }
    }
  }
  if (!p.need_ab) return;
  for (int i = tid; i < 2 * BN; i += kThreads) {
    const int which = i / BN;
    const int col = i % BN;
    const int c = c0 + col;
    if (c >= p.C) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[(w * 2 + which) * BN + col];
    p.part[mb * stride + (size_t)which * p.C + c] = which ? -s : s;
  }
}

template <int BN, int BK, int KT>
__global__ void __launch_bounds__(kThreads, 1)
snake_conv_dgrad_3xtf32(const __grid_constant__ CUtensorMap w_map,
                        const DgradParams p) {
  dgrad_block<BN, BK, KT>(&w_map, p);
}

// the bf16 dgrad: M frames (64 a consumer warpgroup) x BN input channels a
// tile, KT taps a stage (snake_conv_bf16.cuh)
template <int M, int BN, int KT>
__global__ void __launch_bounds__(snake16::block_threads(M, false), 1)
snake_conv_dgrad_bf16(const __grid_constant__ CUtensorMap w_map,
                      const __grid_constant__ CUtensorMap g_map,
                      const snake16::Params p) {
  snake16::block<M, BN, KT, false>(&w_map, &g_map, p);
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

// f32 wgrad: x, alpha, beta, g and an unsplit gw are f32, and so are the
// split partial sums
struct WgradParams {
  const void* x;        // (B, T, C)
  const void* alpha;
  const void* beta;
  const void* g;        // (B, T, O)
  void* gw;             // (k, O, Cw)
  float* ws;            // (splits, k * O * Cw) partial sums when splits > 1
  unsigned long long* count;
  int T, C, O, Cw, k, dilation, left;
  int groups;           // tap groups: k / KT
  int chunks_per_b;     // chunks of one signal
  int n_chunks;         // B * chunks_per_b
  int per_split, splits;
  int vec_x, vec_g;
};

size_t wgrad_smem(int bn, int kt, int dilation) {
  const int w = kFrames + (kt - 1) * dilation;
  return 1024 +                                              // alignment
         (size_t)2 * 2 * 4 * bn * kFrames +                  // activated
         (size_t)kRing * 4 * w * kGStride +                  // g windows
         (size_t)kRing * 4 * kFrames * (bn + 8) +            // raw x
         (size_t)2 * 4 * bn;                                 // alpha, 1 / e
}

// One block: 128 output channels x BN input channels x KT taps, over its
// split's chunks of 32 frames in order, in 3xTF32.
template <int BN, int KT>
__device__ __forceinline__ void wgrad_block(const WgradParams& p) {
  typedef float T;
  constexpr int kF = kFrames;                  // frames a chunk
  constexpr int per = 4;                       // elements of a 16-byte piece
  constexpr int XS = BN + 8;                   // row stride of the raw x tile
  constexpr int TILE = BN * kF;                // elements of an activated tile
  constexpr int KS = kF / 8;                   // MMA steps a chunk
  constexpr int kFold = kFoldW;                // fold every 128 frames
  static_assert(BN % 8 == 0 && (kF * BN) % kThreads == 0, "tiling");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int W = kF + (KT - 1) * p.dilation;      // g window rows
  T* const act = reinterpret_cast<T*>(smem);            // [2][hi, lo][TILE]
  T* const gwin = act + 4 * TILE;                      // [ring][W][kGStride]
  T* const xraw = gwin + kRing * W * kGStride;         // [ring][kF][XS]
  float* const al_s =
      reinterpret_cast<float*>(xraw + kRing * kF * XS);  // [BN]
  float* const ib_s = al_s + BN;                         // [BN]

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kOuts;
  const int c0 = (blockIdx.y / p.groups) * BN;
  const int j0 = (blockIdx.y % p.groups) * KT;
  const int split = blockIdx.z;
  const int first = split * p.per_split;
  const int n = min(p.n_chunks, first + p.per_split) - first;
  const int wg = tid / 128;
  const T* const x = static_cast<const T*>(p.x);
  const T* const g = static_cast<const T*>(p.g);

  if (p.count != nullptr && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0)
    atomicAdd(p.count, 1ull);
  for (int c = tid; c < BN; c += kThreads) {
    const bool live = c0 + c < p.C;
    al_s[c] = live ? widen(__ldg(static_cast<const T*>(p.alpha) + c0 + c))
                   : 0.f;
    ib_s[c] = live ? 1.0f / (widen(__ldg(static_cast<const T*>(p.beta) + c0 +
                                         c)) +
                             1e-9f)
                   : 0.f;
  }

  // chunk i of the split into ring slot i % kRing: its kF frames of x (BN
  // channels) and the g window every tap of the group reads (128
  // channels); zero past every edge; one cp.async group per call
  auto issue = [&](int i) {
    if (i < n) {
      const int ch = first + i;
      const int b = ch / p.chunks_per_b;
      const int f0 = (ch % p.chunks_per_b) * kF;
      const int slot = i % kRing;
      const T* const xb = x + (size_t)b * p.T * p.C;
      const T* const gb = g + (size_t)b * p.T * p.O;
      T* const xd = xraw + slot * kF * XS;
      T* const gd = gwin + slot * W * kGStride;
      const int tg0 = f0 + p.left - (j0 + KT - 1) * p.dilation;
      if (p.vec_x) {
        for (int e = tid; e < kF * BN / per; e += kThreads) {
          const int q = e % (BN / per);
          const int f = e / (BN / per);
          const int t = f0 + f;
          const int c = c0 + per * q;
          const bool ok = t < p.T && c < p.C;
          cp_async16(xd + f * XS + per * q, ok ? xb + (size_t)t * p.C + c : x,
                     ok);
        }
      } else {
        for (int e = tid; e < kF * BN; e += kThreads) {
          const int cc = e % BN;
          const int f = e / BN;
          const int t = f0 + f;
          const int c = c0 + cc;
          const bool ok = t < p.T && c < p.C;
          cp_async4(xd + f * XS + cc, ok ? xb + (size_t)t * p.C + c : x, ok);
        }
      }
      if (p.vec_g) {
        for (int e = tid; e < W * kOuts / per; e += kThreads) {
          const int q = e % (kOuts / per);
          const int r = e / (kOuts / per);
          const int t = tg0 + r;
          const int o = o0 + per * q;
          const bool ok = t >= 0 && t < p.T && o < p.O;
          cp_async16(gd + r * kGStride + per * q,
                     ok ? gb + (size_t)t * p.O + o : g, ok);
        }
      } else {
        for (int e = tid; e < W * kOuts; e += kThreads) {
          const int oo = e % kOuts;
          const int r = e / kOuts;
          const int t = tg0 + r;
          const int o = o0 + oo;
          const bool ok = t >= 0 && t < p.T && o < p.O;
          cp_async4(gd + r * kGStride + oo,
                    ok ? gb + (size_t)t * p.O + o : g, ok);
        }
      }
    }
    cp_async_commit();
  };

  // snake of chunk i's x in f32, into activated buffer i & 1, split into
  // tf32 halves, transposed: channel n's kF frames are one 128-byte row, its
  // 16-byte pieces swizzled (piece ^ (n % 8)) as a 128-byte-swizzle
  // descriptor reads them.  A warp takes 8 channels x 4 frames.
  auto activate = [&](int i) {
    const T* const xr = xraw + (i % kRing) * kF * XS;
    T* const ah = act + (i & 1) * 2 * TILE;
#pragma unroll 4
    for (int e = tid; e < kF * BN; e += kThreads) {
      const int lane = e & 31;
      const int w = e >> 5;
      const int nc = (w % (BN / 8)) * 8 + (lane & 7);
      const int f = (w / (BN / 8)) * 4 + (lane >> 3);
      const float xv = widen(xr[f * XS + nc]);
      const float sn = sinf(xv * al_s[nc]);
      const float v = xv + ib_s[nc] * (sn * sn);
      const int at = nc * kF + ((((f / per) ^ (nc & 7)) * per) | (f % per));
      float hi, lo;
      split_tf32(v, hi, lo);
      ah[at] = hi;
      ah[TILE + at] = lo;
    }
    fence_async_shared();
  };

  // this thread's fragment rows (output channels) inside the warpgroup's 64
  const int lane = tid % 32;
  const int orow = 64 * wg + ((tid / 32) % 4) * 16 + lane / 4;
  const int tig = lane % 4;

  float acc[KT][BN / 2], tot[KT][BN / 2];
#pragma unroll
  for (int jj = 0; jj < KT; ++jj) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[jj][e] = tot[jj][e] = 0.f;
    fence_acc(acc[jj]);
  }

  // chunk i: for each tap, A = g shifted by (KT - 1 - jj) * d rows of the
  // window, in registers, split there, small terms first; B = the activated
  // tile
  auto mma = [&](int i) {
    const T* const gd = gwin + (i % kRing) * W * kGStride;
    const T* const bh = act + (i & 1) * 2 * TILE;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      const int sh = (KT - 1 - jj) * p.dilation;
      uint32_t fh[KS][4], fl[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const float* const r0 = gd + (8 * ks + tig + sh) * kGStride + orow;
        const float* const r4 = r0 + 4 * kGStride;
        split_tf32(r0[0], fh[ks][0], fl[ks][0]);
        split_tf32(r0[8], fh[ks][1], fl[ks][1]);
        split_tf32(r4[0], fh[ks][2], fl[ks][2]);
        split_tf32(r4[8], fh[ks][3], fl[ks][3]);
      }
      // the fragments were written since the last fence
      wgmma_fence();
      const float* const bl = bh + TILE;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint64_t dh = make_desc<128>(bh + 8 * ks);
        const uint64_t dl = make_desc<128>(bl + 8 * ks);
        wgmma_tf32<BN>(acc[jj], fl[ks], dh);
        wgmma_tf32<BN>(acc[jj], fh[ks], dl);
        wgmma_tf32<BN>(acc[jj], fh[ks], dh);
      }
    }
    wgmma_commit();
  };

  issue(0);
  issue(1);
  cp_async_wait_prev();
  __syncthreads();
  if (n > 0) activate(0);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    mma(i);
    issue(i + 2);
    if (i + 1 < n) {
      cp_async_wait_prev();
      __syncthreads();     // chunk i + 1 is in
      activate(i + 1);
    }
    wgmma_wait_all();
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) fence_acc(acc[jj]);
    if ((i + 1) % kFold == 0 || i + 1 == n) {
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) fold(tot[jj], acc[jj]);
    }
    __syncthreads();       // chunk i + 1 is activated; chunk i's slot is free
  }

  // sums: tot[jj][4q + 2h + e] is output channel o0 + orow + 8h, input
  // channel c0 + 8q + 2 tig + e of tap j0 + jj; a split block writes its
  // partial sums to its own slab of ws, an unsplit one gw.  Past C the
  // activated tile is zero, so padded columns are written as 0.
#pragma unroll
  for (int jj = 0; jj < KT; ++jj) {
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int c = c0 + 8 * q + 2 * tig;
      if (c >= p.Cw) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + orow + 8 * h;
        if (o >= p.O) continue;
        const size_t at = ((size_t)(j0 + jj) * p.O + o) * p.Cw + c;
        const float v0 = tot[jj][4 * q + 2 * h];
        const float v1 = tot[jj][4 * q + 2 * h + 1];
        float* const dst = p.splits > 1
                               ? p.ws + (size_t)split * p.k * p.O * p.Cw
                               : static_cast<float*>(p.gw);
        *reinterpret_cast<float2*>(dst + at) = make_float2(v0, v1);
      }
    }
  }
}

template <int BN, int KT>
__global__ void __launch_bounds__(kThreads, 1)
snake_conv_wgrad_3xtf32(const WgradParams p) {
  wgrad_block<BN, KT>(p);
}

// ---------------------------------------------------------------------------
// bf16 wgrad
// ---------------------------------------------------------------------------

namespace wgrad16 {

using snake16::bf16;

constexpr int kF = 64;                // frames a chunk: four k16 steps
constexpr int kN = 64;                // input channels a tile: one x box
constexpr int kXBox = kF * 128;       // a chunk's x tile
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kBlock = 512;           // + the producer and snake warpgroups
// the warps that activate x: the producer warpgroup's last three and the
// fourth warpgroup
constexpr int kSnakes = kBlock - kConsumers - 32;

struct Params {
  const void* x;        // (B, T, C)
  const void* alpha;
  const void* beta;
  const void* g;        // (B, T, O)
  void* gw;             // (k, O, Cw), when the frame sum is one part
  float* ws;            // (splits, k * O * Cw) partial sums, when it is more
  unsigned long long* count;
  int T, C, O, Cw, k, dilation, left;
  int cpb;              // chunks of one signal
  int n_chunks, per_split, splits;
  int wsplit;           // 1: the consumer warpgroups take different output
                        // boxes; 2: the same ones, alternate chunks, their
                        // sums added in the block
  int gboxes;           // 64-channel boxes of g a slot holds
  int ctiles, otiles, tiles, n_items;
  int win;              // g window rows: kF + (KT - 1) * dilation
  int ring, slot_bytes, gbox_bytes;
  int tma_x, tma_g;     // x, g by TMA (else by the producer warp's loads)
  int coef_n;           // entries of each coefficient table: ctiles * kN
};

// one work item: input channels c0.., output channels o0.., taps j0..,
// chunks first.. first + n - 1 of the frame sum (split `split`)
struct Item {
  int c0, o0, j0, split, first, n;
};

template <int KT>
__device__ __forceinline__ Item item_of(const Params& p, int item) {
  Item it;
  const int tile = item % p.tiles;
  const int split = item / p.tiles;
  it.c0 = (tile % p.ctiles) * kN;
  const int rest = tile / p.ctiles;
  it.o0 = (rest % p.otiles) * p.gboxes * 64;
  it.j0 = (rest / p.otiles) * KT;
  it.split = split;
  it.first = split * p.per_split;
  it.n = min(p.n_chunks, it.first + p.per_split) - it.first;
  return it;
}

// A block walks work items (input channel tile x output channel tile x tap
// group x split of the frame sum) in turn.  A slot of the ring holds one
// 64-frame chunk: its x tile (64 frames x 64 channels), then `gboxes`
// boxes of the g window its taps read (win frames x 64 output channels),
// each 128-byte swizzled as TMA writes them.  Each consumer warpgroup
// multiplies U = OBW x KT units (an output box and a tap): A = the unit's
// 64 output channels x 16 frames of g, at the tap's row shift, by ldmatrix
// .trans; B = the activated x tile, MN-major.
template <int KT, int OBW>
__device__ __forceinline__ void block(const CUtensorMap* xmap,
                                      const CUtensorMap* gmap,
                                      const Params& p) {
  using namespace snake16;
  constexpr int U = OBW * KT;          // units a consumer warpgroup

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + kMaxRing;
  uint64_t* const ready = empty + kMaxRing;   // x activated
  uint8_t* const ring = smem + kBarBytes;
  float* const coef = reinterpret_cast<float*>(ring + p.ring * p.slot_bytes);
  // where the warpgroups alternate chunks, the second one's sums
  float* const red = coef + align1k(8 * p.coef_n) / 4;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  if (p.count != nullptr && tid == 0 && blockIdx.x == 0)
    atomicAdd(p.count, 1ull);
  if (tid == 0) {
    for (int s = 0; s < p.ring; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kConsumers / 32);
      bar_init(ready + s, kSnakes / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the block holds 128 registers a thread: a consumer takes 184 and the
    // others 72 (2 x 184 + 2 x 72 = 4 x 128)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    if (tid >= kConsumers + 32) {
      // ---------------------------------------------------------------- snake
      // each slot's x tile, in place, once its loads are in: 8 channels (a
      // 16-byte piece) a thread, every 28th row; alpha and 1 / (beta +
      // 1e-9) of every channel once a block, in f32, 0 past C
      const int at = tid - kConsumers - 32;
      const int q = at % 8;
      const bf16* const alpha = static_cast<const bf16*>(p.alpha);
      const bf16* const beta = static_cast<const bf16*>(p.beta);
      for (int c = at; c < p.coef_n; c += kSnakes) {
        const bool live = c < p.C;
        coef[c] = live ? __bfloat162float(alpha[c]) : 0.f;
        coef[p.coef_n + c] =
            live ? 1.0f / (__bfloat162float(beta[c]) + 1e-9f) : 0.f;
      }
      named_sync(1, kSnakes);
      int seq = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
        const Item it = item_of<KT>(p, item);
        for (int i = 0; i < it.n; ++i, ++seq) {
          const int slot = seq % p.ring;
          bar_wait(full + slot, (seq / p.ring) & 1);
          uint8_t* const xs = ring + slot * p.slot_bytes;
          const int c = it.c0 + 8 * q;
          if (c < p.C) {   // else zero, and stays zero
            float al[8], ib[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              al[e] = coef[c + e];
              ib[e] = coef[p.coef_n + c + e];
            }
#pragma unroll 2
            for (int r = at / 8; r < kF; r += kSnakes / 8)
              snake_piece(xs + r * 128 + ((q ^ (r & 7)) << 4), al, ib);
          }
          fence_async_shared();   // wgmma reads the tile (the async proxy)
          __syncwarp();
          if (lane == 0) bar_arrive(ready + slot);
        }
      }
      return;
    }
    // ------------------------------------------------------------- producer
    if (lane == 0) {
      if (p.tma_x)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(xmap))
                     : "memory");
      if (p.tma_g)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(gmap))
                     : "memory");
    }
    const bf16* const x = static_cast<const bf16*>(p.x);
    const bf16* const g = static_cast<const bf16*>(p.g);
    int seq = 0;
    for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
      const Item it = item_of<KT>(p, item);
      for (int i = 0; i < it.n; ++i, ++seq) {
        const int slot = seq % p.ring;
        if (seq >= p.ring) bar_wait(empty + slot, ((seq / p.ring) + 1) & 1);
        const int ch = it.first + i;
        const int b = ch / p.cpb;
        const int u0 = (ch % p.cpb) * kF;
        // the window's first frame: tap j0 + KT - 1 of the chunk's first
        const int tg0 = u0 + p.left - (it.j0 + KT - 1) * p.dilation;
        uint8_t* const sl = ring + slot * p.slot_bytes;
        // rows without 16-byte pieces (or unaligned): plain loads, zero past
        // every edge, in the swizzled layout TMA would write
        if (!p.tma_x) {
          for (int e = lane; e < kF * 64; e += 32) {
            const int c = e % 64;
            const int r = e / 64;
            const int t = u0 + r;
            const int cc = it.c0 + c;
            const bf16 v = t < p.T && cc < p.C
                               ? x[((size_t)b * p.T + t) * p.C + cc]
                               : __float2bfloat16_rn(0.f);
            *reinterpret_cast<bf16*>(sl + r * 128 + (((c / 8) ^ (r & 7)) << 4) +
                                     (c % 8) * 2) = v;
          }
        }
        if (!p.tma_g) {
          for (int e = lane; e < p.gboxes * p.win * 64; e += 32) {
            const int c = e % 64;
            const int r = (e / 64) % p.win;
            const int gb = e / (64 * p.win);
            const int t = tg0 + r;
            const int o = it.o0 + 64 * gb + c;
            const bf16 v = t >= 0 && t < p.T && o < p.O
                               ? g[((size_t)b * p.T + t) * p.O + o]
                               : __float2bfloat16_rn(0.f);
            *reinterpret_cast<bf16*>(sl + kXBox + gb * p.gbox_bytes +
                                     r * 128 + (((c / 8) ^ (r & 7)) << 4) +
                                     (c % 8) * 2) = v;
          }
        }
        __syncwarp();   // the lanes' stores before lane 0's arrival
        if (lane == 0) {
          bar_expect(full + slot, (p.tma_x ? kXBox : 0) +
                                      (p.tma_g ? p.gboxes * p.win * 128 : 0));
          if (p.tma_x) tma_3d(sl, xmap, full + slot, it.c0, u0, b);
          if (p.tma_g) {
            for (int gb = 0; gb < p.gboxes; ++gb)
              tma_3d(sl + kXBox + gb * p.gbox_bytes, gmap, full + slot,
                     it.o0 + 64 * gb, tg0, b);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n" ::: "memory");
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  // ldmatrix .trans: this lane's frame row of a 16-frame step and its
  // 16-byte chunk (8 output channels) of the warp's 16
  const int lrow = (lane / 16) * 8 + lane % 8;
  const int lchunk = 2 * warp + (lane / 8) % 2;
  const int tig = lane % 4;
  const int ob0 = p.wsplit == 1 ? wg * OBW : 0;   // this warpgroup's boxes
  float acc[U][kN / 2];

  int seq = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const Item it = item_of<KT>(p, item);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) acc[u][e] = 0.f;
      keep_f(acc[u]);
    }
    for (int i = 0; i < it.n; ++i, ++seq) {
      const int slot = seq % p.ring;
      bar_wait(ready + slot, (seq / p.ring) & 1);
      if (p.wsplit == 1 || (i & 1) == wg) {
        // the chunk's fragments, its MMAs as one group, waited for (the
        // other warpgroup's keep the tensor cores busy meanwhile)
        const uint8_t* const xs = ring + slot * p.slot_bytes;
        const uint8_t* const gs = xs + kXBox;
        uint32_t frag[U * 4][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = (KT - 1 - u % KT) * p.dilation + lrow;
          const uint32_t base =
              smem_addr(gs + (ob0 + u / KT) * p.gbox_bytes + r * 128 +
                        ((lchunk ^ (r & 7)) << 4));
#pragma unroll
          for (int s = 0; s < 4; ++s)
            ldsm_x4_t(frag[u * 4 + s], base + s * 2048);
        }
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_bf16_mn(acc[u], frag[u * 4 + s], desc128_mn(xs + s * 2048));
        wgmma_commit();
        wg_wait<0>();
#pragma unroll
        for (int u = 0; u < U; ++u) keep_f(acc[u]);
        keep_a(frag);
      }
      if (lane == 0) bar_arrive(empty + slot);
    }

    if (p.wsplit == 2) {
      // the second warpgroup's sums into the first's, through shared
      // memory, in that order (the first has read the last item's)
      named_sync(2, kConsumers);
      if (wg == 1) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int e = 0; e < kN / 2; ++e)
            red[(u * (kN / 2) + e) * 128 + tid % 128] = acc[u][e];
      }
      named_sync(3, kConsumers);
      if (wg == 1) continue;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < kN / 2; ++e)
          acc[u][e] += red[(u * (kN / 2) + e) * 128 + tid];
    }

    // acc[u][4q + 2h + e] is output channel o0 + 64 box + 16 warp + lane / 4
    // + 8h, input channel c0 + 8q + 2 tig + e, tap j0 + u % KT: the split's
    // sum goes to its own slab of ws (f32), or, as the only one, to gw
    // rounded once.  Past C the activated tile is zero, so padded columns
    // are written as 0.
    const bool direct = p.splits == 1;
    bf16* const gw = static_cast<bf16*>(p.gw);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = it.j0 + u % KT;
      const int orow = it.o0 + 64 * (ob0 + u / KT) + 16 * warp + lane / 4;
#pragma unroll
      for (int q = 0; q < kN / 8; ++q) {
        const int c = it.c0 + 8 * q + 2 * tig;
        if (c >= p.Cw) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = orow + 8 * h;
          if (o >= p.O) continue;
          const size_t at = ((size_t)j * p.O + o) * p.Cw + c;
          const float v0 = acc[u][4 * q + 2 * h];
          const float v1 = acc[u][4 * q + 2 * h + 1];
          if (direct)
            *reinterpret_cast<__nv_bfloat162*>(gw + at) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(
                p.ws + (size_t)it.split * p.k * p.O * p.Cw + at) =
                make_float2(v0, v1);
        }
      }
    }
  }
}

}  // namespace wgrad16

// the bf16 wgrad: KT taps and OBW output boxes a consumer warpgroup
template <int KT, int OBW>
__global__ void __launch_bounds__(wgrad16::kBlock, 1)
snake_conv_wgrad_bf16(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap g_map,
                      const wgrad16::Params p) {
  wgrad16::block<KT, OBW>(&x_map, &g_map, p);
}

// ---------------------------------------------------------------------------
// the fixed-order sum of per-block partials
// ---------------------------------------------------------------------------

// Over parts slabs of `stride` floats, output i of [0, n0 + n1 + n2) is the
// sum of ws[s * stride + i] over s, written to y0[i], y1[i - n0] or y2[i -
// n0 - n1] as Out (f32, or bf16 rounded once; a null y skips its outputs).
// A block takes 256 / G outputs and G groups of slabs: group r adds slabs
// r, r + G, ... in order, then the G group sums are added in order.  The
// same bits at every launch.
template <typename Out>
__global__ void sum_partials(const float* __restrict__ ws, long long stride,
                             int parts, int G, Out* y0, long long n0,
                             Out* y1, long long n1, Out* y2, long long n2,
                             unsigned long long* count) {
  __shared__ float red[kThreads];
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
  const int per = kThreads / G;
  const int lo = threadIdx.x % per;
  const int grp = threadIdx.x / per;
  const long long n = n0 + n1 + n2;
  for (long long base = (long long)blockIdx.x * per; base < n;
       base += (long long)gridDim.x * per) {
    const long long i = base + lo;
    Out* y = nullptr;
    long long at = 0;
    if (i < n0) {
      y = y0;
      at = i;
    } else if (i < n0 + n1) {
      y = y1;
      at = i - n0;
    } else if (i < n) {
      y = y2;
      at = i - n0 - n1;
    }
    float v = 0.f;
    if (y != nullptr)
      for (int s = grp; s < parts; s += G) v += ws[s * stride + i];
    red[threadIdx.x] = v;
    __syncthreads();
    if (grp == 0 && y != nullptr) {
      float t = red[lo];
      for (int r = 1; r < G; ++r) t += red[r * per + lo];
      put(y + at, t);
    }
    __syncthreads();
  }
}

template <typename Out>
int launch_sum_partials(const float* ws, long long stride, int parts,
                        Out* y0, long long n0, Out* y1, long long n1,
                        Out* y2, long long n2, unsigned long long* count,
                        cudaStream_t s) {
  int G = 1;
  while (G < parts && G < 32) G *= 2;
  const int per = kThreads / G;
  const long long n = n0 + n1 + n2;
  const long long most = (long long)kSMs * 8;
  const long long want = (n + per - 1) / per;
  sum_partials<Out><<<(int)(want < most ? want : most), kThreads, 0, s>>>(
      ws, stride, parts, G, y0, n0, y1, n1, y2, n2, count);
  return (int)cudaGetLastError();
}

// The same fixed-order sum, four outputs a thread by 16-byte loads (n and
// stride multiples of 4, ws 16-byte aligned): a block takes 4 * 256 / G
// outputs and G groups of slabs, group r adds slabs r, r + G, ... in
// order, then the G group sums are added in order.  G grows with the parts
// and shrinks with the outputs, so that some 64k threads keep loads in
// flight (the scalar kernel's grid-stride loop waits on one load a thread
// at a time).  The same bits at every launch of a shape.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
sum_partials4(const float* __restrict__ ws, long long stride, int parts,
              int G, Out* y, long long n, unsigned long long* count) {
  __shared__ float4 red[kThreads];
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
  const int per = kThreads / G;
  const int lo = threadIdx.x % per;
  const int grp = threadIdx.x / per;
  const long long i = ((long long)blockIdx.x * per + lo) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n) {
#pragma unroll 4
    for (int s = grp; s < parts; s += G) {
      const float4 w = *reinterpret_cast<const float4*>(ws + s * stride + i);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
  }
  red[threadIdx.x] = v;
  __syncthreads();
  if (grp == 0 && i < n) {
    float4 t = red[lo];
    for (int r = 1; r < G; ++r) {
      const float4 u = red[r * per + lo];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    put(y + i, t.x);
    put(y + i + 1, t.y);
    put(y + i + 2, t.z);
    put(y + i + 3, t.w);
  }
}

template <typename Out>
int launch_sum_partials4(const float* ws, long long stride, int parts,
                         Out* y, long long n, unsigned long long* count,
                         cudaStream_t s) {
  const long long quads = n / 4;
  int G = 1;
  while (G < 32 && G < parts && quads * G < 65536) G *= 2;
  const int per = kThreads / G;
  sum_partials4<Out><<<(int)((quads + per - 1) / per), kThreads, 0, s>>>(
      ws, stride, parts, G, y, n, count);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// plans and launches
// ---------------------------------------------------------------------------

// channels per stage of each f32 dgrad instance: the most that fits beside
// the other buffers at the main path's windows (146 rows at k = 3, d = 9)
int stage_channels(int bn, int kt) {
  return kt == 3 ? (bn == 64 ? 16 : 8) : (bn == 64 ? 32 : 16);
}

struct DgradPlan {
  int bn, bk, kt, groups, n_stages;
  size_t smem;
};

// dgrad's tile width for one shape: the forward's cost model (a stage costs
// its MMA cycles, its window's split and a fixed 600; a block its stages
// plus three; the grid whole waves over the 132 SMs), without a split of
// the channel sum, which the epilogue needs whole.
int dgrad_plan(int B, int T, int C, int O, int k, int dilation,
               DgradPlan* plan) {
  const int win = kRows + (k - 1) * dilation;
  const int nt = ceil_div(T, kRows) * B;
  const int kt = k % 3 == 0 ? 3 : 1;
  double best = -1.0;
  if (win > 256) return (int)cudaErrorInvalidValue;
  for (int bn = 64; bn <= 128; bn *= 2) {
    if (bn > 64 && ceil_div(C, bn) * bn >= 2 * C) continue;
    const int bk = stage_channels(bn, kt);
    const size_t smem = dgrad_smem(bn, bk, kt, win);
    if (smem > (size_t)kMaxSmem) continue;
    const int groups = k / kt;
    const int n_stages = ceil_div(O, bk) * groups;
    const double mma = 3.0 * kt * bk / 8 * bn;
    const double stage = mma + 0.5 * win * bk + 600.0;
    const int blocks = nt * ceil_div(C, bn);
    const double cost = (double)ceil_div(blocks, kSMs) * (n_stages + 3) * stage;
    if (best < 0 || cost < best) {
      best = cost;
      plan->bn = bn;
      plan->bk = bk;
      plan->kt = kt;
      plan->groups = groups;
      plan->n_stages = n_stages;
      plan->smem = smem;
    }
  }
  return best < 0 ? (int)cudaErrorInvalidValue : 0;
}

struct WgradPlan {
  int bn, kt, groups, per_split, splits;
  size_t smem;
};

// f32 wgrad's tile width and split of the frame sum: each 32-frame chunk
// costs its MMA cycles, its activation and a fixed 600, a block its chunks
// plus two, the grid whole waves; the split's partial sums cost their
// bytes, written and read back, at the card's memory rate (1914 bytes a
// cycle).
int wgrad_plan(int B, int T, int C, int O, int k, int dilation,
               WgradPlan* plan) {
  const int kt = k % 3 == 0 ? 3 : 1;
  const int frames = kFrames;
  const int n_chunks = B * ceil_div(T, frames);
  double best = -1.0;
  for (int bn = kt == 3 ? 32 : 64; bn <= (kt == 3 ? 32 : 128); bn *= 2) {
    if (bn > 64 && ceil_div(C, bn) * bn >= 2 * C) continue;
    const size_t smem = wgrad_smem(bn, kt, dilation);
    if (smem > (size_t)kMaxSmem) continue;
    const int groups = k / kt;
    const int tiles = ceil_div(O, kOuts) * ceil_div(C, bn) * groups;
    const double chunk = 12.0 * kt * bn + 0.4 * frames * bn + 600.0;
    const double out_bytes = 8.0 * k * O * (double)ceil_div(C, 4) * 4;
    for (int s = 1; s <= n_chunks && s <= 4 * kSMs; ++s) {
      const int per = ceil_div(n_chunks, s);
      const int splits = ceil_div(n_chunks, per);
      if (splits != s) continue;
      if ((long long)splits > 65535) continue;
      const double cost =
          (double)ceil_div(tiles * splits, kSMs) * (per + 2) * chunk +
          (splits > 1 ? splits * out_bytes / 1914.0 : 0.0);
      if (best < 0 || cost < best) {
        best = cost;
        plan->bn = bn;
        plan->kt = kt;
        plan->groups = groups;
        plan->per_split = per;
        plan->splits = splits;
        plan->smem = smem;
      }
    }
  }
  return best < 0 ? (int)cudaErrorInvalidValue : 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// (k * C, Ow) rows of a weight array of f32 or bf16 values, boxes of BK
// channels x BN rows, swizzled by the box's row bytes
int weight_map(CUtensorMap* map, const void* w, int rows, int cols, int bk,
               int bn, bool bf16 = false) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const int elem = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)bn};
  const cuuint32_t estrides[2] = {1, 1};
  const int row_bytes = bk * elem;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(w), dims, strides, box, estrides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int BK, int KT>
int launch_dgrad(const void* wt, int Ow, const DgradParams& p,
                 const DgradPlan& plan, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        snake_conv_dgrad_3xtf32<BN, BK, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap map;
  const int err = weight_map(&map, wt, p.k * p.C, Ow, BK, BN);
  if (err) return err;
  dim3 grid(ceil_div(p.T, kRows), ceil_div(p.C, BN), B);
  snake_conv_dgrad_3xtf32<BN, BK, KT><<<grid, kThreads, plan.smem, stream>>>(
      map, p);
  return (int)cudaGetLastError();
}

template <int M, int BN, int KT>
int launch_dgrad16(const snake16::Plan& plan, const CUtensorMap& w,
                   const CUtensorMap& g, const snake16::Params& p,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        snake_conv_dgrad_bf16<M, BN, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, snake16::kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  snake_conv_dgrad_bf16<M, BN, KT>
      <<<plan.grid, snake16::block_threads(M, false), plan.smem, stream>>>(
          w, g, p);
  return (int)cudaGetLastError();
}

template <int BN, int KT>
int launch_wgrad(const WgradParams& p, const WgradPlan& plan,
                 cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        snake_conv_wgrad_3xtf32<BN, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(ceil_div(p.O, kOuts), ceil_div(p.C, BN) * plan.groups,
            plan.splits);
  snake_conv_wgrad_3xtf32<BN, KT><<<grid, kThreads, plan.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

namespace wgrad16 {

struct Plan {
  int kt, obw, wsplit, gboxes, ctiles, otiles, tiles;
  int per_split, splits, n_items, grid, ring, slot_bytes, gbox_bytes, win;
  size_t smem;
};

// The bf16 wgrad's tile (KT taps and OBW output boxes a consumer
// warpgroup; the warpgroups on other output boxes or alternate chunks) and
// split of the frame sum for one shape, from a model of its time on an
// H100: a chunk costs the larger of its tensor-core cycles (a warpgroup's
// m64n64k16 counted as 132; both warpgroups share the tensor cores) and its
// snake (31 cycles a row), plus a fixed 300; a block its chunks and two
// more for each of its items, the grid whole rounds of items over the 132
// SMs; a split sum adds its f32 slabs, written and read back, at 3600
// bytes a cycle (they stay in L2).  Fitted to the kernel's times with each
// tile forced at the encoder's shapes (scripts/torch_bf16_tiles.py): the
// plan's choices come within 0.4% of the best forced tile a bf16 generator
// step.  (Tiles of 128 input channels were slower at every k = 1 shape.)
constexpr double kChunkCycles = 300.0;   // a chunk's fixed cycles
constexpr double kMmaCycles = 132.0;     // an m64n64k16's cycles
constexpr double kSnakeCycles = 31.0;    // the snake of a row
constexpr double kPartBytes = 3600.0;    // partials' bytes a cycle

int make_plan(int B, int T, int C, int O, int k, int dilation, Plan* plan) {
  using snake16::align1k;
  const int kt = k % 3 == 0 ? 3 : 1;
  const int win = kF + (kt - 1) * dilation;
  if (win > 256) return (int)cudaErrorInvalidValue;   // a TMA box's rows
  const int groups = k / kt;
  const int n_chunks = B * ceil_div(T, kF);
  const int oboxes = ceil_div(O, 64);
  const double out_bytes = 8.0 * k * O * (double)ceil_div(C, 8) * 8;
  const int gbox_bytes = align1k(win * 128);
  const int ctiles = ceil_div(C, kN);
  double best = -1.0;
  for (int obw = 1; obw <= (kt == 3 ? 1 : 2); ++obw) {
    for (int wsplit = 1; wsplit <= 2; ++wsplit) {
      // the second warpgroup would find no output box of its own
      if (wsplit == 1 && oboxes <= obw) continue;
      const int gboxes = obw * (3 - wsplit);
      const int slot = kXBox + gboxes * gbox_bytes;
      // the coefficients; where the warpgroups alternate chunks, the
      // second one's sums
      const int extra = align1k(8 * ctiles * kN) +
                        (wsplit == 2 ? 128 * obw * kt * kN / 2 * 4 : 0);
      const int room = snake16::kMaxSmem - 1024 - snake16::kBarBytes - extra;
      int ring = room / slot;
      if (ring > snake16::kMaxRing) ring = snake16::kMaxRing;
      if (ring < 2) continue;
      const int otiles = ceil_div(oboxes, gboxes);
      const int tiles = otiles * ctiles * groups;
      const double mma = (3 - wsplit) * obw * kt * 4.0 * kMmaCycles;
      const double snake = kSnakeCycles * kF;
      const double chunk = (mma > snake ? mma : snake) + kChunkCycles;
      for (int s = 1; s <= n_chunks && s <= 4 * kSMs; ++s) {
        const int per = ceil_div(n_chunks, s);
        const int splits = ceil_div(n_chunks, per);
        if (splits != s) continue;
        const int items = tiles * splits;
        const double cost =
            (double)ceil_div(items, kSMs) * (per + 2) * chunk +
            (splits > 1 ? splits * out_bytes / kPartBytes : 0.0);
        if (best < 0 || cost < best) {
          best = cost;
          plan->kt = kt;
          plan->obw = obw;
          plan->wsplit = wsplit;
          plan->gboxes = gboxes;
          plan->ctiles = ctiles;
          plan->otiles = otiles;
          plan->tiles = tiles;
          plan->per_split = per;
          plan->splits = splits;
          plan->n_items = items;
          plan->grid = items < kSMs ? items : kSMs;
          plan->ring = ring;
          plan->slot_bytes = slot;
          plan->gbox_bytes = gbox_bytes;
          plan->win = win;
          plan->smem = (size_t)1024 + snake16::kBarBytes +
                       (size_t)ring * slot + extra;
        }
      }
    }
  }
  return best < 0 ? (int)cudaErrorInvalidValue : 0;
}

template <int KT, int OBW>
int launch(const Plan& plan, const CUtensorMap& xmap, const CUtensorMap& gmap,
           const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        snake_conv_wgrad_bf16<KT, OBW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, snake16::kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  snake_conv_wgrad_bf16<KT, OBW>
      <<<plan.grid, kBlock, plan.smem, stream>>>(xmap, gmap, p);
  return (int)cudaGetLastError();
}
}  // namespace wgrad16

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

int backward_plan(int B, int T, int C, int O, int k, int dilation, int* out,
                  bool bf16) {
  if (B <= 0 || T <= 0 || C <= 0 || O <= 0 || k <= 0 || dilation <= 0)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    snake16::Plan dp;
    int err = snake16::make_plan(false, B, T, O, C, k, dilation, &dp);
    if (err) return err;
    wgrad16::Plan wp;
    err = wgrad16::make_plan(B, T, C, O, k, dilation, &wp);
    if (err) return err;
    out[0] = dp.bn;
    out[1] = snake16::kStage;
    out[2] = B * dp.mtiles;
    out[3] = wgrad16::kN;
    out[4] = wp.splits;
  } else {
    DgradPlan dp;
    int err = dgrad_plan(B, T, C, O, k, dilation, &dp);
    if (err) return err;
    WgradPlan wp;
    err = wgrad_plan(B, T, C, O, k, dilation, &wp);
    if (err) return err;
    out[0] = dp.bn;
    out[1] = dp.bk;
    out[2] = B * ceil_div(T, kRows);
    out[3] = wp.bn;
    out[4] = wp.splits;
  }
  return 0;
}

// the bf16 dgrad and its sum of partials (see the extern entry)
int run_dgrad16(const void* g, const void* x, const void* alpha,
                const void* beta, const void* wt, void* gx, float* ws,
                void* galpha, void* gbeta, void* gb, int B, int T, int C,
                int O, int k, int dilation, int left, int Ow,
                unsigned long long* counts, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || O <= 0 || k <= 0 || dilation <= 0 ||
      left < 0 || left > (k - 1) * dilation || Ow < O || Ow % 8 != 0 ||
      !aligned16(wt))
    return (int)cudaErrorInvalidValue;
  const bool need_ab = galpha != nullptr || gbeta != nullptr;
  const bool need_sums = need_ab || gb != nullptr;
  if (gx == nullptr && !need_sums) return 0;
  if (need_sums && ws == nullptr) return (int)cudaErrorInvalidValue;
  snake16::Plan plan;
  int err = snake16::make_plan(false, B, T, O, C, k, dilation, &plan);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  snake16::Params p = {};
  p.a = g;
  p.alpha = alpha;
  p.beta = beta;
  p.x = x;
  p.out = gx;
  p.ws = ws;
  p.count = counts;
  p.B = B;
  p.T = T;
  p.Ka = O;
  p.N = C;
  p.C = C;
  p.O = O;
  p.k = k;
  p.dilation = dilation;
  p.lead = (k - 1) * dilation - left;
  p.vec_x = C % 8 == 0 && aligned16(x) && (gx == nullptr || aligned16(gx));
  p.need_ga = gx != nullptr || need_ab;
  p.need_ab = need_ab;
  p.need_gb = gb != nullptr;
  CUtensorMap wmap, gmap;
  err = snake16::prepare(plan, wt, Ow, &p, &wmap, &gmap);
  if (err) return err;
  int e;
  switch ((plan.m / 64) * 1000 + plan.bn * 4 + plan.kt) {
    case 2000 + 64 * 4 + 3: e = launch_dgrad16<128, 64, 3>(plan, wmap, gmap, p, s); break;
    case 2000 + 128 * 4 + 3: e = launch_dgrad16<128, 128, 3>(plan, wmap, gmap, p, s); break;
    case 2000 + 64 * 4 + 1: e = launch_dgrad16<128, 64, 1>(plan, wmap, gmap, p, s); break;
    case 2000 + 128 * 4 + 1: e = launch_dgrad16<128, 128, 1>(plan, wmap, gmap, p, s); break;
    case 1000 + 64 * 4 + 3: e = launch_dgrad16<64, 64, 3>(plan, wmap, gmap, p, s); break;
    case 1000 + 128 * 4 + 3: e = launch_dgrad16<64, 128, 3>(plan, wmap, gmap, p, s); break;
    case 1000 + 64 * 4 + 1: e = launch_dgrad16<64, 64, 1>(plan, wmap, gmap, p, s); break;
    default: e = launch_dgrad16<64, 128, 1>(plan, wmap, gmap, p, s);
  }
  if (e != 0 || !need_sums) return e;
  typedef __nv_bfloat16 bf;
  return launch_sum_partials<bf>(
      ws, 2 * (long long)C + O, B * plan.mtiles, static_cast<bf*>(galpha), C,
      static_cast<bf*>(gbeta), C, static_cast<bf*>(gb), O,
      counts == nullptr ? nullptr : counts + 2, s);
}

// the f32 dgrad and its sum of partials (see the extern entries)
template <typename T>
int run_dgrad(const void* g, const void* x, const void* alpha,
              const void* beta, const void* wt, void* gx, float* ws,
              void* galpha, void* gbeta, void* gb, int B, int T_, int C,
              int O, int k, int dilation, int left, int Ow,
              unsigned long long* counts, void* stream) {
  constexpr int per = 16 / (int)sizeof(T);
  if (B <= 0 || T_ <= 0 || C <= 0 || O <= 0 || k <= 0 || dilation <= 0 ||
      left < 0 || left > (k - 1) * dilation || Ow < O || Ow % per != 0 ||
      !aligned16(wt) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const bool need_ab = galpha != nullptr || gbeta != nullptr;
  const bool need_sums = need_ab || gb != nullptr;
  if (gx == nullptr && !need_sums) return 0;
  if (need_sums && ws == nullptr) return (int)cudaErrorInvalidValue;
  DgradPlan plan;
  const int err = dgrad_plan(B, T_, C, O, k, dilation, &plan);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  DgradParams p;
  p.g = g;
  p.x = x;
  p.alpha = alpha;
  p.beta = beta;
  p.gx = gx;
  p.part = ws;
  p.count = counts;
  p.T = T_;
  p.C = C;
  p.O = O;
  p.k = k;
  p.dilation = dilation;
  p.lead = (k - 1) * dilation - left;
  p.win = kRows + (k - 1) * dilation;
  p.groups = plan.groups;
  p.n_stages = plan.n_stages;
  p.vec_g = O % per == 0 && aligned16(g);
  p.vec_x = C % per == 0 && aligned16(x) && (gx == nullptr || aligned16(gx));
  p.need_ga = gx != nullptr || need_ab;
  p.need_ab = need_ab;
  p.need_gb = gb != nullptr;
  int e;
  switch (plan.bn * 4 + plan.kt) {
    case 64 * 4 + 3: e = launch_dgrad<64, 16, 3>(wt, Ow, p, plan, B, s); break;
    case 128 * 4 + 3: e = launch_dgrad<128, 8, 3>(wt, Ow, p, plan, B, s); break;
    case 64 * 4 + 1: e = launch_dgrad<64, 32, 1>(wt, Ow, p, plan, B, s); break;
    default: e = launch_dgrad<128, 16, 1>(wt, Ow, p, plan, B, s);
  }
  if (e != 0 || !need_sums) return e;
  return launch_sum_partials<T>(
      ws, 2 * (long long)C + O, B * ceil_div(T_, kRows),
      static_cast<T*>(galpha), C, static_cast<T*>(gbeta), C,
      static_cast<T*>(gb), O, counts == nullptr ? nullptr : counts + 2, s);
}

// the f32 wgrad and (when its plan splits the frame sum) its sum of
// partials
int run_wgrad(const void* x, const void* alpha, const void* beta,
              const void* g, void* gw, float* ws, int B, int T_, int C, int O,
              int k, int dilation, int left, int Cw,
              unsigned long long* counts, void* stream) {
  constexpr int per = 4;
  if (B <= 0 || T_ <= 0 || C <= 0 || O <= 0 || k <= 0 || dilation <= 0 ||
      left < 0 || left > (k - 1) * dilation || Cw < C || Cw % per != 0 ||
      !aligned16(gw))
    return (int)cudaErrorInvalidValue;
  WgradPlan plan;
  const int err = wgrad_plan(B, T_, C, O, k, dilation, &plan);
  if (err) return err;
  if (plan.splits > 1 && (ws == nullptr || !aligned16(ws)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  WgradParams p;
  p.x = x;
  p.alpha = alpha;
  p.beta = beta;
  p.g = g;
  p.gw = gw;
  p.ws = ws;
  p.count = counts == nullptr ? nullptr : counts + 1;
  p.T = T_;
  p.C = C;
  p.O = O;
  p.Cw = Cw;
  p.k = k;
  p.dilation = dilation;
  p.left = left;
  p.groups = plan.groups;
  p.chunks_per_b = ceil_div(T_, kFrames);
  p.n_chunks = B * p.chunks_per_b;
  p.per_split = plan.per_split;
  p.splits = plan.splits;
  p.vec_x = C % per == 0 && aligned16(x);
  p.vec_g = O % per == 0 && aligned16(g);
  int e;
  switch (plan.bn * 4 + plan.kt) {
    case 32 * 4 + 3: e = launch_wgrad<32, 3>(p, plan, s); break;
    case 64 * 4 + 1: e = launch_wgrad<64, 1>(p, plan, s); break;
    default: e = launch_wgrad<128, 1>(p, plan, s);
  }
  if (e != 0 || plan.splits == 1) return e;
  const long long n = (long long)k * O * Cw;
  return launch_sum_partials<float>(ws, n, plan.splits, static_cast<float*>(gw),
                                    n, nullptr, 0, nullptr, 0,
                                    counts == nullptr ? nullptr : counts + 2,
                                    s);
}

// the bf16 wgrad and (when its plan sums in more than one part) its sum of
// partials
int run_wgrad16(const void* x, const void* alpha, const void* beta,
                const void* g, void* gw, float* ws, int B, int T, int C,
                int O, int k, int dilation, int left, int Cw,
                unsigned long long* counts, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || O <= 0 || k <= 0 || dilation <= 0 ||
      left < 0 || left > (k - 1) * dilation || Cw < C || Cw % 8 != 0 ||
      !aligned16(gw))
    return (int)cudaErrorInvalidValue;
  wgrad16::Plan plan;
  int err = wgrad16::make_plan(B, T, C, O, k, dilation, &plan);
  if (err) return err;
  const int parts = plan.splits;
  if (parts > 1 && (ws == nullptr || !aligned16(ws)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  wgrad16::Params p = {};
  p.x = x;
  p.alpha = alpha;
  p.beta = beta;
  p.g = g;
  p.gw = gw;
  p.ws = ws;
  p.count = counts == nullptr ? nullptr : counts + 1;
  p.T = T;
  p.C = C;
  p.O = O;
  p.Cw = Cw;
  p.k = k;
  p.dilation = dilation;
  p.left = left;
  p.cpb = ceil_div(T, wgrad16::kF);
  p.n_chunks = B * p.cpb;
  p.per_split = plan.per_split;
  p.splits = plan.splits;
  p.wsplit = plan.wsplit;
  p.gboxes = plan.gboxes;
  p.ctiles = plan.ctiles;
  p.otiles = plan.otiles;
  p.tiles = plan.tiles;
  p.n_items = plan.n_items;
  p.win = plan.win;
  p.ring = plan.ring;
  p.slot_bytes = plan.slot_bytes;
  p.gbox_bytes = plan.gbox_bytes;
  p.tma_x = C % 8 == 0 && aligned16(x);
  p.tma_g = O % 8 == 0 && aligned16(g);
  p.coef_n = plan.ctiles * wgrad16::kN;
  // boxes of 64 channels x 64 frames of x, 64 channels x win frames of g
  CUtensorMap xmap, gmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&gmap, 0, sizeof(gmap));
  if (p.tma_x) {
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
    err = snake16::bf16_map(&xmap, x, 3, dims, wgrad16::kF, 1);
    if (err) return err;
  }
  if (p.tma_g) {
    const cuuint64_t dims[3] = {(cuuint64_t)O, (cuuint64_t)T, (cuuint64_t)B};
    err = snake16::bf16_map(&gmap, g, 3, dims, plan.win, 1);
    if (err) return err;
  }
  int e;
  switch (plan.kt * 10 + plan.obw) {
    case 31: e = wgrad16::launch<3, 1>(plan, xmap, gmap, p, s); break;
    case 11: e = wgrad16::launch<1, 1>(plan, xmap, gmap, p, s); break;
    default: e = wgrad16::launch<1, 2>(plan, xmap, gmap, p, s);
  }
  if (e != 0 || parts == 1) return e;
  typedef __nv_bfloat16 bf;
  const long long n = (long long)k * O * Cw;
  return launch_sum_partials4<bf>(ws, n, parts, static_cast<bf*>(gw), n,
                                  counts == nullptr ? nullptr : counts + 2, s);
}

}  // namespace

extern "C" {

// The tiling a backward of this shape takes: out[0..2] = dgrad's input
// channels per block, output channels per stage and rows of partial sums
// (its blocks: B * ceil(T / 128)); out[3..4] = wgrad's input channels per
// block and splits of the frame sum.
int snake_conv_backward_plan(int B, int T, int C, int O, int k, int dilation,
                             int* out) {
  return backward_plan(B, T, C, O, k, dilation, out, false);
}

// The same for the bf16 kernels (dgrad: 64 output channels a stage, rows
// of partial sums B * ceil(T / frames of its tile)).
int snake_conv_backward_plan_bf16(int B, int T, int C, int O, int k,
                                  int dilation, int* out) {
  return backward_plan(B, T, C, O, k, dilation, out, true);
}

// The bf16 dgrad's whole plan: out[0..5] = frames a tile, input channels a
// tile, output channels a stage, slots of the ring, rows of partial sums,
// blocks (persistent, at most one an SM).
int snake_conv_backward_plan_bf16_tiles(int B, int T, int C, int O, int k,
                                        int dilation, int* out) {
  if (B <= 0 || T <= 0 || C <= 0 || O <= 0 || k <= 0 || dilation <= 0)
    return (int)cudaErrorInvalidValue;
  snake16::Plan plan;
  const int err = snake16::make_plan(false, B, T, O, C, k, dilation, &plan);
  if (err) return err;
  out[0] = plan.m;
  out[1] = plan.bn;
  out[2] = snake16::kStage;
  out[3] = plan.ring;
  out[4] = B * plan.mtiles;
  out[5] = plan.grid;
  return 0;
}

// The bf16 wgrad's whole plan: out[0..7] = input channels a tile, taps a
// stage, output channels a block, 2 where the consumer warpgroups alternate
// chunks (else 1), slots of the ring, splits of the frame sum (slabs of
// partial sums), work items, blocks (persistent, at most one an SM).
int snake_conv_backward_plan_bf16_wgrad(int B, int T, int C, int O, int k,
                                        int dilation, int* out) {
  if (B <= 0 || T <= 0 || C <= 0 || O <= 0 || k <= 0 || dilation <= 0)
    return (int)cudaErrorInvalidValue;
  wgrad16::Plan plan;
  const int err = wgrad16::make_plan(B, T, C, O, k, dilation, &plan);
  if (err) return err;
  out[0] = wgrad16::kN;
  out[1] = plan.kt;
  out[2] = 64 * plan.gboxes;
  out[3] = plan.wsplit;
  out[4] = plan.ring;
  out[5] = plan.splits;
  out[6] = plan.n_items;
  out[7] = plan.grid;
  return 0;
}

// dgrad, then the sum of its partials, on `stream`; returns a CUDA error
// code (0 on success).  wt is (k, C, Ow), wt[j] = W[j] transposed, Ow >= O
// a multiple of 4 with zeros past O, 16-byte aligned.  gx, galpha, gbeta
// and gb may each be null (not wanted); ws holds B * ceil(T / 128) * (2C + O) floats when galpha, gbeta
// or gb is wanted.  counts, when not null, is three device counters:
// counts[0] counts dgrad's launches, counts[2] those of sum_partials.
int snake_conv_backward_dgrad_f32(const float* g, const float* x,
                                  const float* alpha, const float* beta,
                                  const float* wt,
                                  float* gx, float* ws, float* galpha,
                                  float* gbeta, float* gb, int B, int T,
                                  int C, int O, int k, int dilation, int left,
                                  int Ow, unsigned long long* counts,
                                  void* stream) {
  return run_dgrad<float>(g, x, alpha, beta, wt, gx, ws, galpha, gbeta, gb,
                          B, T, C, O, k, dilation, left, Ow, counts, stream);
}

// The bf16 instantiation: g, x, alpha, beta, wt, gx, galpha, gbeta and gb
// are bf16 (passed as untyped pointers), Ow a multiple of 8; ws stays f32,
// its sums rounded to bf16 once.  counts as for f32, the bf16 kernels'
// own three counters.
int snake_conv_backward_dgrad_bf16(const void* g, const void* x,
                                   const void* alpha, const void* beta,
                                   const void* wt, void* gx, float* ws,
                                   void* galpha, void* gbeta, void* gb, int B,
                                   int T, int C, int O, int k, int dilation,
                                   int left, int Ow,
                                   unsigned long long* counts, void* stream) {
  return run_dgrad16(g, x, alpha, beta, wt, gx, ws, galpha, gbeta, gb, B, T,
                     C, O, k, dilation, left, Ow, counts, stream);
}

// wgrad, then (when its plan splits the frame sum) the sum of its partials,
// on `stream`; returns a CUDA error code.  gw is (k, O, Cw), Cw >= C a
// multiple of 4, 16-byte aligned, written whole (zeros past C); ws holds
// splits * k * O * Cw floats when the plan splits.  counts, when not null,
// is the three device counters: counts[1] counts wgrad's launches,
// counts[2] those of sum_partials.
int snake_conv_backward_wgrad_f32(const float* x, const float* alpha,
                                  const float* beta, const float* g,
                                  float* gw, float* ws, int B, int T, int C,
                                  int O, int k, int dilation, int left,
                                  int Cw, unsigned long long* counts,
                                  void* stream) {
  return run_wgrad(x, alpha, beta, g, gw, ws, B, T, C, O, k, dilation, left,
                   Cw, counts, stream);
}

// The bf16 wgrad: x, alpha, beta, g and gw bf16, Cw a multiple of 8; ws
// holds splits * k * O * Cw floats when the plan splits the frame sum
// (out[4] of snake_conv_backward_plan_bf16), summed and rounded to bf16
// once (an unsplit gw is rounded once in the kernel).
int snake_conv_backward_wgrad_bf16(const void* x, const void* alpha,
                                   const void* beta, const void* g, void* gw,
                                   float* ws, int B, int T, int C, int O,
                                   int k, int dilation, int left, int Cw,
                                   unsigned long long* counts, void* stream) {
  return run_wgrad16(x, alpha, beta, g, gw, ws, B, T, C, O, k, dilation, left,
                     Cw, counts, stream);
}

}  // extern "C"
