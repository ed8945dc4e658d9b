// Fused SnakeBeta activation + dilated 1-D convolution in f32 on Hopper's
// tensor cores (sm_90a): an implicit GEMM in 3xTF32 on wgmma.
//
//   y[b,t,o] = bias[o] + sum_{j<k} sum_c snake(xpad[b, t + j*d, c]) * W[o,c,j]
//   snake(x) = x + sin^2(alpha_c * x) / (beta_c + 1e-9)
//
// x is (B, T, C) and y is (B, T, O).  The weight is read as two (k, O, Cw)
// arrays, Cw >= C a multiple of 4 with zeros past C: w itself, whose top 19
// bits the tensor cores read as its tf32 high part, and lo = tf32(w - that
// high part), kept beside it by the caller.  Tap j's rows W[:, :, j] are then
// K-major (channels contiguous), as tf32 wgmma needs.  The pad is zero and
// `left` frames of it sit before t = 0 (causal: (k-1)d, centered:
// ceil((k-1)d / 2)); snake(0) == 0, so activating the zero pad equals padding
// the activation.
//
// Replaces the TPU kernel after_tpu/ops/pallas/fused_conv.py (_kernel,
// launched by _pallas_forward from fused_snake_causal_conv).  Like it, the
// activation is computed from x while the input window is staged on chip,
// so the snake output never goes to device memory.
//
// What bounds it: operations.  The base codec's 96 convs of one 524288-sample
// transfer are 147.98 GFLOP against about 1.43 GB of traffic.  3xTF32 runs
// three tf32 products per multiply-add, so at the H100's 495 TFLOP/s of TF32
// no run can take less than 0.90 ms per transfer (the memory floor is
// 0.43 ms; the f32 CUDA cores alone would need 2.22 ms).
//
// The GEMM: M is frames, N output channels, K channels x taps.  A block has
// two warpgroups and computes 128 frames x BN output channels, the sums in
// f32 registers.  It walks its share of the channel sum in stages of BK
// channels x KT taps (KT = 3 for k = 3, else 1):
//
//  - Pipeline: a ring of three stages in shared memory.  Stage s + 2 is in
//    flight while stage s runs: its weight tiles (hi and lo, one 2-D TMA box
//    per tap, swizzled 32, 64 or 128 bytes to match BK) complete on an
//    mbarrier, its raw input window [t0 - left, t0 + 128 + right) x BK
//    channels, with the chunk's alpha and beta, comes by cp.async (16-byte
//    copies, 4-byte ones when C is not a multiple of 4; zero fill past every
//    edge).
//  - Snake once per staged element: each window element is activated with
//    the full-accuracy sinf and split once into hi = tf32(v), lo = tf32(v -
//    hi) (cvt.rna), into a double buffer, then used by every tap and by all
//    BN output channels.  Stage s + 1 is activated right after the MMAs of
//    stage s are issued.
//  - 3xTF32: for each 8-channel step of each tap, three wgmma m64nBNk8
//    .tf32 into the same sums, small terms first: a_lo*b_hi, a_hi*b_lo,
//    a_hi*b_hi.  That keeps f32 accuracy (the dropped a_lo*b_lo is 2^-22 of
//    the product).
//  - A from registers: tap j's A tile starts j*d rows into the window, and
//    d = 1, 3, 9 is not a multiple of the 8-row core matrix, so no shared
//    memory descriptor can point at it.  Each thread loads its fragments of
//    the activated window with ld.shared instead (columns stored in the order
//    that puts a thread's two columns side by side, rows padded so that a
//    half-warp's 8-byte loads hit distinct banks), all of a stage's at once,
//    and then issues the stage's MMAs as one group.  B (weights) is read by
//    the tensor cores from the swizzled TMA tiles through descriptors.
//  - Filling the card: BN is 64, 128 or 256 (as wide as O allows without
//    doubling it), and the channel sum may be split over blocks (gridDim.z).
//    A cost model fitted to this kernel's times (make_plan) picks both per
//    shape; it ends up filling one wave of about 128 blocks, which at the
//    1024-frame stages means splitting the sum 5 to 8 ways.  Split blocks
//    store their partial sums in a scratch buffer (the caller's ``ws``, one
//    (B, T, O) slab per split), and a second kernel (sum_splits) adds the
//    slabs in split order: the output does not depend on the order the
//    blocks run in, so every launch of a shape, eager or replayed from a
//    CUDA graph, gives the same bits.
//
// The bf16 kernel (snake_conv_bf16) is a design of its own for bf16, in
// snake_conv_bf16.cuh (the main loop it shares with the backward's dgrad):
// x, alpha, beta, the weight and the bias are bf16, and the weight is one
// (k, O, Cw) array, Cw a multiple of 8 (TMA rows of 16 bytes), with no low
// half.  A producer warp keeps TMA loads of 64-channel stages (weight tiles
// and the input window) in flight in a ring of slots, seven warps activate
// each window in place (the snake in f32, rounded to bf16 once), and the
// consumer warpgroups run one bf16 wgmma m64nNk16 a 16-channel step, A
// from registers by ldmatrix, B from the swizzled tiles; blocks are
// persistent over the output tiles.  The sums stay in f32 and take the bias in f32; the output
// is rounded to bf16 once.  A split channel sum keeps its f32 partial
// slabs, which sum_splits_bf16 adds in split order before the one
// rounding: the output has the same bits from launch to launch.
//
// Every shape runs these kernels: ragged T, C and O are masked and any B
// is taken.  A launch error is returned to the caller, which raises.  Each
// kernel adds one to a device counter the caller passes (from one thread of
// its first block), so launches replayed from a CUDA graph are counted as
// eager ones are.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "snake_conv_bf16.cuh"

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kRows = 128;      // frames per block, 64 per warpgroup
constexpr int kSMs = 132;       // H100 SXM
constexpr int kMaxSmem = 232448;          // per block, opt-in
constexpr int kRing = 3;                  // stages in flight

// the f32 kernel's parameters (the bf16 kernel's: snake16::Params)
struct Params {
  const void* x;
  const void* alpha;
  const void* beta;
  const void* bias;
  void* y;
  float* ws;            // (splits, B, T, O) partial sums when splits > 1
  unsigned long long* count;   // launches of this kernel, or null
  int T, C, O, k, dilation, left;
  int win;              // window rows: kRows + (k - 1) * dilation
  int groups;           // tap groups per channel chunk: k / KT
  int n_stages;         // channel chunks x tap groups
  int stages_per_split, splits;
  int vec_x;            // 16-byte copies of x
};

// row stride of the activated window: a multiple of 8 that is 8 or 24 mod
// 32, so a half-warp's 8-byte fragment loads hit 16 distinct bank pairs
__host__ __device__ constexpr int act_stride(int bk) {
  return bk % 16 == 0 ? bk + 8 : bk;
}

// column of channel cc inside its group of 8: (cc, cc + 4) side by side
__device__ __forceinline__ int act_col(int cc) {
  return (cc & ~7) + ((cc & 3) << 1) + ((cc >> 2) & 1);
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

// one 2-D box of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
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

// K-major operand in the swizzled layout TMA writes: rows of `row_bytes`
// (32, 64 or 128: the swizzle span), 8-row groups `8 * row_bytes` apart
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

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk8 .f32.tf32.tf32, A from registers, B from shared
// memory, d += A * B; the operand lists are spelled out for each N

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

__device__ __forceinline__ void wgmma_n256(float (&d)[128],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (BN == 64) wgmma_n64(d, a, desc_b);
  else if constexpr (BN == 128) wgmma_n128(d, a, desc_b);
  else wgmma_n256(d, a, desc_b);
}

// Shared memory of one instance, in bytes: the ring of weight tiles (hi and
// lo) and raw windows (with the chunk's alpha and beta as two more rows),
// the double-buffered activated window (hi and lo), the barriers.
__host__ __device__ constexpr int weight_bytes(int bn, int bk, int kt) {
  return 4 * kt * bk * bn;
}

size_t smem_bytes(int bn, int bk, int kt, int win) {
  return 1024 +                                    // alignment
         (size_t)kRing * 2 * weight_bytes(bn, bk, kt) +
         (size_t)kRing * 4 * (win + 2) * bk +
         (size_t)4 * 4 * win * act_stride(bk) + kRing * sizeof(uint64_t);
}

// One block: 128 frames x BN output channels.  A stage is BK channels x KT
// taps; the stages of this block's share of the channel sum run in order.
template <int BN, int BK, int KT>
__device__ __forceinline__ void snake_conv_block(const CUtensorMap* w_hi,
                                                 const CUtensorMap* w_lo,
                                                 const Params& p) {
  constexpr int kq = BK / 4;                 // 16-byte pieces per row
  constexpr int AS = act_stride(BK);
  constexpr int WB = weight_bytes(BN, BK, KT);
  constexpr int WE = WB / 4;                 // elements of one ring slot
  constexpr int TAP = BN * BK;               // elements of one tap's tile
  constexpr int KS = BK / 8;                 // MMA steps per tap
  constexpr int STEPS = KT * KS;
  static_assert(kThreads % BK == 0, "a thread keeps its channel");

  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA tiles want 1024-byte alignment
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int xsz = (p.win + 2) * BK;           // window, alpha, beta
  const int asz = p.win * AS;
  float* const whi = reinterpret_cast<float*>(smem);           // [ring][WE]
  float* const wlo = whi + kRing * WE;                         // [ring][WE]
  float* const xraw = wlo + kRing * WE;                        // [ring][xsz]
  float* const act = xraw + kRing * xsz;   // [2][hi, lo] activated windows
  uint64_t* const full = reinterpret_cast<uint64_t*>(act + 4 * asz);

  const float* const x = static_cast<const float*>(p.x);
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kRows;
  const int o0 = blockIdx.y * BN;
  const int split = blockIdx.z % p.splits;
  const int b = blockIdx.z / p.splits;
  const int st0 = split * p.stages_per_split;
  const int n = min(p.n_stages, st0 + p.stages_per_split) - st0;
  const float* const xb = x + (size_t)b * p.T * p.C;

  // one block counts the launch, on the device: replays of a CUDA graph
  // count as eager launches do
  if (p.count != nullptr && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0)
    atomicAdd(p.count, 1ull);
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage i of this block into ring slot i % kRing: the weights by TMA
  // (thread 0), the raw window by every thread; one cp.async group per call
  auto issue = [&](int i) {
    if (i < n) {
      const int st = st0 + i;
      const int c0 = (st / p.groups) * BK;
      const int j0 = (st % p.groups) * KT;
      const int slot = i % kRing;
      if (tid == 0) {
        uint64_t* const bar = full + slot;
        mbar_expect(bar, 2 * WB);
#pragma unroll
        for (int jj = 0; jj < KT; ++jj) {
          const int row = (j0 + jj) * p.O + o0;
          tma_load_2d(whi + slot * WE + jj * TAP, w_hi, bar, c0, row);
          tma_load_2d(wlo + slot * WE + jj * TAP, w_lo, bar, c0, row);
        }
      }
      float* const xdst = xraw + slot * xsz;
      if (tid < 2 * BK) {
        const int c = c0 + tid % BK;
        const bool ok = c < p.C;
        const float* src =
            static_cast<const float*>(tid < BK ? p.alpha : p.beta);
        cp_async4(xdst + p.win * BK + tid,
                  ok ? src + c : static_cast<const float*>(p.alpha), ok);
      }
      if (p.vec_x) {
        for (int e = tid; e < p.win * kq; e += kThreads) {
          const int q = e % kq;
          const int r = e / kq;
          const int t = t0 - p.left + r;
          const int c = c0 + 4 * q;
          const bool ok = t >= 0 && t < p.T && c < p.C;
          cp_async16(xdst + r * BK + 4 * q,
                     ok ? xb + (size_t)t * p.C + c : x, ok);
        }
      } else {
        for (int e = tid; e < p.win * BK; e += kThreads) {
          const int cc = e % BK;
          const int r = e / BK;
          const int t = t0 - p.left + r;
          const int c = c0 + cc;
          const bool ok = t >= 0 && t < p.T && c < p.C;
          cp_async4(xdst + e, ok ? xb + (size_t)t * p.C + c : x, ok);
        }
      }
    }
    cp_async_commit();
  };

  // snake of stage i's window in f32, into activated buffer i & 1, split
  // into its tf32 hi and lo; a thread keeps one channel
  auto activate = [&](int i) {
    const int st = st0 + i;
    const int cc = tid % BK;
    const int c = (st / p.groups) * BK + cc;
    const bool live = c < p.C;
    const float* const xr = xraw + (i % kRing) * xsz;
    const float al = xr[p.win * BK + cc];
    const float ib = 1.0f / (xr[(p.win + 1) * BK + cc] + 1e-9f);
    float* const ah = act + (i & 1) * 2 * asz;
    float* const alo = ah + asz;
    const int col = act_col(cc);
#pragma unroll 2
    for (int r = tid / BK; r < p.win; r += kThreads / BK) {
      const float xv = xr[r * BK + cc];
      const float sn = sinf(xv * al);
      const float v = live ? xv + ib * (sn * sn) : 0.f;
      float hi, lo;
      split_tf32(v, hi, lo);
      ah[r * AS + col] = hi;
      alo[r * AS + col] = lo;
    }
  };

  // this thread's fragment rows: warp w of warpgroup g holds rows
  // 64g + 16w + (lane / 4) and 8 below
  const int lane = tid % 32;
  const int row0 = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + lane / 4;
  const int tig = lane % 4;

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  fence_acc(acc);

  // all fragments of stage i in registers, then its 3 x STEPS MMAs in one
  // group, small terms first
  auto mma = [&](int i) {
    const int j0 = ((st0 + i) % p.groups) * KT;
    const float* const bh = whi + (i % kRing) * WE;
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
        const float2 l1 =
            *reinterpret_cast<const float2*>(alo + off + 8 * AS);
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
        // tap u / KS, channels 8 (u % KS) on: 32 bytes into the swizzled
        // rows
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
    mma(i);
    issue(i + 2);
    if (i + 1 < n) {
      cp_async_wait_prev();
      __syncthreads();   // stage i + 1's window is in
      mbar_wait(full + (i + 1) % kRing, ((i + 1) / kRing) & 1);
      activate(i + 1);
    }
    wgmma_wait_all();
    fence_acc(acc);
    __syncthreads();     // stage i + 1 is activated; stage i's slot is free
  }

  // sums: d[4q + 2h + e] is row (lane / 4) + 8h, column 8q + 2 * tig + e;
  // a split block writes its partial sums to its own slab of ws, an
  // unsplit one its output
  const int batch = gridDim.z / p.splits;
  const bool to_ws = p.splits > 1;
  float* const wsb = p.ws + ((size_t)split * batch + b) * p.T * p.O;
  float* const yb = static_cast<float*>(p.y) + (size_t)b * p.T * p.O;
  const float* const bias = static_cast<const float*>(p.bias);
  const bool pairs = p.O % 2 == 0;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int o = o0 + 8 * q + 2 * tig;
    if (o >= p.O) continue;
    const bool has1 = o + 1 < p.O;
    const bool with_bias = split == 0;
    const float b0 = with_bias ? bias[o] : 0.f;
    const float b1 = with_bias && has1 ? bias[o + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + row0 + 8 * h;
      if (t >= p.T) continue;
      const size_t at = (size_t)t * p.O + o;
      const float v0 = acc[4 * q + 2 * h] + b0;
      const float v1 = acc[4 * q + 2 * h + 1] + b1;
      float* const dst = to_ws ? wsb + at : yb + at;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (has1) dst[1] = v1;
      }
    }
  }
}

template <int BN, int BK, int KT>
__global__ void __launch_bounds__(kThreads, 1)
snake_conv_3xtf32(const __grid_constant__ CUtensorMap w_hi,
                  const __grid_constant__ CUtensorMap w_lo, const Params p) {
  snake_conv_block<BN, BK, KT>(&w_hi, &w_lo, p);
}

// the bf16 kernel: M frames (64 a consumer warpgroup) x BN output channels
// a tile, KT taps a stage (snake_conv_bf16.cuh)
template <int M, int BN, int KT>
__global__ void __launch_bounds__(snake16::block_threads(M, true), 1)
snake_conv_bf16(const __grid_constant__ CUtensorMap w,
                const __grid_constant__ CUtensorMap a,
                const snake16::Params p) {
  snake16::block<M, BN, KT, true>(&w, &a, p);
}

// y[i] = ws[0][i] + ws[1][i] + ... in split order, over n = B * T * O, f32
// in and Out (f32, or bf16 rounded once) out; block 0 counts the launch in
// *count when it is not null
template <typename Out>
__device__ __forceinline__ void sum_splits_body(const float* __restrict__ ws,
                                                Out* __restrict__ y,
                                                long long n, int splits,
                                                unsigned long long* count) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1ull);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * n + i];
    if constexpr (std::is_same<Out, float>::value)
      y[i] = v;
    else
      y[i] = __float2bfloat16_rn(v);
  }
}

__global__ void sum_splits(const float* __restrict__ ws, float* __restrict__ y,
                           long long n, int splits,
                           unsigned long long* count) {
  sum_splits_body(ws, y, n, splits, count);
}

__global__ void sum_splits_bf16(const float* __restrict__ ws,
                                __nv_bfloat16* __restrict__ y, long long n,
                                int splits, unsigned long long* count) {
  sum_splits_body(ws, y, n, splits, count);
}

// sum_splits (f32 out) or sum_splits_bf16 (bf16 out) over n outputs on
// stream s: one thread an output, at most 8 blocks an SM (a grid-stride loop
// covers the rest)
template <typename Out>
int launch_sum_splits(const float* ws, Out* y, long long n, int splits,
                      unsigned long long* count, cudaStream_t s) {
  const long long most = (long long)kSMs * 8;
  const int blocks = (int)((n + 255) / 256 < most ? (n + 255) / 256 : most);
  if constexpr (std::is_same<Out, float>::value)
    sum_splits<<<blocks, 256, 0, s>>>(ws, y, n, splits, count);
  else
    sum_splits_bf16<<<blocks, 256, 0, s>>>(ws, y, n, splits, count);
  return (int)cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// channels per stage of each instance: the most that fits beside the other
// buffers at the main path's windows (146 rows at k = 3, d = 9)
int stage_channels(int bn, int kt) {
  if (kt == 3) return bn == 64 ? 16 : 8;
  return bn == 64 ? 32 : 16;
}

struct Plan {
  int bn, bk, kt, splits, stages_per_split, n_stages, groups;
  size_t smem;
};

// Tile width and split of the channel sum for one shape, from a model fitted
// to the kernel's times on an H100: a stage costs its MMA cycles plus its
// activation cycles plus a fixed 600 (the activation does not hide behind
// the MMAs in practice), a block costs its stages plus three for its
// prologue and epilogue, and the grid costs whole waves over the 132 SMs.
// The best plans fill one wave with about 128 blocks.
int make_plan(int B, int T, int C, int O, int k, int dilation, Plan* plan) {
  const int win = kRows + (k - 1) * dilation;
  const int nt = ceil_div(T, kRows) * B;
  const int kt = k % 3 == 0 ? 3 : 1;
  double best = -1.0;
  if (win > 256) return (int)cudaErrorInvalidValue;
  for (int bn = 64; bn <= 256; bn *= 2) {
    if (bn > 64 && ceil_div(O, bn) * bn >= 2 * O) continue;
    const int bk = stage_channels(bn, kt);
    const size_t smem = smem_bytes(bn, bk, kt, win);
    if (smem > (size_t)kMaxSmem) continue;
    const int groups = k / kt;
    const int n_stages = ceil_div(C, bk) * groups;
    const double mma = 3.0 * kt * bk / 8 * bn;
    const double stage = mma + 1.6 * win * bk + 600.0;
    const int most = n_stages / 2 > 1 ? n_stages / 2 : 1;
    for (int s = 1; s <= most; ++s) {
      const int per = ceil_div(n_stages, s);
      const int blocks = nt * ceil_div(O, bn) * ceil_div(n_stages, per);
      const double cost = (double)ceil_div(blocks, kSMs) * (per + 3) *
                          stage * (s > 1 ? 1.05 : 1.0);
      if (best < 0 || cost < best) {
        best = cost;
        plan->bn = bn;
        plan->bk = bk;
        plan->kt = kt;
        plan->groups = groups;
        plan->n_stages = n_stages;
        plan->stages_per_split = per;
        plan->splits = ceil_div(n_stages, per);
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

// (k * O, Cw) rows of a weight array of f32 values, boxes of BK channels x
// BN rows, swizzled by the box's row bytes (32, 64 or 128)
int weight_map(CUtensorMap* map, const void* w, int rows, int Cw, int bk,
               int bn) {
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
  const int elem = 4;
  const cuuint64_t dims[2] = {(cuuint64_t)Cw, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Cw * elem};
  const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)bn};
  const cuuint32_t estrides[2] = {1, 1};
  const int row_bytes = bk * elem;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(w), dims,
      strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int BK, int KT>
int launch(const float* w, const float* wlo, int Cw, const Params& p,
           const Plan& plan, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        snake_conv_3xtf32<BN, BK, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap map_hi, map_lo;
  int err = weight_map(&map_hi, w, p.k * p.O, Cw, BK, BN);
  if (err == 0) err = weight_map(&map_lo, wlo, p.k * p.O, Cw, BK, BN);
  if (err) return err;
  dim3 grid(ceil_div(p.T, kRows), ceil_div(p.O, BN), B * plan.splits);
  snake_conv_3xtf32<BN, BK, KT><<<grid, kThreads, plan.smem, stream>>>(
      map_hi, map_lo, p);
  return (int)cudaGetLastError();
}

template <int M, int BN, int KT>
int launch_bf16(const snake16::Plan& plan, const CUtensorMap& w,
                const CUtensorMap& a, const snake16::Params& p,
                cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        snake_conv_bf16<M, BN, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, snake16::kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  snake_conv_bf16<M, BN, KT><<<plan.grid, snake16::block_threads(M, true),
                               plan.smem, stream>>>(w, a, p);
  return (int)cudaGetLastError();
}

// the launch parameters of a planned shape
Params params(const void* x, const void* alpha, const void* beta,
              const void* bias, void* y, float* ws, int T, int C, int O,
              int k, int dilation, int left, const Plan& plan,
              unsigned long long* counts, bool vec_x) {
  Params p;
  p.x = x;
  p.alpha = alpha;
  p.beta = beta;
  p.bias = bias;
  p.y = y;
  p.ws = ws;
  p.count = counts;
  p.T = T;
  p.C = C;
  p.O = O;
  p.k = k;
  p.dilation = dilation;
  p.left = left;
  p.win = kRows + (k - 1) * dilation;
  p.groups = plan.groups;
  p.n_stages = plan.n_stages;
  p.stages_per_split = plan.stages_per_split;
  p.splits = plan.splits;
  p.vec_x = vec_x;
  return p;
}

// the checks both entry points make before planning
bool bad_args(int B, int T, int C, int O, int k, int dilation, int left,
              int Cw, int cw_multiple) {
  return B <= 0 || T <= 0 || C <= 0 || O <= 0 || k <= 0 || dilation <= 0 ||
         left < 0 || left > (k - 1) * dilation || Cw < C ||
         Cw % cw_multiple != 0;
}

}  // namespace

extern "C" {

// The tiling a launch of this shape takes: out[0..2] = output channels per
// block, channels per stage, splits of the channel sum.
int fused_snake_conv_plan(int B, int T, int C, int O, int k, int dilation,
                          int* out) {
  Plan plan;
  const int err = make_plan(B, T, C, O, k, dilation, &plan);
  if (err) return err;
  out[0] = plan.bn;
  out[1] = plan.bk;
  out[2] = plan.splits;
  return 0;
}

// The same for the bf16 kernel (64 channels a stage).
int fused_snake_conv_plan_bf16(int B, int T, int C, int O, int k,
                               int dilation, int* out) {
  snake16::Plan plan;
  const int err = snake16::make_plan(true, B, T, C, O, k, dilation, &plan);
  if (err) return err;
  out[0] = plan.bn;
  out[1] = snake16::kStage;
  out[2] = plan.splits;
  return 0;
}

// The bf16 kernel's whole plan: out[0..5] = frames a tile, output channels
// a tile, channels a stage, slots of the ring, splits of the channel sum,
// blocks (persistent, at most one an SM).
int fused_snake_conv_plan_bf16_tiles(int B, int T, int C, int O, int k,
                                     int dilation, int* out) {
  snake16::Plan plan;
  const int err = snake16::make_plan(true, B, T, C, O, k, dilation, &plan);
  if (err) return err;
  out[0] = plan.m;
  out[1] = plan.bn;
  out[2] = snake16::kStage;
  out[3] = plan.ring;
  out[4] = plan.splits;
  out[5] = plan.grid;
  return 0;
}

// Launches on `stream` and returns a CUDA error code (0 on success).  w and
// wlo are (k, O, Cw), Cw >= C a multiple of 4, 16-byte aligned; ws holds
// splits * B * T * O floats when the plan splits the channel sum (else it
// may be null).  counts, when not null, is two device counters to which
// the launched kernels add one each: counts[0] the conv kernel's launches,
// counts[1] those of sum_splits.
int fused_snake_conv_f32(const float* x, const float* alpha, const float* beta,
                         const float* w, const float* wlo, const float* bias,
                         float* y, float* ws, int B, int T, int C, int O,
                         int k, int dilation, int left, int Cw,
                         unsigned long long* counts, void* stream) {
  if (bad_args(B, T, C, O, k, dilation, left, Cw, 4) ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)wlo % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  const int err = make_plan(B, T, C, O, k, dilation, &plan);
  if (err) return err;
  if ((long long)B * plan.splits > 65535) return (int)cudaErrorInvalidValue;
  if (plan.splits > 1 && (ws == nullptr || (uintptr_t)ws % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Params p = params(x, alpha, beta, bias, y, ws, T, C, O, k, dilation,
                          left, plan, counts,
                          C % 4 == 0 && (uintptr_t)x % 16 == 0);
  int e;
  switch (plan.bn * 4 + plan.kt) {
    case 64 * 4 + 3: e = launch<64, 16, 3>(w, wlo, Cw, p, plan, B, s); break;
    case 128 * 4 + 3: e = launch<128, 8, 3>(w, wlo, Cw, p, plan, B, s); break;
    case 256 * 4 + 3: e = launch<256, 8, 3>(w, wlo, Cw, p, plan, B, s); break;
    case 64 * 4 + 1: e = launch<64, 32, 1>(w, wlo, Cw, p, plan, B, s); break;
    case 128 * 4 + 1: e = launch<128, 16, 1>(w, wlo, Cw, p, plan, B, s); break;
    default: e = launch<256, 16, 1>(w, wlo, Cw, p, plan, B, s);
  }
  if (e != 0 || plan.splits == 1) return e;
  return launch_sum_splits(ws, y, (long long)B * T * O, plan.splits,
                           counts == nullptr ? nullptr : counts + 1, s);
}

// The bf16 kernel: x, alpha, beta, w, bias and y are bf16 (passed as their
// addresses), w is (k, O, Cw), Cw >= C a multiple of 8, 16-byte aligned,
// with no low half; ws and counts as for fused_snake_conv_f32 (ws f32,
// added by sum_splits_bf16 into the bf16 y).
int fused_snake_conv_bf16(const void* x, const void* alpha, const void* beta,
                          const void* w, const void* bias, void* y, float* ws,
                          int B, int T, int C, int O, int k, int dilation,
                          int left, int Cw, unsigned long long* counts,
                          void* stream) {
  if (bad_args(B, T, C, O, k, dilation, left, Cw, 8) ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)y % 4 != 0)
    return (int)cudaErrorInvalidValue;
  snake16::Plan plan;
  int err = snake16::make_plan(true, B, T, C, O, k, dilation, &plan);
  if (err) return err;
  if (plan.splits > 1 && (ws == nullptr || (uintptr_t)ws % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  snake16::Params p = {};
  p.a = x;
  p.alpha = alpha;
  p.beta = beta;
  p.bias = bias;
  p.out = y;
  p.ws = ws;
  p.count = counts;
  p.B = B;
  p.T = T;
  p.Ka = C;
  p.N = O;
  p.C = C;
  p.O = O;
  p.k = k;
  p.dilation = dilation;
  p.lead = left;
  CUtensorMap wmap, amap;
  err = snake16::prepare(plan, w, Cw, &p, &wmap, &amap);
  if (err) return err;
  int e;
  switch ((plan.m / 64) * 1000 + plan.bn * 4 + plan.kt) {
    case 2000 + 64 * 4 + 3: e = launch_bf16<128, 64, 3>(plan, wmap, amap, p, s); break;
    case 2000 + 128 * 4 + 3: e = launch_bf16<128, 128, 3>(plan, wmap, amap, p, s); break;
    case 2000 + 64 * 4 + 1: e = launch_bf16<128, 64, 1>(plan, wmap, amap, p, s); break;
    case 2000 + 128 * 4 + 1: e = launch_bf16<128, 128, 1>(plan, wmap, amap, p, s); break;
    case 1000 + 64 * 4 + 3: e = launch_bf16<64, 64, 3>(plan, wmap, amap, p, s); break;
    case 1000 + 128 * 4 + 3: e = launch_bf16<64, 128, 3>(plan, wmap, amap, p, s); break;
    case 1000 + 64 * 4 + 1: e = launch_bf16<64, 64, 1>(plan, wmap, amap, p, s); break;
    default: e = launch_bf16<64, 128, 1>(plan, wmap, amap, p, s);
  }
  if (e != 0 || plan.splits == 1) return e;
  return launch_sum_splits(ws, static_cast<__nv_bfloat16*>(y),
                           (long long)B * T * O, plan.splits,
                           counts == nullptr ? nullptr : counts + 1, s);
}

// The split sum alone, as fused_snake_conv_f32 launches it: y[i] = ws[0][i]
// + ... + ws[splits - 1][i] over n = B * T * O outputs, in split order;
// counts[1] (when counts is not null) counts the launch.
int fused_snake_conv_sum_splits(const float* ws, float* y, long long n,
                                int splits, unsigned long long* counts,
                                void* stream) {
  if (n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  return launch_sum_splits(ws, y, n, splits,
                           counts == nullptr ? nullptr : counts + 1,
                           (cudaStream_t)stream);
}

// The bf16 split sum alone, as fused_snake_conv_bf16 launches it: f32 ws,
// bf16 y (the sum rounded once).
int fused_snake_conv_sum_splits_bf16(const float* ws, void* y, long long n,
                                     int splits, unsigned long long* counts,
                                     void* stream) {
  if (n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  return launch_sum_splits(ws, static_cast<__nv_bfloat16*>(y), n, splits,
                           counts == nullptr ? nullptr : counts + 1,
                           (cudaStream_t)stream);
}

}  // extern "C"
