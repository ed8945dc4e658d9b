// The bf16 main loop shared by the snake+conv forward (fused_snake_conv.cu:
// snake_conv_bf16) and the dgrad of its backward (snake_conv_backward.cu:
// snake_conv_dgrad_bf16), designed for Hopper at bf16 (sm_90a).
//
// Both are one implicit GEMM over a window of a (B, T, Ka) bf16 input:
//
//   out[b, t, n] = sum_{j<k} sum_c A[b, t - lead + j*d, c] * Wj[n, c]
//
// The forward takes A = snake(x) (Ka = C channels), Wj = W[j] (n = output
// channel) and lead = left; dgrad takes A = g (Ka = O), Wj = Wt[k - 1 - j]
// (the weight transposed, n = input channel) and lead = (k-1)d - left: it
// is the forward's conv applied to g with the taps reversed.  A is zero
// outside [0, T).
//
// What bounds it: at bf16 the tensor cores do the products in a sixth of
// the 3xTF32 kernels' time, so what surrounds them sets the pace; the
// design keeps the tensor cores fed:
//
//  - Warp specialization.  A block is one or two consumer warpgroups (M =
//    64 or 128 frames, 64 a warpgroup) and a producer warpgroup, whose
//    first warp issues, per stage, the TMA loads of the weight tiles (one 2-D
//    box of 64 channels x BN rows per tap) and of the input window (one 3-D
//    box of 64 channels x win frames x 1 signal over (Ka, T, B), whose zero
//    fill past T's edges and past Ka is the pad), into a ring of `ring`
//    slots (2-6, as shared memory allows); full and empty mbarriers hand
//    the slots between the two sides, so no stage waits for a block-wide
//    barrier.  Where Ka's rows are not 16-byte
//    multiples (or A is not 16-byte aligned), the producer warp stages the
//    window with plain loads instead, zero past every edge.
//  - Stages of 64 channels x KT taps (KT = 3 for k = 3, else 1): 128-byte
//    rows, swizzled 128 bytes by TMA, KT x 4 wgmma m64nBNk16 a warpgroup.
//  - A from registers, loaded with ldmatrix: a lane gives each of its rows'
//    addresses, so a tap's shift j*d needs no 8-row alignment, and the
//    swizzle is undone in the address (chunk ^ row % 8).  B (the weights)
//    is read by the tensor cores from the swizzled tiles through
//    descriptors.  A warpgroup waits for its stage's group before it hands
//    the slot back (wgmma.wait_group 0): the other warpgroup's MMAs keep
//    the tensor cores busy meanwhile, and a slot comes back a stage sooner
//    than with a group kept in flight, which counts at the 2-3 slots that
//    64-channel stages leave room for at k = 3.
//  - The forward's snake, once per staged element, by seven warps (the
//    producer warpgroup's other three and a fourth warpgroup), in place in
//    the slot, between the loads' arrival (full) and the consumers'
//    (ready): 16-byte pieces in f32, with a sine squared of f32 accuracy
//    (a 3-part reduction by pi/2 and Cephes' polynomial, about half the
//    instructions of sinf), rounded to bf16 once.  It runs while the
//    consumers multiply the stages before.
//  - Persistent blocks: at most one block an SM walks its output tiles
//    (frames x BN columns x signal x split) in turn; the producer runs
//    ahead across tiles, so one tile's loads overlap the last tile's
//    epilogue.  Most of the codec's convs are one or two stages deep.
//
// The sums stay f32 in the tensor cores' accumulators: every output is
// rounded to bf16 once, so no f32 total is folded beside them (the float64
// check holds without: scripts/torch_backward_f64.py --bf16).  Replaces,
// at bf16, the TPU kernel after_tpu/ops/pallas/fused_conv.py (_kernel) and
// its VJP's input half (_fused_with_vjp.bwd).  The VJP's weight half at
// bf16 (snake_conv_backward.cu: snake_conv_wgrad_bf16) has a loop of its
// own, built from this file's barriers, TMA and ldmatrix wrappers, tensor
// maps and snake_piece.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace snake16 {

typedef __nv_bfloat16 bf16;

constexpr int kStage = 64;       // channels a stage: one 128-byte row
constexpr int kMaxRing = 6;
constexpr int kSMs = 132;        // H100 SXM
constexpr int kMaxSmem = 232448; // per block, opt-in
constexpr int kBarBytes = 1024;  // the barriers, before the 1024-aligned ring

__host__ __device__ constexpr int align1k(int n) { return (n + 1023) & ~1023; }

// threads of a block of M frames: one or two consumer warpgroups and a
// producer warpgroup, whose first warp issues the loads; the forward's
// snake runs in its other three and in a fourth warpgroup (seven warps),
// dgrad's gb (where wanted) in its second
__host__ __device__ constexpr int block_threads(int m, bool fwd) {
  return m + m + (fwd ? 256 : 128);
}

// the snake of one 16-byte piece of the window, 8 channels, in place: in
// f32 from the widened values, rounded to bf16 once
__device__ __forceinline__ void snake_piece(uint8_t* at, const float (&al)[8],
                                            const float (&ib)[8]);

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t su32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(su32(b)),
               "r"(count)
               : "memory");
}

// arrives and expects `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          su32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(su32(b))
               : "memory");
}

// waits until the barrier's phase `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(su32(b)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* b, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(su32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(su32(b)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* b, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(su32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(su32(b)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and holds row l / 4, columns 2 (l % 4), +1 of each in r[0..3]
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// a barrier of `count` threads on hardware barrier `id` (0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// K-major operand in TMA's 128-byte swizzle: 128-byte rows, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc128(const void* p) {
  return (uint64_t)((su32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void keep_f(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the registers of a wgmma group's A fragments stay this group's until
// here: the compiler may not reuse them before
template <int S>
__device__ __forceinline__ void keep_a(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) asm volatile("" ::"r"(a[s][v]) : "memory");
}

// wgmma.mma_async m64nNk16 .f32.bf16.bf16, A from registers, B K-major
// from shared memory, d += A * B

__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
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

__device__ __forceinline__ void mma_n128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4],
                                    uint64_t desc_b) {
  if constexpr (BN == 64) mma_n64(d, a, desc_b);
  else mma_n128(d, a, desc_b);
}

// sin(y) and cos(y) in f32, reduced as sin_sq reduces y, with Cephes' sinf
// and cosf polynomials on [-pi/4, pi/4] and the quarter's signs: within
// 7.7e-8 of the exact values for |y| <= 300 (sincosf: 6.9e-8)
__device__ __forceinline__ void sin_cos(float y, float* sn, float* cs) {
  const float j = rintf(y * 0.636619772f);
  float r = fmaf(j, -1.5703125f, y);
  r = fmaf(j, -4.837512969970703125e-4f, r);
  r = fmaf(j, -7.54978995489188216e-8f, r);
  const float z = r * r;
  float ps = fmaf(z, -1.9515295891e-4f, 8.3321608736e-3f);
  ps = fmaf(ps, z, -1.6666654611e-1f);
  ps = fmaf(ps * z, r, r);
  float pc = fmaf(z, 2.443315711809948e-5f, -1.388731625493765e-3f);
  pc = fmaf(pc, z, 4.166664568298827e-2f);
  pc = fmaf(-0.5f, z, pc * z * z) + 1.0f;
  const int q = static_cast<int>(j) & 3;
  const float s0 = q & 1 ? pc : ps;
  const float c0 = q & 1 ? ps : pc;
  *sn = q & 2 ? -s0 : s0;
  *cs = (q + 1) & 2 ? -c0 : c0;
}

// sin(y)^2 in f32: y reduced by pi/2 in three parts (Cody and Waite), then
// Cephes' sinf polynomial on [-pi/4, pi/4]; sin^2 of an odd quarter is
// 1 - sin^2 of the rest.  Within 1.2e-7 of the exact value for |y| <= 200
// (f32 sinf's square: 1.2e-7)
__device__ __forceinline__ float sin_sq(float y) {
  const float j = rintf(y * 0.636619772f);
  float r = fmaf(j, -1.5703125f, y);
  r = fmaf(j, -4.837512969970703125e-4f, r);
  r = fmaf(j, -7.54978995489188216e-8f, r);
  const float r2 = r * r;
  float s = fmaf(r2, -1.9515295891e-4f, 8.3321608736e-3f);
  s = fmaf(s, r2, -1.6666654611e-1f);
  s = fmaf(s * r2, r, r);
  const float s2 = s * s;
  return (static_cast<int>(j) & 1) ? 1.0f - s2 : s2;
}

__device__ __forceinline__ void snake_piece(uint8_t* at, const float (&al)[8],
                                            const float (&ib)[8]) {
  const uint4 in = *reinterpret_cast<const uint4*>(at);
  const __nv_bfloat162* const h = reinterpret_cast<const __nv_bfloat162*>(&in);
  uint4 res;
  __nv_bfloat162* const o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v0 = __low2float(h[e]);
    const float v1 = __high2float(h[e]);
    const float a0 = fmaf(ib[2 * e], sin_sq(v0 * al[2 * e]), v0);
    const float a1 = fmaf(ib[2 * e + 1], sin_sq(v1 * al[2 * e + 1]), v1);
    o[e] = __floats2bfloat162_rn(a0, a1);
  }
  *reinterpret_cast<uint4*>(at) = res;
}

// ---------------------------------------------------------------------------
// the block
// ---------------------------------------------------------------------------

struct Params {
  const void* a;        // the window's source (B, T, Ka): x or g
  const void* alpha;    // the snake's alpha and beta, (C,)
  const void* beta;
  const void* bias;     // forward: (O,)
  const void* x;        // dgrad: (B, T, C)
  void* out;            // forward: y (B, T, O); dgrad: gx (B, T, C) or null
  float* ws;            // forward: (splits, B, T, O) partial sums;
                        // dgrad: (B * mtiles, 2C + O) partials
  unsigned long long* count;
  int B, T, Ka, N;      // the GEMM's frames, channels of A, columns
  int C, O;             // the conv's input and output channels
  int k, dilation, lead, win;
  int groups;           // tap groups a channel chunk: k / KT
  int n_stages;         // chunks of 64 channels x tap groups
  int per_split, splits;
  int mtiles, ntiles, n_tiles;
  int ring, slot_bytes;
  int tma_a;            // the window by TMA (else by the producer's loads)
  int vec_x;            // dgrad: 16-byte loads of x and stores of gx
  int need_ga, need_ab, need_gb;
};

// one output tile: frames t0.., columns n0.., signal b, split s
struct Tile {
  int t0, b, split, nt, mt, st0, n;
};

template <int M>
__device__ __forceinline__ Tile tile_of(const Params& p, int tile) {
  Tile t;
  t.nt = tile % p.ntiles;
  int rest = tile / p.ntiles;
  t.mt = rest % p.mtiles;
  rest /= p.mtiles;
  t.split = rest % p.splits;
  t.b = rest / p.splits;
  t.t0 = t.mt * M;
  t.st0 = t.split * p.per_split;
  t.n = min(p.n_stages, t.st0 + p.per_split) - t.st0;
  return t;
}

// The shared memory of a block, 1024-aligned: the barriers (full, empty,
// ready), the ring of slots ([KT][BN][64] weights, then [win][64] window,
// activated in place by the forward), then the forward's alpha and 1 /
// (beta + 1e-9) of every channel in f32 or dgrad's epilogue buffers.
template <int M, int BN, int KT, bool kFwd>
__device__ __forceinline__ void block(const CUtensorMap* wmap,
                                      const CUtensorMap* amap,
                                      const Params& p) {
  constexpr int NC = M / 64;               // consumer warpgroups
  constexpr int kConsumers = 128 * NC;
  constexpr int STEPS = KT * 4;            // k16 steps a stage
  constexpr int WBYTES = KT * BN * 128;    // the weight tiles of a slot
  constexpr int XS = BN + 8;               // dgrad epilogue: row stride
  // forward: the threads that run the snake
  constexpr int kActivators = block_threads(M, true) - kConsumers - 32;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + kMaxRing;
  uint64_t* const ready = empty + kMaxRing;   // forward: window activated
  uint8_t* const ring = smem + kBarBytes;
  uint8_t* const extra = ring + p.ring * p.slot_bytes;
  const int tid = threadIdx.x;
  const bf16* const a_src = static_cast<const bf16*>(p.a);

  if (p.count != nullptr && tid == 0 && blockIdx.x == 0)
    atomicAdd(p.count, 1ull);
  const bool gbw = !kFwd && p.need_gb;   // a warp sums g for gb
  if (tid == 0) {
    for (int s = 0; s < p.ring; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 4 * NC + (gbw ? 1 : 0));
      bar_init(ready + s, kActivators / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---------------------------------------------------------------- producer
    // at 128 frames the block holds 128 (forward, 512 threads) or 168
    // registers a thread: a consumer warp takes 184 and the others 72 (2 x
    // 184 + 2 x 72 = 4 x 128), or 208 and 88 (2 x 208 + 88 = 3 x 168);
    // setmaxnreg.inc waits for what .dec gives back, so more than that
    // would never return
    if constexpr (NC == 2 && kFwd)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    if constexpr (NC == 2 && !kFwd)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n" ::: "memory");
    const int pw = (tid - kConsumers) / 32;
    const int lane = tid % 32;
    if (kFwd && pw > 0) {
      // the snake of each slot's window, in place, once its loads are in:
      // 8 channels (a 16-byte piece) a thread, every row
      const int at = tid - kConsumers - 32;
      const int q = at % 8;
      // alpha and 1 / (beta + 1e-9) of every channel, once a block, in
      // f32, 0 past C (the table is whole 64-channel chunks)
      float* const coef = reinterpret_cast<float*>(extra);
      const int chunks = (p.Ka + kStage - 1) / kStage * kStage;
      const bf16* const alpha = static_cast<const bf16*>(p.alpha);
      const bf16* const beta = static_cast<const bf16*>(p.beta);
      for (int c = at; c < chunks; c += kActivators) {
        const bool live = c < p.Ka;
        coef[c] = live ? __bfloat162float(alpha[c]) : 0.f;
        coef[chunks + c] =
            live ? 1.0f / (__bfloat162float(beta[c]) + 1e-9f) : 0.f;
      }
      named_sync(1, kActivators);
      int g = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        const Tile t = tile_of<M>(p, tile);
        for (int i = 0; i < t.n; ++i, ++g) {
          const int slot = g % p.ring;
          bar_wait(full + slot, (g / p.ring) & 1);
          uint8_t* const win = ring + slot * p.slot_bytes + WBYTES;
          const int c0 = (t.st0 + i) / p.groups * kStage + 8 * q;
          float al[8], ib[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            al[e] = coef[c0 + e];
            ib[e] = coef[chunks + c0 + e];
          }
#pragma unroll 2
          for (int r = at / 8; r < p.win; r += kActivators / 8)
            snake_piece(win + r * 128 + ((q ^ (r & 7)) << 4), al, ib);
          __syncwarp();
          if (lane == 0) bar_arrive(ready + slot);
        }
      }
      return;
    }
    if (pw == 1 && gbw) {
      // dgrad's gb: the sums of g over a tile's frames (the first column
      // tile of each frame tile; its chunks of the first tap group), in
      // frame order, from each slot once its window is in
      int g = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        const Tile t = tile_of<M>(p, tile);
        for (int i = 0; i < t.n; ++i, ++g) {
          const int slot = g % p.ring;
          bar_wait(full + slot, (g / p.ring) & 1);
          const int st = t.st0 + i;
          if (t.nt == 0 && st % p.groups == 0) {
            const uint8_t* const win = ring + slot * p.slot_bytes + WBYTES;
            const int q = lane / 4;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
            for (int r = p.lead; r < p.lead + M; ++r) {
              const __nv_bfloat162 v =
                  *reinterpret_cast<const __nv_bfloat162*>(
                      win + r * 128 + ((q ^ (r & 7)) << 4) + (lane % 4) * 4);
              s0 += __low2float(v);
              s1 += __high2float(v);
            }
            const int o = (st / p.groups) * kStage + 2 * lane;
            float* const part = p.ws + (size_t)(t.b * p.mtiles + t.mt) *
                                           (2 * p.C + p.O) + 2 * p.C;
            if (o < p.O) part[o] = s0;
            if (o + 1 < p.O) part[o + 1] = s1;
          }
          __syncwarp();
          if (lane == 0) bar_arrive(empty + slot);
        }
      }
    }
    if (pw != 0) return;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(wmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(amap))
                   : "memory");
    }
    int g = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const Tile t = tile_of<M>(p, tile);
      const int n0 = t.nt * BN;
      for (int i = 0; i < t.n; ++i, ++g) {
        const int slot = g % p.ring;
        if (g >= p.ring) bar_wait(empty + slot, ((g / p.ring) + 1) & 1);
        const int st = t.st0 + i;
        const int c0 = (st / p.groups) * kStage;
        const int j0 = (st % p.groups) * KT;
        uint8_t* const sl = ring + slot * p.slot_bytes;
        if (!p.tma_a) {
          // the window by plain loads, zero past every edge, in the
          // swizzled layout TMA would write
          for (int e = lane; e < p.win * kStage; e += 32) {
            const int r = e / kStage;
            const int c = e % kStage;
            const int tt = t.t0 - p.lead + r;
            const int ch = c0 + c;
            const bf16 v = tt >= 0 && tt < p.T && ch < p.Ka
                               ? a_src[((size_t)t.b * p.T + tt) * p.Ka + ch]
                               : __float2bfloat16_rn(0.f);
            *reinterpret_cast<bf16*>(sl + WBYTES + r * 128 +
                                     (((c / 8) ^ (r & 7)) << 4) +
                                     (c % 8) * 2) = v;
          }
        }
        __syncwarp();   // the lanes' stores before lane 0's arrival
        if (lane == 0) {
          bar_expect(full + slot, WBYTES + (p.tma_a ? p.win * 128 : 0));
#pragma unroll
          for (int jj = 0; jj < KT; ++jj) {
            const int j = kFwd ? j0 + jj : p.k - 1 - (j0 + jj);
            tma_2d(sl + jj * BN * 128, wmap, full + slot, c0, j * p.N + n0);
          }
          if (p.tma_a)
            tma_3d(sl + WBYTES, amap, full + slot, c0, t.t0 - p.lead, t.b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------------ consumers
  if constexpr (NC == 2 && kFwd)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n" ::: "memory");
  if constexpr (NC == 2 && !kFwd)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
  const int wg = tid / 128;
  const int wt = tid % 128;
  const int warp = wt / 32;
  const int lane = tid % 32;
  // ldmatrix: this lane's row of the 16 of its warp, and its chunk half
  const int lrow = warp * 16 + (lane / 8 % 2) * 8 + lane % 8;
  const int lhalf = lane / 16;
  float acc[BN / 2];

  // stage g of the block (stage i of its tile): its fragments, its MMAs as
  // one group, waited for (the other warpgroup's keep the tensor cores
  // busy meanwhile), then its slot handed back
  auto stage = [&](int g, int i, const Tile& t) {
    const int slot = g % p.ring;
    bar_wait((kFwd ? ready : full) + slot, (g / p.ring) & 1);
    const int st = t.st0 + i;
    const int c0 = (st / p.groups) * kStage;
    const int j0 = (st % p.groups) * KT;
    const int left = p.Ka - c0;
    const int nks = left >= kStage ? 4 : (left + 15) / 16;
    const uint8_t* const wslot = ring + slot * p.slot_bytes;
    const uint8_t* const abase = wslot + WBYTES;
    const int row0 = wg * 64;
    uint32_t frag[STEPS][4];
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      const int r = row0 + lrow + (j0 + jj) * p.dilation;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (s < nks)
          ldsm_x4(frag[jj * 4 + s],
                  su32(abase + r * 128 + (((2 * s + lhalf) ^ (r & 7)) << 4)));
    }
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < KT; ++jj)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (s < nks)
          mma<BN>(acc, frag[jj * 4 + s],
                  desc128(wslot + jj * BN * 128 + s * 32));
    wg_commit();
    wg_wait<0>();
    keep_f(acc);
    keep_a(frag);
    if (lane == 0) bar_arrive(empty + slot);
  };

  int g = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const Tile t = tile_of<M>(p, tile);
    const int n0 = t.nt * BN;
    if constexpr (!kFwd) {
      if (p.need_ga && p.vec_x) {
        // the tile's x into the epilogue's buffer while its MMAs run, once
        // the last tile's epilogue is done with it
        named_sync(3, kConsumers);
        bf16* const xs = reinterpret_cast<bf16*>(extra);
        const bf16* const xb =
            static_cast<const bf16*>(p.x) + (size_t)t.b * p.T * p.C;
        for (int e = tid; e < M * BN / 8; e += kConsumers) {
          const int q = e % (BN / 8);
          const int r = e / (BN / 8);
          const int tt = t.t0 + r;
          const int c = n0 + 8 * q;
          const bool ok = tt < p.T && c < p.C;
          asm volatile(
              "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                  su32(xs + r * XS + 8 * q)),
              "l"(ok ? xb + (size_t)tt * p.C + c : xb), "r"(ok ? 16 : 0)
              : "memory");
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    keep_f(acc);
    for (int i = 0; i < t.n; ++i, ++g) stage(g, i, t);

    // this thread's sums: acc[4q + 2h + e] is frame t0 + wg*64 + 16 warp +
    // lane / 4 + 8h, column n0 + 8q + 2 (lane % 4) + e
    const int tig = lane % 4;
    const int rloc = wg * 64 + warp * 16 + lane / 4;
    if constexpr (kFwd) {
      // a split tile writes its f32 partial sums to its own slab of ws, an
      // unsplit one y rounded once
      const bool to_ws = p.splits > 1;
      float* const wsb =
          p.ws + ((size_t)t.split * p.B + t.b) * p.T * p.O;
      bf16* const yb = static_cast<bf16*>(p.out) + (size_t)t.b * p.T * p.O;
      const bf16* const bias = static_cast<const bf16*>(p.bias);
      const bool pairs = p.O % 2 == 0;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int o = n0 + 8 * q + 2 * tig;
        if (o >= p.O) continue;
        const bool has1 = o + 1 < p.O;
        const bool with_bias = t.split == 0;
        const float b0 = with_bias ? __bfloat162float(bias[o]) : 0.f;
        const float b1 = with_bias && has1 ? __bfloat162float(bias[o + 1])
                                           : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tt = t.t0 + rloc + 8 * h;
          if (tt >= p.T) continue;
          const size_t at = (size_t)tt * p.O + o;
          const float v0 = acc[4 * q + 2 * h] + b0;
          const float v1 = acc[4 * q + 2 * h + 1] + b1;
          if (to_ws) {
            if (pairs) {
              *reinterpret_cast<float2*>(wsb + at) = make_float2(v0, v1);
            } else {
              wsb[at] = v0;
              if (has1) wsb[at + 1] = v1;
            }
          } else if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(yb + at) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            yb[at] = __float2bfloat16_rn(v0);
            if (has1) yb[at + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    } else {
      if (!p.need_ga) continue;
      // ga = acc.  The tile's x comes into shared memory by 16-byte loads,
      // gx goes back in its place and out the same way (rounded once);
      // galpha's and gbeta's terms are summed over the thread's 2 frames,
      // its warp's 8 lanes of a column (shuffles) and the consumer warps
      // (shared memory), in fixed orders
      bf16* const xs = reinterpret_cast<bf16*>(extra);          // [M][XS]
      float* const coef = reinterpret_cast<float*>(xs + M * XS); // [2][BN]
      float* const red = coef + 2 * BN;                 // [warps][2][BN]
      const int cwarp = tid / 32;
      const bf16* const xb =
          static_cast<const bf16*>(p.x) + (size_t)t.b * p.T * p.C;
      bf16* const gxb = p.out == nullptr
                            ? nullptr
                            : static_cast<bf16*>(p.out) +
                                  (size_t)t.b * p.T * p.C;
      if (p.vec_x) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      } else {
        named_sync(3, kConsumers);   // the last tile's epilogue is done
        for (int e = tid; e < M * BN / 8; e += kConsumers) {
          const int q = e % (BN / 8);
          const int r = e / (BN / 8);
          const int tt = t.t0 + r;
          const int c = n0 + 8 * q;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          bf16* const h = reinterpret_cast<bf16*>(&v);
          if (tt < p.T) {
#pragma unroll
            for (int u = 0; u < 8; ++u)
              h[u] = c + u < p.C ? xb[(size_t)tt * p.C + c + u]
                                 : __float2bfloat16_rn(0.f);
          }
          *reinterpret_cast<uint4*>(xs + r * XS + 8 * q) = v;
        }
      }
      const bf16* const alpha = static_cast<const bf16*>(p.alpha);
      const bf16* const beta = static_cast<const bf16*>(p.beta);
      for (int c = tid; c < BN; c += kConsumers) {
        const bool live = n0 + c < p.C;
        coef[c] = live ? __bfloat162float(alpha[n0 + c]) : 0.f;
        coef[BN + c] =
            live ? 1.0f / (__bfloat162float(beta[n0 + c]) + 1e-9f) : 0.f;
      }
      named_sync(3, kConsumers);
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int col = 8 * q + 2 * tig;
        float pa[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rloc + 8 * h;
          __nv_bfloat162* const at =
              reinterpret_cast<__nv_bfloat162*>(xs + r * XS + col);
          const __nv_bfloat162 xv = *at;
          const float xe[2] = {__low2float(xv), __high2float(xv)};
          float out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // past C alpha and 1 / e are 0 (and x is): no term; past T
            // no term
            const float al = coef[col + e];
            const float ib = coef[BN + col + e];
            const float ga = acc[4 * q + 2 * h + e];
            float sn, co;
            sin_cos(xe[e] * al, &sn, &co);
            out[e] = ga * (1.0f + 2.0f * al * sn * co * ib);
            if (t.t0 + r < p.T) {
              pa[e] += ga * (2.0f * xe[e] * sn * co * ib);
              pb[e] += ga * (sn * sn * ib * ib);
            }
          }
          *at = __floats2bfloat162_rn(out[0], out[1]);
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
              red[(cwarp * 2) * BN + col + e] = pa[e];
              red[(cwarp * 2 + 1) * BN + col + e] = pb[e];
            }
          }
        }
      }
      named_sync(3, kConsumers);
      if (gxb != nullptr) {
        for (int e = tid; e < M * BN / 8; e += kConsumers) {
          const int q = e % (BN / 8);
          const int r = e / (BN / 8);
          const int tt = t.t0 + r;
          const int c = n0 + 8 * q;
          if (tt >= p.T || c >= p.C) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(xs + r * XS + 8 * q);
          if (p.vec_x) {
            *reinterpret_cast<uint4*>(gxb + (size_t)tt * p.C + c) = v;
          } else {
            const bf16* const h = reinterpret_cast<const bf16*>(&v);
            for (int u = 0; u < 8 && c + u < p.C; ++u)
              gxb[(size_t)tt * p.C + c + u] = h[u];
          }
        }
      }
      if (p.need_ab) {
        float* const part =
            p.ws + (size_t)(t.b * p.mtiles + t.mt) * (2 * p.C + p.O);
        for (int i = tid; i < 2 * BN; i += kConsumers) {
          const int which = i / BN;
          const int col = i % BN;
          const int c = n0 + col;
          if (c >= p.C) continue;
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < 4 * NC; ++w) s += red[(w * 2 + which) * BN + col];
          part[(size_t)which * p.C + c] = which ? -s : s;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: plans, tensor maps, launches
// ---------------------------------------------------------------------------

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Plan {
  int m, bn, kt, groups, n_stages, per_split, splits, ring;
  int mtiles, ntiles, n_tiles, grid;
  int slot_bytes;
  size_t smem;
};

// the epilogue buffers of dgrad: x / gx tile, coefficients, the consumer
// warps' sums (m / 16 warps)
inline int dgrad_extra(int m, int bn) {
  return align1k(2 * m * (bn + 8) + 4 * 2 * bn + 4 * (m / 16) * 2 * bn);
}

// Tile height, width, ring and (forward) split of the channel sum for one
// shape, from a model of the kernels' times on an H100: a stage costs the
// larger of its tensor-core cycles (a warpgroup's m64nNk16 counted as N +
// 32; both warpgroups share the tensor cores) and, forward, its snake (20
// cycles a window row), plus a fixed 600; a block costs its stages and a
// tile's epilogue (a stage's worth forward, two dgrad) for each of its
// tiles, the grid whole rounds of tiles over the 132 SMs; a split adds its
// f32 slabs, written and read back, at 1830 bytes a cycle.  Its choices
// were held to the kernels' times with each tile forced
// (scripts/torch_bf16_tiles.py) at a transfer's, a buffer's and the
// encoder's training shapes.
inline int make_plan(bool fwd, int B, int T, int Ka, int N, int k,
                     int dilation, Plan* plan) {
  const double FIX = 600.0, EPI = fwd ? 1.0 : 2.0;
  const int kt = k % 3 == 0 ? 3 : 1;
  const int groups = k / kt;
  const int n_stages = cdiv(Ka, kStage) * groups;
  const int nks = Ka >= kStage ? 4 : cdiv(Ka, 16);
  double best = -1.0;
  for (int m = 128; m >= 64; m /= 2) {
    const int win = m + (k - 1) * dilation;
    if (win > 256) continue;
    const int nc = m / 64;
    for (int bn = 64; bn <= 128; bn *= 2) {
      if (bn > 64 && cdiv(N, bn) * bn >= 2 * N) continue;
      const int slot = kt * bn * 128 + align1k(win * 128);
      const int extra =
          fwd ? align1k(8 * cdiv(Ka, kStage) * kStage) : dgrad_extra(m, bn);
      const int room = kMaxSmem - 1024 - kBarBytes - extra;
      int ring = room / slot;
      if (ring > kMaxRing) ring = kMaxRing;
      if (ring < 2) continue;
      const double mma = (double)nc * kt * nks * (bn + 32);
      const double actc = fwd ? 20.0 * win : 0.0;
      const double stage = (mma > actc ? mma : actc) + FIX;
      const int mtiles = cdiv(T, m);
      const int ntiles = cdiv(N, bn);
      const int most = fwd ? (n_stages / 2 > 1 ? n_stages / 2 : 1) : 1;
      for (int s = 1; s <= most; ++s) {
        const int per = cdiv(n_stages, s);
        const int splits = cdiv(n_stages, per);
        if (splits != s) continue;
        const int n_tiles = mtiles * ntiles * B * splits;
        const int waves = cdiv(n_tiles, kSMs);
        // a split writes its f32 slabs and sum_splits reads them back
        const double cost =
            waves * (per + EPI) * stage +
            (splits > 1 ? (splits + 1.0) * 4.0 * B * (double)T * N / 1830.0
                        : 0.0);
        if (best < 0 || cost < best) {
          best = cost;
          plan->m = m;
          plan->bn = bn;
          plan->kt = kt;
          plan->groups = groups;
          plan->n_stages = n_stages;
          plan->per_split = per;
          plan->splits = splits;
          plan->ring = ring;
          plan->mtiles = mtiles;
          plan->ntiles = ntiles;
          plan->n_tiles = n_tiles;
          plan->grid = n_tiles < kSMs ? n_tiles : kSMs;
          plan->slot_bytes = slot;
          plan->smem = (size_t)1024 + kBarBytes + (size_t)ring * slot + extra;
        }
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

inline int encoder(EncodeTiled* out) {
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
  *out = encode;
  return 0;
}

// a bf16 tensor map, 128-byte swizzled boxes of 64 channels (the innermost
// dimension) x box1 x box2, zero fill past every edge
inline int bf16_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, int box1, int box2) {
  EncodeTiled encode;
  const int err = encoder(&encode);
  if (err) return err;
  cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {kStage, (cuuint32_t)box1, (cuuint32_t)box2};
  const cuuint32_t estrides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the launch parameters and tensor maps of a planned shape: w is the
// (k * N, Wc) weight, a the (B, T, Ka) window source
inline int prepare(const Plan& plan, const void* w, int Wc, Params* p,
                   CUtensorMap* wmap, CUtensorMap* amap) {
  p->win = plan.m + (p->k - 1) * p->dilation;
  p->groups = plan.groups;
  p->n_stages = plan.n_stages;
  p->per_split = plan.per_split;
  p->splits = plan.splits;
  p->mtiles = plan.mtiles;
  p->ntiles = plan.ntiles;
  p->n_tiles = plan.n_tiles;
  p->ring = plan.ring;
  p->slot_bytes = plan.slot_bytes;
  p->tma_a = p->Ka % 8 == 0 && (uintptr_t)p->a % 16 == 0;
  const cuuint64_t wdims[2] = {(cuuint64_t)Wc, (cuuint64_t)p->k * p->N};
  int err = bf16_map(wmap, w, 2, wdims, plan.bn, 1);
  if (err) return err;
  *amap = *wmap;   // unused without TMA for the window
  if (p->tma_a) {
    const cuuint64_t adims[3] = {(cuuint64_t)p->Ka, (cuuint64_t)p->T,
                                 (cuuint64_t)p->B};
    err = bf16_map(amap, p->a, 3, adims, p->win, 1);
  }
  return err;
}

}  // namespace snake16
