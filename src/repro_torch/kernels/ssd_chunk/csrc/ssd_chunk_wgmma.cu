// SSD (Mamba2) intra-chunk block for Hopper (sm_90a), bfloat16 operands, on
// the tensor cores.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd_chunk/kernel.py:51 `ssd_chunk_pallas` (body
// `_kernel`, kernel.py:23; pallas_call at kernel.py:66) for bf16 x, B and C.
// Same function, per (batch b, head h, chunk c) of K <= 128 rows:
//
//   a_cs = cumsum(dA), summed in float64;
//   G = C.B^T (float32);
//   S = G o L with L[i, j] = exp(a_cs[i] - a_cs[j]) for i >= j and exactly 0
//   above the diagonal (selected, never multiplied: exp of a positive
//   difference can overflow and inf * 0 is NaN); every difference of two
//   prefix sums is taken in float64 before it is rounded to float32;
//   y_diag = S.x, written in bf16;
//   states = (B o w)^T.x as float32 [N, P], w = exp(a_cs[K-1] - a_cs);
//   decay = exp(a_cs[K-1]).
//
// What bounds it on this card: bytes.  At zamba2-7b's prefill (b 2, h 112,
// 64 chunks of K 128, P 64, N 64, one group) a layer must read x and dA and
// write y, the states and the decay for each of the 14 336 (b, h, c), and
// read B and C once per (b, c): 0.716 GB, 0.214 ms at 3.35 TB/s, against
// 4.5e10 live flops, 0.046 ms on the tensor cores.  What the design does
// about it:
//
//   * one C.B^T per chunk for a run of heads.  Every config of the registry
//     has one SSM group, so B and C reach the kernel as stride-0 expansions
//     over the heads.  A block takes one (b, c) and a run of heads, loads
//     the B and C tiles once and computes G = C.B^T once; per head only L,
//     the two products with x and the stores remain.  With head strides
//     that are not 0 (several groups) a run is one head, and B and C are
//     loaded for it.  The caller chooses the run (ops.head_run) so that the
//     blocks cover the SMs evenly, one block an SM (all 112 heads a block
//     at zamba2-7b);
//   * warp specialisation and a ring.  Warpgroup 0 produces: one thread
//     loads B and C once and streams each head's x tile through TMA into a
//     ring of 4 stages (full and empty mbarriers); three warps, a head each
//     in turn, read the head's dA, scan it in float64 and leave in the
//     stage a_cs (float64), w = exp(a_cs[K-1] - a_cs) and L's factors, and
//     write the decay.  Warpgroups 1 and 2 compute y for the chunk's rows
//     0-63 and 64-127, warpgroup 3 the states, so that the states, the
//     longest per-head chain, run beside the y work and not after it.  setmaxnreg leaves the producers 32 registers and gives each
//     consumer thread 160.  The tensor maps describe the model's strides
//     (x [b, l, h, P], B and C column slices of the conv output) as 5-d maps
//     (P or N, K, c, h, b), so nothing is copied; a head of B and C maps to
//     its group's coordinate, not to the stride-0 view; ragged K, P and N
//     arrive as TMA's out-of-bounds zeros;
//   * L from factors.  Per head, L[i, j] = R[kk][i] E[j] with kk = j / 16
//     (the k-step's column block), E[j] = exp(a_cs[16 kk] - a_cs[j]) and
//     R[kk][i] = exp(a_cs[i] - a_cs[16 kk]), the latter as
//     exp(a_cs[16 m] - a_cs[16 kk]) exp(a_cs[i] - a_cs[16 m]) (m = i / 16):
//     every exponent is a difference of float64 prefix sums rounded to
//     float32, and the producers take 320 exps a head (E, the second factor
//     of R, and 64 block-to-block factors) where the consumers would take
//     9 216 (taken per entry in the consumers, the exps and float64
//     differences double the kernel's time).  The factors are used when
//     none can overflow (dA <= 0, so R <= 1, and every exponent of E at most
//     kMaxE); otherwise the consumers take each L[i, j] directly;
//   * the products on wgmma at float32 accuracy.  G = C.B^T is one bf16
//     wgmma with both operands K-major in 128-byte-swizzled shared memory
//     and float32 accumulation (bf16 products are exact in float32); the
//     rows 0-63 warpgroup needs only G's columns 0-63 (the triangle's
//     imbalance between the two is left in place), and G stays in
//     registers for the whole run.  y = S.x takes S from registers as the A
//     operand (G's accumulator layout is the A fragment layout) and x as an
//     MN-major B operand with the transpose bit set, not copied transposed;
//     S is float32, so it goes in as a bf16 high part and a bf16 low part,
//     two wgmmas into one accumulator (about 2^-17 relative; x is exact in
//     bf16).  The states are computed transposed, states^T = (w o x)^T.B:
//     (w o x)^T comes from x's tile by ldmatrix.trans into registers, is
//     scaled by w and split into three bf16 terms (two put the states past
//     their 1e-5 bound, tests/test_torch_ssd_tiles.py); B is the MN-major B
//     operand;
//   * stores through shared memory and TMA: y's 64 rows of each warpgroup
//     through a bf16 staging tile (two a warpgroup, alternating heads), the
//     states (16 KB float32 a head at zamba2-7b, the largest write) through
//     a float32 tile in the 128-byte swizzle (conflict-free from the
//     accumulator layout); the stores clip rows past K and columns past P
//     and N.
//
// What holds it back (PERF.md): about 0.56 of the byte bound at zamba2-7b.
// Each consumer warpgroup runs its per-head chain (S or w o x, wgmmas,
// wait, staging, store) in turn, and four warps an SMSP hide little of its
// latency: by instruction count against the measured time the SMSPs issue
// about 0.4 instructions a cycle.
//
// Not taken here (ops.wgmma_route sends them to the float32-pipe kernel in
// ssd_chunk.cu): float32 operands, P > 64 or P % 8 != 0, bases or strides
// that are not multiples of 16 bytes, and B or C with a head stride of 0
// while the other's is not.  A chunk of K <= 64 rows still runs the rows
// 64-127 warpgroup (on zero rows).
//
// Built by ../kernel.py (repro_torch.kernels.nvcc) with
// nvcc -gencode arch=compute_90a,code=sm_90a into a shared library with a
// plain C interface, called through ctypes; the tensor maps are encoded on
// the host through cuTensorMapEncodeTiled, obtained with
// cudaGetDriverEntryPoint, so nothing links against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRows = 128;     // chunk rows of every tile (K <= 128)
constexpr int kWgRows = 64;    // rows of a consumer warpgroup
constexpr int kPP = 64;        // head dims of the x and y tiles (P <= 64)
constexpr int kThreads = 4 * 128;
constexpr int kStages = 4;
constexpr int kTerms = 2;      // bf16 terms of S in y = S.x
constexpr int kWTerms = 3;     // bf16 terms of w o x in the states
constexpr int kSmemLimit = 232448;
constexpr int kBlocks = kRows / 16;  // column blocks of 16 (wgmma k-steps)
// L's factored form is used when no factor can overflow: dA <= 0 (then
// R <= 1) and every block's inner decay a_cs[16 kk] - a_cs[j] <= kMaxE
constexpr float kMaxE = 80.f;

// Shared memory.  Every tile is [128 rows, 64] bf16 panels, 128 bytes a
// row in TMA's 128-byte swizzle, each 1024-byte aligned; NP is N padded to
// 64 or 128 (one or two panels of B and C).
template <int NP>
struct Layout {
  static constexpr int PANEL = kRows * 128;
  static constexpr int BC_BYTES = (NP / 64) * PANEL;
  static constexpr int X_BYTES = PANEL;
  static constexpr int Y_BYTES = kWgRows * 128;  // one staging tile
  // the states' staging tile: [NP rows n] x 64 columns p of float32, as
  // two panels of 32 columns (128 bytes a row)
  static constexpr int ST_PANEL = NP * 128;
  static constexpr int C_OFF = 0;
  static constexpr int B_OFF = C_OFF + BC_BYTES;
  static constexpr int X_OFF = B_OFF + BC_BYTES;
  static constexpr int Y_OFF = X_OFF + kStages * X_BYTES;  // 2 per warpgroup
  static constexpr int ST_OFF = Y_OFF + 4 * Y_BYTES;
  static constexpr int ACS_OFF = ST_OFF + 2 * ST_PANEL;     // float64 a_cs
  static constexpr int W_OFF = ACS_OFF + kStages * kRows * 8;  // float32 w
  // L's factors: R [8 column blocks][128 rows] and E [128], a flag
  static constexpr int R_OFF = W_OFF + kStages * kRows * 4;
  static constexpr int E_OFF = R_OFF + kStages * kBlocks * kRows * 4;
  static constexpr int F_OFF = E_OFF + kStages * kRows * 4;
  static constexpr int BAR_OFF = F_OFF + kStages * 16;
  // B and C; then full and empty per stage
  static constexpr int BARS = 1 + 2 * kStages;
  static constexpr int SMEM = BAR_OFF + 8 * BARS + 1024;  // + alignment
  static_assert(SMEM <= kSmemLimit, "tiles exceed the shared memory");
};

struct Args {
  const float* dA;
  float* st;
  float* dec;
  int b, h, c, K, P, N;
  int run;        // heads of a block
  int bc_shared;  // B and C are one tile per (b, c) for every head
  long long a_sb, a_sh, a_sc, a_sk;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival for the calling warp, once all its lanes are here.
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Wait until the barrier's phase differs from `parity` (no watchdog trap:
// an exit path in a consumer loop makes ptxas ignore setmaxnreg).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 5-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// One box of shared memory out through a 5-d tensor map (clipped at its
// bounds), in the calling thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3,
                                          int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory, made visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence, commit and wait.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// Two float32 values as T bf16 pairs whose sum is their value: the first
// term the pair rounded to bf16, each next one the rest rounded.
template <int T>
__device__ __forceinline__ void split(float v0, float v1, uint32_t (&out)[T]) {
#pragma unroll
  for (int e = 0; e < T; ++e) {
    out[e] = pack_bf16(v0, v1);
    if (e + 1 < T) {
      const float2 f = unpack_bf16(out[e]);
      v0 -= f.x;
      v1 -= f.y;
    }
  }
}

// wgmma m64nNk16, bf16 in, float32 accumulate into d[N / 2] (row 16 w +
// lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1) for d[4 j .. 4 j + 3]);
// d is overwritten when scale_d is 0.  `ss`: A and B K-major descriptors.
// `rs`: A from registers (the m16n8k16 A fragment of the warp's 16 rows), B
// an MN-major descriptor (transpose bit set).
#define D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D32(i) D8(i), D8(i + 8), D8(i + 16), D8(i + 24)

#define REGS32                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "   \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "   \
  "%26, %27, %28, %29, %30, %31"
#define REGS64                                                          \
  REGS32                                                                \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "  \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63"

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : D32(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : D32(0), D32(32)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : D32(0), D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "widths 64 and 128");
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, scale_d);
  } else {
    wgmma_ss_n128(d, a, b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "widths 64 and 128");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b, scale_d);
  } else {
    wgmma_rs_n128(d, a, b, scale_d);
  }
}

// Shared-memory addresses of one block.
struct Smem {
  uint32_t C, B, X, Y, ST, bars;
  const double* acs;
  const float* w;
  const float* R;
  const float* E;
  const int* fast;
  __device__ uint32_t full(int s) const { return bars + 8u * (1 + s); }
  __device__ uint32_t empty(int s) const {
    return bars + 8u * (1 + kStages + s);
  }
};

// S = G o L for the columns [16 k0, 16 k0 + 16 KQ) of this thread's rows
// row0 and row0 + 8, as kTerms bf16 A fragments (sf[e][4 q + i] holds term
// e of the k-step k0 + q).  L from its factors R and E when the producers
// found them safe, else directly from a_cs; selected 0 above the diagonal
// (only on blocks that cross it: `masked` false means every column is at
// or below every row of the warp).
template <int KQ, int NG, bool FAST>
__device__ __forceinline__ void s_frags(const Smem& sm, int s,
                                        const float (&G)[NG], int k0,
                                        bool masked, int row0, int row_last,
                                        int t, uint32_t (&sf)[kTerms][4 * KQ]) {
  const float* Rs = sm.R + s * kBlocks * kRows;
  const float* Es = sm.E + s * kRows;
  const double* acs = sm.acs + s * kRows;
#pragma unroll
  for (int q8 = 0; q8 < 2 * KQ; ++q8) {
    const int jj = 2 * k0 + q8;  // the 8-column block
    const int j0 = 8 * jj + 2 * t;
    if (masked && 8 * jj > row_last) {  // above the diagonal for every row
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < kTerms; ++e) sf[e][2 * q8 + r] = 0u;
      continue;
    }
    float2 ej = make_float2(0.f, 0.f);
    double2 aj = make_double2(0.0, 0.0);
    if constexpr (FAST) {
      ej = *reinterpret_cast<const float2*>(Es + j0);
    } else {
      aj = *reinterpret_cast<const double2*>(acs + j0);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      float l0, l1;
      if constexpr (FAST) {
        const float ri = Rs[(jj / 2) * kRows + i];
        l0 = ri * ej.x;
        l1 = ri * ej.y;
      } else {
        const double ai = acs[i];
        l0 = __expf(static_cast<float>(ai - aj.x));
        l1 = __expf(static_cast<float>(ai - aj.y));
      }
      float v0 = G[4 * jj + 2 * r] * l0;
      float v1 = G[4 * jj + 2 * r + 1] * l1;
      if (masked) {
        v0 = j0 <= i ? v0 : 0.f;
        v1 = j0 + 1 <= i ? v1 : 0.f;
      }
      uint32_t tv[kTerms];
      split(v0, v1, tv);
#pragma unroll
      for (int e = 0; e < kTerms; ++e) sf[e][2 * q8 + r] = tv[e];
    }
  }
}

template <int KQ, int NG>
__device__ __forceinline__ void s_fragments(const Smem& sm, int s,
                                            const float (&G)[NG], int k0,
                                            bool masked, int row0,
                                            int row_last, int t,
                                            uint32_t (&sf)[kTerms][4 * KQ]) {
  if (sm.fast[4 * s]) {
    s_frags<KQ, NG, true>(sm, s, G, k0, masked, row0, row_last, t, sf);
  } else {
    s_frags<KQ, NG, false>(sm, s, G, k0, masked, row0, row_last, t, sf);
  }
}

// One warpgroup of y = S.x.  ROLE 0 owns the chunk's rows 0-63 (G's
// columns 0-63, one pass of 4 k-steps); ROLE 1 rows 64-127 (G's columns
// 0-127, two passes of 4 k-steps, the first over the rectangle below the
// diagonal; the S fragments of a pass are rewritten once its wgmmas have
// completed, which keeps the warpgroup within 160 registers).
template <int NP, int ROLE>
__device__ __forceinline__ void consume_y(const Smem& sm, const CUtensorMap* ty,
                                          const Args& a, int bi, int ci,
                                          int h0, int nh) {
  using T = Layout<NP>;
  constexpr int NCOL = ROLE == 0 ? 64 : 128;  // G's columns
  constexpr int PASSES = NCOL / 64;
  const int tid = threadIdx.x - 128 * (ROLE + 1);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = ROLE * kWgRows + warp * 16 + g;  // and row0 + 8
  const int row_last = ROLE * kWgRows + warp * 16 + 15;  // the warp's last

  // G = C.B^T over this warpgroup's rows, once for the run
  float G[NCOL / 2];
  mbar_wait(sm.bars, 0);
  {
    const uint64_t dc = sw128_desc(sm.C + ROLE * kWgRows * 128, 1, 64);
    const uint64_t db = sw128_desc(sm.B, 1, 64);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const int off = (kk / 4) * T::PANEL + (kk % 4) * 32;
      wgmma_ss<NCOL>(G, dc + (off >> 4), db + (off >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(G);
  }

  for (int j = 0; j < nh; ++j) {
    const int s = j % kStages;
    const int hh = h0 + j;
    mbar_wait(sm.full(s), (j / kStages) & 1);
    // y = S.x: x is the MN-major B operand (one panel of P)
    const uint64_t dx = sw128_desc(sm.X + s * T::X_BYTES, 8 * kRows, 64);
    float y[kPP / 2];
    uint32_t sf[kTerms][16];
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      if (pass > 0) {
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < kTerms; ++e) reg_fence(sf[e]);
      }
      s_fragments<4>(sm, s, G, 4 * pass, ROLE == 0 || pass == 1, row0,
                     row_last, t, sf);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = 4 * pass + q;
#pragma unroll
        for (int e = 0; e < kTerms; ++e)
          wgmma_rs_n64(y, &sf[e][4 * q], dx + ((kk * 16 * 128) >> 4),
                       kk > 0 || e > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < kTerms; ++e) reg_fence(sf[e]);
    reg_fence(y);
    warp_arrive(sm.empty(s));

    // y through one of two staging tiles and one TMA store of this
    // warpgroup's 64 rows.  The store of the last head has read the other
    // tile before the barrier (its issuing thread waits there), so the
    // next head may write it with no barrier of its own
    const uint32_t yb = sm.Y + (2 * ROLE + (j & 1)) * T::Y_BYTES;
#pragma unroll
    for (int jj = 0; jj < kPP / 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        st_shared(yb + row * 128 + ((jj ^ (row & 7)) << 4) + 4 * t,
                  pack_bf16(y[4 * jj + 2 * r], y[4 * jj + 2 * r + 1]));
      }
    fence_proxy_async();
    if (tid == 0) bulk_wait_read<0>();
    wg_sync(1 + ROLE);
    if (tid == 0 && ROLE * kWgRows < a.K) {
      tma_store(ty, yb, 0, ROLE * kWgRows, ci, hh, bi);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

// The warpgroup of the states, states^T = (w o x)^T.B: (w o x)^T from x's
// tile by ldmatrix.trans (this thread: p = 16 warp + g (+ 8), k = 16 kk +
// 2 t (+ 1, + 8, + 9)), scaled, split into kWTerms terms, two k-steps at a
// time in SETS register sets (a set is rewritten once the wgmmas that read
// it have completed); B is the MN-major B operand.  The states
// leave through a staging tile and TMA stores.
template <int NP>
__device__ __forceinline__ void consume_states(const Smem& sm,
                                               const CUtensorMap* ts,
                                               const Args& a, int bi, int ci,
                                               int h0, int nh) {
  using T = Layout<NP>;
  // register sets of the A fragments: every quarter its own at N 64 (no
  // wait inside the loop), two at N 128 (the accumulator takes 64)
  constexpr int SETS = NP == 64 ? 4 : 2;
  const int tid = threadIdx.x - 3 * 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // B as the MN-major operand (LBO: one panel of 64 n)
  const uint64_t dbt = sw128_desc(sm.B, 8 * kRows, 64);
  mbar_wait(sm.bars, 0);

  for (int j = 0; j < nh; ++j) {
    const int s = j % kStages;
    const int hh = h0 + j;
    mbar_wait(sm.full(s), (j / kStages) & 1);
    const uint32_t xs = sm.X + s * T::X_BYTES;
    const float* wv = sm.w + s * kRows;
    float st[NP / 2];
    uint32_t af[SETS][kWTerms][8];
#pragma unroll
    for (int qq = 0; qq < kBlocks / 2; ++qq) {
      uint32_t(&cur)[kWTerms][8] = af[qq % SETS];
      if (qq >= SETS) {
        wgmma_wait<SETS - 1>();
#pragma unroll
        for (int e = 0; e < kWTerms; ++e) reg_fence(cur[e]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int kk = 2 * qq + q;
        const int k = 16 * kk + ((lane >> 4) << 3) + (lane & 7);
        const int chunk = 2 * warp + ((lane >> 3) & 1);  // p / 8
        uint32_t r[4];
        ldsm_x4_trans(xs + k * 128 + ((chunk ^ (k & 7)) << 4), r);
        const float2 w0 =
            *reinterpret_cast<const float2*>(wv + 16 * kk + 2 * t);
        const float2 w8 =
            *reinterpret_cast<const float2*>(wv + 16 * kk + 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 xv = unpack_bf16(r[m]);
          const float2 wm = m < 2 ? w0 : w8;
          uint32_t tv[kWTerms];
          split(xv.x * wm.x, xv.y * wm.y, tv);
#pragma unroll
          for (int e = 0; e < kWTerms; ++e) cur[e][4 * q + m] = tv[e];
        }
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int kk = 2 * qq + q;
#pragma unroll
        for (int e = 0; e < kWTerms; ++e)
          wgmma_rs<NP>(st, &cur[e][4 * q], dbt + ((kk * 16 * 128) >> 4),
                       kk > 0 || e > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b2 = 0; b2 < SETS; ++b2)
#pragma unroll
      for (int e = 0; e < kWTerms; ++e) reg_fence(af[b2][e]);
    reg_fence(st);
    warp_arrive(sm.empty(s));

    // states[n][p] (this thread: n = 8 jj + 2 t + q, p = 16 warp + g +
    // 8 r) into the panel of p / 32, row n, in the 128-byte swizzle (n & 7
    // = 2 t + q for every jj); the only staging tile, once the last store
    // has read it
    if (tid == 0) bulk_wait_read<0>();
    wg_sync(3);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = warp * 16 + g + 8 * r;
        const uint32_t at = sm.ST + (p >> 5) * T::ST_PANEL +
                            (2 * t + q) * 128 +
                            ((((p & 31) >> 2) ^ (2 * t + q)) << 4) +
                            ((p & 3) << 2);
#pragma unroll
        for (int jj = 0; jj < NP / 8; ++jj)
          st_shared(at + jj * 1024, __float_as_uint(st[4 * jj + 2 * r + q]));
      }
    fence_proxy_async();
    wg_sync(3);
    if (tid == 0) {
      const int bhc = (bi * a.h + hh) * a.c + ci;
      tma_store(ts, sm.ST, 0, 0, bhc);
      if (a.P > 32) tma_store(ts, sm.ST + T::ST_PANEL, 32, 0, bhc);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

// The producers of one head: the a_cs scan (float64, one warp), w, the
// decay, and L's factors.  Lane l holds rows l, l + 32, l + 64, l + 96;
// rows past K read 0.  With kk = j / 16 (the column block of the k-step)
// and m = i / 16, L[i, j] = R[kk][i] E[j] with E[j] = exp(a_cs[16 kk] -
// a_cs[j]) and, for i >= 16 kk, R[kk][i] = D[m][kk] F[i], D[m][kk] =
// exp(a_cs[16 m] - a_cs[16 kk]) and F[i] = exp(a_cs[i] - a_cs[16 m]):
// each exponent is a difference of float64 prefix sums rounded to float32.
// `fast` says whether the factors are safe (dA <= 0 and no exponent of E
// past kMaxE: no factor overflows, so no inf * 0); else the consumers take
// every L[i, j] directly.
__device__ __forceinline__ void scan_head(const Args& a, int bi, int hh,
                                          int ci, double* acs, float* w,
                                          float* R, float* E, int* fast) {
  const int lane = threadIdx.x & 31;
  const float* ag =
      a.dA + bi * a.a_sb + static_cast<long long>(hh) * a.a_sh + ci * a.a_sc;
  double carry = 0.0;
  bool rising = false;
#pragma unroll
  for (int q = 0; q < kRows / 32; ++q) {
    const int k = 32 * q + lane;
    double v = k < a.K ? static_cast<double>(ag[k * a.a_sk]) : 0.0;
    rising |= v > 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    v += carry;
    acs[k] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  __syncwarp();
  const double last = acs[a.K - 1];
  bool big = false;
  float f[kRows / 32];  // exp(a_cs[k] - a_cs[16 m]), m = k / 16
#pragma unroll
  for (int q = 0; q < kRows / 32; ++q) {
    const int k = 32 * q + lane;
    w[k] = expf(static_cast<float>(last - acs[k]));
    const float e = static_cast<float>(acs[k & ~15] - acs[k]);
    big |= e > kMaxE;
    E[k] = __expf(e);
    f[q] = __expf(-e);
  }
  // D[m][kk] = exp(a_cs[16 m] - a_cs[16 kk]) for kk <= m (lane l holds
  // m 8 + kk = l and l + 32); R[kk][i] = D[m][kk] f[i] for the rows i of
  // block m >= kk
  float d[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = (32 * hf + lane) >> 3, kk = lane & 7;
    d[hf] = kk <= m ? __expf(static_cast<float>(acs[16 * m] - acs[16 * kk]))
                    : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kRows / 32; ++q) {
    const int i = 32 * q + lane, m = i >> 4;
#pragma unroll
    for (int kk = 0; kk < kBlocks; ++kk) {
      const float dm = __shfl_sync(0xffffffffu, d[q >> 1], (m * 8 + kk) & 31);
      if (kk <= m) R[kk * kRows + i] = dm * f[q];
    }
  }
  const bool ok = !__any_sync(0xffffffffu, rising || big);
  if (lane == 0) {
    *fast = ok;
    a.dec[(static_cast<long long>(bi) * a.h + hh) * a.c + ci] =
        expf(static_cast<float>(last));
  }
}

// One block per (batch, chunk, run of heads); warpgroup 0 produces,
// warpgroups 1 and 2 compute y over the chunk's rows 0-63 and 64-127,
// warpgroup 3 the states.  The roles part at the top and never meet again
// (setmaxnreg needs that).
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_wgmma(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tB,
                    const __grid_constant__ CUtensorMap tC,
                    const __grid_constant__ CUtensorMap ty,
                    const __grid_constant__ CUtensorMap ts, const Args a) {
  using T = Layout<NP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  Smem sm;
  sm.C = base + T::C_OFF;
  sm.B = base + T::B_OFF;
  sm.X = base + T::X_OFF;
  sm.Y = base + T::Y_OFF;
  sm.ST = base + T::ST_OFF;
  sm.bars = base + T::BAR_OFF;
  sm.acs = reinterpret_cast<const double*>(gbase + T::ACS_OFF);
  sm.w = reinterpret_cast<const float*>(gbase + T::W_OFF);
  sm.R = reinterpret_cast<const float*>(gbase + T::R_OFF);
  sm.E = reinterpret_cast<const float*>(gbase + T::E_OFF);
  sm.fast = reinterpret_cast<const int*>(gbase + T::F_OFF);

  const int runs = (a.h + a.run - 1) / a.run;
  const int blk = blockIdx.x;
  const int hr = blk % runs;
  const int ci = (blk / runs) % a.c;
  const int bi = blk / (runs * a.c);
  const int h0 = hr * a.run;
  const int nh = min(a.run, a.h - h0);

  if (threadIdx.x == 0) {
    mbar_init(sm.bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full(s), 2);       // the x tile's TMA and the scan
      mbar_init(sm.empty(s), 3 * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
      // B and C of this (b, c) (of this head's group when not shared)
      const int hb = a.bc_shared ? 0 : h0;
      mbar_expect_tx(sm.bars, 2 * T::BC_BYTES);
#pragma unroll
      for (int pn = 0; pn < NP / 64; ++pn) {
        tma_load(sm.C + pn * T::PANEL, &tC, sm.bars, 64 * pn, 0, ci, hb, bi);
        tma_load(sm.B + pn * T::PANEL, &tB, sm.bars, 64 * pn, 0, ci, hb, bi);
      }
      for (int j = 0; j < nh; ++j) {
        const int s = j % kStages;
        mbar_wait(sm.empty(s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), T::X_BYTES);
        tma_load(sm.X + s * T::X_BYTES, &tx, sm.full(s), 0, 0, ci, h0 + j,
                 bi);
      }
    } else if (warp > 0) {
      // warps 1-3 scan every third head each
      double* acs = reinterpret_cast<double*>(gbase + T::ACS_OFF);
      float* w = reinterpret_cast<float*>(gbase + T::W_OFF);
      float* R = reinterpret_cast<float*>(gbase + T::R_OFF);
      float* E = reinterpret_cast<float*>(gbase + T::E_OFF);
      int* fast = reinterpret_cast<int*>(gbase + T::F_OFF);
      for (int j = warp - 1; j < nh; j += 3) {
        const int s = j % kStages;
        mbar_wait(sm.empty(s), ((j / kStages) & 1) ^ 1);
        scan_head(a, bi, h0 + j, ci, acs + s * kRows, w + s * kRows,
                  R + s * kBlocks * kRows, E + s * kRows, fast + 4 * s);
        warp_arrive(sm.full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    if (wg == 1) {
      consume_y<NP, 0>(sm, &ty, a, bi, ci, h0, nh);
    } else if (wg == 2) {
      consume_y<NP, 1>(sm, &ty, a, bi, ci, h0, nh);
    } else {
      consume_states<NP>(sm, &ts, a, bi, ci, h0, nh);
    }
  }
}

// Error codes beyond cudaError_t: the driver's cuTensorMapEncodeTiled could
// not be found, or it refused a map (the code less kErrTensorMap is its
// CUresult).
constexpr int kErrNoEncode = 200000;
constexpr int kErrTensorMap = 100000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static std::atomic<EncodeTiledFn> cached{nullptr};
  EncodeTiledFn fn = cached.load();
  if (fn != nullptr) return fn;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
  if (err != cudaSuccess || status != cudaDriverEntryPointSuccess ||
      ptr == nullptr)
    return nullptr;
  fn = reinterpret_cast<EncodeTiledFn>(ptr);
  cached.store(fn);
  return fn;
}

// A bf16 operand [b, heads, c, K, cols] (strides in elements, unit along
// cols) as a 5-d map of dims (cols, K, c, heads, b), read in boxes of 64
// columns by 128 rows (or `box_rows`) with the 128-byte swizzle;
// out-of-bounds reads are 0 and out-of-bounds writes are dropped.
CUresult make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
                  int cols, int K, int c, int heads, int b, long long s_k,
                  long long s_c, long long s_h, long long s_b, int box_rows) {
  const cuuint64_t dims[5] = {
      static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(K),
      static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[4] = {
      static_cast<cuuint64_t>(s_k) * 2, static_cast<cuuint64_t>(s_c) * 2,
      static_cast<cuuint64_t>(s_h) * 2, static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(box_rows), 1, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The float32 states [b h c, N, P] (contiguous) as a 3-d map of dims (P, N,
// b h c), written in boxes of 32 columns by `rows` rows with the 128-byte
// swizzle; columns past P and rows past N are dropped.
CUresult make_states_map(EncodeTiledFn encode, CUtensorMap* map, void* ptr,
                         int P, int N, long long bhc, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(bhc)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(P) * 4,
                                 static_cast<cuuint64_t>(P) * N * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Operands {
  const void *x, *B, *C;
  void* y;
  long long x_s[4], B_s[4], C_s[4], y_s[4];  // (batch, head, chunk, row)
};

template <int NP>
int launch(const Operands& o, const Args& a, cudaStream_t stream) {
  using T = Layout<NP>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  // B and C shared by the heads: a map over one head (its stride is then
  // never stepped; the chunk stride stands in, a valid one)
  const int hm = a.bc_shared ? 1 : a.h;
  CUtensorMap tx, tB, tC, ty, ts;
  CUresult r = make_map(encode, &tx, o.x, a.P, a.K, a.c, a.h, a.b, o.x_s[3],
                        o.x_s[2], o.x_s[1], o.x_s[0], kRows);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tB, o.B, a.N, a.K, a.c, hm, a.b, o.B_s[3], o.B_s[2],
                 a.bc_shared ? o.B_s[2] : o.B_s[1], o.B_s[0], kRows);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tC, o.C, a.N, a.K, a.c, hm, a.b, o.C_s[3], o.C_s[2],
                 a.bc_shared ? o.C_s[2] : o.C_s[1], o.C_s[0], kRows);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &ty, o.y, a.P, a.K, a.c, a.h, a.b, o.y_s[3],
                 o.y_s[2], o.y_s[1], o.y_s[0], kWgRows);
  if (r == CUDA_SUCCESS)
    r = make_states_map(encode, &ts, a.st, a.P, a.N,
                        static_cast<long long>(a.b) * a.h * a.c, NP);
  if (r != CUDA_SUCCESS) return kErrTensorMap + static_cast<int>(r);
  static std::atomic<uint64_t> raised{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit == 0 || !(raised.load() & bit)) {
    err = cudaFuncSetAttribute(ssd_chunk_wgmma<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  const long long blocks = static_cast<long long>(a.b) * a.c *
                           ((a.h + a.run - 1) / a.run);
  ssd_chunk_wgmma<NP><<<static_cast<unsigned>(blocks), kThreads, T::SMEM,
                        stream>>>(tx, tB, tC, ty, ts, a);
  return static_cast<int>(cudaGetLastError());
}

bool tma_ok(const void* p, const long long* s, int n) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (s[i] < 0 || (s[i] * 2) % 16 || s[i] * 2 >= (1LL << 40)) return false;
  return true;
}

}  // namespace

extern "C" {

// bf16 x, B, C and y, float32 dA, states (contiguous [b, h, c, N, P]) and
// decay ([b, h, c]).  Strides are in elements, in the order (batch, head,
// chunk, row); the last stride of x, B, C and y is 1.  B and C either both
// have head stride 0 (one tile per (b, c) for every head) or neither.
// `run`: heads of a block (1 unless B and C are shared).  Runs on the
// calling thread's current device, which must be the one the tensors lie
// on.  Returns 0 on success, else the launch's cudaError_t or one of the
// codes ssd_chunk_wgmma_error names; operands outside what the kernel takes
// (1 <= K <= 128, 8 <= P <= 64 with P % 8 == 0, 1 <= N <= 128, 16-byte
// bases and strides) return cudaErrorInvalidValue without launching.
int ssd_chunk_wgmma_fwd(const void* x, const void* dA, const void* B,
                        const void* C, void* y, void* states, void* decay,
                        int b, int h, int c, int K, int P, int N,
                        long long x_sb, long long x_sh, long long x_sc,
                        long long x_sk, long long a_sb, long long a_sh,
                        long long a_sc, long long a_sk, long long B_sb,
                        long long B_sh, long long B_sc, long long B_sk,
                        long long C_sb, long long C_sh, long long C_sc,
                        long long C_sk, long long y_sb, long long y_sh,
                        long long y_sc, long long y_sk, int run,
                        void* stream) {
  const int shared = B_sh == 0 && C_sh == 0;
  const Operands o{x,
                   B,
                   C,
                   y,
                   {x_sb, x_sh, x_sc, x_sk},
                   {B_sb, B_sh, B_sc, B_sk},
                   {C_sb, C_sh, C_sc, C_sk},
                   {y_sb, y_sh, y_sc, y_sk}};
  const long long sb[3] = {B_sb, B_sc, B_sk}, sc[3] = {C_sb, C_sc, C_sk};
  const long long blocks =
      run < 1 ? 0 : static_cast<long long>(b) * c * ((h + run - 1) / run);
  if (b < 1 || h < 1 || c < 1 || K < 1 || K > kRows || P < 8 || P > kPP ||
      P % 8 || N < 1 || N > 128 || run < 1 || run > h ||
      (!shared && run != 1) || blocks > 0x7fffffffLL ||
      !tma_ok(x, o.x_s, 4) || !tma_ok(y, o.y_s, 4) || !tma_ok(B, sb, 3) ||
      !tma_ok(C, sc, 3) ||
      (!shared && (B_sh == 0 || C_sh == 0 || !tma_ok(B, &B_sh, 1) ||
                   !tma_ok(C, &C_sh, 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(dA),
               static_cast<float*>(states),
               static_cast<float*>(decay),
               b, h, c, K, P, N, run, shared,
               a_sb, a_sh, a_sc, a_sk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N <= 64 ? launch<64>(o, a, st) : launch<128>(o, a, st);
}

// Dynamic shared memory of the build for state width N.
int ssd_chunk_wgmma_smem(int N) {
  return N <= 64 ? Layout<64>::SMEM : Layout<128>::SMEM;
}

const char* ssd_chunk_wgmma_error(int err) {
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err >= kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map (the code less "
           "100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
