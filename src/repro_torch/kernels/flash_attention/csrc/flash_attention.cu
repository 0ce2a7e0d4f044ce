// Flash attention forward for Hopper (sm_90a), bfloat16 and float32.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:90 `flash_attention` (body
// `_kernel`, kernel.py:27; pallas_call at kernel.py:110).  Same function:
//
//   q [B, H, L, D], k and v [B, K, S, D] (any strides with a unit last
//   stride), query head h reads kv head h / (H / K); query i sits at key
//   position i + S - L (end-aligned); s = q.k^T * scale in float32, then
//   tanh(s / cap) * cap when a soft-cap is given, then the causal
//   (q_pos >= k_pos) and window (q_pos - k_pos < window) masks; an online
//   softmax keeps the running max, the running sum and a float32
//   accumulator; p is cast to v's dtype before p.v and the row sum is
//   taken over the float32 p; the output is acc / max(l, 1e-30), in q's
//   dtype; a masked score contributes exactly 0.
//
// What bounds it: tensor-core operations.  At gemma2-2b's prefill shape
// (B 2, H 8, K 4, L = S = 8192, D 256) a global layer does 4 * B * H * D
// flops for every live (query, key) pair, about 5.5e11, and moves 0.2 GB:
// some 2 700 flops per byte, far above the card's ridge point.  So the
// bfloat16 kernel (`flash_fwd_bf16`) is built to keep the tensor cores fed
// and to spend as little as it can around them:
//
//   * warp specialisation: a block of 3 warpgroups per (128-query tile,
//     head, batch).  One producer thread loads the query tile once and
//     streams the live 64-key tiles of k and v through TMA into a ring (2
//     stages at head dim 256, 4 below; a full and an empty mbarrier per
//     stage for k and for v, released once per consumer warp);
//     `setmaxnreg` leaves the producer 24 registers and gives each
//     consumer thread 240.  The tensor maps describe the [B, L, H, D] and
//     [B, S, K, D] model layouts through their strides, so nothing is
//     transposed or copied; ragged rows past L or S and head dims past D
//     (112 -> 128, 16 -> 64) arrive as zeros by TMA's out-of-bounds fill;
//   * wgmma for both products: two consumer warpgroups own 64 query rows
//     each.  q.k^T reads both operands from 128-byte-swizzled shared
//     memory; p.v takes p from registers as bf16 (the score accumulator's
//     layout is the A operand's) and v as an MN-major operand with the
//     transpose bit set.  At head dim 256 the accumulator is 64 x 256
//     float32, 128 registers a thread; 192 KB of shared memory.  At head
//     dim 112 the products run over 112 head dims, not the padded 128;
//   * overlap inside a warpgroup: q.k^T of tile j is issued with p.v of
//     tile j - 1, and the softmax of tile j runs while that p.v holds the
//     tensor cores (p alternates between two register sets, so no
//     register a wgmma in flight reads is written and ptxas keeps the
//     wgmmas asynchronous);
//   * less work per score: exp2 with scale * log2(e) folded into one
//     multiply; the soft-cap's tanh as 1 - 2 / (1 + 2^(2 y log2 e)) through
//     ex2.approx and rcp.approx (tanh.approx's 2^-11 relative error would
//     move a score near the cap of 50 by more than bf16 rounds p); the
//     masks are evaluated only on key tiles that cross the causal
//     diagonal, the window's lower edge or the end of S; o is rescaled
//     only when some row's max moved; row sums stay per thread until the
//     end;
//   * the heaviest (latest) query tiles of every head are dispatched first.
//
// What still holds it back, measured on the card (PERF.md): about half
// the tensor-core peak.  The products, the softmax and the copies each
// take most of a tile's time alone and overlap only in part; a ping-pong
// between the consumer warpgroups on named barriers and k and v loads
// shared by the two heads of a GQA pair (TMA multicast in a cluster of
// two) were measured no faster and slower.
//
// The float32 kernel (`flash_fwd_f32`) stays full float32 (no TF32) on the
// FP32 pipes: 4 warps per 32 queries, one key per lane for the scores and
// a slice of head dims per lane for p.v, head dims padded to 32, 64, 128
// or 256 in shared memory.
//
// Built by kernel.py with nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, called through ctypes; the
// tensor maps are encoded on the host through cuTensorMapEncodeTiled,
// obtained with cudaGetDriverEntryPoint, so nothing links against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1.0e38f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, K, L, S, D, group;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_sl;
  int causal, window;  // window <= 0: no window
  float softcap, scale;  // softcap <= 0: no soft-cap
};

// Live key range [*k_begin, *k_end) of the query rows [r0, r1) of one
// block; empty when k_end <= k_begin.
__device__ __forceinline__ void live_keys(const Params& p, int r0, int r1,
                                          int* k_begin, int* k_end) {
  const int off = p.S - p.L;
  const int q_lo = r0 + off;
  const int q_hi = r1 - 1 + off;
  int kb = 0, ke = p.S;
  if (p.causal) ke = min(ke, q_hi + 1);
  if (p.window > 0) kb = max(kb, q_lo - p.window + 1);
  *k_begin = kb;
  *k_end = ke;
}

__device__ __forceinline__ float score(const Params& p, float dot, int qpos,
                                       int key) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
  const bool ok = key < p.S && (!p.causal || qpos >= key) &&
                  (p.window <= 0 || qpos - key < p.window);
  return ok ? s : kNegInf;
}

// ---------------------------------------------------------------------------
// float32: full float32 on the FP32 pipes
// ---------------------------------------------------------------------------

// Rows of a [rows, D] float32 matrix into shared memory [ROWS][LD]; rows
// past `nrows` and columns past D are zero.  D % 4 == 0 and 16-byte
// aligned rows are checked by the wrapper; LD % 4 == 0 takes vector
// stores, otherwise scalar ones.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ld, int row0,
                                              int nrows, int D) {
  constexpr int CHUNKS = DP / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && c < D)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * ld + c);
    float* d = dst + r * LD + c;
    if (LD % 4 == 0) {
      *reinterpret_cast<float4*>(d) = val;
    } else {
      d[0] = val.x;
      d[1] = val.y;
      d[2] = val.z;
      d[3] = val.w;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  constexpr int BM = 32;  // 4 warps x 8 query rows
  constexpr int BN = 32;  // one key per lane
  constexpr int RW = 8;   // rows per warp
  constexpr int KLD = DP + 1;  // odd stride: lanes read distinct banks
  constexpr int CW = DP / 32;  // head dims per lane in p.v
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BM][DP]
  float* Vs = Qs + BM * DP;                     // [BN][DP]
  float* Ks = Vs + BN * DP;                     // [BN][KLD]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = qt * BM, r1 = min(r0 + BM, p.L);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile_f32<BM, DP, DP>(Qs, qg, p.q_sl, r0, p.L, p.D);

  int k_begin, k_end;
  live_keys(p, r0, r1, &k_begin, &k_end);
  const int t_begin = k_begin / BN;
  const int t_end = k_end > k_begin ? (k_end + BN - 1) / BN : t_begin;

  float acc[RW][CW];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  float m_r[RW], l_r[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  const int row_w = warp * RW;
  const int off = p.S - p.L;

  for (int kt = t_begin; kt < t_end; ++kt) {
    __syncthreads();
    load_tile_f32<BN, DP, KLD>(Ks, kg, p.k_ss, kt * BN, p.S, p.D);
    load_tile_f32<BN, DP, DP>(Vs, vg, p.v_ss, kt * BN, p.S, p.D);
    __syncthreads();

    // lane = key: s[i] = q[row_w + i] . k[lane]
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.f;
    const float* kr = Ks + lane * KLD;
    for (int d = 0; d < DP; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (row_w + i) * DP + d);
        s[i] = fmaf(qv.x, k0, s[i]);
        s[i] = fmaf(qv.y, k1, s[i]);
        s[i] = fmaf(qv.z, k2, s[i]);
        s[i] = fmaf(qv.w, k3, s[i]);
      }
    }

    const int key = kt * BN + lane;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float x = score(p, s[i], r0 + row_w + i + off, key);
      float mx = x;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      const float pr = x == kNegInf ? 0.f : expf(x - m_new);
      float sum = pr;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l_r[i] = alpha * l_r[i] + sum;
      m_r[i] = m_new;
      s[i] = pr;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }

    // lane = head dims lane + 32 c: acc[i][c] += sum_n p[i][n] v[n][.]
    for (int n = 0; n < BN; ++n) {
      float vv[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) vv[c] = Vs[n * DP + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float pn = __shfl_sync(0xffffffffu, s[i], n);
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(pn, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = r0 + row_w + i;
    if (row >= p.L) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int col = lane + 32 * c;
      if (col < p.D) og[row * p.o_sl + col] = acc[i][c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised TMA + wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 128;           // query rows of a block
constexpr int kWgRows = 64;        // query rows of a consumer warpgroup
constexpr int kBN = 64;            // keys of a tile
constexpr int kWsThreads = 3 * 128;  // producer + two consumer warpgroups
constexpr int kSmemLimit = 232448;
constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry for a padded head dim DP (64, 128 or 256).  Every tile is
// stored as DP / 64 panels of [rows, 64] bf16, 128 bytes a row, in TMA's
// 128-byte swizzle, each panel 1024-byte aligned.  The ring holds STAGES
// key tiles and STAGES value tiles of kBN keys.
template <int DP>
struct Tiles {
  static constexpr int STAGES = DP == 256 ? 2 : 4;
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_PANEL = kBM * 128;
  static constexpr int KV_PANEL = kBN * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q; then per stage full k, full v, empty k, empty v
  static constexpr int BARS = 1 + 4 * STAGES;
  static constexpr int SMEM = BAR_OFF + 8 * BARS + 1024;  // + alignment
  static_assert(SMEM <= kSmemLimit, "tiles exceed the shared memory");
  static_assert(Q_PANEL % 1024 == 0 && KV_PANEL % 1024 == 0,
                "panels must keep the 1024-byte swizzle alignment");
};

struct Attn {
  void* o;
  long long o_sb, o_sh, o_sl;
  int L, S, D, group, causal, window;
  float softcap, scale;
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

// One arrival for the calling warp, once all its lanes are here (each
// lane's wgmma reads of the stage are complete by then).
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Wait until the barrier's phase differs from `parity`.  (No watchdog
// trap in the loop: an exit path there stops ptxas from allocating the
// consumers' registers per setmaxnreg, and the bf16 kernel then spills.)
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

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets in 16-byte units.
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
// Wait until at most N wgmma groups of this warpgroup are in flight.
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 in, float32 accumulate into d[N / 2] (the
// accumulator fragment: row 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane %
// 4) (+ 1) for d[4 j .. 4 j + 3]).  `ss`: A and B K-major descriptors.
// `rs`: A from registers (the m16n8k16 A fragment of the warp's 16 rows),
// B an MN-major descriptor (transpose bit set).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n112(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  static_assert(N == 64 || N == 112 || N == 128 || N == 256,
                "p.v widths 64, 112, 128, 256");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (N == 112) {
    wgmma_rs_n112(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    wgmma_rs_n256(d, a, b);
  }
}

// The products of one key tile for one consumer warpgroup, issued without
// fence or commit (the caller issues a stage's products under one fence).
// DN: the head dims they cover (D rounded up to 16).  qk: sc = q.k^T over
// DN / 16 steps of 16 head dims (32 bytes; a new panel every 4), the first
// step overwriting sc.  pv: o += p.v over kBN / 16 steps of 16 keys (2 048
// bytes of v), N = DN.
template <int DP, int DN>
__device__ __forceinline__ void qk_wgmmas(float (&sc)[kBN / 2], uint64_t dq,
                                          uint64_t dk) {
  using T = Tiles<DP>;
#pragma unroll
  for (int kk = 0; kk < DN / 16; ++kk) {
    const int kq = (kk / 4) * T::Q_PANEL + (kk % 4) * 32;
    const int kkv = (kk / 4) * T::KV_PANEL + (kk % 4) * 32;
    wgmma_ss_n64(sc, dq + (kq >> 4), dk + (kkv >> 4), kk > 0);
  }
}

template <int DN>
__device__ __forceinline__ void pv_wgmmas(float (&o)[DN / 2],
                                          uint32_t (&pk)[kBN / 4],
                                          uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_rs<DN>(o, &pk[4 * kk], dv + ((kk * 16 * 128) >> 4));
}

// What one consumer thread knows of the score function.
struct ScoreFn {
  int S, causal, window;
  bool cap;
  float c, cap_in, cap_out;
};

// Online softmax over one tile of scores (this thread: rows qpos0 and
// qpos0 + 8, keys key0 + 8 jj + ccol (+1)).  Soft-caps, masks when `edge`,
// updates m and this thread's share of l, returns alpha (the factor for
// o) and p rounded to bf16 as the A fragments of p.v.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2],
                                             uint32_t (&pk)[kBN / 4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const ScoreFn& f, bool edge,
                                             int qpos0, int key0, int ccol) {
  if (f.cap) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      sc[i] = f.cap_out - 2.f * f.cap_out * rcp(1.f + ex2(sc[i] * f.cap_in));
  }
  if (edge) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
#pragma unroll
      for (int jj = 0; jj < kBN / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * jj + ccol + e;
          const bool ok = key < f.S && (!f.causal || key <= qpos) &&
                          (f.window <= 0 || qpos - key < f.window);
          if (!ok) sc[4 * jj + 2 * r + e] = kNegInf;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj)
      mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * r], sc[4 * jj + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    // a row with no live key yet keeps m at kNegInf; subtracting 0 then
    // sends its masked scores (and alpha) to exactly 0
    const float mc = (m_new == kNegInf ? 0.f : m_new) * f.c;
    alpha[r] = ex2(m[r] * f.c - mc);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * r + e;
        sc[i] = ex2(fmaf(sc[i], f.c, -mc));
        sum += sc[i];
      }
    }
    l[r] = l[r] * alpha[r] + sum;
  }
  // the accumulator layout of keys 16 kk.. is the A fragment of p.v
#pragma unroll
  for (int i = 0; i < kBN / 4; ++i)
    pk[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// One block per (head, batch, 128-query tile); warpgroup 0 produces,
// warpgroups 1 and 2 consume 64 query rows each.  The two roles part at
// the top and never meet again (setmaxnreg needs that).  DP: the padded
// head dim of the tiles in shared memory; DN: the head dims the products
// cover (112 at zamba2-7b's head dim, else DP).
template <int DP, int DN>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Attn p) {
  using T = Tiles<DP>;
  constexpr int ST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + T::K_OFF, sV = base + T::V_OFF;
  const uint32_t bar_q = base + T::BAR_OFF;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + ST + s); };
  auto empty_k = [&](int s) { return bar_q + 8u * (1 + 2 * ST + s); };
  auto empty_v = [&](int s) { return bar_q + 8u * (1 + 3 * ST + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  // heaviest (latest) query tiles of every head first: causal work grows
  // with the row
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / p.group;
  const int r0 = qt * kBM;
  const int off = p.S - p.L;
  // the block's live key tiles [t0, t0 + nt) (the TPU kernel's pl.when)
  int kb = 0, ke = p.S;
  if (p.causal) ke = min(ke, min(r0 + kBM, p.L) + off);
  if (p.window > 0) kb = max(kb, r0 + off - p.window + 1);
  const int t0 = kb / kBN;
  const int nt = ke > kb ? (ke + kBN - 1) / kBN - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 2 * 4);  // one arrival per consumer warp
      mbar_init(empty_v(s), 2 * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy, k of a tile before its v
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && nt > 0) {
      mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn)
        tma_load(sQ + pn * T::Q_PANEL, &tq, bar_q, 64 * pn, r0, h, b);
      for (int j = 0; j < nt; ++j) {
        const int s = j % ST;
        const uint32_t ph = (j / ST) & 1;
        const int key0 = (t0 + j) * kBN;
        mbar_wait(empty_k(s), ph ^ 1);
        mbar_expect_tx(full_k(s), T::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn)
          tma_load(sK + s * T::KV_BYTES + pn * T::KV_PANEL, &tk, full_k(s),
                   64 * pn, key0, kvh, b);
        mbar_wait(empty_v(s), ph ^ 1);
        mbar_expect_tx(full_v(s), T::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn)
          tma_load(sV + s * T::KV_BYTES + pn * T::KV_PANEL, &tv, full_v(s),
                   64 * pn, key0, kvh, b);
      }
    }
  } else {
    // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int row_lo = r0 + cw * kWgRows;
    const int q_lo = row_lo + off;
    const int q_hi = min(row_lo + kWgRows, p.L) - 1 + off;
    const int rrow = warp * 16 + (lane >> 2);  // this thread's rows: +0, +8
    const int ccol = 2 * (lane & 3);  // its columns in an n8 chunk: +0, +1
    const int qpos0 = row_lo + rrow + off;
    // Without a soft-cap the scores stay raw and p = 2^(s c - m c) with
    // c = scale log2(e); with one they become the capped score in log2
    // units, cap log2(e) tanh(s scale / cap), and c = 1.
    ScoreFn f;
    f.S = p.S;
    f.causal = p.causal;
    f.window = p.window;
    f.cap = p.softcap > 0.f;
    f.c = f.cap ? 1.f : p.scale * kLog2e;
    f.cap_in = f.cap ? 2.f * p.scale * kLog2e / p.softcap : 0.f;
    f.cap_out = p.softcap * kLog2e;
    // A tile needs the masks when some pair of this warpgroup's rows in it
    // is masked.  Both warpgroups run every tile of the block: a tile
    // where one of them has no live pair is all masked there and adds 0.
    auto edge = [&](int j) {
      const int key0 = (t0 + j) * kBN;
      return key0 + kBN > p.S || (p.causal && key0 + kBN - 1 > q_lo) ||
             (p.window > 0 && key0 <= q_hi - p.window);
    };

    // descriptors: q's rows of this warpgroup, and stage 0 of k (K-major)
    // and v (MN-major: LBO steps 64 head dims, one panel; SBO 8 keys)
    const uint64_t dq = sw128_desc(sQ + cw * kWgRows * 128, 1, 64);
    const uint64_t dk0 = sw128_desc(sK, 1, 64);
    const uint64_t dv0 = sw128_desc(sV, kBN * 8, 64);
    constexpr int KV16 = T::KV_BYTES >> 4;

    float o[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
    float sc[kBN / 2];
    uint32_t pk_a[kBN / 4], pk_b[kBN / 4];

    // o and p are final before a stage's first wgmma, and read again only
    // after its wait
    auto fence_o_p = [&](uint32_t (&pk)[kBN / 4]) {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) reg_fence(o[i]);
#pragma unroll
      for (int i = 0; i < kBN / 4; ++i) reg_fence(pk[i]);
    };
    // The scores of tile j run on the tensor cores beside p.v of tile
    // j - 1, and the softmax of tile j overlaps that p.v.  p of tile j - 1
    // is in `cur`, tile j's goes to `nxt`: the loop runs two tiles a turn
    // with the buffers swapped, so no register that a wgmma in flight
    // reads is written (ptxas would serialise the wgmmas).
    // o *= alpha of the last softmax; most tiles leave every row's max
    // where it was, and then alpha is 1
    auto rescale = [&]() {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int jj = 0; jj < DN / 8; ++jj) {
          o[4 * jj] *= alpha[0];
          o[4 * jj + 1] *= alpha[0];
          o[4 * jj + 2] *= alpha[1];
          o[4 * jj + 3] *= alpha[1];
        }
      }
    };
    // The scores of tile j run on the tensor cores beside p.v of tile
    // j - 1, and the softmax of tile j overlaps that p.v; o takes the
    // previous softmax's alpha between the two issues.  p of tile j - 1 is
    // in `cur`, tile j's goes to `nxt`: the loop runs two tiles a turn with
    // the buffers swapped, so no register that a wgmma in flight reads is
    // written (ptxas would serialise the wgmmas).
    auto step = [&](int j, uint32_t (&cur)[kBN / 4],
                    uint32_t (&nxt)[kBN / 4]) {
      const int s = j % ST, sp = (j - 1) % ST;
      mbar_wait(full_k(s), (j / ST) & 1);
      wgmma_fence();
      qk_wgmmas<DP, DN>(sc, dq, dk0 + s * KV16);
      wgmma_commit();
      rescale();
      mbar_wait(full_v(sp), ((j - 1) / ST) & 1);
      fence_o_p(cur);
      wgmma_fence();
      pv_wgmmas<DN>(o, cur, dv0 + sp * KV16);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) reg_fence(sc[i]);
      warp_arrive(empty_k(s));
      softmax_tile(sc, nxt, m, l, alpha, f, edge(j), qpos0, (t0 + j) * kBN,
                   ccol);
      wgmma_wait<0>();
      fence_o_p(cur);
      warp_arrive(empty_v(sp));
    };
    auto last = [&](uint32_t (&cur)[kBN / 4]) {
      const int s = (nt - 1) % ST;
      rescale();
      mbar_wait(full_v(s), ((nt - 1) / ST) & 1);
      fence_o_p(cur);
      wgmma_fence();
      pv_wgmmas<DN>(o, cur, dv0 + s * KV16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_o_p(cur);
      warp_arrive(empty_v(s));
    };

    if (nt > 0) {
      mbar_wait(bar_q, 0);
      // first tile: scores and softmax (o is still 0)
      mbar_wait(full_k(0), 0);
      wgmma_fence();
      qk_wgmmas<DP, DN>(sc, dq, dk0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) reg_fence(sc[i]);
      warp_arrive(empty_k(0));
      softmax_tile(sc, pk_a, m, l, alpha, f, edge(0), qpos0, t0 * kBN, ccol);
      int j = 1;
      for (; j + 1 < nt; j += 2) {
        step(j, pk_a, pk_b);
        step(j + 1, pk_b, pk_a);
      }
      if (j < nt) {
        step(j, pk_a, pk_b);
        last(pk_b);
      } else {
        last(pk_a);
      }
    }

    if (row_lo < p.L) {
      __nv_bfloat16* og =
          static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lt = l[r];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float den = fmaxf(lt, 1e-30f);
        const int row = row_lo + rrow + 8 * r;
        if (row < p.L) {
          __nv_bfloat16* orow = og + row * p.o_sl;
#pragma unroll
          for (int jj = 0; jj < DN / 8; ++jj) {
            const int col = 8 * jj + ccol;
            if (col < p.D)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(o[4 * jj + 2 * r] / den,
                                        o[4 * jj + 2 * r + 1] / den);
          }
        }
      }
    }
  }
}

// Launches run on the calling thread's current device (the wrapper selects
// the tensors' device).  The dynamic shared-memory limit is a property of
// a kernel on one device: it is raised once per device, recorded in the
// instantiation's own `raised` bit mask (devices 0..63; any others set it
// at every launch).
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, std::atomic<uint64_t>& raised,
                       size_t smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit == 0 || !(raised.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  return cudaSuccess;
}

// Error codes of the bf16 route beyond cudaError_t: the driver's
// cuTensorMapEncodeTiled could not be found, or it refused a map (the
// code less kErrTensorMap is its CUresult).
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

// A bf16 tensor [B, heads, rows, D] (strides in elements, unit along D) as
// a 4-d map of dims (D, rows, heads, B), read in boxes of 64 head dims by
// `box_rows` rows with the 128-byte swizzle; out-of-bounds reads are 0.
CUresult make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
                  int D, int rows, int heads, int B, long long s_row,
                  long long s_head, long long s_b, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP, int DN>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Tiles<DP>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(encode, &tq, p.q, p.D, p.L, p.H, p.B, p.q_sl, p.q_sh,
                        p.q_sb, kBM);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tk, p.k, p.D, p.S, p.K, p.B, p.k_ss, p.k_sh, p.k_sb,
                 kBN);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tv, p.v, p.D, p.S, p.K, p.B, p.v_ss, p.v_sh, p.v_sb,
                 kBN);
  if (r != CUDA_SUCCESS) return kErrTensorMap + static_cast<int>(r);
  static std::atomic<uint64_t> raised{0};
  cudaError_t err = raise_smem(flash_fwd_bf16<DP, DN>, raised, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Attn a{p.o,      p.o_sb,   p.o_sh, p.o_sl,   p.L,       p.S,
               p.D,      p.group,  p.causal, p.window, p.softcap, p.scale};
  const dim3 grid(p.H, p.B, (p.L + kBM - 1) / kBM);
  flash_fwd_bf16<DP, DN><<<grid, kWsThreads, T::SMEM, stream>>>(tq, tk, tv,
                                                               a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int BM = 32, BN = 32;
  const size_t smem = sizeof(float) * (BM * DP + BN * DP + BN * (DP + 1));
  const dim3 grid((p.L + BM - 1) / BM, p.H, p.B);
  static std::atomic<uint64_t> raised{0};
  cudaError_t err = raise_smem(flash_fwd_f32<DP>, raised, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_f32<DP><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Runs on the calling thread's current
// device, which must be the one the tensors lie on.  Strides are in
// elements; the last stride of every operand is 1, the others (bf16: in
// bytes) multiples of 16 below 2^40.  window <= 0 means no window,
// softcap <= 0 no soft-cap.  Returns 0 on success, else the launch's
// cudaError_t or one of the codes flash_attention_error names; invalid
// arguments return cudaErrorInvalidValue without launching.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int K, int L,
                        int S, int D,
                        long long q_sb, long long q_sh, long long q_sl,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_sl,
                        int causal, int window, float softcap, float scale,
                        void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || L < 1 || S < 1 || D < 1 ||
      D > 256 || D % 8 != 0 || B > 65535 || H > 65535 ||
      (L + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    B,    H,    K,    L,      S,      D,
           H / K, q_sb, q_sh, q_sl, k_sb, k_sh, k_ss, v_sb, v_sh,   v_ss,
           o_sb, o_sh, o_sl, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // head dim 112 (zamba2-7b's) skips the products over the padding
    return D <= 64     ? launch_bf16<64, 64>(p, st)
           : D == 112  ? launch_bf16<128, 112>(p, st)
           : D <= 128  ? launch_bf16<128, 128>(p, st)
                       : launch_bf16<256, 256>(p, st);
  }
  if (dtype == 0) {
    const int dp = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
    return dp == 32    ? launch_f32<32>(p, st)
           : dp == 64  ? launch_f32<64>(p, st)
           : dp == 128 ? launch_f32<128>(p, st)
                       : launch_f32<256>(p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the bf16 kernel's build for head dim D.
int flash_attention_bf16_smem(int D) {
  return D <= 64 ? Tiles<64>::SMEM : D <= 128 ? Tiles<128>::SMEM
                                              : Tiles<256>::SMEM;
}

const char* flash_attention_error(int err) {
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err >= kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map (the code less "
           "100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
