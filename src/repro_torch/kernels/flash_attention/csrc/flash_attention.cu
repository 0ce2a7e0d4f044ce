// Flash attention forward for Hopper (sm_90a), float32 and bfloat16.
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
//   accumulator; p is cast to v's dtype before p.v; the output is
//   acc / max(l, 1e-30), in q's dtype.
//
// What bounds it: tensor-core operations.  At gemma2-2b's prefill shape
// (B 2, H 8, K 4, L = S = 8192, D 256) a global layer does 4 * B * H * D
// flops for every live (query, key) pair, about 5.5e11, and moves 0.2 GB:
// some 2 700 flops per byte, far above the card's ridge point.  The
// design therefore spends its effort on keeping the products on the
// tensor cores and never writing scores to device memory:
//
//   * one block of 4 warps per (64-query tile, head, batch); the TPU's
//     sequential key-tile grid axis becomes a loop inside the block over
//     only the key tiles that the causal and window bounds leave live
//     (the TPU kernel's pl.when skip), so a windowed layer costs
//     O(L * window);
//   * bfloat16: each warp owns 16 query rows; q.k^T and p.v run on
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) with the score tile and
//     the [16, D] accumulator in registers, p reused from the score
//     registers as the A operand, v read transposed by ldmatrix.trans;
//     rows of the shared-memory tiles are padded by 16 bytes so every
//     fragment load is free of bank conflicts;
//   * float32 stays full float32 (no TF32): the same tiling on the FP32
//     pipes, each warp owning 8 query rows, one key per lane for the
//     scores and a slice of head dims per lane for p.v;
//   * head dims are padded with zeros to 32, 64, 128 or 256 in shared
//     memory; at head dim 256 the bf16 tiles (64 queries, 32 keys) take
//     68 KB and the float32 tiles (32 queries, 32 keys) 98 KB, so both
//     kernels take dynamic shared memory above 48 KB;
//   * a masked score is the finite -1e38 of the TPU kernel, and its
//     probability is forced to 0, so a row that is fully masked inside a
//     live tile (at the window's lower edge) adds nothing rather than
//     exp(0) that a later tile must wipe.
//
// wgmma and TMA come later; this kernel is simple and right first.
// Built by kernel.py with nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, called through ctypes.

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
// bfloat16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem_row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + ROWS) of a [rows, D] bf16 matrix (row stride `ld`
// elements, unit column stride) into shared memory [ROWS][DP + 8]; rows
// past `nrows` and columns past D are zero.  D % 8 == 0 and 16-byte
// aligned rows are checked by the wrapper.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long ld, int row0,
                                               int nrows, int D) {
  constexpr int LD = DP + 8;
  constexpr int CHUNKS = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < D)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int DP, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const Params p) {
  constexpr int BM = 64;  // 4 warps x 16 query rows
  constexpr int LD = DP + 8;
  constexpr int NT = BN / 8;  // score n-tiles per warp
  constexpr int OT = DP / 8;  // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;

  // heaviest (latest) query tiles first: causal work grows with the row
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * BM, r1 = min(r0 + BM, p.L);

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile_bf16<BM, DP>(Qs, qg, p.q_sl, r0, p.L, p.D);

  int k_begin, k_end;
  live_keys(p, r0, r1, &k_begin, &k_end);
  const int t_begin = k_begin / BN;
  const int t_end = k_end > k_begin ? (k_end + BN - 1) / BN : t_begin;

  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int row_a = warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  const int off = p.S - p.L;

  for (int kt = t_begin; kt < t_end; ++kt) {
    __syncthreads();  // the previous tile is no longer read
    load_tile_bf16<BN, DP>(Ks, kg, p.k_ss, kt * BN, p.S, p.D);
    load_tile_bf16<BN, DP>(Vs, vg, p.v_ss, kt * BN, p.S, p.D);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const uint32_t a0 =
          *reinterpret_cast<const uint32_t*>(Qs + row_a * LD + c);
      const uint32_t a1 =
          *reinterpret_cast<const uint32_t*>(Qs + (row_a + 8) * LD + c);
      const uint32_t a2 =
          *reinterpret_cast<const uint32_t*>(Qs + row_a * LD + c + 8);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(Qs + (row_a + 8) * LD + c + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + c;
        mma_bf16(s[j], a0, a1, a2, a3,
                 *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, soft-cap, mask; online softmax per row (two rows a thread,
    // each row spread over the 4 threads of a quad)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r0 + row_a + 8 * r + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt * BN + j * 8 + 2 * t + e;
          const float x = score(p, s[j][2 * r + e], qpos, key);
          s[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float alpha = expf(m_r[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * r + e];
          const float pr = x == kNegInf ? 0.f : expf(x - m_new);
          s[j][2 * r + e] = pr;
          sum += pr;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[r] = alpha * l_r[r] + sum;
      m_r[r] = m_new;
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // o += p.v: p (bf16) from the score registers as the A operand, v
    // [key][d] read transposed into B fragments
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + (mi & 1) * 8 + mr;
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + key * LD + nn * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * nn], a0, a1, a2, a3, bv[0], bv[1]);
        mma_bf16(o[2 * nn + 1], a0, a1, a2, a3, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row_a + 8 * r;
    if (row >= p.L) continue;
    const float den = fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* orow = og + row * p.o_sl;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
    }
  }
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

// Launches on the calling thread's current device (the wrapper selects
// the tensors' device).  The dynamic shared-memory limit is a property of
// the kernel on one device: it is raised once per device, recorded in the
// instantiation's own `raised` bit mask (devices 0..63; any others set it
// at every launch).
template <typename Kernel>
cudaError_t launch(Kernel kernel, std::atomic<uint64_t>& raised, dim3 grid,
                   size_t smem, cudaStream_t stream, const Params& p) {
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
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int BM = 64;
  constexpr int BN = DP <= 128 ? 64 : 32;
  const size_t smem = sizeof(__nv_bfloat16) * (BM + 2 * BN) * (DP + 8);
  const dim3 grid((p.L + BM - 1) / BM, p.H, p.B);
  static std::atomic<uint64_t> raised{0};
  return launch(flash_fwd_bf16<DP, BN>, raised, grid, smem, stream, p);
}

template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int BM = 32, BN = 32;
  const size_t smem = sizeof(float) * (BM * DP + BN * DP + BN * (DP + 1));
  const dim3 grid((p.L + BM - 1) / BM, p.H, p.B);
  static std::atomic<uint64_t> raised{0};
  return launch(flash_fwd_f32<DP>, raised, grid, smem, stream, p);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Runs on the calling thread's current
// device, which must be the one the tensors lie on.  Strides are in elements; the last stride of every operand is 1.
// window <= 0 means no window, softcap <= 0 no soft-cap.  Returns the
// launch's cudaError_t (0 on success); invalid arguments return
// cudaErrorInvalidValue without launching.
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
      D > 256 || D % 8 != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    B,    H,    K,    L,      S,      D,
           H / K, q_sb, q_sh, q_sl, k_sb, k_sh, k_ss, v_sb, v_sh,   v_ss,
           o_sb, o_sh, o_sl, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  cudaError_t err;
  if (dtype == 1) {
    err = dp == 32    ? launch_bf16<32>(p, st)
          : dp == 64  ? launch_bf16<64>(p, st)
          : dp == 128 ? launch_bf16<128>(p, st)
                      : launch_bf16<256>(p, st);
  } else if (dtype == 0) {
    err = dp == 32    ? launch_f32<32>(p, st)
          : dp == 64  ? launch_f32<64>(p, st)
          : dp == 128 ? launch_f32<128>(p, st)
                      : launch_f32<256>(p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
