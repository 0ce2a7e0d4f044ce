// SSD (Mamba2) intra-chunk block for Hopper (sm_90a), float32 and bfloat16
// inputs.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd_chunk/kernel.py:51 `ssd_chunk_pallas` (body
// `_kernel`, kernel.py:23; pallas_call at kernel.py:66).  Same function,
// per (batch b, head h, chunk c) of K rows:
//
//   x [K, P], dA [K] (float32), B and C [K, N], read through strides (the
//   model's [b, l, h, .] layout regrouped to [b, h, c, K, .] by views, the
//   groups of B and C expanded over the heads by a stride-0 view);
//   a_cs = cumsum(dA);
//   S = (C.B^T) o Lmask with Lmask[i, j] = exp(a_cs[i] - a_cs[j]) for
//   i >= j and exactly 0 above the diagonal (selected, never multiplied:
//   exp of a positive difference can overflow and inf * 0 is NaN);
//   y_diag = S.x, written in x's dtype;
//   states = (B o exp(a_cs[K-1] - a_cs))^T.x, [N, P] in float32;
//   decay = exp(a_cs[K-1]), float32.
//
// What bounds it: operations.  At zamba2-7b's prefill (b 2, h 112, 64
// chunks of K 128, P 64, N 64) one layer does 4.5e10 flops on the FP32
// pipes (TF32 is off in the port) against about 1.2 GB moved: some 38
// flops a byte, above the card's FP32 ridge (20).  The design keeps the
// [K, K] score tile out of device memory and the products in shared
// memory and registers:
//
//   * one block of 256 threads (8 warps) per (b, h, c); the TPU grid's
//     three parallel axes become one linear grid;
//   * x and B are upcast to float32 into shared memory once; C is loaded
//     a strip of 32 rows at a time, and S is built a strip of 32 rows at
//     a time, only up to the diagonal's column tile; the y strip follows
//     from it.  At K 128, N 128, P 128 the tiles take 166 KB (dynamic
//     shared memory; at zamba2-7b's widths 92 KB, two blocks an SM, which
//     the launch bounds hold to 128 registers a thread);
//   * each thread owns a 4 x 4 register tile of every product (4 rows,
//     4 columns 32 apart), so lanes read neighbouring shared-memory
//     words; B's rows are padded by one word, so the lanes of a warp,
//     which walk B's rows in C.B^T, hit 32 different banks;
//   * the cumulative sum runs in float64 (one warp: 4 rows a lane, then a
//     shuffle scan), and every exponent a_cs[i] - a_cs[j] and
//     a_cs[K-1] - a_cs[j] is taken in float64 before it is rounded to
//     float32: a segment of a long decaying sum keeps its own precision,
//     where a difference of two float32 prefix sums of magnitude 50 would
//     carry 4e-6 of absolute error into every exp.
//
// wgmma, TMA and pipelining come later; this kernel is simple and right
// first.  Built by ../kernel.py (repro_torch.kernels.nvcc) with
// nvcc -gencode arch=compute_90a,code=sm_90a into a shared library with a
// plain C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 32;  // rows of a C / S / y strip: 8 warps x 4 rows
constexpr int kMaxDim = 128;
constexpr int kMaxSmem = 232448;  // the opt-in limit of one block

struct Params {
  const void* x;
  const float* dA;
  const void* B;
  const void* C;
  void* y;
  float* st;
  float* dec;
  int b, h, c, K, P, N;
  long long x_sb, x_sh, x_sc, x_sk;
  long long a_sb, a_sh, a_sc, a_sk;
  long long B_sb, B_sh, B_sc, B_sk;
  long long C_sb, C_sh, C_sc, C_sk;
  long long y_sb, y_sh, y_sc, y_sk;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory of one block, in bytes: a_cs (float64), x, B (rows
// padded by one word), a C strip, an S strip (row length rounded up to a
// multiple of 32), the state weights.
__host__ __device__ inline size_t smem_bytes(int K, int P, int N) {
  const int ks = (K + kStrip - 1) / kStrip * kStrip;
  return sizeof(double) * K +
         sizeof(float) * (static_cast<size_t>(K) * P + K * (N + 1) +
                          kStrip * N + kStrip * ks + K);
}

// CQ: column groups of 32 in P (P <= 32 * CQ).
template <typename T, int CQ>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, P = p.P, N = p.N, NB = N + 1;
  const int ks = (K + kStrip - 1) / kStrip * kStrip;
  double* acs = reinterpret_cast<double*>(smem);
  float* xs = reinterpret_cast<float*>(acs + K);
  float* Bs = xs + K * P;
  float* Cs = Bs + K * NB;
  float* Ss = Cs + kStrip * N;
  float* ws = Ss + kStrip * ks;

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const long long blk = blockIdx.x;
  const int ci = static_cast<int>(blk % p.c);
  const int hi = static_cast<int>((blk / p.c) % p.h);
  const int bi = static_cast<int>(blk / (static_cast<long long>(p.c) * p.h));

  const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb + hi * p.x_sh +
                ci * p.x_sc;
  const float* ag = p.dA + bi * p.a_sb + hi * p.a_sh + ci * p.a_sc;
  const T* Bg = static_cast<const T*>(p.B) + bi * p.B_sb + hi * p.B_sh +
                ci * p.B_sc;
  const T* Cg = static_cast<const T*>(p.C) + bi * p.C_sb + hi * p.C_sh +
                ci * p.C_sc;
  T* yg = static_cast<T*>(p.y) + bi * p.y_sb + hi * p.y_sh + ci * p.y_sc;
  float* stg = p.st + blk * N * P;

  for (int e = tid; e < K * P; e += kThreads) {
    const int k = e / P, q = e - k * P;
    xs[e] = to_f32(xg[k * p.x_sk + q]);
  }
  for (int e = tid; e < K * N; e += kThreads) {
    const int k = e / N, n = e - k * N;
    Bs[k * NB + n] = to_f32(Bg[k * p.B_sk + n]);
  }
  if (ty == 0) {  // a_cs in float64: 4 rows a lane, then a shuffle scan
    double part[4], run = 0.0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = tx * 4 + r;
      run += k < K ? static_cast<double>(ag[k * p.a_sk]) : 0.0;
      part[r] = run;
    }
    double tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, tot, off);
      if (tx >= off) tot += o;
    }
    const double before = tot - run;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = tx * 4 + r;
      if (k < K) acs[k] = before + part[r];
    }
  }
  __syncthreads();
  const double last = acs[K - 1];
  for (int k = tid; k < K; k += kThreads)
    ws[k] = expf(static_cast<float>(last - acs[k]));
  if (tid == 0) p.dec[blk] = expf(static_cast<float>(last));
  __syncthreads();

  int qc[CQ];  // this lane's columns of x / y / states, clamped for loads
#pragma unroll
  for (int c = 0; c < CQ; ++c) qc[c] = min(tx + 32 * c, P - 1);

  // states[n, q] = sum_k B[k, n] w[k] x[k, q], a strip of 32 n at a time
  for (int n0 = 0; n0 < N; n0 += kStrip) {
    int nr[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) nr[a] = min(n0 + ty * 4 + a, N - 1);
    float acc[4][CQ] = {};
    for (int k = 0; k < K; ++k) {
      const float w = ws[k];
      float bv[4], xv[CQ];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = Bs[k * NB + nr[a]] * w;
#pragma unroll
      for (int c = 0; c < CQ; ++c) xv[c] = xs[k * P + qc[c]];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < CQ; ++c) acc[a][c] = fmaf(bv[a], xv[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = n0 + ty * 4 + a;
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const int q = tx + 32 * c;
        if (n < N && q < P) stg[n * P + q] = acc[a][c];
      }
    }
  }

  const int strips = ks / kStrip;
  for (int s = 0; s < strips; ++s) {
    const int r0 = s * kStrip;
    for (int e = tid; e < kStrip * N; e += kThreads) {
      const int r = e / N, n = e - r * N, k = r0 + r;
      Cs[e] = k < K ? to_f32(Cg[k * p.C_sk + n]) : 0.0f;
    }
    __syncthreads();

    // S strip: rows r0 + 4 ty + a, columns tx + 32 jb for jb <= s (the
    // column tiles up to the diagonal's)
    {
      int jr[4];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) jr[jb] = min(tx + 32 * jb, K - 1);
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty * 4 + a) * N + n];
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          if (jb <= s) {
            const float bv = Bs[jr[jb] * NB + n];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][jb] = fmaf(cv[a], bv, acc[a][jb]);
          }
        }
      }
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        if (jb > s) continue;
        const int j = tx + 32 * jb;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = r0 + ty * 4 + a;
          float v = 0.0f;
          if (i < K && j <= i)
            v = acc[a][jb] * expf(static_cast<float>(acs[i] - acs[j]));
          Ss[(ty * 4 + a) * ks + j] = v;
        }
      }
    }
    __syncthreads();

    // y strip: y[i, q] = sum_{j <= i} S[i, j] x[j, q]
    {
      const int jmax = min(K, r0 + kStrip);
      float acc[4][CQ] = {};
      for (int j = 0; j < jmax; ++j) {
        float xv[CQ];
#pragma unroll
        for (int c = 0; c < CQ; ++c) xv[c] = xs[j * P + qc[c]];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float sv = Ss[(ty * 4 + a) * ks + j];
#pragma unroll
          for (int c = 0; c < CQ; ++c) acc[a][c] = fmaf(sv, xv[c], acc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = r0 + ty * 4 + a;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int q = tx + 32 * c;
          if (i < K && q < P) yg[i * p.y_sk + q] = from_f32<T>(acc[a][c]);
        }
      }
    }
    __syncthreads();  // the next strip overwrites Cs and Ss
  }
}

// Launches on the calling thread's current device (the wrapper selects
// the tensors' device).  The dynamic shared-memory limit is raised to the
// opt-in maximum once per device and instantiation, recorded in the
// instantiation's own `raised` bit mask (devices 0..63; any others set it
// at every launch); the launch itself asks for what this shape needs.
template <typename T, int CQ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  auto kernel = ssd_chunk_kernel<T, CQ>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit == 0 || !(raised.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  const long long blocks = static_cast<long long>(p.b) * p.h * p.c;
  kernel<<<static_cast<unsigned>(blocks), kThreads,
           smem_bytes(p.K, p.P, p.N), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Params& p, cudaStream_t stream) {
  switch ((p.P + 31) / 32) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    default: return launch<T, 4>(p, stream);
  }
}

}  // namespace

extern "C" {

// dtype of x, B, C and y: 0 float32, 1 bfloat16; dA, states and decay are
// float32.  states is contiguous [b, h, c, N, P], decay [b, h, c].  Strides
// are in elements, in the order (batch, head, chunk, row); the last stride
// of x, B, C and y is 1.  Runs on the calling thread's current device,
// which must be the one the tensors lie on.  Returns the launch's
// cudaError_t (0 on success); shapes outside 1 <= K, P, N <= 128 return
// cudaErrorInvalidValue without launching.
int ssd_chunk_fwd(const void* x, const void* dA, const void* B,
                  const void* C, void* y, void* states, void* decay,
                  int dtype, int b, int h, int c, int K, int P, int N,
                  long long x_sb, long long x_sh, long long x_sc,
                  long long x_sk, long long a_sb, long long a_sh,
                  long long a_sc, long long a_sk, long long B_sb,
                  long long B_sh, long long B_sc, long long B_sk,
                  long long C_sb, long long C_sh, long long C_sc,
                  long long C_sk, long long y_sb, long long y_sh,
                  long long y_sc, long long y_sk, void* stream) {
  const long long blocks = static_cast<long long>(b) * h * c;
  if (b < 1 || h < 1 || c < 1 || K < 1 || K > kMaxDim || P < 1 ||
      P > kMaxDim || N < 1 || N > kMaxDim || blocks > 0x7fffffffLL ||
      smem_bytes(K, P, N) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x,    static_cast<const float*>(dA), B,    C,    y,
           static_cast<float*>(states), static_cast<float*>(decay),
           b,    h,    c,    K,    P,    N,
           x_sb, x_sh, x_sc, x_sk, a_sb, a_sh, a_sc, a_sk,
           B_sb, B_sh, B_sc, B_sk, C_sb, C_sh, C_sc, C_sk,
           y_sb, y_sh, y_sc, y_sk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch_dtype<__nv_bfloat16>(p, st);
  } else if (dtype == 0) {
    err = launch_dtype<float>(p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* ssd_chunk_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
