// Fused FedAWE echo + implicit-gossip aggregation for Hopper (sm_90a),
// float32 and bfloat16 client stacks.
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/echo_aggregate/kernel.py:
//
//   * `echo_aggregate_fused_pallas` (kernel.py:100; pallas_call :145),
//     body `_fused_kernel` (:33): GUARD, w = mask;
//   * the same with `upload=`, body `_fused_kernel_upload` (:82): GUARD
//     and UPLOAD, w = mask * upload, multiplied here in float32;
//   * `echo_aggregate_pallas` (kernel.py:48; pallas_call :65), body
//     `_kernel` (:23): neither.
//
// Per column n of the [m, N] stacks x (client starts) and y (post-local-SGD
// clients):
//
//   out[n] = sum_i w_i (x_in - c_i (x_in - y_in)) / max(sum_i w_i, 1),
//   c_i = eta_g * echo_i,
//
// and with GUARD out[n] = g[n] where sum_i w_i <= 0 (an empty or
// all-dropped round keeps the previous global).  Every product and sum is
// float32 and rounded where it is written (`__fmul_rn`, `__fsub_rn`,
// `__fadd_rn`: no contraction into FMAs), so `ref.echo_aggregate_split_ref`
// repeats the arithmetic operation for operation.
//
// What bounds it: HBM bytes.  It reads x and y once, 2 m N sizeof(x) bytes,
// at about 5 flops per (client, column) pair: 0.6 flop a byte in float32,
// far below the card's ridge.  The rows of the FL path's stacks start only
// 8 (float32, N = 27 370) or 4 (bfloat16) bytes apart from a 16-byte
// boundary, so a tensor map cannot describe them (TMA wants 16-byte
// strides) and a vector load of a row's columns is not aligned.  The design:
//
//   * grid (column tiles of BN = 1 KB of a row, S row slices); the S blocks
//     of one column tile form one thread-block cluster (S <= 8), and slice
//     k takes rows [k m / S, (k + 1) m / S).  The wrapper's
//     `ops.launch_geometry` picks S: the most slices, of at least 512 rows
//     each, whose grid is one wave of resident blocks (S = 1 at the FL
//     path's m = 100, 3 at m = 16 384 and N = 27 370);
//   * each row's window, the 16-byte aligned span covering the tile's
//     columns (at most 65 chunks of 16 bytes), comes by one bulk copy (the
//     TMA unit without a tensor map: 16-byte aligned addresses, a multiple
//     of 16 bytes) into a ring of 2 stages of 16 rows of x and y (33 KB a
//     stage), 65 KB a block and three blocks an SM.  One producer warp
//     issues them, a lane a window, each stage on its own `full` mbarrier
//     (arrive + expect_tx, completed by the bytes).  16-byte `cp.async`
//     copies, a thread a chunk, measured slower on the long shapes for
//     their address work, as did rings of 4 stages of 8 rows or of 3 of
//     16.  A chunk that is not wholly inside the tensor (the last
//     row's tail, or the first row's head when the tensor starts off a
//     16-byte boundary) is copied element by element, only its elements
//     inside: nothing outside the tensor is read;
//   * four consumer warps wait on a stage's `full` barrier, reduce it and
//     release it on its `empty` barrier for the producer.  Reading a row
//     back, each thread takes its columns t, t + 128, ... at the row's
//     shift (0-3 elements in float32, 0-7 in bfloat16): neighbouring lanes
//     read neighbouring shared-memory words, with no bank conflict.  A lane
//     per row loads the row's weights and shifts a stage ahead and shuffles
//     them to the warp.  Each thread keeps its columns' sums and the
//     slice's sum of weights in registers, adding the rows in order;
//   * the combine is deterministic, without atomics: each rank r > 0
//     writes its partial column sums and weight sum into rank 0's shared
//     memory (distributed shared memory) and arrives on rank 0's `combine`
//     mbarrier; rank 0 adds them to its own in rank order 1, ..., S - 1,
//     divides and writes the tile.  Two launches on the same inputs give
//     the same bits;
//   * a seed axis: the grid's z is the seed, as vmapping the Pallas call
//     adds a grid axis on the TPU.  Seed z's [m, N] stacks start z m N
//     elements in, its g and out z N, its mask, echo and upload z m; each
//     seed is treated as a tensor of its own (its own bounds for the
//     element-by-element edges), so its arithmetic, rank order included,
//     is that of a launch on that seed alone at the same slice count.  The
//     cluster stays (1, S, 1) within one seed.

// Built by ../kernel.py (repro_torch.kernels.nvcc) with
// nvcc -gencode arch=compute_90a,code=sm_90a into a shared library with a
// plain C interface, called through ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;  // one column set each
constexpr int kThreads = kConsumers + 32;        // and one producer warp
constexpr int kRows = 16;                        // rows of a ring stage
constexpr int kStages = 2;
constexpr int kTileRowBytes = 1024;              // BN * sizeof(x)
constexpr int kChunks = kTileRowBytes / 16 + 1;  // a row's window
constexpr int kWindowBytes = kChunks * 16;
constexpr int kMaxSlices = 8;                    // portable cluster size
constexpr int kStageBytes = 2 * kRows * kWindowBytes;
constexpr int kBarOffset = kStages * kStageBytes;  // full, empty, combine
constexpr int kPartOffset = kBarOffset + 16 * kStages + 16;
constexpr int kSmemBytes = kPartOffset;  // and the partials, with S > 1

// dynamic shared memory of a block: the ring and its barriers, and on the
// rank-0 block of a cluster of S the other ranks' partials (BN column sums
// and the weight sum, padded to 16 bytes, per rank)
__host__ __device__ constexpr int part_stride(int bn) { return bn + 4; }
__host__ __device__ constexpr int smem_bytes(int bn, int slices) {
  return kSmemBytes + (slices - 1) * part_stride(bn) * 4;
}

static_assert(kStageBytes % 16 == 0, "stages must start 16-byte aligned");
static_assert(2 * kRows <= 32, "one producer lane a window");
static_assert(kRows <= 32, "one consumer lane a row's weights");

// element size in bytes for dtype code DT (0 float32, 1 bfloat16)
template <int DT>
__host__ __device__ constexpr int elem_bytes() {
  return DT == 0 ? 4 : 2;
}

template <int DT>
__device__ __forceinline__ float load_elem(const unsigned char* row, int i);

template <>
__device__ __forceinline__ float load_elem<0>(const unsigned char* row,
                                              int i) {
  return reinterpret_cast<const float*>(row)[i];
}

template <>
__device__ __forceinline__ float load_elem<1>(const unsigned char* row,
                                              int i) {
  const unsigned short b = reinterpret_cast<const unsigned short*>(row)[i];
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t rank0_addr(uint32_t addr) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
               : "=r"(out)
               : "r"(addr));
  return out;
}

// arrive on an mbarrier of another block of the cluster, releasing this
// thread's earlier writes to the cluster
__device__ __forceinline__ void bar_arrive_remote(uint32_t cluster_bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_bar)
      : "memory");
}

// wait for a phase of a local mbarrier that other blocks of the cluster
// arrive on, acquiring their writes
__device__ __forceinline__ void bar_wait_cluster(uint32_t bar,
                                                 uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one bulk copy (the TMA unit without a tensor map): 16-byte aligned
// addresses, a multiple of 16 bytes, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, uintptr_t src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// copy the elements of [p0, p1) that lie in [lo, hi) to the window at
// `dst`, which holds global byte `base` at offset 0
template <int ES>
__device__ __forceinline__ void copy_elems(unsigned char* dst, uintptr_t base,
                                           uintptr_t p0, uintptr_t p1,
                                           uintptr_t lo, uintptr_t hi) {
  for (uintptr_t p = p0; p < p1; p += ES) {
    if (p < lo || p >= hi) continue;
    if (ES == 4)
      *reinterpret_cast<float*>(dst + (p - base)) =
          *reinterpret_cast<const float*>(p);
    else
      *reinterpret_cast<unsigned short*>(dst + (p - base)) =
          *reinterpret_cast<const unsigned short*>(p);
  }
}

struct Args {
  const unsigned char* x;
  const unsigned char* y;
  const float* g;
  const float* mask;
  const float* upload;
  const float* echo;
  float* out;
  long long m, n;
  float eta;
};

template <int DT, bool GUARD, bool UPLOAD>
__global__ void __launch_bounds__(kThreads)
    echo_aggregate_kernel(const Args a) {
  constexpr int ES = elem_bytes<DT>();
  constexpr int BN = kTileRowBytes / ES;
  constexpr int CPT = BN / kConsumers;  // columns a consumer thread owns
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31;
  // seed z's operands: its [m, N] stacks, [N] global and output, [m]
  // vectors
  const long long z = blockIdx.z;
  const unsigned char* const xs = a.x + z * a.m * a.n * ES;
  const unsigned char* const ys = a.y + z * a.m * a.n * ES;
  const float* const gs = GUARD ? a.g + z * a.n : nullptr;
  float* const outs = a.out + z * a.n;
  const float* const masks = a.mask + z * a.m;
  const float* const echos = a.echo + z * a.m;
  const float* const uploads = UPLOAD ? a.upload + z * a.m : nullptr;
  const long long c0 = static_cast<long long>(blockIdx.x) * BN;
  const int ncols = static_cast<int>(min(static_cast<long long>(BN),
                                         a.n - c0));
  // the cluster is (1, S, 1): a block's rank in it is its slice
  const int S = gridDim.y, rank = blockIdx.y;
  const long long r_begin = a.m * rank / S, r_end = a.m * (rank + 1) / S;
  const int nsteps = static_cast<int>((r_end - r_begin + kRows - 1) / kRows);
  const uintptr_t xlo = reinterpret_cast<uintptr_t>(xs);
  const uintptr_t ylo = reinterpret_cast<uintptr_t>(ys);
  const uintptr_t nbytes = static_cast<uintptr_t>(a.m * a.n) * ES;
  const uint32_t full0 = smem_addr(smem + kBarOffset);
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t combine = full0 + 16 * kStages;
  float* const parts = reinterpret_cast<float*>(smem + kPartOffset);

  // start of row r's tile columns in the stack at `lo`
  auto row_start = [&](uintptr_t lo, long long r) {
    return lo + static_cast<uintptr_t>(r * a.n + c0) * ES;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full0 + 8 * s, 2 * kRows);         // the producer's lanes
      bar_init(empty0 + 8 * s, kConsumerWarps);   // the consumer warps
    }
    if (S > 1 && rank == 0) bar_init(combine, (S - 1) * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this block has started, its barriers initialised; waited for before
  // the combine, long after every block of the cluster has arrived
  if (S > 1) asm volatile("barrier.cluster.arrive;\n" ::: "memory");

  float acc[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) acc[q] = 0.f;
  float ws = 0.f;

  if (tid >= kConsumers) {
    // producer warp: lane l < 2 kRows copies the window of row l / 2 of
    // the step, of x (l even) or y (l odd), into the step's stage
    if (lane < 2 * kRows) {
      const int rr = lane >> 1, ts = lane & 1;
      const uintptr_t lo = ts ? ylo : xlo, hi = lo + nbytes;
      const uintptr_t lo16 = (lo + 15) & ~static_cast<uintptr_t>(15);
      const uintptr_t hi16 = hi & ~static_cast<uintptr_t>(15);
      for (int step = 0; step < nsteps; ++step) {
        const int slot = step % kStages;
        if (step >= kStages)
          bar_wait(empty0 + 8 * slot, ((step / kStages) - 1) & 1);
        const long long r = r_begin + static_cast<long long>(step) * kRows
                            + rr;
        uint32_t bytes = 0;
        uintptr_t from = 0;
        unsigned char* dst = smem + slot * kStageBytes
                             + (ts * kRows + rr) * kWindowBytes;
        if (r < r_end) {
          const uintptr_t start = row_start(lo, r);
          const uintptr_t base = start & ~static_cast<uintptr_t>(15);
          const uintptr_t end =
              (start + static_cast<uintptr_t>(ncols) * ES + 15)
              & ~static_cast<uintptr_t>(15);
          // the window's 16-byte chunks inside the tensor go by one bulk
          // copy; a chunk that sticks out (the first row's head, the last
          // row's tail) element by element, only its elements inside
          from = base > lo16 ? base : lo16;
          const uintptr_t to = end < hi16 ? end : hi16;
          if (to > from) bytes = static_cast<uint32_t>(to - from);
          else from = end;  // no whole chunk inside: all element by element
          copy_elems<ES>(dst, base, base, from, lo, hi);
          copy_elems<ES>(dst, base, from + bytes, end, lo, hi);
          dst += from - base;
        }
        bar_arrive_tx(full0 + 8 * slot, bytes);
        if (bytes) bulk_copy(smem_addr(dst), from, bytes, full0 + 8 * slot);
      }
    }
  } else {
    // consumer warps: lane l < kRows holds row l's weights and shifts for
    // the step, loaded a step ahead
    float nm = 0.f, ne = 0.f, nu = 0.f;
    auto fetch = [&](int step) {
      const long long r = r_begin + static_cast<long long>(step) * kRows
                          + lane;
      if (lane < kRows && r < r_end) {
        nm = __ldg(masks + r);
        ne = __ldg(echos + r);
        if (UPLOAD) nu = __ldg(uploads + r);
      }
    };
    fetch(0);
    for (int step = 0; step < nsteps; ++step) {
      const int slot = step % kStages;
      const long long r0 = r_begin + static_cast<long long>(step) * kRows;
      const float lw = UPLOAD ? __fmul_rn(nm, nu) : nm;
      const float lc = __fmul_rn(a.eta, ne);
      const int lsx = static_cast<int>((row_start(xlo, r0 + lane) & 15) / ES);
      const int lsy = static_cast<int>((row_start(ylo, r0 + lane) & 15) / ES);
      if (step + 1 < nsteps) fetch(step + 1);
      bar_wait(full0 + 8 * slot, (step / kStages) & 1);
      const unsigned char* st = smem + slot * kStageBytes;
      const int nr = static_cast<int>(min(static_cast<long long>(kRows),
                                          r_end - r0));
      for (int rr = 0; rr < nr; ++rr) {
        const float w = __shfl_sync(0xffffffffu, lw, rr);
        const float c = __shfl_sync(0xffffffffu, lc, rr);
        const int sx = __shfl_sync(0xffffffffu, lsx, rr);
        const int sy = __shfl_sync(0xffffffffu, lsy, rr);
        const unsigned char* rx = st + rr * kWindowBytes;
        const unsigned char* ry = st + (kRows + rr) * kWindowBytes;
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          // columns past ncols read stale window bytes, never written
          const int j = tid + q * kConsumers;
          const float xv = load_elem<DT>(rx, sx + j);
          const float yv = load_elem<DT>(ry, sy + j);
          const float xd = __fsub_rn(xv, __fmul_rn(c, __fsub_rn(xv, yv)));
          acc[q] = __fadd_rn(acc[q], __fmul_rn(w, xd));
        }
        ws = __fadd_rn(ws, w);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty0 + 8 * slot);
    }
  }

  if (S > 1) {
    // the combine: each rank r > 0 writes its partials into rank 0's
    // shared memory and arrives on rank 0's combine barrier; rank 0 adds
    // them to its own in rank order 1, ..., S - 1
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
    if (tid < kConsumers) {
      if (rank != 0) {
        float* rp = cg::this_cluster().map_shared_rank(
            parts + (rank - 1) * part_stride(BN), 0);
#pragma unroll
        for (int q = 0; q < CPT; ++q) rp[tid + q * kConsumers] = acc[q];
        if (tid == 0) rp[BN] = ws;
        bar_arrive_remote(rank0_addr(combine));
      } else {
        bar_wait_cluster(combine, 0);
        for (int s = 1; s < S; ++s) {
          const float* rp = parts + (s - 1) * part_stride(BN);
#pragma unroll
          for (int q = 0; q < CPT; ++q)
            acc[q] = __fadd_rn(acc[q], rp[tid + q * kConsumers]);
          ws = __fadd_rn(ws, rp[BN]);
        }
      }
    }
    if (rank != 0) return;
  }
  if (tid >= kConsumers) return;

  const float den = fmaxf(ws, 1.f);
  const bool keep = GUARD && !(ws > 0.f);
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int j = tid + q * kConsumers;
    if (j < ncols)
      outs[c0 + j] = keep ? gs[c0 + j] : __fdiv_rn(acc[q], den);
  }
}

// Raises the instantiation's dynamic shared-memory limit to what 8 slices
// take and asks for the largest shared-memory carveout (three blocks of
// 65-70 KB an SM up to 3 slices), once per device (devices 0..63; any
// others at every launch), on the calling thread's current device.
template <int DT, bool GUARD, bool UPLOAD>
cudaError_t prepare() {
  constexpr int BN = kTileRowBytes / elem_bytes<DT>();
  static std::atomic<uint64_t> raised{0};
  auto kernel = echo_aggregate_kernel<DT, GUARD, UPLOAD>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit == 0 || !(raised.load() & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(BN, kMaxSlices));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  return cudaSuccess;
}

template <int DT>
cudaLaunchConfig_t config(long long n, int slices, int seeds,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  constexpr int BN = kTileRowBytes / elem_bytes<DT>();
  const long long tiles = (n + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles),
                     static_cast<unsigned>(slices),
                     static_cast<unsigned>(seeds));
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(BN, slices);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(slices);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches on the calling thread's current device (the wrapper selects
// the tensors' device).
template <int DT, bool GUARD, bool UPLOAD>
cudaError_t launch(const Args& a, int slices, int seeds,
                   cudaStream_t stream) {
  cudaError_t err = prepare<DT, GUARD, UPLOAD>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config<DT>(a.n, slices, seeds, stream, attr);
  err = cudaLaunchKernelEx(&cfg, echo_aggregate_kernel<DT, GUARD, UPLOAD>,
                           a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_dtype(const Args& a, int guard, int slices, int seeds,
                         cudaStream_t stream) {
  if (a.upload != nullptr)
    return launch<DT, true, true>(a, slices, seeds, stream);
  if (guard) return launch<DT, true, false>(a, slices, seeds, stream);
  return launch<DT, false, false>(a, slices, seeds, stream);
}

// Blocks of the guarded float32 instantiation at `slices` resident on one
// SM, and clusters of `slices` blocks resident on the card at once.
cudaError_t occupancy(int slices, int* blocks_per_sm, int* clusters) {
  cudaError_t err = prepare<0, true, false>();
  if (err != cudaSuccess) return err;
  auto kernel = echo_aggregate_kernel<0, true, false>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads,
      smem_bytes(kTileRowBytes / 4, slices));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config<0>(1LL << 20, slices, 1, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace

extern "C" {

// x, y: contiguous [seeds, m, n] stacks of dtype 0 (float32) or 1
// (bfloat16), each at least element-aligned; g ([seeds, n], read with
// guard), mask, upload ([seeds, m]; may be null; needs guard) and echo
// ([seeds, m]) float32; out [seeds, n] float32.  block_cols must be the
// kernel's tile for the dtype (1024 bytes of a row), slices in 1..8 and
// seeds in 1..65535; the grid is (ceil(n / block_cols), slices, seeds) in
// clusters of (1, slices, 1).  Runs on the calling thread's current device, which must
// be the one the tensors lie on.  Returns the launch's cudaError_t (0 on
// success); arguments outside these ranges return cudaErrorInvalidValue
// without launching.
int echo_aggregate_fwd(const void* x, const void* y, const void* g,
                       const void* mask, const void* upload,
                       const void* echo, void* out, int dtype, int guard,
                       long long m, long long n, float eta_g,
                       int block_cols, int slices, int seeds, void* stream) {
  if ((dtype != 0 && dtype != 1) || m < 1 || n < 1 || slices < 1 ||
      slices > kMaxSlices || seeds < 1 || seeds > 65535 ||
      (upload != nullptr && !guard) ||
      block_cols != kTileRowBytes / (dtype == 0 ? 4 : 2) ||
      (n + block_cols - 1) / block_cols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const unsigned char*>(x),
               static_cast<const unsigned char*>(y),
               static_cast<const float*>(g),
               static_cast<const float*>(mask),
               static_cast<const float*>(upload),
               static_cast<const float*>(echo),
               static_cast<float*>(out),
               m,
               n,
               eta_g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_dtype<0>(a, guard, slices, seeds, st)
                 : launch_dtype<1>(a, guard, slices, seeds, st);
  return static_cast<int>(err);
}

const char* echo_aggregate_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dynamic shared memory a block takes for dtype 0 (float32) or 1
// (bfloat16) at `slices`
int echo_aggregate_smem(int dtype, int slices) {
  return smem_bytes(kTileRowBytes / (dtype == 0 ? 4 : 2), slices);
}

// blocks resident on one SM, and clusters of `slices` (1..8) blocks
// resident on the current device; returns a cudaError_t
int echo_aggregate_occupancy(int slices, int* blocks_per_sm,
                             int* clusters) {
  if (slices < 1 || slices > kMaxSlices)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(occupancy(slices, blocks_per_sm, clusters));
}

}  // extern "C"
