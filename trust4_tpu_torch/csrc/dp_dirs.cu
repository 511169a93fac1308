// CUDA kernel for the traceback-bits DP (replaces the Pallas kernel
// _dp_dirs_kernel, trust4_tpu/ops/dp_pallas.py:385-489, pallas_call l.540
// in banded_affine_dirs_pallas l.493).
//
// What bounds it on an H100: the bytes of its output.  A job writes
// p_max * W bytes of bits (N * P * W in all: 113 MB for the top gap-oracle
// tier, 16,384 x 144 x 48) against about 2 * cap bytes of codes read,
// while its integer work is about 24 operations per band cell.  One
// thread per job left a tier chunk a few warps per scheduler, and wrote
// each row as W/8 eight-byte stores p_max * W bytes apart across a warp,
// none of them coalesced.
//
// Design: each job's band is spread across a group of L lanes, C = W/L
// cells per lane in registers, the row's F running max combined across
// the group in log2(L) shuffle steps (dp_dirs_group.cuh; L = 1 is the
// one-thread sweep).  32/L jobs share a warp; a 128-thread block takes
// 128/L consecutive jobs (no reordering: every job runs all p_max rows,
// so a warp's groups end together) and stages their code rows in shared
// memory with one coalesced load.  The bits do not go straight out: each
// lane writes its C bytes of a row into its job's slot of a shared
// staging buffer of R rows (kStageRows: R * W a multiple of 16, the
// block's buffer at most 16 KB), and every R rows the warp copies its
// jobs' R * W contiguous bytes each to device memory with 16-byte stores,
// neighbouring lanes on neighbouring addresses (at L = 1 that is the
// transpose: 32 jobs' rows, about six lanes to a job's 96 bytes at W =
// 48).  The last batch holds the p_max % R tail rows; where a job's
// block of bits is only 8-byte aligned (W = 24 with an odd p_max) or the
// tail is not a multiple of 16 bytes, the copy uses 8-byte stores.  The
// kernel is built for the (W, L) pairs of T4DP_DIRS_INSTANCES; the
// wrapper picks L.
//
// Plain C interface for ctypes (ops/build.py, ops/dp_dirs.py): every
// pointer and the stream are void*, and the function returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_dirs_group.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kStageBytes = 16 * 1024;

// Rows of bits a job stages before the warp writes them out: the most
// that keeps the block's buffer within kStageBytes with R * W a multiple
// of 16 bytes.
template <int W, int L>
constexpr int kStageRows() {
  int r = kStageBytes / ((kBlock / L) * W);
  while (r > 1 && (r * W) % 16 != 0) --r;
  return r;
}

// Copies the warp's jobs' staged rows (rows bytes each, at stride bytes
// in shared memory) to their blocks of bits in device memory (at
// job_bytes apart), `Unit` bytes a lane and store.
template <class Unit>
__device__ inline void copy_rows(const int8_t* stage, int stride,
                                 int8_t* dst, size_t job_bytes, int jobs,
                                 int bytes, int lane) {
  const int per = bytes / static_cast<int>(sizeof(Unit));
  for (int u = lane; u < jobs * per; u += 32) {
    const int q = u / per, o = u - q * per;
    reinterpret_cast<Unit*>(dst + q * job_bytes)[o] =
        reinterpret_cast<const Unit*>(stage + q * stride)[o];
  }
}

// The kernel's Out (dp_dirs_group.cuh): a row's C bytes go to the lane's
// cells of its job's staged row; after each R-th row and the last, the
// warp writes its jobs' staged rows out.  Host-device qualified, as
// CudaLanes is, so the host-device sweep may call it; only the kernel
// instantiates it.
template <int W, int L>
struct StagedRows {
  static constexpr int R = kStageRows<W, L>();
  int8_t* job;          // this lane's job's R * W staging bytes
  const int8_t* warp;   // the warp's first job's staging bytes
  int8_t* dirs;         // the warp's first job's (p_max, W) bits
  int jobs;             // jobs of the warp with an index below n
  int p_max;
  bool vec16;           // every job's block of bits 16-byte aligned
  int r = 0;            // staged rows

  template <int C, int K>
  __host__ __device__ void row(int, int lane, int, const uint32_t (&w)[K]) {
    int8_t* dst = job + r * W + lane * C;
    if constexpr (C % 8 == 0) {
#pragma unroll
      for (int q = 0; q < C / 8; ++q)
        reinterpret_cast<uint2*>(dst)[q] = make_uint2(w[2 * q], w[2 * q + 1]);
    } else if constexpr (C % 4 == 0) {
#pragma unroll
      for (int q = 0; q < C / 4; ++q) reinterpret_cast<uint32_t*>(dst)[q] = w[q];
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) dst[c] = int8_t(w[c >> 2] >> (8 * (c & 3)));
    }
  }

  __host__ __device__ void end_row(int i) {
    if (++r < R && i < p_max) return;
#ifdef __CUDA_ARCH__
    __syncwarp();
    const int bytes = r * W;
    const int lane = threadIdx.x % 32;
    int8_t* dst = dirs + (size_t)(i - r) * W;
    const size_t job_bytes = (size_t)p_max * W;
    if (vec16 && bytes % 16 == 0)
      copy_rows<uint4>(warp, R * W, dst, job_bytes, jobs, bytes, lane);
    else
      copy_rows<uint2>(warp, R * W, dst, job_bytes, jobs, bytes, lane);
    __syncwarp();
#endif
    r = 0;
  }
};

template <int W, int L>
__global__ void __launch_bounds__(kBlock)
    dp_dirs_kernel(const int8_t* __restrict__ t_codes,
                   const int32_t* __restrict__ t_lens,
                   const int8_t* __restrict__ p_codes,
                   const int32_t* __restrict__ p_lens, int n, int t_max,
                   int p_max, int vec16, int32_t* __restrict__ scores,
                   int8_t* __restrict__ dirs) {
  constexpr int kJobs = kBlock / L;
  constexpr int kStride = StagedRows<W, L>::R * W;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* stage = smem;                  // kJobs x R rows of W bits
  int8_t* rows = smem + kJobs * kStride;  // kJobs x (t_max + p_max) codes
  const int g0 = blockIdx.x * kJobs;
  const int jobs = min(kJobs, n - g0);
  const int stride = t_max + p_max;
  // The block's jobs are consecutive, so each code array is one run.
  for (int idx = threadIdx.x; idx < jobs * t_max; idx += kBlock) {
    const int q = idx / t_max;
    rows[q * stride + idx - q * t_max] = t_codes[(size_t)g0 * t_max + idx];
  }
  for (int idx = threadIdx.x; idx < jobs * p_max; idx += kBlock) {
    const int q = idx / p_max;
    rows[q * stride + t_max + idx - q * p_max] =
        p_codes[(size_t)g0 * p_max + idx];
  }
  __syncthreads();

  // A warp with no job leaves; every lane of the others runs to the end
  // (the group's exchanges and the warp's copies need the whole warp).  A
  // slot past n sweeps with no job and writes nothing.
  constexpr int kWarpJobs = 32 / L;
  const int wq = threadIdx.x / 32 * kWarpJobs;
  if (wq >= jobs) return;
  const int q = threadIdx.x / L;
  const bool has_job = q < jobs;
  const int b = g0 + q;
  const t4dp::CudaLanes<L> x{static_cast<int>(threadIdx.x % L)};
  StagedRows<W, L> out{stage + q * kStride, stage + wq * kStride,
                       dirs + (size_t)(g0 + wq) * p_max * W,
                       min(kWarpJobs, jobs - wq), p_max, vec16 != 0};
  const int8_t* row = rows + q * stride;
  int score[1];
  bool own[1];
  t4dp::dp_dirs_group<W, L>(x, row, t_max, row + t_max, p_max,
                            has_job ? t_lens[b] : 0,
                            has_job ? p_lens[b] : 0, out, score, own);
  if (has_job && own[0]) scores[b] = score[0];
}

template <int W, int L>
cudaError_t launch(const void* t, const void* tl, const void* p,
                   const void* pl, int n, int t_max, int p_max, void* scores,
                   void* dirs, cudaStream_t stream) {
  constexpr int kJobs = kBlock / L;
  const size_t smem = (size_t)kJobs * (StagedRows<W, L>::R * W + t_max +
                                       p_max);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dp_dirs_kernel<W, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int vec16 = reinterpret_cast<uintptr_t>(dirs) % 16 == 0 &&
                    ((size_t)p_max * W) % 16 == 0;
  const int grid = (n + kJobs - 1) / kJobs;
  dp_dirs_kernel<W, L><<<grid, kBlock, smem, stream>>>(
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tl),
      static_cast<const int8_t*>(p), static_cast<const int32_t*>(pl), n,
      t_max, p_max, vec16, static_cast<int32_t*>(scores),
      static_cast<int8_t*>(dirs));
  return cudaGetLastError();
}

}  // namespace

// t: (n, t_max) int8, tl: (n,) int32, p: (n, p_max) int8, pl: (n,) int32,
// scores: (n,) int32, dirs: (n, p_max, w) int8, 8-byte aligned.  (w,
// lanes) must be one of T4DP_DIRS_INSTANCES.
extern "C" int t4_dp_dirs(const void* t, const void* tl, const void* p,
                          const void* pl, int n, int t_max, int p_max, int w,
                          int lanes, void* scores, void* dirs, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(dirs) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(W_, L_)        \
  if (w == W_ && lanes == L_) \
    return launch<W_, L_>(t, tl, p, pl, n, t_max, p_max, scores, dirs, s);
  T4DP_DIRS_INSTANCES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (w, lanes) pairs the library is built for, as 2 x count ints in out
// (at most cap pairs); returns the count.
extern "C" int t4_dp_dirs_instances(int* out, int cap) {
  int k = 0;
#define PAIR(W_, L_)     \
  if (k < cap) {         \
    out[2 * k] = W_;     \
    out[2 * k + 1] = L_; \
  }                      \
  ++k;
  T4DP_DIRS_INSTANCES(PAIR)
#undef PAIR
  return k;
}
