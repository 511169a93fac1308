// CUDA kernel for the batched banded scores DP (replaces the Pallas kernel
// _dp_kernel, trust4_tpu/ops/dp_pallas.py:55, pallas_call l.341, and its
// XLA twin banded_affine_scores, trust4_tpu/ops/dp_batch.py:63).
//
// What bounds it on an H100: integer issue.  A job is about p_len x band
// cells of ~13 int32 operations each, while its input is t_max + p_max
// bytes of codes and 8 bytes of lengths, so the bench shape (65,536 jobs
// x 148 rows x ~13 band cells) is ~1.6G operations on ~20 MB.  Its real
// launches are small (256 pairs in entry, about 2,300 per realign pass):
// with one thread per job they fill a few SMs with one warp per
// scheduler.
//
// Design: each job's band is spread across a group of L lanes, C = W/L
// cells per lane in registers (m, e and the text window); the row's F
// running max is combined across the group in log2(L) shuffle steps
// (dp_scores_group.cuh; L = 1 is the one-thread sweep).  32/L jobs share
// a warp; a 128-thread block stages its jobs' code rows in shared memory
// with one coalesced cooperative load; jobs arrive sorted by query length
// (``order``), so the groups of a warp end together, and each score goes
// to its job's own index.  A warp sweeps the narrowest tile of 16, 24 or
// 32 cells that holds all its jobs' bands (band_need in dp_lanes.cuh):
// the cells of a wider tile beyond the band never reach the result.  The Pallas kernel's text pre-shift
// (_build_ts_selshift) is an index offset here, and its 8-row blocks and
// host statics (scan_span, uniform_p, jz_blocks) have no counterpart.
// The kernel is built for the (W, L) pairs of T4DP_SCORES_INSTANCES; the
// wrapper picks L.
//
// Plain C interface for ctypes (ops/build.py, ops/dp_scores.py): every
// pointer and the stream are void*, and the function returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_scores_group.cuh"

namespace {

constexpr int kBlock = 128;

template <int W, int L>
__global__ void __launch_bounds__(kBlock)
    dp_scores_kernel(const int8_t* __restrict__ t_codes,
                     const int32_t* __restrict__ t_lens,
                     const int8_t* __restrict__ p_codes,
                     const int32_t* __restrict__ p_lens,
                     const int64_t* __restrict__ order, int n, int t_max,
                     int p_max, int32_t* __restrict__ scores) {
  extern __shared__ int8_t rows[];
  constexpr int kJobs = kBlock / L;
  const int g0 = blockIdx.x * kJobs;
  t4dp::stage_rows<kBlock>(t_codes, p_codes, order, g0, min(kJobs, n - g0),
                           t_max, p_max, rows);
  __syncthreads();

  // Every lane runs to the end: the group's exchanges need the whole
  // warp.  A slot past n sweeps with no job and writes nothing.
  const int q = threadIdx.x / L;
  const int g = g0 + q;
  const int b = g < n ? static_cast<int>(order[g]) : -1;
  const int8_t* row = rows + q * (t_max + p_max);
  const t4dp::CudaLanes<L> x{static_cast<int>(threadIdx.x % L)};
  int score[1];
  bool own[1];
  const int t_len = b >= 0 ? t_lens[b] : 0;
  const int p_len = b >= 0 ? p_lens[b] : 0;
  const int need = b >= 0 ? t4dp::band_need(t_len, p_len) : 0;
  t4dp::dp_scores_narrow<W, L>(x, need, row, t_max, row + t_max, p_max, t_len,
                           p_len, score, own);
  if (b >= 0 && own[0]) scores[b] = score[0];
}

template <int W, int L>
cudaError_t launch(const void* t, const void* tl, const void* p,
                   const void* pl, const void* order, int n, int t_max,
                   int p_max, void* scores, cudaStream_t stream) {
  constexpr int kJobs = kBlock / L;
  const size_t smem = (size_t)kJobs * (t_max + p_max);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dp_scores_kernel<W, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int grid = (n + kJobs - 1) / kJobs;
  dp_scores_kernel<W, L><<<grid, kBlock, smem, stream>>>(
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tl),
      static_cast<const int8_t*>(p), static_cast<const int32_t*>(pl),
      static_cast<const int64_t*>(order), n, t_max, p_max,
      static_cast<int32_t*>(scores));
  return cudaGetLastError();
}

}  // namespace

// t: (n, t_max) int8, tl: (n,) int32, p: (n, p_max) int8, pl: (n,) int32,
// order: (n,) int64, a permutation of the pairs (the launch order),
// scores: (n,) int32.  (w, lanes) must be one of T4DP_SCORES_INSTANCES.
extern "C" int t4_dp_scores(const void* t, const void* tl, const void* p,
                            const void* pl, const void* order, int n,
                            int t_max, int p_max, int w, int lanes,
                            void* scores, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(W_, L_)             \
  if (w == W_ && lanes == L_)    \
    return launch<W_, L_>(t, tl, p, pl, order, n, t_max, p_max, scores, s);
  T4DP_SCORES_INSTANCES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (w, lanes) pairs the library is built for, as 2 x count ints in out
// (at most cap pairs); returns the count.
extern "C" int t4_dp_scores_instances(int* out, int cap) {
  int k = 0;
#define PAIR(W_, L_)     \
  if (k < cap) {         \
    out[2 * k] = W_;     \
    out[2 * k + 1] = L_; \
  }                      \
  ++k;
  T4DP_SCORES_INSTANCES(PAIR)
#undef PAIR
  return k;
}
