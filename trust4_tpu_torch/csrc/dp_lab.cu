// CUDA kernels of the kernel lab (replace the Pallas kernels of
// tools/dp_kernel_lab.py: _dp_kernel_inter, l.51, pallas_call l.251 in
// scores_inter l.197; and _dp_kernel_abl, l.279, pallas_call l.467 in
// scores_abl l.414).  Experiments on the scores kernel (dp_scores.cu) at
// the lab's band width W = 32, on its own design: a job's band over a
// group of L lanes, the jobs in the wrapper's order, a block's code rows
// staged in shared memory, each warp on the narrowest tile its jobs share.
//
// dp_abl_kernel<W, L, FLAGS>: the scores kernel's block with the pieces
// of the sweep that FLAGS names removed at compile time
// (dp_scores_group.cuh: the scores kernel's own sweep, FLAGS = 0 there).
// Built for no flag and for each flag alone at every L of the scores
// kernel's W = 32 instances, so the time a piece costs is read at each L.
//
// dp_inter_kernel<W, L, G>: each group of L lanes carries G jobs
// (dp_lab.cuh), every step of a row issued for the G jobs before the next
// step.  A 128-thread block takes 128 / L x G jobs.
//
// What bounds both on an H100: integer issue, as for dp_scores.cu (the
// same function and work at the lab's shape, 65,536 x 152 at W = 32).
//
// Plain C interface for ctypes (ops/build.py,
// trust4_tpu_torch/tools/dp_kernel_lab.py): every pointer and the stream
// are void*, and each function returns the cudaError_t of the launch (0 on
// success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_lab.cuh"

namespace {

constexpr int kBlock = 128;

template <int W, int L, int FLAGS>
__global__ void __launch_bounds__(kBlock)
    dp_abl_kernel(const int8_t* __restrict__ t_codes,
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
  t4dp::dp_scores_narrow<W, L, FLAGS>(x, need, row, t_max, row + t_max,
                                      p_max, t_len, p_len, score, own);
  if (b >= 0 && own[0]) scores[b] = score[0];
}

template <int W, int L, int G>
__global__ void __launch_bounds__(kBlock)
    dp_inter_kernel(const int8_t* __restrict__ t_codes,
                    const int32_t* __restrict__ t_lens,
                    const int8_t* __restrict__ p_codes,
                    const int32_t* __restrict__ p_lens,
                    const int64_t* __restrict__ order, int n, int t_max,
                    int p_max, int32_t* __restrict__ scores) {
  extern __shared__ int8_t rows[];
  constexpr int kJobs = kBlock / L * G;
  const int g0 = blockIdx.x * kJobs;
  t4dp::stage_rows<kBlock>(t_codes, p_codes, order, g0, min(kJobs, n - g0),
                           t_max, p_max, rows);
  __syncthreads();

  // Group q takes the block's jobs q*G .. q*G + G-1 of the launch order.
  const int q = threadIdx.x / L;
  const t4dp::CudaLanes<L> x{static_cast<int>(threadIdx.x % L)};
  const int8_t* t[G];
  const int8_t* p[G];
  int b[G], t_len[G], p_len[G], score[G][1];
  bool own[G][1];
  int need = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int slot = q * G + j;
    b[j] = g0 + slot < n ? static_cast<int>(order[g0 + slot]) : -1;
    t[j] = rows + slot * (t_max + p_max);
    p[j] = t[j] + t_max;
    t_len[j] = b[j] >= 0 ? t_lens[b[j]] : 0;
    p_len[j] = b[j] >= 0 ? p_lens[b[j]] : 0;
    if (b[j] >= 0) need = max(need, t4dp::band_need(t_len[j], p_len[j]));
  }
  t4dp::dp_inter_narrow<W, L, G>(x, need, t, t_max, p, p_max, t_len, p_len,
                                 score, own);
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (b[j] >= 0 && own[j][0]) scores[b[j]] = score[j][0];
}

using JobsKernel = void (*)(const int8_t*, const int32_t*, const int8_t*,
                            const int32_t*, const int64_t*, int, int, int,
                            int32_t*);

// One launch of a lab kernel that takes `jobs` jobs a block, its code
// rows staged in dynamic shared memory.
cudaError_t launch(JobsKernel kernel, int jobs, const void* t, const void* tl,
                   const void* p, const void* pl, const void* order, int n,
                   int t_max, int p_max, void* scores, cudaStream_t stream) {
  const size_t smem = (size_t)jobs * (t_max + p_max);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<(n + jobs - 1) / jobs, kBlock, smem, stream>>>(
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tl),
      static_cast<const int8_t*>(p), static_cast<const int32_t*>(pl),
      static_cast<const int64_t*>(order), n, t_max, p_max,
      static_cast<int32_t*>(scores));
  return cudaGetLastError();
}

}  // namespace

// t: (n, t_max) int8, tl: (n,) int32, p: (n, p_max) int8, pl: (n,) int32,
// order: (n,) int64, a permutation of the pairs (the launch order),
// scores: (n,) int32.  w must be 32 and (lanes, flags) one of
// T4DP_ABL_INSTANCES (flags: 0 or one t4dp::kAbl* bit).
extern "C" int t4_dp_abl(const void* t, const void* tl, const void* p,
                         const void* pl, const void* order, int n, int t_max,
                         int p_max, int w, int lanes, int flags, void* scores,
                         void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != 32) return static_cast<int>(cudaErrorInvalidValue);
#define CASE(L_, F_)                                                     \
  if (lanes == L_ && flags == F_)                                        \
    return launch(dp_abl_kernel<32, L_, F_>, kBlock / L_, t, tl, p, pl,  \
                  order, n, t_max, p_max, scores, s);
  T4DP_ABL_INSTANCES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// As t4_dp_abl, with (lanes, groups) one of T4DP_INTER_INSTANCES.
extern "C" int t4_dp_inter(const void* t, const void* tl, const void* p,
                           const void* pl, const void* order, int n,
                           int t_max, int p_max, int w, int lanes, int groups,
                           void* scores, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != 32) return static_cast<int>(cudaErrorInvalidValue);
#define CASE(L_, G_)                                                        \
  if (lanes == L_ && groups == G_)                                          \
    return launch(dp_inter_kernel<32, L_, G_>, kBlock / L_ * G_, t, tl, p,  \
                  pl, order, n, t_max, p_max, scores, s);
  T4DP_INTER_INSTANCES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instances the library is built for, as 2 x count ints in out (at
// most cap pairs): (lanes, flags) for kind 0 (t4_dp_abl), (lanes,
// groups) for kind 1 (t4_dp_inter).  Returns the count.
extern "C" int t4_dp_lab_instances(int kind, int* out, int cap) {
  int k = 0;
#define PAIR(A_, B_)    \
  if (k < cap) {        \
    out[2 * k] = A_;    \
    out[2 * k + 1] = B_; \
  }                     \
  ++k;
  if (kind == 0) {
    T4DP_ABL_INSTANCES(PAIR)
  } else {
    T4DP_INTER_INSTANCES(PAIR)
  }
#undef PAIR
  return k;
}
