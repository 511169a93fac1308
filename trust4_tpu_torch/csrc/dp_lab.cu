// CUDA kernels of the kernel lab (replace the Pallas kernels of
// tools/dp_kernel_lab.py: _dp_kernel_inter, l.51, pallas_call l.251 in
// scores_inter l.197; and _dp_kernel_abl, l.279, pallas_call l.467 in
// scores_abl l.414).  Experiments on the scores DP of dp_scores.cu, at the
// lab's band width W = 32.
//
// dp_inter_kernel<W, G>: one thread carries G jobs (thread t takes jobs
// t, t + T, ..., T = ceil(n / G) threads), interleaved cell by cell
// (dp_inter_jobs in dp_lab.cuh), so each thread issues G independent
// dependency chains.  Its state is G times the scores kernel's (m, e and
// the text window per job, 96 registers per job at W = 32), so G = 4 must
// spill: the compiler's -Xptxas -v line says how much.
//
// dp_abl_kernel<W, FLAGS>: one thread per job (dp_abl_job), with the
// pieces of the sweep that FLAGS names removed at compile time.  Built for
// no flag and for each flag alone.
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

template <int W, int G>
__global__ void dp_inter_kernel(const int8_t* __restrict__ t_codes,
                                const int32_t* __restrict__ t_lens,
                                const int8_t* __restrict__ p_codes,
                                const int32_t* __restrict__ p_lens, int n,
                                int t_max, int p_max,
                                int32_t* __restrict__ scores) {
  const int threads = (n + G - 1) / G;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= threads) return;
  int job[G], out[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int b = tid + g * threads;
    job[g] = b < n ? b : -1;
  }
  t4dp::dp_inter_jobs<W, G>(t_codes, t_lens, p_codes, p_lens, t_max, p_max,
                            job, out);
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (job[g] >= 0) scores[job[g]] = out[g];
}

template <int W, int FLAGS>
__global__ void dp_abl_kernel(const int8_t* __restrict__ t_codes,
                              const int32_t* __restrict__ t_lens,
                              const int8_t* __restrict__ p_codes,
                              const int32_t* __restrict__ p_lens, int n,
                              int t_max, int p_max,
                              int32_t* __restrict__ scores) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  scores[b] = t4dp::dp_abl_job<W, FLAGS>(
      t_codes + (size_t)b * t_max, t_max, p_codes + (size_t)b * p_max, p_max,
      t_lens[b], p_lens[b]);
}

constexpr int kBlock = 128;

template <int W, int G>
cudaError_t launch_inter(const void* t, const void* tl, const void* p,
                         const void* pl, int n, int t_max, int p_max,
                         void* scores, cudaStream_t stream) {
  const int threads = (n + G - 1) / G;
  dp_inter_kernel<W, G><<<(threads + kBlock - 1) / kBlock, kBlock, 0,
                          stream>>>(
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tl),
      static_cast<const int8_t*>(p), static_cast<const int32_t*>(pl), n,
      t_max, p_max, static_cast<int32_t*>(scores));
  return cudaGetLastError();
}

template <int W, int FLAGS>
cudaError_t launch_abl(const void* t, const void* tl, const void* p,
                       const void* pl, int n, int t_max, int p_max,
                       void* scores, cudaStream_t stream) {
  dp_abl_kernel<W, FLAGS><<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tl),
      static_cast<const int8_t*>(p), static_cast<const int32_t*>(pl), n,
      t_max, p_max, static_cast<int32_t*>(scores));
  return cudaGetLastError();
}

}  // namespace

// t: (n, t_max) int8, tl: (n,) int32, p: (n, p_max) int8, pl: (n,) int32,
// scores: (n,) int32.  w must be 32; groups 2 or 4.
extern "C" int t4_dp_inter(const void* t, const void* tl, const void* p,
                           const void* pl, int n, int t_max, int p_max, int w,
                           int groups, void* scores, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != 32) return static_cast<int>(cudaErrorInvalidValue);
  switch (groups) {
    case 2:
      return launch_inter<32, 2>(t, tl, p, pl, n, t_max, p_max, scores, s);
    case 4:
      return launch_inter<32, 4>(t, tl, p, pl, n, t_max, p_max, scores, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As t4_dp_inter; flags is 0 or one t4dp::kAbl* bit.
extern "C" int t4_dp_abl(const void* t, const void* tl, const void* p,
                         const void* pl, int n, int t_max, int p_max, int w,
                         int flags, void* scores, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != 32) return static_cast<int>(cudaErrorInvalidValue);
  switch (flags) {
#define T4_ABL_CASE(F) \
  case F:              \
    return launch_abl<32, F>(t, tl, p, pl, n, t_max, p_max, scores, s);
    T4_ABL_CASE(0)
    T4_ABL_CASE(t4dp::kAblNoShift)
    T4_ABL_CASE(t4dp::kAblStatLoad)
    T4_ABL_CASE(t4dp::kAblNoTSlice)
    T4_ABL_CASE(t4dp::kAblNoSub)
    T4_ABL_CASE(t4dp::kAblNoKir)
    T4_ABL_CASE(t4dp::kAblNoScan)
    T4_ABL_CASE(t4dp::kAblNoJz)
#undef T4_ABL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
