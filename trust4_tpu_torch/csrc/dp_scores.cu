// CUDA kernel for the batched banded scores DP (replaces the Pallas kernel
// _dp_kernel, trust4_tpu/ops/dp_pallas.py:55, pallas_call l.341, and its
// XLA twin banded_affine_scores, trust4_tpu/ops/dp_batch.py:63).
//
// Design: one thread per job; the job's arithmetic is dp_scores_job in
// dp_scores.cuh, a row loop over the query with a left-to-right sweep of
// the W band cells, the band's m, e and text codes in registers.  What
// bounds it on an H100: integer issue.  A job is about p_len * W cells of
// ~28 int32 operations each, while its input is t_max + p_max bytes of
// codes and 8 bytes of lengths, so the bench shape (65,536 jobs x 148
// rows x 32 cells) does ~8.7G operations on ~20 MB.  The Pallas kernel's
// text pre-shift (_build_ts_selshift) is an index offset here, and its
// 8-row blocks and host statics (scan_span, uniform_p, jz_blocks) have no
// counterpart: each thread stops at its own p_len.  Each thread reads its
// own code rows, one text byte and one query byte per row (not coalesced;
// L1 absorbs them).  Spreading a band across warp lanes is later work.
//
// Plain C interface for ctypes (ops/build.py, ops/dp_scores.py): every
// pointer and the stream are void*, and the function returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_scores.cuh"

namespace {

template <int W>
__global__ void dp_scores_kernel(const int8_t* __restrict__ t_codes,
                                 const int32_t* __restrict__ t_lens,
                                 const int8_t* __restrict__ p_codes,
                                 const int32_t* __restrict__ p_lens, int n,
                                 int t_max, int p_max,
                                 int32_t* __restrict__ scores) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  scores[b] = t4dp::dp_scores_job<W>(t_codes + (size_t)b * t_max, t_max,
                                     p_codes + (size_t)b * p_max, p_max,
                                     t_lens[b], p_lens[b]);
}

template <int W>
cudaError_t launch(const void* t, const void* tl, const void* p,
                   const void* pl, int n, int t_max, int p_max, void* scores,
                   cudaStream_t stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  dp_scores_kernel<W><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tl),
      static_cast<const int8_t*>(p), static_cast<const int32_t*>(pl), n,
      t_max, p_max, static_cast<int32_t*>(scores));
  return cudaGetLastError();
}

}  // namespace

// t: (n, t_max) int8, tl: (n,) int32, p: (n, p_max) int8, pl: (n,) int32,
// scores: (n,) int32.  w must be 16, 24, 32 or 48.
extern "C" int t4_dp_scores(const void* t, const void* tl, const void* p,
                            const void* pl, int n, int t_max, int p_max,
                            int w, void* scores, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 16:
      return launch<16>(t, tl, p, pl, n, t_max, p_max, scores, s);
    case 24:
      return launch<24>(t, tl, p, pl, n, t_max, p_max, scores, s);
    case 32:
      return launch<32>(t, tl, p, pl, n, t_max, p_max, scores, s);
    case 48:
      return launch<48>(t, tl, p, pl, n, t_max, p_max, scores, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
