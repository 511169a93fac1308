// CUDA kernel for the traceback-bits DP (replaces the Pallas kernel
// _dp_dirs_kernel, trust4_tpu/ops/dp_pallas.py:385-489, pallas_call l.540
// in banded_affine_dirs_pallas l.493).
//
// Design: one thread per job; the job's arithmetic is dp_dirs_job in
// dp_dirs.cuh, a row loop over all p_max query rows with a left-to-right
// sweep of the W band cells, the band's m and e in registers.  What bounds
// it on an H100: the bytes of its output.  A job writes p_max * W bytes of
// bits (N * P * W in all: 113 MB for the top gap-oracle tier, 16,384 x 144
// x 48) against about 2 * cap bytes of codes read, while its integer work
// is about 24 operations per band cell.  Each thread writes its own rows
// as W/8 eight-byte stores per row; neighbouring threads are p_max * W
// bytes apart, so a warp's stores are not coalesced.  A layout that gives
// a warp's lanes neighbouring words (a transposed staging buffer in shared
// memory) is later work.
//
// Plain C interface for ctypes (ops/build.py, ops/dp_dirs.py): every
// pointer and the stream are void*, and the function returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_dirs.cuh"

namespace {

template <int W>
__global__ void dp_dirs_kernel(const int8_t* __restrict__ t_codes,
                               const int32_t* __restrict__ t_lens,
                               const int8_t* __restrict__ p_codes,
                               const int32_t* __restrict__ p_lens, int n,
                               int t_max, int p_max,
                               int32_t* __restrict__ scores,
                               int8_t* __restrict__ dirs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  scores[b] = t4dp::dp_dirs_job<W>(
      t_codes + (size_t)b * t_max, t_max, p_codes + (size_t)b * p_max, p_max,
      t_lens[b], p_lens[b], dirs + (size_t)b * p_max * W);
}

template <int W>
cudaError_t launch(const void* t, const void* tl, const void* p,
                   const void* pl, int n, int t_max, int p_max, void* scores,
                   void* dirs, cudaStream_t stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  dp_dirs_kernel<W><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tl),
      static_cast<const int8_t*>(p), static_cast<const int32_t*>(pl), n,
      t_max, p_max, static_cast<int32_t*>(scores),
      static_cast<int8_t*>(dirs));
  return cudaGetLastError();
}

}  // namespace

// t: (n, t_max) int8, tl: (n,) int32, p: (n, p_max) int8, pl: (n,) int32,
// scores: (n,) int32, dirs: (n, p_max, w) int8, 8-byte aligned.  w must be
// 16, 24, 32 or 48.
extern "C" int t4_dp_dirs(const void* t, const void* tl, const void* p,
                          const void* pl, int n, int t_max, int p_max, int w,
                          void* scores, void* dirs, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 16:
      return launch<16>(t, tl, p, pl, n, t_max, p_max, scores, dirs, s);
    case 24:
      return launch<24>(t, tl, p, pl, n, t_max, p_max, scores, dirs, s);
    case 32:
      return launch<32>(t, tl, p, pl, n, t_max, p_max, scores, dirs, s);
    case 48:
      return launch<48>(t, tl, p, pl, n, t_max, p_max, scores, dirs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
