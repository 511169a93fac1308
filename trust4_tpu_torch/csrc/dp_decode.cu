// CUDA kernel for the traceback decoder over the dirs kernel's bits
// (replaces the JAX package's batched DFA walker decode_dirs_counts,
// trust4_tpu/ops/dp_pallas.py:583-725, an XLA program; the port's torch
// loop ops/dp_dirs.py decode_dirs_counts_plain is its plain version).
//
// What bounds it on an H100: the latency of a dependent chain.  A job's
// walk is one step per edit-script operation or DFA transition, each step
// a byte of bits read at an address the previous step chose (a new row
// of W bytes as the walk moves up), against about 3 bytes read and a few
// dozen integer operations a step; so a tier chunk's bytes and operations
// bound it at microseconds, and the longest walk's chain of loads sets
// its time.
//
// Design: one thread per job (dp_decode.cuh decode_dirs_job), each
// walking until (0, 0) or the fixed-step loop's cap, whichever comes
// first, so a short job's thread ends early instead of standing still for
// the cap's steps as the XLA program's lanes do.  The kernel is built for
// each band width of the dirs kernel.
//
// Plain C interface for ctypes (ops/build.py, ops/dp_dirs.py): every
// pointer and the stream are void*, and the function returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_decode.cuh"

namespace {

constexpr int kBlock = 128;

template <int W>
__global__ void __launch_bounds__(kBlock)
    decode_dirs_kernel(const int8_t* __restrict__ dirs, int dirs_stride,
                       const int8_t* __restrict__ t_codes,
                       const int32_t* __restrict__ t_lens,
                       const int8_t* __restrict__ p_codes,
                       const int32_t* __restrict__ p_lens, int n, int t_max,
                       int p_codes_max, int p_max, int steps,
                       int32_t* __restrict__ counts,
                       int32_t* __restrict__ walked) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= n) return;
  const int k = t4dp::decode_dirs_job<W>(
      dirs + (size_t)b * dirs_stride, p_max, t_codes + (size_t)b * t_max,
      t_max, p_codes + (size_t)b * p_codes_max, p_codes_max, t_lens[b],
      p_lens[b], steps, counts + 3 * (size_t)b);
  if (walked != nullptr) walked[b] = k;
}

template <int W>
cudaError_t launch(const void* dirs, int dirs_stride, const void* t,
                   const void* tl, const void* p, const void* pl, int n,
                   int t_max, int p_codes_max, int p_max, int steps,
                   void* counts, void* walked, cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  decode_dirs_kernel<W><<<grid, kBlock, 0, stream>>>(
      static_cast<const int8_t*>(dirs), dirs_stride,
      static_cast<const int8_t*>(t), static_cast<const int32_t*>(tl),
      static_cast<const int8_t*>(p), static_cast<const int32_t*>(pl), n,
      t_max, p_codes_max, p_max, steps, static_cast<int32_t*>(counts),
      static_cast<int32_t*>(walked));
  return cudaGetLastError();
}

}  // namespace

// dirs: n rows of dirs_stride int8 bits (a contiguous (n, P, W') tensor,
// p_max * w <= dirs_stride), t: (n, t_max) int8, tl: (n,) int32, p: (n,
// p_codes_max) int8, pl: (n,) int32, counts: (n, 3) int32 (match,
// mismatch, indel); walked: (n,) int32 iterations walked, or null.  w
// must be 16, 24, 32 or 48.
extern "C" int t4_dp_decode(const void* dirs, int dirs_stride, const void* t,
                            const void* tl, const void* p, const void* pl,
                            int n, int t_max, int p_codes_max, int p_max,
                            int w, int steps, void* counts, void* walked,
                            void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define CASE(W_)                                                        \
  case W_:                                                              \
    return launch<W_>(dirs, dirs_stride, t, tl, p, pl, n, t_max,        \
                      p_codes_max, p_max, steps, counts, walked, s);
    CASE(16) CASE(24) CASE(32) CASE(48)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
