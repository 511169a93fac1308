// CUDA microbenchmark of int32 operation chains (replaces the Pallas kernel
// `kern` built in `bench`, tools/vpu_microbench.py:35-50, pallas_call l.42).
//
// Each body runs K = 512 int32 operations per element of a (w, lanes)
// tile, in one dependent chain, in G interleaved independent chains, or
// as independent operations folded by a max; the launch repeats the tile
// `grid` times (GRID = 256 in the tool), every repeat reading the same
// input, as the Pallas grid steps do.  Only repeat 0 stores the tile: the
// others store only where the result equals `never` (a kernel argument
// no result takes), so the compiler must still compute them, and the
// repeats do not contend in L2 for the same 4-64 KB of output.  Bodies
// (the tool's order, tools/vpu_microbench.py:72-132):
//   0 chain_max    K/2 x: x = max(x, x + one)
//   1 inter2       2 chains of chain_max, interleaved, then their max
//   2 inter4       4 chains likewise
//   3 chain_shift  K x: x = the tile shifted up one row, fill at the bottom
//   4 shift_max    K/2 x: x = max(x, x shifted up one row)
//   5 indep_max    max over i < K/2 of max(x, x + i * one)
//   6 chain_where  K x: x = (x0 > threshold) ? x + one : x
//
// Layout: one thread per tile element, the w rows of a column on w
// neighbouring lanes of a warp (w = 8 or 32), so "shift up one row" is
// __shfl_down_sync within a w-lane segment, and no body indexes a
// register array.  Guards against the compiler folding the chains: `one`,
// `fill`, `threshold` and `never` are kernel arguments, and each step's
// result passes an empty asm statement, so no step can be folded into or
// reassociated with the next (a chain of `x + one` selects would
// otherwise become one multiply-add).  The bodies are unrolled in full:
// the function's SASS instruction count shows whether the K operations
// survived.  What bounds it: the latency of a dependent chain (throughput
// only for the independent forms); the tile's bytes are negligible.
//
// Plain C interface for ctypes (ops/build.py,
// trust4_tpu_torch/tools/vpu_microbench.py); returns the cudaError_t of
// the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 512;
constexpr int kBlock = 256;

__device__ __forceinline__ int keep(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The value of the element one row down (row + 1), fill on the last row.
template <int ROWS>
__device__ __forceinline__ int shift_up(int v, int row, int fill) {
  const int below = __shfl_down_sync(0xffffffffu, v, 1, ROWS);
  return row == ROWS - 1 ? fill : below;
}

template <int BODY, int ROWS>
__global__ void microbench_kernel(const int32_t* __restrict__ x,
                                  int32_t* __restrict__ out, int lanes,
                                  int one, int fill, int threshold,
                                  int never) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = t % (ROWS * lanes);
  const int row = e % ROWS, col = e / ROWS;
  int v = x[row * lanes + col];
  if constexpr (BODY == 0) {
#pragma unroll
    for (int s = 0; s < kK / 2; ++s) v = keep(max(v, v + one));
  } else if constexpr (BODY == 1 || BODY == 2) {
    constexpr int G = BODY == 1 ? 2 : 4;
    int xs[G];
#pragma unroll
    for (int g = 0; g < G; ++g) xs[g] = v + g;
#pragma unroll
    for (int s = 0; s < kK / 2; ++s) {
#pragma unroll
      for (int g = 0; g < G; ++g) xs[g] = keep(max(xs[g], xs[g] + one));
    }
    v = xs[0];
#pragma unroll
    for (int g = 1; g < G; ++g) v = max(v, xs[g]);
  } else if constexpr (BODY == 3) {
#pragma unroll
    for (int s = 0; s < kK; ++s) v = keep(shift_up<ROWS>(v, row, fill));
  } else if constexpr (BODY == 4) {
#pragma unroll
    for (int s = 0; s < kK / 2; ++s)
      v = keep(max(v, shift_up<ROWS>(v, row, fill)));
  } else if constexpr (BODY == 5) {
    int acc = v;  // i = 0: max(x, x + 0)
#pragma unroll
    for (int i = 1; i < kK / 2; ++i) acc = keep(max(acc, max(v, v + i * one)));
    v = acc;
  } else {
    const bool m = v > threshold;
#pragma unroll
    for (int s = 0; s < kK; ++s) v = keep(m ? v + one : v);
  }
  if (t < ROWS * lanes || v == never) out[row * lanes + col] = v;
}

template <int BODY, int ROWS>
cudaError_t launch(int lanes, int grid, const void* x, void* out, int one,
                   int fill, int threshold, cudaStream_t stream) {
  const int tile = ROWS * lanes;
  if (tile % kBlock != 0) return cudaErrorInvalidValue;
  microbench_kernel<BODY, ROWS><<<grid * (tile / kBlock), kBlock, 0, stream>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), lanes, one,
      fill, threshold, INT32_MIN);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_rows(int body, int lanes, int grid, const void* x,
                        void* out, int one, int fill, int threshold,
                        cudaStream_t s) {
  switch (body) {
    case 0: return launch<0, ROWS>(lanes, grid, x, out, one, fill, threshold, s);
    case 1: return launch<1, ROWS>(lanes, grid, x, out, one, fill, threshold, s);
    case 2: return launch<2, ROWS>(lanes, grid, x, out, one, fill, threshold, s);
    case 3: return launch<3, ROWS>(lanes, grid, x, out, one, fill, threshold, s);
    case 4: return launch<4, ROWS>(lanes, grid, x, out, one, fill, threshold, s);
    case 5: return launch<5, ROWS>(lanes, grid, x, out, one, fill, threshold, s);
    case 6: return launch<6, ROWS>(lanes, grid, x, out, one, fill, threshold, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (rows, lanes) int32 tiles; rows 8 or 32, rows * lanes a multiple
// of 256; grid repeats of the tile.
extern "C" int t4_microbench(int body, int rows, int lanes, int grid,
                             const void* x, void* out, int one, int fill,
                             int threshold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 8:
      return launch_rows<8>(body, lanes, grid, x, out, one, fill, threshold, s);
    case 32:
      return launch_rows<32>(body, lanes, grid, x, out, one, fill, threshold,
                             s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
