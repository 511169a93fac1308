// The lane exchange of the group DP sweeps (dp_counts_group.cuh,
// dp_scores_group.cuh): a job's band is spread over a group of L lanes,
// and the lanes of a group trade values with shfl_up / shfl_down.
//
// A group sweep is written over N lane slots: every lane-local value is
// an array of N, every lane-local step a loop over the slots, and lane(s)
// says which lane of the group slot s holds.
//   - CudaLanes (the CUDA build): N = 1, each thread is one lane, and the
//     exchange is __shfl_*_sync over all 32 lanes of the warp with width
//     L, so the L lanes of each group trade among themselves.  The slot
//     loops vanish at compile time.
//   - HostLanes (the g++ host build, CPU tests): N = L, one host thread
//     runs the L lanes of a group in lockstep over the slot arrays, and
//     the exchange is an array shift with CUDA's edge rule (a lane with no
//     source lane keeps its own value).
//
// rows(r) is the row count a group loops to when its own job has r rows:
// with shuffles, every lane of a warp must take part in every exchange,
// so on the card a group runs to the longest job of its warp (the rows
// past its own do no work but their exchanges).  width(w) is the band
// width the warp runs at when its job could run at w (narrow_width): the
// widest among the warp's jobs, so the warp takes one code path.  The
// host build takes both warp maxima as arguments.

#pragma once

#include <stdint.h>

namespace t4dp {

template <int L>
struct HostLanes {
  static constexpr int N = L;
  int warp_rows;   // the longest job's rows among the warp's groups
  int warp_width;  // the widest narrow_width among the warp's jobs

  __host__ __device__ int lane(int s) const { return s; }
  __host__ __device__ int rows(int r) const { return L == 1 ? r : warp_rows; }
  __host__ __device__ int width(int) const { return warp_width; }
  __host__ __device__ void shfl_up(int (&v)[N], int d) const {
    for (int s = N - 1; s >= d; --s) v[s] = v[s - d];
  }
  __host__ __device__ void shfl_down(int (&v)[N], int d) const {
    for (int s = 0; s + d < N; ++s) v[s] = v[s + d];
  }
};

#ifdef __CUDACC__
// Host-device qualified so the group sweeps (host-device templates) may
// call it; only the kernels instantiate it, and there it is device code.
template <int L>
struct CudaLanes {
  static constexpr int N = 1;
  int my_lane;  // threadIdx.x % L

  __host__ __device__ int lane(int) const { return my_lane; }
  __host__ __device__ int rows(int r) const {
#ifdef __CUDA_ARCH__
    if (L > 1) return static_cast<int>(__reduce_max_sync(0xffffffffu, r));
#endif
    return r;
  }
  __host__ __device__ int width(int w) const {
#ifdef __CUDA_ARCH__
    return static_cast<int>(__reduce_max_sync(0xffffffffu, w));
#else
    return w;
#endif
  }
  __host__ __device__ void shfl_up(int (&v)[N], int d) const {
#ifdef __CUDA_ARCH__
    v[0] = __shfl_up_sync(0xffffffffu, v[0], d, L);
#endif
  }
  __host__ __device__ void shfl_down(int (&v)[N], int d) const {
#ifdef __CUDA_ARCH__
    v[0] = __shfl_down_sync(0xffffffffu, v[0], d, L);
#endif
  }
};

// Copies the code rows of a block's jobs into shared memory with the
// block's kThreads threads, coalesced: job q of the block (the launch
// order's order[g0 + q]) at q * (t_max + p_max), its query row after its
// text row.  The group kernels' staging (dp_counts.cu, dp_scores.cu,
// dp_lab.cu).
template <int kThreads>
__device__ inline void stage_rows(const int8_t* __restrict__ t_codes,
                                  const int8_t* __restrict__ p_codes,
                                  const int64_t* __restrict__ order, int g0,
                                  int jobs, int t_max, int p_max,
                                  int8_t* rows) {
  const int stride = t_max + p_max;
  for (int idx = threadIdx.x; idx < jobs * t_max; idx += kThreads) {
    const int q = idx / t_max, off = idx - q * t_max;
    rows[q * stride + off] = t_codes[order[g0 + q] * t_max + off];
  }
  for (int idx = threadIdx.x; idx < jobs * p_max; idx += kThreads) {
    const int q = idx / p_max, off = idx - q * p_max;
    rows[q * stride + t_max + off] = p_codes[order[g0 + q] * p_max + off];
  }
}
#endif

// The text codes a lane's C cells read, four to a 32-bit word: cell c in
// byte c % 4 of word c / 4, the bytes past cell C-1 zero.  A row's window
// moves one column right, so shift() hands each cell its right
// neighbour's code and the last cell a new one: C/4 words, not C
// registers, which keeps a one-lane group of 48 cells out of local memory.
template <int C>
struct TextWindow {
  static constexpr int kWords = (C + 3) / 4;
  uint32_t w[kWords];

  __host__ __device__ void clear() {
    for (int i = 0; i < kWords; ++i) w[i] = 0;
  }
  // Cell c's code; call once per cell on a cleared window.
  __host__ __device__ void set(int c, int code) {
    w[c >> 2] |= uint32_t(uint8_t(code)) << (8 * (c & 3));
  }
  __host__ __device__ int get(int c) const {
    return int8_t(uint8_t(w[c >> 2] >> (8 * (c & 3))));
  }
  __host__ __device__ void shift(int code) {
    for (int i = 0; i + 1 < kWords; ++i) w[i] = (w[i] >> 8) | (w[i + 1] << 24);
    w[kWords - 1] = (w[kWords - 1] >> 8) |
                    (uint32_t(uint8_t(code)) << (8 * ((C - 1) & 3)));
  }
};

// Band cells a job needs.  Cells k > left + right are outside the band in
// every row past row 0 (column j = i - left + k > i + right), so their
// stored values are the analytic off-band ones whatever they read, and
// nothing they compute reaches a cell to their left.  A tile of W' >=
// left + right + 2 cells (the last of them off the band, so the k = W'
// fill is never read by a band cell) gives every band cell, the final
// cell and so the result of the W-wide tile, bit for bit; so does the
// text read, since W' > left + 6 keeps the counts DP's pre-shift bucket
// covering left.  left + right = 10 + |t_len - p_len|.  With t_len = 0 no
// cell is in the band: every cell holds a constant (column 0 or off the
// band), and the result is the final cell's, k = 5.
__host__ __device__ inline int band_need(int t_len, int p_len) {
  if (t_len == 0) return 6;
  return 12 + (t_len > p_len ? t_len - p_len : p_len - t_len);
}

// The narrowest tile, of 16, 24 and 32 cells that L lanes divide, or W
// itself, that holds a job needing `need` cells (0: no job).
template <int W, int L>
__host__ __device__ inline int narrow_width(int need) {
  if (W > 16 && 16 % L == 0 && need <= 16) return 16;
  if (W > 24 && 24 % L == 0 && need <= 24) return 24;
  if (W > 32 && 32 % L == 0 && need <= 32) return 32;
  return W;
}

}  // namespace t4dp
