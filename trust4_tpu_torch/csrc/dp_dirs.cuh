// Banded affine-gap global DP with traceback decision bits: the arithmetic
// of one job in one thread, the sequential model of the CUDA kernel's
// lane-group sweep (dp_dirs_group.cuh, which must equal it bit for bit)
// and run in a host build by the CPU tests.
//
// Replaces the Pallas kernel _dp_dirs_kernel
// (trust4_tpu/ops/dp_pallas.py:385-489) and its XLA mirror
// banded_affine_dirs_xla (l.1160-1285).  The recurrence is the counts
// kernel's (dp_counts.cuh: GlobalAlignment semantics, the pre-shifted text
// window with its bucket and start clamp, the stale e[0][j] seed) without
// the count carries; per band cell it emits the four bits the traceback
// walker reads (AlignAlgo.hpp:174-203):
//
//   bit0: f >= e                 bit1: m[i-1][j-1] + sub == m[i][j]
//   bit2: m[i-1][j] + GO+GE == e  bit3: m[i][j-1] + GO+GE == f
//
// Three places where the scores kernel (dp_scores.cuh) is not the model:
// the text column follows the counts DP (shift_hi bucket, window start
// min(i-1, t_max+8)), not XLA's clamp; the final score of a cell outside
// the tile is -2^29, not INT32_MIN; and every row up to p_max writes
// bits, rows beyond p_len from the frozen m/e (their stored m reads
// neg_inf, so b3 sees it), because the whole (N, P, W) tensor is the
// output.  Those extra rows are the price of that contract on batches of
// mixed lengths.
//
// Band coordinates: cell k in [0, W) of row i is column j = i - left + k.
// One thread sweeps each row left to right (the in-row F max is a running
// scalar); a row's W bit bytes are packed into W/8 64-bit words and
// written with W/8 eight-byte stores.  The kernel spreads the row over a
// group of lanes and stages the bits in shared memory instead
// (dp_dirs.cu).
//
// The header needs no CUDA headers: compiled by g++ with __host__ and
// __device__ defined empty, it runs the same arithmetic on the CPU (the
// port's CPU tests hold it against the plain PyTorch version).

#pragma once

#include <stdint.h>

#include "dp_counts.cuh"  // t4dp's scoring constants, imax, imin, shift_hi

namespace t4dp {

// One job.  t: its text code row (t_max int8), p: its query code row
// (p_max int8), t_len/p_len its lengths, dirs: its (p_max, W) int8 block,
// 8-byte aligned.  Returns the banded score (-2^29 off the tile).
template <int W>
__host__ __device__ inline int dp_dirs_job(const int8_t* t, int t_max,
                                           const int8_t* p, int p_max,
                                           int t_len, int p_len,
                                           int8_t* dirs) {
  static_assert(W % 8 == 0, "rows are written as 8-byte words");
  const int go = kGapOpen, ge = kGapExtend, go_ge = kGapOpen + kGapExtend;
  const int left = t_len < p_len ? 5 + (p_len - t_len) : 5;
  const int right = t_len > p_len ? 5 + (t_len - p_len) : 5;
  const int neg_inf = (t_len + 1) * (p_len + 1) * go;
  const bool text_ok = left <= shift_hi(W);

  // With W a template constant the unrolled sweeps index these arrays
  // statically, so they can live in registers.
  int m[W], e[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j0 = k - left;
    const bool in_t0 = j0 >= 0 && j0 <= t_len;
    m[k] = in_t0 ? (j0 == 0 ? 0 : go + j0 * go) : neg_inf;
    e[k] = in_t0 ? (j0 == 0 ? 0 : go + (p_len + 1) * go) : neg_inf;
  }

  for (int i = 1; i <= p_max; ++i) {
    const bool live = i <= p_len;  // rows beyond p_len keep m/e frozen
    const int pi = p[i - 1];
    const int bound_m = go + i * go;
    const int x0 = imin(i - 1, t_max + 8) - left;
    int run = kBigNeg;
    int m_left = (i - left) == 1 ? bound_m : kBigNeg;
    uint64_t word[W / 8];
#pragma unroll
    for (int q = 0; q < W / 8; ++q) word[q] = 0;

#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = i - left + k;
      const bool in_band = j >= 1 && j <= t_len && j <= i + right;
      const bool is_col0 = j == 0;

      const int x = x0 + k;
      const int tj = (text_ok && x >= 0 && x < t_max) ? t[x] : kCodePad;
      const bool eq = tj == pi || tj == kCodeN || pi == kCodeN;

      const int m_up = k + 1 < W ? m[k + 1] : kBigNeg;
      const int e_up = k + 1 < W ? e[k + 1] : kBigNeg;
      const int e_new = imax(e_up + ge, m_up + go_ge);
      const int diag = m[k] + (eq ? kMatch : kMismatch);

      int base = is_col0 ? bound_m : imax(diag, e_new);
      if (!(in_band || is_col0)) base = kBigNeg;
      const int f_new = k == 0 ? kBigNeg : run - k * (-ge);
      run = imax(run, (is_col0 ? bound_m : base + go) + k * (-ge));

      const int m_fin = imax(base, f_new);
      const int m_st =
          !live ? neg_inf : (is_col0 ? bound_m : (in_band ? m_fin : neg_inf));
      const int e_st = live && in_band ? e_new : neg_inf;

      const int bits = (f_new >= e_new ? 1 : 0) | (diag == m_fin ? 2 : 0) |
                       (m_up + go_ge == e_new ? 4 : 0) |
                       (m_left + go_ge == f_new ? 8 : 0);
      word[k / 8] |= (uint64_t)bits << (8 * (k % 8));

      if (live) {
        m[k] = m_st;
        e[k] = e_st;
      }
      m_left = m_st;
    }
    uint64_t* row = reinterpret_cast<uint64_t*>(dirs + (size_t)(i - 1) * W);
#pragma unroll
    for (int q = 0; q < W / 8; ++q) row[q] = word[q];
  }

  // Read the final cell with a static-index select (a dynamic index
  // would push the band arrays out of registers).
  const int k_final = t_len - p_len + left;
  int score = kBigNeg;
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k == k_final) score = imax(m[k], kBigNeg);
  return score;
}

}  // namespace t4dp
