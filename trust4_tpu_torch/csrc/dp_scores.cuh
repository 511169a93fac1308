// Banded affine-gap global DP, final score only: the arithmetic of one
// job, shared by the CUDA kernel (dp_scores.cu) and a host build.
//
// Replaces the Pallas kernel _dp_kernel (trust4_tpu/ops/dp_pallas.py:55)
// and computes the function that kernel and the XLA banded_affine_scores
// (trust4_tpu/ops/dp_batch.py:63-199) share: GlobalAlignment semantics
// (reference: AlignAlgo.hpp:218-424), match +2, mismatch -2, gap open -4,
// extend -1, N (code 4) matches any base, band left = 5+max(0,p-t),
// right = 5+max(0,t-p), the stale seed e[0][j] = GO+(p_len+1)*GO.  It
// follows the XLA function bit for bit, also where the Pallas kernel
// differs (outside band_ok): the text column read at cell k of row i is
// t[clamp(j-1, 0, t_max-1)] with no pre-shift bucket, and a final cell
// outside the band gives INT32_MIN, as XLA's out-of-range gather does.
//
// Band coordinates: cell k in [0, W) of row i is column j = i - left + k.
// One thread owns one job and sweeps each row left to right: the in-row
// horizontal-gap max (an exclusive cummax over the band in XLA and a
// log-doubling scan in Pallas) is a running scalar.  The sweep updates
// the band arrays in place: cell k reads the previous row at k (diagonal)
// and k+1 (vertical) before it overwrites k.  The text codes of the band
// ride in registers too: cell k of row i+1 reads the column cell k+1 of
// row i read, so each row shifts the window by one and loads one byte.
// Rows beyond p_len are frozen in XLA, so the sweep stops at row p_len.
//
// The header needs no CUDA headers: compiled by g++ with __host__ and
// __device__ defined empty, it runs the same arithmetic on the CPU (the
// port's CPU tests hold it against the plain PyTorch version).

#pragma once

#include <stdint.h>

#include "dp_counts.cuh"  // t4dp's scoring constants, imax, imin

namespace t4dp {

constexpr int kInt32Min = -2147483647 - 1;

// Text code at band cell x (unclamped column index j-1) of a job.
__host__ __device__ inline int text_at(const int8_t* t, int t_max, int x) {
  return t_max > 0 ? t[imin(imax(x, 0), t_max - 1)] : kCodePad;
}

// One job.  t: its text code row (t_max int8), p: its query code row
// (p_max int8), t_len/p_len its lengths.  Returns m[p_len][t_len].
//
// int32 operations per band cell of the row loop, counted from the
// source (chip_smoke.py's SCORE_OPS_PER_CELL): column j 1, in_band 3
// (two compares against the row's hoisted bounds, one and), column-0
// test 1, eq 4 (two compares, two ors; pi == N is per row), sub 1, diag
// 1, e_new 3, base 4 (max, or, two selects), f_new 1, t_val 3 (add,
// select, add), running max 1, m_fin 1, stored m and e 3 (selects), text
// shift 1: 28.
template <int W>
__host__ __device__ inline int dp_scores_job(const int8_t* t, int t_max,
                                             const int8_t* p, int p_max,
                                             int t_len, int p_len) {
  const int go = kGapOpen, ge = kGapExtend, go_ge = kGapOpen + kGapExtend;
  const int left = t_len < p_len ? 5 + (p_len - t_len) : 5;
  const int right = t_len > p_len ? 5 + (t_len - p_len) : 5;
  // (t+1)(p+1)*GO with int32 wraparound, as XLA computes it.
  const int neg_inf = (int)((unsigned)(t_len + 1) * (unsigned)(p_len + 1) *
                            (unsigned)go);

  // With W a template constant the unrolled sweeps index these arrays
  // statically, so they can live in registers.
  int m[W], e[W], tw[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j0 = k - left;
    const bool in_t0 = j0 >= 0 && j0 <= t_len;
    m[k] = in_t0 ? (j0 == 0 ? 0 : go + j0 * go) : neg_inf;
    e[k] = in_t0 ? (j0 == 0 ? 0 : go + (p_len + 1) * go) : neg_inf;
    // Row 1 reads column j-1 = k - left.
    tw[k] = text_at(t, t_max, k - left);
  }

  const int rows = imin(p_len, p_max);
  for (int i = 1; i <= rows; ++i) {
    const int pi = p[i - 1];
    const bool p_is_n = pi == kCodeN;
    const int bound_m = go + i * go;
    const int j_base = i - left;  // column of cell 0
    const int j_hi = imin(t_len, i + right);
    // Cell W of the previous row (just outside the band) reads big_neg.
    int run = kInt32Min;  // max of t_val over cells 0..k-1
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = j_base + k;
      const bool in_band = j >= 1 && j <= j_hi;
      const bool is_col0 = j == 0;

      const int tj = tw[k];
      const bool eq = tj == pi || tj == kCodeN || p_is_n;

      const int m_up = k + 1 < W ? m[k + 1] : kBigNeg;
      const int e_up = k + 1 < W ? e[k + 1] : kBigNeg;
      const int e_new = imax(e_up + ge, m_up + go_ge);
      const int diag = m[k] + (eq ? kMatch : kMismatch);

      int base = is_col0 ? bound_m : imax(diag, e_new);
      if (!(in_band || is_col0)) base = kBigNeg;
      const int f_new = k == 0 ? kBigNeg : run - k * (-ge);
      run = imax(run, (is_col0 ? bound_m : base + go) + k * (-ge));

      const int m_fin = imax(base, f_new);
      m[k] = is_col0 ? bound_m : (in_band ? m_fin : neg_inf);
      e[k] = in_band ? e_new : neg_inf;
      tw[k] = k + 1 < W ? tw[k + 1] : text_at(t, t_max, j_base + W - 1);
    }
  }

  // Read the final cell with a static-index select (a dynamic index
  // would push the band arrays out of registers).
  const int k_final = t_len - p_len + left;
  int score = kInt32Min;
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k == k_final) score = m[k];
  return score;
}

}  // namespace t4dp
