// The kernel lab's two variants of the scores DP: the arithmetic, shared by
// the CUDA kernels (dp_lab.cu) and a host build.
//
// Replaces the Pallas kernels of tools/dp_kernel_lab.py: _dp_kernel_inter
// (l.51, G independent 128-lane groups interleaved in one row body) and
// _dp_kernel_abl (l.279, the shipping row body with DP_ABLATE toggles that
// remove pieces, for timing).  Both compute the scores DP of dp_scores.cuh
// (the XLA function: text column clamp(j-1, 0, t_max-1), INT32_MIN for a
// final cell outside the band) with the same sweep, split here into
// init / row_begin / cell / row_end / final so that
//
//   * dp_inter_jobs<W, G> carries G jobs through it in one thread, cell by
//     cell: for each cell k, the step of job 0, then job 1, ... — the CUDA
//     form of G interleaved dependency chains;
//   * dp_abl_job<W, FLAGS> runs one job with the pieces named by FLAGS
//     removed at compile time.  With FLAGS == 0 it is dp_scores_job.
//
// dp_scores.cuh stays as it is: its kernel is on the main path.
//
// The ablation flags.  Each drops from the sweep the piece that DP_ABLATE
// drops from the Pallas row body, where the TPU layout has one; the wrong
// scores that result are the lab's, not the DP's:
//   noshift  (1): the vertical neighbour is cell k of the previous row, not
//                 k+1 (Pallas: shift_up is the identity).
//   statload (2): no loads in the row loop: every row reuses row 1's text
//                 window and query base (Pallas: every 8-row block loads
//                 the first block's codes).
//   notslice (4): the text window and query base of the first row of each
//                 8-row block serve the whole block; the window moves by 8
//                 at a block's end (Pallas: no per-row static slice).
//   nosub    (8): the substitution is always +2 (no match test).
//   nokir   (16): no band mask on base and on the stored e (Pallas: no
//                 k_in_right mask on base and e_in).
//   noscan  (32): no horizontal-gap running max: f = base.
//   nojz    (64): no column-0 case: j == 0 is an ordinary (out-of-band)
//                 cell (Pallas: no jz_blocks).
// statload wins over notslice where both are set.
//
// The header needs no CUDA headers: compiled by g++ with __host__ and
// __device__ defined empty, it runs the same arithmetic on the CPU (the
// port's CPU tests hold it against the plain PyTorch versions).

#pragma once

#include <stdint.h>

#include "dp_scores.cuh"  // t4dp's constants, imax, imin, text_at, kInt32Min

namespace t4dp {

constexpr int kAblNoShift = 1;
constexpr int kAblStatLoad = 2;
constexpr int kAblNoTSlice = 4;
constexpr int kAblNoSub = 8;
constexpr int kAblNoKir = 16;
constexpr int kAblNoScan = 32;
constexpr int kAblNoJz = 64;

// One job's sweep state: the band's m, e and text window.
template <int W>
struct ScoresSweep {
  int m[W], e[W], tw[W];
  const int8_t* t;
  const int8_t* p;
  int t_max, t_len, p_len, left, right, neg_inf, rows;
  int pi;  // the query code in use (held across rows by statload/notslice)
};

// Per-row scalars of a sweep.
struct ScoresRow {
  int pi, bound_m, j_base, j_hi, run;
  bool p_is_n;
};

template <int W>
__host__ __device__ inline void sweep_init(ScoresSweep<W>& s, const int8_t* t,
                                           int t_max, const int8_t* p,
                                           int p_max, int t_len, int p_len) {
  const int go = kGapOpen;
  s.t = t;
  s.p = p;
  s.t_max = t_max;
  s.t_len = t_len;
  s.p_len = p_len;
  s.left = t_len < p_len ? 5 + (p_len - t_len) : 5;
  s.right = t_len > p_len ? 5 + (t_len - p_len) : 5;
  // (t+1)(p+1)*GO with int32 wraparound, as XLA computes it.
  s.neg_inf = (int)((unsigned)(t_len + 1) * (unsigned)(p_len + 1) *
                    (unsigned)go);
  s.rows = imin(p_len, p_max);
  s.pi = s.rows > 0 ? p[0] : kCodePad;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j0 = k - s.left;
    const bool in_t0 = j0 >= 0 && j0 <= t_len;
    s.m[k] = in_t0 ? (j0 == 0 ? 0 : go + j0 * go) : s.neg_inf;
    s.e[k] = in_t0 ? (j0 == 0 ? 0 : go + (p_len + 1) * go) : s.neg_inf;
    s.tw[k] = text_at(t, t_max, k - s.left);  // row 1 reads column k-left
  }
}

template <int W, int FLAGS>
__host__ __device__ inline ScoresRow row_begin(ScoresSweep<W>& s, int i) {
  if constexpr (!(FLAGS & kAblStatLoad)) {
    if (!(FLAGS & kAblNoTSlice) || ((i - 1) & 7) == 0) s.pi = s.p[i - 1];
  }
  ScoresRow r;
  r.pi = s.pi;
  r.p_is_n = s.pi == kCodeN;
  r.bound_m = kGapOpen + i * kGapOpen;
  r.j_base = i - s.left;  // column of cell 0
  r.j_hi = imin(s.t_len, i + s.right);
  r.run = kInt32Min;  // max of t_val over cells 0..k-1
  return r;
}

template <int W, int FLAGS>
__host__ __device__ inline void cell(ScoresSweep<W>& s, ScoresRow& r, int k) {
  const int go = kGapOpen, ge = kGapExtend, go_ge = kGapOpen + kGapExtend;
  const int j = r.j_base + k;
  const bool in_band = j >= 1 && j <= r.j_hi;
  const bool is_col0 = !(FLAGS & kAblNoJz) && j == 0;

  int m_up, e_up;
  if constexpr ((FLAGS & kAblNoShift) != 0) {
    m_up = s.m[k];
    e_up = s.e[k];
  } else {
    m_up = k + 1 < W ? s.m[k + 1] : kBigNeg;
    e_up = k + 1 < W ? s.e[k + 1] : kBigNeg;
  }
  const int e_new = imax(e_up + ge, m_up + go_ge);
  int sub = kMatch;
  if constexpr (!(FLAGS & kAblNoSub)) {
    const int tj = s.tw[k];
    sub = (tj == r.pi || tj == kCodeN || r.p_is_n) ? kMatch : kMismatch;
  }
  const int diag = s.m[k] + sub;

  int base = is_col0 ? r.bound_m : imax(diag, e_new);
  if constexpr (!(FLAGS & kAblNoKir)) {
    if (!(in_band || is_col0)) base = kBigNeg;
  }
  int f_new;
  if constexpr ((FLAGS & kAblNoScan) != 0) {
    f_new = base;
  } else {
    f_new = k == 0 ? kBigNeg : r.run - k * (-ge);
    r.run = imax(r.run, (is_col0 ? r.bound_m : base + go) + k * (-ge));
  }

  const int m_fin = imax(base, f_new);
  s.m[k] = is_col0 ? r.bound_m : (in_band ? m_fin : s.neg_inf);
  if constexpr ((FLAGS & kAblNoKir) != 0) {
    s.e[k] = e_new;
  } else {
    s.e[k] = in_band ? e_new : s.neg_inf;
  }
}

// Moves the text window to the next row.
template <int W, int FLAGS>
__host__ __device__ inline void row_end(ScoresSweep<W>& s, const ScoresRow& r,
                                        int i) {
  if constexpr ((FLAGS & kAblStatLoad) != 0) {
    return;
  } else if constexpr ((FLAGS & kAblNoTSlice) != 0) {
    if ((i & 7) == 0) {
#pragma unroll
      for (int k = 0; k < W; ++k)
        s.tw[k] = k + 8 < W ? s.tw[k + 8] : text_at(s.t, s.t_max, r.j_base + k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      s.tw[k] = k + 1 < W ? s.tw[k + 1] : text_at(s.t, s.t_max, r.j_base + W - 1);
  }
}

// m[p_len][t_len], read with a static-index select (a dynamic index would
// push the band arrays out of registers); INT32_MIN off the band.
template <int W>
__host__ __device__ inline int sweep_final(const ScoresSweep<W>& s) {
  const int k_final = s.t_len - s.p_len + s.left;
  int score = kInt32Min;
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (k == k_final) score = s.m[k];
  return score;
}

// One job with the pieces FLAGS names removed; FLAGS == 0 is
// dp_scores_job<W>.
template <int W, int FLAGS>
__host__ __device__ inline int dp_abl_job(const int8_t* t, int t_max,
                                          const int8_t* p, int p_max,
                                          int t_len, int p_len) {
  ScoresSweep<W> s;
  sweep_init<W>(s, t, t_max, p, p_max, t_len, p_len);
  for (int i = 1; i <= s.rows; ++i) {
    ScoresRow r = row_begin<W, FLAGS>(s, i);
#pragma unroll
    for (int k = 0; k < W; ++k) cell<W, FLAGS>(s, r, k);
    row_end<W, FLAGS>(s, r, i);
  }
  return sweep_final<W>(s);
}

// G jobs in one thread, interleaved cell by cell.  job[g] < 0 marks no
// job (its slot sweeps nothing and out[g] is not written).  Code rows are
// (n, t_max) / (n, p_max) int8.  Each job stops at its own p_len: rows
// beyond it leave that job's state alone.
template <int W, int G>
__host__ __device__ inline void dp_inter_jobs(
    const int8_t* t_codes, const int32_t* t_lens, const int8_t* p_codes,
    const int32_t* p_lens, int t_max, int p_max, const int* job, int* out) {
  ScoresSweep<W> s[G];
  int rows_max = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int b = job[g] < 0 ? 0 : job[g];
    sweep_init<W>(s[g], t_codes + (size_t)b * t_max, t_max,
                  p_codes + (size_t)b * p_max, p_max, t_lens[b], p_lens[b]);
    if (job[g] < 0) s[g].rows = 0;
    rows_max = imax(rows_max, s[g].rows);
  }
  for (int i = 1; i <= rows_max; ++i) {
    ScoresRow r[G] = {};
    bool live[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      live[g] = i <= s[g].rows;
      if (live[g]) r[g] = row_begin<W, 0>(s[g], i);
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (live[g]) cell<W, 0>(s[g], r[g], k);
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (live[g]) row_end<W, 0>(s[g], r[g], i);
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (job[g] >= 0) out[g] = sweep_final<W>(s[g]);
}

}  // namespace t4dp
