// The batched scores DP of one job with its band spread across a group of
// L lanes: the arithmetic of the CUDA kernel dp_scores.cu, and of its host
// build in the CPU tests.  It computes what dp_scores_job
// (dp_scores.cuh) computes, bit for bit: the XLA text clamp
// clamp(j-1, 0, t_max-1), neg_inf with int32 wraparound, INT32_MIN for a
// final cell outside the tile, rows to min(p_len, p_max).  L = 1 is that
// one-thread sweep with no exchange.
//
// Lane l of a group holds the C = W / L consecutive band cells
// k = l*C .. l*C + C-1 in registers (m, e and the text codes the cells
// read; each row shifts a lane's text window by one and loads one byte).
// Each row i:
//   1. the vertical neighbour of a lane's last cell (cell k+1 of row i-1)
//      is the next lane's first cell: one shfl_down each for m and e; the
//      last lane takes big_neg;
//   2. each lane sweeps its cells for E, the diagonal, the base score and
//      its largest F candidate t_val = base + GO + k*(-GE);
//   3. the F running max over the row (an exclusive max scan with no seed,
//      as XLA's cummax: INT32_MIN) combines the lanes' maxima in log2(L)
//      shfl_up steps, and each lane finishes its cells from its incoming
//      max.
// Max is associative, so the result is the sequential sweep's.
//
// The exchange is behind dp_lanes.cuh, so the same source runs on the
// card (one lane per thread) and in the host build (L lanes in lockstep).
//
// FLAGS (default 0) removes pieces of the sweep at compile time, for the
// kernel lab's ablation kernel (dp_lab.cu), which so times the very code
// the scores kernel runs.  Each flag drops what tools/dp_kernel_lab.py's
// DP_ABLATE flag of the same name drops from the Pallas row body; the
// scores that result are the lab's (banded_affine_scores_ablated), not
// the DP's:
//   noshift  (1): the vertical neighbour is cell k of the previous row,
//                 not k+1: no step-1 exchange, each cell reads its own.
//   statload (2): no loads in the row loop: every row reads row 1's text
//                 window and query code.
//   notslice (4): the text window and query code of the first row of each
//                 8-row block serve the whole block; the window is loaded
//                 anew at a block's end.
//   nosub    (8): the substitution is always +2 (no match test).
//   nokir   (16): no band mask on base and on the stored e.
//   noscan  (32): no horizontal-gap running max: f = base, so no step 3
//                 (neither its shuffles nor its second pass).
//   nojz    (64): no column-0 case: j == 0 is an ordinary (off-band) cell.
// statload wins over notslice where both are set.

#pragma once

#include <stdint.h>

#include "dp_lanes.cuh"
#include "dp_scores.cuh"

// The (W, L) instances the kernel is built for: every lane count in
// {1, 4, 8, 16} that divides a band width the wrapper takes.
#define T4DP_SCORES_INSTANCES(X) \
  X(16, 1) X(16, 4) X(16, 8) X(16, 16) X(24, 1) X(24, 4) X(24, 8) \
  X(32, 1) X(32, 4) X(32, 8) X(32, 16) X(48, 1) X(48, 4) X(48, 8) X(48, 16)

namespace t4dp {

constexpr int kAblNoShift = 1;
constexpr int kAblStatLoad = 2;
constexpr int kAblNoTSlice = 4;
constexpr int kAblNoSub = 8;
constexpr int kAblNoKir = 16;
constexpr int kAblNoScan = 32;
constexpr int kAblNoJz = 64;

// The query code row i reads: its own, or under statload / notslice that
// of row 1 / of its block's first row (held in `held` across rows).
template <int FLAGS>
__host__ __device__ inline int query_code(const int8_t* p, int i, int& held) {
  if constexpr ((FLAGS & kAblStatLoad) != 0) {
    return p[0];
  } else if constexpr ((FLAGS & kAblNoTSlice) != 0) {
    if (((i - 1) & 7) == 0) held = p[i - 1];
    return held;
  } else {
    return p[i - 1];
  }
}

// Whether column j takes the column-0 case (never under nojz).
template <int FLAGS>
__host__ __device__ inline bool col0(int j) {
  if constexpr ((FLAGS & kAblNoJz) != 0)
    return false;
  else
    return j == 0;
}

// Moves a lane's text window from row i to row i+1, whose cell k0 + c
// reads column j_base + k0 + c (j_base: row i's column of cell 0).
template <int C, int FLAGS>
__host__ __device__ inline void next_window(TextWindow<C>& tw,
                                            const int8_t* t, int t_max,
                                            int j_base, int k0, int i) {
  if constexpr ((FLAGS & kAblStatLoad) != 0) {
    return;
  } else if constexpr ((FLAGS & kAblNoTSlice) != 0) {
    if ((i & 7) == 0) {
      tw.clear();
#pragma unroll
      for (int c = 0; c < C; ++c) tw.set(c, text_at(t, t_max, j_base + k0 + c));
    }
  } else {
    tw.shift(text_at(t, t_max, j_base + k0 + C - 1));
  }
}

// One job on the group's lanes.  t, p: its code rows; X: the lane
// exchange (dp_lanes.cuh).  Every slot returns m[p_len][t_len] as
// dp_scores_job does; own[s] is true in exactly one slot of the group:
// the lane that holds the final cell (lane 0 when it lies outside the
// tile), which writes the result.  FLAGS: the pieces removed (above).
template <int W, int L, int FLAGS = 0, class X>
__host__ __device__ inline void dp_scores_group(
    const X& x, const int8_t* t, int t_max, const int8_t* p, int p_max,
    int t_len, int p_len, int (&score)[X::N], bool (&own)[X::N]) {
  static_assert(W % L == 0, "L must divide W");
  constexpr int C = W / L;
  constexpr int N = X::N;
  const int go = kGapOpen, ge = kGapExtend, go_ge = kGapOpen + kGapExtend;
  const int left = t_len < p_len ? 5 + (p_len - t_len) : 5;
  const int right = t_len > p_len ? 5 + (t_len - p_len) : 5;
  // (t+1)(p+1)*GO with int32 wraparound, as XLA computes it.
  const int neg_inf = (int)((unsigned)(t_len + 1) * (unsigned)(p_len + 1) *
                            (unsigned)go);

  // The band rows m, e of the lane's cells.  Within a row, step 2 leaves
  // the diagonal score and the new e in them (each cell's old values are
  // read by the cell to its left before it), and step 3 finishes m in
  // place.
  int m[N][C], e[N][C];
  TextWindow<C> tw[N];
  for (int s = 0; s < N; ++s) {
    const int k0 = x.lane(s) * C;
    tw[s].clear();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j0 = k0 + c - left;
      const bool in_t0 = j0 >= 0 && j0 <= t_len;
      m[s][c] = in_t0 ? (j0 == 0 ? 0 : go + j0 * go) : neg_inf;
      e[s][c] = in_t0 ? (j0 == 0 ? 0 : go + (p_len + 1) * go) : neg_inf;
      // Row 1 reads column j-1 = k - left.
      tw[s].set(c, text_at(t, t_max, j0));
    }
  }

  const int rows = imin(p_len, p_max);
  const int loop_rows = x.rows(rows);
  int pi_held = kCodePad;  // notslice: the block's query code
  for (int i = 1; i <= loop_rows; ++i) {
    // Rows past the job's own (a warp-mate runs on) only exchange.
    const bool live = L == 1 || i <= rows;
    const int pi = live ? query_code<FLAGS>(p, i, pi_held) : kCodePad;
    const bool p_is_n = pi == kCodeN;
    const int bound_m = go + i * go;
    const int j_base = i - left;  // column of cell 0
    const int j_hi = imin(t_len, i + right);

    // 1. Previous-row values at the cell after each lane's last.
    [[maybe_unused]] int up_m[N], up_e[N];
    if constexpr ((FLAGS & kAblNoShift) == 0) {
      for (int s = 0; s < N; ++s) {
        up_m[s] = m[s][0];
        up_e[s] = e[s][0];
      }
      if constexpr (L > 1) {
        x.shfl_down(up_m, 1);
        x.shfl_down(up_e, 1);
      }
      for (int s = 0; s < N; ++s) {
        if (x.lane(s) == L - 1) {
          up_m[s] = kBigNeg;
          up_e[s] = kBigNeg;
        }
      }
    }

    // 2. E, the diagonal and the lane's largest F candidate
    // t_val = base + GO + k*(-GE).
    int run[N];
    for (int s = 0; s < N; ++s) {
      run[s] = kInt32Min;
      if (!live) continue;
      const int k0 = x.lane(s) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        const int j = j_base + k;
        const bool in_band = j >= 1 && j <= j_hi;
        const bool is_col0 = col0<FLAGS>(j);
        bool eq = true;  // nosub: every substitution a match
        if constexpr ((FLAGS & kAblNoSub) == 0) {
          const int tj = tw[s].get(c);
          eq = tj == pi || tj == kCodeN || p_is_n;
        }
        int m_up, e_up;
        if constexpr ((FLAGS & kAblNoShift) != 0) {
          m_up = m[s][c];
          e_up = e[s][c];
        } else {
          m_up = c + 1 < C ? m[s][c + 1] : up_m[s];
          e_up = c + 1 < C ? e[s][c + 1] : up_e[s];
        }
        const int e_new = imax(e_up + ge, m_up + go_ge);
        const int diag = m[s][c] + (eq ? kMatch : kMismatch);
        int base;
        if constexpr ((FLAGS & kAblNoKir) != 0)
          base = is_col0 ? bound_m : imax(diag, e_new);
        else
          base = is_col0 ? bound_m : (in_band ? imax(diag, e_new) : kBigNeg);
        if constexpr ((FLAGS & kAblNoScan) != 0) {
          m[s][c] = is_col0 ? bound_m : (in_band ? base : neg_inf);
        } else {
          run[s] = imax(run[s], (is_col0 ? bound_m : base + go) + k * (-ge));
          m[s][c] = diag;
        }
        if constexpr ((FLAGS & kAblNoKir) != 0)
          e[s][c] = e_new;
        else
          e[s][c] = in_band ? e_new : neg_inf;
      }
    }

    // 3. The F running max: the max over the lanes before this one.
    if constexpr (L > 1 && (FLAGS & kAblNoScan) == 0) {
#pragma unroll
      for (int d = 1; d < L; d *= 2) {
        int o[N];
        for (int s = 0; s < N; ++s) o[s] = run[s];
        x.shfl_up(o, d);  // lanes below d get their own value back
        for (int s = 0; s < N; ++s) run[s] = imax(run[s], o[s]);
      }
      x.shfl_up(run, 1);
    }
    for (int s = 0; s < N; ++s) {
      if (!live) continue;
      const int k0 = x.lane(s) * C;
      if constexpr ((FLAGS & kAblNoScan) == 0) {
        int r = x.lane(s) == 0 ? kInt32Min : run[s];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = k0 + c;
          const int j = j_base + k;
          const bool in_band = j >= 1 && j <= j_hi;
          const bool is_col0 = col0<FLAGS>(j);
          // In the band e holds E and m the diagonal score.
          int base;
          if constexpr ((FLAGS & kAblNoKir) != 0)
            base = is_col0 ? bound_m : imax(m[s][c], e[s][c]);
          else
            base = is_col0 ? bound_m
                           : (in_band ? imax(m[s][c], e[s][c]) : kBigNeg);
          const int f_new = k == 0 ? kBigNeg : r - k * (-ge);
          r = imax(r, (is_col0 ? bound_m : base + go) + k * (-ge));
          m[s][c] = is_col0 ? bound_m : (in_band ? imax(base, f_new) : neg_inf);
        }
      }
      // The next row's text window: cell k reads column j_base + k.
      next_window<C, FLAGS>(tw[s], t, t_max, j_base, k0, i);
    }
  }

  // The final cell, with a static-index select (a dynamic index would
  // push the band arrays out of registers).
  const int k_final = t_len - p_len + left;
  const int owner = (k_final >= 0 && k_final < W) ? k_final / C : 0;
  for (int s = 0; s < N; ++s) {
    const int k0 = x.lane(s) * C;
    int sc = kInt32Min;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (k0 + c == k_final) sc = m[s][c];
    score[s] = sc;
    own[s] = x.lane(s) == owner;
  }
}

// The job on the narrowest tile its warp can share (band_need,
// narrow_width, X::width): the same result as dp_scores_group<W, L>,
// with the off-band cells of a wide tile left out.  need is band_need(t_len,
// p_len), or 0 for a slot with no job.  FLAGS as for dp_scores_group.
template <int W, int L, int FLAGS = 0, class X>
__host__ __device__ inline void dp_scores_narrow(
    const X& x, int need, const int8_t* t, int t_max, const int8_t* p,
    int p_max, int t_len, int p_len, int (&score)[X::N], bool (&own)[X::N]) {
  const int w = x.width(narrow_width<W, L>(need));
  if constexpr (W > 16 && 16 % L == 0)
    if (w == 16)
      return dp_scores_group<16, L, FLAGS>(
          x, t, t_max, p, p_max, t_len, p_len, score, own);
  if constexpr (W > 24 && 24 % L == 0)
    if (w == 24)
      return dp_scores_group<24, L, FLAGS>(
          x, t, t_max, p, p_max, t_len, p_len, score, own);
  if constexpr (W > 32 && 32 % L == 0)
    if (w == 32)
      return dp_scores_group<32, L, FLAGS>(
          x, t, t_max, p, p_max, t_len, p_len, score, own);
  dp_scores_group<W, L, FLAGS>(
      x, t, t_max, p, p_max, t_len, p_len, score, own);
}

}  // namespace t4dp
