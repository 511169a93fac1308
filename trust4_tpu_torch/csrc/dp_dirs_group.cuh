// The traceback-bits DP of one job with its band spread across a group of
// L lanes: the arithmetic of the CUDA kernel dp_dirs.cu, and of its host
// build in the CPU tests.  It computes what dp_dirs_job (dp_dirs.cuh)
// computes, bit for bit: the score and every row's W bit bytes, rows
// beyond p_len and cells outside the band included.  L = 1 is that
// one-thread sweep with no exchange.
//
// Lane l of a group holds the C = W / L consecutive band cells
// k = l*C .. l*C + C-1 of m and e in registers, with the text codes the
// cells read (TextWindow).  Each row i is steps 1-3 of the counts sweep
// (dp_counts_group.cuh) without its CM/CF maps:
//   1. the vertical neighbour of a lane's last cell (cell k+1 of row i-1)
//      is the next lane's first cell: one shfl_down each for m and e; the
//      last lane takes the k = W fill (big_neg);
//   2. each lane sweeps its cells for E, the diagonal, the base score and
//      its largest F candidate t_val = base + GO + k*(-GE), keeping the
//      diagonal and E of each cell (b2 is set here);
//   3. the F running max over the row (an exclusive max scan, seeded at
//      big_neg) combines the lanes' maxima in log2(L) shfl_up steps, and
//      each lane finishes its cells from its incoming max: F, M, the
//      stored m and e, bits b0 and b1, and b3 from the stored m of the
//      cell to the left; the previous lane's last stored m (one shfl_up)
//      gives b3 of a lane's first cell.
// At L = 1 steps 2 and 3 are one pass, as in dp_dirs_job.  Rows beyond
// p_len read the frozen m and e (the exchange included) and store
// neg_inf as their m, so b3 reads it; every row up to p_max is swept,
// since its bits are part of the output.  The tile is never narrowed.
//
// A row's bits leave through the caller's Out: out.row<C>(s, lane, i,
// words) hands slot s's C bytes of row i (cell c in byte c % 4 of word
// c / 4), and out.end_row(i) follows each row, for every lane at once.
//
// The exchange is behind dp_lanes.cuh, so the same source runs on the
// card (one lane per thread) and in the host build (L lanes in lockstep).

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "dp_counts.cuh"  // t4dp's scoring constants, imax, imin, shift_hi
#include "dp_lanes.cuh"

// The (W, L) instances the kernel is built for: every lane count in
// {1, 4, 8, 16} that divides a band width of the scores kernel's.
#define T4DP_DIRS_INSTANCES(X)                                       \
  X(16, 1) X(16, 4) X(16, 8) X(16, 16) X(24, 1) X(24, 4) X(24, 8)    \
  X(32, 1) X(32, 4) X(32, 8) X(32, 16) X(48, 1) X(48, 4) X(48, 8)    \
  X(48, 16)

namespace t4dp {

// Text code of a dirs job at window index x (dp_dirs_job's read).
__host__ __device__ inline int dirs_text(const int8_t* t, int t_max,
                                         bool text_ok, int x) {
  return (text_ok && x >= 0 && x < t_max) ? t[x] : kCodePad;
}

// One job on the group's lanes.  t, p: its code rows; X: the lane
// exchange (dp_lanes.cuh); out: where each row's bits go.  Every slot
// returns the banded score as dp_dirs_job does (-2^29 off the tile);
// own[s] is true in exactly one slot of the group: the lane that holds
// the final cell (lane 0 when it lies outside the tile).
template <int W, int L, class X, class Out>
__host__ __device__ inline void dp_dirs_group(
    const X& x, const int8_t* t, int t_max, const int8_t* p, int p_max,
    int t_len, int p_len, Out& out, int (&score)[X::N], bool (&own)[X::N]) {
  static_assert(W % L == 0, "L must divide W");
  constexpr int C = W / L;
  constexpr int N = X::N;
  constexpr int kWords = (C + 3) / 4;
  const int go = kGapOpen, ge = kGapExtend, go_ge = kGapOpen + kGapExtend;
  const int left = t_len < p_len ? 5 + (p_len - t_len) : 5;
  const int right = t_len > p_len ? 5 + (t_len - p_len) : 5;
  const int neg_inf = (t_len + 1) * (p_len + 1) * go;
  const bool text_ok = left <= shift_hi(W);

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
      // Row 1 reads window index min(0, t_max+8) - left + k.
      tw[s].set(c, dirs_text(t, t_max, text_ok, j0));
    }
  }

  for (int i = 1; i <= p_max; ++i) {
    const bool live = i <= p_len;  // rows beyond p_len keep m/e frozen
    const int pi = p[i - 1];
    const int bound_m = go + i * go;
    const int row0 = i - left;  // column of cell 0
    const int j_hi = imin(t_len, i + right);
    const int m_left0 = row0 == 1 ? bound_m : kBigNeg;

    // 1. Previous-row values at the cell after each lane's last.
    int up_m[N], up_e[N];
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

    uint32_t bits[N][kWords];
    int f0[N], m_last[N];
    if constexpr (L == 1) {
      // One lane: the F running max is a scalar, steps 2 and 3 one pass.
      for (int s = 0; s < N; ++s) {
        for (int q = 0; q < kWords; ++q) bits[s][q] = 0;
        int run = kBigNeg, m_left = m_left0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = row0 + c;
          const bool in_band = j >= 1 && j <= j_hi;
          const bool is_col0 = j == 0;
          const int tj = tw[s].get(c);
          const bool eq = tj == pi || tj == kCodeN || pi == kCodeN;
          const int m_up = c + 1 < C ? m[s][c + 1] : up_m[s];
          const int e_up = c + 1 < C ? e[s][c + 1] : up_e[s];
          const int e_new = imax(e_up + ge, m_up + go_ge);
          const int diag = m[s][c] + (eq ? kMatch : kMismatch);
          const int base = is_col0 ? bound_m
                                   : (in_band ? imax(diag, e_new) : kBigNeg);
          const int f_new = c == 0 ? kBigNeg : run - c * (-ge);
          run = imax(run, (is_col0 ? bound_m : base + go) + c * (-ge));
          const int m_fin = imax(base, f_new);
          const int m_st = !live ? neg_inf
                                 : (is_col0 ? bound_m
                                            : (in_band ? m_fin : neg_inf));
          const uint32_t b = (f_new >= e_new ? 1u : 0u) |
                             (diag == m_fin ? 2u : 0u) |
                             (m_up + go_ge == e_new ? 4u : 0u) |
                             (m_left + go_ge == f_new ? 8u : 0u);
          bits[s][c >> 2] |= b << (8 * (c & 3));
          if (live) {
            m[s][c] = m_st;
            e[s][c] = in_band ? e_new : neg_inf;
          }
          m_left = m_st;
        }
        f0[s] = kBigNeg;
        m_last[s] = kBigNeg;
      }
    } else {
      // 2. E, the diagonal and the lane's largest F candidate.
      int dg[N][C], en[N][C], agg[N];
      for (int s = 0; s < N; ++s) {
        for (int q = 0; q < kWords; ++q) bits[s][q] = 0;
        agg[s] = kBigNeg;
        const int k0 = x.lane(s) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = k0 + c;
          const int j = row0 + k;
          const bool in_band = j >= 1 && j <= j_hi;
          const bool is_col0 = j == 0;
          const int tj = tw[s].get(c);
          const bool eq = tj == pi || tj == kCodeN || pi == kCodeN;
          const int m_up = c + 1 < C ? m[s][c + 1] : up_m[s];
          const int e_up = c + 1 < C ? e[s][c + 1] : up_e[s];
          en[s][c] = imax(e_up + ge, m_up + go_ge);
          dg[s][c] = m[s][c] + (eq ? kMatch : kMismatch);
          const int base =
              is_col0 ? bound_m
                      : (in_band ? imax(dg[s][c], en[s][c]) : kBigNeg);
          agg[s] = imax(agg[s], (is_col0 ? bound_m : base + go) + k * (-ge));
          if (m_up + go_ge == en[s][c]) bits[s][c >> 2] |= 4u << (8 * (c & 3));
        }
      }

      // 3. The F running max: the max over the lanes before this one.
      int run[N];
      for (int s = 0; s < N; ++s) run[s] = agg[s];
#pragma unroll
      for (int d = 1; d < L; d *= 2) {
        int o[N];
        for (int s = 0; s < N; ++s) o[s] = run[s];
        x.shfl_up(o, d);  // lanes below d get their own value back
        for (int s = 0; s < N; ++s) run[s] = imax(run[s], o[s]);
      }
      x.shfl_up(run, 1);
      for (int s = 0; s < N; ++s) {
        const int k0 = x.lane(s) * C;
        int r = x.lane(s) == 0 ? kBigNeg : run[s];
        int m_prev = kBigNeg;
        f0[s] = kBigNeg;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = k0 + c;
          const int j = row0 + k;
          const bool in_band = j >= 1 && j <= j_hi;
          const bool is_col0 = j == 0;
          const int base =
              is_col0 ? bound_m
                      : (in_band ? imax(dg[s][c], en[s][c]) : kBigNeg);
          const int f_new = k == 0 ? kBigNeg : r - k * (-ge);
          r = imax(r, (is_col0 ? bound_m : base + go) + k * (-ge));
          const int m_fin = imax(base, f_new);
          const int m_st = !live ? neg_inf
                                 : (is_col0 ? bound_m
                                            : (in_band ? m_fin : neg_inf));
          uint32_t b = (f_new >= en[s][c] ? 1u : 0u) |
                       (dg[s][c] == m_fin ? 2u : 0u);
          if (c == 0)
            f0[s] = f_new;
          else if (m_prev + go_ge == f_new)
            b |= 8u;
          bits[s][c >> 2] |= b << (8 * (c & 3));
          if (live) {
            m[s][c] = m_st;
            e[s][c] = in_band ? en[s][c] : neg_inf;
          }
          m_prev = m_st;
        }
        m_last[s] = m_prev;
      }
      // b3 of each lane's first cell: the previous lane's last stored m.
      x.shfl_up(m_last, 1);
    }
    for (int s = 0; s < N; ++s) {
      if (L > 1 && (x.lane(s) == 0 ? m_left0 : m_last[s]) + go_ge == f0[s])
        bits[s][0] |= 8u;
      out.template row<C>(s, x.lane(s), i, bits[s]);
      // The next row's text window (it stops moving past t_max + 8).
      if (i <= t_max + 8)
        tw[s].shift(
            dirs_text(t, t_max, text_ok, row0 + x.lane(s) * C + C - 1));
    }
    out.end_row(i);
  }

  // The final cell, with a static-index select (a dynamic index would
  // push the band arrays out of registers).
  const int k_final = t_len - p_len + left;
  const int owner = (k_final >= 0 && k_final < W) ? k_final / C : 0;
  for (int s = 0; s < N; ++s) {
    const int k0 = x.lane(s) * C;
    int sc = kBigNeg;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (k0 + c == k_final) sc = imax(m[s][c], kBigNeg);
    score[s] = sc;
    own[s] = x.lane(s) == owner;
  }
}

}  // namespace t4dp
