// The gap-fill counts DP of one job with its band spread across a group
// of L lanes: the arithmetic of the CUDA kernel dp_counts.cu, and of its
// host build in the CPU tests.  It computes what dp_counts_job
// (dp_counts.cuh) computes, bit for bit, with the same edge semantics;
// L = 1 is that one-thread sweep with no exchange.
//
// Lane l of a group holds the C = W / L consecutive band cells
// k = l*C .. l*C + C-1 in registers (m, e, cm, ce and the text codes the
// cells read).  Each row i:
//   1. the vertical neighbour of a lane's last cell (cell k+1 of row i-1)
//      is the next lane's first cell: one shfl_down each for m, e, cm and
//      ce; the last lane takes the k = W fill (big_neg, cm_edge, ce_edge);
//   2. each lane sweeps its cells for E, the diagonal, the base score and
//      its largest F candidate t_val = base + GO + k*(-GE);
//   3. the F running max over the row (an exclusive max scan, seeded at
//      big_neg) combines the lanes' maxima in log2(L) shfl_up steps, and
//      each lane finishes its cells from its incoming max: F, M, the
//      stored m and e, the tie bits b0-b2; the stored m of the previous
//      lane's last cell (one shfl_up) gives b3 of the first cell;
//   4. the in-row CM/CF recurrence: each lane composes its cells' transfer
//      maps ("take the predecessor's CM or CF and add a constant, or reset
//      to a constant"; dp_pallas.py:882-932), the maps are combined in
//      log2(L) shfl_up steps and evaluated at the k = -1 state (cm_init,
//      cf_init), and the previous lane's outgoing CM/CF (one shfl_up)
//      seeds the lane's own left-to-right sweep of its cells.
// Max and the map composition are associative, so the result is the
// sequential sweep's.
//
// The exchange is behind dp_lanes.cuh, so the same source runs on the
// card (one lane per thread) and in the host build (L lanes in lockstep).

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "dp_counts.cuh"
#include "dp_lanes.cuh"

// The (W, L) instances the kernel is built for: every lane count in
// {1, 4, 8, 16} that divides a gap-oracle tier's band width.
#define T4DP_COUNTS_INSTANCES(X) \
  X(16, 1) X(16, 4) X(16, 8) X(16, 16) X(24, 1) X(24, 4) X(24, 8) \
  X(48, 1) X(48, 4) X(48, 8) X(48, 16)

namespace t4dp {

// Transfer-map sources: the predecessor's CM, its CF, or none (a reset).
constexpr int kSrcM = 0;
constexpr int kSrcF = 1;
constexpr int kSrcConst = 2;

// A map component (src, val) applied after a map whose components are
// (pm_s, pm_v) and (pf_s, pf_v): the composition's component.
__host__ __device__ inline void compose_src(int& s, int& v, int pm_s,
                                            int pm_v, int pf_s, int pf_v) {
  if (s != kSrcConst) {
    const bool from_m = s == kSrcM;
    v += from_m ? pm_v : pf_v;
    s = from_m ? pm_s : pf_s;
  }
}

// A map component evaluated at the state (cm, cf).
__host__ __device__ inline int apply_src(int s, int v, int cm, int cf) {
  return s == kSrcConst ? v : (s == kSrcM ? cm : cf) + v;
}

// Text code of a counts job at window index x (dp_counts_job's read).
__host__ __device__ inline int counts_text(const int8_t* t, int t_max,
                                           bool text_ok, int x) {
  return (text_ok && x >= 0 && x < t_max) ? t[x] : kCodePad;
}

// The kernel's epilogue for job b: with packed, counts[b] =
// m<<20 | mm<<10 | ind; else scores[b] and counts[b] = (m, mm, ind).
__host__ __device__ inline void store_counts(bool packed, int b, int score,
                                             int pk, int32_t* scores,
                                             int32_t* counts) {
  if (packed) {
    counts[b] = pk;
  } else {
    scores[b] = score;
    counts[3 * (size_t)b + 0] = (pk >> 20) & kPkField;
    counts[3 * (size_t)b + 1] = (pk >> 10) & kPkField;
    counts[3 * (size_t)b + 2] = pk & kPkField;
  }
}

// One job on the group's lanes.  t, p: its code rows; X: the lane
// exchange (dp_lanes.cuh).  Every slot returns score and packed counts of
// the final cell as dp_counts_job does; own[s] is true in exactly one
// slot of the group: the lane that holds the final cell (lane 0 when it
// lies outside the tile), which writes the result.
template <int W, int L, class X>
__host__ __device__ inline void dp_counts_group(
    const X& x, const int8_t* t, int t_max, const int8_t* p, int p_max,
    int t_len, int p_len, int (&score)[X::N], int (&packed)[X::N],
    bool (&own)[X::N]) {
  static_assert(W % L == 0, "L must divide W");
  constexpr int C = W / L;
  constexpr int N = X::N;
  const int go = kGapOpen, ge = kGapExtend, go_ge = kGapOpen + kGapExtend;
  const int left = t_len < p_len ? 5 + (p_len - t_len) : 5;
  const int right = t_len > p_len ? 5 + (t_len - p_len) : 5;
  const int neg_inf = (t_len + 1) * (p_len + 1) * go;
  const bool text_ok = left <= shift_hi(W);

  // The band rows m, e, cm, ce of the lane's cells.  Within a row, step 2
  // leaves the diagonal score, the new e, CM's diagonal candidate and
  // CE's row value in them (each cell's old values are read by the cell
  // to its left before it), and steps 3 and 4 finish m and cm, ce in
  // place: four arrays of C, so a lane of C = 48 keeps them in registers.
  int m[N][C], e[N][C], cm[N][C], ce[N][C];
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
      cm[s][c] = j0 >= 0 ? j0 * kPkIndel : 0;
      ce[s][c] = j0 > 0 ? (j0 + 1) * kPkIndel : 0;
      // Row 1 reads window index min(0, t_max+8) - left + k.
      tw[s].set(c, counts_text(t, t_max, text_ok, j0));
    }
  }

  const int rows = imin(p_len, p_max);
  const int loop_rows = x.rows(rows);
  for (int i = 1; i <= loop_rows; ++i) {
    // Rows past the job's own (a warp-mate runs on) only exchange.
    const bool live = L == 1 || i <= rows;
    const int pi = live ? p[i - 1] : kCodePad;
    const int bound_m = go + i * go;
    const int row0 = i - left;  // column of cell 0
    const int j_hi = imin(t_len, i + right);
    const int j_up = (i - 1) - left + W;
    const int cm_edge = (i == 1 ? j_up : (i - 1) + j_up + 1) * kPkIndel;
    const int ce_edge = (i == 1 ? j_up + 1 : (i - 1) + j_up + 1) * kPkIndel;
    const int m_left0 = row0 == 1 ? bound_m : kBigNeg;
    const int j_init = row0 - 1;
    const int oob_init = imax(i + j_init + 1, 0) * kPkIndel;
    const int cm_init = j_init == 0 ? i * kPkIndel : oob_init;
    const int cf_init = j_init == 0 ? (i + 1) * kPkIndel : oob_init;

    // 1. Previous-row values at the cell after each lane's last.
    int up_m[N], up_e[N], up_cm[N], up_ce[N];
    for (int s = 0; s < N; ++s) {
      up_m[s] = m[s][0];
      up_e[s] = e[s][0];
      up_cm[s] = cm[s][0];
      up_ce[s] = ce[s][0];
    }
    if constexpr (L > 1) {
      x.shfl_down(up_m, 1);
      x.shfl_down(up_e, 1);
      x.shfl_down(up_cm, 1);
      x.shfl_down(up_ce, 1);
    }
    for (int s = 0; s < N; ++s) {
      if (x.lane(s) == L - 1) {
        up_m[s] = kBigNeg;
        up_e[s] = kBigNeg;
        up_cm[s] = cm_edge;
        up_ce[s] = ce_edge;
      }
    }

    // 2. E, the diagonal, CE and the lane's largest F candidate
    // t_val = base + GO + k*(-GE).
    int agg[N];
    for (int s = 0; s < N; ++s) {
      agg[s] = kBigNeg;
      if (!live) continue;
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
        const int cm_up = c + 1 < C ? cm[s][c + 1] : up_cm[s];
        const int ce_up = c + 1 < C ? ce[s][c + 1] : up_ce[s];
        const int e_new = imax(e_up + ge, m_up + go_ge);
        const int diag = m[s][c] + (eq ? kMatch : kMismatch);
        const int base = is_col0 ? bound_m
                                 : (in_band ? imax(diag, e_new) : kBigNeg);
        agg[s] = imax(agg[s], (is_col0 ? bound_m : base + go) + k * (-ge));
        const bool b2 = m_up + go_ge == e_new;
        m[s][c] = diag;
        e[s][c] = in_band ? e_new : neg_inf;
        cm[s][c] += eq ? kPkMatch : kPkMismatch;  // CM's diagonal candidate
        ce[s][c] = kPkIndel + (b2 ? cm_up : ce_up);  // CE in the band
      }
    }

    // 3. The F running max: the max over the lanes before this one.
    int run[N];
    for (int s = 0; s < N; ++s) run[s] = agg[s];
    if constexpr (L > 1) {
#pragma unroll
      for (int d = 1; d < L; d *= 2) {
        int o[N];
        for (int s = 0; s < N; ++s) o[s] = run[s];
        x.shfl_up(o, d);  // lanes below d get their own value back
        for (int s = 0; s < N; ++s) run[s] = imax(run[s], o[s]);
      }
      x.shfl_up(run, 1);
    }
    // Tie bits of each cell (bit c): b0 F >= E, b1 M from the diagonal,
    // b3 F opened from M.
    uint64_t b0[N], b1[N], b3[N];
    int f0[N], m_last[N];
    for (int s = 0; s < N; ++s) {
      b0[s] = b1[s] = b3[s] = 0;
      f0[s] = kBigNeg;
      m_last[s] = kBigNeg;
      if (!live) continue;
      const int k0 = x.lane(s) * C;
      int r = x.lane(s) == 0 ? kBigNeg : run[s];
      int m_prev = kBigNeg;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        const int j = row0 + k;
        const bool in_band = j >= 1 && j <= j_hi;
        const bool is_col0 = j == 0;
        // In the band e holds E and m the diagonal score.
        const int base = is_col0 ? bound_m
                                 : (in_band ? imax(m[s][c], e[s][c]) : kBigNeg);
        const int f_new = k == 0 ? kBigNeg : r - k * (-ge);
        r = imax(r, (is_col0 ? bound_m : base + go) + k * (-ge));
        const int m_fin = imax(base, f_new);
        const int m_st = is_col0 ? bound_m : (in_band ? m_fin : neg_inf);
        const uint64_t bit = uint64_t(1) << c;
        if (f_new >= e[s][c]) b0[s] |= bit;
        if (m[s][c] == m_fin) b1[s] |= bit;
        if (c == 0)
          f0[s] = f_new;
        else if (m_prev + go_ge == f_new)
          b3[s] |= bit;
        m[s][c] = m_st;
        m_prev = m_st;
      }
      m_last[s] = m_prev;
    }
    // b3 of each lane's first cell: the previous lane's last stored m.
    if constexpr (L > 1) x.shfl_up(m_last, 1);
    for (int s = 0; s < N; ++s)
      if ((x.lane(s) == 0 ? m_left0 : m_last[s]) + go_ge == f0[s]) b3[s] |= 1;

    // 4. The lane's incoming CM/CF, then its own sweep.
    int in_m[N], in_f[N];
    for (int s = 0; s < N; ++s) {
      in_m[s] = cm_init;
      in_f[s] = cf_init;
    }
    if constexpr (L > 1) {
      // The lane's composed map (identity: CM <- CM, CF <- CF).
      int am_s[N], am_v[N], af_s[N], af_v[N];
      for (int s = 0; s < N; ++s) {
        am_s[s] = kSrcM;
        am_v[s] = 0;
        af_s[s] = kSrcF;
        af_v[s] = 0;
        if (!live) continue;
        const int k0 = x.lane(s) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = row0 + k0 + c;
          const bool in_band = j >= 1 && j <= j_hi;
          const bool is_col0 = j == 0;
          const bool c3 = (b3[s] >> c) & 1;
          // from_left: the predecessor's CM (b3) or CF, plus one indel.
          const int fl_s = c3 ? am_s[s] : af_s[s];
          const int fl_v = (c3 ? am_v[s] : af_v[s]) + kPkIndel;
          if (is_col0 || !in_band) {
            const int v0 = (i + j + 1) * kPkIndel;
            am_s[s] = kSrcConst;
            am_v[s] = is_col0 ? i * kPkIndel : v0;
            af_s[s] = kSrcConst;
            af_v[s] = is_col0 ? (i + 1) * kPkIndel : v0;
          } else {
            const bool c0 = (b1[s] >> c) & 1;
            if (c0 || !((b0[s] >> c) & 1)) {
              am_s[s] = kSrcConst;
              am_v[s] = c0 ? cm[s][c] : ce[s][c];
            } else {
              am_s[s] = fl_s;
              am_v[s] = fl_v;
            }
            af_s[s] = fl_s;
            af_v[s] = fl_v;
          }
        }
      }
      // Inclusive scan of the maps over the lanes, in lane order.
#pragma unroll
      for (int d = 1; d < L; d *= 2) {
        int pm_s[N], pm_v[N], pf_s[N], pf_v[N];
        for (int s = 0; s < N; ++s) {
          pm_s[s] = am_s[s];
          pm_v[s] = am_v[s];
          pf_s[s] = af_s[s];
          pf_v[s] = af_v[s];
        }
        x.shfl_up(pm_s, d);
        x.shfl_up(pm_v, d);
        x.shfl_up(pf_s, d);
        x.shfl_up(pf_v, d);
        for (int s = 0; s < N; ++s) {
          if (x.lane(s) < d) continue;
          compose_src(am_s[s], am_v[s], pm_s[s], pm_v[s], pf_s[s], pf_v[s]);
          compose_src(af_s[s], af_v[s], pm_s[s], pm_v[s], pf_s[s], pf_v[s]);
        }
      }
      // Each lane's outgoing CM/CF; the previous lane's is the incoming.
      int out_m[N], out_f[N];
      for (int s = 0; s < N; ++s) {
        out_m[s] = apply_src(am_s[s], am_v[s], cm_init, cf_init);
        out_f[s] = apply_src(af_s[s], af_v[s], cm_init, cf_init);
      }
      x.shfl_up(out_m, 1);
      x.shfl_up(out_f, 1);
      for (int s = 0; s < N; ++s) {
        if (x.lane(s) > 0) {
          in_m[s] = out_m[s];
          in_f[s] = out_f[s];
        }
      }
    }
    for (int s = 0; s < N; ++s) {
      if (!live) continue;
      const int k0 = x.lane(s) * C;
      int cm_run = in_m[s], cf_run = in_f[s];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = row0 + k0 + c;
        const bool in_band = j >= 1 && j <= j_hi;
        const bool is_col0 = j == 0;
        const int oob = (i + j + 1) * kPkIndel;
        int cm_new, cf_new;
        if (is_col0) {
          cm_new = i * kPkIndel;
          cf_new = (i + 1) * kPkIndel;
        } else if (!in_band) {
          cm_new = oob;
          cf_new = oob;
        } else {
          const int from_left =
              (((b3[s] >> c) & 1) ? cm_run : cf_run) + kPkIndel;
          const bool c1 = (b1[s] >> c) & 1;
          cm_new = (c1 || !((b0[s] >> c) & 1)) ? (c1 ? cm[s][c] : ce[s][c])
                                               : from_left;
          cf_new = from_left;
        }
        cm[s][c] = cm_new;
        ce[s][c] = is_col0 ? i * kPkIndel : (in_band ? ce[s][c] : oob);
        cm_run = cm_new;
        cf_run = cf_new;
      }
      // The next row's text window (it stops moving past t_max + 8).
      if (i <= t_max + 8)
        tw[s].shift(counts_text(t, t_max, text_ok, row0 + k0 + C - 1));
    }
  }

  // The final cell, with a static-index select (a dynamic index would
  // push the band arrays out of registers).
  const int k_final = t_len - p_len + left;
  const int owner = (k_final >= 0 && k_final < W) ? k_final / C : 0;
  for (int s = 0; s < N; ++s) {
    const int k0 = x.lane(s) * C;
    int sc = kBigNeg, pk = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (k0 + c == k_final) {
        sc = imax(m[s][c], kBigNeg);
        pk = imax(cm[s][c], -1);
      }
    }
    score[s] = sc;
    packed[s] = (t_len == 0 || p_len == 0) ? 0 : pk;
    own[s] = x.lane(s) == owner;
  }
}

// The job on the narrowest tile its warp can share (band_need,
// narrow_width, X::width): the same result as dp_counts_group<W, L>,
// with the off-band cells of a wide tile left out.  need is band_need(t_len,
// p_len), or 0 for a slot with no job.
template <int W, int L, class X>
__host__ __device__ inline void dp_counts_narrow(
    const X& x, int need, const int8_t* t, int t_max, const int8_t* p,
    int p_max, int t_len, int p_len, int (&score)[X::N], int (&packed)[X::N],
    bool (&own)[X::N]) {
  const int w = x.width(narrow_width<W, L>(need));
  if constexpr (W > 16 && 16 % L == 0)
    if (w == 16)
      return dp_counts_group<16, L>(
          x, t, t_max, p, p_max, t_len, p_len, score, packed, own);
  if constexpr (W > 24 && 24 % L == 0)
    if (w == 24)
      return dp_counts_group<24, L>(
          x, t, t_max, p, p_max, t_len, p_len, score, packed, own);
  if constexpr (W > 32 && 32 % L == 0)
    if (w == 32)
      return dp_counts_group<32, L>(
          x, t, t_max, p, p_max, t_len, p_len, score, packed, own);
  dp_counts_group<W, L>(
      x, t, t_max, p, p_max, t_len, p_len, score, packed, own);
}

}  // namespace t4dp
