// The kernel lab's interleaved scores sweep: G jobs on one group of L
// lanes, the arithmetic of dp_lab.cu's inter kernel and of its host build
// in the CPU tests.
//
// Replaces the Pallas kernel _dp_kernel_inter (tools/dp_kernel_lab.py:51:
// G independent 128-lane groups side by side, each recurrence step emitted
// for every group before the next step).  On the card: the group sweep of
// the scores kernel (dp_scores_group.cuh, one job's band over L lanes,
// C = W/L cells a lane) carrying G jobs at once.  A lane holds the C cells
// of each of its G jobs (G x C cells of m and e, G text windows), and each
// step of a row, the exchanges included, is issued for job 0..G-1 before
// the next step: the G shuffles of a step are independent, so their
// latencies overlap, and so do the G dependency chains of a lane's cell
// sweep.  Each job's arithmetic is dp_scores_group's, so every job's
// score is bit for bit dp_scores_job's (banded_affine_scores_plain).  It
// is a copy of that sweep with a job index, not dp_scores_group itself
// made generic over G: written so, the scores kernel (G = 1) compiled to
// other SASS than its own, and its code must not move for the lab.
//
// The lab's other kernel, the ablation kernel, needs no code here: it is
// the scores kernel's own sweep with dp_scores_group's FLAGS.
//
// The header needs no CUDA headers: compiled by g++ with __host__ and
// __device__ defined empty (HostLanes), it runs the same arithmetic on the
// CPU.

#pragma once

#include <stdint.h>

#include "dp_scores_group.cuh"

// The lab kernels' instances (dp_lab.cu), at the lab's band width W = 32
// and every lane count L of the scores kernel's W = 32 instances
// (T4DP_SCORES_INSTANCES): the ablation kernel as (L, FLAGS) for no flag
// and each flag alone, the interleaved kernel as (L, G).
#define T4DP_ABL_INSTANCES(X)                                           \
  X(1, 0) X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(1, 16) X(1, 32) X(1, 64)    \
  X(4, 0) X(4, 1) X(4, 2) X(4, 4) X(4, 8) X(4, 16) X(4, 32) X(4, 64)    \
  X(8, 0) X(8, 1) X(8, 2) X(8, 4) X(8, 8) X(8, 16) X(8, 32) X(8, 64)    \
  X(16, 0) X(16, 1) X(16, 2) X(16, 4) X(16, 8) X(16, 16) X(16, 32)      \
  X(16, 64)
#define T4DP_INTER_INSTANCES(X) \
  X(1, 2) X(1, 4) X(4, 2) X(4, 4) X(8, 2) X(8, 4) X(16, 2) X(16, 4)

namespace t4dp {

// G jobs on one group's lanes.  t[g], p[g]: job g's code rows, with
// t_len[g] = p_len[g] = 0 for a slot with no job.  The group loops to its
// longest job's rows (its warp's on the card, X::rows); each job stops at
// its own.  score[g][s], own[g][s] as dp_scores_group's for job g.
template <int W, int L, int G, class X>
__host__ __device__ inline void dp_inter_group(
    const X& x, const int8_t* const (&t)[G], int t_max,
    const int8_t* const (&p)[G], int p_max, const int (&t_len)[G],
    const int (&p_len)[G], int (&score)[G][X::N], bool (&own)[G][X::N]) {
  static_assert(W % L == 0, "L must divide W");
  constexpr int C = W / L;
  constexpr int N = X::N;
  const int go = kGapOpen, ge = kGapExtend, go_ge = kGapOpen + kGapExtend;

  int left[G], right[G], neg_inf[G], rows[G];
  int m[G][N][C], e[G][N][C];
  TextWindow<C> tw[G][N];
  int rows_max = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    left[g] = t_len[g] < p_len[g] ? 5 + (p_len[g] - t_len[g]) : 5;
    right[g] = t_len[g] > p_len[g] ? 5 + (t_len[g] - p_len[g]) : 5;
    // (t+1)(p+1)*GO with int32 wraparound, as XLA computes it.
    neg_inf[g] = (int)((unsigned)(t_len[g] + 1) * (unsigned)(p_len[g] + 1) *
                       (unsigned)go);
    rows[g] = imin(p_len[g], p_max);
    rows_max = imax(rows_max, rows[g]);
    for (int s = 0; s < N; ++s) {
      const int k0 = x.lane(s) * C;
      tw[g][s].clear();
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j0 = k0 + c - left[g];
        const bool in_t0 = j0 >= 0 && j0 <= t_len[g];
        m[g][s][c] = in_t0 ? (j0 == 0 ? 0 : go + j0 * go) : neg_inf[g];
        e[g][s][c] =
            in_t0 ? (j0 == 0 ? 0 : go + (p_len[g] + 1) * go) : neg_inf[g];
        tw[g][s].set(c, text_at(t[g], t_max, j0));
      }
    }
  }

  const int loop_rows = x.rows(rows_max);
  for (int i = 1; i <= loop_rows; ++i) {
    const int bound_m = go + i * go;
    bool live[G];
    int pi[G], j_base[G], j_hi[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      live[g] = i <= rows[g];
      pi[g] = live[g] ? p[g][i - 1] : kCodePad;
      j_base[g] = i - left[g];
      j_hi[g] = imin(t_len[g], i + right[g]);
    }

    // 1. The cell after each lane's last, for every job: 2G shuffles.
    int up_m[G][N], up_e[G][N];
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int s = 0; s < N; ++s) {
        up_m[g][s] = m[g][s][0];
        up_e[g][s] = e[g][s][0];
      }
    if constexpr (L > 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x.shfl_down(up_m[g], 1);
        x.shfl_down(up_e[g], 1);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int s = 0; s < N; ++s)
        if (x.lane(s) == L - 1) {
          up_m[g][s] = kBigNeg;
          up_e[g][s] = kBigNeg;
        }

    // 2. Each job's cell sweep: E, the diagonal, the largest F candidate.
    int run[G][N];
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int s = 0; s < N; ++s) {
        run[g][s] = kInt32Min;
        if (!live[g]) continue;
        const int k0 = x.lane(s) * C;
        const bool p_is_n = pi[g] == kCodeN;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = k0 + c;
          const int j = j_base[g] + k;
          const bool in_band = j >= 1 && j <= j_hi[g];
          const bool is_col0 = j == 0;
          const int tj = tw[g][s].get(c);
          const bool eq = tj == pi[g] || tj == kCodeN || p_is_n;
          const int m_up = c + 1 < C ? m[g][s][c + 1] : up_m[g][s];
          const int e_up = c + 1 < C ? e[g][s][c + 1] : up_e[g][s];
          const int e_new = imax(e_up + ge, m_up + go_ge);
          const int diag = m[g][s][c] + (eq ? kMatch : kMismatch);
          const int base = is_col0 ? bound_m
                                   : (in_band ? imax(diag, e_new) : kBigNeg);
          run[g][s] =
              imax(run[g][s], (is_col0 ? bound_m : base + go) + k * (-ge));
          m[g][s][c] = diag;
          e[g][s][c] = in_band ? e_new : neg_inf[g];
        }
      }

    // 3. The F running max over the lanes, log2(L) + 1 shuffle steps of G
    // shuffles each; then each job's finishing pass and window shift.
    if constexpr (L > 1) {
#pragma unroll
      for (int d = 1; d < L; d *= 2) {
        int o[G][N];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          for (int s = 0; s < N; ++s) o[g][s] = run[g][s];
          x.shfl_up(o[g], d);  // lanes below d get their own value back
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
          for (int s = 0; s < N; ++s) run[g][s] = imax(run[g][s], o[g][s]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) x.shfl_up(run[g], 1);
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int s = 0; s < N; ++s) {
        if (!live[g]) continue;
        const int k0 = x.lane(s) * C;
        int r = x.lane(s) == 0 ? kInt32Min : run[g][s];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = k0 + c;
          const int j = j_base[g] + k;
          const bool in_band = j >= 1 && j <= j_hi[g];
          const bool is_col0 = j == 0;
          const int base =
              is_col0 ? bound_m
                      : (in_band ? imax(m[g][s][c], e[g][s][c]) : kBigNeg);
          const int f_new = k == 0 ? kBigNeg : r - k * (-ge);
          r = imax(r, (is_col0 ? bound_m : base + go) + k * (-ge));
          m[g][s][c] =
              is_col0 ? bound_m : (in_band ? imax(base, f_new) : neg_inf[g]);
        }
        tw[g][s].shift(text_at(t[g], t_max, j_base[g] + k0 + C - 1));
      }
  }

  // Each job's final cell, with a static-index select.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int k_final = t_len[g] - p_len[g] + left[g];
    const int owner = (k_final >= 0 && k_final < W) ? k_final / C : 0;
    for (int s = 0; s < N; ++s) {
      const int k0 = x.lane(s) * C;
      int sc = kInt32Min;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (k0 + c == k_final) sc = m[g][s][c];
      score[g][s] = sc;
      own[g][s] = x.lane(s) == owner;
    }
  }
}

// The G jobs on the narrowest tile the warp can share: need is the
// largest band_need among the group's jobs (0: none), and X::width takes
// the widest narrow_width over the warp, as dp_scores_narrow does for one
// job a group.
template <int W, int L, int G, class X>
__host__ __device__ inline void dp_inter_narrow(
    const X& x, int need, const int8_t* const (&t)[G], int t_max,
    const int8_t* const (&p)[G], int p_max, const int (&t_len)[G],
    const int (&p_len)[G], int (&score)[G][X::N], bool (&own)[G][X::N]) {
  const int w = x.width(narrow_width<W, L>(need));
  if constexpr (W > 16 && 16 % L == 0)
    if (w == 16)
      return dp_inter_group<16, L, G>(x, t, t_max, p, p_max, t_len, p_len,
                                      score, own);
  if constexpr (W > 24 && 24 % L == 0)
    if (w == 24)
      return dp_inter_group<24, L, G>(x, t, t_max, p, p_max, t_len, p_len,
                                      score, own);
  if constexpr (W > 32 && 32 % L == 0)
    if (w == 32)
      return dp_inter_group<32, L, G>(x, t, t_max, p, p_max, t_len, p_len,
                                      score, own);
  dp_inter_group<W, L, G>(x, t, t_max, p, p_max, t_len, p_len, score, own);
}

}  // namespace t4dp
