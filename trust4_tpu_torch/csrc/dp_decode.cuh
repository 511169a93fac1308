// The traceback decoder over the dirs kernel's bits: one job's walk, shared
// by the CUDA kernel (dp_decode.cu) and a host build in the CPU tests.
//
// Replaces the JAX package's batched DFA walker decode_dirs_counts
// (trust4_tpu/ops/dp_pallas.py:583-725, an XLA program), which replays the
// native walker t4_decode_dirs (native/align_kernels.cpp) for a whole batch
// in a fixed-step loop.  Here each job walks on its own from (p_len,
// t_len) through the DFA states M (0), insert run (1) and delete run (2),
// reading the bits of in-band cells (dp_dirs.cuh: b0 F >= E, b1 M from
// the diagonal, b2 E opened from M, b3 F opened from M) and the boundary
// formulas elsewhere, and counts matches, mismatches and indels.  It stops
// at (0, 0), or after the XLA program's `steps` = 2 * (p_max + T) + 4
// iterations, whichever comes first; a finished job stands still there,
// so on any bits, malformed ones included, the counts are the fixed-step
// loop's.  Zero-length jobs start finished.
//
// The header needs no CUDA headers: compiled by g++ with __host__ and
// __device__ defined empty, it runs the same walk on the CPU.

#pragma once

#include <stdint.h>

#include "dp_counts.cuh"  // t4dp's scoring constants, imax, imin

namespace t4dp {

// One job.  dirs: its bits, row i-1 of the band at dirs + (i-1) * W, read
// at flat indices clamped to [0, p_max * W); t (t_max codes) and p
// (p_codes codes): its code rows, read at indices clamped into them, as
// the XLA program's gathers read them (an empty array reads as the pad
// code).  Writes (match, mismatch, indel) to out3 and returns the
// iterations walked (at most steps).
template <int W>
__host__ __device__ inline int decode_dirs_job(const int8_t* dirs,
                                               int p_max, const int8_t* t,
                                               int t_max, const int8_t* p,
                                               int p_codes, int t_len,
                                               int p_len, int steps,
                                               int32_t* out3) {
  const int go = kGapOpen, ge = kGapExtend, go_ge = kGapOpen + kGapExtend;
  const int left = t_len < p_len ? 5 + (p_len - t_len) : 5;
  const int neg_inf = (t_len + 1) * (p_len + 1) * go;
  const int sent = neg_inf - 1;  // unknown in-band m: equals nothing
  const int last = p_max * W - 1;

  // Row 0 / column 0 are analytic; any other cell off the band is neg_inf.
  auto m_val = [&](int i, int j) {
    return i == 0 ? (j == 0 ? 0 : go + j * go)
                  : (j == 0 ? go + i * go : neg_inf);
  };
  auto e_val = [&](int i, int j) {
    return i == 0 ? (j == 0 ? 0 : go + (p_len + 1) * go)
                  : (j == 0 ? go + i * ge : neg_inf);
  };
  auto f_val = [&](int i, int j) {
    return i == 0 ? (j == 0 ? 0 : go + j * ge)
                  : (j == 0 ? go + i * go : neg_inf);
  };
  auto in_band = [&](int i, int j) {
    const int k = j - i + left;
    return i >= 1 && j >= 1 && j <= t_len && k >= 0 && k < W;
  };

  const bool empty = t_len == 0 || p_len == 0;
  int ti = empty ? 0 : p_len, tj = empty ? 0 : t_len, mat = 0;
  int cm = 0, cmm = 0, cind = 0, walked = 0;
  for (; walked < steps && (ti > 0 || tj > 0); ++walked) {
    const bool ib = in_band(ti, tj);
    int bits = 0;
    if (ib && last >= 0)
      bits = dirs[imin(imax((ti - 1) * W + (tj - ti + left), 0), last)];
    if (mat == 0) {
      const bool fe = ib ? (bits & 1) != 0 : f_val(ti, tj) >= e_val(ti, tj);
      if (ib && (bits & 2) && ti > 0 && tj > 0) {
        const int tc = t_max > 0 ? t[imin(imax(tj - 1, 0), t_max - 1)]
                                 : kCodePad;
        const int pc = p_codes > 0 ? p[imin(imax(ti - 1, 0), p_codes - 1)]
                                   : kCodePad;
        if (tc == pc || tc == kCodeN || pc == kCodeN)
          ++cm;
        else
          ++cmm;
        --ti;
        --tj;
      } else {
        mat = fe ? 2 : 1;
      }
    } else if (mat == 1) {  // insert run
      ++cind;
      if (ti > 0) {
        bool opened = (bits & 4) != 0;
        if (!ib) {
          const int mv = (ti - 1 == 0 || tj == 0 || !in_band(ti - 1, tj))
                             ? m_val(ti - 1, tj)
                             : sent;
          const int ev = e_val(ti, tj);
          opened = (ev != neg_inf || mv != sent) && mv + go_ge == ev;
        }
        --ti;
        if (opened) mat = 0;
      } else {
        mat = 2;
      }
    } else {  // delete run
      ++cind;
      if (tj > 0) {
        bool opened = (bits & 8) != 0;
        if (!ib) {
          const int mv = (ti == 0 || tj - 1 == 0 || !in_band(ti, tj - 1))
                             ? m_val(ti, tj - 1)
                             : sent;
          const int fv = f_val(ti, tj);
          opened = (fv != neg_inf || mv != sent) && mv + go_ge == fv;
        }
        --tj;
        if (opened) mat = 0;
      } else {
        mat = 1;
      }
    }
  }
  out3[0] = cm;
  out3[1] = cmm;
  out3[2] = cind;
  return walked;
}

}  // namespace t4dp
