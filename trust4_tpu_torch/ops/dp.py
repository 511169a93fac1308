"""Plain PyTorch banded affine-gap DP: scores, scores with forward
traceback counts, and scores with traceback decision bits.

``banded_affine_dirs_plain`` (at the end) is the plain version of the
dirs kernel (csrc/dp_dirs.cu), a mirror of trust4_tpu's
``banded_affine_dirs_xla``.

``banded_affine_scores_plain`` is the plain version of the scores kernel
(csrc/dp_scores.cu) and the semantic spec of the final-score DP: a
line-for-line mirror of trust4_tpu's XLA ``banded_affine_scores``
(trust4_tpu/ops/dp_batch.py), to which the Pallas kernel ``_dp_kernel``
is bit-equal inside the band contract ``band_ok``.

``banded_affine_counts_plain`` is the plain version of the gap-fill counts
kernel (csrc/dp_counts.cu): the tests hold it against the JAX package,
the CPU path runs it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card.  It is a line-for-line mirror of
``banded_affine_counts_xla`` (trust4_tpu/ops/dp_pallas.py), itself
bit-equal to the Pallas kernel ``_dp_counts_kernel``: GlobalAlignment semantics (reference:
AlignAlgo.hpp:218-424) with match +2, mismatch -2, gap open -4, extend -1,
N matching any base, band ``left = 5+max(0,p-t)``, ``right = 5+max(0,t-p)``
and the stale ``e[0][j]`` seed; the traceback walker's (match, mismatch,
indel) counts ride forward through the CM/CE/CF recurrences

    CM(i,j) = b1 ? CM(i-1,j-1)+inc : (b0 ? CF(i,j) : CE(i,j))
    CE(i,j) = indel + (b2 ? CM(i-1,j) : CE(i-1,j))
    CF(i,j) = indel + (b3 ? CM(i,j-1) : CF(i,j-1))

as packed ``match<<20 | mismatch<<10 | indel`` int32s.  Band coordinates:
``k in [0, w)``, column ``j = i - left + k``.  The in-row max (F) and the
in-row CM<->CF dependency are solved by log-doubling scans over the band,
as in the JAX version; the CUDA kernel runs the same recurrences as plain
left-to-right sweeps instead, so the two share no scan code.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from trust4_tpu_torch.dna import NUC2NUM_256

SCORE_MATCH = 2
SCORE_MISMATCH = -2
SCORE_GAPOPEN = -4
SCORE_GAPEXTEND = -1

# Code 4 marks N (wildcard); >4 marks padding.
_CODE_N = 4
_CODE_PAD = 5

_BIG_NEG = -(1 << 29)

_PK_MATCH = 1 << 20
_PK_MISMATCH = 1 << 10
_PK_INDEL = 1
_PK_FIELD = (1 << 10) - 1


def encode_for_dp(seqs: List[str], pad_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(codes (B, pad_len) int8, lens (B,) int32): A,C,G,T -> 0..3, N -> 4,
    padding 5; sequences longer than pad_len are cut."""
    batch = len(seqs)
    codes = np.full((batch, pad_len), _CODE_PAD, dtype=np.int8)
    lens = np.zeros(batch, dtype=np.int32)
    table = NUC2NUM_256.copy()
    table[ord("N")] = _CODE_N
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode(), dtype=np.uint8)[:pad_len]
        codes[i, : len(b)] = table[b]
        lens[i] = len(b)
    return codes, lens


def shift_hi_bucket(w: int) -> int:
    """Largest left band the JAX kernels' pre-shifted text covers at band
    width w (dp_pallas._shift_hi_bucket(max(5, w-6))); a job whose left
    band exceeds it reads padding for its whole text row there, so the
    port reproduces that.  Every tier job has left <= w-6."""
    left_max = max(5, w - 6)
    for b in (5, 9, 17, 33, 49, 81, 129):
        if left_max <= b:
            return b
    return left_max


def band_ok(t_lens: np.ndarray, p_lens: np.ndarray,
            band_width: int) -> np.ndarray:
    """Pairs whose reference band fits in the static tile (where the
    Pallas scores kernel equals the XLA function)."""
    diff = np.abs(t_lens.astype(np.int64) - p_lens.astype(np.int64))
    return 11 + diff <= band_width


def banded_affine_scores_plain(
    t_codes: torch.Tensor,  # (N, T) int8
    t_lens: torch.Tensor,  # (N,) int32
    p_codes: torch.Tensor,  # (N, P) int8
    p_lens: torch.Tensor,  # (N,) int32
    band_width: int,
) -> torch.Tensor:
    """(N,) int32 final ``m[p_len][t_len]`` of each pair, bit-equal to
    trust4_tpu's XLA ``banded_affine_scores`` on the same inputs, any band
    width.  Where the final cell lies outside the band (``t_len - p_len >=
    band_width - 5``) the XLA gather reads out of range and returns
    INT32_MIN; so does this function.  Rows beyond ``p_len`` are frozen,
    so zero-length pairs give the column-0 / row-0 boundary values."""
    n, t_max = t_codes.shape
    p_max = p_codes.shape[1]
    w = band_width
    dev = t_codes.device
    i32 = torch.int32
    go, ge = SCORE_GAPOPEN, SCORE_GAPEXTEND
    go_ge = go + ge
    big_neg = _BIG_NEG

    def where(c, a, b):
        return torch.where(c, a, b).to(i32)

    tl = t_lens.to(i32)
    pl = p_lens.to(i32)
    left = where(tl < pl, 5 + (pl - tl), 5)
    right = where(tl > pl, 5 + (tl - pl), 5)
    neg_inf = ((tl + 1) * (pl + 1) * go)[:, None]  # (N, 1)

    k_idx = torch.arange(w, dtype=i32, device=dev)[None, :]  # (1, W)
    j0 = k_idx - left[:, None]
    in_t0 = (j0 >= 0) & (j0 <= tl[:, None])
    m0 = where(j0 == 0, 0, where(j0 > 0, go + j0 * go, big_neg))
    # Reference quirk: e[0][j] is seeded with the stale loop variable
    # lenp+1 (AlignAlgo.hpp:271).
    e0 = where(j0 == 0, 0,
               where(j0 > 0, go + (pl[:, None] + 1) * go, big_neg))
    m = where(in_t0, m0, neg_inf)
    e = where(in_t0, e0, neg_inf)

    # The XLA gather clips the text column into [0, t_max-1]; with an
    # empty text no cell is in band, so a pad column stands in.
    if t_max == 0:
        t_codes = torch.full((n, 1), _CODE_PAD, dtype=torch.int8, device=dev)
    tci = t_codes.long()
    t_hi = max(t_max - 1, 0)
    pci = p_codes.to(i32)
    bn_col = torch.full((n, 1), big_neg, dtype=i32, device=dev)

    def shift(x):  # band neighbour k+1 of the previous row
        return torch.cat([x[:, 1:], bn_col], dim=1)

    for i in range(1, p_max + 1):
        j_row = i - left[:, None] + k_idx
        in_band = (
            (j_row >= 1)
            & (j_row <= tl[:, None])
            & (j_row <= i + right[:, None])
        )
        in_dp_row = (i <= pl)[:, None]

        tj = torch.gather(tci, 1, torch.clamp(j_row - 1, 0, t_hi).long())
        pi = pci[:, i - 1 : i]
        eq = (tj == pi) | (tj == _CODE_N) | (pi == _CODE_N)
        sub = where(eq, SCORE_MATCH, SCORE_MISMATCH)

        m_up = shift(m)
        e_new = torch.maximum(shift(e) + ge, m_up + go_ge)
        diag = m + sub

        bound_m = go + i * go
        base = torch.maximum(diag, e_new)
        base = where(j_row == 0, bound_m, base)
        base = where(in_band | (j_row == 0), base, big_neg)

        # Horizontal gaps: exclusive running max over the band; the F
        # seed at column 0 skips the gap open (host.py _affine_fill).
        t_val = where(j_row == 0, bound_m, base + go) + k_idx * (-ge)
        run = torch.cummax(t_val, dim=1).values
        f_new = torch.cat([bn_col, run[:, :-1]], dim=1) - k_idx * (-ge)

        m_new = torch.maximum(base, f_new)
        m_new = where(in_band & in_dp_row, m_new, neg_inf)
        m_new = where((j_row == 0) & in_dp_row, bound_m, m_new)
        e_keep = where(in_band & in_dp_row, e_new, neg_inf)

        m = where(in_dp_row, m_new, m)
        e = where(in_dp_row, e_keep, e)

    k_final = (tl - pl + left)[:, None].long()
    inside = (k_final >= 0) & (k_final < w)
    score = torch.gather(m, 1, torch.clamp(k_final, 0, w - 1))
    return where(inside, score, torch.iinfo(i32).min)[:, 0]


def unpack_counts(packed: torch.Tensor) -> torch.Tensor:
    """(N,) packed int32 -> (N, 3) int32 (match, mismatch, indel)."""
    return torch.stack(
        [(packed >> 20) & _PK_FIELD, (packed >> 10) & _PK_FIELD,
         packed & _PK_FIELD],
        dim=1,
    )


def banded_affine_counts_plain(
    t_codes: torch.Tensor,  # (N, T) int8
    t_lens: torch.Tensor,  # (N,) int32
    p_codes: torch.Tensor,  # (N, P) int8
    p_lens: torch.Tensor,  # (N,) int32
    band_width: int,
    packed: bool = False,
):
    """Returns (scores (N,), counts (N, 3)) int32 — the banded DP score and
    the traceback's (match, mismatch, indel) totals — or, with
    ``packed=True``, (N,) int32 ``m<<20 | mm<<10 | ind``.  Bit-equal to
    trust4_tpu's banded_affine_counts_xla / _pallas on the same inputs.
    Packed-field bound: requires t_max + p_max + 2 < 1024."""
    n, t_max = t_codes.shape
    p_max = p_codes.shape[1]
    w = band_width
    assert t_max + p_max + 2 < (1 << 10), "packed count fields overflow"
    dev = t_codes.device
    i32 = torch.int32
    go, ge = SCORE_GAPOPEN, SCORE_GAPEXTEND
    go_ge = go + ge
    big_neg, pk_i = _BIG_NEG, _PK_INDEL

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    def where(c, a, b):
        return torch.where(c, a, b).to(i32)

    tl = t_lens.to(i32)
    pl = p_lens.to(i32)
    left = where(tl < pl, 5 + (pl - tl), 5)
    right = where(tl > pl, 5 + (tl - pl), 5)
    neg_inf = ((tl + 1) * (pl + 1) * go)[:, None]  # (N, 1)
    # Text column read at band cell k of row i: the JAX kernels' window
    # ts[min(i-1, t_max+8) + k] of the text pre-shifted right by `left`
    # (dynamic_slice clamps the start); column t_max of t_ext is padding.
    t_ext = torch.cat(
        [t_codes.to(i32), full((n, 1), _CODE_PAD)], dim=1
    )
    text_ok = (left <= shift_hi_bucket(w))[:, None]
    pci = p_codes.to(i32)

    k_col = torch.arange(w, dtype=i32, device=dev)[None, :]  # (1, W)
    j0 = k_col - left[:, None]
    in_t0 = (j0 >= 0) & (j0 <= tl[:, None])
    m0 = where(j0 == 0, 0, where(j0 > 0, go + j0 * go, big_neg))
    e0 = where(j0 == 0, 0,
               where(j0 > 0, go + (pl[:, None] + 1) * go, big_neg))
    m = where(in_t0, m0, neg_inf)
    e = where(in_t0, e0, neg_inf)
    # Row-0 counts: CM(0,j) = CF(0,j) = j indels, CE(0,j) = j+1 indels.
    cm = where(j0 >= 0, j0 * pk_i, 0)
    ce = where(j0 > 0, (j0 + 1) * pk_i, 0)

    def shift_up(a, fill):  # band neighbour k+1
        return torch.cat([a[:, 1:], fill], dim=1)

    bn_fill = full((n, 1), big_neg)

    for i in range(1, p_max + 1):
        j_row = i - left[:, None] + k_col
        in_band = (
            (j_row >= 1)
            & (j_row <= tl[:, None])
            & (j_row <= i + right[:, None])
        )
        in_dp_row = (i <= pl)[:, None]

        x = min(i - 1, t_max + 8) + k_col - left[:, None]
        x = where(text_ok & (x >= 0) & (x < t_max), x, t_max)
        tj = torch.gather(t_ext, 1, x.long())
        pi = pci[:, i - 1 : i]
        eq = (tj == pi) | (tj == _CODE_N) | (pi == _CODE_N)
        sub = where(eq, SCORE_MATCH, SCORE_MISMATCH)

        m_up = shift_up(m, bn_fill)
        e_new = torch.maximum(shift_up(e, bn_fill) + ge, m_up + go_ge)
        diag = m + sub

        bound_m = go + i * go
        base = torch.maximum(diag, e_new)
        base = where(j_row == 0, bound_m, base)
        base = where(in_band | (j_row == 0), base, big_neg)

        t_val = where(j_row == 0, bound_m, base + go) + k_col * (-ge)
        run = t_val
        s = 1
        while s < w:
            run = torch.maximum(
                run, torch.cat([full((n, s), big_neg), run[:, :-s]], dim=1)
            )
            s *= 2
        f_new = torch.cat([bn_fill, run[:, :-1]], dim=1) - k_col * (-ge)

        m_fin = torch.maximum(base, f_new)
        m_stored = where(in_band & in_dp_row, m_fin, neg_inf)
        m_stored = where((j_row == 0) & in_dp_row, bound_m, m_stored)
        e_stored = where(in_band & in_dp_row, e_new, neg_inf)

        b0 = f_new >= e_new
        b1 = diag == m_fin
        b2 = m_up + go_ge == e_new
        fill = where((i - left[:, None]) == 1, bound_m, big_neg)
        m_left = torch.cat([fill, m_stored[:, :-1]], dim=1)
        b3 = m_left + go_ge == f_new

        # ---- counts ----
        # The k = w-1 read of row i-1 is the analytic value at (i-1,
        # j_up): row 0 if i == 1, else out of band (i-1 + j_up + 1).
        j_up = ((i - 1) - left + w)[:, None]
        cm_fill = (j_up if i == 1 else (i - 1) + j_up + 1) * pk_i
        ce_fill = (j_up + 1 if i == 1 else (i - 1) + j_up + 1) * pk_i
        cm_up = shift_up(cm, cm_fill)
        ce_up = shift_up(ce, ce_fill)
        ce_row = pk_i + where(b2, cm_up, ce_up)

        inc = where(eq, _PK_MATCH, _PK_MISMATCH)
        cm_diag = cm + inc

        # Per-column transfer maps for the in-row (CM, CF) recurrence.
        # src: 0 = predecessor's M, 1 = predecessor's F, 2 = constant.
        c0 = b1 | ~b0
        reset_val = where(b1, cm_diag, ce_row)
        src_m = where(c0, 2, where(b3, 0, 1))
        val_m = where(c0, reset_val, pk_i)
        src_f = where(b3, 0, 1)
        val_f = full((n, w), pk_i)

        # Column 0 and out-of-band cells reset to the walker's analytic
        # continuation.
        is_col0 = j_row == 0
        col0_m = i * pk_i
        col0_f = (i + 1) * pk_i
        oob = (i + j_row + 1) * pk_i
        outb = ~in_band & ~is_col0
        src_m = where(is_col0 | outb, 2, src_m)
        val_m = where(is_col0, col0_m, where(outb, oob, val_m))
        src_f = where(is_col0 | outb, 2, src_f)
        val_f = where(is_col0, col0_f, where(outb, oob, val_f))

        # Log-doubling composition (inclusive over k; identity fill).
        s = 1
        while s < w:
            zf = full((n, s), 0)
            sm_s = torch.cat([zf, src_m[:, :-s]], dim=1)
            vm_s = torch.cat([zf, val_m[:, :-s]], dim=1)
            sf_s = torch.cat([zf + 1, src_f[:, :-s]], dim=1)
            vf_s = torch.cat([zf, val_f[:, :-s]], dim=1)
            pick_m = where(src_m == 0, sm_s, sf_s)
            pickv_m = where(src_m == 0, vm_s, vf_s)
            pick_f = where(src_f == 0, sm_s, sf_s)
            pickv_f = where(src_f == 0, vm_s, vf_s)
            src_m, val_m, src_f, val_f = (
                where(src_m == 2, 2, pick_m),
                where(src_m == 2, val_m, pickv_m + val_m),
                where(src_f == 2, 2, pick_f),
                where(src_f == 2, val_f, pickv_f + val_f),
            )
            s *= 2

        # Evaluate at the k = -1 initial state, column i-left-1.
        j_init = (i - left - 1)[:, None]
        cm_i = where(j_init == 0, i * pk_i,
                     torch.clamp_min(i + j_init + 1, 0) * pk_i)
        cf_i = where(j_init == 0, (i + 1) * pk_i,
                     torch.clamp_min(i + j_init + 1, 0) * pk_i)
        cm_scan = where(src_m == 2, val_m,
                        where(src_m == 0, cm_i, cf_i) + val_m)

        cm_store = where(in_band, cm_scan, oob)
        cm_store = where(is_col0, col0_m, cm_store)
        ce_store = where(in_band, ce_row, oob)
        ce_store = where(is_col0, col0_m, ce_store)

        m = where(in_dp_row, m_stored, m)
        e = where(in_dp_row, e_stored, e)
        cm = where(in_dp_row, cm_store, cm)
        ce = where(in_dp_row, ce_store, ce)

    k_final = (tl - pl + left)[:, None]
    hit = k_col == k_final
    scores = where(hit, m, big_neg).amax(dim=1)
    packed_c = where(hit, cm, -1).amax(dim=1)
    # Zero-length jobs produce empty edit scripts.
    packed_c = where((tl == 0) | (pl == 0), 0, packed_c)
    if packed:
        return packed_c
    return scores, unpack_counts(packed_c)


def banded_affine_dirs_plain(
    t_codes: torch.Tensor,  # (N, T) int8
    t_lens: torch.Tensor,  # (N,) int32
    p_codes: torch.Tensor,  # (N, P) int8
    p_lens: torch.Tensor,  # (N,) int32
    band_width: int,
):
    """Returns (scores (N,) int32, dirs (N, P, W) int8): the banded DP
    score and, for every band cell of every query row up to P, the four
    traceback decision bits

        bit0: f >= e                 bit1: m[i-1][j-1] + sub == m[i][j]
        bit2: m[i-1][j] + GO+GE == e  bit3: m[i][j-1] + GO+GE == f

    A line-for-line mirror of trust4_tpu's ``banded_affine_dirs_xla``
    (bit-equal to the Pallas ``_dp_dirs_kernel``): the text is read as the
    counts DP reads it (pre-shift bucket, window start clamp), rows beyond
    p_len keep computing bits from the frozen m/e, and a final cell
    outside the tile scores -2^29."""
    n, t_max = t_codes.shape
    p_max = p_codes.shape[1]
    w = band_width
    dev = t_codes.device
    i32 = torch.int32
    go, ge = SCORE_GAPOPEN, SCORE_GAPEXTEND
    go_ge = go + ge
    big_neg = _BIG_NEG

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    def where(c, a, b):
        return torch.where(c, a, b).to(i32)

    tl = t_lens.to(i32)
    pl = p_lens.to(i32)
    left = where(tl < pl, 5 + (pl - tl), 5)
    right = where(tl > pl, 5 + (tl - pl), 5)
    neg_inf = ((tl + 1) * (pl + 1) * go)[:, None]  # (N, 1)
    # The pre-shifted text window ts[min(i-1, t_max+8) + k] (as in
    # banded_affine_counts_plain); column t_max of t_ext is padding.
    t_ext = torch.cat([t_codes.to(i32), full((n, 1), _CODE_PAD)], dim=1)
    text_ok = (left <= shift_hi_bucket(w))[:, None]
    pci = p_codes.to(i32)

    k_col = torch.arange(w, dtype=i32, device=dev)[None, :]  # (1, W)
    j0 = k_col - left[:, None]
    in_t0 = (j0 >= 0) & (j0 <= tl[:, None])
    m0 = where(j0 == 0, 0, where(j0 > 0, go + j0 * go, big_neg))
    e0 = where(j0 == 0, 0,
               where(j0 > 0, go + (pl[:, None] + 1) * go, big_neg))
    m = where(in_t0, m0, neg_inf)
    e = where(in_t0, e0, neg_inf)

    bn_fill = full((n, 1), big_neg)

    def shift_up(a):  # band neighbour k+1
        return torch.cat([a[:, 1:], bn_fill], dim=1)

    dirs = torch.empty((n, p_max, w), dtype=torch.int8, device=dev)
    for i in range(1, p_max + 1):
        j_row = i - left[:, None] + k_col
        in_band = (
            (j_row >= 1)
            & (j_row <= tl[:, None])
            & (j_row <= i + right[:, None])
        )
        in_dp_row = (i <= pl)[:, None]

        x = min(i - 1, t_max + 8) + k_col - left[:, None]
        x = where(text_ok & (x >= 0) & (x < t_max), x, t_max)
        tj = torch.gather(t_ext, 1, x.long())
        pi = pci[:, i - 1 : i]
        eq = (tj == pi) | (tj == _CODE_N) | (pi == _CODE_N)
        sub = where(eq, SCORE_MATCH, SCORE_MISMATCH)

        e_new = torch.maximum(shift_up(e) + ge, shift_up(m) + go + ge)
        diag = m + sub

        bound_m = go + i * go
        base = torch.maximum(diag, e_new)
        base = where(j_row == 0, bound_m, base)
        base = where(in_band | (j_row == 0), base, big_neg)

        # horizontal-gap recurrence: exclusive running max over the band
        t_val = where(j_row == 0, bound_m, base + go) + k_col * (-ge)
        run = t_val
        s = 1
        while s < w:
            run = torch.maximum(
                run, torch.cat([full((n, s), big_neg), run[:, :-s]], dim=1)
            )
            s *= 2
        f_new = torch.cat([bn_fill, run[:, :-1]], dim=1) - k_col * (-ge)

        m_fin = torch.maximum(base, f_new)
        m_stored = where(in_band & in_dp_row, m_fin, neg_inf)
        m_stored = where((j_row == 0) & in_dp_row, bound_m, m_stored)
        e_stored = where(in_band & in_dp_row, e_new, neg_inf)

        b0 = (f_new >= e_new).to(i32)
        b1 = (diag == m_fin).to(i32)
        b2 = (shift_up(m) + go_ge == e_new).to(i32)
        fill = where((i - left[:, None]) == 1, bound_m, big_neg)
        m_left = torch.cat([fill, m_stored[:, :-1]], dim=1)
        b3 = (m_left + go_ge == f_new).to(i32)
        dirs[:, i - 1, :] = (b0 | (b1 << 1) | (b2 << 2) | (b3 << 3)).to(
            torch.int8)

        m = where(in_dp_row, m_stored, m)
        e = where(in_dp_row, e_stored, e)

    k_final = (tl - pl + left)[:, None]
    scores = where(k_col == k_final, m, big_neg).amax(dim=1)
    return scores, dirs
