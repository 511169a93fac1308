"""The traceback-bits form of the gap-fill DP: the dirs kernel
(csrc/dp_dirs.cu) and the decoder kernel (csrc/dp_decode.cu).

``banded_affine_dirs`` replaces trust4_tpu's ``banded_affine_dirs_pallas``
(the Pallas kernel ``_dp_dirs_kernel``, trust4_tpu/ops/dp_pallas.py:385)
and its XLA mirror ``banded_affine_dirs_xla``: a CPU tensor runs the plain
PyTorch version (ops/dp.py ``banded_affine_dirs_plain``); a CUDA tensor
launches the CUDA kernel on the current stream or raises.  It never falls
back from one to the other.  The kernel spreads each job's band over a
group of L lanes (csrc/dp_dirs_group.cuh); it is built for every L in
``LANES`` that divides a band width (``INSTANCES``), and ``CHOICE`` picks
the one launched by band width and batch size, from chip_smoke.py's
timings of every instance (PERF.md).  The jobs keep their input order.

``decode_dirs_counts`` replaces the JAX package's batched DFA walker
(dp_pallas.py:583-725, an XLA program) the same way: the decoder kernel
on a CUDA tensor, ``decode_dirs_counts_plain`` (a torch loop over the
walk's steps) on a CPU tensor.  ``dirs_counts`` chains the two.  The gap
oracle itself uses the forward counts kernel (ops/dp_counts.py), which
replaced this pair in the JAX package; the pair stays as ops API, as it
does there.
"""

from __future__ import annotations

import torch

from trust4_tpu_torch.ops import dp_counts, dp_scores
from trust4_tpu_torch.ops.dp import (
    SCORE_GAPEXTEND,
    SCORE_GAPOPEN,
    _CODE_N,
    banded_affine_dirs_plain,
)

# The kernels are compiled for the scores kernel's band widths and take
# the same inputs.
BANDS = dp_scores.BANDS
LANES = (1, 4, 8, 16)
# The (band width, lanes) instances the dirs kernel is built for
# (csrc/dp_dirs_group.cuh T4DP_DIRS_INSTANCES).
INSTANCES = tuple((w, ln) for w in BANDS for ln in LANES if w % ln == 0)

# Kernel launches made by this process (one per call on a CUDA tensor):
# the dirs kernel's and the decoder kernel's.
LAUNCHES = 0
DECODE_LAUNCHES = 0

# Lanes per job of the dirs instance launched, by (band width, class):
# the gap-oracle tiers' widths classed as the counts kernel classes them
# (dp_counts.job_class), W = 32 as the scores kernel does
# (dp_scores.job_class).  Each is the fastest back-to-back device time of
# every instance at chip_smoke.py's dirs shapes (PERF.md, section 6): one
# lane per job wins the full chunks of tiers 0 and 1 and the mixed W=32
# batch, four lanes tier 2's chunks, eight or sixteen the small ones.
CHOICE = {
    (16, "small"): 16, (16, "partial"): 1, (16, "chunk"): 1,
    (24, "small"): 8, (24, "partial"): 8, (24, "chunk"): 1,
    (32, "small"): 16, (32, "large"): 1,
    (48, "small"): 16, (48, "partial"): 4, (48, "chunk"): 4,
}


def job_class(n: int, band_width: int) -> str:
    if band_width in dp_counts.FULL_CHUNK:
        return dp_counts.job_class(n, band_width)
    return dp_scores.job_class(n)


def lanes_for(n: int, band_width: int) -> int:
    """Lanes per job of the instance the wrapper launches for n jobs."""
    return CHOICE[(band_width, job_class(n, band_width))]


def banded_affine_dirs(
    t_codes: torch.Tensor,  # (N, T) int8
    t_lens: torch.Tensor,  # (N,) int32
    p_codes: torch.Tensor,  # (N, P) int8
    p_lens: torch.Tensor,  # (N,) int32
    band_width: int,
    lanes: int = None,
):
    """(scores (N,) int32, dirs (N, P, W) int8), as
    banded_affine_dirs_plain (-2^29 where the final cell lies outside the
    tile).  lanes: the instance to launch (None: ``lanes_for``); one not
    built raises, on a CPU tensor too."""
    if t_codes.dim() != 2:
        raise ValueError("t_codes must be (N, T)")
    if lanes is not None and (band_width, lanes) not in INSTANCES:
        raise ValueError(f"the dirs kernel is not built for L={lanes} at "
                         f"W={band_width}: {INSTANCES}")
    if t_codes.device.type == "cpu":
        return banded_affine_dirs_plain(t_codes, t_lens, p_codes, p_lens,
                                        band_width)
    if t_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {t_codes.device}")
    dp_scores._check(t_codes, t_lens, p_codes, p_lens, band_width)
    if lanes is None:
        lanes = lanes_for(t_codes.shape[0], band_width)
    return launch(t_codes, t_lens, p_codes, p_lens, band_width, lanes)


def launch(t_codes, t_lens, p_codes, p_lens, band_width: int, lanes: int):
    """One launch of the (band_width, lanes) instance on inputs that
    passed the checks.  The wrapper's own path; chip_smoke.py calls it to
    check and time every instance."""
    global LAUNCHES
    n, p_max = t_codes.shape[0], p_codes.shape[1]
    dev = t_codes.device
    scores = torch.empty(n, dtype=torch.int32, device=dev)
    dirs = torch.empty((n, p_max, band_width), dtype=torch.int8, device=dev)
    if n == 0:
        return scores, dirs

    from trust4_tpu_torch.ops.build import load

    lib = load("dp_dirs")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t4_dp_dirs(
            t_codes.data_ptr(), t_lens.data_ptr(), p_codes.data_ptr(),
            p_lens.data_ptr(), n, t_codes.shape[1], p_max, band_width, lanes,
            scores.data_ptr(), dirs.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"t4_dp_dirs launch failed: cudaError {rc}")
    LAUNCHES += 1
    return scores, dirs


def decode_steps(p_max: int, t_max: int) -> int:
    """The walk's cap: the XLA program's fixed step count, enough for
    every job of a tier (each step emits an operation or moves the DFA)."""
    return 2 * (p_max + t_max) + 4


def decode_dirs_counts(dirs, t_codes, t_lens, p_codes, p_lens, *, w, p_max):
    """dirs (N, P, W) int8 from banded_affine_dirs; returns (N, 3) int32
    (match, mismatch, indel) counts of the decoded edit scripts: the
    decoder kernel on a CUDA tensor (or a raise), decode_dirs_counts_plain
    on a CPU tensor."""
    if dirs.device.type == "cpu":
        return decode_dirs_counts_plain(dirs, t_codes, t_lens, p_codes,
                                        p_lens, w=w, p_max=p_max)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    return decode_launch(dirs, t_codes, t_lens, p_codes, p_lens, w=w,
                         p_max=p_max)


def decode_launch(dirs, t_codes, t_lens, p_codes, p_lens, *, w, p_max,
                  walked=None):
    """One launch of the decoder kernel on CUDA tensors: (N, 3) int32
    counts; walked, an (N,) int32 tensor on the card or None, receives
    each job's steps walked."""
    global DECODE_LAUNCHES
    n = dirs.shape[0]
    dp_scores._check(t_codes, t_lens, p_codes, p_lens, w)
    if dirs.dtype != torch.int8 or not dirs.is_contiguous():
        raise TypeError("dirs must be a contiguous int8 tensor")
    if dirs.device != t_codes.device or t_codes.shape[0] != n:
        raise ValueError("dirs and the codes must be (N, ...) on one device")
    stride = dirs.numel() // n if n else 0
    if n and p_max * w > stride:
        raise ValueError(f"p_max*w = {p_max * w} beyond the dirs tensor")
    if walked is not None and (walked.shape != (n,) or
                               walked.dtype != torch.int32 or
                               walked.device != dirs.device):
        raise ValueError("walked must be (N,) int32 on the card")
    counts = torch.empty((n, 3), dtype=torch.int32, device=dirs.device)
    if n == 0:
        return counts

    from trust4_tpu_torch.ops.build import load

    lib = load("dp_decode")
    with torch.cuda.device(dirs.device):
        stream = torch.cuda.current_stream(dirs.device).cuda_stream
        rc = lib.t4_dp_decode(
            dirs.data_ptr(), stride, t_codes.data_ptr(),
            t_lens.data_ptr(), p_codes.data_ptr(), p_lens.data_ptr(), n,
            t_codes.shape[1], p_codes.shape[1], p_max, w,
            decode_steps(p_max, t_codes.shape[1]), counts.data_ptr(),
            None if walked is None else walked.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"t4_dp_decode launch failed: cudaError {rc}")
    DECODE_LAUNCHES += 1
    return counts


def decode_dirs_counts_plain(dirs, t_codes, t_lens, p_codes, p_lens, *, w,
                             p_max):
    """The decoder's plain version: (N, 3) int32 (match, mismatch, indel)
    counts of the edit scripts decoded from dirs (N, P, W) int8.

    A line-for-line port of trust4_tpu's ``decode_dirs_counts``: each job
    walks back from (p_len, t_len) through the DFA states M (0), insert
    run (1) and delete run (2), reading the bits of in-band cells and the
    boundary formulas elsewhere, for a fixed 2*(p_max+T)+4 steps (enough
    for every job; finished jobs stand still).  Zero-length jobs start
    finished.  Runs on the tensors' device, with no host synchronisation
    inside the walk."""
    n = dirs.shape[0]
    dev = dirs.device
    i32 = torch.int32
    go, ge = SCORE_GAPOPEN, SCORE_GAPEXTEND
    go_ge = go + ge

    def where(c, a, b):
        return torch.where(c, a, b).to(i32)

    lent = t_lens.to(i32)
    lenp = p_lens.to(i32)
    left = where(lent < lenp, 5 + (lenp - lent), 5)
    neg_inf = (lent + 1) * (lenp + 1) * go
    sent = neg_inf - 1  # unknown in-band m (can never satisfy an equality)

    flat = dirs.reshape(n, -1)
    if p_max * w > flat.shape[1]:
        raise ValueError(f"p_max*w = {p_max * w} beyond the dirs tensor")
    tmax = t_codes.shape[1]
    pmax_codes = p_codes.shape[1]
    tci = t_codes.to(i32)
    pci = p_codes.to(i32)

    def m_val(i, j):
        # analytic-only cells: row 0 / col 0; neg_inf otherwise
        return where(i == 0, where(j == 0, 0, go + j * go),
                     where(j == 0, go + i * go, neg_inf))

    def e_val(i, j):
        return where(i == 0, where(j == 0, 0, go + (lenp + 1) * go),
                     where(j == 0, go + i * ge, neg_inf))

    def f_val(i, j):
        return where(i == 0, where(j == 0, 0, go + j * ge),
                     where(j == 0, go + i * go, neg_inf))

    def in_band(i, j):
        k = j - i + left
        return (i >= 1) & (j >= 1) & (j <= lent) & (k >= 0) & (k < w)

    def bits_at(i, j):
        k = j - i + left
        idx = torch.clamp((i - 1) * w + k, 0, p_max * w - 1)
        return torch.gather(flat, 1, idx.long()[:, None])[:, 0].to(i32)

    def take(codes, idx, hi):
        return torch.gather(codes, 1,
                            torch.clamp(idx, 0, hi - 1).long()[:, None])[:, 0]

    zero = torch.zeros((), dtype=i32, device=dev)
    one = torch.ones((), dtype=i32, device=dev)
    z = torch.zeros(n, dtype=i32, device=dev)
    # Zero-length jobs produce empty edit scripts (the CPU kernels return
    # out_len 0); start them finished.
    empty = (lent == 0) | (lenp == 0)
    ti, tj = where(empty, 0, lenp), where(empty, 0, lent)
    mat, cm, cmm, cind = z, z, z, z
    # each iteration emits >= 1 op or transitions the DFA; 2*(P+T)+4 bounds
    # the walk for every job in the tier
    for _ in range(decode_steps(p_max, tmax)):
        active = (ti > 0) | (tj > 0)
        ib = in_band(ti, tj)
        bits = where(ib, bits_at(ti, tj), zero)
        b0 = (bits & 1) != 0
        b1 = (bits & 2) != 0
        b2 = (bits & 4) != 0
        b3 = (bits & 8) != 0

        # mat == 0
        fe = torch.where(ib, b0, f_val(ti, tj) >= e_val(ti, tj))
        diag_ok = ib & b1 & (ti > 0) & (tj > 0)
        tc = take(tci, tj - 1, tmax)
        pc = take(pci, ti - 1, pmax_codes)
        eqc = (tc == pc) | (tc == _CODE_N) | (pc == _CODE_N)

        is0 = active & (mat == 0)
        take_diag = is0 & diag_ok
        to_del = is0 & ~diag_ok & fe
        to_ins = is0 & ~diag_ok & ~fe

        # mat == 1 (insert run)
        is1 = active & (mat == 1)
        ti_pos = ti > 0
        mv2 = where((ti - 1 == 0) | (tj == 0) | ~in_band(ti - 1, tj),
                    m_val(ti - 1, tj), sent)
        ev2 = e_val(ti, tj)
        opened2_an = ((ev2 != neg_inf) | (mv2 != sent)) & (mv2 + go_ge == ev2)
        opened2 = torch.where(ib, b2, opened2_an)
        ins_emit = is1
        ins_step = is1 & ti_pos
        ins_close = ins_step & opened2
        ins_to2 = is1 & ~ti_pos

        # mat == 2 (delete run)
        is2 = active & (mat == 2)
        tj_pos = tj > 0
        mv3 = where((ti == 0) | (tj - 1 == 0) | ~in_band(ti, tj - 1),
                    m_val(ti, tj - 1), sent)
        fv3 = f_val(ti, tj)
        opened3_an = ((fv3 != neg_inf) | (mv3 != sent)) & (mv3 + go_ge == fv3)
        opened3 = torch.where(ib, b3, opened3_an)
        del_emit = is2
        del_step = is2 & tj_pos
        del_close = del_step & opened3
        del_to1 = is2 & ~tj_pos

        cm = cm + (take_diag & eqc).to(i32)
        cmm = cmm + (take_diag & ~eqc).to(i32)
        cind = cind + (ins_emit | del_emit).to(i32)

        ti_n = ti - (take_diag | ins_step).to(i32)
        tj_n = tj - (take_diag | del_step).to(i32)
        mat_n = where(
            take_diag | ins_close | del_close, zero,
            where(to_ins | (is1 & ~(ins_close | ins_to2)), one,
                  where(to_del | ins_to2 | (is2 & ~(del_close | del_to1)),
                        one + one, where(del_to1, one, mat))))
        mat = where(active, mat_n, mat)
        ti, tj = ti_n, tj_n
    return torch.stack([cm, cmm, cind], dim=1)


def dirs_counts(t_codes, t_lens, p_codes, p_lens, band_width):
    """(scores (N,), counts (N, 3)) int32 through the traceback-bits path:
    the dirs kernel, then the decoder kernel, on the card (their plain
    versions on a CPU tensor).  The counts equal the forward counts
    kernel's (ops/dp_counts.py) on the same jobs."""
    scores, dirs = banded_affine_dirs(t_codes, t_lens, p_codes, p_lens,
                                      band_width)
    counts = decode_dirs_counts(dirs, t_codes, t_lens, p_codes, p_lens,
                                w=band_width, p_max=p_codes.shape[1])
    return scores, counts
