"""Wrapper of the batched banded scores kernel (csrc/dp_scores.cu).

``banded_affine_scores`` replaces both trust4_tpu's XLA
``dp_batch.banded_affine_scores`` and its Pallas twin
``dp_pallas.banded_affine_scores_pallas`` (the kernel ``_dp_kernel``,
trust4_tpu/ops/dp_pallas.py:55) with one signature: a CPU tensor runs the
plain PyTorch version (ops/dp.py, any band width); a CUDA tensor launches
the CUDA kernel on the current stream or raises.  It never falls back
from one to the other.

The kernel spreads each job's band over a group of L lanes
(csrc/dp_scores_group.cuh); it is built for several L per band width, and
``CHOICE`` picks the one launched by band width and batch size, from
chip_smoke.py's timings of every instance (PERF.md).  Jobs go to the
kernel sorted by length difference, then query length
(``dp_counts.job_order``), so a warp's jobs share a tile width and its
groups end together.
"""

from __future__ import annotations

import torch

from trust4_tpu_torch.ops.dp import banded_affine_scores_plain
from trust4_tpu_torch.ops.dp_counts import job_order

# Band widths the kernel is compiled for: 32 serves entry, the bench shape
# and the realign round; 16/24/48 are the gap-oracle tiers' widths.
BANDS = (16, 24, 32, 48)

# Kernel launches made by this process (one per call on a CUDA tensor).
LAUNCHES = 0

# Batch-size classes: fewer than SMALL_JOBS pairs (entry's step, a realign
# pass) or more (bench.py's launch).
SMALL_JOBS = 4096

# Lanes per job of the instance launched, by (band width, class): the
# fastest back-to-back device time of every instance at chip_smoke.py's
# scores shapes (PERF.md, section 6; a small batch at W=32 is timed on
# entry's 256 pairs and a realign pass's 2,300, and takes the realign
# pass's choice, 11 launches to entry's one).
CHOICE = {
    (16, "small"): 16, (16, "large"): 1,
    (24, "small"): 8, (24, "large"): 1,
    (32, "small"): 8, (32, "large"): 1,
    (48, "small"): 8, (48, "large"): 8,
}


def job_class(n: int) -> str:
    return "small" if n < SMALL_JOBS else "large"


def lanes_for(n: int, band_width: int) -> int:
    """Lanes per job of the instance the wrapper launches for n pairs."""
    return CHOICE[(band_width, job_class(n))]


def _check(t_codes, t_lens, p_codes, p_lens, band_width):
    n = t_codes.shape[0]
    if p_codes.dim() != 2 or p_codes.shape[0] != n:
        raise ValueError(f"p_codes shape {tuple(p_codes.shape)} vs n={n}")
    if t_lens.shape != (n,) or p_lens.shape != (n,):
        raise ValueError("t_lens and p_lens must be (N,)")
    for x, dt in ((t_codes, torch.int8), (p_codes, torch.int8),
                  (t_lens, torch.int32), (p_lens, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"expected {dt}, got {x.dtype}")
        if x.device != t_codes.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if band_width not in BANDS:
        raise ValueError(f"band_width {band_width} not in {BANDS}")
    if max(n, t_codes.shape[1], p_codes.shape[1]) >= (1 << 31):
        raise ValueError("shapes beyond int32")


def banded_affine_scores(
    t_codes: torch.Tensor,  # (N, T) int8
    t_lens: torch.Tensor,  # (N,) int32
    p_codes: torch.Tensor,  # (N, P) int8
    p_lens: torch.Tensor,  # (N,) int32
    band_width: int,
) -> torch.Tensor:
    """(N,) int32 final ``m[p_len][t_len]`` per pair, as
    banded_affine_scores_plain (INT32_MIN where the final cell lies
    outside the band)."""
    if t_codes.dim() != 2:
        raise ValueError("t_codes must be (N, T)")
    if t_codes.device.type == "cpu":
        return banded_affine_scores_plain(t_codes, t_lens, p_codes, p_lens,
                                          band_width)
    if t_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {t_codes.device}")
    _check(t_codes, t_lens, p_codes, p_lens, band_width)
    return launch(t_codes, t_lens, p_codes, p_lens, band_width,
                  lanes_for(t_codes.shape[0], band_width),
                  job_order(t_lens, p_lens))


def launch(t_codes, t_lens, p_codes, p_lens, band_width: int, lanes: int,
           order: torch.Tensor) -> torch.Tensor:
    """One launch of the (band_width, lanes) instance on inputs that
    passed _check, taking the pairs in ``order`` ((N,) int64 on the card,
    a permutation); the scores are in input order.  The wrapper's own
    path; chip_smoke.py and the card tests call it to time and check
    every instance."""
    global LAUNCHES
    n = t_codes.shape[0]
    dev = t_codes.device
    scores = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return scores
    if order.dtype != torch.int64 or order.shape != (n,) or \
            order.device != dev:
        raise ValueError("order must be (N,) int64 on the inputs' device")

    from trust4_tpu_torch.ops.build import load

    lib = load("dp_scores")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t4_dp_scores(
            t_codes.data_ptr(), t_lens.data_ptr(), p_codes.data_ptr(),
            p_lens.data_ptr(), order.data_ptr(), n, t_codes.shape[1],
            p_codes.shape[1], band_width, lanes, scores.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"t4_dp_scores launch failed: cudaError {rc}")
    LAUNCHES += 1
    return scores
