"""Wrapper of the batched banded scores kernel (csrc/dp_scores.cu).

``banded_affine_scores`` replaces both trust4_tpu's XLA
``dp_batch.banded_affine_scores`` and its Pallas twin
``dp_pallas.banded_affine_scores_pallas`` (the kernel ``_dp_kernel``,
trust4_tpu/ops/dp_pallas.py:55) with one signature: a CPU tensor runs the
plain PyTorch version (ops/dp.py, any band width); a CUDA tensor launches
the CUDA kernel on the current stream or raises.  It never falls back
from one to the other.
"""

from __future__ import annotations

import torch

from trust4_tpu_torch.ops.dp import banded_affine_scores_plain

# Band widths the kernel is compiled for: 32 serves entry, the bench shape
# and the realign round; 16/24/48 are the gap-oracle tiers' widths.
BANDS = (16, 24, 32, 48)

# Kernel launches made by this process (one per call on a CUDA tensor).
LAUNCHES = 0


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
    global LAUNCHES
    if t_codes.dim() != 2:
        raise ValueError("t_codes must be (N, T)")
    if t_codes.device.type == "cpu":
        return banded_affine_scores_plain(t_codes, t_lens, p_codes, p_lens,
                                          band_width)
    if t_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {t_codes.device}")
    _check(t_codes, t_lens, p_codes, p_lens, band_width)
    n = t_codes.shape[0]
    dev = t_codes.device
    scores = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return scores

    from trust4_tpu_torch.ops.build import load

    lib = load("dp_scores")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t4_dp_scores(
            t_codes.data_ptr(), t_lens.data_ptr(), p_codes.data_ptr(),
            p_lens.data_ptr(), n, t_codes.shape[1], p_codes.shape[1],
            band_width, scores.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"t4_dp_scores launch failed: cudaError {rc}")
    LAUNCHES += 1
    return scores
