"""Wrapper of the gap-fill counts kernel (csrc/dp_counts.cu).

``banded_affine_counts`` replaces trust4_tpu's
``banded_affine_counts_pallas`` and ``banded_affine_counts_packed_pallas``
(the Pallas kernel ``_dp_counts_kernel``, trust4_tpu/ops/dp_pallas.py:768)
with one signature: a CPU tensor runs the plain PyTorch version
(ops/dp.py); a CUDA tensor launches the CUDA kernel on the current stream
or raises.  It never falls back from one to the other.

The kernel spreads each job's band over a group of L lanes
(csrc/dp_counts_group.cuh); it is built for several L per band width, and
``CHOICE`` picks the one launched by band width and batch size, from
chip_smoke.py's timings of every instance (PERF.md).  Jobs go to the
kernel sorted by length difference, then query length (``job_order``),
so a warp's jobs share a tile width and its groups end together.
"""

from __future__ import annotations

import numpy as np
import torch

from trust4_tpu_torch.ops.dp import banded_affine_counts_plain

# Band widths the kernel is compiled for (the gap-oracle tiers).
BANDS = (16, 24, 48)

# Kernel launches made by this process (one per call on a CUDA tensor).
LAUNCHES = 0

# Batch-size classes: fewer than SMALL_JOBS jobs, a full gap-oracle tier
# chunk (FULL_CHUNK jobs or more at that band width), or in between.
SMALL_JOBS = 4096
FULL_CHUNK = {16: 65536, 24: 32768, 48: 16384}

# Lanes per job of the instance launched, by (band width, class): the
# fastest back-to-back device time of every instance at chip_smoke.py's
# counts shapes (PERF.md, section 6).  With the tile narrowed to the band
# (dp_lanes.cuh), one lane per job wins the full and partial chunks of
# tiers 0 and 1; tier 2's wider bands and small batches take 8 or 16
# lanes per job.
CHOICE = {
    (16, "small"): 16, (16, "partial"): 1, (16, "chunk"): 1,
    (24, "small"): 8, (24, "partial"): 1, (24, "chunk"): 1,
    (48, "small"): 16, (48, "partial"): 8, (48, "chunk"): 8,
}


def band_widths(t_lens: np.ndarray, p_lens: np.ndarray,
                band_width: int) -> np.ndarray:
    """The tile width of 16, 24, 32 or band_width each job needs, as the
    kernels narrow it (csrc/dp_lanes.cuh band_need, narrow_width, before
    rounding to what L lanes divide)."""
    t = np.asarray(t_lens, np.int64)
    need = np.where(t == 0, 6, 12 + np.abs(t - np.asarray(p_lens, np.int64)))
    out = np.full(need.shape, band_width, np.int64)
    for w in (32, 24, 16):
        if w < band_width:
            out[need <= w] = w
    return out


def job_order(t_lens: torch.Tensor, p_lens: torch.Tensor) -> torch.Tensor:
    """The launch order: jobs by |t_len - p_len| (so a warp's jobs share a
    tile width), then by p_len (so its groups end together)."""
    key = (t_lens - p_lens).abs_().mul_(1 << 12).add_(p_lens)
    return torch.argsort(key, stable=True)


def job_class(n: int, band_width: int) -> str:
    if n < SMALL_JOBS:
        return "small"
    return "chunk" if n >= FULL_CHUNK[band_width] else "partial"


def lanes_for(n: int, band_width: int) -> int:
    """Lanes per job of the instance the wrapper launches for n jobs."""
    return CHOICE[(band_width, job_class(n, band_width))]


def to_device_jobs(t_codes: np.ndarray, t_lens: np.ndarray,
                   p_codes: np.ndarray, p_lens: np.ndarray, device):
    """numpy job arrays (int8 code rows, int32 lengths) -> the kernel's
    contiguous tensors on ``device``."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device
        )

    return (put(t_codes, np.int8), put(t_lens, np.int32),
            put(p_codes, np.int8), put(p_lens, np.int32))


def _check(t_codes, t_lens, p_codes, p_lens, band_width):
    n, t_max = t_codes.shape
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
    if t_max + p_codes.shape[1] + 2 >= (1 << 10):
        raise ValueError("packed count fields overflow")


def banded_affine_counts(
    t_codes: torch.Tensor,  # (N, T) int8
    t_lens: torch.Tensor,  # (N,) int32
    p_codes: torch.Tensor,  # (N, P) int8
    p_lens: torch.Tensor,  # (N,) int32
    band_width: int,
    packed: bool = False,
    events=None,
):
    """(scores (N,), counts (N, 3)) int32, or with ``packed=True`` (N,)
    int32 ``m<<20 | mm<<10 | ind`` — as banded_affine_counts_plain.

    events: on the card, an optional (start, end) pair of CUDA events,
    recorded on the stream just around the kernel launch (the gap
    oracle's per-tier kernel time)."""
    if t_codes.dim() != 2:
        raise ValueError("t_codes must be (N, T)")
    if t_codes.device.type == "cpu":
        return banded_affine_counts_plain(
            t_codes, t_lens, p_codes, p_lens, band_width, packed=packed
        )
    if t_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {t_codes.device}")
    _check(t_codes, t_lens, p_codes, p_lens, band_width)
    n = t_codes.shape[0]
    return launch(t_codes, t_lens, p_codes, p_lens, band_width, packed,
                  lanes_for(n, band_width), job_order(t_lens, p_lens), events)


def launch(t_codes, t_lens, p_codes, p_lens, band_width: int, packed: bool,
           lanes: int, order: torch.Tensor, events=None):
    """One launch of the (band_width, lanes) instance on inputs that
    passed _check, taking the jobs in ``order`` ((N,) int64 on the card, a
    permutation); the outputs are in input order.  The wrapper's own path;
    chip_smoke.py and the card tests call it to time and check every
    instance."""
    global LAUNCHES
    n = t_codes.shape[0]
    dev = t_codes.device
    counts = torch.empty((n,) if packed else (n, 3), dtype=torch.int32,
                         device=dev)
    scores = None if packed else torch.empty(n, dtype=torch.int32,
                                             device=dev)
    if n == 0:
        return counts if packed else (scores, counts)
    if order.dtype != torch.int64 or order.shape != (n,) or \
            order.device != dev:
        raise ValueError("order must be (N,) int64 on the inputs' device")

    from trust4_tpu_torch.ops.build import load

    lib = load("dp_counts")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if events is not None:
            events[0].record()
        rc = lib.t4_dp_counts(
            t_codes.data_ptr(), t_lens.data_ptr(), p_codes.data_ptr(),
            p_lens.data_ptr(), order.data_ptr(), n, t_codes.shape[1],
            p_codes.shape[1], band_width, lanes, int(packed),
            None if scores is None else scores.data_ptr(),
            counts.data_ptr(), stream,
        )
        if events is not None:
            events[1].record()
    if rc != 0:
        raise RuntimeError(f"t4_dp_counts launch failed: cudaError {rc}")
    LAUNCHES += 1
    return counts if packed else (scores, counts)
