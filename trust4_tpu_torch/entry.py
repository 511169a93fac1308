"""The flagship compute step: candidate prefilter + batched banded scores.

Counterpart of the JAX package's entry point
(``__graft_entry__.entry``): the dense membership prefilter of 256 reads'
k-mer windows (ops/prefilter.py ``prefilter_kernel``) and the banded DP
scores of 256 pairs at band 32 (ops/dp_scores.py, the hand-written CUDA
kernel on the card), masked by the prefilter.  The inputs are the JAX
package's, made by numpy from the same seeds.  The multi-GPU dry run
(``dryrun_multichip``) is still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from trust4_tpu_torch.ops import dp_scores
from trust4_tpu_torch.ops.prefilter import prefilter_kernel


def _make_inputs(batch=256, windows=128, k=9, seed=0):
    rng = np.random.default_rng(seed)
    size = 1 << (2 * k)
    codes = rng.integers(0, size, size=(batch, windows), dtype=np.int32)
    valid = np.ones((batch, windows), dtype=bool)
    fwd = (rng.random(size) < 0.01).astype(np.uint8)
    rc = (rng.random(size) < 0.01).astype(np.uint8)
    return codes, valid, fwd, rc


def step(codes, valid, fwd_table, rc_table, tc, tl, pc, pl):
    """The step as a function of its eight tensors."""
    mask = prefilter_kernel(codes, valid, fwd_table, rc_table, 9, 27)
    scores = dp_scores.banded_affine_scores(tc, tl, pc, pl, 32)
    return torch.where(mask, scores, -(1 << 29)).to(torch.int32)


def entry(device="cuda"):
    """Returns (fn, args): the step and its example inputs as tensors on
    ``device`` ("cuda" by default; "cpu" runs the plain DP)."""
    codes, valid, fwd, rc = _make_inputs()
    rng = np.random.default_rng(1)
    batch = codes.shape[0]
    tc = rng.integers(0, 4, size=(batch, 128), dtype=np.int8)
    pc = rng.integers(0, 4, size=(batch, 128), dtype=np.int8)
    tl = np.full(batch, 120, dtype=np.int32)
    pl = np.full(batch, 118, dtype=np.int32)
    args = tuple(torch.from_numpy(a).to(device)
                 for a in (codes, valid, fwd, rc, tc, tl, pc, pl))
    return step, args
