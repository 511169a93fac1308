"""Rank-sharded gap-fill DP: the annotator's phase-1 gap batch over a
1-D ("dp",) mesh of ranks.

Port of trust4_tpu/parallel/gap_mesh.py.  Stage 2's phase-1 scored-overlap
batch collects every inter-anchor gap-fill DP job (native
t4o_batch_collect_gaps; reference: SeqSet.hpp:1829-2007).  Here the
unique jobs of each tier shard over the mesh's ``dp`` axis: rank r runs
the counts kernel (ops/dp_counts.py, the hand-written CUDA kernel on the
card, its plain version on the CPU) on its contiguous block of rows,
scatters them into a zero (n_pad, 3) contribution, and an all-reduce SUM
over ``dp`` gives every rank the merged counts.  ``pipeline/annotator.py``
consumes them through the same oracle interface as the single-card path
(t4o_query_scored_batch_oracle), so ``_cdr3.out`` is byte-identical for
every rank count.

The program is SPMD: every rank collected its own batch.  The native
collect runs on several threads and returns the same rows in an order
that differs from run to run, so each rank first puts its batch in one
canonical order (rows sorted), and its counts come back in the rank's own
order.  Before the DP the ranks compare digests of the sorted batch and
of each tier's arrays, and a difference raises
(``mesh.check_agreement``); differing batches are never merged.

Enable in the pipeline with ``TRUST4_TPU_GAP_MESH=<n>`` in a world of n
ranks (``torchrun --nproc-per-node <n> python -m trust4_tpu_torch run``);
the run raises without one.  There is no CPU fallback on this path.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from trust4_tpu_torch.ops.gap_oracle import (
    _TIERS,
    _job_segments,
    tier_of_jobs,
    wait_ready,
)
from trust4_tpu_torch.parallel import mesh as _mesh


def make_mesh(n_ranks: int, device=None):
    """A 1-D ("dp",) mesh over world ranks 0..n_ranks-1 (None on a rank
    outside it; every rank of the world calls it)."""
    return _mesh.make_mesh((n_ranks,), ("dp",), device=device)


def pipeline_mesh(n_ranks: int, device=None):
    """The mesh of ``TRUST4_TPU_GAP_MESH=<n_ranks>``: the whole world,
    which must hold exactly n_ranks ranks (a process outside a world is a
    world of one)."""
    _rank, size = _mesh.world()
    if size != n_ranks:
        raise RuntimeError(
            f"TRUST4_TPU_GAP_MESH={n_ranks} needs torch.distributed "
            f"initialised with world size {n_ranks}, found {size}: start "
            f"the run with torchrun --nproc-per-node {n_ranks}"
        )
    return make_mesh(n_ranks, device=device)


def mesh_tier_counts(mesh, t_codes, p_codes, t_lens, p_lens, *,
                     w: int) -> np.ndarray:
    """(n, 3) int32 gap counts of one tier batch, computed rank by rank
    over the mesh's ``dp`` axis and merged with an all-reduce SUM.

    Rows are padded to n_pad = ceil(n / n_dp) * n_dp (code 5, length 0);
    rank r takes rows [r * n_pad / n_dp, (r + 1) * n_pad / n_dp), and
    every rank returns the merged counts, bit-identical for every rank
    count because each job's DP is integer arithmetic on its own row.
    The DP runs on the mesh's device."""
    from trust4_tpu_torch.ops.dp_counts import (
        banded_affine_counts,
        to_device_jobs,
    )

    tc = np.ascontiguousarray(t_codes, np.int8)
    pc = np.ascontiguousarray(p_codes, np.int8)
    tl = np.ascontiguousarray(t_lens, np.int32)
    pl = np.ascontiguousarray(p_lens, np.int32)
    _mesh.check_agreement(mesh, "dp", tc, pc, tl, pl, np.int32(w))
    n = tc.shape[0]
    n_dp = mesh.size("dp")
    n_pad = -(-max(n, 1) // n_dp) * n_dp
    per = n_pad // n_dp
    lo = mesh.coord("dp") * per
    hi = min(lo + per, n)

    def block(a, fill):
        out = np.full((per,) + a.shape[1:], fill, dtype=a.dtype)
        if hi > lo:
            out[: hi - lo] = a[lo:hi]
        return out

    dev = mesh.device
    jobs = to_device_jobs(block(tc, 5), block(tl, 0), block(pc, 5),
                          block(pl, 0), dev)
    _scores, local = banded_affine_counts(*jobs, w)
    contrib = torch.zeros((n_pad, 3), dtype=torch.int32, device=dev)
    contrib[lo : lo + per] = local
    merged = mesh.all_reduce(contrib, dist.ReduceOp.SUM, "dp")
    return merged[:n].cpu().numpy()


def gap_counts_via_mesh(mesh, nat, query_jobs, gap_jobs: np.ndarray, seqs,
                        n_threads: int = 0) -> np.ndarray:
    """The (n, 3) oracle of a collected gap batch with its DP sharded over
    the mesh: the single-card oracle's tiering and native dedup, each
    tier's unique jobs through ``mesh_tier_counts``, and jobs beyond the
    top tier on the native CPU DP, as trust4_tpu's gap_counts_via_mesh;
    the batch runs in its canonical order (see the module docstring)."""
    import trust4_tpu_torch.align.native as an

    order = np.lexsort(np.asarray(gap_jobs).T[::-1])
    gap_jobs = np.ascontiguousarray(gap_jobs[order], dtype=np.int32)
    _mesh.check_agreement(mesh, "dp", gap_jobs)
    n = len(gap_jobs)
    if n == 0:
        return np.zeros((0, 3), dtype=np.int32)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    # This rank's prewarm (pipeline/run.py started it), joined as the
    # single-card oracle joins it: bounded, its error raised here.
    wait_ready(mesh.device)

    t_lens = gap_jobs[:, 5]
    r_lens = gap_jobs[:, 7]
    tier_of = tier_of_jobs(gap_jobs)
    counts = np.zeros((n, 3), dtype=np.int32)

    dev_all = bool((tier_of >= 0).all())
    dev_idx = None if dev_all else np.nonzero(tier_of >= 0)[0]
    dev_jobs = (
        gap_jobs if dev_all else np.ascontiguousarray(gap_jobs[dev_idx])
    )
    uniq_local, inverse = nat.dedup_gap_jobs(
        query_jobs, dev_jobs, _TIERS[-1][0], n_threads
    )
    uniq_global = uniq_local if dev_all else dev_idx[uniq_local]
    uniq_tier = tier_of[uniq_global]
    uniq_counts = np.zeros((len(uniq_global), 3), dtype=np.int32)

    for ti, (s_cap, w_cap, _chunk) in enumerate(_TIERS):
        usel = np.nonzero(uniq_tier == ti)[0]
        if len(usel) == 0:
            continue
        gsel = uniq_global[usel]
        t_codes, p_codes = nat.emit_gap_codes(
            query_jobs, np.ascontiguousarray(gap_jobs[gsel]), s_cap
        )
        tl = np.minimum(t_lens[gsel], s_cap).astype(np.int32)
        pl = np.minimum(r_lens[gsel], s_cap).astype(np.int32)
        uniq_counts[usel] = mesh_tier_counts(
            mesh, t_codes, p_codes, tl, pl, w=w_cap
        )

    if dev_all:
        counts[:] = uniq_counts[inverse]
    else:
        counts[dev_idx] = uniq_counts[inverse]
        reads = [j[0] if isinstance(j, tuple) else j for j in query_jobs]
        for i in np.nonzero(tier_of < 0)[0]:
            t, p = _job_segments(reads, seqs, gap_jobs[i])
            counts[i] = an.global_alignment_counts(t, p)
    out = np.empty_like(counts)
    out[order] = counts
    return out
