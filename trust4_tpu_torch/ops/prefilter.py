"""Device candidate-read prefilters for extraction.

Port of trust4_tpu/ops/prefilter.py.  The reference tests every read
against the V/D/J/C k-mer index one k-mer at a time on the CPU
(SeqSet.hpp:3144-3327, HasHitInSet; FastqExtractor.cpp:129).  Two
conservative device formulations (both strict supersets of the exact
filter, so the candidate set stays bit-identical after the exact host
pass on survivors):

* ``prefilter_kernel``: dense 4^k membership gather + k-window coverage
  reduction — the cheapest sweep, the first step of ``entry`` and of the
  realign round;
* ``seq_count_prefilter_kernel``: fixed-width postings gather + the
  reference's own diagonal-cluster rule (hits grouped per (strand, seq)
  by sorted diffs with adjacent gaps <= radius, SeqSet.hpp:889-919) —
  the longest cluster bounds any exact chain from above.

Both were jnp programs in the JAX package, not Pallas kernels, so their
port is plain PyTorch: on a CUDA tensor each torch call runs on the card.
The table builders are numpy, copied here (the JAX module imports jax).

Selectivity (the JAX package's finding, VALIDATION.md): at k=9 the
germline DB populates much of the code space and gene families share
most k-mers, so random bulk 100-mers pass the cluster test at the
default hitLen=23; it becomes selective at long-read thresholds
(hitLen>=50).  The bulk extraction therefore uses the native exact filter
(pipeline/extract_native.py); ``--tpuPrefilter`` puts the cluster kernel
first.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from trust4_tpu_torch.ops.kmer import kmer_codes

# Per-process totals of TpuPrefilter calls, read by chip_smoke.py: read
# batches, reads tested, reads that passed.
STATS = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(batches=0, reads=0, passed=0)


reset_stats()


def _revcomp_index(k: int) -> np.ndarray:
    """(4^k,) uint64: the reverse-complement code of every code."""
    codes = np.arange(1 << (2 * k), dtype=np.uint64)
    rc = np.zeros(codes.shape, dtype=np.uint64)
    for i in range(k):
        base = (codes >> np.uint64(2 * i)) & np.uint64(3)
        rc |= (np.uint64(3) - base) << np.uint64(2 * (k - 1 - i))
    return rc


def build_membership_tables(seqs: List[str], k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Forward and reverse-complement membership tables over the 4^k code
    space (host-side, one-time; the DB is static)."""
    fwd = np.zeros(1 << (2 * k), dtype=np.uint8)
    for s in seqs:
        if len(s) < k:
            continue
        codes, valid = kmer_codes(s, k)
        fwd[codes[valid]] = 1
    return fwd, fwd[_revcomp_index(k)]


def encode_reads(reads: List[str], k: int, pad_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack reads into (B, pad_len) window-code + validity arrays.

    Window w of a read covers read[w:w+k]; invalid (N-containing or padded)
    windows get valid=0.
    """
    batch = len(reads)
    codes = np.zeros((batch, pad_len), dtype=np.int32)
    valid = np.zeros((batch, pad_len), dtype=bool)
    for i, r in enumerate(reads):
        if len(r) < k:
            continue
        c, v = kmer_codes(r, k)
        n = min(len(c), pad_len)
        codes[i, :n] = c[:n].astype(np.int64) & 0x7FFFFFFF
        valid[i, :n] = v[:n]
    return codes, valid


def _total_cover(hits: torch.Tensor, k: int) -> torch.Tensor:
    """Covered read positions per read: positions p with a hit window w,
    w <= p <= w+k-1, from a running count over the last k windows."""
    b, w = hits.shape
    csum = torch.cumsum(hits.to(torch.int32), dim=1, dtype=torch.int32)
    csum_pad = torch.cat(
        [torch.zeros((b, 1), dtype=torch.int32, device=hits.device), csum],
        dim=1,
    )  # (B, W+1)
    pos = torch.arange(w + k - 1, device=hits.device)
    hi = torch.clamp(pos + 1, max=w)
    lo = torch.clamp(pos - k + 1, min=0)
    cnt = csum_pad[:, hi] - csum_pad[:, lo]
    return (cnt > 0).sum(dim=1)


def prefilter_kernel(
    codes: torch.Tensor,  # (B, W) int32 window codes
    valid: torch.Tensor,  # (B, W) bool
    fwd_table: torch.Tensor,  # (4^k,) uint8
    rc_table: torch.Tensor,  # (4^k,) uint8
    k: int,
    hit_len_required: int,
) -> torch.Tensor:
    """(B,) bool candidate mask: True when either strand's total hit
    coverage reaches hit_len_required (conservative superset of the exact
    filter)."""
    idx = codes.long()
    fwd_cov = _total_cover((fwd_table[idx] != 0) & valid, k)
    rc_cov = _total_cover((rc_table[idx] != 0) & valid, k)
    return torch.maximum(fwd_cov, rc_cov) >= hit_len_required


def build_posting_tables(seqs: List[str], k: int, pmax: int = 16):
    """Fixed-width postings layout for the device per-seq-count filter.

    For every 4^k code: up to ``pmax`` postings packed as
    ``seq_id * 2**16 + (offset + 1)`` (0 = empty) plus an overflow flag
    for codes with more postings (handled as conservative wildcards).
    A second table with the same layout is indexed by the
    reverse-complement code, serving the RC-strand scan.
    """
    size = 1 << (2 * k)
    post = np.zeros((size, pmax), dtype=np.int32)
    fill = np.zeros(size, dtype=np.int32)
    overflow = np.zeros(size, dtype=bool)
    for sid, s in enumerate(seqs):
        if len(s) < k:
            continue
        codes, valid = kmer_codes(s, k)
        for w in range(len(codes)):
            if not valid[w]:
                continue
            c = int(codes[w])
            n = fill[c]
            if n < pmax:
                post[c, n] = sid * 65536 + (w + 1)
                fill[c] = n + 1
            else:
                overflow[c] = True
    rc = _revcomp_index(k)
    return post, overflow, post[rc], overflow[rc]


def seq_count_prefilter_kernel(
    codes: torch.Tensor,  # (B, W) int32 window codes
    valid: torch.Tensor,  # (B, W) bool
    post: torch.Tensor,  # (4^k, PMAX) int32 packed postings
    overflow: torch.Tensor,  # (4^k,) bool
    rc_post: torch.Tensor,
    rc_overflow: torch.Tensor,
    k: int,
    hit_len_required: int,
    radius: int = 10,
) -> torch.Tensor:
    """(B,) bool candidate mask via the reference's own diagonal-cluster
    rule: HasHitInSet chains live inside one (strand, seq) group of hits
    whose diffs (readOffset - seqOffset), sorted, have adjacent gaps
    <= radius (SeqSet.hpp:889-919).  The longest such run per read bounds
    any exact chain, so maxrun >= n_min is a strict superset of the exact
    filter.  Overflow-code windows count as wildcards toward every group.

    Memory: the (B, W*PMAX) int32 keys, their sort and cummax take about
    16 * 4 * W bytes per read and temporary, ~1 GB at B=16384, W=120."""
    # Minimum hits any passing chain must contain: n hits cover at most
    # (n-1)*(k-1) + k read positions (runs break beyond k-1 spacing), so
    # coverage >= hitLen forces n >= (hitLen-k)/(k-1) + 1.
    if hit_len_required <= k:
        need = 1
    else:
        need = -(-(hit_len_required - k) // (k - 1)) + 1

    dev = codes.device
    idx = codes.long()
    w_idx = torch.arange(codes.shape[1], dtype=torch.int32,
                         device=dev)[None, :, None]

    def strand_max_run(tbl, ovf):
        entries = tbl[idx]  # (B, W, PMAX) int32
        live = (entries > 0) & valid[:, :, None]
        seqs = entries >> 16
        offs = (entries & 0xFFFF) - 1
        diff = w_idx - offs + 2048  # keep positive
        key = seqs * (1 << 13) + diff  # diff < 8192
        key = torch.where(live, key, 1 << 30).to(torch.int32)
        b, w, p = key.shape
        flat = torch.sort(key.reshape(b, w * p), dim=1).values
        fseq = flat >> 13
        fdiff = flat & ((1 << 13) - 1)
        prev_seq = torch.cat(
            [torch.full((b, 1), -1, dtype=torch.int32, device=dev),
             fseq[:, :-1]], dim=1,
        )
        prev_diff = torch.cat(
            [torch.full((b, 1), -(1 << 12), dtype=torch.int32, device=dev),
             fdiff[:, :-1]], dim=1,
        )
        start = (fseq != prev_seq) | (fdiff - prev_diff > radius)
        pos = torch.arange(w * p, dtype=torch.int32, device=dev)[None, :]
        last_start = torch.cummax(
            torch.where(start, pos, -1).to(torch.int32), dim=1
        ).values
        runlen = torch.where(flat < (1 << 30), pos - last_start + 1, 0)
        wild = (ovf[idx] & valid).sum(dim=1)
        return runlen.amax(dim=1) + wild

    best = torch.maximum(
        strand_max_run(post, overflow), strand_max_run(rc_post, rc_overflow)
    )
    return best >= need


class NumpyPrefilter:
    """The membership sweep of ``prefilter_kernel`` in numpy on the host
    (no device, no transfer): the same conservative superset of the exact
    filter, for callers without torch tensors.  No extraction path calls
    it; extraction uses the native exact filter or ``TpuPrefilter``."""

    def __init__(self, ref_seqs: List[str], k: int = 9, hit_len_required: int = 27):
        self.k = k
        self.hit_len_required = hit_len_required
        self.fwd_table, self.rc_table = build_membership_tables(ref_seqs, k)

    def __call__(self, reads: List[str], pad_len: int = 512) -> np.ndarray:
        from trust4_tpu_torch.ops.encode import pack_reads, window_codes_batch

        k = self.k
        mat = pack_reads(reads, max(pad_len, k))
        codes, valid = window_codes_batch(mat, k)
        fwd_hit = (self.fwd_table[codes] != 0) & valid
        rc_hit = (self.rc_table[codes] != 0) & valid

        def total_cover(hits):
            x = hits.astype(np.int32)
            csum = np.cumsum(x, axis=1)
            csum_pad = np.concatenate(
                [np.zeros((x.shape[0], 1), np.int32), csum], axis=1
            )
            W = x.shape[1]
            P = W + k - 1
            hi = np.minimum(np.arange(P) + 1, W)
            lo = np.maximum(np.arange(P) - k + 1, 0)
            cnt = csum_pad[:, hi] - csum_pad[:, lo]
            return np.sum(cnt > 0, axis=1)

        cov = np.maximum(total_cover(fwd_hit), total_cover(rc_hit))
        return cov >= self.hit_len_required


class TpuPrefilter:
    """Stateful wrapper: build the posting tables once on ``device``,
    stream read batches through the diagonal-cluster kernel (the tighter
    of the two conservative formulations).  The name is the JAX
    package's, kept with its ``--tpuPrefilter`` flag.  ``device="cuda"``
    (the default) runs on the card and raises without one; ``"cpu"`` runs
    the same torch program on the host."""

    def __init__(self, ref_seqs: List[str], k: int = 9, hit_len_required: int = 27,
                 radius: int = 10, device="cuda"):
        self.k = k
        self.hit_len_required = hit_len_required
        self.radius = radius
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TpuPrefilter(device={device!r}) but "
                "torch.cuda.is_available() is False; pass device='cpu'"
            )
        self.tables = tuple(
            torch.from_numpy(a).to(self.device)
            for a in build_posting_tables(ref_seqs, k)
        )  # post, overflow, rc_post, rc_overflow

    def __call__(self, reads: List[str], pad_len: int = 512) -> np.ndarray:
        """(len(reads),) bool numpy mask.  Reads are packed to ``pad_len``
        rounded up to a power of two of at least 64, as the JAX package
        does, so a read longer than ``pad_len`` is cut at the same place.
        (The JAX package's ``fixed_batch`` padded batches to one shape for
        XLA's compile cache; PyTorch has none, so it is not taken.)"""
        from trust4_tpu_torch.ops.encode import pack_reads, window_codes_batch

        mat = pack_reads(reads, max(64, 1 << (pad_len - 1).bit_length()))
        codes, valid = window_codes_batch(mat, self.k)
        mask = seq_count_prefilter_kernel(
            torch.from_numpy(codes).to(self.device),
            torch.from_numpy(valid).to(self.device),
            *self.tables, self.k, self.hit_len_required, self.radius,
        ).cpu().numpy()
        STATS["batches"] += 1
        STATS["reads"] += len(reads)
        STATS["passed"] += int(mask.sum())
        return mask
