"""Read-realignment round on one card: the pipeline's batched
read-vs-contig matching as one device program.

Port of trust4_tpu/parallel/realign_mesh.py (l.39-235), the multi-chip
form of the pipeline's dense realignment sweeps — the annotator's
AssignRead pass over every assembled read (reference:
Annotator.cpp:813-854, SeqSet.hpp:4632-4701) and the batch-match phase of
round-based assembly (SURVEY.md §7.1): every read is k-mer-matched and
then banded-DP-scored against the current contig set, and accepted reads'
bases accumulate into the per-contig posWeight coverage tensor.

This slice runs the round on one card, which is the JAX program on a
(1, 1) mesh: its ``pmax`` over the contig axis and ``psum`` over the read
axis are identities.  The process-group (multi-GPU) form is still to be
ported (ROADMAP.md).  Step 3's DP goes through
``ops/dp_scores.banded_affine_scores``: the hand-written CUDA kernel on
the card, its plain PyTorch version on the CPU.

Reads are processed in chunks.  Step 2 gathers a (C, chunk, W) int32
position tensor (C contigs, W = read windows), and its masks and diffs
are as large; ``default_chunk`` sizes ``chunk`` so that the gather stays
under ``_GATHER_BYTES``.  Every output is per read, or an integer sum over
reads, so chunked results are bit-equal to one pass.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from trust4_tpu_torch.ops import dp_scores
from trust4_tpu_torch.ops.dp import encode_for_dp
from trust4_tpu_torch.ops.prefilter import (
    build_membership_tables,
    encode_reads,
    prefilter_kernel,
)

_NEG = -(1 << 30)

# Budget of one chunk's (C, chunk, W) int32 contig-position gather; with
# its bool hit mask and int32 diffs a chunk's step 2 holds about 2.5x this.
_GATHER_BYTES = 1 << 29


def default_chunk(n_contigs: int, n_windows: int) -> int:
    """Reads per pass: the most whose (C, chunk, W) gather fits the
    budget."""
    return max(1, _GATHER_BYTES // (4 * max(n_contigs, 1) * n_windows))


def build_contig_position_tables(
    contigs: List[str], k: int, pad_to: int
) -> np.ndarray:
    """(C, 4^k) int32 first-occurrence position of each k-mer per contig
    (-1 = absent).  The device-side replacement for KmerIndex postings over
    the (small, per-round-static) contig set."""
    from trust4_tpu_torch.ops.kmer import kmer_codes

    size = 1 << (2 * k)
    tables = np.full((pad_to, size), -1, dtype=np.int32)
    for c, s in enumerate(contigs):
        if len(s) < k:
            continue
        codes, valid = kmer_codes(s, k)
        # first occurrence wins: np.unique returns each code's first index
        uniq, first = np.unique(codes[valid], return_index=True)
        tables[c, uniq] = np.flatnonzero(valid)[first]
    return tables


def encode_contigs(contigs: List[str], pad_to: int,
                   max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    codes, lens = encode_for_dp(list(contigs), max_len)
    out_c = np.full((pad_to, max_len), 5, dtype=codes.dtype)
    out_l = np.zeros(pad_to, dtype=np.int32)
    out_c[: len(contigs)] = codes
    out_l[: len(contigs)] = lens
    return out_c, out_l


def _round_chunk(read_codes, read_valid, read_dp, read_len, fwd_tab, rc_tab,
                 ctg_pos, ctg_codes, ctg_lens, pw, *, k, hit_len, window,
                 band):
    """One chunk of reads against every contig (the JAX round body on a
    (1, 1) mesh).  Adds the chunk's coverage into ``pw`` in place and
    returns (cand, scores, ids) for the chunk."""
    dev = read_codes.device
    i32 = torch.int32
    c = ctg_pos.shape[0]
    lc = ctg_codes.shape[1]

    # 1. candidate prefilter against the germline tables.
    cand = prefilter_kernel(read_codes, read_valid, fwd_tab, rc_tab, k,
                            hit_len)

    # 2. k-mer hit counting + diagonal estimate against each contig.
    pos = ctg_pos[:, read_codes.long()]  # (C, b, W)
    hit = (pos >= 0) & read_valid[None, :, :]
    hits_cnt = hit.sum(dim=2, dtype=i32)  # (C, b)
    widx = torch.arange(read_codes.shape[1], dtype=i32, device=dev)
    diag = torch.where(hit, pos - widx, 1 << 30)
    del pos, hit
    offset = torch.clamp(diag.amin(dim=2), min=0)  # (C, b)
    del diag

    # Best contig per read by (hit count, lower id): hits < 2^14, ids <
    # 2^16, so the packed keys are unique per contig.
    ctg_ids = torch.arange(c, dtype=i32, device=dev)[:, None]
    alive = (ctg_lens > 0)[:, None]
    key = torch.where(alive, hits_cnt, -1) * (1 << 16) + (
        (1 << 16) - 1 - ctg_ids
    )
    best = key.argmax(dim=0)  # (b,)
    best_hits = hits_cnt.gather(0, best[None, :])[0]
    best_off = offset.gather(0, best[None, :])[0]
    best_id = best.to(i32)

    # 3. banded DP of each read against its best contig's window.
    w_idx = best_off[:, None] + torch.arange(window, dtype=i32,
                                             device=dev)[None, :]
    win_codes = ctg_codes[best].gather(1, torch.clamp(w_idx, 0, lc - 1).long())
    win_len = torch.clamp(ctg_lens[best] - best_off, 0, window)
    pad_mask = torch.arange(window, device=dev)[None, :] < win_len[:, None]
    win_codes = torch.where(pad_mask, win_codes, 5).to(torch.int8)
    ok = cand & (best_hits > 0) & ((win_len - read_len).abs() + 11 <= band)
    zero = torch.zeros((), dtype=i32, device=dev)
    scores = dp_scores.banded_affine_scores(
        win_codes.contiguous(), torch.where(ok, win_len, zero).to(i32),
        read_dp, torch.where(ok, read_len, zero).to(i32), band,
    )
    scores = torch.where(ok, scores, _NEG).to(i32)
    ids = torch.where(ok, best_id, -1).to(i32)

    # 5. posWeight accumulation for the reads a contig won.
    win_here = ok & (scores > _NEG)
    rd = read_dp.to(i32)
    base_idx = torch.clamp(rd, 0, 3)  # (b, L)
    l_ar = torch.arange(rd.shape[1], dtype=i32, device=dev)[None, :]
    l_pos = best_off[:, None] + l_ar
    valid_pos = (
        win_here[:, None]
        & (l_ar < read_len[:, None])
        & (l_pos < lc)
        & (rd < 4)
    )
    pw.index_put_(
        (best[:, None].expand_as(l_pos), torch.clamp(l_pos, 0, lc - 1).long(),
         base_idx.long()),
        valid_pos.to(i32), accumulate=True,
    )
    return cand, scores, ids


def realign_round(reads: List[str], contigs: List[str], germline: List[str],
                  *, k: int = 9, hit_len: int = 17, band: int = 32,
                  device="cuda", chunk: Optional[int] = None):
    """One batched realign round of ``reads`` against ``contigs`` on
    ``device`` ("cuda" by default: the card, raising without one; "cpu":
    the same torch program and the plain DP on the host).  Returns host
    numpy (cand_mask (B,) bool, scores (B,) int32, contig_ids (B,) int32,
    posWeight (C, Lc, 4) int32, n_candidates), with B = max(len(reads), 1)
    and C = max(len(contigs), 1) — bit-identical to trust4_tpu's
    ``sharded_realign_round`` on a (1, 1) mesh.

    ``chunk`` is the reads per pass (default ``default_chunk``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"realign_round(device={device!r}) but torch.cuda.is_available() "
            "is False; pass device='cpu'"
        )

    n_b = max(len(reads), 1)
    n_c = max(len(contigs), 1)
    reads = list(reads) + [""] * (n_b - len(reads))
    max_rd = max(max((len(r) for r in reads), default=1), k)
    n_win = max_rd - k + 1

    codes, valid = encode_reads(reads, k, n_win)
    read_dp, read_len = encode_for_dp(reads, max_rd)
    fwd, rc = build_membership_tables(germline, k)
    lc = -(-max(max((len(c) for c in contigs), default=1), max_rd) // 8) * 8
    ctg_pos = build_contig_position_tables(contigs, k, n_c)
    ctg_codes, ctg_lens = encode_contigs(contigs, n_c, lc)
    window = max_rd + 16
    chunk = min(chunk or default_chunk(n_c, n_win), n_b)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fwd_t, rc_t, pos_t = put(fwd), put(rc), put(ctg_pos)
    ctg_codes_t, ctg_lens_t = put(ctg_codes), put(ctg_lens)
    pw = torch.zeros((n_c, lc, 4), dtype=torch.int32, device=dev)
    outs = []
    for s in range(0, n_b, chunk):
        sl = slice(s, s + chunk)
        outs.append(_round_chunk(
            put(codes[sl]), put(valid[sl]), put(read_dp[sl]),
            put(read_len[sl].astype(np.int32)), fwd_t, rc_t, pos_t,
            ctg_codes_t, ctg_lens_t, pw, k=k, hit_len=hit_len, window=window,
            band=band,
        ))
    cand, scores, ids = (torch.cat(x).cpu().numpy() for x in zip(*outs))
    return cand, scores, ids, pw.cpu().numpy(), int(cand.sum())
