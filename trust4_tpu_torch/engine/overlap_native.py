"""ctypes loader for the native overlap engine (libt4overlap.so).

The engine mirrors the dynamic k-mer index and runs the overlap query chain
(GetHitsFromRead -> SortHits -> GetOverlapsFromHits -> VJ rescue)
bit-identically to engine/overlap.py; the similarity/extension pass stays
in Python.  Set TRUST4_TPU_NATIVE=0 to disable, TRUST4_TPU_OVERLAP_CHECK=1
to run native and host side by side and assert equality.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

from trust4_tpu_torch.utils.nativebuild import ensure_built, native_dir

_LIB = None
_TRIED = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p_mod = ctypes.POINTER(ctypes.c_double)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TRUST4_TPU_NATIVE", "1") == "0":
        return None
    # make rebuilds a library older than its sources, so the symbols
    # registered below are never behind them.
    try:
        lib = ctypes.CDLL(ensure_built("libt4overlap.so"))
        _register_protos(lib)
        _LIB = lib
        return _LIB
    except (OSError, subprocess.CalledProcessError, AttributeError):
        pass
    import sys as _sys

    print(
        "[trust4-tpu] WARNING: native overlap engine unavailable "
        "(libt4overlap.so failed to build or load); falling back "
        "to the 10-100x slower Python host path.  Run "
        f"`make -C {native_dir()}`.",
        file=_sys.stderr,
        flush=True,
    )
    return None


def _register_protos(lib):
    c_int = ctypes.c_int
    c_char_p = ctypes.c_char_p
    lib.t4o_create.restype = ctypes.c_void_p
    lib.t4o_create.argtypes = [c_int]
    lib.t4o_destroy.argtypes = [ctypes.c_void_p]
    lib.t4o_set_kmer_len.argtypes = [ctypes.c_void_p, c_int]
    lib.t4o_set_consider_barcode.argtypes = [ctypes.c_void_p, c_int]
    lib.t4o_clear.argtypes = [ctypes.c_void_p]
    lib.t4o_build_from_read.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_int, c_int, ctypes.c_int64, c_int,
    ]
    lib.t4o_build_batch_mt.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, _i64p, c_int, c_int, c_int,
    ]
    lib.t4o_remove_from_read.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_int, c_int, ctypes.c_int64, c_int,
    ]
    lib.t4o_update_from_read.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_int, ctypes.c_int64, c_int,
        c_int, c_int,
    ]
    lib.t4o_resync_seq.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_char_p, c_int, c_int, c_int,
        ctypes.c_int64,
    ]
    lib.t4o_query.restype = c_int
    lib.t4o_query.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_int, c_int, c_int, c_int,
        _u8p, c_int, _i8p, _i32p, _i32p, _u8p, c_int, c_int, c_int, c_int,
        c_int, _i32p, c_int, _i32p, c_int, _i32p,
    ]
    lib.t4o_stats.argtypes = [ctypes.c_void_p, _i64p]
    # scored-query engine (full GetOverlapsFromRead + annotate0 + assign)
    _f64p = ctypes.POINTER(ctypes.c_double)
    c_dbl = ctypes.c_double
    lib.t4o_reg_seq.argtypes = [
        ctypes.c_void_p, c_int, c_int, c_int, c_char_p, c_int, c_char_p,
        c_int, _i32p, c_int,
    ]
    lib.t4o_clear_seqs.argtypes = [ctypes.c_void_p]
    lib.t4o_reg_count.restype = c_int
    lib.t4o_reg_count.argtypes = [ctypes.c_void_p]
    lib.t4o_destroy_registry.argtypes = [ctypes.c_void_p]
    lib.t4o_query_scored.restype = c_int
    lib.t4o_query_scored.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_int, c_int, c_int, c_int, _u8p,
        c_int, c_int, c_int, c_int, c_dbl, c_dbl, c_dbl, _i32p, _f64p, c_int,
    ]
    lib.t4o_annotate0.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_int, c_int, c_int, c_int,
        c_dbl, c_dbl, c_dbl, c_int, _i32p, _f64p,
    ]
    lib.t4o_annotate0_batch.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, c_int, c_int, c_int, c_int, c_int,
        c_int, c_dbl, c_dbl, c_dbl, c_int, _i32p, _f64p,
    ]
    lib.t4o_assign_read.restype = c_int
    lib.t4o_assign_read.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_int, c_int, c_int, c_int, c_int,
        c_int, c_dbl, c_dbl, c_dbl, _i32p, _f64p,
    ]
    lib.t4o_assign_batch.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, _i32p, c_int, c_int, c_int,
        c_int, c_int, c_int, c_dbl, c_dbl, c_dbl, _i32p, _f64p, _i32p,
    ]
    lib.t4o_assign_batch_ol.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, _i32p, _i32p, c_int, c_int, c_int,
        c_int, c_int, c_int, c_dbl, c_dbl, c_dbl, _i32p, _f64p, _i32p,
    ]
    lib.t4o_query_scored_batch.restype = c_int
    lib.t4o_query_scored_batch.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, _i32p, _i32p, _i32p, c_int,
        c_int, c_int, c_int, c_int, c_int, c_dbl, c_dbl, c_dbl, _i32p,
        _f64p, c_int, _i64p,
    ]
    lib.t4o_batch_collect_gaps.restype = c_int
    lib.t4o_batch_collect_gaps.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, _i32p, _i32p, _i32p, c_int,
        c_int, c_int, c_int, c_int, c_int, c_dbl, c_dbl, c_dbl, _i32p,
        c_int,
    ]
    lib.t4o_query_scored_batch_oracle.restype = c_int
    lib.t4o_query_scored_batch_oracle.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, _i32p, _i32p, _i32p, c_int,
        c_int, c_int, c_int, c_int, c_int, c_dbl, c_dbl, c_dbl, _i32p,
        _i32p, c_int, _i32p, _f64p, c_int, _i64p,
    ]
    lib.t4o_emit_gap_codes.restype = None
    lib.t4o_emit_gap_codes.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, c_int, c_int, _i8p, _i8p,
    ]
    lib.t4o_prof_dump7.restype = None
    lib.t4o_prof_dump7.argtypes = [ctypes.c_void_p, _f64p]
    lib.t4s_pull_meta_all.restype = None
    lib.t4s_pull_meta_all.argtypes = [ctypes.c_void_p, _i64p]
    lib.t4o_dedup_gap_jobs.restype = c_int
    lib.t4o_dedup_gap_jobs.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, ctypes.c_int64, c_int,
        c_int, _i32p, _i32p,
    ]
    lib.t4o_gap_counts_cpu.restype = None
    lib.t4o_gap_counts_cpu.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, _i64p, ctypes.c_int64,
        c_int, _i32p,
    ]
    lib.t4s_pull_data_all.restype = None
    lib.t4s_pull_data_all.argtypes = [
        ctypes.c_void_p, c_char_p, c_char_p, _i32p, _u8p,
    ]
    lib.t4o_annotate0_collect_gaps.restype = c_int
    lib.t4o_annotate0_collect_gaps.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, c_int, c_int, c_int, c_int, c_int,
        c_int, c_dbl, c_dbl, c_dbl, c_int, _i32p, c_int,
    ]
    lib.t4o_annotate0_batch_oracle.restype = None
    lib.t4o_annotate0_batch_oracle.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, c_int, c_int, c_int, c_int, c_int,
        c_int, c_dbl, c_dbl, c_dbl, c_int, _i32p, _i32p, c_int, _i32p,
        _f64p,
    ]
    lib.t4o_reg_seq_cdr.restype = None
    lib.t4o_reg_seq_cdr.argtypes = [
        ctypes.c_void_p, c_int, c_int, c_int, c_int, c_int,
    ]
    lib.t4o_annotate2_batch.restype = c_int
    lib.t4o_annotate2_batch.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, c_int, _i32p, _i64p, _i32p, _f64p,
        _i64p, c_int, c_int, c_int, c_int, c_int, c_int, c_dbl, c_dbl,
        c_dbl, _i32p, _i32p, _f64p, _i32p, _f64p, _i32p, _f64p, _i64p,
        c_int,
    ]
    # master-mode assembly (t4s_*)
    lib.t4s_add_read.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_char_p, c_int, c_int, c_int,
        c_int, c_int, c_dbl, c_int, c_int, c_int, c_int, c_dbl, c_dbl,
        c_dbl, _i32p,
    ]
    lib.t4s_substring_relation.argtypes = [ctypes.c_void_p, _i32p]
    lib.t4s_repeat_add_read.restype = c_int
    lib.t4s_repeat_add_read.argtypes = [ctypes.c_void_p, c_char_p, c_int]
    lib.t4s_input_novel_read.restype = c_int
    lib.t4s_input_novel_read.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_char_p, c_int, c_int, c_int,
    ]
    lib.t4s_update_all_consensus.argtypes = [ctypes.c_void_p]
    lib.t4s_release_finished_barcode.argtypes = [
        ctypes.c_void_p, c_int, c_int, c_int, c_int,
    ]
    lib.t4s_change_kmer_length.argtypes = [ctypes.c_void_p, c_int]
    lib.t4s_seq_count.restype = c_int
    lib.t4s_seq_count.argtypes = [ctypes.c_void_p]
    lib.t4s_get_prev_add.argtypes = [ctypes.c_void_p, _i32p]
    lib.t4s_pull_meta.argtypes = [ctypes.c_void_p, c_int, _i64p]
    lib.t4s_pull_name_len.restype = c_int
    lib.t4s_pull_name_len.argtypes = [ctypes.c_void_p, c_int]
    lib.t4s_pull_data.argtypes = [
        ctypes.c_void_p, c_int, c_char_p, c_char_p, _i32p,
    ]
    # canonical k-mer counter (t4kc_*)
    lib.t4kc_create.restype = ctypes.c_void_p
    lib.t4kc_create.argtypes = [c_int]
    lib.t4kc_destroy.argtypes = [ctypes.c_void_p]
    lib.t4kc_get_max_read_len.restype = ctypes.c_int64
    lib.t4kc_get_max_read_len.argtypes = [ctypes.c_void_p]
    lib.t4kc_set_max_read_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.t4kc_set_count.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
    ]
    lib.t4kc_get_count_code.restype = ctypes.c_int64
    lib.t4kc_get_count_code.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.t4kc_add_count.restype = c_int
    lib.t4kc_add_count.argtypes = [ctypes.c_void_p, c_char_p, c_int]
    lib.t4kc_stats_trim.argtypes = [
        ctypes.c_void_p, c_char_p, c_int, c_char_p, c_int, _i64p,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.t4kc_add_count_batch_mt.restype = None
    lib.t4kc_add_count_batch_mt.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, c_int, c_int,
    ]
    lib.t4kc_add_count_batch.restype = None
    lib.t4kc_add_count_batch.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, c_int,
    ]
    lib.t4kc_stats_trim_batch.restype = None
    lib.t4kc_stats_trim_batch.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, c_char_p, c_int, c_int, _i64p,
        _f64p,
    ]
    lib.t4kc_barcode_pass.restype = None
    lib.t4kc_barcode_pass.argtypes = [
        c_int, c_char_p, _i64p, _i64p, c_int, ctypes.c_int64, c_int,
        _i64p, _i64p, _f64p,
    ]
    lib.t4o_build_batch.restype = None
    lib.t4o_build_batch.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, _i32p, _i64p, c_int, c_int,
    ]
    lib.t4s_assemble_loop.restype = c_int
    lib.t4s_assemble_loop.argtypes = [
        ctypes.c_void_p, c_char_p, _i64p, c_int,
        _i32p, _f64p, _i32p, _i32p, _f64p, _i32p, c_char_p, _i64p, c_int,
        c_int, c_int, c_int, c_int, c_dbl, c_dbl, c_dbl,
        c_int, c_int, c_int, c_int, c_int, ctypes.c_int64, c_int,
        _i32p, _i32p, _u8p, _i32p, _i32p, _i32p,
    ]


def available() -> bool:
    return _load() is not None


def prof_dump() -> "dict | None":
    """Drain the T4_PROF=1 native phase counters (cumulative since the
    last drain).  Keys: hits/chain/score/sort/score_dp seconds (summed
    across threads), n_hits/n_overlaps volumes, lis seconds.  None when
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(10, dtype=np.float64)
    lib.t4o_prof_dump10(
        None, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    )
    return {
        "hits_s": out[0], "chain_s": out[1], "score_s": out[2],
        "sort_s": out[3], "score_dp_s": out[4], "n_hits": int(out[5]),
        "n_overlaps": int(out[6]), "lis_s": out[7],
        "gsort_s": out[8], "gfin_s": out[9],
    }


class NativeKmerCount:
    """C++ canonical k-mer counter (t4kc_*), bit-identical stats/trim."""

    def __init__(self, k: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native kmer counter unavailable")
        self._lib = lib
        self._h = lib.t4kc_create(k)
        self._i64 = (ctypes.c_int64 * 4)()
        self._f64 = (ctypes.c_double * 1)()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.t4kc_destroy(self._h)
                self._h = None
        except Exception:
            pass

    @property
    def max_read_len(self) -> int:
        return self._lib.t4kc_get_max_read_len(self._h)

    @max_read_len.setter
    def max_read_len(self, v: int) -> None:
        self._lib.t4kc_set_max_read_len(self._h, v)

    def set_count(self, code: int, c: int) -> None:
        self._lib.t4kc_set_count(self._h, code, c)

    def get_count_code(self, code: int) -> int:
        return self._lib.t4kc_get_count_code(self._h, code)

    def add_count(self, read: str) -> int:
        b = read.encode("ascii")
        return self._lib.t4kc_add_count(self._h, b, len(b))

    def stats_trim(self, read: str, qual):
        b = read.encode("ascii")
        q = qual.encode("ascii") if qual is not None else None
        self._lib.t4kc_stats_trim(
            self._h, b, len(b), q, 0 if qual is None else 1,
            self._i64, self._f64,
        )
        mn, med, ok, new_len = (
            self._i64[0], self._i64[1], self._i64[2], self._i64[3],
        )
        if new_len >= 0:
            read = read[:new_len]
            if qual is not None:
                qual = qual[:new_len]
        return read, qual, mn, med, self._f64[0], ok

    def add_count_batch(self, reads, threads: int = 1) -> None:
        """One FFI call counting a whole read list.  Counting is
        commutative and the counter is 8-way hash-sharded, so threads > 1
        runs the disjoint-shard workers (identical final counts)."""
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        self._lib.t4kc_add_count_batch_mt(
            self._h, b"".join(blobs), offs.ctypes.data_as(_i64p),
            len(blobs), max(1, threads),
        )

    def stats_trim_batch(self, reads, quals):
        """Batched stats_trim preserving the serial stale-buffer quirk.
        quals is a same-length list (entries may not be None when the
        batch has quals; pass quals=None for the no-qual mode).  Returns
        (i64 (n,4) {min, median, ok, new_len}, f64 (n,) {avg})."""
        n = len(reads)
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        out_i64 = np.empty((n, 4), dtype=np.int64)
        out_f64 = np.empty(n, dtype=np.float64)
        qual_blob = None
        if quals is not None:
            qual_blob = b"".join(q.encode("ascii") for q in quals)
        self._lib.t4kc_stats_trim_batch(
            self._h, b"".join(blobs), offs.ctypes.data_as(_i64p),
            qual_blob, 0 if quals is None else 1, n,
            out_i64.ctypes.data_as(_i64p),
            out_f64.ctypes.data_as(_f64p_mod),
        )
        return out_i64, out_f64


def barcode_pass(k, reads, barcodes, max_read_len, n_threads):
    """Per-barcode k-mer pass (native t4kc_barcode_pass): reads sorted by
    barcode; returns (min, median, avg) int64/int64/float64 arrays, or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(reads)
    blobs = [r.encode("ascii") for r in reads]
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offs[1:])
    bcs = np.ascontiguousarray(barcodes, dtype=np.int64)
    out_min = np.empty(n, dtype=np.int64)
    out_med = np.empty(n, dtype=np.int64)
    out_avg = np.empty(n, dtype=np.float64)
    lib.t4kc_barcode_pass(
        k, b"".join(blobs), offs.ctypes.data_as(_i64p),
        bcs.ctypes.data_as(_i64p), n, max_read_len, n_threads,
        out_min.ctypes.data_as(_i64p), out_med.ctypes.data_as(_i64p),
        out_avg.ctypes.data_as(_f64p_mod),
    )
    return out_min, out_med, out_avg


class NativeOverlapEngine:
    """Owns the C++ twin of one KmerIndex; queried by SeqSet."""

    _CAP_OV = 1 << 14
    _CAP_COORDS = 1 << 20

    def __init__(self, kmer_len: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native overlap engine unavailable")
        self._lib = lib
        self._h = lib.t4o_create(kmer_len)
        self._ov_buf = np.empty((self._CAP_OV, 9), dtype=np.int32)
        self._coord_buf = np.empty((self._CAP_COORDS, 2), dtype=np.int32)
        self._counts = np.empty(2, dtype=np.int32)
        # scored-query output buffers (grown on demand)
        self._sc_cap = 1 << 10
        self._sc_i32 = np.empty((self._sc_cap, 9), dtype=np.int32)
        self._sc_f64 = np.empty(self._sc_cap, dtype=np.float64)
        # posWeight keepalives for registered seqs (sid -> ndarray)
        self._pw_keep = {}
        self._s_out2 = None  # reusable AddRead out buffer (hot loop)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.t4o_destroy_registry(self._h)
                self._lib.t4o_destroy(self._h)
                self._h = None
        except Exception:
            pass

    # --- index mirror ---

    def set_kmer_len(self, kl: int) -> None:
        self._lib.t4o_set_kmer_len(self._h, kl)

    def set_consider_barcode(self, v: bool) -> None:
        self._lib.t4o_set_consider_barcode(self._h, 1 if v else 0)

    def clear(self) -> None:
        self._lib.t4o_clear(self._h)

    def build_from_read(self, s: str, kl: int, sid: int, barcode: int,
                        shift: int = 0) -> None:
        b = s.encode("ascii")
        self._lib.t4o_build_from_read(self._h, b, len(b), kl, sid, barcode,
                                      shift)

    def build_batch(self, seqs, kl: int, sids, barcodes,
                    threads: int = 1) -> None:
        """Full-rebuild batch (t4o_build_batch_mt): one FFI call with the
        reserved sharded postings map; shards build in parallel."""
        blobs = [s.encode("ascii") for s in seqs]
        offs = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        sid_arr = np.ascontiguousarray(sids, dtype=np.int32)
        bc_arr = np.ascontiguousarray(barcodes, dtype=np.int64)
        self._lib.t4o_build_batch_mt(
            self._h, b"".join(blobs), offs.ctypes.data_as(_i64p),
            sid_arr.ctypes.data_as(_i32p), bc_arr.ctypes.data_as(_i64p),
            len(blobs), kl, max(1, threads),
        )

    def remove_from_read(self, s: str, kl: int, sid: int, barcode: int,
                         offset: int = 0) -> None:
        b = s.encode("ascii")
        self._lib.t4o_remove_from_read(self._h, b, len(b), kl, sid, barcode,
                                       offset)

    def resync_seq(self, old: str, new: str, kl: int, sid: int,
                   barcode: int) -> None:
        """Ordered index resync of one seq whose consensus changed
        (t4o_resync_seq): bit-equivalent to a full sid-ordered rebuild."""
        ob = old.encode("ascii")
        nb = new.encode("ascii")
        self._lib.t4o_resync_seq(self._h, ob, len(ob), nb, len(nb), kl,
                                 sid, barcode)

    def update_from_read(self, s: str, kl: int, barcode: int, shift: int,
                         old_id: int, new_id: int) -> None:
        b = s.encode("ascii")
        self._lib.t4o_update_from_read(self._h, b, len(b), kl, barcode,
                                       shift, old_id, new_id)

    def stats(self):
        out = np.empty(2, dtype=np.int64)
        self._lib.t4o_stats(self._h, out.ctypes.data_as(_i64p))
        return int(out[0]), int(out[1])

    # --- query ---

    def query(self, read: str, strand: int, barcode: int, read_type: int,
              skip_repeats: bool, puse: Optional[np.ndarray],
              meta, radius: int, hit_len_required: int,
              is_long_seq_set: bool, skip_limit: int, down_sample: int):
        """Returns list of (seq_idx, read_start, read_end, strand,
        seq_start, seq_end, match_cnt, coords) matching the host
        pre-similarity overlap list."""
        is_ref, seq_bc, seq_len, name4 = meta
        n_seqs = len(is_ref)
        b = read.encode("ascii")
        puse_p = (
            puse.ctypes.data_as(_u8p) if puse is not None
            else ctypes.cast(None, _u8p)
        )
        rc = self._lib.t4o_query(
            self._h, b, len(b), strand, barcode, read_type,
            1 if skip_repeats else 0, puse_p, n_seqs,
            is_ref.ctypes.data_as(_i8p),
            seq_bc.ctypes.data_as(_i32p),
            seq_len.ctypes.data_as(_i32p),
            name4.ctypes.data_as(_u8p),
            radius, hit_len_required, 1 if is_long_seq_set else 0,
            skip_limit, down_sample,
            self._ov_buf.ctypes.data_as(_i32p), self._CAP_OV,
            self._coord_buf.ctypes.data_as(_i32p), self._CAP_COORDS,
            self._counts.ctypes.data_as(_i32p),
        )
        if rc != 0:
            raise MemoryError("overlap engine output buffer overflow")
        n_ov = int(self._counts[0])
        n_pairs = int(self._counts[1])
        rows = self._ov_buf[:n_ov].tolist()
        # One copy of the coord block per query; per-overlap coords are
        # contiguous int32 views into it (zero-copy into t4_chain_score).
        # The raw pointer rides along so batch scoring needs no per-
        # overlap .ctypes access (keepalive: the views hold `pairs`).
        pairs = self._coord_buf[:n_pairs].copy()
        base = pairs.ctypes.data
        out = []
        for row in rows:
            coff = row[7]
            ccnt = row[8]
            out.append(
                (row[0], row[1], row[2], row[3], row[4], row[5], row[6],
                 pairs[coff : coff + ccnt], base + 8 * coff, ccnt)
            )
        return out

    # --- scored-query engine (registry-backed) ---

    def reg_seq(self, sid: int, is_ref: bool, barcode: int,
                name: Optional[str], consensus: Optional[str],
                pos_weight: Optional[np.ndarray], cdr3_anchor: int) -> None:
        """Register/refresh one sequence record.  The posWeight pointer is
        kept alive here; name/consensus are copied by the C++ side."""
        nb = name.encode("ascii") if name is not None else None
        cb = consensus.encode("ascii") if consensus is not None else None
        if pos_weight is not None:
            self._pw_keep[sid] = pos_weight
            pw_ptr = pos_weight.ctypes.data_as(_i32p)
        else:
            self._pw_keep.pop(sid, None)
            pw_ptr = ctypes.cast(None, _i32p)
        self._lib.t4o_reg_seq(
            self._h, sid, 1 if is_ref else 0, barcode,
            nb, 0 if nb is None else len(nb),
            cb, 0 if cb is None else len(cb),
            pw_ptr, cdr3_anchor,
        )

    def clear_seqs(self) -> None:
        self._lib.t4o_clear_seqs(self._h)
        self._pw_keep.clear()

    def query_scored(self, read: str, strand: int, barcode: int,
                     read_type: int, skip_repeats: bool,
                     puse: Optional[np.ndarray], radius: int,
                     hit_len_required: int, is_long_seq_set: bool,
                     nomatch_gap_limit: int, novel_sim: float,
                     ref_sim: float, repeat_sim: float):
        """Full GetOverlapsFromRead.  Returns (n, int32 rows (n,9),
        similarities (n,)) — n<=0 means none/short-read."""
        b = read.encode("ascii")
        puse_p = (
            puse.ctypes.data_as(_u8p) if puse is not None
            else ctypes.cast(None, _u8p)
        )
        while True:
            n = self._lib.t4o_query_scored(
                self._h, b, len(b), strand, barcode, read_type,
                1 if skip_repeats else 0, puse_p, radius, hit_len_required,
                1 if is_long_seq_set else 0, nomatch_gap_limit,
                novel_sim, ref_sim, repeat_sim,
                self._sc_i32.ctypes.data_as(_i32p),
                self._sc_f64.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_double)),
                self._sc_cap,
            )
            if n != -2:
                return n, self._sc_i32, self._sc_f64
            self._sc_cap *= 4
            self._sc_i32 = np.empty((self._sc_cap, 9), dtype=np.int32)
            self._sc_f64 = np.empty(self._sc_cap, dtype=np.float64)

    def annotate0(self, read: str, radius: int, hit_len_required: int,
                  is_long_seq_set: bool, nomatch_gap_limit: int,
                  novel_sim: float, ref_sim: float, repeat_sim: float,
                  gap_n: int):
        """Quick annotation (detail 0) of one read.  Returns
        (int32 (4,8), float64 (4,))."""
        b = read.encode("ascii")
        out_i32 = np.empty((4, 8), dtype=np.int32)
        out_f64 = np.empty(4, dtype=np.float64)
        self._lib.t4o_annotate0(
            self._h, b, len(b), radius, hit_len_required,
            1 if is_long_seq_set else 0, nomatch_gap_limit,
            novel_sim, ref_sim, repeat_sim, gap_n,
            out_i32.ctypes.data_as(_i32p),
            out_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out_i32, out_f64

    def annotate0_batch(self, reads, n_threads: int, radius: int,
                        hit_len_required: int, is_long_seq_set: bool,
                        nomatch_gap_limit: int, novel_sim: float,
                        ref_sim: float, repeat_sim: float, gap_n: int):
        """Quick annotation (detail 0) of many reads.  Returns
        (int32 (n,4,8), float64 (n,4))."""
        n = len(reads)
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        out_i32 = np.empty((n, 4, 8), dtype=np.int32)
        out_f64 = np.empty((n, 4), dtype=np.float64)
        self._lib.t4o_annotate0_batch(
            self._h, blob, offs.ctypes.data_as(_i64p), n, n_threads,
            radius, hit_len_required, 1 if is_long_seq_set else 0,
            nomatch_gap_limit, novel_sim, ref_sim, repeat_sim, gap_n,
            out_i32.ctypes.data_as(_i32p),
            out_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out_i32, out_f64

    def annotate0_collect_gaps(self, reads, n_threads: int, radius: int,
                               hit_len_required: int, is_long_seq_set: bool,
                               nomatch_gap_limit: int, novel_sim: float,
                               ref_sim: float, repeat_sim: float,
                               gap_n: int):
        """Phase 1 of the device-assisted quick annotation: run the batch
        in collect mode and return the is_ref gap-fill job rows (n, 8)
        int32 (seq_idx carries a bit-30 rc flag; r_from anchors into the
        full forward read)."""
        n = len(reads)
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        # Overflow returns the exact needed size (negative), so at most
        # one retry re-runs the batch instead of an exponential ladder.
        cap = max(1 << 16, 8 * n)
        for _ in range(2):
            out = np.empty((cap, 8), dtype=np.int32)
            rc = self._lib.t4o_annotate0_collect_gaps(
                self._h, blob, offs.ctypes.data_as(_i64p), n, n_threads,
                radius, hit_len_required, 1 if is_long_seq_set else 0,
                nomatch_gap_limit, novel_sim, ref_sim, repeat_sim, gap_n,
                out.ctypes.data_as(_i32p), cap,
            )
            if rc >= 0:
                return out[:rc]
            cap = -rc
        raise RuntimeError("annotate0_collect_gaps cap negotiation failed")

    def annotate0_batch_oracle(self, reads, gap_jobs, gap_counts,
                               n_threads: int, radius: int,
                               hit_len_required: int, is_long_seq_set: bool,
                               nomatch_gap_limit: int, novel_sim: float,
                               ref_sim: float, repeat_sim: float,
                               gap_n: int):
        """Phase 2: the quick-annotation batch consuming device gap
        counts.  Returns (int32 (n,4,8), float64 (n,4)) like
        annotate0_batch."""
        n = len(reads)
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        gj = np.ascontiguousarray(gap_jobs, dtype=np.int32)
        gc = np.ascontiguousarray(gap_counts, dtype=np.int32)
        out_i32 = np.empty((n, 4, 8), dtype=np.int32)
        out_f64 = np.empty((n, 4), dtype=np.float64)
        self._lib.t4o_annotate0_batch_oracle(
            self._h, blob, offs.ctypes.data_as(_i64p), n, n_threads,
            radius, hit_len_required, 1 if is_long_seq_set else 0,
            nomatch_gap_limit, novel_sim, ref_sim, repeat_sim, gap_n,
            gj.ctypes.data_as(_i32p), gc.ctypes.data_as(_i32p), len(gj),
            out_i32.ctypes.data_as(_i32p),
            out_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out_i32, out_f64

    def assign_read(self, read: str, strand: int, barcode: int, radius: int,
                    hit_len_required: int, is_long_seq_set: bool,
                    nomatch_gap_limit: int, novel_sim: float,
                    ref_sim: float, repeat_sim: float):
        """AssignRead.  Returns (rc, int32 row (8,), sim) — rc 1 found,
        0 none, -3 needs host fallback."""
        b = read.encode("ascii")
        out_i32 = np.empty(8, dtype=np.int32)
        out_f64 = np.empty(1, dtype=np.float64)
        rc = self._lib.t4o_assign_read(
            self._h, b, len(b), strand, barcode, radius, hit_len_required,
            1 if is_long_seq_set else 0, nomatch_gap_limit,
            novel_sim, ref_sim, repeat_sim,
            out_i32.ctypes.data_as(_i32p),
            out_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return rc, out_i32, float(out_f64[0])

    def query_scored_batch(self, jobs, n_threads: int, radius: int,
                           hit_len_required: int, is_long_seq_set: bool,
                           nomatch_gap_limit: int, novel_sim: float,
                           ref_sim: float, repeat_sim: float):
        """Threaded batch of scored queries.  jobs = list of (read, strand,
        barcode, read_type, skip_repeats).  Returns a list of
        (n, rows(n,9), sims(n)) per job (n = -1 for short reads)."""
        n = len(jobs)
        blobs = [j[0].encode("ascii") for j in jobs]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        st = np.array([j[1] for j in jobs], dtype=np.int32)
        bc = np.array([j[2] for j in jobs], dtype=np.int32)
        rt = np.array([j[3] for j in jobs], dtype=np.int32)
        sk = np.array([1 if j[4] else 0 for j in jobs], dtype=np.int32)
        rng = np.empty(2 * n, dtype=np.int64)
        cap = max(1 << 14, 64 * n)
        while True:
            out_i32 = np.empty((cap, 9), dtype=np.int32)
            out_f64 = np.empty(cap, dtype=np.float64)
            rc = self._lib.t4o_query_scored_batch(
                self._h, blob, offs.ctypes.data_as(_i64p),
                st.ctypes.data_as(_i32p), bc.ctypes.data_as(_i32p),
                rt.ctypes.data_as(_i32p), sk.ctypes.data_as(_i32p),
                n, n_threads, radius, hit_len_required,
                1 if is_long_seq_set else 0, nomatch_gap_limit,
                novel_sim, ref_sim, repeat_sim,
                out_i32.ctypes.data_as(_i32p),
                out_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                cap, rng.ctypes.data_as(_i64p),
            )
            if rc != -2:
                break
            cap *= 4
        return self._batch_views(n, rng, out_i32, out_f64)

    def query_scored_batch_flat(self, jobs, *conf):
        """Like query_scored_batch but returns the flat result arrays
        (rng(2n) int64, rows(cap,9) int32, sims(cap) float64) for zero-copy
        reuse by annotate2_batch."""
        self._last_flat = None
        self.query_scored_batch(jobs, *conf)
        return self._last_flat

    @staticmethod
    def _flat_to_views(flat):
        rng, out_i32, out_f64 = flat
        n = len(rng) // 2
        out = []
        for i in range(n):
            a = int(rng[2 * i])
            c = int(rng[2 * i + 1])
            if c < 0:
                out.append((-1, None, None))
            else:
                out.append((c, out_i32[a : a + c], out_f64[a : a + c]))
        return out

    def _batch_views(self, n, rng, out_i32, out_f64):
        self._last_flat = (rng, out_i32, out_f64)
        return self._flat_to_views(self._last_flat)

    def _batch_args(self, jobs):
        n = len(jobs)
        blobs = [j[0].encode("ascii") for j in jobs]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        st = np.array([j[1] for j in jobs], dtype=np.int32)
        bc = np.array([j[2] for j in jobs], dtype=np.int32)
        rt = np.array([j[3] for j in jobs], dtype=np.int32)
        sk = np.array([1 if j[4] else 0 for j in jobs], dtype=np.int32)
        return n, blob, offs, st, bc, rt, sk

    def batch_collect_gaps(self, jobs, n_threads: int, radius: int,
                           hit_len_required: int, is_long_seq_set: bool,
                           nomatch_gap_limit: int, novel_sim: float,
                           ref_sim: float, repeat_sim: float):
        """Phase 1 of the device-assisted batch: run the queries in collect
        mode and return the is_ref gap-fill job rows (n, 8) int32."""
        n, blob, offs, st, bc, rt, sk = self._batch_args(jobs)
        # Overflow returns the exact needed size (negative): one retry max.
        cap = max(1 << 16, 128 * n)
        for _ in range(2):
            out = np.empty((cap, 8), dtype=np.int32)
            rc = self._lib.t4o_batch_collect_gaps(
                self._h, blob, offs.ctypes.data_as(_i64p),
                st.ctypes.data_as(_i32p), bc.ctypes.data_as(_i32p),
                rt.ctypes.data_as(_i32p), sk.ctypes.data_as(_i32p),
                n, n_threads, radius, hit_len_required,
                1 if is_long_seq_set else 0, nomatch_gap_limit,
                novel_sim, ref_sim, repeat_sim,
                out.ctypes.data_as(_i32p), cap,
            )
            if rc >= 0:
                return out[:rc]
            cap = -rc
        raise RuntimeError("batch_collect_gaps cap negotiation failed")

    def emit_gap_codes(self, jobs, gap_jobs, width: int):
        """Device-ready DP code rows for collected gap jobs: returns
        (t_codes, p_codes), each (n_jobs, width) int8, pad 5.  jobs are the
        batch's query tuples or plain read strings (for the read blob);
        gap_jobs the (n, 8) rows from batch_collect_gaps or
        annotate0_collect_gaps."""
        reads = [j[0] if isinstance(j, tuple) else j for j in jobs]
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(len(reads) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        gj = np.ascontiguousarray(gap_jobs, dtype=np.int32)
        out_t = np.empty((len(gj), width), dtype=np.int8)
        out_p = np.empty((len(gj), width), dtype=np.int8)
        self._lib.t4o_emit_gap_codes(
            self._h, blob, offs.ctypes.data_as(_i64p),
            gj.ctypes.data_as(_i32p), len(gj), width,
            out_t.ctypes.data_as(_i8p), out_p.ctypes.data_as(_i8p),
        )
        return out_t, out_p

    def dedup_gap_jobs(self, jobs, gap_jobs, width: int, n_threads: int):
        """Content-keyed dedup of gap jobs (t4o_dedup_gap_jobs): groups
        jobs whose device DP inputs (code rows + lengths) are identical.
        Returns (uniq_idx (n_uniq,) i32 — job index of each unique's
        representative, inverse (n,) i32 — unique ordinal per job)."""
        reads = [j[0] if isinstance(j, tuple) else j for j in jobs]
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(len(reads) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        gj = np.ascontiguousarray(gap_jobs, dtype=np.int32)
        n = len(gj)
        inverse = np.empty(n, dtype=np.int32)
        uniq = np.empty(max(1, n), dtype=np.int32)
        n_uniq = self._lib.t4o_dedup_gap_jobs(
            self._h, blob, offs.ctypes.data_as(_i64p),
            gj.ctypes.data_as(_i32p), n, width, n_threads,
            inverse.ctypes.data_as(_i32p), uniq.ctypes.data_as(_i32p),
        )
        return uniq[:n_uniq].copy(), inverse

    def gap_counts_cpu(self, jobs, gap_jobs, sel, n_threads: int):
        """Native threaded (match, mismatch, indel) counts for the gap
        jobs selected by `sel` (int indices into gap_jobs) — the hybrid
        tier split's CPU half and the top-tier-miss path.  Segment
        semantics match _job_segments/t4o_emit_gap_codes."""
        reads = [j[0] if isinstance(j, tuple) else j for j in jobs]
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(len(reads) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        gj = np.ascontiguousarray(gap_jobs, dtype=np.int32)
        si = np.ascontiguousarray(sel, dtype=np.int64)
        out = np.empty((len(si), 3), dtype=np.int32)
        self._lib.t4o_gap_counts_cpu(
            self._h, blob, offs.ctypes.data_as(_i64p),
            gj.ctypes.data_as(_i32p), si.ctypes.data_as(_i64p), len(si),
            n_threads, out.ctypes.data_as(_i32p),
        )
        return out

    def query_scored_batch_oracle(self, jobs, gap_jobs, gap_counts,
                                  n_threads: int, radius: int,
                                  hit_len_required: int,
                                  is_long_seq_set: bool,
                                  nomatch_gap_limit: int, novel_sim: float,
                                  ref_sim: float, repeat_sim: float):
        """Phase 2: the scored batch consuming device gap counts."""
        n, blob, offs, st, bc, rt, sk = self._batch_args(jobs)
        gj = np.ascontiguousarray(gap_jobs, dtype=np.int32)
        gc = np.ascontiguousarray(gap_counts, dtype=np.int32)
        rng = np.empty(2 * n, dtype=np.int64)
        cap = max(1 << 14, 64 * n)
        while True:
            out_i32 = np.empty((cap, 9), dtype=np.int32)
            out_f64 = np.empty(cap, dtype=np.float64)
            rc = self._lib.t4o_query_scored_batch_oracle(
                self._h, blob, offs.ctypes.data_as(_i64p),
                st.ctypes.data_as(_i32p), bc.ctypes.data_as(_i32p),
                rt.ctypes.data_as(_i32p), sk.ctypes.data_as(_i32p),
                n, n_threads, radius, hit_len_required,
                1 if is_long_seq_set else 0, nomatch_gap_limit,
                novel_sim, ref_sim, repeat_sim,
                gj.ctypes.data_as(_i32p), gc.ctypes.data_as(_i32p),
                len(gj),
                out_i32.ctypes.data_as(_i32p),
                out_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                cap, rng.ctypes.data_as(_i64p),
            )
            if rc != -2:
                break
            cap *= 4
        return self._batch_views(n, rng, out_i32, out_f64)

    def query_scored_batch_oracle_flat(self, jobs, gap_jobs, gap_counts,
                                       *conf):
        """Oracle variant returning the flat result arrays."""
        self._last_flat = None
        self.query_scored_batch_oracle(jobs, gap_jobs, gap_counts, *conf)
        return self._last_flat

    def reg_seq_cdr(self, sid: int, c1s: int, c1e: int, c2s: int,
                    c2e: int) -> None:
        """Register CDR1/2 IMGT coords (engine/types.py info[0..1]) for a
        ref seq; must follow reg_seq (which resets them)."""
        self._lib.t4o_reg_seq_cdr(self._h, sid, c1s, c1e, c2s, c2e)

    def annotate2_batch(self, contigs, piece_jobs, piece_off, flat_cache,
                        n_threads: int, gap_n: int, radius: int,
                        hit_len_required: int, is_long_seq_set: bool,
                        nomatch_gap_limit: int, novel_sim: float,
                        ref_sim: float, repeat_sim: float):
        """Batched native detail-2 annotation (native/annotate2.inc).

        contigs = list of consensus strings; piece_jobs/piece_off map each
        contig's N-split pieces to job indices of the phase-1 batch whose
        flat arrays are ``flat_cache`` (from query_scored_batch_flat or the
        oracle variant).  Returns (ret(n), gene_i32(n,4,9), gene_f64(n,4),
        cdr_i32(n,3,9), cdr_f64(n,3), sec_i32, sec_f64, sec_rng(2n))."""
        n = len(contigs)
        blobs = [c.encode("ascii") for c in contigs]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        pj = np.ascontiguousarray(piece_jobs, dtype=np.int32)
        po = np.ascontiguousarray(piece_off, dtype=np.int64)
        rng, rows, sims = flat_cache
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        sims = np.ascontiguousarray(sims, dtype=np.float64)
        rng = np.ascontiguousarray(rng, dtype=np.int64)
        out_ret = np.empty(n, dtype=np.int32)
        gene_i32 = np.empty((n, 4, 9), dtype=np.int32)
        gene_f64 = np.empty((n, 4), dtype=np.float64)
        cdr_i32 = np.empty((n, 3, 9), dtype=np.int32)
        cdr_f64 = np.empty((n, 3), dtype=np.float64)
        sec_rng = np.empty(2 * n, dtype=np.int64)
        sec_cap = max(256, 8 * n)
        while True:
            sec_i32 = np.empty((sec_cap, 9), dtype=np.int32)
            sec_f64 = np.empty(sec_cap, dtype=np.float64)
            rc = self._lib.t4o_annotate2_batch(
                self._h, blob, offs.ctypes.data_as(_i64p), n,
                pj.ctypes.data_as(_i32p), po.ctypes.data_as(_i64p),
                rows.ctypes.data_as(_i32p),
                sims.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                rng.ctypes.data_as(_i64p),
                n_threads, gap_n, radius, hit_len_required,
                1 if is_long_seq_set else 0, nomatch_gap_limit,
                novel_sim, ref_sim, repeat_sim,
                out_ret.ctypes.data_as(_i32p),
                gene_i32.ctypes.data_as(_i32p),
                gene_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                cdr_i32.ctypes.data_as(_i32p),
                cdr_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                sec_i32.ctypes.data_as(_i32p),
                sec_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                sec_rng.ctypes.data_as(_i64p), sec_cap,
            )
            if rc != -2:
                break
            sec_cap *= 4
        return (out_ret, gene_i32, gene_f64, cdr_i32, cdr_f64, sec_i32,
                sec_f64, sec_rng)

    # --- master-mode assembly (native-owned contig state) ---

    def s_add_read(self, read: str, gene_name: str, strand: int,
                   barcode: int, min_kmer_count: int, repetitive: bool,
                   sim_threshold: float, conf) -> tuple:
        """conf = (radius, hit_len_required, is_long, nomatch, nsim, rsim,
        repsim)."""
        b = read.encode("ascii")
        g = gene_name.encode("ascii")
        # Hot loop (once per AddRead): reuse one out buffer and a cached
        # bound method instead of np.empty + data_as per call.
        out2 = self._s_out2
        if out2 is None:
            out2 = self._s_out2 = (ctypes.c_int32 * 2)()
        self._lib.t4s_add_read(
            self._h, b, len(b), g, len(g), strand, barcode, min_kmer_count,
            1 if repetitive else 0, sim_threshold, *conf, out2,
        )
        return out2[0], out2[1]

    def s_assemble_loop(self, reads, meta, plan_sim, plan_name4, g8, gsim,
                        ref_lens, ref_names, conf, has_barcode,
                        keep_missing_barcode, contig_min_cov,
                        first_read_len, repetitive, change_kmer_threshold,
                        index_kmer_length, io_strand, io_info, io_good):
        """Run the whole greedy loop + rescue pass in C++
        (t4s_assemble_loop).  Mutates io_strand/io_info/io_good in place;
        returns (add_ret (n,) i32, assembled index list)."""
        n = len(reads)
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        nblobs = [s.encode("ascii") for s in ref_names]
        noffs = np.zeros(len(nblobs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in nblobs], out=noffs[1:])
        out_add_ret = np.empty(n, dtype=np.int32)
        out_assembled = np.empty(n, dtype=np.int32)
        out_final_kl = np.empty(1, dtype=np.int32)
        cnt = self._lib.t4s_assemble_loop(
            self._h, b"".join(blobs), offs.ctypes.data_as(_i64p), n,
            meta.ctypes.data_as(_i32p), plan_sim.ctypes.data_as(_f64p_mod),
            plan_name4.ctypes.data_as(_i32p), g8.ctypes.data_as(_i32p),
            gsim.ctypes.data_as(_f64p_mod), ref_lens.ctypes.data_as(_i32p),
            b"".join(nblobs), noffs.ctypes.data_as(_i64p), len(nblobs),
            *conf, has_barcode, 1 if keep_missing_barcode else 0,
            contig_min_cov, first_read_len, repetitive,
            change_kmer_threshold, index_kmer_length,
            io_strand.ctypes.data_as(_i32p), io_info.ctypes.data_as(_i32p),
            io_good.ctypes.data_as(_u8p),
            out_add_ret.ctypes.data_as(_i32p),
            out_assembled.ctypes.data_as(_i32p),
            out_final_kl.ctypes.data_as(_i32p),
        )
        return out_add_ret, out_assembled[:cnt], int(out_final_kl[0])

    def substring_relation(self, seq_cnt: int):
        """BuildSeqSubstringRelation over the synced seqs + index
        (t4s_substring_relation).  Returns [(container, start) | None]."""
        out = np.empty(2 * seq_cnt, dtype=np.int32)
        self._lib.t4s_substring_relation(self._h, out.ctypes.data_as(_i32p))
        return [
            (int(out[2 * i]), int(out[2 * i + 1]))
            if out[2 * i] != -1 else None
            for i in range(seq_cnt)
        ]

    def s_repeat_add_read(self, read: str) -> int:
        b = read.encode("ascii")
        return self._lib.t4s_repeat_add_read(self._h, b, len(b))

    def s_input_novel_read(self, name: str, read: str, strand: int,
                           barcode: int) -> int:
        nb = name.encode("ascii")
        b = read.encode("ascii")
        return self._lib.t4s_input_novel_read(
            self._h, nb, len(nb), b, len(b), strand, barcode
        )

    def s_update_all_consensus(self) -> None:
        self._lib.t4s_update_all_consensus(self._h)

    def s_release_finished_barcode(self, barcode: int,
                                   remove_from_index: bool,
                                   contig_min_cov: int,
                                   early_stop: bool) -> None:
        self._lib.t4s_release_finished_barcode(
            self._h, barcode, 1 if remove_from_index else 0,
            contig_min_cov, 1 if early_stop else 0,
        )

    def s_change_kmer_length(self, kl: int) -> None:
        self._lib.t4s_change_kmer_length(self._h, kl)

    def s_seq_count(self) -> int:
        return self._lib.t4s_seq_count(self._h)

    def s_get_prev_add(self):
        out = np.empty(6, dtype=np.int32)
        self._lib.t4s_get_prev_add(self._h, out.ctypes.data_as(_i32p))
        return tuple(int(v) for v in out)

    def s_pull_all(self):
        """Bulk-pull every seq's state in two FFI calls.  Returns
        (meta (n, 11) i64 [last column = name_len], names bytes,
        cons bytes, pw_flat i32, info_zero (n,) u8)."""
        n = self._lib.t4s_seq_count(self._h)
        meta = np.empty((n, 11), dtype=np.int64)
        if n:
            self._lib.t4s_pull_meta_all(self._h, meta.ctypes.data_as(_i64p))
        name_total = int(meta[:, 10].sum()) if n else 0
        cons_total = int(meta[:, 8].sum()) if n else 0
        pw_total = int(meta[:, 9].sum()) if n else 0
        names = ctypes.create_string_buffer(max(1, name_total))
        cons = ctypes.create_string_buffer(max(1, cons_total))
        pw = np.empty(max(1, pw_total), dtype=np.int32)
        info_zero = np.zeros(max(1, n), dtype=np.uint8)
        if n:
            self._lib.t4s_pull_data_all(
                self._h, names, cons, pw.ctypes.data_as(_i32p),
                info_zero.ctypes.data_as(_u8p),
            )
        return (meta, names.raw[:name_total], cons.raw[:cons_total],
                pw[:pw_total], info_zero[:n])

    def s_pull(self, sid: int):
        """Pull one seq's full state.  Returns (meta11, name, consensus,
        pw_flat_int32)."""
        meta = np.empty(11, dtype=np.int64)
        self._lib.t4s_pull_meta(self._h, sid, meta.ctypes.data_as(_i64p))
        cons_len = int(meta[8])
        pw_len = int(meta[9])
        name_len = self._lib.t4s_pull_name_len(self._h, sid)
        cons_buf = ctypes.create_string_buffer(cons_len)
        name_buf = ctypes.create_string_buffer(name_len)
        pw = np.empty(pw_len, dtype=np.int32)
        self._lib.t4s_pull_data(
            self._h, sid, cons_buf, name_buf,
            pw.ctypes.data_as(_i32p),
        )
        return (
            meta,
            name_buf.raw[:name_len].decode("ascii"),
            cons_buf.raw[:cons_len].decode("ascii"),
            pw,
        )

    def assign_batch_ol(self, blob: bytes, offs, lens, strands, barcodes,
                        n_threads: int, radius: int, hit_len_required: int,
                        is_long_seq_set: bool, nomatch_gap_limit: int,
                        novel_sim: float, ref_sim: float, repeat_sim: float):
        """assign_batch over reads at arbitrary (offset, length) positions
        inside one backing blob (t4o_assign_batch_ol) — no repacking."""
        n = len(offs)
        offs = np.ascontiguousarray(offs, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        st = np.ascontiguousarray(strands, dtype=np.int32)
        bc = np.ascontiguousarray(barcodes, dtype=np.int32)
        out_i32 = np.zeros((n, 8), dtype=np.int32)
        out_f64 = np.zeros(n, dtype=np.float64)
        found = np.zeros(n, dtype=np.int32)
        self._lib.t4o_assign_batch_ol(
            self._h, blob, offs.ctypes.data_as(_i64p),
            lens.ctypes.data_as(_i32p),
            st.ctypes.data_as(_i32p), bc.ctypes.data_as(_i32p), n,
            n_threads, radius, hit_len_required,
            1 if is_long_seq_set else 0, nomatch_gap_limit,
            novel_sim, ref_sim, repeat_sim,
            out_i32.ctypes.data_as(_i32p),
            out_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            found.ctypes.data_as(_i32p),
        )
        return found, out_i32, out_f64

    def assign_batch(self, reads, strands, barcodes, n_threads: int,
                     radius: int, hit_len_required: int,
                     is_long_seq_set: bool, nomatch_gap_limit: int,
                     novel_sim: float, ref_sim: float, repeat_sim: float):
        """Batched AssignRead.  Returns (found (n,), int32 (n,8),
        float64 (n,))."""
        n = len(reads)
        blobs = [r.encode("ascii") for r in reads]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offs[1:])
        blob = b"".join(blobs)
        st = np.asarray(strands, dtype=np.int32)
        bc = np.asarray(barcodes, dtype=np.int32)
        out_i32 = np.empty((n, 8), dtype=np.int32)
        out_f64 = np.empty(n, dtype=np.float64)
        found = np.empty(n, dtype=np.int32)
        self._lib.t4o_assign_batch(
            self._h, blob, offs.ctypes.data_as(_i64p),
            st.ctypes.data_as(_i32p), bc.ctypes.data_as(_i32p), n,
            n_threads, radius, hit_len_required,
            1 if is_long_seq_set else 0, nomatch_gap_limit,
            novel_sim, ref_sim, repeat_sim,
            out_i32.ctypes.data_as(_i32p),
            out_f64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            found.ctypes.data_as(_i32p),
        )
        return found, out_i32, out_f64
