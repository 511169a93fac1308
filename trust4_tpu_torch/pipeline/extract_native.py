"""ctypes loader for the native candidate filter (libt4extract.so).

The exact HasHitInSet test is the extraction bottleneck; the native port
(native/extract_filter.cpp) is semantics-identical to
engine/overlap.py:has_hit_in_set and runs the batch over std::thread.
Set TRUST4_TPU_NATIVE=0 to force the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

from trust4_tpu_torch.utils.nativebuild import ensure_built

# out[i] of a batch decider that leaves read i to the host
# (native/extract_filter.cpp t4x_decider).
UNDECIDED = 2


class Decider(ctypes.Structure):
    """native/extract_filter.cpp ``t4x_decider``, field for field."""

    _fields_ = [
        ("decide", ctypes.c_void_p), ("ctx", ctypes.c_void_p),
        ("bases", ctypes.c_void_p), ("bases_cap", ctypes.c_int64),
        ("offs", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("reads_cap", ctypes.c_int32),
    ]

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TRUST4_TPU_NATIVE", "1") == "0":
        return None
    try:
        lib = ctypes.CDLL(ensure_built("libt4extract.so"))
    except (OSError, subprocess.CalledProcessError):
        return None

    lib.t4x_create.restype = ctypes.c_void_p
    lib.t4x_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.t4x_destroy.argtypes = [ctypes.c_void_p]
    lib.t4x_set_hit_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.t4x_finalize.argtypes = [ctypes.c_void_p]
    lib.t4x_add_seq.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.t4x_filter_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8),
    ]
    lib.t4x_has_hit.restype = ctypes.c_int
    lib.t4x_has_hit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.t4x_extract_stream.restype = ctypes.c_int64
    lib.t4x_extract_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.t4x_csr_view.restype = ctypes.c_int
    lib.t4x_csr_view.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.t4x_extract_stream_bc.restype = ctypes.c_int64
    lib.t4x_extract_stream_bc.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
    ]
    lib.t4x_extract_stream_bc2.restype = ctypes.c_int64
    lib.t4x_extract_stream_bc2.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.t4x_bc_create.restype = ctypes.c_void_p
    lib.t4x_bc_create.argtypes = []
    lib.t4x_bc_destroy.argtypes = [ctypes.c_void_p]
    lib.t4x_bc_load.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.t4x_bc_collect_background.restype = ctypes.c_int64
    lib.t4x_bc_collect_background.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int64,
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.t4x_ingest_single.restype = ctypes.c_int64
    u8p_ = ctypes.POINTER(ctypes.c_uint8)
    lib.t4x_ingest_single.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int,
        u8p_, ctypes.c_int64, i64p,
        u8p_, u8p_, ctypes.c_int64, i64p,
        i32p, i32p, ctypes.c_int64,
        u8p_, ctypes.c_int64, i64p, ctypes.c_int64,
        i64p, i64p,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


class NativeCandidateFilter:
    """is_good_candidate over read batches, bit-identical to the host path.

    ``phase_ns``: the last stream's nanoseconds reading (opening,
    inflating, parsing), filtering and writing (closing included); the
    bulk stream adds a fourth, the calling thread's wait for its reader
    thread's batches.  ``decided``: the bulk stream's candidate tests
    (every first read, and the mates the mate rule reaches) decided by
    its batch decider and by the host."""

    def __init__(self, ref_seqs: List[str], kmer_length: int, radius: int,
                 hit_len_required: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native extract filter unavailable")
        self._lib = lib
        self._h = lib.t4x_create(kmer_length, radius)
        self.phase_ns = (0, 0, 0)
        self.decided = (0, 0)
        for s in ref_seqs:
            lib.t4x_add_seq(self._h, s.encode("ascii"))
        lib.t4x_set_hit_len(self._h, hit_len_required)
        lib.t4x_finalize(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.t4x_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def has_hit(self, read: str) -> int:
        return self._lib.t4x_has_hit(
            self._h, read.encode("ascii"), len(read)
        )

    def csr_view(self):
        """The index's direct-addressed tables (t4x_csr_view), as numpy
        views of the filter's own memory: (starts (4^k + 1,) int32,
        postings (n, 2) int32 of (sequence, offset), (k, radius, hit
        length, sequences)); None without them (k > 12)."""
        off, posts = ctypes.c_void_p(), ctypes.c_void_p()
        n_off, n_posts = ctypes.c_int64(), ctypes.c_int64()
        meta = (ctypes.c_int32 * 4)()
        if self._lib.t4x_csr_view(self._h, ctypes.byref(off),
                                  ctypes.byref(n_off), ctypes.byref(posts),
                                  ctypes.byref(n_posts), meta) != 0:
            return None

        def view(ptr, n):
            if n == 0:
                return np.zeros(0, np.int32)
            return np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)), (n,))

        return (view(off, n_off.value),
                view(posts, 2 * n_posts.value).reshape(-1, 2), tuple(meta))

    def extract_stream(self, paths1: List[str], paths2: Optional[List[str]],
                       out1: str, out2: Optional[str],
                       threads: int = 1, decider=None) -> int:
        """Full extraction loop in native code (read -> filter -> write,
        input order preserved; FastqExtractor.cpp:549-724 batched flow).
        A reader thread inflates and parses the next batch while the
        filter runs this one: on ``threads`` workers, or through
        ``decider``, an object whose ``as_decider()`` gives a ``Decider``
        that decides each batch's reads in place of the threads and whose
        ``failed()``, if it has one, raises what made that fail.  Returns
        the candidate count, or raises on I/O failure and on the
        decider's."""
        j1 = "\n".join(paths1).encode()
        j2 = "\n".join(paths2).encode() if paths2 else None
        ns = (ctypes.c_int64 * 4)()
        decided = (ctypes.c_int64 * 2)()
        dec = None if decider is None else ctypes.byref(decider.as_decider())
        n = self._lib.t4x_extract_stream(
            self._h, j1, j2, out1.encode(),
            out2.encode() if out2 else None, threads, ns, dec, decided,
        )
        if n == -2:
            if hasattr(decider, "failed"):
                decider.failed()
            raise RuntimeError("the extraction stream's batch decider failed")
        if n < 0:
            raise OSError(f"native extract failed reading {paths1}")
        self.phase_ns = tuple(ns)
        self.decided = tuple(decided)
        return int(n)

    def extract_stream_bc(self, paths1, paths2, bc_paths, umi_paths,
                          umi_alias: bool, out1, out2, out_bc, out_umi,
                          fmt_rows: np.ndarray, threads: int = 1,
                          corrector=None, skip_err: bool = False) -> int:
        """Barcoded extraction loop in native code
        (t4x_extract_stream_bc2).  fmt_rows: (n, 4) int32 {cat, start,
        end, strand} sequence-sourced --readFormat segments; corrector:
        NativeBarcodeCorrector or None.  Returns the candidate count or
        raises."""
        j = lambda ps: "\n".join(ps).encode() if ps else None
        fr = np.ascontiguousarray(fmt_rows, dtype=np.int32)
        ns = (ctypes.c_int64 * 3)()
        n = self._lib.t4x_extract_stream_bc2(
            self._h, j(paths1), j(paths2), j(bc_paths), j(umi_paths),
            1 if umi_alias else 0,
            out1.encode(), out2.encode() if out2 else None,
            out_bc.encode() if out_bc else None,
            out_umi.encode() if out_umi else None,
            fr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(fr),
            threads,
            corrector._h if corrector is not None else None,
            1 if skip_err else 0, ns,
        )
        if n < 0:
            raise OSError(f"native barcoded extract failed for {paths1}")
        self.phase_ns = tuple(ns)
        return int(n)


    def filter_batch(self, reads: List[str], threads: int = 1) -> np.ndarray:
        """Per-read candidate code: 0 = reject, else HasHitInSet strand."""
        n = len(reads)
        enc = [r.encode("ascii") for r in reads]
        arr = (ctypes.c_char_p * n)(*enc)
        lens = (ctypes.c_int * n)(*[len(r) for r in reads])
        out = np.zeros(n, dtype=np.int8)
        self._lib.t4x_filter_batch(
            self._h,
            arr,
            lens,
            n,
            threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
        return out


class NativeBarcodeCorrector:
    """Native whitelist trie (t4x_bc_*); semantics mirror
    pipeline/barcode.py BarcodeCorrector exactly (oracle in tests)."""

    def __init__(self, whitelist_path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native extract filter unavailable")
        self._lib = lib
        self._h = lib.t4x_bc_create()
        import gzip

        opener = gzip.open if whitelist_path.endswith(".gz") else open
        with opener(whitelist_path, "rb") as fp:
            blob = fp.read()
        lib.t4x_bc_load(self._h, blob, len(blob))

    def collect_background(self, bc_paths, fmt_rows: np.ndarray,
                           case_cnt: int = 2_000_000) -> int:
        fr = np.ascontiguousarray(fmt_rows, dtype=np.int32)
        n = self._lib.t4x_bc_collect_background(
            self._h, "\n".join(bc_paths).encode(),
            fr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(fr),
            case_cnt,
        )
        if n < 0:
            raise OSError("native background collection failed")
        return int(n)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.t4x_bc_destroy(self._h)
                self._h = None
        except Exception:
            pass



def ingest_single(read_files, barcode_files, umi_files,
                  keep_missing_barcode: bool, want_bc_totals: bool):
    """Native assembler ingest for the single-end (+barcode/+umi) case
    (t4x_ingest_single).  Returns None when unavailable/overflowed, else
    a dict with reads/quals/ids lists, bc/umi id arrays, the barcode
    string table, per-barcode totals, first_read_len and the pre-filter
    record count."""
    lib = _load()
    if lib is None:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def total_size(paths):
        t = 0
        for p in paths or []:
            if p.endswith(".gz"):
                return None  # compressed: size bound unknown -> fallback
            try:
                t += os.path.getsize(p)
            except OSError:
                return None
        return t

    r_size = total_size(read_files)
    b_size = total_size(barcode_files) if barcode_files else 0
    u_size = total_size(umi_files) if umi_files else 0
    if r_size is None or b_size is None or u_size is None:
        return None
    reads_cap = r_size + 16
    n_cap = r_size // 4 + 16
    bct_cap = b_size + 16
    bct_n_cap = b_size // 4 + 16
    # numpy-backed blobs: no create_string_buffer zero-fill (first-touch
    # page faults on this VM run ~100MB/s) and no whole-buffer .raw copy
    # afterward — decode slices straight off memoryviews.
    u8p = ctypes.POINTER(ctypes.c_uint8)
    reads_blob = np.empty(reads_cap, dtype=np.uint8)
    quals_blob = np.empty(reads_cap, dtype=np.uint8)
    ids_blob = np.empty(reads_cap, dtype=np.uint8)
    read_offs = np.zeros(n_cap + 1, dtype=np.int64)
    id_offs = np.zeros(n_cap + 1, dtype=np.int64)
    bc_ids = np.zeros(n_cap, dtype=np.int32)
    umi_ids = np.zeros(n_cap, dtype=np.int32)
    bct_blob = np.empty(max(bct_cap, 1), dtype=np.uint8)
    bct_offs = np.zeros(bct_n_cap + 1, dtype=np.int64)
    bc_totals = np.zeros(max(bct_n_cap, 1), dtype=np.int64)
    out_meta = np.zeros(3, dtype=np.int64)
    n = lib.t4x_ingest_single(
        "\n".join(read_files).encode(),
        "\n".join(barcode_files).encode() if barcode_files else None,
        "\n".join(umi_files).encode() if umi_files else None,
        1 if keep_missing_barcode else 0, 1 if want_bc_totals else 0,
        reads_blob.ctypes.data_as(u8p), reads_cap,
        read_offs.ctypes.data_as(i64p),
        quals_blob.ctypes.data_as(u8p), ids_blob.ctypes.data_as(u8p),
        reads_cap, id_offs.ctypes.data_as(i64p),
        bc_ids.ctypes.data_as(i32p), umi_ids.ctypes.data_as(i32p), n_cap,
        bct_blob.ctypes.data_as(u8p), bct_cap,
        bct_offs.ctypes.data_as(i64p), bct_n_cap,
        bc_totals.ctypes.data_as(i64p), out_meta.ctypes.data_as(i64p),
    )
    if n < 0:
        return None
    n = int(n)
    rb = memoryview(reads_blob).cast("B")
    qb = memoryview(quals_blob).cast("B")
    ib = memoryview(ids_blob).cast("B")
    ro = read_offs[: n + 1].tolist()
    io_ = id_offs[: n + 1].tolist()
    n_bc = int(out_meta[1])
    bo = bct_offs[: n_bc + 1].tolist()
    bt = memoryview(bct_blob).cast("B")
    return {
        "reads": [
            str(rb[ro[i]: ro[i + 1]], "ascii") for i in range(n)
        ],
        "quals": [
            str(qb[ro[i]: ro[i + 1]], "ascii") for i in range(n)
        ],
        "ids": [
            str(ib[io_[i]: io_[i + 1]], "ascii") for i in range(n)
        ],
        "bc_ids": bc_ids[:n].tolist(),
        "umi_ids": umi_ids[:n].tolist(),
        "barcode_table": [
            str(bt[bo[i]: bo[i + 1]], "ascii") for i in range(n_bc)
        ],
        "bc_totals": bc_totals[:n_bc].tolist(),
        "first_read_len": int(out_meta[0]),
        "n_total": int(out_meta[2]),
    }
