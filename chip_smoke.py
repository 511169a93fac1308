#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (trust4_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port only (never jax, never trust4_tpu):

1. prints the card (nvidia-smi name and power limit) and builds every
   kernel from csrc/ with nvcc (one process per source, all at once);
2. kernel phase: the gap-fill counts kernel, every (W, L) instance the
   library is built for (L lanes per job), at each tier's full chunk, a
   partial and a small batch per tier and a ragged batch of 33 jobs:
   bit-equal to its plain PyTorch version on the card (scores and
   counts, both epilogues, in the wrapper's order and a random
   permutation), the wrapper's own launch likewise, a 2,000-job sample
   of each full chunk against the native CPU DP; per instance the warm
   CUDA-event median of 15 launches, the back-to-back device time, SASS
   per tile and per band cell, registers and spills, beside the bound
   and the instance the wrapper's table chose; then the scores kernel the
   same way at the entry, bench, mixed, realign-sized (2,300 pairs) and
   ragged shapes at W=32, and a mixed and a realign-sized batch at W =
   16, 24, 48; each W=32 sample is held against the native
   ``global_alignment`` score;
3. entry phase: ``trust4_tpu_torch.entry.entry(device="cuda")`` (the
   prefilter and the scores kernel) against the same step with the plain
   DP on the card;
4. gold phase: the paired-end gold reads through ``run_trust4`` on the
   card in check mode with the stand-in references; every artifact must
   equal tests/data/gold_*;
5. scale phase: a 500k-read bulk corpus (tools/make_bench_corpus.py) run
   on the card with the default settings (the main path: launches counted
   from 0 around it; the gap oracle's per-tier launches and CUDA-event
   kernel ms) and again with TRUST4_TPU_DEVICE=0; the artifacts must be
   byte-identical and the kernel must have launched; a third card run
   under torch.profiler gives the device's busy and idle share;
6. realign phase: the scale run's own candidate reads and contigs, with
   the stand-in coordinate FASTA as germline, through ``realign_round``
   on the card (launches counted from 0 around it); its five outputs must
   equal the same round with the plain DP on the card, and on a sample
   the round on the CPU;
7. prefilter phase: a 20,000-read corpus through ``run_trust4`` with
   ``use_tpu_prefilter=True`` on the card and with the default native
   extractor; every artifact must be byte-identical;
8. dirs phase: the traceback-bits path (``ops/dp_dirs.dirs_counts``: the
   dirs kernel, then the decoder) at each tier's full chunk (launches
   counted from 0 around it); the kernel's scores and whole (N, P, W)
   bits tensor bit-equal to its plain version, the decoded counts equal
   to the counts kernel's and to the native DP on a sample; the mixed
   scores batch at W=32 with its out-of-tile rows at -2^29; medians of
   the kernel, the plain version and the decoder beside the bound;
9. lab phase: ``trust4_tpu_torch.tools.dp_kernel_lab`` at the bench shape
   (modes base, inter2, inter4, abl, then abl per DP_ABLATE flag;
   launches counted from 0 around it); each lab kernel bit-equal to its
   plain version, the no-flag kernels also to the scores kernel;
10. microbench phase: ``trust4_tpu_torch.tools.vpu_microbench`` (every
   body and size; launches counted from 0 around it); each body's output
   equal to the plain body's, with ms per launch, ns/op and the body's
   SASS instruction count.

Small launches spend much of their CUDA-event time in the host's gap
before the kernel starts, so the dirs, lab and microbench phases also
report each kernel's time in back-to-back launches (``device_ms``).

It prints one ``{"kernels": [...]}`` line, the card line again, and last
``{"ok": true, "device": {...}}``.  Any failure raises, so the script
exits non-zero without that line; it also does so when no CUDA device is
visible.
"""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# Read by pipeline/run.py at import: per-stage walls on stderr.
os.environ["TRUST4_TPU_STAGE_TIMES"] = "1"

import torch  # noqa: E402

import trust4_tpu_torch  # noqa: E402,F401  (fails outside a checkout)

GOLD = os.path.join(REPO, "tests", "data")
ARTIFACTS = ("_raw.out", "_assembled_reads.fa", "_final.out", "_annot.fa",
             "_cdr3.out")

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 at
# 3.35 TB/s; int32 operations at the SM's issue ceiling, 132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz boost.  (The 64 INT32 lanes per SM
# are not the ceiling: the scores kernel's compiled loop ran faster than
# they allow, so part of its integer work issues to other lanes.)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# int32 operations the function needs per band cell (see _band_cells),
# counted from the recurrence (AlignAlgo.hpp GlobalAlignment), not from a
# kernel's masked W-wide sweep.  Scores: match test 3 (compare, N test on
# the text base, or; the query base's N test is per row), substitution
# select 1, diagonal add 1, E = max(E+GE, M+GO+GE) 3, F likewise 3,
# M = max of three 2: 13.
SCORE_OPS_PER_CELL = 13
# Counts (dp_counts.cuh): the score's 13, four tie compares, CM 4
# (increment select, add, two selects), CE 2 and CF 2 (select, add): 25.
OPS_PER_CELL = 25
# Traceback bits (dp_dirs.cuh): the score's 13, the four bit tests (b0,
# b1 and b2 one compare each, b2 reusing E's m_up + GO+GE; b3 an add and a
# compare: 5) and packing four bits into a byte (three shifts, three ors:
# 6): 24.
DIRS_OPS_PER_CELL = 24
N_TIMED = 15
N_SAMPLE = 2000
SCALE_READS = 500_000
PREFILTER_READS = 20_000


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_build() -> dict:
    """nvcc for the kernels, then g++ for the native libraries, so no
    later phase times a build.  Returns the SASS counts (_sass_counts) of
    every kernel instance, with the registers and spills ptxas reported
    for it."""
    from trust4_tpu_torch.ops import build
    from trust4_tpu_torch.utils.nativebuild import ensure_built

    t0 = time.perf_counter()
    build.build_all()
    t1 = time.perf_counter()
    for lib in ("libt4align.so", "libt4extract.so", "libt4overlap.so",
                "libt4bam.so"):
        ensure_built(lib)
    print(f"build: nvcc {t1 - t0:.2f}s {json.dumps(build.BUILD_SECONDS)}, "
          f"native {time.perf_counter() - t1:.2f}s", flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "error" in line:
                print(f"  nvcc {name}: {line.strip()}")
    usage = _ptxas_usage("\n".join(build.BUILD_LOG.values()))
    sass = {}
    for name in build.kernel_names():
        sass.update(_sass_counts(build.library_path(name)))
        for k, v in sass.items():
            v.update(usage.get(k, {}))
        print(f"  sass {name}: " + json.dumps(
            {k: v for k, v in sass.items() if v["library"] == name}))
    return sass


_KERNEL_NAME = re.compile(r"([a-z_]+_kernel)I((?:L[a-z]\d+E)+)E")


def _kernel_key(mangled: str) -> str:
    """'dp_counts_kernel<48,8>' from a mangled kernel name."""
    m = _KERNEL_NAME.search(mangled)
    args = re.findall(r"L[a-z](\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def _ptxas_usage(log: str) -> dict:
    """Registers and spill bytes per kernel instance from nvcc's
    ``-Xptxas -v`` output (empty for a library found built)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            cur = (_kernel_key(m.group(1)) if _KERNEL_NAME.search(m.group(1))
                   else None)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def _sass_counts(lib: str) -> dict:
    """SASS instructions (cuobjdump) of each kernel instance in a built
    library, keyed by the kernel's name and full template arguments
    ("dp_inter_kernel<32,2>"): ``total`` in the function; ``loop`` inside
    its widest backward branch (its row loop), where it has one; and for
    the DP kernels ``per_tile_cell`` = loop / the tile cells a thread
    sweeps per row: W x jobs per thread, or W / L for the group kernels
    (dp_counts_kernel<W,L>, dp_scores_kernel<W,L>), W being the first
    template argument.  The DP kernels sweep all their tile cells of a
    row, so that is what they issue per tile cell, beside the operations
    the function needs per band cell (OPS_PER_CELL, SCORE_OPS_PER_CELL,
    DIRS_OPS_PER_CELL).  The microbenchmark bodies are unrolled in full,
    so their ``total`` holds the K operations."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        raise RuntimeError("cuobjdump not found")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    library = re.match(r"lib(\w+?)_[0-9a-f]{16}\.so$",
                       os.path.basename(lib)).group(1)
    out = {}
    for fn in sass.split("Function : ")[1:]:
        key = _kernel_key(fn.split()[0])
        name = key.split("<")[0]
        args = [int(a) for a in key[len(name) + 1:-1].split(",")]
        ins = [(int(a, 16), op) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        rec = {"library": library, "total": len(ins)}
        loops = [(int(t, 16), a) for a, op in ins
                 for t in re.findall(r"BRA\s+0x([0-9a-f]+)", op)
                 if int(t, 16) < a]
        if loops:
            lo, hi = max(loops, key=lambda x: x[1] - x[0])
            rec["loop"] = sum(lo <= a <= hi for a, _ in ins)
            if name.startswith("dp_"):
                cells = (args[0] * args[1] if name == "dp_inter_kernel" else
                         args[0] // args[1] if name in _GROUP_KERNELS else
                         args[0])
                rec["per_tile_cell"] = round(rec["loop"] / cells, 2)
            if name in _GROUP_KERNELS:
                # One row loop per tile width the kernel can narrow to
                # (dp_lanes.cuh narrow_width), the wider the longer.
                rec["per_tile_cell_by_width"] = _row_loops(
                    ins, loops, args[0], args[1])
        out[key] = rec
    return dict(sorted(out.items()))


# The group kernels: template arguments <W, L>, W / L cells per lane.
_GROUP_KERNELS = ("dp_counts_kernel", "dp_scores_kernel")


def _row_loops(ins, loops, w: int, lanes: int) -> dict:
    """SASS per tile cell of each row loop of a group kernel, by the tile
    width its path sweeps: the outermost loops of 40 instructions or more,
    longest first, matched to the widths narrow_width can pick, widest
    first."""
    spans = []
    for lo, hi in sorted(loops, key=lambda x: x[0] - x[1]):
        if not any(a <= lo and hi <= b for a, b in spans):
            spans.append((lo, hi))
    sizes = sorted((sum(lo <= a <= hi for a, _ in ins) for lo, hi in spans),
                   reverse=True)
    widths = [w] + [x for x in (32, 24, 16) if x < w and x % lanes == 0]
    return {str(x): round(n / (x // lanes), 2)
            for x, n in zip(widths, [n for n in sizes if n >= 40])}


def _band_cells(t_lens, p_lens, w: int, p_max: int) -> int:
    """Band cells the function needs, from this run's lengths: for each
    pair whose final cell lies in the W-cell tile, the cells of rows
    1..min(p_len, p_max) at columns 1 <= j <= t_len within the band
    i-left <= j <= i+right (and the tile).  A pair whose final cell lies
    outside the tile needs none (its score is INT32_MIN).  The kernels
    sweep all W tile cells of every row; the cells beyond the band are
    their overhead, not work the function needs."""
    total = 0
    for s in range(0, len(t_lens), 8192):  # bounded temporaries
        tl = t_lens[s:s + 8192].astype(np.int64)[:, None]
        pl = p_lens[s:s + 8192].astype(np.int64)[:, None]
        left = 5 + np.maximum(0, pl - tl)
        right = 5 + np.maximum(0, tl - pl)
        in_tile = (tl - pl + left >= 0) & (tl - pl + left < w)
        i = np.arange(1, p_max + 1, dtype=np.int64)[None, :]
        lo = np.maximum(1, i - left)
        hi = np.minimum(np.minimum(tl, i + right), i - left + w - 1)
        cnt = np.clip(hi - lo + 1, 0, None) * (i <= pl) * in_tile
        total += int(cnt.sum())
    return total


def _median_ms(fn, n: int) -> float:
    """Median over n launches of fn, each between its own CUDA events,
    after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _instance_records(name, sass, key_w, t_lens, p_lens, w, cells,
                      tile_cells, want, run, launch_one):
    """Every built (W, L) instance of one kernel on one batch: checked
    bit-equal to the plain version (want, on the card) in the wrapper's
    order (dp_counts.job_order) and a random permutation, then
    timed; returns {L: record} with ms (CUDA-event median) and device_ms
    (back to back) of launch_one(lanes, order), one launch, and the SASS
    counts with per band cell, registers and spills.  run(lanes, order)
    gives the outputs held against want."""
    from trust4_tpu_torch.ops.build import instances
    from trust4_tpu_torch.ops.dp_counts import job_order

    order = job_order(t_lens, p_lens)
    perm = torch.from_numpy(np.random.default_rng(len(order)).permutation(
        len(order))).to(order.device)
    recs = {}
    for ww, lanes in instances(name):
        if ww != w:
            continue
        for o in (order, perm):
            got = run(lanes, o)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    bad = int((a != b).reshape(len(a), -1).any(1).sum())
                    raise AssertionError(
                        f"{name}<{w},{lanes}>: differs from the plain "
                        f"version in {bad} jobs")
        key = f"{key_w}<{w},{lanes}>"
        rec = {k: sass[key].get(k) for k in ("loop", "per_tile_cell",
                                               "registers", "spill_stores",
                                               "spill_loads")}
        rec["per_band_cell"] = (None if not cells or rec["per_tile_cell"]
                                is None else
                                rec["per_tile_cell"] * tile_cells / cells)
        rec["ms"] = _median_ms(lambda: launch_one(lanes, order), N_TIMED)
        recs[lanes] = rec
    dev_ms = _device_ms([lambda ln=ln: launch_one(ln, order) for ln in recs],
                        N_TIMED)
    for rec, ms in zip(recs.values(), dev_ms):
        rec["device_ms"] = ms
    return recs


def _pick(rec: dict, chosen: int) -> None:
    """The chosen instance's numbers on the shape's record, beside the
    one-thread (L = 1) instance's and the fastest instance's."""
    inst = rec["instances"]
    rec["chosen_lanes"] = chosen
    rec["ms"] = inst[chosen]["ms"]
    rec["device_ms"] = inst[chosen]["device_ms"]
    rec["per_thread_ms"] = inst[1]["ms"]
    rec["per_thread_device_ms"] = inst[1]["device_ms"]
    rec["fastest_lanes"] = min(inst, key=lambda ln: inst[ln]["device_ms"])
    rec["chosen_over_per_thread"] = (inst[chosen]["device_ms"]
                                     / inst[1]["device_ms"])
    rec["kernel_over_bound"] = rec["ms"] / rec["bound_ms"]
    rec["device_over_bound"] = rec["device_ms"] / rec["bound_ms"]
    rec["cells_per_s"] = rec["cells"] / (rec["device_ms"] * 1e-3)


# Counts shapes beside each tier's full chunk of testing.rand_gap_jobs
# (at most four edits a job, so nearly every band fits 16 cells): the
# same chunk with the main path's mix of band widths ("gapmix"), a
# partial chunk (about the last chunk of a sample's tier: 0.97 / 0.54 /
# 0.67 chunks in PERF.md section 5; 11,000 jobs at tier 2) and a small
# batch with that mix, and at tier 2 a ragged batch of 33 jobs.
PARTIAL_JOBS = {16: 43690, 24: 21845, 48: 11000}
SMALL_JOBS = 2000
RAGGED_JOBS = 33
# Shares of each tier's unique jobs by the tile width the kernels narrow
# them to, on the main path (the scale phase's gap_oracle.STATS
# tier_widths, on an H100; PERF.md section 6).  Each width holds the length
# differences |t - p| from the previous width's + 1 to its own - 12, the
# band width W itself up to W - 11 (a tier's band is 11 + |t - p| <= W).
GAP_WIDTH_SHARES = {16: {16: 1.0},
                    24: {16: 0.814, 24: 0.186},
                    48: {16: 0.569, 24: 0.329, 32: 0.085, 48: 0.016}}


def _gapmix_jobs(rng, n: int, cap: int, w: int):
    """rand_gap_jobs with each job's length difference redrawn so the
    band widths follow GAP_WIDTH_SHARES[w] (query rows cut or padded with
    random bases; zero-length rows kept)."""
    from trust4_tpu_torch.testing import rand_gap_jobs

    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, n, cap, w)
    widths = sorted(GAP_WIDTH_SHARES[w])
    shares = np.array([GAP_WIDTH_SHARES[w][x] for x in widths])
    pick = rng.choice(len(widths), n, p=shares / shares.sum())
    lo = np.array([0] + [x - 11 for x in widths[:-1]])[pick]
    hi = np.array([x - 12 for x in widths[:-1]] + [w - 11])[pick]
    d = rng.integers(lo, hi + 1)
    live = (tl > 0) & (pl > 0)
    longer = rng.random(n) < 0.5
    new_pl = np.where(longer, tl + d, tl - d).clip(1, cap)
    pl = np.where(live, new_pl, pl).astype(np.int32)
    grow = np.arange(cap)[None, :] >= _ps_lens(_ps)[:, None]
    pc[grow] = rng.integers(0, 4, int(grow.sum()))
    pc[np.arange(cap)[None, :] >= pl[:, None]] = 5
    return tc, tl, pc, pl


def _ps_lens(ps) -> np.ndarray:
    return np.array([len(p) for p in ps], np.int64)


def phase_kernels(sass: dict):
    """The counts kernel against its plain version: every (W, L) instance
    at each tier's full chunk, the chunk, a partial and a small batch with
    the main path's band widths, and a ragged batch, with the wrapper's
    own launch; a native sample at the full chunks.  Returns the
    per-shape records (full chunks first)."""
    from trust4_tpu_torch.align.native import global_alignment_counts
    from trust4_tpu_torch.ops import dp_counts
    from trust4_tpu_torch.ops.dp import banded_affine_counts_plain
    from trust4_tpu_torch.ops.gap_oracle import _TIERS
    from trust4_tpu_torch.testing import rand_gap_jobs

    dev = torch.device("cuda")
    shapes = [("chunk", cap, w, chunk) for cap, w, chunk in _TIERS]
    shapes += [(kind, cap, w, n) for cap, w, chunk in _TIERS
               for kind, n in (("gapmix", chunk), ("partial", PARTIAL_JOBS[w]),
                               ("small", SMALL_JOBS))]
    cap, w, _ = _TIERS[-1]
    shapes.append(("ragged", cap, w, RAGGED_JOBS))
    records = []
    for kind, cap, w, n in shapes:
        rng = np.random.default_rng(1000 + cap if kind == "chunk" else
                                    2000 + cap + n)
        if kind in ("chunk", "ragged"):
            ts, ps, tc, tl, pc, pl = rand_gap_jobs(rng, n, cap, w)
        else:
            tc, tl, pc, pl = _gapmix_jobs(rng, n, cap, w)
        args = dp_counts.to_device_jobs(tc, tl, pc, pl, dev)
        s_p, c_p = banded_affine_counts_plain(*args, w)
        pk_p = banded_affine_counts_plain(*args, w, packed=True)
        s_k, c_k = dp_counts.banded_affine_counts(*args, w)
        pk_k = dp_counts.banded_affine_counts(*args, w, packed=True)
        torch.cuda.synchronize()
        for what, a, b in (("scores", s_k, s_p), ("counts", c_k, c_p),
                           ("packed", pk_k, pk_p)):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(len(a), -1).any(1).sum())
                raise AssertionError(
                    f"counts {kind} ({cap},{w},{n}): wrapper {what} differ "
                    f"from the plain version in {bad} jobs")
        max_abs_err = int(max((s_k - s_p).abs().max(),
                              (c_k - c_p).abs().max(),
                              (pk_k - pk_p).abs().max()))
        if kind == "chunk":
            counts = c_k.cpu().numpy()
            for i in rng.choice(n, N_SAMPLE, replace=False):
                want = ((0, 0, 0) if tl[i] == 0 or pl[i] == 0 else
                        global_alignment_counts(ts[i][: tl[i]],
                                                ps[i][: pl[i]]))
                got = tuple(int(v) for v in counts[i])
                if got != want:
                    raise AssertionError(f"tier ({cap},{w}) job {i}: "
                                         f"kernel {got} vs native {want}")
        rec = {"shape": kind, "cap": cap, "w": w, "chunk": n, "n": n}
        rec["tile_cells"] = int(np.minimum(pl, cap).astype(np.int64).sum()) * w
        rec["cells"] = _band_cells(tl, pl, w, cap)
        rec["bytes"] = int(tc.nbytes + pc.nbytes + 8 * n + 16 * n)
        ops_s = rec["cells"] * OPS_PER_CELL / INT32_OPS_PER_S
        bytes_s = rec["bytes"] / HBM_BYTES_PER_S
        rec["bound_ms"] = 1e3 * max(bytes_s, ops_s)
        rec["bound_by"] = "bytes" if bytes_s > ops_s else "operations"
        rec["max_abs_err"] = max_abs_err
        # Each instance is timed in the unpacked epilogue (what the gap
        # oracle reads); the wrapper's time adds the length sort.
        rec["instances"] = _instance_records(
            "dp_counts", sass, "dp_counts_kernel", args[1], args[3], w,
            rec["cells"],
            rec["tile_cells"], (s_p, c_p, pk_p),
            lambda ln, o: (*dp_counts.launch(*args, w, False, ln, o),
                           dp_counts.launch(*args, w, True, ln, o)),
            lambda ln, o: dp_counts.launch(*args, w, False, ln, o))
        _pick(rec, dp_counts.lanes_for(n, w))
        rec["wrapper_ms"] = _median_ms(
            lambda: dp_counts.banded_affine_counts(*args, w), N_TIMED)
        if kind == "chunk":
            rec["packed_ms"] = _median_ms(
                lambda: dp_counts.banded_affine_counts(*args, w, packed=True),
                N_TIMED)
            rec["plain_ms"] = _median_ms(
                lambda: banded_affine_counts_plain(*args, w), N_TIMED)
        print(f"kernel {kind} {json.dumps(rec)}", flush=True)
        records.append(rec)
    return records


def _score_inputs(shape: str, w: int = 32):
    """numpy (t_codes, t_lens, p_codes, p_lens) of one scores shape: the
    entry step's pairs, bench.py's launch (the text row doubles as the
    query, bench.py:334-337), a mixed 65,536-pair batch inside band_ok
    with N bases, some zero-length rows and some rows with t_len - p_len
    >= W-5 (final cell outside the band: INT32_MIN), a realign-sized batch
    (2,300 of the scale corpus's 100 bp reads against windows of their
    length +-10, t_max = 116 as realign_round pads them, 2% substitutions)
    and a ragged batch of 33 mixed rows."""
    if shape == "entry":
        rng = np.random.default_rng(1)
        tc = rng.integers(0, 4, size=(256, 128), dtype=np.int8)
        pc = rng.integers(0, 4, size=(256, 128), dtype=np.int8)
        return tc, np.full(256, 120, np.int32), pc, np.full(256, 118, np.int32)
    if shape == "bench":
        rng = np.random.default_rng(0)
        tc = rng.integers(0, 4, size=(65536, 152), dtype=np.int8)
        return tc, np.full(65536, 150, np.int32), tc, np.full(65536, 148,
                                                              np.int32)
    if shape == "realign":
        rng = np.random.default_rng(3 + w)
        n = 2300
        pc = rng.integers(0, 4, size=(n, 100), dtype=np.int8)
        tl = (100 + rng.integers(-10, 11, n)).astype(np.int32)
        tc = np.full((n, 116), 5, np.int8)
        tc[:, :100] = pc
        tc[:, 100:110] = rng.integers(0, 4, size=(n, 10), dtype=np.int8)
        sub = rng.random((n, 116)) < 0.02
        tc[sub] = rng.integers(0, 4, int(sub.sum()))
        tc[np.arange(116)[None, :] >= tl[:, None]] = 5
        return tc, tl, pc, np.full(n, 100, np.int32)
    n, cap = (33 if shape == "ragged" else 65536), 152
    rng = np.random.default_rng(2 if shape == "mixed" and w == 32 else
                                4 + w + n)
    tc = rng.integers(0, 4, size=(n, cap), dtype=np.int8)
    tl = rng.integers(1, cap + 1, n).astype(np.int32)
    pl = np.clip(tl + rng.integers(-(w - 11), w - 10, n), 0, cap)
    pc = tc.copy()
    sub = rng.random((n, cap)) < 0.05
    pc[sub] = rng.integers(0, 5, int(sub.sum()))
    tc[rng.random((n, cap)) < 0.01] = 4
    pl = pl.astype(np.int32)
    k = max(1, 600 * n // 65536)  # 600 of 65,536
    z = rng.choice(n, 2 * k, replace=False)
    tl[z[:k]] = 0
    pl[z[k:]] = 0
    far = rng.choice(n, 2 * k, replace=False)
    tl[far] = cap
    pl[far] = cap - (w - 5) - rng.integers(0, 40, len(far))
    for codes, lens in ((tc, tl), (pc, pl)):  # pad beyond each length
        codes[np.arange(cap)[None, :] >= lens[:, None]] = 5
    return tc, tl, pc, pl


# Scores shapes: (name, band width).  W = 32 is entry's, the bench's and
# the realign round's; the mixed and realign-sized batches at the other
# widths time the instances the choice table names there.
SCORE_SHAPES = [("entry", 32), ("bench", 32), ("mixed", 32), ("realign", 32),
                ("ragged", 32)] + [(s, w) for w in (16, 24, 48)
                                   for s in ("mixed", "realign")]


def phase_scores(sass: dict):
    """The scores kernel against its plain version: every (W, L) instance
    at each of SCORE_SHAPES, with the wrapper's own launch; a native
    sample on each W = 32 shape.  Returns the per-shape records."""
    from trust4_tpu_torch.align.native import global_alignment
    from trust4_tpu_torch.ops import dp_scores
    from trust4_tpu_torch.ops.dp import band_ok, banded_affine_scores_plain
    from trust4_tpu_torch.ops.dp_counts import to_device_jobs

    dev = torch.device("cuda")
    records = []
    for shape, w in SCORE_SHAPES:
        tc, tl, pc, pl = _score_inputs(shape, w)
        args = to_device_jobs(tc, tl, pc, pl, dev)
        s_k = dp_scores.banded_affine_scores(*args, w)
        s_p = banded_affine_scores_plain(*args, w)
        torch.cuda.synchronize()
        if not torch.equal(s_k, s_p):
            raise AssertionError(
                f"scores {shape} W={w}: kernel differs from the plain "
                f"version in {int((s_k != s_p).sum())} pairs"
            )
        got = s_k.cpu().numpy()
        if w == 32:
            rng = np.random.default_rng(7)
            ok = np.flatnonzero(band_ok(tl, pl, w) & (tl > 0) & (pl > 0))
            alphabet = np.frombuffer(b"ACGTNN", np.uint8)
            for i in rng.choice(ok, min(N_SAMPLE, len(ok)), replace=False):
                t = alphabet[tc[i, : tl[i]]].tobytes().decode()
                p = alphabet[pc[i, : pl[i]]].tobytes().decode()
                want = global_alignment(t, p)[0]
                if got[i] != want:
                    raise AssertionError(
                        f"scores {shape} pair {i}: kernel {got[i]} vs "
                        f"native {want}")
        rows = np.minimum(pl, pc.shape[1]).astype(np.int64)
        rec = {"shape": shape, "n": len(tl), "t_max": tc.shape[1],
               "p_max": pc.shape[1], "w": w,
               "int32_min_rows": int((got == np.iinfo(np.int32).min).sum()),
               "tile_cells": int(rows.sum()) * w,
               "cells": _band_cells(tl, pl, w, pc.shape[1]),
               "bytes": int(tc.nbytes + pc.nbytes + 12 * len(tl))}
        ops_s = rec["cells"] * SCORE_OPS_PER_CELL / INT32_OPS_PER_S
        bytes_s = rec["bytes"] / HBM_BYTES_PER_S
        rec["bound_ms"] = 1e3 * max(ops_s, bytes_s)
        rec["bound_by"] = "bytes" if bytes_s > ops_s else "operations"
        rec["max_abs_err"] = int((s_k.long() - s_p.long()).abs().max())
        rec["instances"] = _instance_records(
            "dp_scores", sass, "dp_scores_kernel", args[1], args[3], w,
            rec["cells"],
            rec["tile_cells"], (s_p,),
            lambda ln, o: (dp_scores.launch(*args, w, ln, o),),
            lambda ln, o: dp_scores.launch(*args, w, ln, o))
        _pick(rec, dp_scores.lanes_for(len(tl), w))
        rec["wrapper_ms"] = _median_ms(
            lambda: dp_scores.banded_affine_scores(*args, w), N_TIMED)
        if w == 32 or shape == "mixed":
            rec["plain_ms"] = _median_ms(
                lambda: banded_affine_scores_plain(*args, w), N_TIMED)
        print(f"scores kernel {json.dumps(rec)}", flush=True)
        records.append(rec)
    return records


def _dirs_cells(t_lens, p_lens, w: int, p_max: int) -> int:
    """Band cells whose bits the dirs function outputs: for every pair,
    the cells of rows 1..p_max (rows beyond p_len included: their bits
    are part of the (N, P, W) output) at columns 1 <= j <= t_len within
    the band and the tile."""
    total = 0
    for s in range(0, len(t_lens), 8192):  # bounded temporaries
        tl = t_lens[s:s + 8192].astype(np.int64)[:, None]
        pl = p_lens[s:s + 8192].astype(np.int64)[:, None]
        left = 5 + np.maximum(0, pl - tl)
        right = 5 + np.maximum(0, tl - pl)
        i = np.arange(1, p_max + 1, dtype=np.int64)[None, :]
        lo = np.maximum(1, i - left)
        hi = np.minimum(np.minimum(tl, i + right), i - left + w - 1)
        total += int(np.clip(hi - lo + 1, 0, None).sum())
    return total


def _dirs_record(tag, tc, tl, pc, pl, w, args, max_abs_err) -> dict:
    """Bound and CUDA-event medians of the dirs kernel and its plain
    version on one batch (the inputs on the card in args)."""
    from trust4_tpu_torch.ops import dp_dirs
    from trust4_tpu_torch.ops.dp import banded_affine_dirs_plain

    n, p_max = len(tl), pc.shape[1]
    rec = {"shape": tag, "n": n, "t_max": tc.shape[1], "p_max": p_max,
           "w": w, "cells": _dirs_cells(tl, pl, w, p_max),
           "live_rows": int(np.minimum(pl, p_max).astype(np.int64).sum()),
           "rows": n * p_max,
           "bytes": int(tc.nbytes + pc.nbytes + 12 * n + n * p_max * w)}
    ops_s = rec["cells"] * DIRS_OPS_PER_CELL / INT32_OPS_PER_S
    bytes_s = rec["bytes"] / HBM_BYTES_PER_S
    rec["bound_ms"] = 1e3 * max(ops_s, bytes_s)
    rec["bound_by"] = "bytes" if bytes_s > ops_s else "operations"
    rec["max_abs_err"] = max_abs_err
    rec["ms"] = _median_ms(lambda: dp_dirs.banded_affine_dirs(*args, w),
                           N_TIMED)
    rec["plain_ms"] = _median_ms(lambda: banded_affine_dirs_plain(*args, w),
                                 N_TIMED)
    rec["kernel_over_bound"] = rec["ms"] / rec["bound_ms"]
    return rec


def phase_dirs():
    """The traceback-bits path (ops/dp_dirs.dirs_counts: the dirs kernel,
    then the decoder) at each gap-oracle tier's full chunk, launches
    counted from 0 around it; then per tier the kernel's scores and whole
    (N, P, W) bits tensor against the plain version, the decoded counts
    against the counts kernel and a native sample, and timings; and the
    mixed scores batch at W=32 with its out-of-tile rows pinned at -2^29.
    Returns (launches, per-tier records, mixed record)."""
    from trust4_tpu_torch.align.native import global_alignment_counts
    from trust4_tpu_torch.ops import dp_counts, dp_dirs
    from trust4_tpu_torch.ops.dp import banded_affine_dirs_plain
    from trust4_tpu_torch.ops.gap_oracle import _TIERS
    from trust4_tpu_torch.testing import rand_gap_jobs

    dev = torch.device("cuda")
    jobs = []
    for cap, w, chunk in _TIERS:
        rng = np.random.default_rng(1000 + cap)
        ts, ps, tc, tl, pc, pl = rand_gap_jobs(rng, chunk, cap, w)
        jobs.append((cap, w, chunk, rng, ts, ps, tc, tl, pc, pl,
                     dp_counts.to_device_jobs(tc, tl, pc, pl, dev)))
    dp_dirs.LAUNCHES = 0
    outs = [dp_dirs.dirs_counts(*job[-1], job[1]) for job in jobs]
    torch.cuda.synchronize()
    launches = dp_dirs.LAUNCHES
    if launches == 0:
        raise AssertionError("dirs phase: the dirs kernel never launched")

    records = []
    for (cap, w, chunk, rng, ts, ps, tc, tl, pc, pl, args), (s_path, c_path) \
            in zip(jobs, outs):
        s_k, d_k = dp_dirs.banded_affine_dirs(*args, w)
        s_p, d_p = banded_affine_dirs_plain(*args, w)
        _s, c_counts = dp_counts.banded_affine_counts(*args, w)
        torch.cuda.synchronize()
        for what, a, b in (("scores", s_k, s_p), ("dirs", d_k, d_p),
                           ("path scores", s_path, s_p),
                           ("decoded counts vs the counts kernel", c_path,
                            c_counts)):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(len(a), -1).any(1).sum())
                raise AssertionError(
                    f"dirs tier ({cap},{w},{chunk}): {what} differ in {bad} "
                    "jobs")
        counts = c_path.cpu().numpy()
        for i in rng.choice(chunk, N_SAMPLE, replace=False):
            want = ((0, 0, 0) if tl[i] == 0 or pl[i] == 0 else
                    global_alignment_counts(ts[i][: tl[i]], ps[i][: pl[i]]))
            if tuple(int(v) for v in counts[i]) != want:
                raise AssertionError(f"dirs tier ({cap},{w}) job {i}: "
                                     f"{counts[i]} vs native {want}")
        err = int(max((s_k - s_p).abs().max(),
                      (d_k.int() - d_p.int()).abs().max()))
        del s_k, d_k, s_p, d_p
        rec = _dirs_record(f"tier ({cap},{w},{chunk})", tc, tl, pc, pl, w,
                           args, err)
        dirs = dp_dirs.banded_affine_dirs(*args, w)[1]
        rec["decode_steps"] = 2 * (cap + cap) + 4
        rec["decode_ms"] = _median_ms(
            lambda: dp_dirs.decode_dirs_counts(dirs, *args, w=w, p_max=cap),
            N_TIMED)
        del dirs
        rec["counts_kernel_ms"] = _median_ms(
            lambda: dp_counts.banded_affine_counts(*args, w), N_TIMED)
        records.append(rec)

    tc, tl, pc, pl = _score_inputs("mixed")
    w = 32
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, dev)
    s_k, d_k = dp_dirs.banded_affine_dirs(*args, w)
    s_p, d_p = banded_affine_dirs_plain(*args, w)
    torch.cuda.synchronize()
    if not (torch.equal(s_k, s_p) and torch.equal(d_k, d_p)):
        raise AssertionError("dirs mixed: kernel differs from the plain "
                             "version")
    k_final = tl.astype(np.int64) - pl + np.where(tl < pl, 5 + (pl - tl), 5)
    off = (k_final < 0) | (k_final >= w)
    got = s_k.cpu().numpy()
    if not off.any() or (got[off] != -(1 << 29)).any() \
            or (got[~off] == -(1 << 29)).any():
        raise AssertionError("dirs mixed: out-of-tile rows not at -2^29")
    err = int(max((s_k - s_p).abs().max(),
                  (d_k.int() - d_p.int()).abs().max()))
    del s_k, d_k, s_p, d_p
    mixed = _dirs_record("mixed", tc, tl, pc, pl, w, args, err)
    mixed["out_of_tile_rows"] = int(off.sum())

    # Back-to-back device times: per tier the dirs and the counts kernel,
    # then the dirs kernel on the mixed batch.
    calls = []
    for job in jobs:
        calls += [lambda a=job[-1], w=job[1]: dp_dirs.banded_affine_dirs(*a, w),
                  lambda a=job[-1], w=job[1]:
                  dp_counts.banded_affine_counts(*a, w)]
    calls.append(lambda: dp_dirs.banded_affine_dirs(*args, w))
    dev_ms = _device_ms(calls, N_TIMED)
    for i, rec in enumerate(records):
        rec["device_ms"] = dev_ms[2 * i]
        rec["counts_kernel_device_ms"] = dev_ms[2 * i + 1]
        print(f"dirs tier {json.dumps(rec)}", flush=True)
    mixed["device_ms"] = dev_ms[-1]
    print(f"dirs mixed {json.dumps(mixed)}", flush=True)
    return launches, records, mixed


def phase_lab(scores_bench: dict):
    """The kernel lab tool at the bench shape, as a user runs it (modes
    base, inter2, inter4, abl; then abl once per DP_ABLATE flag), launches
    counted from 0 around it; then each lab kernel against its plain
    version on the same inputs, the no-flag kernels also against the
    scores kernel's output.  Returns {row name: record}."""
    from trust4_tpu_torch.ops import dp_scores
    from trust4_tpu_torch.ops.dp import banded_affine_scores_plain
    from trust4_tpu_torch.ops.dp_counts import to_device_jobs
    from trust4_tpu_torch.tools import dp_kernel_lab as lab

    lab.INTER_LAUNCHES = {g: 0 for g in lab.GROUPS}
    lab.ABL_LAUNCHES = 0
    timed = lab.run_modes(["base", "inter2", "inter4", "abl"], "cuda")
    for flag in lab.ABL_FLAGS:
        timed.update(lab.run_modes(["abl"], "cuda", ablate=frozenset([flag])))
    torch.cuda.synchronize()
    launches = {"inter2": lab.INTER_LAUNCHES[2],
                "inter4": lab.INTER_LAUNCHES[4], "abl": lab.ABL_LAUNCHES}
    if min(launches.values()) == 0:
        raise AssertionError(f"lab phase: a kernel never launched {launches}")

    w = lab.LAB_BAND
    tc, tl, pc, pl, _ = lab.make_inputs()
    args = to_device_jobs(tc, tl, pc, pl, torch.device("cuda"))
    want = banded_affine_scores_plain(*args, w)
    base = dp_scores.banded_affine_scores(*args, w)
    if not torch.equal(base, want):
        raise AssertionError("lab: the scores kernel differs from plain")
    plain_ms = _median_ms(lambda: banded_affine_scores_plain(*args, w),
                          N_TIMED)
    common = {k: scores_bench[k] for k in ("n", "t_max", "p_max", "w",
                                            "cells", "bytes", "bound_ms",
                                            "bound_by")}
    out = {}
    for g in lab.GROUPS:
        got = lab.scores_inter(*args, w, g)
        if not torch.equal(got, want):
            raise AssertionError(f"lab inter{g}: differs from the plain "
                                 "version")
        rec = dict(common, ms=timed[f"inter{g}"]["ms"], plain_ms=plain_ms,
                   max_abs_err=int((got - want).abs().max()),
                   launches=launches[f"inter{g}"])
        out[f"inter{g}"] = rec
    flags = {}
    for flag in [None, *lab.ABL_FLAGS]:
        ablate = frozenset([flag] if flag else [])
        got = lab.scores_abl(*args, w, ablate)
        ref = lab.banded_affine_scores_ablated(*args, w, ablate)
        if not torch.equal(got, ref):
            raise AssertionError(f"lab abl {flag}: differs from the plain "
                                 "ablated version")
        if flag is None and not torch.equal(got, base):
            raise AssertionError("lab abl: differs from the scores kernel")
        label = f"abl {flag or '(no flag)'}"
        flags[flag or "none"] = {
            "ms": timed[label]["ms"],
            "wrong_pairs": int((ref != want).sum()),
            "max_abs_err": int((got.long() - ref.long()).abs().max())}
    # Back-to-back device times: inter2, inter4, abl per flag, then the
    # scores kernel.
    dev_ms = _device_ms(
        [lambda g=g: lab.scores_inter(*args, w, g) for g in lab.GROUPS]
        + [lambda f=f: lab.scores_abl(*args, w, frozenset([f] if f else []))
           for f in [None, *lab.ABL_FLAGS]]
        + [lambda: dp_scores.banded_affine_scores(*args, w)], N_TIMED)
    for g, ms in zip(lab.GROUPS, dev_ms):
        out[f"inter{g}"]["device_ms"] = ms
    for f, ms in zip(flags, dev_ms[len(lab.GROUPS):-1]):
        flags[f]["device_ms"] = ms
    out["abl"] = dict(common, ms=flags["none"]["ms"],
                      device_ms=flags["none"]["device_ms"],
                      scores_kernel_device_ms=dev_ms[-1],
                      plain_ms=_median_ms(
                          lambda: lab.banded_affine_scores_ablated(*args, w),
                          N_TIMED),
                      max_abs_err=max(f["max_abs_err"] for f in flags.values()),
                      launches=launches["abl"], flags=flags)
    for rec in out.values():
        rec["kernel_over_bound"] = rec["ms"] / rec["bound_ms"]
        rec["cells_per_s"] = rec["cells"] / (rec["ms"] * 1e-3)
    print(f"lab: bit-equal to the plain versions {json.dumps(out)}",
          flush=True)
    return out


def _device_ms(calls, n: int) -> list:
    """Device time (ms) per call of each call, with the host's launch
    overhead left out: after 3 warm-up calls, a spin kernel holds the
    stream (about 0.1 s) while the host enqueues n calls, so the card runs
    them back to back between two CUDA events.  _median_ms times one call
    between its events, host gap included, which is most of a small
    launch's time.  (torch.profiler lost about ten kernel events per
    session on the chip machine, so it cannot split a session by call.)"""
    out = []
    for fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n)
    return out


def phase_microbench(sass: dict):
    """The microbenchmark tool as a user runs it (every body and size,
    each checked against its plain body inside the tool), launches counted
    from 0 around it; then each body's output against the plain body's,
    its SASS instructions (the body is unrolled in full, so they hold its
    K operations), its back-to-back device time and the plain body's
    time.  Returns (launches, cases)."""
    from trust4_tpu_torch.tools import vpu_microbench as vb

    vb.LAUNCHES = 0
    cases = vb.run_cases("cuda")
    torch.cuda.synchronize()
    launches = vb.LAUNCHES
    if launches == 0:
        raise AssertionError("microbench: the kernel never launched")
    for rec in cases:
        x = torch.from_numpy(vb.make_tile(rec["w"], rec["lanes"])).cuda()
        got = vb.run_body(rec["body"], x)
        want = vb.plain_body(rec["body"], x)
        rec["max_abs_err"] = int((got.long() - want.long()).abs().max())
        if rec["max_abs_err"]:
            raise AssertionError(f"microbench {rec['body']}: differs")
        rec["sass"] = sass[f"microbench_kernel<{vb.BODIES[rec['body']]},"
                           f"{rec['w']}>"]["total"]
        rec["plain_ms"] = _median_ms(
            lambda: vb.plain_body(rec["body"], x), N_TIMED)
        # Element operations over the issue ceiling: a throughput floor
        # that a dependent chain, bound by latency, cannot reach.
        rec["bound_ms"] = 1e3 * (vb.GRID * rec["k_ops"] * rec["w"]
                                 * rec["lanes"] / INT32_OPS_PER_S)
    tiles = [torch.from_numpy(vb.make_tile(r["w"], r["lanes"])).cuda()
             for r in cases]
    dev_ms = _device_ms([lambda r=r, x=x: vb.run_body(r["body"], x)
                         for r, x in zip(cases, tiles)], N_TIMED)
    for rec, ms in zip(cases, dev_ms):
        rec["device_ms"] = ms
        rec["device_ns_per_op"] = ms * 1e6 / (vb.GRID * rec["k_ops"])
        print(f"microbench {json.dumps(rec)}", flush=True)
    return launches, cases


@contextlib.contextmanager
def _plain_scores():
    """ops/dp_scores ``banded_affine_scores`` swapped for its plain
    version while the block runs (entry and realign_round look it up at
    call time), so a path can be held against itself with the plain DP."""
    from trust4_tpu_torch.ops import dp_scores
    from trust4_tpu_torch.ops.dp import banded_affine_scores_plain

    kernel = dp_scores.banded_affine_scores
    dp_scores.banded_affine_scores = banded_affine_scores_plain
    try:
        yield
    finally:
        dp_scores.banded_affine_scores = kernel


def phase_entry() -> int:
    """``entry(device="cuda")`` on the card, launches counted from 0
    around it, against the same step with the plain DP; returns the
    launches."""
    from trust4_tpu_torch.entry import entry
    from trust4_tpu_torch.ops import dp_scores

    fn, args = entry(device="cuda")
    dp_scores.LAUNCHES = 0
    out = fn(*args)
    torch.cuda.synchronize()
    launches = dp_scores.LAUNCHES
    with _plain_scores():
        want = fn(*args)
    if not torch.equal(out, want):
        raise AssertionError("entry: kernel step differs from the plain step")
    if launches == 0:
        raise AssertionError("entry: the scores kernel never launched")
    print(f"entry: {tuple(out.shape)} {out.dtype}, equal to the plain step, "
          f"{int((out != -(1 << 29)).sum())} pairs pass the prefilter, "
          f"launches={launches}", flush=True)
    return launches


def _fasta_seqs(path: str):
    seqs, cur = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip().upper())
    if cur:
        seqs.append("".join(cur))
    return seqs


def phase_realign(card_prefix: str, coord: str) -> int:
    """The realign round on the scale run's own card outputs; returns the
    launches of the card run."""
    from trust4_tpu_torch.io.fastx import read_fastx
    from trust4_tpu_torch.ops import dp_scores
    from trust4_tpu_torch.parallel import default_chunk, realign_round

    reads = [r.seq for r in read_fastx(card_prefix + "_toassemble.fq")]
    contigs = []
    with open(card_prefix + "_final.out") as f:
        for line in f:
            if line.startswith(">"):
                contigs.append(next(f).strip())
    germ = _fasta_seqs(coord)
    if len(reads) < 1000 or len(contigs) < 10:
        raise AssertionError(
            f"realign: too little work ({len(reads)} reads, {len(contigs)} "
            "contigs)")
    names = ("cand", "scores", "ids", "posWeight", "n_cand")

    def same(a, b, what):
        for name, x, y in zip(names, a, b):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                raise AssertionError(f"realign: {name} differ, {what}")

    dp_scores.LAUNCHES = 0
    t0 = time.perf_counter()
    card = realign_round(reads, contigs, germ, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dp_scores.LAUNCHES
    if launches == 0:
        raise AssertionError("realign: the scores kernel never launched")
    with _plain_scores():
        plain = realign_round(reads, contigs, germ, device="cuda")
    same(card, plain, "kernel vs plain DP on the card")
    sample = reads[:N_SAMPLE]
    same(realign_round(sample, contigs, germ, device="cuda"),
         realign_round(sample, contigs, germ, device="cpu"),
         f"card vs cpu on {len(sample)} reads")
    n_win = max(max(len(r) for r in reads), 9) - 9 + 1
    rec = {"reads": len(reads), "contigs": len(contigs),
           "candidates": card[4],
           "scored": int((card[1] > -(1 << 30)).sum()),
           "chunk": min(default_chunk(len(contigs), n_win), len(reads)),
           "launches": launches, "wall_s": wall,
           "cpu_sample": len(sample)}
    print(f"realign: bit-equal to the plain DP and to the CPU sample "
          f"{json.dumps(rec)}", flush=True)
    return launches


def phase_prefilter(work: str, coord: str, imgt: str) -> dict:
    """A 20k-read corpus through run_trust4 with the prefilter on the
    card and with the default native extractor: byte-identical artifacts.
    Returns the survivor share and the prefilter's card time."""
    from tools.make_bench_corpus import make_corpus
    from trust4_tpu_torch.engine.seqset import SeqSet
    from trust4_tpu_torch.io.fastx import read_fastx
    from trust4_tpu_torch.ops import prefilter
    from trust4_tpu_torch.ops.encode import pack_reads, window_codes_batch
    from trust4_tpu_torch.pipeline.extract import compute_hit_len_required

    fq = os.path.join(work, "pf.fq")
    make_corpus(fq, n_reads=PREFILTER_READS, seed=20261016, ref_fa=coord)
    kw = dict(coord_fasta=coord, imgt_fasta=imgt, single_files=[fq],
              threads=os.cpu_count() or 1)
    runs = {}
    for tag, on in (("pf_card", True), ("pf_native", False)):
        os.makedirs(os.path.join(work, tag))
        prefilter.reset_stats()
        runs[tag] = _run(os.path.join(work, tag, "pf"), device="cuda",
                         use_tpu_prefilter=on, **kw)
        runs[tag]["prefilter"] = dict(prefilter.STATS)
    for suf in ("_toassemble.fq",) + ARTIFACTS + ("_report.tsv",
                                                   "_airr.tsv"):
        a = os.path.join(work, "pf_card", "pf" + suf)
        b = os.path.join(work, "pf_native", "pf" + suf)
        if not filecmp.cmp(a, b, shallow=False):
            raise AssertionError(f"prefilter phase: {suf} differs")
    st = runs["pf_card"]["prefilter"]
    if st["reads"] != PREFILTER_READS:
        raise AssertionError(f"prefilter phase: tested {st['reads']} reads")

    # The prefilter's card time: one extractor batch through the kernel.
    ss = SeqSet(9)
    ss.input_ref_fa(coord)
    reads = [r.seq for r in read_fastx(fq)][:16384]
    pf = prefilter.TpuPrefilter([sw.consensus for sw in ss.seqs], k=9,
                                hit_len_required=compute_hit_len_required(
                                    fq, False), device="cuda")
    mat = pack_reads(reads, 128)
    codes, valid = window_codes_batch(mat, 9)
    cd = torch.from_numpy(codes).cuda()
    vd = torch.from_numpy(valid).cuda()
    batch_ms = _median_ms(lambda: prefilter.seq_count_prefilter_kernel(
        cd, vd, *pf.tables, 9, pf.hit_len_required, pf.radius), N_TIMED)
    rec = {"reads": st["reads"], "batches": st["batches"],
           "survivor_share": st["passed"] / st["reads"],
           "batch_reads": len(reads), "batch_ms": batch_ms,
           "card_ms_est": batch_ms * st["batches"],
           "extract_s": {t: r["stages_s"].get("extract") for t, r in
                         runs.items()},
           "wall_s": {t: r["wall_s"] for t, r in runs.items()}}
    print(f"prefilter: artifacts byte-identical {json.dumps(rec)}",
          flush=True)
    return rec


class _Tee(io.TextIOBase):
    """stderr that is also recorded (the pipeline logs stage walls)."""

    def __init__(self, inner):
        self.inner, self.buf = inner, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.inner.write(s)

    def flush(self):
        self.inner.flush()


def _run(prefix: str, **kw) -> dict:
    from trust4_tpu_torch.ops import gap_oracle
    from trust4_tpu_torch.pipeline.run import run_trust4

    gap_oracle.reset_stats()
    tee = _Tee(sys.stderr)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        run_trust4(output_prefix=prefix, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[stage-time\] (\w+): ([0-9.]+)s", tee.buf.getvalue())}
    return {"wall_s": wall, "stages_s": stages,
            "oracle": dict(gap_oracle.STATS)}


def phase_gold(work: str, coord: str, imgt: str) -> int:
    """Gold reads on the card in check mode; returns the launches."""
    from trust4_tpu_torch.ops import dp_counts

    prefix = os.path.join(work, "gold", "gold")
    os.makedirs(os.path.dirname(prefix))
    for m in (1, 2):
        shutil.copy(os.path.join(GOLD, f"gold_toassemble_{m}.fq"),
                    f"{prefix}_toassemble_{m}.fq")
    os.environ["TRUST4_TPU_DEVICE_CHECK"] = "1"
    launches0 = dp_counts.LAUNCHES
    try:
        res = _run(prefix, coord_fasta=coord, imgt_fasta=imgt,
                   read1_files=[f"{prefix}_toassemble_1.fq"],
                   read2_files=[f"{prefix}_toassemble_2.fq"], stage=1,
                   device="cuda")
    finally:
        del os.environ["TRUST4_TPU_DEVICE_CHECK"]
    launches = dp_counts.LAUNCHES - launches0
    for suf in ARTIFACTS:
        if not filecmp.cmp(prefix + suf, os.path.join(GOLD, "gold" + suf),
                           shallow=False):
            raise AssertionError(f"gold phase: {suf} differs from the golden")
    with open(prefix + "_report.tsv") as a, open(
            os.path.join(GOLD, "gold_report.tsv")) as b:
        if sorted(a) != sorted(b):
            raise AssertionError("gold phase: _report.tsv differs (sorted)")
    if launches == 0:
        raise AssertionError("gold phase: the kernel never launched")
    print(f"gold: byte-identical in check mode, launches={launches} "
          f"{json.dumps(res)}", flush=True)
    return launches


def phase_scale(work: str, coord: str, imgt: str, n_reads: int) -> dict:
    """The main path at scale on the card, then the native CPU DP; the
    artifacts must agree byte for byte.  Returns the card run's record
    with the launches counted from 0 around it."""
    from tools.make_bench_corpus import make_corpus
    from trust4_tpu_torch.ops import dp_counts

    fq = os.path.join(work, "bulk.fq")
    t0 = time.perf_counter()
    make_corpus(fq, n_reads=n_reads, ref_fa=coord)
    print(f"scale: corpus of {n_reads} reads in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    kw = dict(coord_fasta=coord, imgt_fasta=imgt, single_files=[fq],
              threads=os.cpu_count() or 1)
    os.makedirs(os.path.join(work, "card"))
    os.makedirs(os.path.join(work, "cpu"))
    card = os.path.join(work, "card", "bulk")
    cpu = os.path.join(work, "cpu", "bulk")

    dp_counts.LAUNCHES = 0
    res = _run(card, device="cuda", **kw)
    res["launches"] = dp_counts.LAUNCHES
    os.environ["TRUST4_TPU_DEVICE"] = "0"
    try:
        res_cpu = _run(cpu, device="cuda", **kw)
    finally:
        del os.environ["TRUST4_TPU_DEVICE"]
    print(f"scale card: {json.dumps(res)}", flush=True)
    print(f"scale TRUST4_TPU_DEVICE=0: {json.dumps(res_cpu)}", flush=True)
    if res["launches"] == 0:
        raise AssertionError("scale phase: the kernel never launched")
    if res_cpu["oracle"]["gap_fills"] != 0:
        raise AssertionError("TRUST4_TPU_DEVICE=0 ran the oracle")
    for suf in ("_toassemble.fq",) + ARTIFACTS + ("_report.tsv",
                                                   "_airr.tsv"):
        if not filecmp.cmp(card + suf, cpu + suf, shallow=False):
            raise AssertionError(f"scale phase: {suf} differs card vs cpu")
    print("scale: card and TRUST4_TPU_DEVICE=0 artifacts byte-identical",
          flush=True)
    orc = res["oracle"]
    if sum(orc["tier_launches"]) != res["launches"]:
        raise AssertionError("scale phase: the oracle's events missed "
                             "launches")
    # The main path's counts launches by tier: CUDA events just around
    # each kernel launch (gap_oracle.STATS), no profiler.
    print("scale card, main-path counts kernel: " + json.dumps({
        "tier_launches": orc["tier_launches"],
        "tier_kernel_ms": orc["tier_kernel_ms"],
        "kernel_ms": sum(orc["tier_kernel_ms"]),
        "tier_unique": orc["tier_unique"],
        "tier_widths": orc["tier_widths"]}), flush=True)
    prof = _profiled(work, kw)
    prof["event_kernel_ms"] = sum(orc["tier_kernel_ms"])
    print(f"scale card, profiled: {json.dumps(prof)}", flush=True)
    return res


def _profiled(work: str, kw: dict) -> dict:
    """The card run once more under torch.profiler (CUDA activity only):
    device busy time by kind over the run's wall, so the idle share.  A
    separate run, so the timed one above carries no tracing cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.join(work, "prof"))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = _run(os.path.join(work, "prof", "bulk"), device="cuda", **kw)
    busy = {"kernel_ms": 0.0, "copy_ms": 0.0, "sort_ms": 0.0,
            "other_ms": 0.0, "kernel_launches": 0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        kind = ("kernel_ms" if "dp_counts_kernel" in ev.key else
                "copy_ms" if "Memcpy" in ev.key else
                "sort_ms" if "sort" in ev.key.lower() else "other_ms")
        busy[kind] += ev.self_device_time_total / 1e3
        if kind == "kernel_ms":
            busy["kernel_launches"] += ev.count
    busy["wall_ms"] = res["wall_s"] * 1e3
    busy["idle_share"] = 1.0 - sum(
        busy[k] for k in ("kernel_ms", "copy_ms", "sort_ms", "other_ms")
    ) / busy["wall_ms"]
    return busy


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    card = card_line()
    print(card, flush=True)
    sass = phase_build()
    counts_shapes = phase_kernels(sass)
    tiers = [r for r in counts_shapes if r["shape"] == "chunk"]
    shapes = phase_scores(sass)
    entry_launches = phase_entry()

    from trust4_tpu_torch.testing import write_standin_references

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        coord, imgt = write_standin_references(os.path.join(work, "ref"))
        phase_gold(work, coord, imgt)
        scale = phase_scale(work, coord, imgt, SCALE_READS)
        realign_launches = phase_realign(
            os.path.join(work, "card", "bulk"), coord)
        phase_prefilter(work, coord, imgt)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dirs_launches, dirs_tiers, dirs_mixed = phase_dirs()
    lab = phase_lab(shapes[1])
    mb_launches, mb_cases = phase_microbench(sass)

    # The kernel line reports the counts kernel's largest tier (the main
    # path's heaviest launches; every shape is in "shapes", the full
    # chunks also in "tiers") and the scores kernel's bench shape (every
    # shape is in "shapes").  ms is the instance the wrapper chose,
    # per_thread_ms the one-thread (L = 1) instance's in this call.
    top = tiers[-1]
    bench = shapes[1]
    per_shape = ("shape", "n", "w", "chosen_lanes", "fastest_lanes", "ms",
                 "device_ms", "per_thread_ms", "per_thread_device_ms",
                 "wrapper_ms", "bound_ms", "bound_by", "plain_ms")
    kernels = [{
        "name": "dp_counts",
        "route": "cuda",
        "source": "trust4_tpu_torch/csrc/dp_counts.cu",
        "replaces": "trust4_tpu/ops/dp_pallas.py:768",
        "launches": scale["launches"],
        "max_abs_err": max(t["max_abs_err"] for t in counts_shapes),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "per_thread_ms": top["per_thread_ms"],
        "main_path_kernel_ms": sum(scale["oracle"]["tier_kernel_ms"]),
        "tiers": [{k: t[k] for k in ("cap", "w", "chunk", "ms",
                                     "packed_ms", "plain_ms", "bound_ms",
                                     "cells_per_s")} for t in tiers],
        "shapes": [{k: r.get(k) for k in per_shape} for r in counts_shapes],
    }, {
        "name": "dp_scores",
        "route": "cuda",
        "source": "trust4_tpu_torch/csrc/dp_scores.cu",
        "replaces": "trust4_tpu/ops/dp_pallas.py:55",
        "launches": entry_launches + realign_launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": bench["ms"],
        "plain_ms": bench["plain_ms"],
        "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"],
        "library_ms": None,
        "per_thread_ms": bench["per_thread_ms"],
        "shapes": [{k: r.get(k) for k in per_shape + ("t_max", "p_max",
                                                     "cells_per_s")}
                   for r in shapes],
    }]
    # The dirs kernel's top tier (its heaviest launch; every tier and the
    # mixed batch are in "shapes"); the lab kernels at the bench shape;
    # the microbenchmark's dependent max+add chain at (32, 128) (every
    # case is in "cases").
    top = dirs_tiers[-1]
    kernels.append({
        "name": "dp_dirs",
        "route": "cuda",
        "source": "trust4_tpu_torch/csrc/dp_dirs.cu",
        "replaces": "trust4_tpu/ops/dp_pallas.py:385",
        "launches": dirs_launches,
        "max_abs_err": max(r["max_abs_err"] for r in dirs_tiers + [dirs_mixed]),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "device_ms": top["device_ms"],
        "decode_ms": top["decode_ms"],
        "shapes": [{k: r.get(k) for k in (
            "shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "decode_ms", "counts_kernel_ms", "counts_kernel_device_ms")}
            for r in dirs_tiers + [dirs_mixed]],
    })
    for name in ("inter2", "inter4", "abl"):
        r = lab[name]
        kernels.append({
            "name": f"dp_lab_{name}",
            "route": "cuda",
            "source": "trust4_tpu_torch/csrc/dp_lab.cu",
            "replaces": ("tools/dp_kernel_lab.py:279" if name == "abl" else
                         "tools/dp_kernel_lab.py:51"),
            "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "device_ms": r["device_ms"],
            **({"flags": {f: v["device_ms"] for f, v in r["flags"].items()}}
               if name == "abl" else {}),
        })
    mb = next(c for c in mb_cases if (c["body"], c["w"], c["lanes"])
              == ("chain_max", 32, 128))
    kernels.append({
        "name": "microbench",
        "route": "cuda",
        "source": "trust4_tpu_torch/csrc/microbench.cu",
        "replaces": "tools/vpu_microbench.py:42",
        "launches": mb_launches,
        "max_abs_err": max(c["max_abs_err"] for c in mb_cases),
        "ms": mb["ms"],
        "plain_ms": mb["plain_ms"],
        "bound_ms": mb["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "device_ms": mb["device_ms"],
        "cases": [{k: c[k] for k in ("body", "w", "lanes", "ms",
                                     "ns_per_op", "device_ms",
                                     "device_ns_per_op", "sass", "bound_ms")}
                  for c in mb_cases],
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
