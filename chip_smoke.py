#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (trust4_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port only (never jax, never trust4_tpu):

1. prints the card (nvidia-smi name and power limit) and builds every
   kernel from csrc/ with nvcc (one process per source, all at once,
   while the native libraries build beside them);
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
5. scale phase: a 500k-read bulk corpus (the port's
   tools/make_bench_corpus.py) run on the card with the default settings
   (the main path: launches counted from 0 around it; the gap oracle's
   per-tier launches and CUDA-event kernel ms; #8's launches, one a
   stream batch) and again with TRUST4_TPU_DEVICE=0 (no launch of #8);
   the artifacts must be byte-identical and the kernel must have
   launched; a third card run
   under torch.profiler gives the device's busy and idle share;
6. realign phase: the scale run's own candidate reads and contigs, with
   the stand-in coordinate FASTA as germline, through ``realign_round``
   on the card (launches counted from 0 around it); its five outputs must
   equal the same round with the plain DP on the card, and on a sample
   the round on the CPU;
7. prefilter phase: a 20,000-read corpus through ``run_trust4`` with
   ``use_tpu_prefilter=True`` on the card and with the default native
   extractor; every artifact must be byte-identical;
8. ranks phase: the multi-GPU layer (trust4_tpu_torch/parallel/) in
   worlds of 1 (NCCL), 2 and 4 (gloo) ranks spawned on this one card
   (parallel/mesh.py ``spawn``), each part driven with the launch counts
   set to 0 just before it in every rank and read just after: (a)
   ``mesh_tier_counts`` at each tier's full chunk, bit-equal to the
   single-card kernel; (b) in the world of 4, ``sharded_realign_round``
   on the scale run's reads and contigs at (1, 1), (2, 1) and (2, 2),
   every rank's five outputs equal to ``realign_round``'s; (c) the scale
   run's annotation stage under TRUST4_TPU_GAP_MESH at 2 and 4 ranks,
   ``_cdr3.out`` and ``_annot.fa`` byte-identical to the scale run's; (d)
   a barcoded corpus (the port's make_bench_corpus.make_barcoded_corpus at
   its defaults) assembled by the thread pool, then by the mesh executor at
   2 and 4 ranks, ``_final.out`` byte-identical; every rank must launch
   the part's kernel, and a failing rank fails the script;
9. dirs phase: the traceback-bits path (``ops/dp_dirs.dirs_counts``: the
   dirs kernel, then the decoder kernel) at each tier's full chunk
   (launches of both counted from 0 around it); per tier the kernel's
   scores and whole (N, P, W) bits tensor bit-equal to its plain version,
   the decoder kernel's counts equal to the plain decoder's, the counts
   kernel's and the native DP's on a sample; every (W, L) instance of the
   dirs kernel bit-equal to its plain version on each tier's chunk, a
   partial and a small batch, the mixed scores batch at W=32 (its
   out-of-tile rows at -2^29) and its first 2,000 rows, and 33 ragged
   jobs at W=24 with an odd p_max, each timed (CUDA-event median and back to back) beside the
   bound, its SASS per tile cell, registers and spills and the instance
   the wrapper's table chose; both kernels, the plain versions (the plain
   decoder in 3 launches) and the counts kernel timed beside the bounds;
10. lab phase: ``trust4_tpu_torch.tools.dp_kernel_lab`` at the bench shape
   (modes base, inter2, inter4, abl, then abl per DP_ABLATE flag;
   launches counted from 0 around it); then every built instance of the
   lab's two kernels (the ablation kernel at each (L, flag), the
   interleaved kernel at each (L, G)) bit-equal to its plain version, the
   no-flag ablation also to the scores kernel at each L, each timed (the
   launch alone) beside its registers and spills, one line each; then
   the split table: at each L, each flag's saving against no flag and
   the interleaved kernel against no flag;
11. microbench phase: ``trust4_tpu_torch.tools.vpu_microbench`` (every
   body and size; launches counted from 0 around it); each body's output
   equal to the plain body's, with ms per launch, ns/op and the body's
   SASS instruction count;
12. modes phase (run after the ranks phase): the entry points other than
   bulk FASTQ, each part on the card (launches of the counts kernel
   counted from 0 around it, which must be at least 1) and with
   TRUST4_TPU_DEVICE=0, every file byte-identical: (a) a barcoded run of
   a 2,500-cell 10x-style corpus with a whitelist; (b) a bulk BAM of
   125,000 pairs (``testing.write_standin_bam``, against the coordinate
   stand-in); (c) the barcoded tests/data/bambc/bc.bam (also held to its
   goldens) and 20,000 barcoded pairs from the writer; (d) 48 cells of a
   SMART-seq plate, 2,000 pairs a cell, through ``run_smartseq``; (e)
   each mode of tests/data/modes (also held to its golden); (f) the
   scale corpus with TRUST4_TPU_DEVICE_TIMEOUT_S=1 in a fresh process
   (byte-identical to the scale phase's TRUST4_TPU_DEVICE=0 run) and, in
   child processes, the hang hooks, which must raise GapDeviceTimeout
   within their deadlines and exit non-zero;
13. bench phase: ``python -m trust4_tpu_torch.bench --reads 100000`` in
   a subprocess with T4BENCH_SCALE=0 and T4BENCH_BARCODED=0 (the bulk
   A/B, the import walls of the CLI alone, torch alone and both,
   extraction reads/s, kernel #3's sustained rate and the host-input and
   tier-2 launches); it must exit 0 with every timed run held
   byte-identical to its first TRUST4_TPU_DEVICE=0 run and end with
   bench.py's JSON line; its lines are printed, each run's boot line
   among them, and in every run the thread that loaded torch must be the
   boot thread (shipping mode) or none (TRUST4_TPU_DEVICE=0); then a
   shipping-mode CLI run with a missing input, failing in extraction
   while the boot thread imports torch, must exit 1 with its own error;
14. fuzz phase: ``trust4_tpu_torch.tools.fuzz_differential`` in this
   process on the card at the JAX harnesses' sizes: bulk seeds 9000-9031
   and 9041 at -t 1, 9032-9039 at -t 8, barcoded seeds 9000-9015 at -t 1
   and at -t 8, and bulk 9000-9003 with TRUST4_TPU_DEVICE_CHECK=1; each seed in the
   shipping mode (launches counted from 0 around it) against
   TRUST4_TPU_DEVICE=0, every file byte-identical (report tables
   sorted); #1 must launch; it prints each seed's line, the modes drawn,
   the jobs beyond the top tier per mode, the walls and the card;
15. asan phase (a subprocess beside the fuzz phase, as is 16):
   ``python -m trust4_tpu_torch.tools.asan_check 7000 7003 --device
   cuda`` in a subprocess (its libraries built with AddressSanitizer in
   the build phase): under libasan, the gold reads (held to their
   goldens), bulk and barcoded seeds 7000-7002, a 20,000-pair stand-in
   BAM and bulk seed 7000 at -t 8, each in the shipping mode on the card
   against TRUST4_TPU_DEVICE=0, byte-identical; it must end with ``asan
   check passed``, every part having launched #1; its lines, the wall,
   the bulk and barcoded wall per corpus against the fuzz phase's, and
   the card are printed;
16. trace phase: ``python -m trust4_tpu_torch.tools.debug_trace_check
   --device cuda --fuzz-seed 9000 --fuzz-seed 9004`` in a subprocess, on
   the gold reads and fuzz corpora 9000 (pe) and 9004 (long): the
   TRUST4_TPU_DEBUG=1 assembly trace of the shipping mode on the card
   byte-identical to TRUST4_TPU_DEVICE=0's; its lines, the wall and the
   card are printed;
17. extract phase (run before the scale phase): extraction's candidate
   filter kernel #8 (``ops/extract_filter.CardFilter``) on one bulk
   stream batch (16,384 100-base reads, ``testing.mix_reads``) of each
   benchmark mix, on the coordinate stand-in's index at k = 9 and a hit
   length of 23 (launches counted from 0 around it): every decision
   equal to the host filter's (8 threads) and to the plain version's
   (``engine/overlap.py`` ``has_hit_in_set``), none undecided; the
   CUDA-event median and the back-to-back device time of the launch
   beside the bound (bytes) and both host versions' ms.

Small launches spend much of their CUDA-event time in the host's gap
before the kernel starts, so the dirs, lab and microbench phases also
report each kernel's time in back-to-back launches (``device_ms``).  The
dirs and lab phases time each instance over N_SWEEP launches and each
plain version over N_PLAIN; every phase's wall is printed before the
kernels line.

It prints one ``{"kernels": [...]}`` line, the card line again, and last
``{"ok": true, "device": {...}}``.  Any failure raises, so the script
exits non-zero without that line; it also does so when no CUDA device is
visible.
"""

from __future__ import annotations

import contextlib
import filecmp
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# Read by each run_trust4 call (utils/spans.py): per-stage walls on stderr.
os.environ["TRUST4_TPU_STAGE_TIMES"] = "1"

import torch  # noqa: E402

import trust4_tpu_torch  # noqa: E402,F401  (fails outside a checkout)
from trust4_tpu_torch.ops.dp_counts import (  # noqa: E402
    band_cells as _band_cells)

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
# int32 operations the function needs per band cell (see
# dp_counts.band_cells), counted from the recurrence (AlignAlgo.hpp
# GlobalAlignment), not from a kernel's masked W-wide sweep.  Scores:
# match test 3 (compare, N test on the text base, or; the query base's N
# test is per row), substitution select 1, diagonal add 1,
# E = max(E+GE, M+GO+GE) 3, F likewise 3, M = max of three 2: 13.
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
# The dirs and lab phases' depth (they sweep every instance at many
# shapes): each instance timed over N_SWEEP launches, each plain version
# over N_PLAIN after one warm-up call.  Every instance is still held
# bit-equal to its plain version.
N_SWEEP = 5
N_PLAIN = 3
N_SAMPLE = 2000
SCALE_READS = 500_000
# The bulk stream's batch (native/extract_filter.cpp ReadAhead) and the
# receptor shares of the benchmark's bulk mixes (t4bench/traffic).
EXTRACT_BATCH = 16384
EXTRACT_MIXES = (("rich", 0.05), ("sparse", 0.0025))
PREFILTER_READS = 20_000
BENCH_READS = 100_000


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_build() -> dict:
    """nvcc for the kernels and, side by side with it, g++ for the native
    libraries and for their ASan build (tools/asan_check.py), so no later
    phase times a build.  Returns the SASS counts
    (_sass_counts) of every kernel instance, with the registers and
    spills ptxas reported for it."""
    from concurrent.futures import ThreadPoolExecutor

    from trust4_tpu_torch.ops import build
    from trust4_tpu_torch.tools.asan_check import build_asan
    from trust4_tpu_torch.utils.nativebuild import ensure_built

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        nvcc = pool.submit(build.build_all)
        asan = pool.submit(build_asan)  # the asan phase's libraries
        for lib in ("libt4align.so", "libt4extract.so", "libt4overlap.so",
                    "libt4bam.so"):
            ensure_built(lib)
        t_native = time.perf_counter() - t0
        nvcc.result()
        t_asan = asan.result()
    print(f"build: nvcc {max(build.BUILD_SECONDS.values(), default=0):.2f}s "
          f"{json.dumps(build.BUILD_SECONDS)}, native {t_native:.2f}s, "
          f"native with ASan {t_asan:.2f}s (side by side), phase "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
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
# A kernel that is no template: its name's length, the name, the end of
# its (namespace-qualified) name.
_PLAIN_KERNEL_NAME = re.compile(r"\d([a-z_]+_kernel)E")


def _kernel_key(mangled: str):
    """'dp_counts_kernel<48,8>' from a mangled kernel name, the name alone
    for a kernel that is no template ('extract_filter_kernel'), or None
    for a function that is neither."""
    m = _KERNEL_NAME.search(mangled)
    if m:
        args = re.findall(r"L[a-z](\d+)E", m.group(2))
        return f"{m.group(1)}<{','.join(args)}>"
    m = _PLAIN_KERNEL_NAME.search(mangled)
    return m.group(1) if m else None


def _ptxas_usage(log: str) -> dict:
    """Registers and spill bytes per kernel instance from nvcc's
    ``-Xptxas -v`` output (empty for a library found built)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            cur = _kernel_key(m.group(1))
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
    ("dp_inter_kernel<32,4,2>"): ``total`` in the function; ``sha``, a
    digest of its instruction text (two builds with the same ``sha``
    compiled to the same code, instruction for instruction); ``loop``
    inside its widest backward branch (its row loop), where it has one;
    and for the DP kernels ``per_tile_cell`` = loop / the tile cells a
    thread sweeps per row: W for the one-thread kernels, W / L x its jobs
    for the group kernels (_GROUP_KERNELS: <W, L>, <W, L, FLAGS>, and <W,
    L, G> with G jobs a lane; the dirs kernel's <W, L>), W being the first
    template argument.  The
    DP kernels sweep all their tile cells of a row, so that is what they
    issue per tile cell, beside the operations the function needs per
    band cell (OPS_PER_CELL, SCORE_OPS_PER_CELL, DIRS_OPS_PER_CELL).  The
    microbenchmark bodies are unrolled in full, so their ``total`` holds
    the K operations."""
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
        if key is None:
            raise AssertionError(f"{lib}: no kernel name in {fn.split()[0]}")
        name = key.split("<")[0]
        args = [int(a) for a in re.findall(r"\d+", key[len(name):])]
        ins = [(int(a, 16), op) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        rec = {"library": library, "total": len(ins),
               "sha": hashlib.sha256("\n".join(
                   op for _, op in ins).encode()).hexdigest()[:16]}
        loops = [(int(t, 16), a) for a, op in ins
                 for t in re.findall(r"BRA\s+0x([0-9a-f]+)", op)
                 if int(t, 16) < a]
        if loops:
            lo, hi = max(loops, key=lambda x: x[1] - x[0])
            rec["loop"] = sum(lo <= a <= hi for a, _ in ins)
            if name.startswith("dp_"):
                jobs = args[2] if name == "dp_inter_kernel" else 1
                cells = (args[0] // args[1] * jobs
                         if name in _GROUP_KERNELS + ("dp_dirs_kernel",)
                         else args[0])
                rec["per_tile_cell"] = round(rec["loop"] / cells, 2)
            if name in _GROUP_KERNELS:
                # One row loop per tile width the kernel can narrow to
                # (dp_lanes.cuh narrow_width), the wider the longer.
                rec["per_tile_cell_by_width"] = _row_loops(
                    ins, loops, args[0], args[1], jobs)
        out[key] = rec
    return dict(sorted(out.items()))


# The group kernels: template arguments <W, L, ...>, W / L cells per
# lane and job (dp_inter_kernel<W, L, G>: G jobs a lane).
_GROUP_KERNELS = ("dp_counts_kernel", "dp_scores_kernel", "dp_abl_kernel",
                  "dp_inter_kernel")


def _row_loops(ins, loops, w: int, lanes: int, jobs: int = 1) -> dict:
    """SASS per tile cell of each row loop of a group kernel, by the tile
    width its path sweeps: the outermost loops of 40 instructions or more,
    longest first, matched to the widths narrow_width can pick, widest
    first; a lane sweeps width / lanes cells of each of its jobs."""
    spans = []
    for lo, hi in sorted(loops, key=lambda x: x[0] - x[1]):
        if not any(a <= lo and hi <= b for a, b in spans):
            spans.append((lo, hi))
    sizes = sorted((sum(lo <= a <= hi for a, _ in ins) for lo, hi in spans),
                   reverse=True)
    widths = [w] + [x for x in (32, 24, 16) if x < w and x % lanes == 0]
    return {str(x): round(n / (x // lanes * jobs), 2)
            for x, n in zip(widths, [n for n in sizes if n >= 40])}


def _median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median over n launches of fn, each between its own CUDA events,
    after ``warmup`` warm-up calls."""
    for _ in range(warmup):
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


# Dirs shapes beside each tier's full chunk (PARTIAL_JOBS, SMALL_JOBS of
# rand_gap_jobs at the tier's shape) and the mixed scores batch at W=32
# (and its first SMALL_JOBS rows, the wrapper's small class there): 33
# ragged jobs at W=24 with an odd p_max, so every job's block of bits
# is only 8-byte aligned and every L stages a tail of rows past its last
# full batch.
DIRS_RAGGED = (33, 37, 24)  # (jobs, cap, band)
# Operations of the decoder's walk per step, the common diagonal step
# (dp_decode.cuh): the loop's two tests 3, the band test (k = j - i +
# left, five compares, four ands) 11, the bits' address with its clamp 4,
# the state and diag_ok tests 4, the two codes' addresses 2, the match
# test 5, the count and the two moves 3: 32.
DECODE_OPS_PER_STEP = 32


def _dirs_record(tag, tc, tl, pc, pl, w, args, max_abs_err,
                 plain: bool = True) -> dict:
    """Bound and CUDA-event medians of the dirs kernel (the wrapper's
    launch) and, with plain, its plain version on one batch (the inputs
    on the card in args)."""
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
    if plain:
        rec["plain_ms"] = _median_ms(
            lambda: banded_affine_dirs_plain(*args, w), N_PLAIN, warmup=1)
    rec["kernel_over_bound"] = rec["ms"] / rec["bound_ms"]
    return rec


def _dirs_instances(sass, rec, args, want) -> None:
    """Every built (W, L) instance of the dirs kernel on one batch: its
    scores and whole (N, P, W) bits tensor bit-equal to the plain
    version's (want, on the card), then timed (the CUDA-event median of
    N_SWEEP launches and back to back) beside its SASS per tile cell,
    registers and spills; the instance the wrapper's CHOICE picks, the
    fastest and the one-thread one on rec."""
    from trust4_tpu_torch.ops import dp_dirs
    from trust4_tpu_torch.ops.build import instances

    w, n = rec["w"], rec["n"]
    recs = {}
    for ww, lanes in instances("dp_dirs"):
        if ww != w:
            continue
        got = dp_dirs.launch(*args, w, lanes)
        torch.cuda.synchronize()
        for what, a, b in zip(("scores", "dirs"), got, want):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(len(a), -1).any(1).sum())
                raise AssertionError(
                    f"dirs {rec['shape']}: dp_dirs_kernel<{w},{lanes}> "
                    f"{what} differ from the plain version in {bad} jobs")
        del got
        r = {"lanes": lanes}
        r.update({k: sass[f"dp_dirs_kernel<{w},{lanes}>"].get(k) for k in (
            "loop", "per_tile_cell", "registers", "spill_stores",
            "spill_loads")})
        r["ms"] = _median_ms(lambda: dp_dirs.launch(*args, w, lanes),
                             N_SWEEP)
        recs[lanes] = r
    dev_ms = _device_ms([lambda ln=ln: dp_dirs.launch(*args, w, ln)
                         for ln in recs], N_SWEEP)
    for r, ms in zip(recs.values(), dev_ms):
        r["device_ms"] = ms
        r["device_over_bound"] = ms / rec["bound_ms"]
    chosen = dp_dirs.lanes_for(n, w)
    rec["instances"] = list(recs.values())
    rec["chosen_lanes"] = chosen
    rec["instance"] = f"dp_dirs_kernel<{w},{chosen}>"
    rec["fastest_lanes"] = min(recs, key=lambda ln: recs[ln]["device_ms"])
    rec["per_thread_device_ms"] = recs[1]["device_ms"]
    rec["device_ms"] = recs[chosen]["device_ms"]
    rec["device_over_bound"] = rec["device_ms"] / rec["bound_ms"]


def phase_dirs(sass: dict):
    """The traceback-bits path (ops/dp_dirs.dirs_counts: the dirs kernel,
    then the decoder kernel) at each gap-oracle tier's full chunk,
    launches of both counted from 0 around it.  Then per tier: the
    wrapper's scores and whole (N, P, W) bits tensor against the plain
    version, the decoder kernel's counts against the plain decoder's, the
    counts kernel's and a native sample, timings of both kernels beside
    their bounds (the plain decoder timed in 3 launches: about 1.7 s
    each at tier 2); every dirs instance bit-equal to the plain version
    and timed on each tier's chunk, a partial chunk and a small batch,
    the mixed scores batch at W=32 (its out-of-tile rows pinned at
    -2^29) and its first SMALL_JOBS rows, and DIRS_RAGGED.  Returns (launches by kernel, per-tier
    records, records of the other shapes)."""
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
    dp_dirs.DECODE_LAUNCHES = 0
    outs = [dp_dirs.dirs_counts(*job[-1], job[1]) for job in jobs]
    torch.cuda.synchronize()
    launches = {"dp_dirs": dp_dirs.LAUNCHES,
                "dp_dirs_decode": dp_dirs.DECODE_LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"dirs phase: a kernel never launched "
                             f"{launches}")

    records, kept = [], []
    for (cap, w, chunk, rng, ts, ps, tc, tl, pc, pl, args), (s_path, c_path) \
            in zip(jobs, outs):
        s_k, d_k = dp_dirs.banded_affine_dirs(*args, w)
        s_p, d_p = banded_affine_dirs_plain(*args, w)
        _s, c_counts = dp_counts.banded_affine_counts(*args, w)
        walked = torch.empty(chunk, dtype=torch.int32, device=dev)
        c_dec = dp_dirs.decode_launch(d_k, *args, w=w, p_max=cap,
                                      walked=walked)
        c_plain = dp_dirs.decode_dirs_counts_plain(d_k, *args, w=w,
                                                   p_max=cap)
        torch.cuda.synchronize()
        for what, a, b in (("scores", s_k, s_p), ("dirs", d_k, d_p),
                           ("path scores", s_path, s_p),
                           ("decoded counts vs the counts kernel", c_path,
                            c_counts),
                           ("decoder kernel vs the plain decoder", c_dec,
                            c_plain),
                           ("decoder kernel vs the path", c_dec, c_path)):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(len(a), -1).any(1).sum())
                raise AssertionError(
                    f"dirs tier ({cap},{w},{chunk}): {what} differ in {bad} "
                    "jobs")
        counts = c_dec.cpu().numpy()
        for i in rng.choice(chunk, N_SAMPLE, replace=False):
            want = ((0, 0, 0) if tl[i] == 0 or pl[i] == 0 else
                    global_alignment_counts(ts[i][: tl[i]], ps[i][: pl[i]]))
            if tuple(int(v) for v in counts[i]) != want:
                raise AssertionError(f"dirs tier ({cap},{w}) job {i}: "
                                     f"{counts[i]} vs native {want}")
        err = int(max((s_k - s_p).abs().max(),
                      (d_k.int() - d_p.int()).abs().max()))
        rec = _dirs_record(f"tier ({cap},{w},{chunk})", tc, tl, pc, pl, w,
                           args, err)
        _dirs_instances(sass, rec, args, (s_p, d_p))
        del s_k, s_p, d_p
        # The decoder: its bound from this run's walks (one byte of bits a
        # step, each job's codes and lengths read once, its counts
        # written once) and DECODE_OPS_PER_STEP per step walked.
        steps = int(walked.long().sum())
        dec_bytes = steps + int(tl.astype(np.int64).sum() +
                                pl.astype(np.int64).sum()) + 20 * chunk
        ops_s = steps * DECODE_OPS_PER_STEP / INT32_OPS_PER_S
        bytes_s = dec_bytes / HBM_BYTES_PER_S
        rec["decode"] = {
            "steps_walked": steps, "step_cap": dp_dirs.decode_steps(cap, cap),
            "longest_walk": int(walked.max()), "bytes": dec_bytes,
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "bytes" if bytes_s > ops_s else "operations",
            "max_abs_err": int((c_dec - c_plain).abs().max()),
            "ms": _median_ms(lambda: dp_dirs.decode_dirs_counts(
                d_k, *args, w=w, p_max=cap), N_TIMED),
            "plain_ms": _median_ms(lambda: dp_dirs.decode_dirs_counts_plain(
                d_k, *args, w=w, p_max=cap), N_PLAIN, warmup=1)}
        rec["counts_kernel_ms"] = _median_ms(
            lambda: dp_counts.banded_affine_counts(*args, w), N_TIMED)
        records.append(rec)
        kept.append((args, w, cap, d_k))

    others = []

    def other(tag, tc, tl, pc, pl, w):
        args = dp_counts.to_device_jobs(tc, tl, pc, pl, dev)
        s_k, d_k = dp_dirs.banded_affine_dirs(*args, w)
        s_p, d_p = banded_affine_dirs_plain(*args, w)
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_p) and torch.equal(d_k, d_p)):
            raise AssertionError(f"dirs {tag}: the wrapper differs from the "
                                 "plain version")
        err = int(max((s_k - s_p).abs().max(),
                      (d_k.int() - d_p.int()).abs().max()))
        rec = _dirs_record(tag, tc, tl, pc, pl, w, args, err,
                           plain=tag == "mixed")
        _dirs_instances(sass, rec, args, (s_p, d_p))
        others.append(rec)
        return rec, args, s_k

    for cap, w, chunk in _TIERS:
        for kind, n in (("partial", PARTIAL_JOBS[w]), ("small", SMALL_JOBS)):
            rng = np.random.default_rng(3000 + cap + n)
            _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, n, cap, w)
            other(f"{kind} ({cap},{w},{n})", tc, tl, pc, pl, w)
    n, cap, w = DIRS_RAGGED
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(3033), n,
                                             cap, w)
    other(f"ragged ({cap},{w},{n})", tc, tl, pc, pl, w)

    tc, tl, pc, pl = _score_inputs("mixed")
    w = 32
    other(f"small mixed (152,32,{SMALL_JOBS})",
          *(a[:SMALL_JOBS] for a in (tc, tl, pc, pl)), w)
    mixed, _args, s_k = other("mixed", tc, tl, pc, pl, w)
    k_final = tl.astype(np.int64) - pl + np.where(tl < pl, 5 + (pl - tl), 5)
    off = (k_final < 0) | (k_final >= w)
    got = s_k.cpu().numpy()
    if not off.any() or (got[off] != -(1 << 29)).any() \
            or (got[~off] == -(1 << 29)).any():
        raise AssertionError("dirs mixed: out-of-tile rows not at -2^29")
    mixed["out_of_tile_rows"] = int(off.sum())

    # Back-to-back device times of the counts kernel and the decoder
    # kernel per tier (the dirs kernel's are its instances').
    calls = []
    for args, w, cap, dirs in kept:
        calls += [lambda a=args, w=w: dp_counts.banded_affine_counts(*a, w),
                  lambda a=args, w=w, c=cap, d=dirs:
                  dp_dirs.decode_dirs_counts(d, *a, w=w, p_max=c)]
    dev_ms = _device_ms(calls, N_TIMED)
    for i, rec in enumerate(records):
        rec["counts_kernel_device_ms"] = dev_ms[2 * i]
        rec["decode"]["device_ms"] = dev_ms[2 * i + 1]
        print(f"dirs tier {json.dumps(rec)}", flush=True)
    for rec in others:
        print(f"dirs {rec['shape'].split()[0]} {json.dumps(rec)}", flush=True)
    print("dirs instances (device ms back to back, per shape; * the "
          "wrapper's choice):", flush=True)
    for rec in records + others:
        cells = [f"L={r['lanes']}{'*' if r['lanes'] == rec['chosen_lanes'] else ''} "
                 f"{r['device_ms']:.4f}" for r in rec["instances"]]
        print(f"  {rec['shape']:<24} bound {rec['bound_ms']:.4f}  "
              + "  ".join(cells), flush=True)
    return launches, records, others


def phase_lab(scores_bench: dict, sass: dict):
    """The kernel lab at the bench shape.  First the tool as a user runs
    it (modes base, inter2, inter4, abl at each wrapper's default L; then
    abl once per DP_ABLATE flag), launches counted from 0 around it.  Then
    every built instance of its two kernels, each (L, flag) of the
    ablation kernel and each (L, G) of the interleaved one, on the same
    inputs in the scores wrapper's order: bit-equal to its plain version,
    the ablation kernel with no flag also to the scores kernel (the
    wrapper, and its launch at the same L); timed, the launch alone
    (median of N_SWEEP CUDA-event launches, and back to back), beside its
    registers and spills; one line each.  Last the split table: at each L,
    what each flag's removal saves against no flag, and the interleaved
    kernel against no flag.  Returns {row name: record}."""
    from trust4_tpu_torch.ops import dp_scores
    from trust4_tpu_torch.ops.dp import banded_affine_scores_plain
    from trust4_tpu_torch.ops.dp_counts import job_order, to_device_jobs
    from trust4_tpu_torch.tools import dp_kernel_lab as lab

    for key in lab.LAUNCHES:
        lab.LAUNCHES[key] = 0
    timed = lab.run_modes(["base", "inter2", "inter4", "abl"], "cuda")
    for flag in lab.ABL_FLAGS:
        timed.update(lab.run_modes(["abl"], "cuda", ablate=frozenset([flag])))
    torch.cuda.synchronize()
    launches = {kind: {ln: lab.LAUNCHES[(kind, ln)] for ln in lab.LANES
                       if lab.LAUNCHES[(kind, ln)]} for kind in lab.KINDS}
    if not all(launches.values()):
        raise AssertionError(f"lab phase: a kernel never launched {launches}")

    w = lab.LAB_BAND
    tc, tl, pc, pl, _ = lab.make_inputs()
    args = to_device_jobs(tc, tl, pc, pl, torch.device("cuda"))
    order = job_order(args[1], args[3])
    want = banded_affine_scores_plain(*args, w)
    base = dp_scores.banded_affine_scores(*args, w)
    if not torch.equal(base, want):
        raise AssertionError("lab: the scores kernel differs from plain")
    flag_name = {0: "none", **{v: k for k, v in lab.ABL_FLAGS.items()}}
    built = {"abl": lab.instances("abl"), "inter": lab.instances("inter")}
    if built != {"abl": [(ln, f) for ln in lab.LANES for f in flag_name],
                 "inter": [(ln, g) for ln in lab.LANES for g in lab.GROUPS]}:
        raise AssertionError(f"lab: built instances {built}")
    refs = {f: lab.banded_affine_scores_ablated(
        *args, w, frozenset([] if f == 0 else [flag_name[f]]))
        for f in flag_name}
    insts, calls = [], []
    for kind, pairs in built.items():
        for lanes, arg in pairs:
            def call(kind=kind, arg=arg, lanes=lanes):
                return lab.launch(kind, arg, *args, w, lanes, order)
            got = call()
            ref = refs[arg] if kind == "abl" else want
            torch.cuda.synchronize()
            label = (f"abl {flag_name[arg]}" if kind == "abl" else
                     f"inter{arg}") + f" L={lanes}"
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"lab {label}: differs from its plain version in "
                    f"{int((got != ref).sum())} pairs")
            if kind == "abl" and arg == 0 and not (
                    torch.equal(got, base) and torch.equal(
                        got, dp_scores.launch(*args, w, lanes, order))):
                raise AssertionError(f"lab {label}: differs from the scores "
                                     "kernel")
            key = (f"dp_abl_kernel<{w},{lanes},{arg}>" if kind == "abl" else
                   f"dp_inter_kernel<{w},{lanes},{arg}>")
            rec = {"kernel": kind, "lanes": lanes, "instance": key,
                   ("flag" if kind == "abl" else "groups"):
                   flag_name[arg] if kind == "abl" else arg,
                   "max_abs_err": int((got.long() - ref.long()).abs().max()),
                   "wrong_pairs": int((ref != want).sum())}
            rec.update({k: sass[key].get(k) for k in (
                "total", "loop", "per_tile_cell", "per_tile_cell_by_width",
                "registers", "spill_stores", "spill_loads")})
            rec["ms"] = _median_ms(call, N_SWEEP)
            insts.append(rec)
            calls.append(call)
    scores_calls = [lambda ln=ln: dp_scores.launch(*args, w, ln, order)
                    for ln in lab.LANES]
    dev_ms = _device_ms(calls + scores_calls, N_SWEEP)
    for rec, ms in zip(insts, dev_ms):
        rec["device_ms"] = ms
        print(f"lab instance {json.dumps(rec)}", flush=True)
    scores_dev = dict(zip(lab.LANES, dev_ms[len(insts):]))
    scores_ms = {ln: _median_ms(call, N_SWEEP)
                 for ln, call in zip(lab.LANES, scores_calls)}

    # The split: device ms back to back at each L; a flag's saving is the
    # no-flag instance's time less its own, as a share of the no-flag time.
    def find(kind, lanes, what):
        return next(r for r in insts if r["kernel"] == kind and
                    r["lanes"] == lanes and
                    r["flag" if kind == "abl" else "groups"] == what)

    split = {}
    print("lab split (device ms back to back; in brackets the saving "
          "against abl none at the same L):", flush=True)
    for ln in lab.LANES:
        none = find("abl", ln, "none")["device_ms"]
        row = {"scores_kernel": scores_dev[ln], "none": none}
        cells = [f"scores kernel {scores_dev[ln]:.4f}", f"none {none:.4f}"]
        for f in lab.ABL_FLAGS:
            ms = find("abl", ln, f)["device_ms"]
            row[f] = ms
            cells.append(f"{f} {ms:.4f} [{(none - ms) / none:+.1%}]")
        for g in lab.GROUPS:
            ms = find("inter", ln, g)["device_ms"]
            row[f"inter{g}"] = ms
            cells.append(f"inter{g} {ms:.4f} [{(none - ms) / none:+.1%}]")
        split[ln] = row
        print(f"  L={ln:<2}  " + "  ".join(cells), flush=True)
        same = {k: (sass[f"dp_abl_kernel<{w},{ln},0>"].get(k),
                    sass[f"dp_scores_kernel<{w},{ln}>"].get(k))
                for k in ("total", "loop", "per_tile_cell_by_width",
                          "registers", "spill_stores")}
        print(f"        sass abl none vs scores kernel: {json.dumps(same)}",
              flush=True)

    common = {k: scores_bench[k] for k in ("n", "t_max", "p_max", "w",
                                            "cells", "bytes", "bound_ms",
                                            "bound_by")}
    plain_ms = _median_ms(lambda: banded_affine_scores_plain(*args, w),
                          N_PLAIN, warmup=1)
    abl_plain_ms = _median_ms(
        lambda: lab.banded_affine_scores_ablated(*args, w), N_PLAIN,
        warmup=1)
    out = {}
    # The kernels line's rows: each kernel at the wrapper's default L.
    abl_lanes = dp_scores.lanes_for(len(tl), w)
    for g in lab.GROUPS:
        r = find("inter", lab.INTER_LANES, g)
        out[f"inter{g}"] = dict(
            common, lanes=lab.INTER_LANES, instance=r["instance"],
            ms=r["ms"], device_ms=r["device_ms"], plain_ms=plain_ms,
            wrapper_ms=timed[f"inter{g}"]["ms"],
            max_abs_err=max(i["max_abs_err"] for i in insts
                            if i["kernel"] == "inter" and i["groups"] == g),
            launches=sum(launches[f"inter{g}"].values()),
            launches_by_lanes=launches[f"inter{g}"],
            instances=[{k: i[k] for k in ("lanes", "ms", "device_ms",
                                          "registers", "spill_stores",
                                          "spill_loads")}
                       for i in insts if i["kernel"] == "inter"
                       and i["groups"] == g])
    r = find("abl", abl_lanes, "none")
    out["abl"] = dict(
        common, lanes=abl_lanes, instance=r["instance"], ms=r["ms"],
        device_ms=r["device_ms"], plain_ms=abl_plain_ms,
        wrapper_ms=timed["abl (no flag)"]["ms"],
        scores_kernel_ms=scores_ms[abl_lanes],
        scores_kernel_device_ms=scores_dev[abl_lanes],
        max_abs_err=max(i["max_abs_err"] for i in insts
                        if i["kernel"] == "abl"),
        launches=sum(launches["abl"].values()),
        launches_by_lanes=launches["abl"], split=split,
        instances=[{k: i[k] for k in ("lanes", "flag", "ms", "device_ms",
                                      "registers", "spill_stores",
                                      "spill_loads")}
                   for i in insts if i["kernel"] == "abl"])
    for rec in out.values():
        rec["kernel_over_bound"] = rec["ms"] / rec["bound_ms"]
        rec["cells_per_s"] = rec["cells"] / (rec["ms"] * 1e-3)
    rows = {k: {x: v for x, v in r.items() if x not in ("instances", "split")}
            for k, r in out.items()}
    print(f"lab: every instance bit-equal to its plain version "
          f"{json.dumps(rows)}", flush=True)
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


def _realign_inputs(card_prefix: str, coord: str):
    from trust4_tpu_torch.io.fastx import read_fastx

    reads = [r.seq for r in read_fastx(card_prefix + "_toassemble.fq")]
    contigs = []
    with open(card_prefix + "_final.out") as f:
        for line in f:
            if line.startswith(">"):
                contigs.append(next(f).strip())
    return reads, contigs, _fasta_seqs(coord)


def phase_realign(card_prefix: str, coord: str):
    """The realign round on the scale run's own card outputs; returns the
    launches of the card run and its five outputs."""
    from trust4_tpu_torch.ops import dp_scores
    from trust4_tpu_torch.parallel import default_chunk, realign_round

    reads, contigs, germ = _realign_inputs(card_prefix, coord)
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
    return launches, card


def phase_prefilter(work: str, coord: str, imgt: str) -> dict:
    """A 20k-read corpus through run_trust4 with the prefilter on the
    card and with the default native extractor: byte-identical artifacts.
    Returns the survivor share and the prefilter's card time."""
    from trust4_tpu_torch.tools.make_bench_corpus import make_corpus
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


def _same_file(a: str, b: str, what: str) -> None:
    if not filecmp.cmp(a, b, shallow=False):
        raise AssertionError(f"ranks phase: {what} differs")


def _rank_counts():
    from trust4_tpu_torch.ops import dp_counts, dp_scores

    return {"dp_counts": dp_counts.LAUNCHES, "dp_scores": dp_scores.LAUNCHES}


def _zero_counts() -> None:
    from trust4_tpu_torch.ops import dp_counts, dp_scores

    dp_counts.LAUNCHES = 0
    dp_scores.LAUNCHES = 0


def _join_prewarm(dev) -> int:
    """Join this process's gap-oracle prewarm on ``dev`` (starting it if
    none ran) before any launch count is set to 0, so that no part counts
    the prewarm's launches; returns the launches made while joining, and
    fails if there were none (the prewarm never reached the card)."""
    from trust4_tpu_torch.ops import dp_counts, gap_oracle

    n0 = dp_counts.LAUNCHES
    gap_oracle.wait_ready(dev)
    torch.cuda.synchronize()
    n = dp_counts.LAUNCHES - n0
    if n == 0:
        raise AssertionError(f"the prewarm on {dev} launched nothing")
    return n


def _prewarm_launches() -> int:
    from trust4_tpu_torch.ops import gap_oracle

    return gap_oracle.STATS["prewarm_launches"]


def _ranks_body(spec: dict) -> dict:
    """One rank of a world of the ranks phase: (a) mesh_tier_counts at
    each tier's full chunk over the whole world; in a world of 4 (b) the
    realign round at (1, 1), (2, 1) and (2, 2); in worlds of 2 and 4 (c)
    the scale run's annotation stage under TRUST4_TPU_GAP_MESH and (d) the
    barcoded assembly through the mesh executor.  Each part is driven
    with the launch counts set to 0 just before it and read just after;
    any difference, or a part that launched no kernel, raises.  The
    rank's prewarm is joined before the first part, and a part inside
    which a prewarm launched raises: no part counts its launches."""
    import torch.distributed as dist

    from trust4_tpu_torch.ops.gap_oracle import _TIERS
    from trust4_tpu_torch.parallel import (
        gap_mesh,
        make_mesh,
        mesh_partition_executor,
        sharded_realign_round,
    )
    from trust4_tpu_torch.pipeline.assembler import Assembler
    from trust4_tpu_torch.pipeline.run import run_trust4

    rank, n = dist.get_rank(), dist.get_world_size()
    dev = spec["device"]
    rec = {"rank": rank, "ranks": n, "backend": dist.get_backend(),
           "parts": {}, "prewarm_launches": _join_prewarm(dev)}

    def part(name, fn, kernel):
        torch.cuda.synchronize()
        pw0 = _prewarm_launches()
        _zero_counts()
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _rank_counts()
        if _prewarm_launches() != pw0:
            raise AssertionError(f"ranks {name}: a prewarm launched inside "
                                 f"the part on rank {rank} of {n}")
        if launches[kernel] == 0:
            raise AssertionError(f"ranks {name}: rank {rank} of {n} never "
                                 f"launched {kernel}")
        rec["parts"][name] = {"wall_s": wall, "launches": launches,
                              **(info or {})}

    # (a) each tier's full chunk over the whole world.
    tiers = np.load(spec["tiers"])

    def tier_counts():
        m = gap_mesh.make_mesh(n, device=dev)
        for ti, (_cap, w, _chunk) in enumerate(_TIERS):
            got = gap_mesh.mesh_tier_counts(
                m, tiers[f"tc{ti}"], tiers[f"pc{ti}"], tiers[f"tl{ti}"],
                tiers[f"pl{ti}"], w=w)
            if not np.array_equal(got, tiers[f"want{ti}"]):
                raise AssertionError(f"ranks (a): tier {ti} differs on rank "
                                     f"{rank} of {n}")
        if n == 1:
            # A mesh of one rank needs no group; the world's own group
            # carries one collective on the card.
            one = torch.ones(4, dtype=torch.int32, device=m.device)
            dist.all_reduce(one)
            if int(one.sum()) != 4:
                raise AssertionError("ranks (a): all-reduce over one rank")

    part("gap_mesh", tier_counts, "dp_counts")

    if n == 4:
        reads, contigs, germ = _realign_inputs(spec["scale"], spec["coord"])
        ref = np.load(spec["realign"])
        names = ("cand", "scores", "ids", "posWeight", "n_cand")
        for shape in ((1, 1), (2, 1), (2, 2)):
            m = make_mesh(shape, ("dp", "mp"), ranks=range(shape[0] *
                                                            shape[1]),
                          device=dev)
            if m is None:
                continue

            def realign(m=m, shape=shape):
                got = sharded_realign_round(m, reads, contigs, germ)
                nb, nc = len(reads), len(contigs)
                for name, x, want in zip(names, got, (
                        ref["cand"], ref["scores"], ref["ids"], ref["pw"],
                        int(ref["n_cand"]))):
                    x = np.asarray(x)
                    x = x[:nc] if name == "posWeight" else (
                        x if name == "n_cand" else x[:nb])
                    if not np.array_equal(x, want):
                        raise AssertionError(
                            f"ranks (b): {name} differs at {shape} on rank "
                            f"{rank}")
                return {"shape": list(shape)}

            part(f"realign_{shape[0]}x{shape[1]}", realign, "dp_scores")

    if n > 1:
        threads = max(1, (os.cpu_count() or 1) // n)
        here = os.path.join(spec["work"], f"ranks{n}_r{rank}")
        os.makedirs(here)
        prefix = os.path.join(here, "bulk")
        for suf in ("_toassemble.fq", "_final.out", "_assembled_reads.fa"):
            shutil.copy(spec["scale"] + suf, prefix + suf)

        def annotate():
            os.environ["TRUST4_TPU_GAP_MESH"] = str(n)
            try:
                run_trust4(spec["coord"], spec["imgt"],
                           single_files=[prefix + "_toassemble.fq"],
                           output_prefix=prefix, stage=2, threads=threads,
                           device=dev)
            finally:
                del os.environ["TRUST4_TPU_GAP_MESH"]
            for suf in ("_cdr3.out", "_annot.fa"):
                _same_file(prefix + suf, spec["scale"] + suf,
                           f"{suf} under the {n}-rank gap mesh")

        part("annotate_gap_mesh", annotate, "dp_counts")

        def assemble():
            bc = spec["barcoded"]
            asm = Assembler(spec["coord"],
                            output_prefix=os.path.join(here, "bc"),
                            threads=spec["bc_threads"], device=dev)
            spans = []
            run = mesh_partition_executor(make_mesh((n,), ("dp",),
                                                    device=dev))

            def counting(run_part, bounds, workers):
                out = run(run_part, bounds, workers)
                spans.append(len(bounds) - 1)
                return out

            asm._partition_executor = counting
            asm.run([bc + ".fq"], None, barcode_files=[bc + "_bc.fa"],
                    umi_files=[bc + "_umi.fa"])
            if not spans or spans[0] < n:
                raise AssertionError(f"ranks (d): spans {spans}")
            _same_file(os.path.join(here, "bc_final.out"),
                       spec["bc_pool"] + "_final.out",
                       f"_final.out of the {n}-rank mesh executor")
            return {"spans": spans[0]}

        part("barcoded_assembly", assemble, "dp_counts")
    return rec


def phase_ranks(work: str, coord: str, imgt: str, realign_card) -> dict:
    """The multi-GPU layer on one card: worlds of 1 (NCCL), 2 and 4
    (gloo) ranks over cuda:0, spawned by parallel/mesh.py (see
    _ranks_body).  Returns the launches by kernel over every rank, and
    the ranks' prewarms' launches apart."""
    from trust4_tpu_torch.tools.make_bench_corpus import make_barcoded_corpus
    from trust4_tpu_torch.ops import dp_counts
    from trust4_tpu_torch.ops.gap_oracle import _TIERS
    from trust4_tpu_torch.parallel.mesh import spawn
    from trust4_tpu_torch.pipeline.assembler import Assembler
    from trust4_tpu_torch.pipeline.extract import run_barcoded_extractor
    from trust4_tpu_torch.testing import rand_gap_jobs

    # (a) each tier's full chunk and its single-card counts.
    arrays = {}
    for ti, (cap, w, chunk) in enumerate(_TIERS):
        _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(
            np.random.default_rng(1000 + cap), chunk, cap, w)
        args = dp_counts.to_device_jobs(tc, tl, pc, pl, torch.device("cuda"))
        arrays.update({f"tc{ti}": tc, f"tl{ti}": tl, f"pc{ti}": pc,
                       f"pl{ti}": pl, f"want{ti}": dp_counts.
                       banded_affine_counts(*args, w)[1].cpu().numpy()})
    tiers = os.path.join(work, "ranks_tiers.npz")
    np.savez(tiers, **arrays)
    # (b) the scale run's realign round on one card.
    realign = os.path.join(work, "ranks_realign.npz")
    cand, scores, ids, pw, n_cand = realign_card
    np.savez(realign, cand=cand, scores=scores, ids=ids, pw=pw,
             n_cand=n_cand)
    # (d) the barcoded corpus, extracted, and the thread pool's assembly.
    t0 = time.perf_counter()
    reads_fq = os.path.join(work, "bc_reads.fq")
    bc_fq = os.path.join(work, "bc_bc.fq")
    make_barcoded_corpus(reads_fq, bc_fq, ref_fa=coord)
    bc = os.path.join(work, "bc_toassemble")
    run_barcoded_extractor(coord, [reads_fq], None, bc, barcode_files=[bc_fq],
                           umi_files=[bc_fq],
                           read_format="bc:0:15,um:16:25")
    with open(bc + ".fq") as f:
        n_bc = sum(1 for _ in f) // 4
    t1 = time.perf_counter()
    bc_threads = os.cpu_count() or 1
    pool = os.path.join(work, "bc_pool")
    Assembler(coord, output_prefix=pool, threads=bc_threads,
              device="cuda").run([bc + ".fq"], None,
                                 barcode_files=[bc + "_bc.fa"],
                                 umi_files=[bc + "_umi.fa"])
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t1
    print(f"ranks (d): barcoded corpus {n_bc} reads after extraction in "
          f"{t1 - t0:.3f} s; thread pool ({bc_threads} threads) assembly "
          f"{pool_s:.3f} s", flush=True)
    spec = {"tiers": tiers, "realign": realign,
            "scale": os.path.join(work, "card", "bulk"), "coord": coord,
            "imgt": imgt, "work": work, "barcoded": bc, "bc_pool": pool,
            "bc_threads": bc_threads}
    launches = {"dp_counts": 0, "dp_scores": 0}
    prewarm_launches = 0
    worlds = {}
    for n, backend, device in ((1, "nccl", "cuda"), (2, "gloo", "cuda:0"),
                               (4, "gloo", "cuda:0")):
        t0 = time.perf_counter()
        recs = spawn(_ranks_body, n, backend=backend, device=device,
                     args=({**spec, "device": device},), timeout_s=900)
        wall = time.perf_counter() - t0
        prewarm_launches += sum(r["prewarm_launches"] for r in recs)
        print(f"ranks: world of {n} rank(s), backend {backend}, device "
              f"{device}, spawn to join {wall:.3f} s; prewarm launches by "
              f"rank {[r['prewarm_launches'] for r in recs]}", flush=True)
        for name in recs[0]["parts"]:
            per = [r["parts"].get(name) for r in recs]
            per = [p for p in per if p is not None]
            for p in per:
                for k in launches:
                    launches[k] += p["launches"][k]
            print(f"ranks: {name}: {len(per)} rank(s), backend "
                  f"{recs[0]['backend']}, wall_s "
                  f"{[round(p['wall_s'], 3) for p in per]}, launches "
                  f"{[p['launches'] for p in per]}"
                  + (f", spans {per[0]['spans']}" if "spans" in per[0]
                     else ""), flush=True)
        worlds[n] = {"wall_s": wall, "backend": backend, "ranks": recs}
    print(f"ranks: every part equal to one card; launches over all ranks "
          f"{json.dumps(launches)} (and the prewarms' {prewarm_launches})",
          flush=True)
    return {"launches": launches, "prewarm_launches": prewarm_launches,
            "bc_reads": n_bc, "pool_s": pool_s}


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
    if gap_oracle.STATS["prewarm_launches"]:
        raise AssertionError(f"{prefix}: a prewarm launched inside the run; "
                             "its launches would count as the run's")
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


def phase_extract(coord: str) -> dict:
    """Kernel #8 (ops/extract_filter.py) on one bulk stream batch of each
    mix (EXTRACT_MIXES) on the stand-in's index at k = 9 and a hit length
    of 23, launches counted from 0 around it: its decisions equal to the
    host filter's (NativeCandidateFilter.filter_batch on 8 threads, what
    it replaces on the main path) and to the plain version's
    (engine/overlap.py ``has_hit_in_set`` behind the low-complexity
    guard, one thread), none undecided; the CUDA-event median of N_TIMED
    launches, its inputs on the card, the back-to-back device time, the
    bound (bytes: the reads, their offsets, the decisions and the tables
    once, over HBM) and both host versions' ms.  Returns the mixes'
    records, each with the launches."""
    from trust4_tpu_torch import testing
    from trust4_tpu_torch.engine.seqset import SeqSet
    from trust4_tpu_torch.ops import extract_filter
    from trust4_tpu_torch.pipeline import extract_native
    from trust4_tpu_torch.pipeline.extract import is_low_complexity

    ss = SeqSet(9)
    ss.set_native_only_index()
    ss.input_ref_fa(coord)
    native = extract_native.NativeCandidateFilter(
        [sw.consensus for sw in ss.seqs], 9, ss.radius, 23)
    plain = SeqSet(9)
    plain.input_ref_fa(coord)
    plain.hit_len_required = 23
    card = extract_filter.CardFilter(native, "cuda")
    table_bytes = sum(t.numel() * t.element_size()
                      for t in (card.off, card.posts))
    out = {}
    for name, share in EXTRACT_MIXES:
        reads = testing.mix_reads(coord, EXTRACT_BATCH, share, 23)
        launches = extract_filter.launches()
        got = card.decide(reads)
        launches = extract_filter.launches() - launches
        t0 = time.perf_counter()
        host = native.filter_batch(reads, threads=8)
        host_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = np.array([0 if is_low_complexity(r) else
                         plain.has_hit_in_set(r) for r in reads], np.int8)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        if not np.array_equal(host, want):
            raise AssertionError(f"extract {name}: the host filter differs "
                                 "from the plain version")
        if not np.array_equal(got, want):
            raise AssertionError(
                f"extract {name}: #8 differs from the host filter on "
                f"{int((got != want).sum())} reads "
                f"({int((got == extract_native.UNDECIDED).sum())} "
                f"undecided)")
        if launches != 1:
            raise AssertionError(f"extract {name}: {launches} launches")
        batch = card.put(reads)
        n_bytes = sum(t.numel() * t.element_size() for t in batch)
        rec = {"mix": name, "share": share, "n": len(reads),
               "candidates": int((want != 0).sum()), "launches": launches,
               "mismatches": 0,
               "ms": _median_ms(lambda: card.launch(*batch), N_TIMED),
               "device_ms": _device_ms([lambda: card.launch(*batch)],
                                       N_TIMED)[0],
               "bound_ms": 1e3 * (n_bytes + table_bytes) / HBM_BYTES_PER_S,
               "bound_by": "bytes", "host_ms": host_ms,
               "plain_ms": plain_ms}
        print(f"extract {json.dumps(rec)}", flush=True)
        out[name] = rec
    return out


def phase_scale(work: str, coord: str, imgt: str, n_reads: int) -> dict:
    """The main path at scale on the card, then the native CPU DP; the
    artifacts must agree byte for byte.  Returns the card run's record
    with the launches of #1 (``launches``) and of #8
    (``extract_launches``) counted from 0 around it."""
    from trust4_tpu_torch.tools.make_bench_corpus import make_corpus
    from trust4_tpu_torch.ops import dp_counts, extract_filter

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
    xf0 = extract_filter.launches()
    res = _run(card, device="cuda", **kw)
    res["launches"] = dp_counts.LAUNCHES
    res["extract_launches"] = extract_filter.launches() - xf0
    os.environ["TRUST4_TPU_DEVICE"] = "0"
    xf0 = extract_filter.launches()
    try:
        res_cpu = _run(cpu, device="cuda", **kw)
    finally:
        del os.environ["TRUST4_TPU_DEVICE"]
    res_cpu["extract_launches"] = extract_filter.launches() - xf0
    print(f"scale card: {json.dumps(res)}", flush=True)
    print(f"scale TRUST4_TPU_DEVICE=0: {json.dumps(res_cpu)}", flush=True)
    if res["launches"] == 0:
        raise AssertionError("scale phase: the kernel never launched")
    # The prewarm was joined before: the run decides its extraction on
    # the card, one launch of #8 a stream batch.
    if res["extract_launches"] != -(-n_reads // EXTRACT_BATCH):
        raise AssertionError(f"scale phase: #8 launched "
                             f"{res['extract_launches']} times for "
                             f"{n_reads} reads")
    if res_cpu["extract_launches"]:
        raise AssertionError("TRUST4_TPU_DEVICE=0 launched #8")
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
    print(f"scale card: assemble stage {res['stages_s'].get('assemble')} s "
          f"with the prewarm joined before the gold phase (the first batch "
          f"waited {orc['ready_wait_s']:.6f} s for it; completion polls "
          f"{orc['complete_wait_s']:.6f} s)", flush=True)
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


# Modes phase sizes: what users run, halved for the script's time limit
# (with 5,000 cells, 250,000 pairs and 96 wells the whole script took
# 1,001 s of its 1,200 s on one NVIDIA H100 80GB HBM3 host, PERF.md).  A 5' V(D)J library of a few
# thousand cells; a bulk BAM of half the scale corpus's reads; half a
# 96-well SMART-seq plate.
SC_CELLS = 2500
BAM_PAIRS = 125_000
BAM_BC_PAIRS = 20_000
PLATE_CELLS = 48
PLATE_PAIRS = 2000
# Part (f)'s deadlines (seconds).
DEADLINE_S = 1
READY_DEADLINE_S = 2


def _stage_sums(text: str) -> dict:
    """Every [stage-time] wall (stages and sub-stages such as asm/loop),
    summed over the runs in ``text``."""
    out = {}
    for m in re.finditer(r"\[stage-time\]\s+(\S+): ([0-9.]+)s", text):
        out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(2))
    return out


def _same_dirs(a: str, b: str, what: str) -> list:
    names = sorted(os.listdir(a))
    if not names or names != sorted(os.listdir(b)):
        raise AssertionError(f"modes phase: {what}: files {names} vs "
                             f"{sorted(os.listdir(b))}")
    for n in names:
        if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False):
            raise AssertionError(f"modes phase: {what}: {n} differs card "
                                 "vs TRUST4_TPU_DEVICE=0")
    return names


def _card_and_cpu(work: str, tag: str, fn) -> dict:
    """fn(out_dir) on the card, launches (of #1, and of #8 where the part
    streams bulk reads) counted from 0 around it, then with
    TRUST4_TPU_DEVICE=0 (the native CPU DP, the filter on the threads);
    every file the two write must be byte-identical, and the card run
    must launch #1 (the process's prewarm was joined before: a prewarm
    launching inside either run fails)."""
    from trust4_tpu_torch.ops import dp_counts, extract_filter, gap_oracle

    rec = {}
    for mode in ("card", "cpu"):
        d = os.path.join(work, "modes", tag, mode)
        os.makedirs(d)
        if mode == "cpu":
            os.environ["TRUST4_TPU_DEVICE"] = "0"
        gap_oracle.reset_stats()
        tee = _Tee(sys.stderr)
        dp_counts.LAUNCHES = 0
        xf0 = extract_filter.launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(tee):
                fn(d)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("TRUST4_TPU_DEVICE", None)
        orc = gap_oracle.STATS
        if orc["prewarm_launches"]:
            raise AssertionError(f"modes phase: {tag}: a prewarm launched "
                                 "inside the part")
        rec[mode] = {"wall_s": time.perf_counter() - t0,
                     "stages_s": _stage_sums(tee.buf.getvalue()),
                     "launches": dp_counts.LAUNCHES,
                     "extract_launches": extract_filter.launches() - xf0,
                     "gap_fills": orc["gap_fills"],
                     "tier_unique": list(orc["tier_unique"]),
                     "tier_launches": list(orc["tier_launches"])}
    if rec["card"]["launches"] == 0:
        raise AssertionError(f"modes phase: {tag}: #1 never launched")
    if (rec["cpu"]["launches"] or rec["cpu"]["gap_fills"]
            or rec["cpu"]["extract_launches"]):
        raise AssertionError(f"modes phase: {tag}: TRUST4_TPU_DEVICE=0 "
                             "ran the oracle")
    names = _same_dirs(os.path.join(work, "modes", tag, "card"),
                       os.path.join(work, "modes", tag, "cpu"), tag)
    rec["files"] = len(names)
    print(f"modes {tag}: launches {rec['card']['launches']}, "
          f"{len(names)} files byte-identical card vs TRUST4_TPU_DEVICE=0; "
          f"card {json.dumps(rec['card'])}; TRUST4_TPU_DEVICE=0 "
          f"{json.dumps(rec['cpu'])}", flush=True)
    return rec


def _hold_golden(path: str, golden: str, what: str) -> None:
    if not filecmp.cmp(path, golden, shallow=False):
        raise AssertionError(f"modes phase: {what} differs from {golden}")


# A child of part (f): run_trust4 with the arguments in argv[1] (JSON);
# prints its launches (the run's, the cold prewarm's apart), oracle totals
# and wall as JSON.  A missed deadline raises GapDeviceTimeout out of the
# child, which exits non-zero.
_DEADLINE_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from trust4_tpu_torch.ops import dp_counts, gap_oracle
from trust4_tpu_torch.pipeline.run import run_trust4
gap_oracle.reset_stats()
t0 = time.perf_counter()
run_trust4(**json.loads(sys.argv[1]))
torch.cuda.synchronize()
pw = gap_oracle.STATS["prewarm_launches"]
print(json.dumps({"wall_s": time.perf_counter() - t0,
                  "launches": dp_counts.LAUNCHES - pw,
                  "prewarm_launches": pw, "oracle": gap_oracle.STATS}))
"""


def _deadline_children(work: str, coord: str, imgt: str,
                       scale_cpu: str) -> dict:
    """(f): the scale corpus under TRUST4_TPU_DEVICE_TIMEOUT_S=1 in a fresh
    process (so its prewarm starts cold), byte-identical to the scale
    phase's TRUST4_TPU_DEVICE=0 run; and the gold reads under each hang
    hook, which must raise GapDeviceTimeout within the deadline and exit
    non-zero."""
    base = os.path.join(work, "modes", "deadline")
    hangs = {
        "hang-ready": ("TRUST4_TPU_DEVICE_READY_TIMEOUT_S", READY_DEADLINE_S),
        "hang-launch": ("TRUST4_TPU_DEVICE_TIMEOUT_S", DEADLINE_S),
    }
    procs = {}
    for hook, (env, limit) in hangs.items():
        gold = os.path.join(base, hook, "gold")
        os.makedirs(os.path.dirname(gold))
        for m in (1, 2):
            shutil.copy(os.path.join(GOLD, f"gold_toassemble_{m}.fq"),
                        f"{gold}_toassemble_{m}.fq")
        gold_kw = dict(coord_fasta=coord, imgt_fasta=imgt,
                       read1_files=[f"{gold}_toassemble_1.fq"],
                       read2_files=[f"{gold}_toassemble_2.fq"], stage=1,
                       output_prefix=gold, device="cuda")
        procs[hook] = subprocess.Popen(
            [sys.executable, "-c", _DEADLINE_CHILD, json.dumps(gold_kw)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "TRUST4_TPU_GAP_TEST": hook,
                            env: str(limit)})
    rec = {}
    for hook, proc in procs.items():
        env, limit = hangs[hook]
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        m = re.search(r"GapDeviceTimeout: .*" + env + r"=[0-9.]+ s \(waited "
                      r"([0-9.]+) s\)", err)
        if proc.returncode == 0 or m is None:
            raise AssertionError(f"modes phase: (f) {hook}: rc "
                                 f"{proc.returncode}, stderr tail "
                                 f"{err[-2000:]}")
        waited = float(m.group(1))
        if not limit <= waited <= limit + 1.0:
            raise AssertionError(f"modes phase: (f) {hook}: waited {waited} s "
                                 f"for a {limit} s deadline")
        rec[hook] = {"rc": proc.returncode, "deadline_s": limit,
                     "waited_s": waited}
        print(f"modes (f) {hook}: the child raised GapDeviceTimeout after "
              f"{waited:.3f} s ({env}={limit}) and exited "
              f"{proc.returncode}", flush=True)

    out_dir = os.path.join(base, "bulk")
    os.makedirs(out_dir)
    kw = dict(coord_fasta=coord, imgt_fasta=imgt,
              single_files=[os.path.join(work, "bulk.fq")],
              output_prefix=os.path.join(out_dir, "bulk"),
              threads=os.cpu_count() or 1, device="cuda")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", _DEADLINE_CHILD, json.dumps(kw)], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "TRUST4_TPU_DEVICE_TIMEOUT_S": str(DEADLINE_S)})
    if r.returncode != 0:
        raise AssertionError(f"modes phase: (f) the 1 s-deadline run exited "
                             f"{r.returncode}: {r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    for suf in ("_toassemble.fq",) + ARTIFACTS + ("_report.tsv",
                                                   "_airr.tsv"):
        _hold_golden(os.path.join(out_dir, "bulk" + suf), scale_cpu + suf,
                     f"(f) 1 s-deadline run {suf}")
    orc = res["oracle"]
    if res["launches"] == 0 or res["prewarm_launches"] == 0:
        raise AssertionError(f"modes phase: (f) launches {res['launches']}, "
                             f"the prewarm's {res['prewarm_launches']}")
    if sum(orc["tier_launches"]) != res["launches"]:
        raise AssertionError("modes phase: (f) the oracle's events missed "
                             "launches")
    rec["deadline_run"] = {
        "child_wall_s": time.perf_counter() - t0, "wall_s": res["wall_s"],
        "stages_s": _stage_sums(r.stderr), "launches": res["launches"],
        "prewarm_launches": res["prewarm_launches"],
        "ready_wait_s": orc["ready_wait_s"],
        "complete_wait_s": orc["complete_wait_s"]}
    print(f"modes (f): the scale corpus under TRUST4_TPU_DEVICE_TIMEOUT_S="
          f"{DEADLINE_S} in a fresh process completed, byte-identical to "
          f"TRUST4_TPU_DEVICE=0; {json.dumps(rec['deadline_run'])}",
          flush=True)
    return rec


def _write_whitelist(bc_fq: str, path: str, seed: int) -> int:
    """The cells' barcodes (first 16 bases of each barcode read) and as
    many random ones, sorted: a whitelist wider than the sample."""
    import random

    cells = set()
    with open(bc_fq) as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                cells.add(line[:16])
    rnd = random.Random(seed)
    extra = {"".join(rnd.choice("ACGT") for _ in range(16))
             for _ in range(len(cells))}
    with open(path, "w") as f:
        f.write("".join(b + "\n" for b in sorted(cells | extra)))
    return len(cells)


def phase_modes(work: str, coord: str, imgt: str, coord_bam: str) -> dict:
    """The entry points other than bulk FASTQ, each part on the card and
    with TRUST4_TPU_DEVICE=0 (byte-identical), launches of #1 counted from
    0 around each card run.  Returns {part: launches} and the launches
    of part (f)'s cold prewarm."""
    from trust4_tpu_torch.tools.make_bench_corpus import make_barcoded_corpus
    from trust4_tpu_torch.pipeline.assembler import Assembler
    from trust4_tpu_torch.pipeline.extract import run_extractor
    from trust4_tpu_torch.pipeline.run import run_trust4
    from trust4_tpu_torch.pipeline.smartseq import run_smartseq
    from trust4_tpu_torch.testing import (
        write_smartseq_cell,
        write_standin_bam,
    )

    threads = os.cpu_count() or 1
    launches = {}
    t_phase = time.perf_counter()

    # (a) barcoded run: a 10x-style corpus of SC_CELLS cells.
    t0 = time.perf_counter()
    reads, bc = (os.path.join(work, "sc_reads.fq"),
                 os.path.join(work, "sc_bc.fq"))
    n_reads = make_barcoded_corpus(reads, bc, n_cells=SC_CELLS,
                                   seed=20260817, ref_fa=coord_bam)
    wl = os.path.join(work, "sc_whitelist.txt")
    n_cells = _write_whitelist(bc, wl, 20260817)
    print(f"modes (a): {n_reads} reads of {n_cells} cells in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    launches["barcoded"] = _card_and_cpu(work, "barcoded", lambda d: run_trust4(
        coord_bam, imgt, single_files=[reads], barcode_files=[bc],
        umi_files=[bc], read_format="bc:0:15,um:16:25",
        barcode_whitelist=wl, output_prefix=os.path.join(d, "sc"),
        threads=threads, device="cuda"))["card"]["launches"]

    # (b) bulk BAM.
    t0 = time.perf_counter()
    bam = os.path.join(work, "bulk.bam")
    st = write_standin_bam(bam, coord_bam, BAM_PAIRS, seed=20261017)
    print(f"modes (b): BAM {json.dumps(st)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    launches["bam"] = _card_and_cpu(work, "bam", lambda d: run_trust4(
        coord_bam, imgt, bam_file=bam, output_prefix=os.path.join(d, "bam"),
        threads=threads, device="cuda"))["card"]["launches"]

    # (c) barcoded BAM: the committed bc.bam, and BAM_BC_PAIRS pairs with
    # CB/UB tags from the writer.
    bc_bam = os.path.join(GOLD, "bambc", "bc.bam")
    launches["bam_barcoded"] = _card_and_cpu(
        work, "bam_barcoded", lambda d: run_trust4(
            coord_bam, imgt, bam_file=bc_bam,
            output_prefix=os.path.join(d, "bb"), bam_barcode_field="CB",
            bam_umi_field="UB", threads=threads,
            device="cuda"))["card"]["launches"]
    card = os.path.join(work, "modes", "bam_barcoded", "card", "bb")
    for suf, gold in (("_toassemble_bc.fa", "gold_bc.fa"),
                      ("_toassemble_umi.fa", "gold_umi.fa"),
                      ("_toassemble_1.fq", "gold_1.fq"),
                      ("_final.out", "gold_final.out"),
                      ("_cdr3.out", "gold_cdr3.out")):
        _hold_golden(card + suf, os.path.join(GOLD, "bambc", gold),
                     f"(c) bc.bam {suf}")
    print("modes (c): bc.bam on the card equals its five goldens",
          flush=True)
    bam20 = os.path.join(work, "bc20k.bam")
    write_standin_bam(bam20, coord_bam, BAM_BC_PAIRS, seed=20261018,
                      barcodes=True)
    launches["bam_barcoded_20k"] = _card_and_cpu(
        work, "bam_barcoded_20k", lambda d: run_trust4(
            coord_bam, imgt, bam_file=bam20,
            output_prefix=os.path.join(d, "bb"), bam_barcode_field="CB",
            bam_umi_field="UB", threads=threads,
            device="cuda"))["card"]["launches"]

    # (d) SMART-seq: one plate, each cell from its own seed.
    t0 = time.perf_counter()
    plate = os.path.join(work, "plate")
    os.makedirs(plate)
    lists = [os.path.join(plate, f"list{m}.txt") for m in (1, 2)]
    with open(lists[0], "w") as l1, open(lists[1], "w") as l2:
        for c in range(PLATE_CELLS):
            r1, r2 = (os.path.join(plate, f"cell{c:02d}_{m}.fq")
                      for m in (1, 2))
            write_smartseq_cell(r1, r2, coord_bam, PLATE_PAIRS,
                                seed=20261100 + c)
            l1.write(r1 + "\n")
            l2.write(r2 + "\n")
    print(f"modes (d): {PLATE_CELLS} cells of {PLATE_PAIRS} pairs in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    def smartseq(d):
        tmp = d + "_tmp"
        os.makedirs(tmp)
        run_smartseq(coord_bam, imgt, *lists,
                     output_prefix=os.path.join(d, "plate"), tmp_dir=tmp,
                     device="cuda")

    launches["smartseq"] = _card_and_cpu(work, "smartseq",
                                         smartseq)["card"]["launches"]

    # (e) each mode of tests/data/modes at its committed size.
    modes = os.path.join(GOLD, "modes")
    gold_reads = [os.path.join(GOLD, f"gold_toassemble_{m}.fq")
                  for m in (1, 2)]

    def extract_assemble(fq, **kw):
        def fn(d):
            run_extractor(coord, [fq], None, os.path.join(d, "m_toassemble"))
            Assembler(coord, output_prefix=os.path.join(d, "m"),
                      device="cuda", **kw).run(
                [os.path.join(d, "m_toassemble.fq")])
        return fn

    def from_assembly(**kw):
        def fn(d):
            prefix = os.path.join(d, "m")
            for m in (1, 2):
                shutil.copy(gold_reads[m - 1], f"{prefix}_toassemble_{m}.fq")
            run_trust4(coord, coord if kw.get("ref_is_imgt") is False
                       else imgt, read1_files=[f"{prefix}_toassemble_1.fq"],
                       read2_files=[f"{prefix}_toassemble_2.fq"],
                       output_prefix=prefix, stage=1, device="cuda", **kw)
        return fn

    cases = {
        "repseq": (extract_assemble(os.path.join(modes, "repseq.fq"),
                                    trim_level=2, skip_mate_extension=True),
                   "gold_repseq_final.out", "_final.out"),
        "longreads": (extract_assemble(os.path.join(modes, "longreads.fq")),
                      "gold_longread_final.out", "_final.out"),
        "contigMinCov": (lambda d: run_trust4(
            coord, imgt, single_files=[os.path.join(modes, "mincov_r1.fq")],
            barcode_files=[os.path.join(modes, "mincov_bc.fq")],
            read_format="bc:0:15", contig_min_cov=4,
            output_prefix=os.path.join(d, "m"), device="cuda"),
            "gold_mincov_final.out", "_final.out"),
        "jellyfish": (lambda d: Assembler(
            coord, output_prefix=os.path.join(d, "m"), device="cuda",
            kmer_count_file=os.path.join(modes, "jellyfish_counts.fa"),
        ).run(gold_reads[:1], gold_reads[1:]),
            "jellyfish_final.out", "_final.out"),
        "notIMGT": (from_assembly(ref_is_imgt=False), "notimgt_annot.fa",
                    "_annot.fa"),
        "skipReadRealign": (from_assembly(skip_read_realign=True),
                            "skiprealign_cdr3.out", "_cdr3.out"),
    }
    for name, (fn, golden, ours) in cases.items():
        launches[name] = _card_and_cpu(work, name, fn)["card"]["launches"]
        _hold_golden(os.path.join(work, "modes", name, "card", "m" + ours),
                     os.path.join(modes, golden), f"(e) {name}")
    print("modes (e): every mode on the card equals its golden", flush=True)

    # (f) the deadlines.
    deadline = _deadline_children(work, coord, imgt,
                                  os.path.join(work, "cpu", "bulk"))
    launches["deadline"] = deadline["deadline_run"]["launches"]
    print(f"modes: every part exact; #1 launches by part "
          f"{json.dumps(launches)}; phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return launches, deadline["deadline_run"]["prewarm_launches"]


def phase_bench(work: str, coord: str, imgt: str) -> dict:
    """The port's bench (trust4_tpu_torch/bench.py) in a subprocess, the
    scale and barcoded parts gated off: exit 0, every timed bulk run held
    (2 configs x 2 rounds x 2 thread counts, each against the first
    TRUST4_TPU_DEVICE=0 run), bench.py's four keys last.  The device
    stack's boot: every run's [boot] line is relayed, and in each the boot
    thread loaded torch in the shipping mode, nothing did with
    TRUST4_TPU_DEVICE=0 (the bench raises otherwise, and this phase holds
    the record to it too); the import walls of the CLI alone, torch alone
    and both are printed.  Then a shipping-mode CLI run whose input is
    missing, so that extraction fails while the boot thread imports
    torch: it must exit 1 with its FileNotFoundError, and nothing more at
    the interpreter's shutdown.  Returns the bench's record."""
    record = os.path.join(work, "bench.json")
    env = dict(os.environ, T4BENCH_SCALE="0", T4BENCH_BARCODED="0")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "trust4_tpu_torch.bench", "--reads",
         str(BENCH_READS), "--record", record],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env)
    wall = time.perf_counter() - t0
    for line in (r.stderr + r.stdout).splitlines():
        print(f"bench | {line}", flush=True)
    if r.returncode != 0:
        raise AssertionError(f"bench phase: exited {r.returncode}")
    last = json.loads(r.stdout.strip().splitlines()[-1])
    if set(last) != {"metric", "value", "unit", "vs_baseline"}:
        raise AssertionError(f"bench phase: last line {last}")
    with open(record) as f:
        rec = json.load(f)
    if rec["bulk"]["held"] != 7:
        raise AssertionError(f"bench phase: {rec['bulk']['held']} of 8 runs "
                             "held")
    for t in ("t1", f"t{os.cpu_count()}"):
        boots = rec["bulk"][t]["device_boot"]
        by = {m: sorted({b["loaded_by"] for b in v}) for m, v in boots.items()}
        if by != {"default": ["trust4-gap-prewarm-cuda:0"], "off": ["none"]}:
            raise AssertionError(f"bench phase: torch loaded by {by} at {t}")
        print(f"bench boot {t}: torch loaded by the boot thread in every "
              "default run, never in an off run; import on the thread "
              f"{[b['import_s'] for b in boots['default']]} s, the main "
              "thread's wait at the joins "
              f"{[b['ready_wait_s'] for b in boots['default']]} s", flush=True)
    walls = rec["import_wall_s"]
    print("bench import walls (s, median of 3): " + json.dumps(
        {k: float(np.median(v)) for k, v in walls.items()}), flush=True)
    print(f"bench: exit 0 in {wall:.1f}s, 7 of 8 timed bulk runs held "
          f"byte-identical to the first TRUST4_TPU_DEVICE=0 run; {last}",
          flush=True)

    missing = os.path.join(work, "boot_missing")
    r = subprocess.run(
        [sys.executable, "-m", "trust4_tpu_torch", "run", "-u",
         os.path.join(missing, "absent.fq"), "-f", coord, "--ref", imgt,
         "-o", "m", "--od", missing],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, TRUST4_TPU_DEVICE="1"))
    errors = [x for x in r.stderr.splitlines() if "Error" in x[:40]]
    if r.returncode != 1 or len(errors) != 1 or \
            not errors[0].startswith("FileNotFoundError") or \
            "Fatal Python error" in r.stderr:
        raise AssertionError(f"bench phase: a run failing in extraction "
                             f"exited {r.returncode}: {r.stderr[-2000:]}")
    print(f"bench: a shipping-mode run with a missing input exited "
          f"{r.returncode} with its own error ({errors[0]}), nothing at "
          "shutdown", flush=True)
    return rec


# Fuzz phase parts (kind, seeds, threads, check): the JAX harnesses' own
# seed ranges and corpus sizes.  Seeds 9000-9039 draw no repseq corpus,
# so the first seed from 9000 up that does (9041, the one
# tests/test_torch_fuzz.py runs) is added, chosen by its mode.  The
# native collect's row order depends on the threads, hence the -t 8
# parts (at -t 8 the barcoded k-mer pass also spreads the barcodes over
# threads).
FUZZ_PARTS = (("bulk", tuple(range(9000, 9032)) + (9041,), 1, False),
              ("bulk", tuple(range(9032, 9040)), 8, False),
              ("barcoded", tuple(range(9000, 9016)), 1, False),
              ("barcoded", tuple(range(9000, 9016)), 8, False),
              ("bulk", tuple(range(9000, 9004)), 1, True))


def phase_fuzz(work: str, coord: str, imgt: str, card: str) -> dict:
    """trust4_tpu_torch.tools.fuzz_differential in this process on the
    card: every seed of ``FUZZ_PARTS`` in the shipping mode (launches
    counted from 0 around each run, the prewarm joined before) against
    TRUST4_TPU_DEVICE=0, every file byte-identical (report tables
    sorted); raises on any mismatch and unless #1 launched.  Prints each
    seed's line, the modes drawn, the jobs beyond the top tier per mode,
    the walls and the card."""
    from trust4_tpu_torch.tools import fuzz_differential as fz

    t0 = time.perf_counter()
    recs = []
    logs = io.StringIO()  # the runs' stderr, shown when a corpus fails
    for kind, seeds, threads, check in FUZZ_PARTS:
        tag = f"{kind}-t{threads}{'-check' if check else ''}"
        print(f"fuzz {tag}: seeds {seeds[0]}-{seeds[-1]} "
              f"({len(seeds)}), -t {threads}"
              f"{', TRUST4_TPU_DEVICE_CHECK=1' if check else ''}", flush=True)
        with contextlib.redirect_stderr(logs):
            part = fz.wave(seeds, kind, os.path.join(work, "fuzz", tag),
                           (coord, imgt), "cuda", threads, check)
        recs += [dict(r, part=tag) for r in part]
    wall = time.perf_counter() - t0
    bad = [r for r in recs if r["mismatches"]]
    if bad:
        print(logs.getvalue()[-20000:], file=sys.stderr, flush=True)
    ran = [r for r in recs if "dev" in r]
    if any(r["dev"]["prewarm_launches"] for r in ran):
        raise AssertionError("fuzz phase: a prewarm launched inside a run")
    # Per part: seeds by mode and jobs beyond the top tier by mode; the
    # summed walls (card, TRUST4_TPU_DEVICE=0) by part and by part/mode.
    modes, miss, walls = {}, {}, {}
    for r in ran:
        base = r["mode"].split("+")[0]
        m = modes.setdefault(r["part"], {})
        m[r["mode"]] = m.get(r["mode"], 0) + 1
        m = miss.setdefault(r["part"], {})
        m[base] = m.get(base, 0) + r["miss"]
        for key in (r["part"], f"{r['part']}/{base}"):
            w = walls.setdefault(key, {"card_s": 0.0, "off_s": 0.0})
            w["card_s"] += r["dev"]["wall_s"]
            w["off_s"] += r["off"]["wall_s"]
    out = {"corpora": len(recs), "mismatched": len(bad),
           "launches": sum(r["launches"] for r in ran),
           "fills": sum(r["fills"] for r in ran),
           "reads": sum(r["n"] for r in recs), "modes": modes, "miss": miss,
           "walls": walls, "wall_s": wall}
    print(f"fuzz: modes drawn per part {json.dumps(modes)}", flush=True)
    print(f"fuzz: jobs beyond the top tier (miss) per part and mode "
          f"{json.dumps(miss)}", flush=True)
    print(f"fuzz: MISMATCHED CORPORA: {len(bad)} of {len(recs)}; #1 "
          f"launches {out['launches']}; phase {wall:.1f}s; {card}; "
          f"{json.dumps(out)}", flush=True)
    if bad:
        raise AssertionError(f"fuzz phase: {len(bad)} mismatched corpora: "
                             + "; ".join(fz.seed_line(r) for r in bad))
    if out["launches"] == 0:
        raise AssertionError("fuzz phase: #1 never launched")
    return out


# Asan phase: bulk and barcoded seeds [7000, 7003), the first half of
# tools/asan_check.sh's [7000, 7006) (the seed count lowered to fit the
# script's time limit; every corpus at its recipe's size), its other
# parts at the tool's sizes.
ASAN_ARGS = ("7000", "7003", "--device", "cuda")
# Trace phase: the gold reads, and the first pe and the first long
# corpus from 9000 up (both reach the leftover path).
TRACE_SEEDS = (9000, 9004)


class _ToolPhase:
    """``python -m <argv>`` started as a subprocess on cuda:0, a thread
    reading its output and taking its wall when it exits; ``finish``
    waits for it (killing it at ``timeout`` s), prints its stdout lines
    as ``tag | line`` and its stderr's end when it failed (then raises),
    and returns (stdout, wall)."""

    def __init__(self, tag: str, argv, card: str, timeout: int):
        self.tag, self.argv, self.card, self.timeout = tag, argv, card, timeout
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
        self.done = {}
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self):
        out, err = self.proc.communicate()
        self.done.update(out=out, err=err, wall=time.perf_counter() - self.t0)

    def finish(self):
        self.waiter.join(max(0.0, self.t0 + self.timeout
                             - time.perf_counter()))
        if self.waiter.is_alive():
            self.proc.kill()
            self.waiter.join()
        out, err, wall = self.done["out"], self.done["err"], self.done["wall"]
        for line in out.splitlines():
            print(f"{self.tag} | {line}", flush=True)
        rc = self.proc.returncode
        print(f"{self.tag}: exit {rc} in {wall:.1f}s; {self.card}", flush=True)
        if rc != 0:
            print(err[-20000:], file=sys.stderr, flush=True)
            raise AssertionError(f"{self.tag} phase: {self.argv[0]} exited "
                                 f"{rc}")
        return out, wall


def phase_fuzz_asan_trace(work: str, coord: str, imgt: str, card: str):
    """The fuzz phase in this process, with the asan phase and the trace
    phase beside it as two subprocesses on the card, started just before
    it (none of the three times a kernel; the fuzz phase's aim is
    coverage, not a wall).  A failed fuzz phase kills both.

    Asan: trust4_tpu_torch.tools.asan_check (``ASAN_ARGS``), the native
    libraries with AddressSanitizer under libasan, every part in the
    shipping mode against TRUST4_TPU_DEVICE=0, byte-identical; it must
    exit 0 with ``asan check passed``, every part having launched #1.

    Trace: trust4_tpu_torch.tools.debug_trace_check on the card, the
    TRUST4_TPU_DEBUG=1 assembly trace of the gold reads and of the
    ``TRACE_SEEDS`` corpora in the shipping mode, byte-identical to
    TRUST4_TPU_DEVICE=0's.

    Prints the asan bulk and barcoded parts' wall per corpus against the
    fuzz phase's (both runs of a corpus, other seeds, -t 4 against -t 1,
    the three phases side by side).  Returns phase_fuzz's record and the
    asan parts' walls and launches, the trace's line counts and each
    tool's wall; raises when any of the three fails."""
    argv = ["trust4_tpu_torch.tools.debug_trace_check", "--device", "cuda"]
    for seed in TRACE_SEEDS:
        argv += ["--fuzz-seed", str(seed)]
    trace = _ToolPhase("trace", argv, card, 900)
    asan = _ToolPhase("asan", ("trust4_tpu_torch.tools.asan_check",
                               *ASAN_ARGS), card, 900)
    try:
        fuzz = phase_fuzz(work, coord, imgt, card)
    except BaseException:
        for tool in (asan, trace):
            tool.proc.kill()
        raise
    try:
        out, asan_wall = asan.finish()
    finally:
        trace_out, trace_wall = trace.finish()
    if out.splitlines()[-1] != "asan check passed":
        raise AssertionError("asan phase: no 'asan check passed' line")
    parts = {m.group(1): {"corpora": int(m.group(2)),
                          "wall_s": float(m.group(3)),
                          "launches": int(m.group(4))}
             for m in re.finditer(
                 r"^asan (\w+): corpora=(\d+) wall=([\d.]+)s fills=\d+ "
                 r"miss=\d+ launches=(\d+): OK$", out, re.M)}
    if set(parts) != {"gold", "bulk", "barcoded", "bam", "t8"}:
        raise AssertionError(f"asan phase: parts {sorted(parts)}")
    if not all(p["launches"] for p in parts.values()):
        raise AssertionError("asan phase: a part never launched #1")
    slowdown = {}
    for kind in ("bulk", "barcoded"):
        part = f"{kind}-t1"
        fuzz_s = (sum(fuzz["walls"][part].values())
                  / sum(fuzz["modes"][part].values()))
        asan_s = parts[kind]["wall_s"] / parts[kind]["corpora"]
        slowdown[kind] = asan_s / fuzz_s
        print(f"asan: {kind} {asan_s:.3f} s a corpus under ASan against "
              f"{fuzz_s:.3f} s in the fuzz phase ({part}): "
              f"{slowdown[kind]:.2f}x", flush=True)
    lines = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^(.+): debug trace identical \((\d+) lines\)$", trace_out, re.M)}
    if len(lines) != 1 + len(TRACE_SEEDS):
        raise AssertionError(f"trace phase: identical for {sorted(lines)} "
                             "only")
    return fuzz, {"parts": parts, "asan_wall_s": asan_wall,
                  "slowdown": slowdown,
                  "launches": sum(p["launches"] for p in parts.values()),
                  "trace_lines": lines, "trace_wall_s": trace_wall}


# Each phase's wall (s), printed before the kernels line.
WALLS = {}


def _timed(name: str, fn, *args):
    """fn(*args), its wall kept in WALLS under name."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        WALLS[name] = round(time.perf_counter() - t0, 1)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    card = card_line()
    print(card, flush=True)
    sass = _timed("build", phase_build)
    counts_shapes = _timed("kernels", phase_kernels, sass)
    tiers = [r for r in counts_shapes if r["shape"] == "chunk"]
    shapes = _timed("scores", phase_scores, sass)
    entry_launches = _timed("entry", phase_entry)

    from trust4_tpu_torch.testing import write_standin_references

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        coord, imgt = write_standin_references(os.path.join(work, "ref"))
        coord_bam = write_standin_references(os.path.join(work, "ref"),
                                             coordinates=True)[0]
        prewarm = {"main": _join_prewarm("cuda")}
        print(f"prewarm: joined in the main process before its first "
              f"counted run, {prewarm['main']} launches", flush=True)
        _timed("gold", phase_gold, work, coord, imgt)
        extract = _timed("extract", phase_extract, coord)
        scale = _timed("scale", phase_scale, work, coord, imgt, SCALE_READS)
        realign_launches, realign_card = _timed(
            "realign", phase_realign, os.path.join(work, "card", "bulk"),
            coord)
        _timed("prefilter", phase_prefilter, work, coord, imgt)
        ranks = _timed("ranks", phase_ranks, work, coord, imgt, realign_card)
        mode_launches, prewarm["deadline"] = _timed(
            "modes", phase_modes, work, coord, imgt, coord_bam)
        prewarm["ranks"] = ranks["prewarm_launches"]
        _timed("bench", phase_bench, work, coord, imgt)
        fuzz, asan = _timed("fuzz_asan_trace", phase_fuzz_asan_trace, work,
                            coord, imgt, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dirs_launches, dirs_tiers, dirs_others = _timed("dirs", phase_dirs, sass)
    lab = _timed("lab", phase_lab, shapes[1], sass)
    mb_launches, mb_cases = _timed("microbench", phase_microbench, sass)
    print(f"phase walls (s): {json.dumps(WALLS)}; the script so far "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

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
        "mesh_launches": ranks["launches"]["dp_counts"],
        "mode_launches": mode_launches,
        "fuzz_launches": fuzz["launches"],
        "asan_launches": asan["launches"],
        "prewarm_launches": prewarm,
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
        "mesh_launches": ranks["launches"]["dp_scores"],
        "per_thread_ms": bench["per_thread_ms"],
        "shapes": [{k: r.get(k) for k in per_shape + ("t_max", "p_max",
                                                     "cells_per_s")}
                   for r in shapes],
    }]
    # The dirs kernel's and its decoder's top tier (the heaviest launches;
    # every tier and every other shape are in "shapes", each with every
    # instance's times); the lab kernels at the bench shape; the
    # microbenchmark's dependent max+add chain at (32, 128) (every case is
    # in "cases").
    top = dirs_tiers[-1]
    dirs_shape = ("shape", "n", "w", "instance", "chosen_lanes",
                  "fastest_lanes", "ms", "device_ms", "per_thread_device_ms",
                  "plain_ms", "bound_ms", "bound_by", "counts_kernel_ms",
                  "counts_kernel_device_ms")
    kernels.append({
        "name": "dp_dirs",
        "route": "cuda",
        "source": "trust4_tpu_torch/csrc/dp_dirs.cu",
        "replaces": "trust4_tpu/ops/dp_pallas.py:385",
        "launches": dirs_launches["dp_dirs"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in dirs_tiers + dirs_others),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "device_ms": top["device_ms"],
        "instance": top["instance"],
        "lanes": top["chosen_lanes"],
        "instances": top["instances"],
        "decode_ms": top["decode"]["ms"],
        "decode_device_ms": top["decode"]["device_ms"],
        "shapes": [dict({k: r.get(k) for k in dirs_shape},
                        instances={i["lanes"]: i["device_ms"]
                                   for i in r["instances"]})
                   for r in dirs_tiers + dirs_others],
    })
    dec = top["decode"]
    kernels.append({
        "name": "dp_dirs_decode",
        "route": "cuda",
        "source": "trust4_tpu_torch/csrc/dp_decode.cu",
        "replaces": "trust4_tpu/ops/dp_pallas.py:583",
        "launches": dirs_launches["dp_dirs_decode"],
        "max_abs_err": max(r["decode"]["max_abs_err"] for r in dirs_tiers),
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": None,
        "device_ms": dec["device_ms"],
        "tiers": [dict(r["decode"], shape=r["shape"]) for r in dirs_tiers],
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
            "instance": r["instance"],
            "lanes": r["lanes"],
            "wrapper_ms": r["wrapper_ms"],
            "launches_by_lanes": r["launches_by_lanes"],
            "instances": r["instances"],
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
    xf = extract["sparse"]
    kernels.append({
        "name": "extract_filter",
        "route": "cuda",
        "source": "trust4_tpu_torch/csrc/extract_filter.cu",
        "replaces": None,
        "launches": scale["extract_launches"],
        "max_abs_err": max(r["mismatches"] for r in extract.values()),
        "ms": xf["ms"],
        "plain_ms": xf["plain_ms"],
        "bound_ms": xf["bound_ms"],
        "bound_by": xf["bound_by"],
        "library_ms": None,
        "device_ms": xf["device_ms"],
        "host_ms": xf["host_ms"],
        "registers": sass["extract_filter_kernel"].get("registers"),
        "spill_stores": sass["extract_filter_kernel"].get("spill_stores"),
        "phase_launches": sum(r["launches"] for r in extract.values()),
        "mixes": list(extract.values()),
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
