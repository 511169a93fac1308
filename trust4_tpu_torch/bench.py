"""Port bench: end-to-end CDR3 reconstruction wall-clock on the card.

The counterpart of the JAX package's ``bench.py``, function for function,
for the port:

    python -m trust4_tpu_torch.bench                  # on the card
    python -m trust4_tpu_torch.bench --device cpu --reads 2000 --rounds 1 \
        --reps 1 --bc-cells 40 --dp-n 512             # a box without one

Headline (bench.py's): the full CLI wall-clock (``python -m
trust4_tpu_torch run``, the interpreter's boot included) of a 100k-read
bulk corpus (tools/make_bench_corpus.py, seed 20260816) at ``-t 1``, best
of the alternated rounds, in the port's shipping mode (TRUST4_TPU_DEVICE=1,
every gap-fill tier on the card).  Against it, in every round, the same
run with TRUST4_TPU_DEVICE=0 (the native CPU DP) and, where they build,
the reference TRUST4 binaries; the order rotates from round to round, so
no config always runs last on the warmest page cache.  Two rounds at
``-t 1``, two at ``-t N`` (N = os.cpu_count()); best-of, median [min-max]
and per-stage medians (TRUST4_TPU_STAGE_TIMES=1) of each config.

Every timed run of ours is held to the first TRUST4_TPU_DEVICE=0 run of
its part (``Held``): ``_raw.out``, ``_assembled_reads.fa``,
``_final.out``, ``_annot.fa`` and ``_cdr3.out`` byte for byte,
``_report.tsv`` and ``_airr.tsv`` after sorting; a difference raises and
names the file.

Each of our runs prints its ``[boot]`` line (ops/gap_oracle.boot_line):
the thread that loaded torch, that import's seconds and the main
thread's wait at the gap batches' joins.  A TRUST4_TPU_DEVICE=0 run
that loaded torch, or a shipping-mode run whose torch the boot thread
did not load, raises.

The other parts (stderr): the import walls (``import
trust4_tpu_torch.cli`` alone, ``import torch`` alone, and the two
together), candidate extraction reads/s, the barcoded 5,000-cell A/B with
bench.py's wedge rule, the 897k-read / 20,000-cell scale run with its
weather guard, and kernel #3's sustained cell rate with the host-input
and tier-2 counts launches (a subprocess with a time limit).

References: the reference TRUST4 source tree named by ``--reference-dir``
or TRUST4_REF_DIR (as for the repo's tests), when it exists: its
``hg38_bcrtcr.fa`` and ``human_IMGT+C.fa``, and its binaries built once
into ``.refbuild/`` as bench.py builds them.  Otherwise the stand-ins of
``trust4_tpu_torch.testing.write_standin_references`` and no reference
run (``vs_baseline`` 0.0, as in bench.py).

Gates: T4BENCH_SCALE=0 skips the scale run, T4BENCH_BARCODED=0 the
barcoded A/B; each prints that it was skipped.  Unlike bench.py no part
is wrapped in a skip: a part that fails raises and the process exits
non-zero.  ``--device cuda`` (the default) raises without a card; nothing
falls back to the CPU.

Output: every number on stderr; on stdout the card's ``nvidia-smi`` name
and power limit, then, last, bench.py's JSON line
``{"metric", "value", "unit", "vs_baseline"}``.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBUILD = os.path.join(REPO, ".refbuild")

BULK_SEED = 20260816
BC_CELLS, BC_SEED, BC_CLONES = 5000, 777, 800
SCALE_CELLS, SCALE_SEED, SCALE_CLONES = 20000, 424, 2500
READ_FORMAT = "bc:0:15,um:16:25"

# The port's TRUST4_TPU_DEVICE per config.  The JAX bench's "auto" row was
# its shipping default; the port's shipping default is 1 (every tier on
# the card), and its auto is the native CPU DP like 0 (ops/gap_oracle.py),
# so the port's rows are default (1) and off (0).
MODES = {"default": "1", "off": "0"}

# Byte-identical artifacts, and the tables compared after sorting (the
# reference's own gate for the reports).
ARTIFACTS = ("_raw.out", "_assembled_reads.fa", "_final.out", "_annot.fa",
             "_cdr3.out")
SORTED_TABLES = ("_report.tsv", "_airr.tsv")

# bench.py's rules: a default rep slower than WEDGE_FACTOR x the off
# median is rerun once; a scale pair whose default wall is more than
# WEATHER_FACTOR x the off wall is run once more.
WEDGE_FACTOR = 3.0
WEATHER_FACTOR = 1.25

# Every [stage-time] wall, stages and sub-stages (asm/loop, ann/load...).
_STAGE = re.compile(r"\[stage-time\]\s+(\S+): ([0-9.]+)s")

NATIVE_LIBS = ("libt4align.so", "libt4extract.so", "libt4overlap.so",
               "libt4bam.so")


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class OutputMismatch(AssertionError):
    """A timed run's artifact differs from its part's first device-off
    run's."""


def same_outputs(prefix: str, base: str) -> None:
    """Raise OutputMismatch, naming the file, unless ``prefix``'s
    artifacts equal ``base``'s: ARTIFACTS byte for byte, SORTED_TABLES
    after sorting their lines."""
    for suf in ARTIFACTS:
        if not filecmp.cmp(prefix + suf, base + suf, shallow=False):
            raise OutputMismatch(f"{prefix}{suf} differs from {base}{suf}")
    for suf in SORTED_TABLES:
        with open(prefix + suf) as a, open(base + suf) as b:
            if sorted(a) != sorted(b):
                raise OutputMismatch(
                    f"{prefix}{suf} differs from {base}{suf} (sorted)")


class Held:
    """Every timed run of one part held to the part's first device-off
    run; runs made before it are held as soon as it exists."""

    def __init__(self, part: str):
        self.part, self.base, self.pending, self.held = part, None, [], 0

    def add(self, prefix: str, mode: str) -> None:
        if self.base is not None:
            self._hold(prefix)
        elif mode == MODES["off"]:
            self.base = prefix
            for p in self.pending:
                self._hold(p)
            self.pending = []
        else:
            self.pending.append(prefix)

    def _hold(self, prefix: str) -> None:
        same_outputs(prefix, self.base)
        self.held += 1

    def close(self) -> int:
        if self.pending or self.base is None:
            raise AssertionError(f"{self.part}: no device-off run to hold "
                                 "the timed runs against")
        say(f"identity {self.part}: {self.held} of {self.held + 1} timed "
            f"runs held, every one byte-identical to the first "
            f"TRUST4_TPU_DEVICE=0 run")
        return self.held


def rotated(configs: List[str], i: int) -> List[str]:
    k = i % len(configs)
    return configs[k:] + configs[:k]


def rerun_wedged(walls: List[float], off_median: float,
                 rerun: Callable[[int], float]) -> list:
    """bench.py's wedge rule: each default rep slower than WEDGE_FACTOR x
    the device-off median is run once more, and the rerun's wall takes its
    place.  Returns [(rep, slow wall, rerun wall)]."""
    wedged = []
    for rep, w in enumerate(list(walls)):
        if w > WEDGE_FACTOR * off_median:
            walls[rep] = rerun(rep)
            wedged.append((rep, w, walls[rep]))
    return wedged


def spread(v: List[float]) -> str:
    return f"{np.median(v):.3f}s [{min(v):.3f}-{max(v):.3f}]"


class Setup:
    """What every part shares: the device, the references, the reference
    binaries (or ""), the work directory and -t N."""

    def __init__(self, device: str, coord: str, imgt: str, refbin: str,
                 work: str):
        self.device, self.coord, self.imgt = device, coord, imgt
        self.refbin, self.work = refbin, work
        self.nt = os.cpu_count() or 1

    def configs(self) -> List[str]:
        return ["default", "off"] + (["ref"] if self.refbin else [])


def _corpus_tools():
    """The port's copy of tools/make_bench_corpus.py (numpy only)."""
    from trust4_tpu_torch.tools import make_bench_corpus

    return make_bench_corpus


def ensure_corpus(setup: Setup, n_reads: int) -> str:
    """The bulk corpus, made anew from its seed against setup.coord."""
    path = os.path.join(setup.work, "bulk_reads.fq")
    t0 = time.perf_counter()
    _corpus_tools().make_corpus(path, n_reads=n_reads, seed=BULK_SEED,
                                ref_fa=setup.coord)
    say(f"corpus ready: {n_reads} reads in {time.perf_counter() - t0:.1f}s")
    return path


def ensure_reference(ref_src: Optional[str]) -> str:
    """Build the reference binaries once (copy + make), as bench.py does;
    "" when ``ref_src`` is absent (ours then run on the stand-ins) or the
    build fails."""
    if not ref_src or not os.path.isdir(ref_src):
        return ""
    if os.path.exists(os.path.join(REFBUILD, "run-trust4")) and \
            os.path.exists(os.path.join(REFBUILD, "trust4")):
        return REFBUILD
    if not os.path.isdir(REFBUILD):
        shutil.copytree(ref_src, REFBUILD)
        subprocess.run(["chmod", "-R", "u+w", REFBUILD], check=False)
    r = subprocess.run(["make", "-j8"], cwd=REFBUILD, capture_output=True)
    return REFBUILD if r.returncode == 0 else ""


def prebuild(device: str) -> None:
    """Build, untimed, what the timed runs load: the native libraries and,
    on the card, the counts kernel (the run's) and the scores kernel (the
    DP part's), so no nvcc lands in a timed rep."""
    from concurrent.futures import ThreadPoolExecutor

    from trust4_tpu_torch.ops.build import build_all, load
    from trust4_tpu_torch.utils.nativebuild import ensure_built

    t0 = time.perf_counter()
    kernels = ("dp_counts", "dp_scores") if device == "cuda" else ()
    with ThreadPoolExecutor(1) as pool:  # nvcc beside the native g++
        nvcc = pool.submit(build_all, list(kernels))
        for lib in NATIVE_LIBS:
            ensure_built(lib)
        nvcc.result()
    for name in kernels:
        load(name)
    say(f"build: native libraries and kernels ready in "
        f"{time.perf_counter() - t0:.1f}s (untimed)")


# The import walls, apart from a run's: the CLI alone (torch-free: the
# CPU modes' whole start-up), torch alone (what the boot thread imports),
# and the two together (what every run paid before the boot thread).
IMPORTS = {"cli": "import trust4_tpu_torch.cli", "torch": "import torch",
           "both": "import trust4_tpu_torch.cli, torch"}


def import_walls(n: int = 3) -> Dict[str, List[float]]:
    """Each of IMPORTS as ``python -c``, n times, the three interleaved."""
    walls: Dict[str, List[float]] = {k: [] for k in IMPORTS}
    for _ in range(n):
        for k, code in IMPORTS.items():
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", code], check=True,
                           cwd=REPO, timeout=300)
            walls[k].append(time.perf_counter() - t0)
    for k, code in IMPORTS.items():
        say(f"import wall {k} (python -c '{code}', {n} runs): "
            f"{spread(walls[k])}")
    return walls


# The run's [boot] line (ops/gap_oracle.boot_line).
_BOOT = re.compile(r"\[boot\] torch_loaded_by=(\S+) import_s=([0-9.]+) "
                   r"ready_wait_s=([0-9.]+)")
BOOT_THREAD = "trust4-gap-prewarm-"


def device_boot(text: str, mode: Optional[str]) -> dict:
    """The run's boot line as a record, held to its mode: with
    TRUST4_TPU_DEVICE=0 torch was never loaded; in the shipping mode the
    boot thread loaded it (mode None: not held)."""
    m = _BOOT.search(text)
    if m is None:
        raise RuntimeError("the run printed no [boot] line")
    rec = {"loaded_by": m.group(1), "import_s": float(m.group(2)),
           "ready_wait_s": float(m.group(3))}
    if mode == MODES["off"] and rec["loaded_by"] != "none":
        raise RuntimeError(f"a TRUST4_TPU_DEVICE=0 run loaded torch: {m[0]}")
    if mode == MODES["default"] and \
            not rec["loaded_by"].startswith(BOOT_THREAD):
        raise RuntimeError(f"torch was not loaded by the boot thread: {m[0]}")
    return rec


def _stages(text: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for m in _STAGE.finditer(text):
        out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(2))
    return out


def run_ours(setup: Setup, mode: str, threads: int, prefix: str,
             reads: str, barcode: Optional[str] = None,
             timeout: int = 1800) -> dict:
    """The full CLI wall-clock, the surface a user invokes (the
    interpreter's boot included, as in bench.py), with TRUST4_TPU_DEVICE
    = ``mode``; its [stage-time] walls, ``boot`` (the wall the stages
    do not cover) and ``device_boot`` (its [boot] line, held to the
    mode)."""
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    cmd = [sys.executable, "-m", "trust4_tpu_torch", "run", "-u", reads,
           "-f", setup.coord, "--ref", setup.imgt,
           "-o", os.path.basename(prefix), "--od", os.path.dirname(prefix),
           "-t", str(threads), "--device", setup.device]
    if barcode:
        cmd += ["--barcode", barcode, "--readFormat", READ_FORMAT]
    env = dict(os.environ, TRUST4_TPU_DEVICE=mode, TRUST4_TPU_STAGE_TIMES="1")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       cwd=REPO, env=env)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"our run (TRUST4_TPU_DEVICE={mode}) exited "
                           f"{r.returncode}: {r.stderr[-2000:]}")
    stages = _stages(r.stderr)
    stages["boot"] = wall - sum(v for k, v in stages.items() if "/" not in k)
    boot = device_boot(r.stderr, mode)
    say(f"run {os.path.relpath(prefix, setup.work)} TRUST4_TPU_DEVICE={mode}"
        f" -t{threads}: {wall:.3f}s; " + _BOOT.search(r.stderr)[0])
    return {"wall_s": wall, "stages_s": stages, "prefix": prefix,
            "device_boot": boot}


def run_reference(setup: Setup, threads: int, prefix: str, reads: str,
                  barcode: Optional[str] = None, timeout: int = 1800) -> dict:
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    cmd = ["perl", os.path.join(setup.refbin, "run-trust4"), "-u", reads,
           "-f", os.path.join(setup.refbin, "hg38_bcrtcr.fa"),
           "--ref", os.path.join(setup.refbin, "human_IMGT+C.fa"),
           "-o", prefix, "-t", str(threads)]
    if barcode:
        cmd += ["--barcode", barcode, "--readFormat", READ_FORMAT]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"reference run exited {r.returncode}")
    return {"wall_s": wall, "prefix": prefix}


def run_config(setup: Setup, cfg: str, threads: int, prefix: str,
               reads: str, held: Held, barcode: Optional[str] = None,
               timeout: int = 1800) -> dict:
    """One timed run of ``cfg``; ours are held (``held``)."""
    if cfg == "ref":
        return run_reference(setup, threads, prefix, reads, barcode, timeout)
    r = run_ours(setup, MODES[cfg], threads, prefix, reads, barcode, timeout)
    held.add(prefix, MODES[cfg])
    return r


def _stage_medians(runs: List[dict]) -> Dict[str, float]:
    names = set.intersection(*(set(r["stages_s"]) for r in runs))
    return {k: float(np.median([r["stages_s"][k] for r in runs]))
            for k in sorted(names)}


def bench_bulk(setup: Setup, corpus: str, rounds: int) -> dict:
    """Alternated rounds at -t 1, then at -t N, each running every config
    in an order rotated from round to round."""
    held = Held("bulk")
    rec: Dict[str, dict] = {}
    i = 0
    for threads in (1, setup.nt):
        runs: Dict[str, list] = {c: [] for c in setup.configs()}
        for _ in range(rounds):
            for cfg in rotated(setup.configs(), i):
                prefix = os.path.join(setup.work, "bulk", f"{cfg}_t{threads}"
                                      f"_{len(runs[cfg])}", "b")
                runs[cfg].append(run_config(setup, cfg, threads, prefix,
                                            corpus, held))
            i += 1
        walls = {c: [r["wall_s"] for r in v] for c, v in runs.items()}
        best = {c: min(v) for c, v in walls.items()}
        med = {c: float(np.median(v)) for c, v in walls.items()}
        rows = "; ".join(f"{c} best {best[c]:.3f}s, median {spread(v)}"
                         for c, v in walls.items())
        say(f"bulk -t{threads} ({rounds} alternated rounds): {rows}")
        say(f"bulk -t{threads} default/off: {best['default'] / best['off']:.3f}x"
            f" best-of, {med['default'] / med['off']:.3f}x median"
            + (f"; ref/default {best['ref'] / best['default']:.3f}x best-of"
               if "ref" in best else ""))
        stages = {c: _stage_medians(runs[c]) for c in MODES}
        for c in MODES:  # the record keeps the sub-stages too
            say(f"bulk -t{threads} {c} stage medians: " + json.dumps(
                {k: round(v, 3) for k, v in stages[c].items()
                 if "/" not in k}))
        boots = {c: [r["device_boot"] for r in runs[c]] for c in MODES}
        say(f"bulk -t{threads} default boot: torch's import on the boot "
            "thread " + spread([b["import_s"] for b in boots["default"]])
            + ", the main thread's wait at the joins " + spread(
                [b["ready_wait_s"] for b in boots["default"]])
            + "; off: torch never loaded")
        rec[f"t{threads}"] = {"walls_s": walls, "best_s": best,
                              "median_s": med, "stage_medians_s": stages,
                              "device_boot": boots}
    rec["held"] = held.close()
    return rec


def bench_extraction_reads_per_sec(setup: Setup, corpus: str) -> float:
    """Candidate reads/s through the port's shipping extraction path (the
    native loop), best of 3."""
    from trust4_tpu_torch.pipeline.extract import run_extractor

    with open(corpus) as f:
        n_reads = sum(1 for _ in f) // 4
    d = os.path.join(setup.work, "extract")
    os.makedirs(d, exist_ok=True)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_extractor(setup.coord, [corpus], None,
                      out_prefix=os.path.join(d, "x_toassemble"),
                      threads=setup.nt, device=setup.device)
        best = min(best, time.perf_counter() - t0)
    rps = n_reads / best
    say(f"extraction (the port's native path, -t{setup.nt}, best of 3): "
        f"{rps:,.0f} reads/s ({n_reads} reads in {best:.3f}s)")
    return rps


def _barcoded_corpus(setup: Setup, tag: str, cells: int, seed: int,
                     clones: int):
    reads = os.path.join(setup.work, f"{tag}_reads.fq")
    bc = os.path.join(setup.work, f"{tag}_bc.fq")
    t0 = time.perf_counter()
    n = _corpus_tools().make_barcoded_corpus(
        reads, bc, n_cells=cells, seed=seed, n_clones=clones,
        ref_fa=setup.coord)
    say(f"{tag} corpus: {cells} cells, {n} reads in "
        f"{time.perf_counter() - t0:.1f}s")
    return reads, bc, n


def bench_barcoded(setup: Setup, cells: int, reps: int) -> dict:
    """Single-cell e2e A/B (5,000 cells, seed 777, 800 clones): reps
    rounds of every config at -t N, the order rotated each round; median
    [spread] and best-of per config; bench.py's wedge rule on the default
    rows."""
    reads, bc, n = _barcoded_corpus(setup, "bc", cells, BC_SEED, BC_CLONES)
    held = Held("barcoded")
    walls: Dict[str, List[float]] = {c: [] for c in setup.configs()}

    def one(cfg: str, tag: str) -> float:
        prefix = os.path.join(setup.work, "bc", tag, "bc")
        return run_config(setup, cfg, setup.nt, prefix, reads, held,
                          barcode=bc)["wall_s"]

    for rep in range(reps):
        for cfg in rotated(setup.configs(), rep):
            walls[cfg].append(one(cfg, f"{cfg}{rep}"))
    off_med = float(np.median(walls["off"]))
    wedged = rerun_wedged(walls["default"], off_med,
                          lambda rep: one("default", f"wedge{rep}"))
    med = {c: float(np.median(v)) for c, v in walls.items()}
    best = {c: min(v) for c, v in walls.items()}
    say(f"barcoded single-cell e2e -t{setup.nt} ({cells} cells, {n} reads, "
        f"{reps} reps, median [spread]): " + "; ".join(
            f"{c} {spread(v)}" for c, v in walls.items())
        + f"; default/off {med['default'] / med['off']:.3f}x")
    say("barcoded best-of: " + "; ".join(f"{c} {best[c]:.3f}s"
                                         for c in walls)
        + f"; default/off {best['default'] / best['off']:.3f}x"
        + (f"; ref/default {best['ref'] / best['default']:.3f}x"
           if "ref" in best else ""))
    for rep, slow, again in wedged:
        say(f"barcoded WEDGE: default rep {rep} took {slow:.1f}s (>"
            f"{WEDGE_FACTOR:g}x the off median {off_med:.1f}s); rerun "
            f"recorded {again:.3f}s")
    return {"cells": cells, "reads": n, "walls_s": walls, "median_s": med,
            "best_s": best, "wedged": wedged, "held": held.close()}


def bench_barcoded_scale(setup: Setup) -> dict:
    """The 897k-read / 20,000-cell single-cell A/B: one alternated pair of
    default and off (and the reference where present), run once more in
    the other order when the default wall is more than WEATHER_FACTOR x
    the off wall; best of pair per config."""
    reads, bc, n = _barcoded_corpus(setup, "scale", SCALE_CELLS, SCALE_SEED,
                                    SCALE_CLONES)
    held = Held("scale")
    walls: Dict[str, List[float]] = {c: [] for c in setup.configs()}

    def pair(i: int) -> None:
        for cfg in rotated(setup.configs(), i):
            prefix = os.path.join(setup.work, "scale", f"{cfg}{i}", "sc")
            walls[cfg].append(run_config(setup, cfg, setup.nt, prefix, reads,
                                         held, barcode=bc,
                                         timeout=3600)["wall_s"])

    pair(0)
    if walls["default"][0] > WEATHER_FACTOR * walls["off"][0]:
        pair(1)
    best = {c: min(v) for c, v in walls.items()}
    say(f"{n} reads/{SCALE_CELLS}-cell single-cell e2e -t{setup.nt} (best of"
        f" {len(walls['off'])} alternated pair(s)): " + "; ".join(
            f"{c} {best[c]:.3f}s {[round(w, 3) for w in v]}"
            for c, v in walls.items())
        + f"; default/off {best['default'] / best['off']:.3f}x")
    return {"reads": n, "walls_s": walls, "best_s": best,
            "held": held.close()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_child(device: str, n: int) -> None:
    """The device DP part (run in its own process by bench_dp_device):
    kernel #3 (ops/dp_scores.py) at bench.py's shape, n pairs of width 152,
    W=32, t_len 150, p_len 148, codes from default_rng(0); prints CELLS
    (device-resident inputs, best of 5 rounds of 10 launches, each round
    ended by a synchronize), HOSTIN (numpy inputs, copies included) and
    TIER2 (a tier-2 counts chunk from numpy through the oracle's launch
    path) on stdout.  Each result is held against the plain version on a
    sample."""
    from trust4_tpu_torch.ops.dp import (banded_affine_counts_plain,
                                         banded_affine_scores_plain)
    from trust4_tpu_torch.ops.dp_counts import (banded_affine_counts,
                                                to_device_jobs)
    from trust4_tpu_torch.ops.dp_scores import banded_affine_scores

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    width, w = 152, 32
    tc = rng.integers(0, 4, size=(n, width), dtype=np.int8)
    tl = np.full(n, 150, dtype=np.int32)
    pl = np.full(n, 148, dtype=np.int32)
    args = to_device_jobs(tc, tl, tc, pl, dev)
    k = min(n, 256)
    got = banded_affine_scores(*args, w)[:k].cpu()
    want = banded_affine_scores_plain(*(torch.from_numpy(a[:k]) for a in
                                        (tc, tl, tc, pl)), w)
    if not torch.equal(got, want):
        raise AssertionError("dp_scores differs from its plain version")
    cells = n * 150 * w
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(10):
            banded_affine_scores(*args, w)
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / 10)
    bh = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        banded_affine_scores(*to_device_jobs(tc, tl, tc, pl, dev), w).cpu()
        bh = min(bh, time.perf_counter() - t0)
    print(f"HOSTIN {bh * 1e3:.3f} ms/launch ({cells / bh / 1e9:.2f} G "
          "cells/s incl transfers)", flush=True)

    s_cap, w_cap, chunk = 144, 48, min(16384, n)
    tc2 = rng.integers(0, 4, (chunk, s_cap), dtype=np.int8)
    tl2 = np.full(chunk, s_cap, np.int32)
    cnt = banded_affine_counts(*to_device_jobs(tc2, tl2, tc2, tl2, dev),
                               w_cap)[1][:k].cpu()
    _, want = banded_affine_counts_plain(*(torch.from_numpy(a[:k]) for a in
                                           (tc2, tl2, tc2, tl2)), w_cap)
    if not torch.equal(cnt, want):
        raise AssertionError("dp_counts differs from its plain version")
    bf = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        banded_affine_counts(*to_device_jobs(tc2, tl2, tc2, tl2, dev),
                             w_cap)[1].cpu().numpy()
        bf = min(bf, time.perf_counter() - t0)
    c2 = chunk * s_cap * w_cap
    print(f"TIER2 {bf * 1e3:.3f} ms/launch ({c2 / bf / 1e9:.2f} G cells/s "
          f"incl both copies and the job order; {chunk} jobs at (144, 48))",
          flush=True)
    print("CELLS", cells / best, best * 1e3, flush=True)


def bench_dp_device(setup: Setup, n: int) -> dict:
    """dp_child in a subprocess with a time limit, as bench.py runs its
    device DP."""
    out = subprocess.run(
        [sys.executable, "-m", "trust4_tpu_torch.bench", "--dp-child",
         "--device", setup.device, "--dp-n", str(n)],
        capture_output=True, text=True, timeout=900, cwd=REPO)
    if out.returncode != 0:
        raise RuntimeError(f"device DP part exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    rec = {}
    for line in out.stdout.splitlines():
        if line.startswith("HOSTIN"):
            rec["hostin"] = line[7:]
            say(f"device DP #3, one launch from numpy ({n} pairs): "
                f"{line[7:]}")
        elif line.startswith("TIER2"):
            rec["tier2"] = line[6:]
            say(f"device DP #1 tier-2 launch from numpy through the "
                f"oracle's path: {line[6:]} (the port has no fused 4-bit "
                "launch: the JAX package's FUSED line has no counterpart)")
        elif line.startswith("CELLS"):
            rec["cells_per_s"] = float(line.split()[1])
            rec["ms"] = float(line.split()[2])
    if "cells_per_s" not in rec:
        raise RuntimeError(f"device DP part printed no CELLS: {out.stdout}")
    say(f"device banded DP #3 on {setup.device} (sustained, device-resident,"
        f" {n} pairs, best of 5 rounds of 10): {rec['cells_per_s'] / 1e9:.2f}"
        f" G cells/s ({rec['ms']:.4f} ms a launch)")
    return rec


def device_line(device: str) -> str:
    if device == "cpu":
        return f"cpu: {os.cpu_count()} cores"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _gate(name: str) -> bool:
    return os.environ.get(name, "1") != "0"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m trust4_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--reads", type=int, default=100_000,
                   help="bulk corpus reads (default 100000)")
    p.add_argument("--rounds", type=int, default=2,
                   help="alternated bulk rounds per thread count (default 2)")
    p.add_argument("--reps", type=int, default=3,
                   help="alternated barcoded reps (default 3)")
    p.add_argument("--bc-cells", type=int, default=BC_CELLS,
                   help=f"barcoded A/B cells (default {BC_CELLS})")
    p.add_argument("--dp-n", type=int, default=65536,
                   help="pairs of the device DP part (default 65536)")
    p.add_argument("--reference-dir",
                   default=os.environ.get("TRUST4_REF_DIR"),
                   help="reference TRUST4 source tree (default "
                   "$TRUST4_REF_DIR; absent: the stand-ins, no reference "
                   "run)")
    p.add_argument("--work", default=None,
                   help="work directory (default a temporary one, removed)")
    p.add_argument("--record", default=None,
                   help="also write every number as JSON to this file")
    p.add_argument("--dp-child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to bench the plain "
                           "PyTorch DP")
    if args.dp_child:
        dp_child(args.device, args.dp_n)
        return {}

    work = args.work or tempfile.mkdtemp(prefix="t4bench_")
    os.makedirs(work, exist_ok=True)
    try:
        return _bench(args, work)
    finally:
        if args.work is None:
            shutil.rmtree(work, ignore_errors=True)


def _bench(args, work: str) -> dict:
    ref_src = args.reference_dir
    full = bool(ref_src) and os.path.isdir(ref_src)
    if full:
        coord = os.path.join(ref_src, "hg38_bcrtcr.fa")
        imgt = os.path.join(ref_src, "human_IMGT+C.fa")
        say(f"references: {ref_src} (hg38_bcrtcr.fa, human_IMGT+C.fa)")
    else:
        from trust4_tpu_torch.testing import write_standin_references

        coord, imgt = write_standin_references(os.path.join(work, "ref"))
        say("references: the stand-ins (trust4_tpu_torch.testing); these "
            "numbers are not comparable with runs on the full references")
    refbin = ensure_reference(ref_src)
    say(f"reference binaries: {refbin or 'unavailable'}")
    setup = Setup(args.device, coord, imgt, refbin, work)
    say(f"device: {args.device}; -t N = {setup.nt}")
    prebuild(args.device)
    corpus = ensure_corpus(setup, args.reads)
    rec = {"device": args.device, "reads": args.reads,
           "references": "full" if full else "stand-ins",
           "import_wall_s": import_walls()}
    rec["bulk"] = bench_bulk(setup, corpus, args.rounds)
    rec["extract_reads_per_s"] = bench_extraction_reads_per_sec(setup, corpus)
    if _gate("T4BENCH_BARCODED"):
        rec["barcoded"] = bench_barcoded(setup, args.bc_cells, args.reps)
    else:
        say("barcoded A/B skipped: T4BENCH_BARCODED=0")
    if _gate("T4BENCH_SCALE"):
        rec["scale"] = bench_barcoded_scale(setup)
    else:
        say("897k scale run skipped: T4BENCH_SCALE=0")
    rec["dp"] = bench_dp_device(setup, args.dp_n)

    t1 = rec["bulk"]["t1"]["best_s"]
    ours = t1["default"]
    vs = round(t1["ref"] / ours, 2) if "ref" in t1 else 0.0
    rec["device_line"] = device_line(args.device)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(rec, f, indent=1)
    print(rec["device_line"], flush=True)
    print(json.dumps({
        "metric": "e2e_cdr3_wallclock_100k_bulk",
        "value": round(ours, 2),
        "unit": "s (lower is better; vs_baseline = ref/ours)",
        "vs_baseline": vs,
    }), flush=True)
    return rec


if __name__ == "__main__":
    main()
