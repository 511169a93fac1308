"""AddressSanitizer run over the port's native libraries on the path the
card ships.  The port of tools/asan_check.sh.

Usage::

    python -m trust4_tpu_torch.tools.asan_check [LO HI] [--device cuda|cpu]
        [--threads N] [--bam-pairs N] [--asan-dir DIR]
        [--max-clones N] [--max-depth N]

The parent builds the four native libraries from the port's ``native/``
sources with -fsanitize=address (``CXXFLAGS``, tools/asan_check.sh's
flags) into ``native/asan/`` (or ``--asan-dir``), by ``make`` on a copy
of the sources there, under that directory's build lock; the fast
libraries are never touched.  On ``--device cuda`` it first builds the
counts kernel (ops/build.py), so that no nvcc runs under the sanitizer.
It then runs this module again as a child with libasan preloaded
(``LD_PRELOAD``), TRUST4_TPU_NATIVE_DIR naming the ASan directory and
``ASAN_OPTIONS`` (``ASAN_OPTIONS``, plus ``CUDA_ASAN_OPTIONS`` on the
card), and exits with the child's code (128 + the signal when one ended
it: abort_on_error=1 makes any report a SIGABRT).  No option makes a
report non-fatal.

The child first proves what it loaded: the four libraries through the
port's own loaders, each mapped (``/proc/self/maps``) from the ASan
directory and nowhere else, ``__asan_init`` resolving in each, and
libasan mapped.  Then, each part in the shipping mode
(TRUST4_TPU_DEVICE=1: the collect-oracle path, ``t4o_*collect_gaps``,
``t4o_emit_gap_codes``, ``t4o_dedup_gap_jobs``, ``t4o_gap_counts_cpu``
and the ``*_batch_oracle`` entry points) on ``--device`` against
TRUST4_TPU_DEVICE=0, every file byte-identical (report tables sorted,
``fuzz_differential.compare_dirs``):

  gold     the gold reads at ``--stage 1`` on the stand-in references;
           every tests/data/gold_* artifact reproduced (in place of the
           script's example, which needs the reference's tree)
  bulk     ``fuzz_differential.wave`` over bulk seeds [LO, HI)
  barcoded the same over barcoded seeds [LO, HI)
  bam      a stand-in BAM of ``--bam-pairs`` pairs
           (``testing.write_standin_bam``) through ``run -b``
  t8       bulk seed LO at ``-t 8`` (the collect's row order depends on
           the threads)

Output: the loaded libraries' line, one line a part (its wall, the gap
fills, ``miss``: the jobs beyond the top tier, the launches of #1), then
``asan check passed``.  A part that differs prints its mismatches and
the child exits 1; an ASan report aborts it.  ``--max-clones`` and
``--max-depth`` cap the fuzz corpora (as tests/test_torch_fuzz.py does)
for a quick run.  ``--device cuda`` (the default) raises at once
without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

from trust4_tpu_torch.utils.nativebuild import NATIVE_DIR, NATIVE_DIR_ENV

ASAN_DIR = os.path.join(NATIVE_DIR, "asan")
CXXFLAGS = ("-O1 -g -fsanitize=address -march=x86-64-v3 -fPIC -shared "
            "-std=c++17")
SOURCES = ("Makefile", "align_kernels.cpp", "annotate2.inc", "bam_scan.cpp",
           "extract_filter.cpp", "overlap_engine.cpp")
# The compiler of the ASan build and of the preloaded runtime, as the
# script names it; not $CXX, which may name a compiler that ships no
# libasan (the fast build takes $CXX).
CXX = "g++"
LIBS = ("libt4align.so", "libt4extract.so", "libt4overlap.so", "libt4bam.so")
# tools/asan_check.sh's: CPython is not instrumented, so leak checking is
# off (it keeps memory to exit by design), and so are ODR checks over
# ctypes loads.
ASAN_OPTIONS = "detect_leaks=0:abort_on_error=1:detect_odr_violation=0"
# Added on the card: without it torch's CUDA initialisation aborts with an
# ASan report (H100, torch 2.11.0+cu128); it lets CUDA map memory in the
# range ASan otherwise keeps unmapped, and keeps reports fatal.
CUDA_ASAN_OPTIONS = "protect_shadow_gap=0"
# Variables that would take the child off the path under test.
_CLEARED = ("TRUST4_TPU_NATIVE", "TRUST4_TPU_DEVICE",
            "TRUST4_TPU_DEVICE_CHECK", "TRUST4_TPU_GAP_MESH",
            "TRUST4_TPU_GAP_TEST", "TRUST4_TPU_DEBUG")
REPO = os.path.dirname(os.path.dirname(NATIVE_DIR))
DATA_DIR = os.path.join(REPO, "tests", "data")
GOLD_ARTIFACTS = ("_raw.out", "_assembled_reads.fa", "_final.out",
                  "_annot.fa", "_cdr3.out")
BAM_SEED = 20261017


def libasan() -> str:
    """``CXX``'s libasan.so; raises when it names no file."""
    out = subprocess.run([CXX, "-print-file-name=libasan.so"],
                         check=True, capture_output=True, text=True
                         ).stdout.strip()
    if not os.path.isabs(out) or not os.path.exists(out):
        raise RuntimeError(f"{CXX} -print-file-name=libasan.so gave "
                           f"{out!r}: no AddressSanitizer runtime")
    return os.path.realpath(out)


def build_asan(asan_dir: str = ASAN_DIR, jobs: int = 4) -> float:
    """Bring the ASan libraries in ``asan_dir`` up to date: the sources and
    the Makefile copied there (a file only when its bytes changed, so
    ``make`` rebuilds only what changed) and ``make all`` with ``CXX``
    and ``CXXFLAGS``, under the directory's build lock (the one
    utils/nativebuild.ensure_built takes).  Returns the seconds taken."""
    import fcntl

    t0 = time.perf_counter()
    os.makedirs(asan_dir, exist_ok=True)
    with open(os.path.join(asan_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for name in SOURCES:
            src, dst = (os.path.join(NATIVE_DIR, name),
                        os.path.join(asan_dir, name))
            with open(src, "rb") as f:
                data = f.read()
            if os.path.exists(dst):
                with open(dst, "rb") as f:
                    if f.read() == data:
                        continue
            shutil.copyfile(src, dst)
        r = subprocess.run(["make", "-C", asan_dir, f"-j{jobs}",
                            f"CXX={CXX}", f"CXXFLAGS={CXXFLAGS}", "all"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"ASan build in {asan_dir} failed:\n"
                               f"{r.stdout[-4000:]}{r.stderr[-4000:]}")
    return time.perf_counter() - t0


def child_env(asan_dir: str, device: str) -> Dict[str, str]:
    """The child's environment: libasan preloaded, the ASan directory as
    TRUST4_TPU_NATIVE_DIR, ``ASAN_OPTIONS`` (with ``CUDA_ASAN_OPTIONS`` on
    the card) in place of any the caller set, and ``_CLEARED`` unset."""
    env = {k: v for k, v in os.environ.items() if k not in _CLEARED}
    env["LD_PRELOAD"] = " ".join(
        [libasan()] + ([env["LD_PRELOAD"]] if env.get("LD_PRELOAD") else []))
    env[NATIVE_DIR_ENV] = os.path.abspath(asan_dir)
    env["ASAN_OPTIONS"] = ASAN_OPTIONS + (
        ":" + CUDA_ASAN_OPTIONS if device == "cuda" else "")
    return env


def mapped_libraries() -> Dict[str, List[str]]:
    """basename -> the distinct paths it is mapped from in this process,
    for every ``lib*.so*`` in /proc/self/maps."""
    out: Dict[str, List[str]] = {}
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split(None, 5)
            if len(parts) < 6 or not parts[5].startswith("/"):
                continue
            path = parts[5].strip()
            base = os.path.basename(path)
            if base.startswith("lib") and ".so" in base:
                paths = out.setdefault(base, [])
                if path not in paths:
                    paths.append(path)
    return out


def prove_loaded(asan_dir: str) -> str:
    """Load the four libraries through the port's loaders and check that
    each is mapped from ``asan_dir`` only, that ``__asan_init`` resolves
    in each (it does only through an instrumented library's own link to
    libasan) and that libasan is mapped.  Returns the line to print;
    raises on any failure."""
    from trust4_tpu_torch.align import native as align_native
    from trust4_tpu_torch.engine import overlap_native
    from trust4_tpu_torch.io import bam_native
    from trust4_tpu_torch.pipeline import extract_native

    want = os.path.realpath(asan_dir)
    handles = {"libt4align.so": align_native._load(),
               "libt4overlap.so": overlap_native._load(),
               "libt4extract.so": extract_native._load(),
               "libt4bam.so": bam_native._load()}
    missing = sorted(k for k, v in handles.items() if v is None)
    if missing:
        raise RuntimeError(f"the port's loaders did not load {missing}")
    maps = mapped_libraries()
    if not any(k.startswith("libasan.so") for k in maps):
        raise RuntimeError("libasan is not mapped: the child runs without "
                           "the sanitizer")
    for name in LIBS:
        paths = [os.path.realpath(p) for p in maps.get(name, [])]
        if not paths:
            raise RuntimeError(f"{name} is not mapped")
        stray = [p for p in paths if os.path.dirname(p) != want]
        if stray:
            raise RuntimeError(f"{name} mapped from outside {want}: {stray}")
        if not hasattr(ctypes.CDLL(paths[0]), "__asan_init"):
            raise RuntimeError(f"{paths[0]} is not built with ASan "
                               "(__asan_init does not resolve in it)")
    return (f"asan libraries: {len(LIBS)} loaded from {want}, "
            f"__asan_init resolves in each; "
            f"{[k for k in maps if k.startswith('libasan')][0]} preloaded")


def _part_line(part: str, recs: List[Dict], wall: float) -> str:
    bad = [r for r in recs if r["mismatches"]]
    status = ("OK" if not bad else
              "; ".join(f"{r.get('seed', part)}: {r['mismatches']}"
                        for r in bad))
    return (f"asan {part}: corpora={len(recs)} wall={wall:.1f}s "
            f"fills={sum(r.get('fills', 0) for r in recs)} "
            f"miss={sum(r.get('miss', 0) for r in recs)} "
            f"launches={sum(r.get('launches', 0) for r in recs)}: {status}")


def _gold(work: str, refs, device: str, threads: int) -> Dict:
    """The gold reads at ``--stage 1``, the shipping mode against
    TRUST4_TPU_DEVICE=0; the shipping run also held to every
    tests/data/gold_* artifact (the report sorted)."""
    from trust4_tpu_torch.tools import fuzz_differential as fz

    r1, r2 = (os.path.join(DATA_DIR, f"gold_toassemble_{m}.fq")
              for m in (1, 2))
    args = ["-f", refs[0], "--ref", refs[1], "-t", str(threads), "-1", r1,
            "-2", r2, "--stage", "1"]
    rec = fz.run_both(args, os.path.join(work, "gold"), device,
                      inputs=((r1, "_toassemble_1.fq"),
                              (r2, "_toassemble_2.fq")))
    if not rec["mismatches"]:
        dev = os.path.join(rec["dirs"]["dev"], fz.PREFIX)
        for suf in GOLD_ARTIFACTS + ("_report.tsv",):
            with open(dev + suf, "rb") as a, open(
                    os.path.join(DATA_DIR, "gold" + suf), "rb") as b:
                mine, gold = a.read(), b.read()
            if suf.endswith(fz.SORTED):
                mine, gold = sorted(mine.splitlines()), sorted(
                    gold.splitlines())
            if mine != gold:
                rec["mismatches"].append(f"{suf} differs from the golden")
    return rec


def _bam(work: str, coord_bam: str, imgt: str, device: str, threads: int,
         n_pairs: int) -> Dict:
    from trust4_tpu_torch import testing
    from trust4_tpu_torch.tools import fuzz_differential as fz

    d = os.path.join(work, "bam")
    os.makedirs(d)
    bam = os.path.join(d, "standin.bam")
    testing.write_standin_bam(bam, coord_bam, n_pairs, seed=BAM_SEED)
    return fz.run_both(["-f", coord_bam, "--ref", imgt, "-t", str(threads),
                        "-b", bam], d, device)


def child_main(a) -> int:
    """The checks under the sanitizer (``a``: the parsed arguments)."""
    # The preload is in effect for this process; a program this one
    # starts (make, a compiler) runs without it.
    os.environ.pop("LD_PRELOAD", None)
    print(prove_loaded(a.asan_dir), flush=True)

    from trust4_tpu_torch import testing
    from trust4_tpu_torch.ops import build, gap_oracle
    from trust4_tpu_torch.tools import fuzz_differential as fz

    gap_oracle.wait_ready(a.device)
    caps = {"max_clones": a.max_clones, "max_depth": a.max_depth}
    work = tempfile.mkdtemp(prefix="t4asan_")
    logs = io.StringIO()  # the runs' stderr, shown when a part fails
    failed = []
    try:
        refs = testing.write_standin_references(os.path.join(work, "ref"))
        coord_bam = testing.write_standin_references(
            os.path.join(work, "ref"), coordinates=True)[0]
        seeds = range(a.lo, a.hi)
        parts = (
            ("gold", lambda: [_gold(work, refs, a.device, a.threads)]),
            ("bulk", lambda: fz.wave(seeds, "bulk", work, refs, a.device,
                                     a.threads, **caps)),
            ("barcoded", lambda: fz.wave(seeds, "barcoded", work, refs,
                                         a.device, a.threads, **caps)),
            ("bam", lambda: [_bam(work, coord_bam, refs[1], a.device,
                                  a.threads, a.bam_pairs)]),
            ("t8", lambda: fz.wave([a.lo], "bulk",
                                   os.path.join(work, "t8"), refs,
                                   a.device, 8, **caps)),
        )
        for part, run in parts:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(logs), \
                    contextlib.redirect_stderr(logs):
                recs = run()
            line = _part_line(part, recs, time.perf_counter() - t0)
            print(line, flush=True)
            if any(r["mismatches"] for r in recs):
                failed.append(part)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if build.BUILD_SECONDS:
        failed.append(f"nvcc ran under the sanitizer: {build.BUILD_SECONDS}")
    if failed:
        print(logs.getvalue()[-20000:], file=sys.stderr, flush=True)
        print(f"asan check FAILED: {failed}", flush=True)
        return 1
    print("asan check passed", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lo", type=int, nargs="?", default=7000)
    ap.add_argument("hi", type=int, nargs="?", default=7006)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--bam-pairs", type=int, default=20000)
    ap.add_argument("--asan-dir", default=ASAN_DIR)
    ap.add_argument("--max-clones", type=int, default=None)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    a.asan_dir = os.path.abspath(a.asan_dir)
    if a.child:
        return child_main(a)

    if a.device == "cuda":
        from trust4_tpu_torch.ops import build, gap_oracle

        gap_oracle._resolve("cuda")  # raises at once without a card
        build.build_all(["dp_counts"])
    t_build = build_asan(a.asan_dir)
    env = child_env(a.asan_dir, a.device)
    print(f"asan build: {t_build:.1f}s into {a.asan_dir}; ASAN_OPTIONS="
          f"{env['ASAN_OPTIONS']}; LD_PRELOAD={env['LD_PRELOAD']}",
          flush=True)
    argv = [str(a.lo), str(a.hi), "--device", a.device, "--threads",
            str(a.threads), "--bam-pairs", str(a.bam_pairs), "--asan-dir",
            a.asan_dir, "--child"]
    for flag, v in (("--max-clones", a.max_clones),
                    ("--max-depth", a.max_depth)):
        if v is not None:
            argv += [flag, str(v)]
    rc = subprocess.run(
        [sys.executable, "-m", "trust4_tpu_torch.tools.asan_check", *argv],
        env=env, cwd=REPO).returncode
    if rc < 0:  # ended by a signal: report it as a shell would
        print(f"asan check: the child ended by "
              f"{signal.Signals(-rc).name}", file=sys.stderr, flush=True)
        rc = 128 - rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
