"""Randomized end-to-end differential harness: the port's shipping mode
held against its native CPU DP.  The port of tools/fuzz_differential.py
(bulk) and tools/fuzz_differential_barcoded.py (barcoded).

Usage::

    python -m trust4_tpu_torch.tools.fuzz_differential LO HI [--barcoded]
        [--device cuda|cpu] [--threads N] [--check] [--work DIR]

Each seed in [LO, HI) draws a random corpus (the JAX harnesses' recipes,
draw for draw) from the stand-in references (``testing.
write_standin_references``) and runs it through the port's CLI in this
process twice: on ``--device`` in the shipping mode
(TRUST4_TPU_DEVICE=1: the collect-oracle path, kernel #1 on the card or
its plain PyTorch version on the CPU) and with TRUST4_TPU_DEVICE=0 (the
native CPU DP, which is what the JAX package runs by default).  Every
file the two runs write must be byte-identical, except the report tables
(``SORTED``), which are compared after sorting their lines.  Nothing is
normalised: both runs are the same program.  ``--check`` adds
TRUST4_TPU_DEVICE_CHECK=1 to the first run, which asserts every gap count
against the CPU DP.

The JAX harnesses held the JAX package against the reference binaries;
this one holds the port's card path against the path the JAX package
shares with the port, so the chain reaches the reference without its
binaries.

Output, one line a seed, then the total::

    seed S MODE n=N fills=F miss=M launches=L: OK
    seed S MODE n=N fills=F miss=M launches=L: ['_cdr3.out', ...]
    MISMATCHED CORPORA: k

MODE is pe, se, repseq or long (bulk), UMI or BC (barcoded, with
``+minCov<c>`` when ``--contigMinCov c`` was passed); N the reads drawn;
F the gap fills the oracle saw; M the jobs beyond the top tier, which ran
on the native leftover path; L the launches of kernel #1 (0 on the CPU).
A mismatch line lists each file that differs, ``name:MISSING`` for a
file only one run wrote, and ``dev raised: ...`` / ``off raised: ...``
with the last error line of a run that raised.  The exit code is 1 when
k > 0.  ``--device cuda`` (the default) raises at once without a card.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

from trust4_tpu_torch.io.fastx import read_fastx

SORTED = ("_report.tsv", "_barcode_report.tsv", "_airr.tsv",
          "_barcode_airr.tsv")
PREFIX = "fz"
# The stand-in templates are about 600 bases (V median 354, J 60, the
# first 200 of C), so the JAX recipe's long lengths (400, 700, 1200)
# would leave most long corpora empty; these fit.
LONG_LENGTHS = (300, 400, 500)
_COMP = str.maketrans("ACGTN", "TGCAN")


def _genes(rnd: random.Random, coord_fa: str, barcoded: bool):
    """V, D, J and C sequences of the coordinate FASTA, by the JAX
    recipes' name rules, each non-ACGT base drawn anew."""
    vs, ds, js, cs = [], [], [], []
    for rec in read_fastx([coord_fa]):
        s = "".join(c if c in "ACGT" else rnd.choice("ACGT")
                    for c in rec.seq.upper())
        nm = rec.id
        if len(nm) > 3 and nm[3] == "V":
            vs.append(s)
        elif barcoded:
            if len(nm) > 3 and nm[3] == "J":
                js.append(s)
            elif len(nm) <= 3 or nm[3] not in "VDJ":
                cs.append(s)
        elif len(nm) > 4 and nm[3] == "D" and nm[4].isdigit():
            ds.append(s)
        elif len(nm) > 3 and nm[3] == "J":
            js.append(s)
        else:
            cs.append(s)
    return vs, ds, js, cs


def _capped(n: int, cap: Optional[int]) -> int:
    return n if cap is None else min(n, cap)


def gen_corpus(seed: int, out_dir: str, coord_fa: str,
               max_clones: Optional[int] = None,
               max_depth: Optional[int] = None) -> Dict:
    """A bulk corpus, tools/fuzz_differential.py:gen_corpus draw for draw:
    mode pe / se / repseq / long (weights 0.35 / 0.3 / 0.2 / 0.15), read
    length 50-150 (long: ``LONG_LENGTHS``, not the recipe's), error rate
    0-5% with N bases, 3-40 clones (long 40-160) of depth 2-60.  Writes
    ``r1.fq`` (and ``r2.fq`` for pe) into ``out_dir``.  ``max_clones`` and
    ``max_depth`` cap the drawn counts after each draw (the order of draws
    is unchanged); None keeps the recipe's sizes.  Returns the mode, the
    read count and the CLI's input arguments; raises on an empty
    corpus."""
    rnd = random.Random(seed)
    vs, ds, js, cs = _genes(rnd, coord_fa, barcoded=False)
    mode = rnd.choices(["pe", "se", "repseq", "long"],
                       [0.35, 0.3, 0.2, 0.15])[0]
    paired = mode == "pe"
    read_len = (rnd.choice(LONG_LENGTHS) if mode == "long"
                else rnd.choice([50, 75, 100, 125, 150]))
    err = rnd.choice([0.0, 0.005, 0.02, 0.05])
    n_clones = _capped(rnd.randint(40, 160) if mode == "long"
                       else rnd.randint(3, 40), max_clones)
    frag_len = read_len if mode == "long" else (read_len * 2
                                                + rnd.randint(0, 120))

    def mut(s):
        return "".join(rnd.choice("ACGTN") if rnd.random() < err else c
                       for c in s)

    r1_path = os.path.join(out_dir, "r1.fq")
    r2_path = os.path.join(out_dir, "r2.fq")
    r1, r2 = [], []
    for _clone in range(n_clones):
        v, j, c = rnd.choice(vs), rnd.choice(js), rnd.choice(cs)
        d = rnd.choice(ds) if ds and rnd.random() < 0.5 else ""
        ins1 = "".join(rnd.choice("ACGT") for _ in range(rnd.randint(0, 8)))
        ins2 = "".join(rnd.choice("ACGT") for _ in range(rnd.randint(0, 8)))
        full = (v[:len(v) - rnd.randint(0, 8)] + ins1 + d[2:12] + ins2
                + j[rnd.randint(0, 4):] + c[:200])
        depth = _capped(rnd.randint(2, 60), max_depth)
        for _ in range(depth):
            if len(full) < frag_len + 5:
                break
            this_frag = frag_len
            if mode == "long":  # variable long-read lengths
                this_frag = rnd.randint(max(210, frag_len // 2), frag_len)
            fs = rnd.randint(0, len(full) - this_frag)
            frag = full[fs:fs + this_frag]
            this_len = this_frag if mode == "long" else read_len
            fwd = mut(frag[:this_len])
            q = "".join(rnd.choice("BFHI5") for _ in range(this_len))
            r1.append(f"@fz{len(r1)}\n{fwd}\n+\n{q}\n")
            if paired:
                mate_rc = mut(frag[-read_len:]).translate(_COMP)[::-1]
                q2 = "".join(rnd.choice("BFHI5") for _ in range(read_len))
                r2.append(f"@fz{len(r2)}\n{mate_rc}\n+\n{q2}\n")
    if not r1:
        raise ValueError(f"seed {seed}: the {mode} corpus drew no read")
    with open(r1_path, "w") as f:
        f.write("".join(r1))
    if paired:
        with open(r2_path, "w") as f:
            f.write("".join(r2))
        inputs = ["-1", r1_path, "-2", r2_path]
    else:
        inputs = ["-u", r1_path]
    if mode == "repseq":
        inputs.append("--repseq")
    return {"mode": mode, "n": len(r1), "args": inputs}


def gen_barcoded(seed: int, out_dir: str, coord_fa: str,
                 max_clones: Optional[int] = None,
                 max_depth: Optional[int] = None) -> Dict:
    """A barcoded corpus, tools/fuzz_differential_barcoded.py:gen draw for
    draw: 3-25 cells of 1-3 of 2-12 clones, 2-25 reads a clone, read
    length 90-120, error rate 0 or 1%, qualities with '#' (the 3' trim),
    a 16-base barcode and a 10-base UMI a read, ``--UMI`` on half the
    seeds; ``seed % 3 == 0`` adds ``--contigMinCov`` 2, 4 or 6 (drawn
    last, as the JAX harness draws it).  Writes ``r1.fq`` and ``bc.fq``.
    ``max_clones`` caps the clone pool and ``max_depth`` the reads a
    clone (after each draw); None keeps the recipe's sizes.  Returns as
    ``gen_corpus``."""
    rnd = random.Random(seed)
    vs, _ds, js, cs = _genes(rnd, coord_fa, barcoded=True)
    n_cells = rnd.randint(3, 25)
    read_len = rnd.choice([90, 100, 120])
    err = rnd.choice([0.0, 0.01])
    use_umi = rnd.random() < 0.5
    clones = []
    for _ in range(_capped(rnd.randint(2, 12), max_clones)):
        v, j, c = rnd.choice(vs), rnd.choice(js), rnd.choice(cs)
        ins = "".join(rnd.choice("ACGT") for _ in range(rnd.randint(0, 10)))
        clones.append(v + ins + j + c[:150])
    r1, bc = [], []
    for _cell in range(n_cells):
        cb = "".join(rnd.choice("ACGT") for _ in range(16))
        my_clones = rnd.sample(clones, rnd.randint(1, min(3, len(clones))))
        for full in my_clones:
            for _ in range(_capped(rnd.randint(2, 25), max_depth)):
                if len(full) <= read_len:
                    continue
                st = rnd.randint(0, len(full) - read_len)
                rd = list(full[st:st + read_len])
                for i in range(len(rd)):
                    if rnd.random() < err:
                        rd[i] = rnd.choice("ACGTN")
                q = "".join(rnd.choice("FGHI#5B") for _ in range(read_len))
                r1.append(f"@bz{len(r1)}\n{''.join(rd)}\n+\n{q}\n")
                umi = "".join(rnd.choice("ACGT") for _ in range(10))
                bc.append(f"@bz{len(bc)}\n{cb}{umi}\n+\n{'I' * 26}\n")
    mode = "UMI" if use_umi else "BC"
    if not r1:
        raise ValueError(f"seed {seed}: the barcoded corpus drew no read")
    r1_path = os.path.join(out_dir, "r1.fq")
    bc_path = os.path.join(out_dir, "bc.fq")
    with open(r1_path, "w") as f:
        f.write("".join(r1))
    with open(bc_path, "w") as f:
        f.write("".join(bc))
    inputs = ["-u", r1_path, "--barcode", bc_path, "--readFormat",
              "bc:0:15,um:16:25" if use_umi else "bc:0:15"]
    if use_umi:
        inputs += ["--UMI", bc_path]
    if seed % 3 == 0:  # the shallow-contig release and dropout
        cov = rnd.choice([2, 4, 6])
        inputs += ["--contigMinCov", str(cov)]
        mode += f"+minCov{cov}"
    return {"mode": mode, "n": len(r1), "args": inputs}


GENERATORS = {"bulk": gen_corpus, "barcoded": gen_barcoded}


def _last_error_line(e: BaseException) -> str:
    return traceback.format_exception_only(type(e), e)[-1].strip()


def compare_dirs(a: str, b: str) -> List[str]:
    """The names of the files that differ between directories ``a`` and
    ``b`` (report tables after sorting their lines; ``name:MISSING`` for
    a file only one holds)."""
    names_a, names_b = set(os.listdir(a)), set(os.listdir(b))
    bad = [f"{n}:MISSING" for n in sorted(names_a ^ names_b)]
    for n in sorted(names_a & names_b):
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            da, db = fa.read(), fb.read()
        if n.endswith(SORTED):
            same = sorted(da.splitlines()) == sorted(db.splitlines())
        else:
            same = da == db
        if not same:
            bad.append(n)
    return bad


def _run_cli(argv: List[str], env: Dict[str, str]) -> None:
    """``cli.main(["run", ...])`` in this process with ``env`` set, the
    variables restored after."""
    from trust4_tpu_torch import cli

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc = cli.main(["run"] + argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise RuntimeError(f"run exited {rc}")


def run_both(args: List[str], d: str, device: str = "cuda",
             check: bool = False,
             inputs: Sequence[Tuple[str, str]] = ()) -> Dict:
    """Run the port's CLI with ``args`` twice: on ``device`` in the
    shipping mode (TRUST4_TPU_DEVICE=1, and TRUST4_TPU_DEVICE_CHECK=1 with
    ``check``) into ``d/dev/``, then with TRUST4_TPU_DEVICE=0 into
    ``d/off/``, each with ``-o <dir>/fz``; compare every file.  Each
    (path, suffix) of ``inputs`` is copied into both directories first as
    ``fz<suffix>`` (the files of a run resumed at ``--stage``).  The
    device's
    prewarm is joined before the counts are zeroed.  Returns the
    mismatches, both output directories and, under ``dev`` and ``off``,
    each run's wall and counts (gap fills, per-tier unique jobs, jobs
    beyond the top tier as ``miss``, launches of #1)."""
    import torch

    from trust4_tpu_torch.ops import dp_counts, gap_oracle

    gap_oracle.wait_ready(device)
    rec = {"mismatches": [],
           "dirs": {"dev": os.path.join(d, "dev"),
                    "off": os.path.join(d, "off")}}
    runs = (("dev", {"TRUST4_TPU_DEVICE": "1",
                     "TRUST4_TPU_DEVICE_CHECK": "1" if check else "0"}),
            ("off", {"TRUST4_TPU_DEVICE": "0",
                     "TRUST4_TPU_DEVICE_CHECK": "0"}))
    for tag, env in runs:
        out = rec["dirs"][tag]
        os.makedirs(out)
        for path, suffix in inputs:
            shutil.copy(path, os.path.join(out, PREFIX + suffix))
        gap_oracle.reset_stats()
        dp_counts.LAUNCHES = 0
        t0 = time.perf_counter()
        try:
            _run_cli(args + ["--device", device, "-o",
                             os.path.join(out, PREFIX)], env)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        except Exception as e:  # a mismatch, reported with its last line
            traceback.print_exc()
            rec["mismatches"].append(f"{tag} raised: {_last_error_line(e)}")
        st = gap_oracle.STATS
        rec[tag] = {"wall_s": time.perf_counter() - t0,
                    "fills": st["gap_fills"],
                    "tier_unique": list(st["tier_unique"]),
                    "miss": st["miss"], "launches": dp_counts.LAUNCHES,
                    "prewarm_launches": st["prewarm_launches"]}
    if rec["off"]["fills"] or rec["off"]["launches"]:
        rec["mismatches"].append("off ran the oracle")
    if not rec["mismatches"]:
        rec["mismatches"] = compare_dirs(rec["dirs"]["dev"],
                                         rec["dirs"]["off"])
    for k in ("fills", "tier_unique", "miss", "launches"):
        rec[k] = rec["dev"][k]
    return rec


def run_seed(seed: int, kind: str, work: str, refs: Sequence[str],
             device: str = "cuda", threads: int = 1, check: bool = False,
             max_clones: Optional[int] = None,
             max_depth: Optional[int] = None) -> Dict:
    """Draw seed's ``kind`` ("bulk" or "barcoded") corpus into
    ``work/kind/seed`` and run it through ``run_both``.  ``refs`` is
    (coordinate FASTA, IMGT FASTA).  Returns ``run_both``'s record with
    the seed, the mode, the read count and the CLI arguments (``args``,
    without ``--device`` and ``-o``)."""
    d = os.path.join(work, kind, str(seed))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    corpus = GENERATORS[kind](seed, d, refs[0], max_clones=max_clones,
                              max_depth=max_depth)
    args = ["-f", refs[0], "--ref", refs[1], "-t", str(threads)] + corpus[
        "args"]
    rec = {"seed": seed, "kind": kind, "mode": corpus["mode"],
           "n": corpus["n"], "args": args}
    rec.update(run_both(args, d, device, check))
    return rec


def seed_line(rec: Dict) -> str:
    status = rec["mismatches"] or "OK"
    return (f"seed {rec['seed']} {rec['mode']} n={rec['n']} "
            f"fills={rec.get('fills', 0)} miss={rec.get('miss', 0)} "
            f"launches={rec.get('launches', 0)}: {status}")


def wave(seeds, kind: str, work: str, refs: Sequence[str],
         device: str = "cuda", threads: int = 1, check: bool = False,
         **caps) -> List[Dict]:
    """``run_seed`` over ``seeds``, printing each seed's line; a seed
    whose corpus cannot be drawn is a mismatch with its last error
    line."""
    recs = []
    for seed in seeds:
        try:
            rec = run_seed(seed, kind, work, refs, device, threads, check,
                           **caps)
        except ValueError as e:  # the corpus drew no read
            rec = {"seed": seed, "kind": kind, "mode": "-", "n": 0,
                   "mismatches": [f"raised: {_last_error_line(e)}"]}
        print(seed_line(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lo", type=int)
    ap.add_argument("hi", type=int)
    ap.add_argument("--barcoded", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--work", default=None,
                    help="keep the corpora and outputs here (default: a "
                    "temporary directory, removed at exit)")
    a = ap.parse_args(argv)
    from trust4_tpu_torch import testing
    from trust4_tpu_torch.ops import gap_oracle

    gap_oracle.wait_ready(a.device)  # raises at once without a card
    work = a.work or tempfile.mkdtemp(prefix="t4fuzz_")
    try:
        refs = testing.write_standin_references(os.path.join(work, "ref"))
        recs = wave(range(a.lo, a.hi), "barcoded" if a.barcoded else "bulk",
                    work, refs, a.device, a.threads, a.check)
    finally:
        if a.work is None:
            shutil.rmtree(work, ignore_errors=True)
    bad = sum(bool(r["mismatches"]) for r in recs)
    print("MISMATCHED CORPORA:", bad, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
