"""The assembly decision trace of the port's shipping mode held against
TRUST4_TPU_DEVICE=0.  The port of tools/debug_trace_check.sh.

Usage::

    python -m trust4_tpu_torch.tools.debug_trace_check [--device cuda|cpu]
        [--fuzz-seed S ...]

TRUST4_TPU_DEBUG=1 makes the assembler print the reference's -DDEBUG
trace on stdout: the per-read lines, the AddRead internals (from the
native engine, through C stdio), the rescue, the assignment dump and the
mate extension (pipeline/assembler.py ``_dbg``).  This tool runs the
port's ``Assembler`` at threads 1 against the stand-in coordinate FASTA
(``testing.write_standin_references``), as the script runs the JAX
package's, on tests/data/gold_toassemble_{1,2}.fq and on the corpus of
each ``--fuzz-seed`` (``fuzz_differential.gen_corpus``; its pe and long
seeds reach the leftover path).  Each corpus runs twice, each run a
child process whose stdout is the trace: in the shipping mode
(TRUST4_TPU_DEVICE=1: the quick annotation's collect-oracle path) on
``--device``, and with TRUST4_TPU_DEVICE=0.  The two traces must be
byte-identical.  The script's diff against a reference -DDEBUG build
needs the reference's tree and is not made here.

Output, a line a corpus::

    gold: debug trace identical (N lines)
    seed S MODE: debug trace identical (N lines)

or the first differing lines, and the exit code is 1.  A run that exits
non-zero is reported with the end of its stderr.  ``--device cuda`` (the
default) raises at once without a card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG_DIR)
DATA_DIR = os.path.join(REPO, "tests", "data")
GOLD = (os.path.join(DATA_DIR, "gold_toassemble_1.fq"),
        os.path.join(DATA_DIR, "gold_toassemble_2.fq"))
# How a trace run starts: this module as a child.
LAUNCHER = ("-m", "trust4_tpu_torch.tools.debug_trace_check")
# Variables that would change the run under test.
_CLEARED = ("TRUST4_TPU_DEVICE", "TRUST4_TPU_DEVICE_CHECK",
            "TRUST4_TPU_GAP_MESH", "TRUST4_TPU_GAP_TEST",
            "TRUST4_TPU_NATIVE_LOOP")


def trace(reads: Sequence[str], coord: str, prefix: str, device: str,
          device_mode: str, launcher: Sequence[str] = LAUNCHER,
          env: Optional[Dict[str, str]] = None
          ) -> Tuple[int, bytes, str]:
    """One trace run in a child process: ``Assembler(coord, threads=1)``
    on ``reads`` (read 1, and read 2 when paired) with
    TRUST4_TPU_DEBUG=1 and TRUST4_TPU_DEVICE=``device_mode``, its
    outputs at ``prefix``.  ``launcher`` is what follows the interpreter
    (``-c CODE`` for a caller's own child, which must end in this
    module's ``main``); ``env`` adds variables.  Returns (exit code, the
    trace, stderr)."""
    child_env = {k: v for k, v in os.environ.items() if k not in _CLEARED}
    child_env.update(env or {})
    child_env.update(TRUST4_TPU_DEBUG="1", TRUST4_TPU_DEVICE=device_mode)
    argv = ["--child", "--coord", coord, "--prefix", prefix, "--device",
            device, "--reads", *reads]
    r = subprocess.run([sys.executable, *launcher, *argv], cwd=REPO,
                       env=child_env, capture_output=True)
    return r.returncode, r.stdout, r.stderr.decode(errors="replace")


def first_difference(a: bytes, b: bytes, context: int = 3) -> List[str]:
    """Lines around the first line where traces ``a`` and ``b`` differ."""
    la, lb = a.splitlines(), b.splitlines()
    i = next((k for k, (x, y) in enumerate(zip(la, lb)) if x != y),
             min(len(la), len(lb)))
    out = [f"first difference at line {i + 1} ({len(la)} vs {len(lb)} "
           "lines)"]
    for tag, lines in (("dev", la), ("off", lb)):
        for k in range(max(0, i - context), min(len(lines), i + context)):
            out.append(f"  {tag} {k + 1}: "
                       f"{lines[k].decode(errors='replace')}")
    return out


def compare(name: str, reads: Sequence[str], coord: str, work: str,
            device: str, launcher: Sequence[str] = LAUNCHER,
            env: Optional[Dict[str, str]] = None) -> Dict:
    """``trace`` of ``reads`` in the shipping mode on ``device``, then with
    TRUST4_TPU_DEVICE=0.  Returns both traces, the line count and the
    report lines (``ok`` when both ran and the traces are
    byte-identical)."""
    runs = {}
    for tag, mode in (("dev", "1"), ("off", "0")):
        d = os.path.join(work, name, tag)
        os.makedirs(d, exist_ok=True)
        runs[tag] = trace(reads, coord, os.path.join(d, "trace"), device,
                          mode, launcher, env)
    rec = {"dev": runs["dev"][1], "off": runs["off"][1],
           "lines": runs["off"][1].count(b"\n")}
    raised = [f"{tag} exited {rc}: ...{err[-4000:]}"
              for tag, (rc, _out, err) in runs.items() if rc != 0]
    if raised:
        rec["ok"], rec["report"] = False, [f"{name}: a run failed"] + raised
    elif rec["dev"] != rec["off"]:
        rec["ok"] = False
        rec["report"] = [f"{name}: debug traces DIFFER"] + first_difference(
            rec["dev"], rec["off"])
    else:
        rec["ok"] = True
        rec["report"] = [f"{name}: debug trace identical "
                         f"({rec['lines']} lines)"]
    return rec


def _child(a) -> int:
    """The run in the child: the trace on stdout."""
    from trust4_tpu_torch.pipeline.assembler import Assembler

    asm = Assembler(a.coord, output_prefix=a.prefix, threads=1,
                    device=a.device)
    asm.run(a.reads[:1], a.reads[1:] or None)
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--fuzz-seed", type=int, action="append", default=[])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--coord", help=argparse.SUPPRESS)
    ap.add_argument("--prefix", help=argparse.SUPPRESS)
    ap.add_argument("--reads", nargs="+", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        return _child(a)

    from trust4_tpu_torch import testing
    from trust4_tpu_torch.ops import gap_oracle
    from trust4_tpu_torch.tools import fuzz_differential as fz

    if a.device == "cuda":
        gap_oracle._resolve("cuda")  # raises at once without a card
    work = tempfile.mkdtemp(prefix="t4trace_")
    ok = True
    try:
        coord = testing.write_standin_references(
            os.path.join(work, "ref"))[0]
        corpora = [("gold", list(GOLD))]
        for seed in a.fuzz_seed:
            d = os.path.join(work, "corpus", str(seed))
            os.makedirs(d, exist_ok=True)
            c = fz.gen_corpus(seed, d, coord)
            reads = [c["args"][i + 1] for i, v in enumerate(c["args"])
                     if v in ("-1", "-2", "-u")]
            corpora.append((f"seed {seed} {c['mode']}", reads))
        for name, reads in corpora:
            rec = compare(name, reads, coord, work, a.device)
            ok &= rec["ok"]
            print("\n".join(rec["report"]), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
