"""The benchmark's frozen germline references.

``bcrtcr_ref_golden.tsv`` and ``imgt_ref_golden.tsv`` beside this file
are what TRUST4's loader made of the real ``hg38_bcrtcr.fa`` (615 rows,
619 records) and ``human_IMGT+C.fa`` (958 rows, 983 records): one row per
loaded sequence, with its name (``|`` joins records of one sequence), its
degapped consensus and its CDR1/2/3 coordinates.  ``write_references``
turns them back into the two FASTAs, loading to exactly those rows:

* coordinate file: ``>name`` and the consensus for each record;
* IMGT file: one record per name, V genes with IMGT '.' gaps placed so
  that the loader's codon checkpoints (non-gap bases before gapped
  columns 78, 114, 165, 195 and 309) give back the stored coordinates; a
  V gene without a CDR3 anchor stays under 310 columns, and every V gene
  is padded to at least 198 so that the loader computes them.

A frozen copy of the writer the port's tests use, so that the benchmark
reads nothing of the program and no later edit of the tests moves it.
Plain Python: it imports nothing of the program.
"""

from __future__ import annotations

import os
from typing import List, Tuple

DATA_DIR = os.path.dirname(os.path.abspath(__file__))
COORD_TABLE = os.path.join(DATA_DIR, "bcrtcr_ref_golden.tsv")
IMGT_TABLE = os.path.join(DATA_DIR, "imgt_ref_golden.tsv")

# (gapped column, which stored coordinate) the loader counts bases at.
_V_CHECKPOINTS = ((78, 0), (114, 1), (165, 2), (195, 3), (309, 4))


def rows(path: str) -> List[Tuple[str, str, List[int]]]:
    """(names, consensus, [cdr1a, cdr1b, cdr2a, cdr2b, cdr3a, cdr3b]) of
    each row of a table."""
    out = []
    with open(path) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")
            out.append((p[0], p[1], [int(x) for x in p[2:8]]))
    return out


def is_v(name: str) -> bool:
    """A V gene's name: its fourth letter is V (TRUST4's gene type 0)."""
    return not name.startswith("No") and len(name) >= 4 and name[3] == "V"


def gapped_v(consensus: str, info: List[int]) -> str:
    """IMGT-gapped V sequence whose checkpoint counts give back ``info``."""
    # Bases that must lie before each checkpoint: CDR starts count the
    # bases before them, CDR ends the bases up to and including them.
    want = [info[0], info[1] + 1, info[2], info[3] + 1, info[4]]
    out = []
    pos = n = 0
    for g, w in _V_CHECKPOINTS:
        if w == 4 and info[4] < 0:
            break
        need = want[w] - n
        dots = (g - pos) - need
        if need < 0 or dots < 0:
            raise ValueError(f"infeasible IMGT gaps for {info}")
        out.append(consensus[n: n + need] + "." * dots)
        pos, n = g, want[w]
    out.append(consensus[n:])
    s = "".join(out)
    s += "." * max(0, 3 * 66 - len(s))
    if info[4] < 0 and len(s) >= 3 * (104 - 1) + 1:
        raise ValueError(f"gapped V too long to keep CDR3 unset: {info}")
    return s


def write_references(out_dir: str) -> Tuple[str, str]:
    """Write the coordinate and IMGT FASTAs into ``out_dir``; returns
    their paths (coord_fa, imgt_fa)."""
    os.makedirs(out_dir, exist_ok=True)
    coord_fa = os.path.join(out_dir, "bcrtcr.fa")
    imgt_fa = os.path.join(out_dir, "IMGT+C.fa")
    with open(coord_fa, "w") as f:
        for names, cons, _info in rows(COORD_TABLE):
            for name in names.split("|"):
                f.write(f">{name}\n{cons}\n")
    with open(imgt_fa, "w") as f:
        for names, cons, info in rows(IMGT_TABLE):
            seq = gapped_v(cons, info) if is_v(names.split("|")[0]) else cons
            for name in names.split("|"):
                f.write(f">{name}\n{seq}\n")
    return coord_fa, imgt_fa
