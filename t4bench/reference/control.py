"""The control: the reference put in the program's place.

For each sample of a cell's pool the reference's own answers are written
as the program's output files, computed at ``--resolution`` bits a base,
and judged as a run's would be:

* the extraction files (``judge.extraction_files``: the layout's
  ``_toassemble*.fq`` outputs): the reads the reference keeps (judge.py's
  rule on the sequences read at that resolution, and the layout's
  ``keep``), each named as its input names it, in its own file;
* ``_annot.fa``: every planted template as a contig, its header naming
  the planted V allele and CDR3;
* the layout's report files (``write_report`` of
  ``layouts/<layout>.py``): every planted chain with its CDR3 and its V,
  D, J and C genes, and the layout's barcodes.

At 2 bits a base (the configuration's precision) every number reads 0.
At 1 bit, the precision below (purine or pyrimidine, each read back as A
or C), one of the numbers at least has to fail its limit.  The
benchmark's own runs do not run this.

    python3 -m t4bench.reference.control --workload CELL --seeds S [S ...]
        [--resolution 1|2]

prints, per seed, the worst number over the pool's samples beside the
cell's limit, and one JSON line of them all.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from t4bench.data import standin
from t4bench.reference import judge


def write_outputs(sample: dict, prefix: str, genes: np.ndarray,
                  table: dict, resolution: int, layout) -> None:
    """The reference's answers for ``sample`` at ``resolution``, written
    as the program's files at ``prefix``."""
    reads = judge.hook(layout, "read_table")(sample)
    kept = np.nonzero(judge.hook(layout, "keep")(
        sample, judge.expected_kept(reads, genes, resolution)))[0]
    # Each file holds the table's rows from its first to the next file's.
    files = judge.extraction_files(layout, prefix, len(reads))
    ends = [first for _path, first in files[1:]] + [len(reads)]
    for (path, first), end in zip(files, ends):
        with open(path, "w") as f:
            for i in kept[(kept >= first) & (kept < end)]:
                seq = judge.reduce(reads[i].tobytes().decode(), resolution)
                f.write(f"@r{i - first:09d}\n{seq}\n+\n{'I' * len(seq)}\n")
    clones = sample["clones"]
    cdr3 = [judge.reduce(judge.cdr3_of(c, table), resolution)
            for c in clones]
    with open(prefix + "_annot.fa", "w") as f:
        for k, c in enumerate(clones):
            f.write(f">c{k} {len(c['template'])} 1.00 {c['v']}(0) * "
                    f"{c['j']}(0) {c['c']}(0) CDR3(0-0):100.00={cdr3[k]}\n"
                    f"{judge.reduce(c['template'], resolution)}\n")
    layout.write_report(prefix, sample, kept, cdr3,
                        lambda x: judge.reduce(x, resolution))


def control(cell, seed: int, resolution: int, work: str) -> dict:
    """The worst of each number over the pool's samples of ``seed``."""
    from t4bench.traffic import generator

    coord, _imgt = standin.write_references(os.path.join(work, "ref"))
    pool = generator.generate_pool(cell.config, cell.mix, seed,
                                   os.path.join(work, "pool"), cell.layout)
    table = judge.imgt_table(standin.IMGT_TABLE)
    exact = judge.coordinate_genes(coord)
    genes = judge.coordinate_genes(coord, resolution)
    per = []
    for k, sample in enumerate(pool):
        prefix = os.path.join(work, "out", f"s{k}", "S")
        os.makedirs(os.path.dirname(prefix))
        write_outputs(sample, prefix, genes, table, resolution,
                      cell.layout)
        ref = judge.Reference(sample, exact, table,
                              cell.config["read_length"], cell.layout)
        per.append(ref.judge(prefix))
    return judge.worst(per)


def main(argv=None) -> int:
    from t4bench.run import Cell

    p = argparse.ArgumentParser(prog="python3 -m t4bench.reference.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--resolution", type=int, choices=(1, 2), default=1)
    a = p.parse_args(argv)
    cell = Cell(a.workload)
    out = {}
    for seed in a.seeds:
        work = tempfile.mkdtemp(prefix="t4bench-control-")
        try:
            out[seed] = control(cell, seed, a.resolution, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for k, v in out[seed].items():
            print(f"{a.workload} seed {seed} resolution {a.resolution}: "
                  f"{k} {v!r} limit {cell.limits[k]!r}")
    print(json.dumps({"workload": a.workload, "resolution": a.resolution,
                      "numbers": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
