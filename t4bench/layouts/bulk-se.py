"""Bulk RNA-seq, single-end: ``reads_per_sample`` reads in one gzip
FASTQ, ``receptor_share`` of them receptor reads from ``clones`` clones,
each on a random strand, among uniform random background reads.

Every seed gets the same sizes: the receptor reads, each clone rank's
locus and read count; genes, inserts, read places, errors and strands
are the seed's."""

from __future__ import annotations

import os

import numpy as np

from t4bench.traffic import generator as g

OUTPUTS = ("_toassemble.fq", "_annot.fa", "_report.tsv")


def generate(rng, cfg, mix, pools, out_dir: str) -> dict:
    n = mix["reads_per_sample"]
    length = cfg["read_length"]
    loci = list(cfg["locus_weights"])
    w = np.array([cfg["locus_weights"][k] for k in loci], np.float64)
    clones = g.rearrangements(
        rng, pools, [loci[i] for i in g.spread(mix["clones"], w)],
        cfg["insert_max"])
    n_rec = int(round(n * mix["receptor_share"]))
    is_rec = rng.permutation(n) < n_rec
    counts = g.apportion(n_rec, g.zipf(len(clones), cfg["zipf"]))
    which = rng.permutation(np.repeat(np.arange(len(clones)), counts))
    seqs = g.bases(rng, (n, length))
    rec_seq, start = g.template_reads(rng, clones, which, length,
                                      cfg["error_rate"], strand=True)
    seqs[is_rec] = rec_seq
    read_clone = np.full(n, -1, np.int32)
    read_clone[is_rec] = which
    read_start = np.full(n, -1, np.int32)
    read_start[is_rec] = start
    path = os.path.join(out_dir, "reads.fq.gz")
    g.write_fastq(path, seqs)
    return {"files": {"single": path}, "reads": path, "n_reads": n,
            "clones": clones, "read_clone": read_clone,
            "read_start": read_start, "read_group": None}


def run_args(sample: dict) -> dict:
    return {"single_files": [sample["files"]["single"]]}


def wrong_barcodes(prefix: str, sample: dict, kept) -> int:
    return 0


def reported(prefix: str, sample: dict) -> dict:
    """``_report.tsv``: count, frequency, CDR3nt, CDR3aa, V, D, J, ..."""
    rows = []
    with open(prefix + "_report.tsv") as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            rows.append((cols[2], cols[4], cols[6]))
    return {None: rows}


def write_report(prefix: str, sample: dict, kept, cdr3, reduce) -> None:
    clones = sample["clones"]
    rc = sample["read_clone"]
    n_reads = np.bincount(rc[rc >= 0], minlength=len(clones))
    with open(prefix + "_report.tsv", "w") as f:
        f.write("#count\tfrequency\tCDR3nt\tCDR3aa\tV\tD\tJ\tC\tcid\t"
                "cid_full_length\n")
        for k, c in enumerate(clones):
            f.write(f"{n_reads[k]}\t0\t{cdr3[k]}\t.\t{c['v']}\t"
                    f"{c['d'] or '.'}\t{c['j']}\t{c['c']}\tc{k}\t1\n")
