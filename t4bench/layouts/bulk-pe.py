"""Bulk RNA-seq, paired-end: ``fragments_per_sample`` fragments, each
read from both ends into two gzip FASTQs (mate 1 in ``R1``, mate 2 in
``R2``, both mates of fragment i named r<i>), ``receptor_share`` of them
cut from the receptor templates of ``clones`` clones, the rest from
uniform random sequence.

A fragment's length follows a normal law (``fragment_mean``,
``fragment_sd``), clipped to between ``read_length`` and its template's
length; it lies at a uniform place on its template, on a random strand.
Mate 1 is its first ``read_length`` bases, mate 2 the reverse complement
of its last: a fragment shorter than two reads gives mates that overlap.
Substitutions at ``error_rate``, on each mate apart.

The reference's table holds every fragment's mate 1, then every mate 2:
rows i and n + i are fragment i's mates, each with its own
``read_clone`` and ``read_start`` (its first base on the template's
forward strand).  A fragment is kept when either mate shares a K-mer
with the coordinate genes, and then both mates are (FastqExtractor's
rule); a mate is extracted when its own mate's file holds it.  The
report is the single-end layout's.  ``fragment_max``, the longest
fragment drawn, bounds the gap that a scaffolded contig may span in the
judge's ``contig_off``.

Every seed gets the same sizes: the receptor fragments, each clone
rank's locus and fragment count, the fragment lengths before clipping;
genes, inserts, which fragment gets which length, places, errors and
strands are the seed's."""

from __future__ import annotations

import os

import numpy as np

from t4bench import layouts
from t4bench.reference import judge
from t4bench.traffic import generator as g

OUTPUTS = ("_toassemble_1.fq", "_toassemble_2.fq", "_annot.fa",
           "_report.tsv")
_SINGLE = layouts.load("bulk-se", os.path.dirname(os.path.abspath(__file__)))
wrong_barcodes = _SINGLE.wrong_barcodes
reported = _SINGLE.reported
write_report = _SINGLE.write_report


def generate(rng, cfg, mix, pools, out_dir: str) -> dict:
    n = mix["fragments_per_sample"]
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
    mean, sd = cfg["fragment_mean"], cfg["fragment_sd"]
    sizes = np.arange(max(1, round(mean - 5 * sd)), round(mean + 5 * sd) + 1)
    frag = rng.permutation(np.repeat(sizes, g.apportion(
        n, np.exp(-0.5 * ((sizes - mean) / sd) ** 2))))
    mates = np.empty((2, n, length), np.uint8)
    start = np.full((2, n), -1, np.int32)
    # Background: random sequence, of which only the mates' bases are read.
    bg = ~is_rec
    seq = g.bases(rng, (int(bg.sum()), 2 * length))
    last = np.clip(frag[bg], length, 2 * length) - length
    mates[0, bg] = seq[:, :length]
    mates[1, bg] = g.revcomp(seq[np.arange(len(seq))[:, None],
                                 last[:, None] + np.arange(length)])
    mates[:, is_rec], start[:, is_rec] = template_mates(
        rng, clones, which, frag[is_rec], length, cfg["error_rate"])
    paths = {"read1": os.path.join(out_dir, "R1.fq.gz"),
             "read2": os.path.join(out_dir, "R2.fq.gz")}
    g.write_fastq(paths["read1"], mates[0])
    g.write_fastq(paths["read2"], mates[1])
    read_clone = np.full(n, -1, np.int32)
    read_clone[is_rec] = which
    return {"files": paths, "reads": [paths["read1"], paths["read2"]],
            "n_reads": 2 * n, "clones": clones,
            "read_clone": np.concatenate([read_clone, read_clone]),
            "read_start": start.reshape(-1), "read_group": None,
            "fragment_max": int(sizes[-1])}


def template_mates(rng, clones, which: np.ndarray, frag: np.ndarray,
                   length: int, err: float):
    """(2, m, length) mates of fragments of the clones ``which`` names,
    ``frag`` bases long before clipping, and (2, m) each mate's start on
    its template."""
    tlen = np.array([len(c["template"]) for c in clones])
    buf = np.frombuffer("".join(c["template"] for c in clones).encode(),
                        np.uint8)
    offs = np.cumsum(np.concatenate([[0], tlen]))[which]
    tlen = tlen[which]
    frag = np.clip(frag, length, tlen)
    first = (rng.random(len(which)) * (tlen - frag + 1)).astype(np.int64)
    # The template's starts of the fragment's first and last bases read.
    at = np.stack([first, first + frag - length])
    seq = buf[(offs + at)[..., None] + np.arange(length)]
    mut = rng.random(seq.shape, dtype=np.float32) < err
    seq[mut] = g.bases(rng, int(mut.sum()))
    seq[1] = g.revcomp(seq[1])
    # On the reverse strand the fragment starts at the template's last
    # bases read: the mates change places.
    flip = rng.random(len(which)) < 0.5
    seq[:, flip] = seq[::-1, flip]
    at[:, flip] = at[::-1, flip]
    return seq, at.astype(np.int32)


def run_args(sample: dict) -> dict:
    return {"read1_files": [sample["files"]["read1"]],
            "read2_files": [sample["files"]["read2"]]}


def read_table(sample: dict) -> np.ndarray:
    return np.concatenate([judge.read_fastq_seqs(p)
                           for p in sample["reads"]])


def keep(sample: dict, hit: np.ndarray) -> np.ndarray:
    either = hit.reshape(2, -1).any(axis=0)
    return np.concatenate([either, either])

