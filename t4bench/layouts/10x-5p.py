"""10x Chromium 5': ``cells_per_sample`` cells, each with one clonotype
drawn from ``clonotypes`` by the configuration's clone-size law: a chain
pair of one receptor type (TRB+TRA, or IGH with IGK or IGL),
``reads_per_chain`` reads of each chain from the template's forward
strand.  Every cDNA read (R2) has an R1 of its cell's barcode and a
random UMI; ``receptor_share`` < 1 adds barcoded background reads spread
over the same cells.

Every seed gets the same sizes: each clonotype rank's receptor type,
chain loci and number of cells, the multiset of reads a chain, the
background; genes, inserts, barcodes, UMIs, read places and errors are
the seed's.  A chain is judged in its cell."""

from __future__ import annotations

import os

import numpy as np

from t4bench.reference import judge
from t4bench.traffic import generator as g

OUTPUTS = ("_toassemble.fq", "_annot.fa", "_barcode_report.tsv",
           "_toassemble_bc.fa")
# A clonotype's chain pair by receptor type.
PAIRS = {"T": (("TRB",), ("TRA",)), "B": (("IGH",), ("IGK", "IGL"))}


def generate(rng, cfg, mix, pools, out_dir: str) -> dict:
    length = cfg["read_length"]
    n_cells = mix["cells_per_sample"]
    kinds = list(cfg["receptor_type_weights"])
    w = np.array([cfg["receptor_type_weights"][k] for k in kinds])
    types = [kinds[i] for i in g.spread(mix["clonotypes"], w)]
    loci = []
    for r, t in enumerate(types):
        for options in PAIRS[t]:
            loci.append(options[r % len(options)])
    clones = g.rearrangements(rng, pools, loci, cfg["insert_max"])
    cells_of_type = g.apportion(n_cells, g.zipf(len(types), cfg["zipf"]))
    cell_type = rng.permutation(np.repeat(np.arange(len(types)),
                                          cells_of_type))
    barcodes = g.bases(rng, (n_cells, cfg["barcode_length"]))
    lo, hi = mix["reads_per_chain"]
    u = (np.arange(2 * n_cells) * 0.6180339887498949) % 1.0
    per = rng.permutation(lo + (u * (hi - lo + 1)).astype(np.int64)
                          ).reshape(n_cells, 2)
    which = np.concatenate([
        np.repeat(2 * cell_type + k, per[:, k]) for k in (0, 1)])
    cell_of = np.concatenate([np.repeat(np.arange(n_cells), per[:, k])
                              for k in (0, 1)])
    n_rec = len(which)
    n_bg = int(round(n_rec * (1.0 / mix["receptor_share"] - 1.0)))
    rec_seq, start = g.template_reads(rng, clones, which, length,
                                      cfg["error_rate"], strand=False)
    seqs = np.concatenate([rec_seq, g.bases(rng, (n_bg, length))])
    cell_of = np.concatenate([cell_of, rng.permutation(
        np.arange(n_bg) % n_cells)])
    read_clone = np.concatenate([which, np.full(n_bg, -1)]).astype(np.int32)
    read_start = np.concatenate([start, np.full(n_bg, -1)]).astype(np.int32)
    order = rng.permutation(len(seqs))
    seqs, cell_of = seqs[order], cell_of[order]
    read_clone, read_start = read_clone[order], read_start[order]
    umi = g.bases(rng, (len(seqs), cfg["umi_length"]))
    r1 = np.concatenate([barcodes[cell_of], umi], axis=1)
    paths = {"cdna": os.path.join(out_dir, "R2.fq.gz"),
             "barcode": os.path.join(out_dir, "R1.fq.gz")}
    g.write_fastq(paths["cdna"], seqs)
    g.write_fastq(paths["barcode"], r1)
    return {"files": paths, "reads": paths["cdna"], "n_reads": len(seqs),
            "clones": clones, "read_clone": read_clone,
            "read_start": read_start,
            "read_group": cell_of.astype(np.int32),
            "barcodes": [b.tobytes().decode() for b in barcodes],
            "cell_clonotype": cell_type.astype(np.int32)}


def run_args(sample: dict) -> dict:
    return {"single_files": [sample["files"]["cdna"]],
            "barcode_files": [sample["files"]["barcode"]]}


def wrong_barcodes(prefix: str, sample: dict, kept) -> int:
    """Kept reads whose ``_toassemble_bc.fa`` barcode is not their
    cell's."""
    bcs = sample["barcodes"]
    cell = sample["read_group"]
    wrong = 0
    for name, seq in judge.read_fasta(prefix + "_toassemble_bc.fa"):
        r = int(name.split()[0].lstrip("r"))
        if seq != bcs[cell[r]]:
            wrong += 1
    return wrong


def reported(prefix: str, sample: dict) -> dict:
    """``_barcode_report.tsv``: barcode, cell type, then chains of
    ``V,D,J,C,CDR3nt,...`` (``*`` for none), by cell."""
    cell_of = {b: i for i, b in enumerate(sample["barcodes"])}
    out: dict = {}
    with open(prefix + "_barcode_report.tsv") as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            rows = out.setdefault(cell_of.get(cols[0], cols[0]), [])
            for c in cols[2:]:
                x = c.split(",")
                if c != "*" and len(x) > 4:
                    rows.append((x[4], x[0], x[2]))
    return out


def write_report(prefix: str, sample: dict, kept, cdr3, reduce) -> None:
    bcs = [reduce(b) for b in sample["barcodes"]]
    clones = sample["clones"]
    with open(prefix + "_toassemble_bc.fa", "w") as f:
        for i in kept:
            f.write(f">r{i:09d}\n{bcs[sample['read_group'][i]]}\n")
    with open(prefix + "_barcode_report.tsv", "w") as f:
        f.write("#barcode\tcell_type\tchain1\tchain2\tsecondary_chain1\t"
                "secondary_chain2\n")
        for cell, t in enumerate(sample["cell_clonotype"]):
            chains = [",".join([c["v"], c["d"] or "*", c["j"], c["c"],
                                cdr3[k], ".", "1", f"c{k}", "100.00", "0"])
                      for k, c in ((2 * t + i, clones[2 * t + i])
                                   for i in (0, 1))]
            f.write(f"{bcs[cell]}\t.\t{chains[0]}\t{chains[1]}\t*\t*\n")
