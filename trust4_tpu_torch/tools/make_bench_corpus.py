"""Deterministic 100k-read bulk RNA-seq-like benchmark corpus.

Mirrors the round-1 at-scale differential recipe: a small fraction of
reads are 100bp windows of the V/D/J/C germline reference (with point
mutations and random strand), the rest uniform background — so the
extraction stage sees realistic candidate density (~5%) and the
assembler/annotator see receptor-derived reads it can assemble into
CDR3-bearing contigs.  Seeded, so every machine generates the same file.

The port's copy of tools/make_bench_corpus.py (numpy only): the same
draws, so the same seed and reference write the same bytes.  The
reference FASTA has no default here; every caller names it.

Usage: python -m trust4_tpu_torch.tools.make_bench_corpus OUT.fq REF.fa
    [N_READS] [SEED]
"""

import sys

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def load_refs(path):
    seqs = []
    cur = []
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
    return [s for s in seqs if len(s) >= 120]


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


def make_corpus(out_path, n_reads=100_000, seed=20260816, *, ref_fa,
                read_len=100,
                receptor_frac=0.05, mut_rate=0.01):
    rng = np.random.default_rng(seed)
    refs = load_refs(ref_fa)
    qual = "I" * read_len
    is_receptor = rng.random(n_reads) < receptor_frac
    # background reads in one vectorized draw
    bg = BASES[rng.integers(0, 4, size=(n_reads, read_len))]
    with open(out_path, "w") as f:
        for i in range(n_reads):
            if is_receptor[i]:
                ref = refs[int(rng.integers(0, len(refs)))]
                if len(ref) > read_len:
                    at = int(rng.integers(0, len(ref) - read_len))
                    seq = ref[at : at + read_len]
                else:
                    seq = ref[:read_len]
                arr = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
                muts = rng.random(len(arr)) < mut_rate
                arr[muts] = BASES[rng.integers(0, 4, size=int(muts.sum()))]
                seq = arr.tobytes().decode()
                seq = seq.replace(".", "A")
                if rng.random() < 0.5:
                    seq = revcomp(seq)
            else:
                seq = bg[i].tobytes().decode()
            f.write(f"@r{i}\n{seq}\n+\n{qual[: len(seq)]}\n")


def make_barcoded_corpus(out_reads, out_bc, n_cells=1000, seed=20260817, *,
                         ref_fa, read_len=100, n_clones=300, err=0.005):
    """Deterministic 10x-style single-cell corpus: V(+ins)+J+C clone
    templates, 1-3 clones per cell, 10-35 reads per clone, 16bp cell
    barcode + 10bp UMI in a side file (readFormat bc:0:15,um:16:25).
    ~45k-70k reads at the defaults — the single-cell-scale benchmark the
    bulk corpus can't exercise (per-barcode assembly + 10k+ contigs)."""
    import random

    random.seed(seed)
    refs_v, refs_j, refs_c = [], [], []
    cur_name = None
    cur = []

    def _flush():
        if cur_name is None:
            return
        s = "".join(cur)
        s = "".join(
            c if c in "ACGT" else random.choice("ACGT") for c in s.upper()
        )
        if len(cur_name) > 3 and cur_name[3] == "V":
            refs_v.append(s)
        elif len(cur_name) > 3 and cur_name[3] == "J":
            refs_j.append(s)
        elif len(cur_name) <= 3 or cur_name[3] not in "VDJ":
            refs_c.append(s)

    with open(ref_fa) as f:
        for line in f:
            if line.startswith(">"):
                _flush()
                cur_name = line[1:].split()[0]
                cur = []
            else:
                cur.append(line.strip())
    _flush()  # the last record (the loop only flushes on the NEXT header)
    clones = []
    for _ in range(n_clones):
        v, j, c = (
            random.choice(refs_v), random.choice(refs_j),
            random.choice(refs_c),
        )
        ins = "".join(
            random.choice("ACGT") for _ in range(random.randint(0, 10))
        )
        clones.append(v + ins + j + c[:150])
    n = 0
    with open(out_reads, "w") as r1, open(out_bc, "w") as bc:
        for _cell in range(n_cells):
            cb = "".join(random.choice("ACGT") for _ in range(16))
            for full in random.sample(clones, random.randint(1, 3)):
                for _ in range(random.randint(10, 35)):
                    st = random.randint(0, len(full) - read_len)
                    rd = list(full[st : st + read_len])
                    for i in range(len(rd)):
                        if random.random() < err:
                            rd[i] = random.choice("ACGTN")
                    q = "".join(
                        random.choice("FGHI") for _ in range(read_len)
                    )
                    r1.write(f"@bz{n}\n{''.join(rd)}\n+\n{q}\n")
                    umi = "".join(
                        random.choice("ACGT") for _ in range(10)
                    )
                    bc.write(f"@bz{n}\n{cb}{umi}\n+\n{'I' * 26}\n")
                    n += 1
    return n


if __name__ == "__main__":
    if len(sys.argv) < 3:
        sys.exit(__doc__.rsplit("\n\n", 1)[-1])
    out, ref = sys.argv[1], sys.argv[2]
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 100_000
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else 20260816
    make_corpus(out, n, seed, ref_fa=ref)
    print(out)
