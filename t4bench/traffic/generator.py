"""The benchmark's traffic generator: seeded samples of rearranged
receptor transcripts among background reads.

A traffic mix is a JSON file beside this one (``<traffic>.json``) of
parameters; the read layout and the laws that no mix changes (clone
sizes, error rate, loci) come from the configuration.  How a layout
lays out its reads is a module of its own (``layouts/<layout>.py``,
found by the configuration's ``layout``); this module holds what every
layout shares.

Receptor reads come from productive rearranged templates within one
locus: an IMGT V allele (its V-REGION), for IGH/TRB/TRD an IMGT D allele,
0 to ``insert_max`` random bases (as many as keep the J in the V's frame,
and no stop codon in the CDR3), an IMGT J allele and the first 150 bases
of one of the locus's C genes of the coordinate file.  The V and J alleles
are those with a CDR3 anchor (a Cys codon at the V's, a Trp or Phe codon
at the J's) whose gene the coordinate file carries, so the planted CDR3
is known: from the V's Cys through the J's Trp/Phe.  Substitutions at
``error_rate``.  Clone sizes follow a power law (weight 1/rank^zipf).
Background reads are uniform random bases.

Every sample of a pool is written gzip-compressed, as users' FASTQs are;
``generate_pool`` returns what it planted, for the reference.  Vectorised
numpy from one ``numpy.random.Generator`` per sample, so a seed gives the
same bytes everywhere.
"""

from __future__ import annotations

import gzip
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from t4bench.data import standin

C_PREFIX = 150
# How much shorter before its Cys a whole V allele may be than its gene's
# longest.
FULL_SLACK = 6
_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b
_V_ANCHOR = ("TGT", "TGC")
_J_ANCHOR = ("TGG", "TTT", "TTC")
_WITH_D = ("IGH", "TRB", "TRD")


def gene_pools() -> Dict[str, Dict[str, list]]:
    """locus -> {"V": [(allele, seq, cdr3 start)], "D": [(allele, seq)],
    "J": [(allele, seq, anchor)], "C": [(gene, seq)]}, from the frozen
    tables, in table order."""
    coord = standin.rows(standin.COORD_TABLE)
    coord_genes = {n for names, _, _ in coord for n in names.split("|")}
    pools: Dict[str, Dict[str, list]] = {}
    for names, cons, info in standin.rows(standin.IMGT_TABLE):
        for name in names.split("|"):
            if len(name) < 4 or name[3] not in "VDJ":
                continue
            kind = name[3]
            if kind == "D" and not (len(name) > 4 and name[4].isdigit()):
                continue
            p = pools.setdefault(name[:3], {"V": [], "D": [], "J": [],
                                            "C": []})
            at = info[4]
            if kind == "V":
                if (at >= 0 and cons[at:at + 3] in _V_ANCHOR
                        and name.split("*")[0] in coord_genes):
                    p["V"].append((name, cons, at))
            elif kind == "J":
                if (at >= 0 and cons[at:at + 3] in _J_ANCHOR
                        and name.split("*")[0] in coord_genes):
                    p["J"].append((name, cons, at))
            elif set(cons) <= set("ACGT"):
                p["D"].append((name, cons))
    for p in pools.values():
        # Whole V alleles only: a partial IMGT allele (one that starts
        # further into its gene than the gene's longest) is planted as
        # far as IMGT knows it, and a contig that reaches past its start
        # is rightly called as a longer allele.
        longest: Dict[str, int] = {}
        for name, _cons, at in p["V"]:
            gene = name.split("*")[0]
            longest[gene] = max(longest.get(gene, 0), at)
        p["V"] = [v for v in p["V"]
                  if v[2] >= longest[v[0].split("*")[0]] - FULL_SLACK]
    for names, cons, _ in coord:
        for name in names.split("|"):
            # A C gene: a fourth letter other than V, D and J, or IGHD with
            # no digit after it; pseudogenes (IGHGP, IGLCOR22-1) left out.
            c_gene = len(name) > 3 and (name[3] not in "VDJ" or (
                name[3] == "D" and not name[4:5].isdigit()))
            if (c_gene and name[:3] in pools and not name.endswith("P")
                    and "OR" not in name
                    and set(cons[:C_PREFIX]) <= set("ACGT")
                    and len(cons) >= C_PREFIX):
                pools[name[:3]]["C"].append((name, cons[:C_PREFIX]))
    return pools


def zipf(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


_STOPS = ("TAA", "TAG", "TGA")


def rearrangements(rng, pools, loci: List[str], insert_max: int) -> List[dict]:
    """One productive rearranged template per entry of ``loci``: the
    insert's length puts the J's anchor in the V's frame, and a draw whose
    CDR3 has a stop codon is made again."""
    out = []
    for locus in loci:
        p = pools[locus]
        for _attempt in range(1000):
            v = p["V"][int(rng.integers(len(p["V"])))]
            j = p["J"][int(rng.integers(len(p["J"])))]
            d = (p["D"][int(rng.integers(len(p["D"])))]
                 if locus in _WITH_D and p["D"] else ("", ""))
            frame = (len(v[1]) - v[2] + len(d[1]) + j[2]) % 3
            n_ins = [n for n in range(insert_max + 1)
                     if (n + frame) % 3 == 0]
            ins = _BASES[rng.integers(0, 4, n_ins[int(rng.integers(
                len(n_ins)))])].tobytes().decode()
            head = v[1] + d[1] + ins
            cdr3 = (head + j[1])[v[2]:len(head) + j[2] + 3]
            if not any(cdr3[i:i + 3] in _STOPS
                       for i in range(0, len(cdr3), 3)):
                break
        else:
            raise RuntimeError(f"no productive {locus} rearrangement drawn")
        c = p["C"][int(rng.integers(len(p["C"])))]
        template = head + j[1] + c[1]
        out.append({
            "locus": locus, "v": v[0], "d": d[0], "j": j[0], "c": c[0],
            "template": template, "c_len": len(c[1]), "cdr3": cdr3,
        })
    return out


def template_reads(rng, clones, which: np.ndarray, read_len: int, err: float,
           strand: bool):
    """(n, read_len) uint8 reads of the clones ``which`` names, uniform
    start on each template, substitutions at ``err``, a random strand when
    ``strand``; and each read's start on its template."""
    buf = np.frombuffer("".join(c["template"] for c in clones).encode(),
                        np.uint8)
    offs = np.cumsum([0] + [len(c["template"]) for c in clones])
    span = np.array([len(c["template"]) - read_len + 1 for c in clones])
    start = (rng.random(len(which)) * span[which]).astype(np.int64)
    seq = buf[(offs[which] + start)[:, None] + np.arange(read_len)]
    mut = rng.random(seq.shape, dtype=np.float32) < err
    seq[mut] = _BASES[rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)]
    rc = (rng.random(len(which)) < 0.5) if strand else np.zeros(
        len(which), bool)
    seq[rc] = revcomp(seq[rc])
    return seq, start


def revcomp(seqs: np.ndarray) -> np.ndarray:
    """The reverse complement of each row of ``seqs`` (bases)."""
    return _COMP[seqs[:, ::-1]]


def write_fastq(path: str, seqs: np.ndarray) -> None:
    """A gzip FASTQ of ``seqs`` (rows of bases), read i named r<i> in
    nine digits."""
    n, length = seqs.shape
    names = np.frombuffer(b"".join(b"@r%09d\n" % i for i in range(n)),
                          np.uint8).reshape(n, -1)
    tail = np.frombuffer(b"\n+\n" + b"I" * length + b"\n", np.uint8)
    body = np.empty((n, names.shape[1] + length + len(tail)), np.uint8)
    body[:, :names.shape[1]] = names
    body[:, names.shape[1]:names.shape[1] + length] = seqs
    body[:, names.shape[1] + length:] = tail
    with open(path, "wb") as raw, gzip.GzipFile(
            filename="", mode="wb", compresslevel=1, fileobj=raw,
            mtime=0) as f:
        f.write(body.tobytes())


def apportion(total: int, weights: np.ndarray) -> np.ndarray:
    """Whole counts summing to ``total`` in the proportions of
    ``weights``, by largest remainders: the same for every seed."""
    exact = total * weights / weights.sum()
    counts = np.floor(exact).astype(np.int64)
    rest = np.argsort(-(exact - counts), kind="stable")
    counts[rest[:total - counts.sum()]] += 1
    return counts


def spread(n: int, weights: np.ndarray) -> np.ndarray:
    """Indices of ``weights`` for ranks 0..n-1 by the golden-ratio
    sequence: in those proportions, the same for every seed."""
    cum = np.cumsum(weights / weights.sum())
    u = (np.arange(n) * 0.6180339887498949) % 1.0
    return np.minimum(np.searchsorted(cum, u, side="right"),
                      len(weights) - 1)


def bases(rng, shape) -> np.ndarray:
    return _BASES[rng.integers(0, 4, shape, dtype=np.uint8)]


def generate_pool(cfg: dict, mix: dict, seed: int, out_dir: str,
                  layout=None) -> list:
    """The ``mix["pool"]`` samples of a run under ``out_dir``/sNN, each
    from its own generator seeded by (seed, index), written on a thread
    each (numpy and zlib let the interpreter go); returns what each
    planted (the layout module's ``generate``)."""
    from t4bench import layouts

    layout = layout or layouts.load(cfg["layout"])
    pools = gene_pools()

    def one(k: int) -> dict:
        rng = np.random.default_rng([seed % 2 ** 63, k])
        d = os.path.join(out_dir, f"s{k:02d}")
        os.makedirs(d, exist_ok=True)
        return layout.generate(rng, cfg, mix, pools, d)

    with ThreadPoolExecutor(mix["pool"]) as ex:
        return list(ex.map(one, range(mix["pool"])))
