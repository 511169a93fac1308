"""The plain reference and the comparison that decides ``correct``.

The reference works out, from what the benchmark made (the samples'
reads, the planted clones and the frozen coordinate FASTA and IMGT
table), what a correct run of each sample gives, and reads the program's
output files only to judge them.  Plain Python and NumPy: it imports
nothing of the program.  What differs between read layouts (barcodes,
the report's format) is the layout module's (``layouts/<layout>.py``).

Per sample it computes five numbers, each a share (0 is perfect):

``extract_missed``  reads the reference keeps that extraction dropped.
    The reference keeps a read when it or its reverse complement shares
    a ``K``-mer with a sequence of the coordinate FASTA (for mates, when
    either mate of its fragment does: the layout's ``keep``).  The number
    is the reads it keeps that the program's extraction files (the
    layout's ``OUTPUTS`` named ``_toassemble*.fq``: ``extraction_files``)
    lack or write with other bases than the input's (either strand), and
    kept
    reads written with another cell's barcode, over the reads the
    reference keeps.
``extract_extra``  reads extraction kept that the reference does not,
    over the reads the reference does not keep: the extractor's rule is
    looser than a shared ``K``-mer and keeps some background reads.
``clone_miss``  the assembled and annotated clones.  A planted chain is
    due when at least ``MIN_SPAN`` of its reads span its CDR3 (from the V
    allele's Cys through the J allele's Trp/Phe, the anchors of the IMGT
    table) and it has at least ``MIN_READS`` reads in all (a judged group,
    such as a cell, counted apart).  A due chain is found when the
    report gives its group a chain with its CDR3 to the nucleotide and
    its J gene among the J calls (``call_ok``).  The V call is
    ``v_call_wrong``'s: a row's contig may cover too little of the V to
    tell genes apart.  Due chains not found, over the due.
``v_call_wrong``  the V allele that annotation calls, which the gap
    oracle's counts decide.  Judged are the ``_annot.fa`` contigs whose
    CDR3 is a planted chain's and that cover at least ``V_MIN`` bases of
    its V allele base for base.  A contig's call is wrong when no allele
    of its first V call has the planted allele's sequence over the
    stretch the contig covers, up to the Cys codon and aligned at it.
    Wrong calls over the judged contigs.
``contig_off``  the contigs that assembly built: an ``_annot.fa`` contig
    is off when no placement inside a planted template of the sample
    (either strand, at an offset where they share a ``K``-mer) differs
    from it in at most ``CONTIG_MISMATCH`` of its bases: the templates
    carry no indels, so a contig of their reads lies on one diagonal.
    Where the reads come in pairs (the sample names its ``fragment_max``),
    a contig that mate scaffolding joined across a gap (``GAP_N`` or more
    N) is placed piece by piece: in order on one strand of one template,
    each piece starting at most ``fragment_max`` bases past the end of
    the one before.  Off contigs over all.

The reference judges at the configuration's precision, one base of four.
``resolution=1`` computes its answers at one bit a base (purine or
pyrimidine), the precision below: the control (control.py).

The input reads are a table of rows (the layout's ``read_table``; by
default the one FASTQ ``sample["reads"]``), each with its ``read_clone``
and ``read_start``; a layout without its own hook reads and judges as a
single-end one (``hook``).
"""

from __future__ import annotations

import gzip
import os
import re
from typing import Dict, List, Optional

import numpy as np

K = 21
MIN_SPAN = 3
MIN_READS = 10
V_MIN = 100
CONTIG_MISMATCH = 0.05
NUMBERS = ("extract_missed", "extract_extra", "clone_miss", "v_call_wrong",
           "contig_off")
_CDR3_FIELD = re.compile(r"CDR3\((\d+)-(\d+)\):[0-9.]+=([ACGTN]+)")
# TRUST4's gapN: the run of N that mate scaffolding puts where it joins
# two contigs across a gap of unknown length.
GAP_N = 7
_GAP = re.compile("N{%d,}" % GAP_N)

_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
# One bit a base: purines (A, G) 0, pyrimidines (C, T) 1.
_RY = np.array([0, 1, 0, 1], np.uint8)


def _kmer_codes(seqs: np.ndarray, resolution: int) -> np.ndarray:
    """(n, L - K + 1) uint64 codes of every K-mer of each row of ``seqs``
    ((n, L) ASCII), with bits at ``resolution`` a base; a K-mer with a
    base other than ACGT gets the code 2**63 + its position, which
    matches nothing.  Built by doubling: codes of 1-, 2-, 4-, 8- and
    16-mers, then 16 + 4 + 1."""
    codes = _CODE[seqs]
    bad = codes == 255
    codes = np.where(bad, 0, codes)
    if resolution == 1:
        codes = _RY[codes]
    n, length = seqs.shape
    width = length - K + 1
    if width <= 0:
        return np.zeros((n, 0), np.uint64)
    r = np.uint64(resolution)
    by_len = {1: codes.astype(np.uint64)}
    for k in (2, 4, 8, 16):
        h = by_len[k // 2]
        w = h.shape[1] - k // 2
        by_len[k] = (h[:, :w] << (r * np.uint64(k // 2))) | h[:, k // 2:]
    out = ((by_len[16][:, :width] << (r * np.uint64(5)))
           | (by_len[4][:, 16:16 + width] << r) | by_len[1][:, 20:20 + width])
    rows = np.nonzero(bad.any(axis=1))[0]
    if len(rows):
        b = bad[rows].astype(np.int32)
        nbad = np.concatenate([np.zeros((len(rows), 1), np.int32),
                               np.cumsum(b, axis=1, dtype=np.int32)], axis=1)
        has_bad = (nbad[:, K:K + width] - nbad[:, :width]) > 0
        sub = out[rows]
        sub[has_bad] = np.uint64(1 << 63) + np.nonzero(has_bad)[1].astype(
            np.uint64)
        out[rows] = sub
    return out


def _revcomp_rows(seqs: np.ndarray) -> np.ndarray:
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    return comp[seqs[:, ::-1]]


def _rows_of(seqs: List[str]) -> List[np.ndarray]:
    return [np.frombuffer(s.upper().encode(), np.uint8)[None, :]
            for s in seqs if len(s) >= K]


def kmer_set(seqs: List[str], resolution: int = 2) -> np.ndarray:
    """Sorted unique K-mer codes of ``seqs`` on both strands."""
    parts = []
    for row in _rows_of(seqs):
        parts.append(_kmer_codes(row, resolution).ravel())
        parts.append(_kmer_codes(_revcomp_rows(row), resolution).ravel())
    if not parts:
        return np.zeros(0, np.uint64)
    codes = np.unique(np.concatenate(parts))
    return codes[codes < np.uint64(1 << 63)]


def read_fasta(path: str) -> List[tuple]:
    out, name, seq = [], None, []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(seq)))
                name, seq = line[1:].rstrip("\n"), []
            else:
                seq.append(line.strip())
    if name is not None:
        out.append((name, "".join(seq)))
    return out


def read_fastq_seqs(path: str) -> np.ndarray:
    """(n, L) ASCII rows of a FASTQ whose reads share one length."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    seqs = lines[1::4][: len(lines) // 4]
    return np.frombuffer(b"".join(seqs), np.uint8).reshape(len(seqs), -1)


def expected_kept(reads: np.ndarray, genes: np.ndarray,
                  resolution: int = 2, block: int = 16384) -> np.ndarray:
    """Whether the reference keeps each read: a K-mer of it or of its
    reverse complement in ``genes`` (a ``kmer_set`` of the coordinate
    FASTA at the same resolution, both strands: so the read's own strand
    suffices)."""
    keep = np.zeros(len(reads), bool)
    for at in range(0, len(reads), block):
        codes = _kmer_codes(reads[at:at + block], resolution)
        keep[at:at + block] = _member(codes, genes).any(axis=1)
    return keep


def _member(codes: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Whether each code is in ``table`` (sorted): a bitmap of the codes'
    top bits first, then a binary search for what passes it."""
    hit = np.zeros(codes.shape, bool)
    if len(table) == 0:
        return hit
    shift = np.uint64(max(0, int(table[-1]).bit_length() - 24))
    bitmap = np.zeros(1 << 24, bool)
    bitmap[(table >> shift).astype(np.int64)] = True
    top = codes >> shift
    cand = top < np.uint64(1 << 24)
    cand[cand] = bitmap[top[cand].astype(np.int64)]
    c = codes[cand]
    at = np.minimum(np.searchsorted(table, c), len(table) - 1)
    hit[cand] = table[at] == c
    return hit


def _one_table(sample: dict) -> np.ndarray:
    return read_fastq_seqs(sample["reads"])


def _each_alone(sample: dict, hit: np.ndarray) -> np.ndarray:
    return hit


# What a layout module that lacks a hook (layouts/__init__.py) gets: one
# single-end FASTQ, each read kept on its own hit.
_DEFAULT_HOOKS = {"read_table": _one_table, "keep": _each_alone}


def hook(layout, name: str):
    """The layout module's own ``name``, or the single-end default."""
    return getattr(layout, name, _DEFAULT_HOOKS[name])


def extraction_files(layout, prefix: str, n_rows: int) -> List[tuple]:
    """The program's files of extracted reads, the layout's ``OUTPUTS``
    named ``_toassemble*.fq``, each with the first row of the read table
    that it holds: the table splits into one equal share a file, in
    order, and a record named r<i> in a file is its row first + i."""
    names = [o for o in layout.OUTPUTS
             if o.startswith("_toassemble") and o.endswith(".fq")]
    return [(prefix + o, k * n_rows // len(names))
            for k, o in enumerate(names)]


def cdr3_of(clone: dict, table: Dict[str, tuple]) -> str:
    """The planted chain's CDR3 worked out from its template and the IMGT
    table's anchors: the V allele's Cys codon through the J allele's
    Trp/Phe codon (the J sits before the template's last ``c_len``
    bases)."""
    v_at = table[clone["v"]][1]
    j_seq, j_at = table[clone["j"]]
    t = clone["template"]
    j_start = len(t) - clone["c_len"] - len(j_seq)
    return t[v_at: j_start + j_at + 3]


def _gene(allele: str) -> str:
    return allele.split("*")[0]


def call_ok(planted: str, calls: str, table: Dict[str, tuple]) -> bool:
    """Whether a J call (alleles joined by ``|``) names the planted
    allele's gene, or an allele that ends in its sequence: duplicated
    genes cannot be told apart."""
    want = table[planted][0]
    for a in calls.split("|"):
        if _gene(a) == _gene(planted):
            return True
        if a in table and table[a][0].endswith(want):
            return True
    return False


class Reference:
    """The reference's answer for one sample, worked out once per pool
    sample and held against every run of it."""

    def __init__(self, sample: dict, genes: np.ndarray,
                 table: Dict[str, tuple], read_length: int, layout):
        self.sample = sample
        self.table = table
        self.layout = layout
        self.reads = hook(layout, "read_table")(sample)
        self.kept = hook(layout, "keep")(sample,
                                         expected_kept(self.reads, genes))
        clones = sample["clones"]
        self.cdr3 = [cdr3_of(c, table) for c in clones]
        rc, st = sample["read_clone"], sample["read_start"]
        rec = rc >= 0
        starts = np.array([table[c["v"]][1] for c in clones])
        ends = starts + np.array([len(x) for x in self.cdr3])
        spans = rec.copy()
        spans[rec] = (st[rec] <= starts[rc[rec]]) & (
            st[rec] + read_length >= ends[rc[rec]])
        # A due chain is a (group, chain) pair; a layout without groups
        # judges every chain in the one group None.
        group = sample["read_group"]
        grp = np.zeros(len(rc), np.int64) if group is None else group
        n_grp = int(grp.max()) + 1 if len(grp) else 1
        key = grp.astype(np.int64) * len(clones) + rc
        n_span = np.bincount(key[spans], minlength=n_grp * len(clones))
        n_all = np.bincount(key[rec], minlength=n_grp * len(clones))
        self.due = [(None if group is None else int(k) // len(clones),
                     int(k) % len(clones))
                    for k in np.nonzero((n_span >= MIN_SPAN)
                                        & (n_all >= MIN_READS))[0]]
        self.by_cdr3: Dict[str, List[int]] = {}
        for k, c in enumerate(self.cdr3):
            self.by_cdr3.setdefault(c, []).append(k)
        # Every K-mer of every template on both strands, sorted, with the
        # (template, strand, offset) it starts at.
        self.strands = []
        codes, where = [], []
        for t, c in enumerate(clones):
            row = np.frombuffer(c["template"].encode(), np.uint8)[None, :]
            for strand, seq in enumerate((row, _revcomp_rows(row))):
                self.strands.append(seq[0])
                kc = _kmer_codes(seq, 2).ravel()
                codes.append(kc)
                where.append(np.full(len(kc), len(self.strands) - 1))
        codes = np.concatenate(codes) if codes else np.zeros(0, np.uint64)
        where = np.concatenate(where) if where else np.zeros(0, np.int64)
        offs = np.concatenate([np.arange(len(c)) for c in
                               np.split(codes, np.cumsum(
                                   [len(x) - K + 1 for x in self.strands])[
                                       :-1])]) if len(codes) else where
        order = np.argsort(codes, kind="stable")
        self._codes, self._where, self._offs = (
            codes[order], where[order], offs[order])
        # A run judges each pool sample's outputs several times over, and
        # the program writes the same contigs each time: each contig is
        # placed once.  Both are pure in the contig and this sample.
        self._place_memo: Dict[tuple, Optional[tuple]] = {}
        self._placed_memo: Dict[str, bool] = {}

    def judge(self, prefix: str) -> Dict[str, float]:
        """The numbers for the program's outputs at ``prefix``."""
        missed, extra = self._extract(prefix)
        contigs = read_fasta(prefix + "_annot.fa")
        return {
            "extract_missed": missed,
            "extract_extra": extra,
            "clone_miss": len(self.missed_chains(prefix))
            / max(1, len(self.due)),
            "v_call_wrong": self._v_calls(contigs),
            "contig_off": self._contigs(contigs),
        }

    def _extract(self, prefix: str) -> tuple:
        got = np.zeros(len(self.kept), bool)
        names, seqs = [], []
        # A record named r<i> in a file is the table's row first + i.
        for path, first in extraction_files(self.layout, prefix,
                                            len(self.reads)):
            with open(path) as f:
                for i, line in enumerate(f):
                    if i % 4 == 0:
                        names.append(first + int(
                            line[2:].split()[0].split("/")[0]))
                    elif i % 4 == 1:
                        seqs.append(line.rstrip("\n"))
        got[names] = True
        # A read is extracted when it is written with its input's bases.
        same = np.zeros(len(self.kept), bool)
        length = self.reads.shape[1]
        whole = [i for i, q in enumerate(seqs) if len(q) == length]
        if whole:
            at = np.array([names[i] for i in whole])
            rows = np.frombuffer("".join(seqs[i] for i in whole).encode(),
                                 np.uint8).reshape(len(whole), length)
            want = self.reads[at]
            ok = (rows == want).all(axis=1) | (
                rows == _revcomp_rows(want)).all(axis=1)
            same[at[ok]] = True
        missed = int((self.kept & ~same).sum()) + self.layout.wrong_barcodes(
            prefix, self.sample, self.kept)
        extra = int((got & ~self.kept).sum())
        return (missed / max(1, int(self.kept.sum())),
                extra / max(1, int((~self.kept).sum())))

    def missed_chains(self, prefix: str) -> List[tuple]:
        """The due (group, chain) pairs that the report does not give."""
        found = self.layout.reported(prefix, self.sample)
        clones = self.sample["clones"]
        return [(g, k) for g, k in self.due
                if not any(cdr3 == self.cdr3[k]
                           and call_ok(clones[k]["j"], j, self.table)
                           for cdr3, _v, j in found.get(g, []))]

    def _v_calls(self, contigs: List[tuple]) -> float:
        judged = wrong = 0
        for header, seq in contigs:
            m = _CDR3_FIELD.search(header)
            if not m or m.group(3) not in self.by_cdr3:
                continue
            fields = header.split()
            call = fields[3].split("(")[0] if len(fields) > 3 else "*"
            for k in self.by_cdr3[m.group(3)]:
                ok = self._v_call_ok(seq, k, call)
                if ok is not None:
                    judged += 1
                    wrong += not ok
        return wrong / judged if judged else 0.0

    def _v_call_ok(self, contig: str, k: int, call: str) -> Optional[bool]:
        """Whether ``call`` names an allele with the planted V's sequence
        over the stretch of it that ``contig`` covers base for base, up to
        the end of its Cys codon (past it the V's last bases meet the
        insert); None when the contig covers less than V_MIN bases of it
        so."""
        at = self._place(contig, k)
        if at is None:
            return None
        seq, a = at
        v_seq, v_at = self.table[self.sample["clones"][k]["v"]]
        tpl = self.strands[2 * k]
        lo, hi = max(a, 0), min(a + len(seq), v_at + 3)
        if hi - lo < V_MIN or (tpl[lo:hi] != seq[lo - a:hi - a]).any():
            return None
        want = v_seq[lo:hi]
        for allele in call.split("|"):
            if allele not in self.table:
                continue
            s2, at2 = self.table[allele]
            x0, x1 = lo - v_at + at2, hi - v_at + at2
            if 0 <= x0 and x1 <= len(s2) and s2[x0:x1] == want:
                return True
        return False

    def _place(self, contig: str, k: int) -> Optional[tuple]:
        """The contig, turned to template ``k``'s forward strand, and its
        offset there, at the placement with the fewest mismatches among
        those where they share a K-mer."""
        if (contig, k) not in self._place_memo:
            self._place_memo[contig, k] = self._find_place(contig, k)
        return self._place_memo[contig, k]

    def _find_place(self, contig: str, k: int) -> Optional[tuple]:
        rows = _rows_of([contig])
        if not rows:
            return None
        fwd = rows[0][0]
        codes = _kmer_codes(rows[0], 2).ravel()
        lo = np.searchsorted(self._codes, codes, "left")
        hi = np.searchsorted(self._codes, codes, "right")
        best = None
        for i in np.nonzero(hi > lo)[0]:
            for h in range(lo[i], hi[i]):
                w = int(self._where[h])
                if w // 2 != k:
                    continue
                a = int(self._offs[h]) - int(i)
                tpl = self.strands[w]
                lo_c = max(0, -a)
                hi_c = len(fwd) - max(0, a + len(fwd) - len(tpl))
                diff = int((tpl[a + lo_c:a + hi_c] != fwd[lo_c:hi_c]).sum())
                if best is None or diff < best[0]:
                    best = (diff, w, a)
        if best is None:
            return None
        _diff, w, a = best
        if w % 2 == 0:
            return fwd, a
        return (_revcomp_rows(fwd[None, :])[0],
                len(self.strands[w]) - a - len(fwd))

    def _contigs(self, contigs: List[tuple]) -> float:
        if not contigs:
            return 1.0 if self.due else 0.0
        off = sum(not self._placed(s) for _n, s in contigs)
        return off / len(contigs)

    def _placed(self, contig: str) -> bool:
        """Whether ``contig`` lies inside a template within
        CONTIG_MISMATCH of its bases.  Where the reads come in pairs, mate
        scaffolding may have joined two contigs across a gap of unknown
        length, GAP_N or more N standing in it: such a contig lies there
        piece by piece, each piece within CONTIG_MISMATCH of its own bases,
        all on one strand of one template, each starting past the start of
        the one before and at most ``fragment_max`` bases past its end (a
        pair spans the gap)."""
        if contig not in self._placed_memo:
            self._placed_memo[contig] = self._lies_inside(contig)
        return self._placed_memo[contig]

    def _lies_inside(self, contig: str) -> bool:
        top = self.sample.get("fragment_max")
        if top is None:
            return next(self._spots(contig), None) is not None
        pieces = [p for p in _GAP.split(contig.upper()) if p]
        return bool(pieces) and any(
            self._follow(pieces[1:], w, a, a + len(pieces[0]), top)
            for w, a in self._spots(pieces[0]))

    def _follow(self, pieces: List[str], w: int, start: int, end: int,
                top: int) -> bool:
        """Whether ``pieces`` lie in order on strand ``w``, the first
        starting past ``start`` and at most ``top`` bases past ``end``."""
        return not pieces or any(
            start < a <= end + top
            and self._follow(pieces[1:], w, a, a + len(pieces[0]), top)
            for v, a in self._spots(pieces[0]) if v == w)

    def _spots(self, piece: str):
        """Each (strand, offset) at which ``piece`` lies within
        CONTIG_MISMATCH of its bases, among those where they share a
        K-mer."""
        rows = _rows_of([piece])
        if not rows:
            return
        seq = rows[0][0]
        codes = _kmer_codes(rows[0], 2).ravel()
        lo = np.searchsorted(self._codes, codes, "left")
        hi = np.searchsorted(self._codes, codes, "right")
        seen = set()
        allowed = CONTIG_MISMATCH * len(seq)
        for i in np.nonzero(hi > lo)[0]:
            for h in range(lo[i], hi[i]):
                key = (int(self._where[h]), int(self._offs[h]) - int(i))
                if key in seen:
                    continue
                seen.add(key)
                tpl = self.strands[key[0]]
                a, b = key[1], key[1] + len(seq)
                lo_c, hi_c = max(0, -a), len(seq) - max(0, b - len(tpl))
                if hi_c <= lo_c:
                    continue
                diff = int((tpl[a + lo_c: a + hi_c] != seq[lo_c:hi_c]).sum())
                if diff + lo_c + (len(seq) - hi_c) <= allowed:
                    yield key


def reduce(seq: str, resolution: int) -> str:
    """A sequence as computed at ``resolution`` bits a base: at one, each
    purine reads as A and each pyrimidine as C."""
    if resolution == 2:
        return seq
    return seq.translate(str.maketrans("GTgt", "ACac"))


def imgt_table(path: str) -> Dict[str, tuple]:
    """allele -> (degapped sequence, CDR3 anchor) from a frozen IMGT
    table (``data/imgt_ref_golden.tsv``)."""
    out = {}
    with open(path) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")
            for name in p[0].split("|"):
                out[name] = (p[1], int(p[6]))
    return out


def coordinate_genes(coord_fa: str, resolution: int = 2) -> np.ndarray:
    return kmer_set([s for _n, s in read_fasta(coord_fa)], resolution)


def worst(per_sample: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest value over the judged samples."""
    return {k: max(d[k] for d in per_sample) for k in NUMBERS}


def passes(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def missing_outputs(prefix: str, layout) -> Optional[str]:
    for suffix in layout.OUTPUTS:
        if not os.path.exists(prefix + suffix):
            return prefix + suffix
    return None
