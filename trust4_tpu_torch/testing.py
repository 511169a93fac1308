"""Stand-in germline references for tests and ``chip_smoke.py``.

The pipeline needs two reference FASTAs: the V/D/J/C coordinate file
(hg38_bcrtcr.fa) and the gapped IMGT allele file (human_IMGT+C.fa).  The
repository carries what the loader made of both as dumps under
``tests/data`` (one row per loaded sequence: name, degapped consensus,
CDR1/2/3 coordinates), and this module turns them back into FASTAs that
load to exactly those rows:

* coordinate file: ``>name`` + consensus for each row of
  ``bcrtcr_ref_golden.tsv``;
* IMGT file: for each row of ``imgt_ref_golden.tsv``, one record per
  ``|``-merged name.  V genes get IMGT '.' gaps placed so that the
  loader's codon checkpoints (engine/seqset.py ``_imgt_v_cdr_coords``:
  non-gap bases before gapped indices 78, 114, 165, 195 and 309) give back
  the stored CDR1/2/3 coordinates; a V gene with no CDR3 anchor stays
  shorter than 310 gapped columns, and every V gene is padded to at least
  198 so the loader computes its coordinates.

With these files the pipeline reproduces the committed goldens
``tests/data/gold_*`` from the assembly stage on.

``write_standin_references(..., coordinates=True)`` writes the coordinate
file with BAM-extractor headers as well (``>name chrom start end
strand``; ``STANDIN_LOCI`` says where each locus lies), and
``write_standin_bam`` writes a seeded, coordinate-sorted BAM of
receptor and background pairs against those places; its receptor reads,
and the SMART-seq cells of ``write_smartseq_cell``, come from
``clone_templates``.

For extraction's candidate filter (on the threads, in the kernel's host
build, on the card): ``mix_reads`` (a bulk mix's 100-base reads),
``filter_parity_reads`` (every quirk of the filter at one read length)
and ``filter_repeats_case`` (k-mers of over 10,000 postings).
"""

from __future__ import annotations

import os
import random
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from trust4_tpu_torch.engine.seqset import get_gene_type

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
    "data",
)

# (gapped index, which stored coordinate) the loader counts bases at.
_V_CHECKPOINTS = ((78, 0), (114, 1), (165, 2), (195, 3), (309, 4))


def _rows(path: str) -> List[Tuple[str, str, List[int]]]:
    rows = []
    with open(path) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")
            rows.append((p[0], p[1], [int(x) for x in p[2:8]]))
    return rows


def gapped_v(consensus: str, info: List[int]) -> str:
    """IMGT-gapped V sequence whose checkpoint counts give back ``info``
    = [cdr1a, cdr1b, cdr2a, cdr2b, cdr3, cdr3]."""
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
        out.append(consensus[n : n + need] + "." * dots)
        pos, n = g, want[w]
    out.append(consensus[n:])
    s = "".join(out)
    s += "." * max(0, 3 * 66 - len(s))
    if info[4] < 0 and len(s) >= 3 * (104 - 1) + 1:
        raise ValueError(f"gapped V too long to keep CDR3 unset: {info}")
    return s


def rand_gap_jobs(rng, n: int, cap: int, w: int):
    """Tier-shaped DP jobs the way gap fills look: mutated copies of a
    random text (substitutions incl. N, deletions, insertions), cut so the
    band covers them, plus a few zero-length rows.  The recipe of
    tests/test_dp_pallas.py ``_rand_gap_jobs``; returns (ts, ps, t_codes
    (n, cap) int8, t_lens (n,) int32, p_codes, p_lens), pad code 5."""
    code = {c: i for i, c in enumerate("ACGTN")}
    maxd = w - 11
    ts, ps = [], []
    for _ in range(n):
        lt = int(rng.integers(1, cap + 1))
        t = "".join(rng.choice(list("ACGT"), lt))
        p = list(t)
        for _ in range(int(rng.integers(0, 5))):
            r = rng.random()
            i = int(rng.integers(0, max(1, len(p))))
            if r < 0.6 and p:
                p[i] = str(rng.choice(list("ACGTN")))
            elif r < 0.8 and len(p) > 1:
                del p[i]
            else:
                p.insert(i, str(rng.choice(list("ACGT"))))
        p = "".join(p)[:cap] or "A"
        if abs(len(p) - len(t)) > maxd:
            p = p[: len(t) + maxd] if len(p) > len(t) else p
            t = t[: len(p) + maxd]
        ts.append(t)
        ps.append(p)
    tc = np.full((n, cap), 5, np.int8)
    pc = np.full((n, cap), 5, np.int8)
    tl = np.zeros(n, np.int32)
    pl = np.zeros(n, np.int32)
    for i, (t, p) in enumerate(zip(ts, ps)):
        tc[i, : len(t)] = [code[c] for c in t]
        pc[i, : len(p)] = [code[c] for c in p]
        tl[i], pl[i] = len(t), len(p)
    for i in rng.choice(n, max(1, n // 30), replace=False):
        if rng.random() < 0.5:
            tl[i] = 0
        else:
            pl[i] = 0
    return ts, ps, tc, tl, pc, pl


# Where the coordinate stand-in puts each locus: (first three letters of
# the gene names, chromosome, first base, last base, strand).  A locus's
# records tile its span in file order, so every read mapped inside it
# overlaps a gene.  IGH fills the span that the 398 mapped chr14 records of
# tests/data/bambc/bc.bam cover; the others lie near their hg38 places,
# on chromosomes that BAM's header names (TRD inside TRA, as on hg38).
STANDIN_LOCI = (
    ("IGH", "chr14", 105_856_119, 106_810_621, "-"),
    ("IGK", "chr2", 88_857_361, 90_235_368, "-"),
    ("IGL", "chr22", 22_026_076, 22_922_913, "+"),
    ("TRA", "chr14", 21_621_904, 22_552_132, "+"),
    ("TRB", "chr7", 142_299_011, 142_813_287, "+"),
    ("TRG", "chr7", 38_240_024, 38_368_055, "-"),
)


def _coordinates(names: List[str]) -> List[str]:
    """`` chrom start end strand`` of each coordinate-file record."""
    loci = {lo[0]: lo for lo in STANDIN_LOCI}
    key = ["TRA" if n[:3] == "TRD" else n[:3] for n in names]
    total = {k: key.count(k) for k in set(key)}
    seen: Dict[str, int] = {}
    out = []
    for k in key:
        _, chrom, lo, hi, strand = loci[k]
        step = (hi - lo + 1) // total[k]
        i = seen[k] = seen.get(k, -1) + 1
        out.append(f" {chrom} {lo + i * step} {lo + (i + 1) * step - 1}"
                   f" {strand}")
    return out


def write_standin_references(out_dir: str,
                             data_dir: Optional[str] = None,
                             coordinates: bool = False
                             ) -> Tuple[str, str]:
    """Write the stand-in coordinate and IMGT FASTAs into ``out_dir``;
    returns their paths (coord_fa, imgt_fa).  ``coordinates=True`` writes
    the coordinate file as ``standin_bcrtcr_coord.fa`` with ``>name chrom
    start end strand`` headers (the BAM extractor's input); its
    sequences, and so everything but BAM extraction, are the same."""
    data_dir = data_dir or DATA_DIR
    os.makedirs(out_dir, exist_ok=True)
    coord_fa = os.path.join(
        out_dir,
        "standin_bcrtcr_coord.fa" if coordinates else "standin_bcrtcr.fa")
    imgt_fa = os.path.join(out_dir, "standin_IMGT+C.fa")
    records = [
        (name, cons)
        for names, cons, _info in _rows(
            os.path.join(data_dir, "bcrtcr_ref_golden.tsv"))
        for name in names.split("|")
    ]
    tails = (_coordinates([n for n, _ in records]) if coordinates
             else [""] * len(records))
    with open(coord_fa, "w") as f:
        for (name, cons), tail in zip(records, tails):
            f.write(f">{name}{tail}\n{cons}\n")
    with open(imgt_fa, "w") as f:
        for names, cons, info in _rows(
            os.path.join(data_dir, "imgt_ref_golden.tsv")
        ):
            first = names.split("|")[0]
            seq = gapped_v(cons, info) if get_gene_type(first) == 0 else cons
            for name in names.split("|"):
                f.write(f">{name}\n{seq}\n")
    return coord_fa, imgt_fa


# ---------------------------------------------------------------------------
# Seeded corpora: receptor clones from the stand-in genes, and a BAM writer
# (the BGZF and record framing of tools/make_bam_corpus.py).
# ---------------------------------------------------------------------------

_COMP = str.maketrans("ACGTN", "TGCAN")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def read_coordinate_fasta(path: str) -> List[Tuple[str, str, str, int]]:
    """(name, sequence, chrom, start) of each record of a coordinate
    FASTA with ``write_standin_references(coordinates=True)`` headers
    (chrom "" and start 0 where a header has no coordinates)."""
    out = []
    head, seq = None, []
    with open(path) as f:
        for line in list(f) + [">"]:
            if not line.startswith(">"):
                seq.append(line.strip().upper())
                continue
            if head is not None:
                name, chrom, start = (head + ["", "0"])[:3]
                out.append((name, "".join(seq), chrom, int(start)))
            head, seq = line[1:].split(), []
    return out


def clone_templates(coord_fa: str, n_clones: int, seed: int
                    ) -> List[Tuple[str, int, str, int]]:
    """Rearranged receptor templates from a coordinate FASTA, the recipe
    of tools/make_bench_corpus.make_barcoded_corpus: a V gene, 0-10
    random bases, a J gene and the first 150 bases of a C gene; any base
    other than ACGT drawn anew.  Returns (template, V length, V chrom, V
    start) per clone."""
    rnd = random.Random(seed)
    genes: Dict[str, list] = {"V": [], "J": [], "C": []}
    for name, seq, chrom, start in read_coordinate_fasta(coord_fa):
        seq = "".join(c if c in "ACGT" else rnd.choice("ACGT") for c in seq)
        kind = name[3] if len(name) > 3 and name[3] in "VDJ" else "C"
        if kind in genes:
            genes[kind].append((seq, chrom, start))
    out = []
    for _ in range(n_clones):
        v, chrom, start = rnd.choice(genes["V"])
        ins = "".join(rnd.choice("ACGT") for _ in range(rnd.randint(0, 10)))
        j = rnd.choice(genes["J"])[0]
        c = rnd.choice(genes["C"])[0]
        out.append((v + ins + j + c[:150], len(v), chrom, start))
    return out


def mix_reads(coord_fa: str, n: int, share: float, seed: int) -> List[str]:
    """n 100-base reads shaped like a bulk benchmark mix: a ``share`` of
    them cut from rearranged receptor templates (``clone_templates``, 200
    clones; either strand, up to two substitutions), the rest uniform
    random."""
    rng = np.random.default_rng(seed)
    templates = [t for t, *_ in clone_templates(coord_fa, 200, seed)]
    reads = [r.tobytes().decode() for r in np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n, 100))]]
    for i in np.nonzero(rng.random(n) < share)[0]:
        t = templates[int(rng.integers(len(templates)))]
        at = int(rng.integers(len(t) - 100))
        r = bytearray(t[at:at + 100].encode())
        for _ in range(int(rng.integers(3))):
            r[int(rng.integers(100))] = b"ACGT"[int(rng.integers(4))]
        r = r.decode()
        reads[i] = revcomp(r) if rng.random() < 0.5 else r
    return reads


def filter_parity_reads(seqs: List[str], templates: List[str], length: int,
                        rng) -> List[str]:
    """Reads of one length for holding a candidate filter to another:
    random ones; cut from the reference ``seqs`` and from rearranged
    receptor ``templates``, either strand, a few substitutions; those
    with one N, with several, with a byte other than ACGTN; low-complexity
    ones (runs, short repeats); and reads with a run of one base, whose
    windows are alike in a row."""
    def cut(src):
        at = int(rng.integers(max(1, len(src) - length + 1)))
        r = bytearray(src[at:at + length].ljust(length, "A").encode())
        for _ in range(int(rng.integers(4))):
            r[int(rng.integers(length))] = b"ACGT"[int(rng.integers(4))]
        r = r.decode()
        return revcomp(r) if rng.random() < 0.5 else r

    def with_bytes(r, byte, k):
        r = bytearray(r.encode())
        for _ in range(k):
            r[int(rng.integers(length))] = ord(byte)
        return r.decode()

    out = ["".join("ACGT"[int(b)] for b in rng.integers(0, 4, length))
           for _ in range(150)]
    for _ in range(150):
        out.append(cut(seqs[int(rng.integers(len(seqs)))]))
        out.append(cut(templates[int(rng.integers(len(templates)))]))
    planted = out[150:]
    for i in range(60):
        out.append(with_bytes(planted[i], "N", 1))
        out.append(with_bytes(planted[60 + i], "N", int(rng.integers(2, 6))))
        out.append(with_bytes(planted[120 + i], "acgtRY."[i % 7], 2))
    for unit in ("A", "AC", "ACG", "AAAAT", "GGGC"):
        out.append((unit * length)[:length])
        out.append(with_bytes((unit * length)[:length], "T", 3))
    for i in range(60):
        r, n = planted[i], int(rng.integers(10, 16))
        at = int(rng.integers(max(1, length - n)))
        out.append((r[:at] + "ACGT"[i % 4] * n + r[at + n:])[:length])
    return out


def filter_repeats_case(seed: int = 5) -> Tuple[List[str], List[str]]:
    """Sequences to add to an index so that some k-mers (k = 9) have more
    than 10,000 postings, and reads that reach them: a 20-base element
    as 10,001 sequences and twice in a gene of its own, which also holds
    a run of 14 A.  The reads are cut across the gene's copies (60, 100
    and 150 bases, either strand, a few substitutions), carry the element
    among random bases, or hold a few bases either side of the run of A.
    Returns (sequences, reads)."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return "".join("ACGT"[int(b)] for b in rng.integers(0, 4, n))

    rep = rand(20)
    gene = rand(60) + rep + rand(30) + rep + rand(20) + "A" * 14 + rand(60)
    run_at = gene.index("A" * 14)
    reads = []
    for length in (60, 100, 150):
        for _ in range(200):
            at = int(rng.integers(len(gene) - length + 1))
            r = bytearray(gene[at:at + length].encode())
            for _ in range(int(rng.integers(3))):
                r[int(rng.integers(length))] = b"ACGT"[int(rng.integers(4))]
            r = r.decode()
            reads.append(revcomp(r) if rng.random() < 0.5 else r)
        for _ in range(50):
            at = int(rng.integers(length - 20))
            reads.append((rand(at) + rep + rand(length))[:length])
        for _ in range(100):
            lo = run_at - int(rng.integers(0, 12))
            hi = run_at + 14 + int(rng.integers(0, 12))
            at = int(rng.integers(length - (hi - lo)))
            reads.append((rand(at) + gene[lo:hi] + rand(length))[:length])
    return [gene] + [rep] * 10_001, reads


def bgzf_block(data: bytes, level: int = 6) -> bytes:
    """One BGZF block (at most 64 KiB of data)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    hdr = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67,
                      2, len(comp) + 25)
    return hdr + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                                    len(data))


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
# Base -> 4-bit BAM code (anything else N, 15); Phred+33 -> Phred (cap 93).
_SEQ_CODE = bytes(
    "=ACMGRSVTWYHKDBN".find(chr(c)) % 16 if chr(c) in "=ACMGRSVTWYHKDB"
    else 15 for c in range(256))
_QUAL_CODE = bytes(min(93, max(0, c - 33)) for c in range(256))


def z_tag(tag: str, val: str) -> bytes:
    return tag.encode() + b"Z" + val.encode() + b"\x00"


def bam_record(name: str, flag: int, refid: int, pos: int, mapq: int,
               cigar_ops, seq: str, qual: str, mrefid: int, mpos: int,
               tlen: int, tags: bytes = b"") -> bytes:
    """One BAM alignment record (bin 0: the readers ignore it); ``seq``
    and ``qual`` as stored, i.e. on the forward strand."""
    nm = name.encode() + b"\x00"
    cig = b"".join(struct.pack("<I", (ln << 4) | op) for ln, op in cigar_ops)
    codes = np.frombuffer(seq.encode().translate(_SEQ_CODE) + b"\x00",
                          np.uint8)
    sb = ((codes[0:-1:2] << 4) | codes[1::2]).tobytes()
    qb = qual.encode().translate(_QUAL_CODE)
    body = struct.pack("<iiBBHHHiiii", refid, pos, len(nm), mapq, 0,
                       len(cigar_ops), flag, len(seq), mrefid, mpos, tlen)
    body += nm + cig + sb + qb + tags
    return struct.pack("<i", len(body)) + body


# The chromosomes of write_standin_bam's header (hg38 lengths): the
# stand-in loci's, chr1 for mapped background, and an alternative contig
# (the extractor tests reads placed there by sequence).
BAM_CHROMS = (("chr1", 248_956_422), ("chr2", 242_193_529),
              ("chr7", 159_345_973), ("chr14", 107_043_718),
              ("chr22", 50_818_468), ("chr14_KI270846v1_alt", 1_351_493))


def write_standin_bam(path: str, coord_fa: str, n_pairs: int, seed: int,
                      receptor_frac: float = 0.25, barcodes: bool = False,
                      n_cells: int = 200, read_len: int = 100,
                      n_clones: int = 150) -> Dict[str, int]:
    """A coordinate-sorted paired-end BAM of ``n_pairs`` fragments of
    120-300 bases, drawn from ``seed``: ``receptor_frac`` of them from
    ``clone_templates(coord_fa, n_clones, seed)`` with 0.5% substitutions,
    the rest random.  Receptor pairs are 40% mapped at their V gene's
    place in ``coord_fa`` (a coordinate stand-in), 10% on the alternative
    contig and 50% unmapped; background pairs half mapped on chr1, half
    unmapped.  Unmapped pairs follow the mapped records, mates adjacent.
    ``barcodes`` adds CB (one of ``n_cells`` 16-base barcodes) and UB (10
    bases) tags to both mates.  Returns the counts of what it wrote."""
    rng = np.random.default_rng(seed)
    rnd = random.Random(seed)
    clones = clone_templates(coord_fa, n_clones, seed)
    tid = {c: i for i, (c, _) in enumerate(BAM_CHROMS)}
    alt = tid["chr14_KI270846v1_alt"]
    cells = ["".join(rnd.choice("ACGT") for _ in range(16))
             for _ in range(n_cells)]
    bases = np.frombuffer(b"ACGT", np.uint8)
    L = read_len
    q = "I" * L
    mapped, unmapped = [], []
    n_rec = 0
    for n in range(n_pairs):
        name = f"bm{n}"
        receptor = rng.random() < receptor_frac
        if receptor:
            full, v_len, chrom, v_start = clones[int(rng.integers(len(clones)))]
            flen = int(rng.integers(L + 20, min(300, len(full)) + 1))
            st = int(rng.integers(0, len(full) - flen + 1))
            arr = np.frombuffer(full[st:st + flen].encode(), np.uint8).copy()
            mut = rng.random(flen) < 0.005
            arr[mut] = bases[rng.integers(0, 4, int(mut.sum()))]
        else:
            flen = int(rng.integers(L + 20, 301))
            arr = bases[rng.integers(0, 4, flen)]
        frag = arr.tobytes().decode()
        tags = b""
        if barcodes:
            umi = bases[rng.integers(0, 4, 10)].tobytes().decode()
            tags = z_tag("CB", cells[int(rng.integers(n_cells))]) + z_tag(
                "UB", umi)
        place = rng.random()
        if receptor and place < 0.4 and chrom in tid:
            ref, pos = tid[chrom], v_start - 1 + min(st, v_len)
        elif receptor and place < 0.5:
            ref, pos = alt, int(rng.integers(0, BAM_CHROMS[alt][1] - 300))
        elif not receptor and place < 0.5:
            ref, pos = 0, int(rng.integers(1000, 90_000_000))
        else:
            ref = -1
        r1, r2 = frag[:L], frag[-L:]  # r2 as stored: the forward strand
        if ref >= 0:
            mpos = pos + flen - L
            mapped.append((ref, pos, n, bam_record(
                name, 0x63, ref, pos, 60, [(L, 0)], r1, q, ref, mpos, flen,
                tags)))
            mapped.append((ref, mpos, n, bam_record(
                name, 0x93, ref, mpos, 60, [(L, 0)], r2, q, ref, pos, -flen,
                tags)))
        else:
            unmapped.append(bam_record(name, 0x4D, -1, -1, 0, [], r1, q, -1,
                                       -1, 0, tags))
            unmapped.append(bam_record(name, 0x8D, -1, -1, 0, [],
                                       revcomp(r2), q, -1, -1, 0, tags))
        n_rec += 2
    mapped.sort(key=lambda r: r[:3])
    hdr_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{c}\tLN:{ln}\n" for c, ln in BAM_CHROMS)
    header = (b"BAM\x01" + struct.pack("<i", len(hdr_text))
              + hdr_text.encode() + struct.pack("<i", len(BAM_CHROMS)))
    for c, ln in BAM_CHROMS:
        header += struct.pack("<i", len(c) + 1) + c.encode() + b"\x00"
        header += struct.pack("<i", ln)
    with open(path, "wb") as out:
        out.write(bgzf_block(header))
        buf = bytearray()
        for rec in [r[3] for r in mapped] + unmapped:
            if len(buf) + len(rec) > 0xFF00:
                out.write(bgzf_block(bytes(buf)))
                buf.clear()
            buf += rec
        if buf:
            out.write(bgzf_block(bytes(buf)))
        out.write(BGZF_EOF)
    return {"pairs": n_pairs, "records": n_rec,
            "mapped_records": len(mapped), "unmapped_records": len(unmapped)}


def write_smartseq_cell(r1_path: str, r2_path: str, coord_fa: str,
                        n_pairs: int, seed: int, receptor_frac: float = 0.2,
                        n_chains: int = 2, read_len: int = 100) -> None:
    """One SMART-seq cell as paired FASTQs: ``n_pairs`` fragments of
    150-300 bases drawn from ``seed``, ``receptor_frac`` of them from the
    cell's ``n_chains`` receptor templates (``clone_templates(coord_fa,
    n_chains, seed)``, 0.5% substitutions), the rest random; read 2 is the
    reverse complement of the fragment's end."""
    rng = np.random.default_rng(seed)
    chains = clone_templates(coord_fa, n_chains, seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    L = read_len
    q = "I" * L
    with open(r1_path, "w") as f1, open(r2_path, "w") as f2:
        for n in range(n_pairs):
            if rng.random() < receptor_frac:
                full = chains[int(rng.integers(n_chains))][0]
                flen = int(rng.integers(min(150, len(full)),
                                        min(300, len(full)) + 1))
                st = int(rng.integers(0, len(full) - flen + 1))
                arr = np.frombuffer(full[st:st + flen].encode(),
                                    np.uint8).copy()
                mut = rng.random(flen) < 0.005
                arr[mut] = bases[rng.integers(0, 4, int(mut.sum()))]
            else:
                arr = bases[rng.integers(0, 4, int(rng.integers(150, 301)))]
            frag = arr.tobytes().decode()
            f1.write(f"@c{seed}_{n}/1\n{frag[:L]}\n+\n{q}\n")
            f2.write(f"@c{seed}_{n}/2\n{revcomp(frag[-L:])}\n+\n{q}\n")
