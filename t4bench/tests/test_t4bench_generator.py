"""The traffic generator: seeded, sized alike for every seed, planted
receptor reads from productive rearrangements within one locus, the
paired-end and the 10x read layouts."""

import gzip
import json
import os

import numpy as np
import pytest

from t4bench.traffic import generator
from t4bench_common import ROOT, TINY

_STOPS = ("TAA", "TAG", "TGA")


def _config(name):
    with open(os.path.join(ROOT, "t4bench", "configs", name + ".json")) as f:
        return json.load(f)


def _reads(path):
    with gzip.open(path, "rt") as f:
        lines = f.read().split("\n")
    return lines[0::4][:len(lines) // 4], lines[1::4][:len(lines) // 4]


@pytest.mark.parametrize("config", ["bulk-se", "bulk-pe", "sc-10x-5p"])
def test_same_seed_same_bytes(tmp_path, config):
    cfg, mix = _config(config), TINY[config]
    a = generator.generate_pool(cfg, mix, 2 ** 31 + 77, str(tmp_path / "a"))
    b = generator.generate_pool(cfg, mix, 2 ** 31 + 77, str(tmp_path / "b"))
    c = generator.generate_pool(cfg, mix, 5, str(tmp_path / "c"))
    for x, y, z in zip(a, b, c):
        for key in x["files"]:
            with open(x["files"][key], "rb") as f1, \
                    open(y["files"][key], "rb") as f2, \
                    open(z["files"][key], "rb") as f3:
                d1, d2, d3 = f1.read(), f2.read(), f3.read()
            assert d1 == d2
            assert d1 != d3
        # Another seed, the same sizes.
        assert x["n_reads"] == z["n_reads"]
        assert (np.bincount(x["read_clone"][x["read_clone"] >= 0])
                .tolist() == np.bincount(
                    z["read_clone"][z["read_clone"] >= 0]).tolist()) or \
            config == "sc-10x-5p"
        assert [c["locus"] for c in x["clones"]] == [
            c["locus"] for c in z["clones"]]


@pytest.mark.parametrize("config", ["bulk-se", "sc-10x-5p"])
def test_reads_and_receptor_share(tmp_path, config):
    cfg, mix = _config(config), TINY[config]
    for s in generator.generate_pool(cfg, mix, 99, str(tmp_path)):
        names, seqs = _reads(s["reads"])
        assert len(seqs) == s["n_reads"]
        assert {len(x) for x in seqs} == {cfg["read_length"]}
        assert set("".join(seqs)) <= set("ACGT")
        assert names[:2] == ["@r000000000", "@r000000001"]
        share = (s["read_clone"] >= 0).mean()
        assert share == pytest.approx(mix["receptor_share"], abs=0.01)
        # Each receptor read is its template's bases at its start, within
        # the error rate, on either strand for bulk.
        comp = str.maketrans("ACGT", "TGCA")
        bad = 0
        for i in np.nonzero(s["read_clone"] >= 0)[0][:300]:
            t = s["clones"][s["read_clone"][i]]["template"]
            st = s["read_start"][i]
            want = t[st:st + cfg["read_length"]]
            got = seqs[i]
            if config == "bulk-se" and sum(
                    a != b for a, b in zip(got, want)) > 5:
                got = got.translate(comp)[::-1]
            bad += sum(a != b for a, b in zip(got, want)) > 5
        assert bad == 0


def test_rearrangements_locus_consistent_and_productive(tmp_path):
    for config in ("bulk-se", "sc-10x-5p"):
        cfg, mix = _config(config), dict(TINY[config], pool=1)
        mix = dict(mix, clones=200, clonotypes=100)
        s = generator.generate_pool(cfg, mix, 3, str(tmp_path / config))[0]
        for c in s["clones"]:
            assert c["v"][:3] == c["j"][:3] == c["locus"]
            assert c["d"] == "" or c["d"][:3] == c["locus"]
            assert c["d"] == "" or c["locus"] in ("IGH", "TRB", "TRD")
            assert c["v"].split("*")[0][3] == "V"
            assert c["j"].split("*")[0][3] == "J"
            cdr3 = c["cdr3"]
            assert cdr3[:3] in ("TGT", "TGC")
            assert cdr3[-3:] in ("TGG", "TTT", "TTC")
            assert len(cdr3) % 3 == 0
            assert not any(cdr3[i:i + 3] in _STOPS
                           for i in range(0, len(cdr3), 3))
            assert c["template"].endswith(
                c["template"][-c["c_len"]:]) and c["c_len"] == 150


def test_only_whole_v_alleles_are_planted():
    """No V allele starts further into its gene than the gene's longest
    (less the slack), so a contig past a template's start is not a
    longer allele's."""
    from t4bench.data import standin

    longest = {}
    for names, cons, info in standin.rows(standin.IMGT_TABLE):
        for name in names.split("|"):
            if name[3:4] == "V" and info[4] >= 0:
                gene = name.split("*")[0]
                longest[gene] = max(longest.get(gene, 0), info[4])
    pools = generator.gene_pools()
    n = 0
    for p in pools.values():
        for name, _seq, at in p["V"]:
            assert at >= longest[name.split("*")[0]] - generator.FULL_SLACK
            n += 1
    assert n > 500


def test_tenx_layout(tmp_path):
    cfg, mix = _config("sc-10x-5p"), TINY["sc-10x-5p"]
    for s in generator.generate_pool(cfg, mix, 12, str(tmp_path)):
        n1, r1 = _reads(s["files"]["barcode"])
        n2, r2 = _reads(s["files"]["cdna"])
        assert n1 == n2
        assert {len(x) for x in r1} == {cfg["barcode_length"]
                                        + cfg["umi_length"]}
        bcs = s["barcodes"]
        assert len(bcs) == mix["cells_per_sample"] == len(set(bcs))
        for i, x in enumerate(r1):
            assert x[:16] == bcs[s["read_group"][i]]
        # One clonotype a cell: a chain pair of one receptor type.
        for cell in range(len(bcs)):
            chains = {int(k) for k in s["read_clone"][
                (s["read_group"] == cell) & (s["read_clone"] >= 0)]}
            t = s["cell_clonotype"][cell]
            assert chains == {2 * t, 2 * t + 1}
            loci = {s["clones"][k]["locus"] for k in chains}
            assert loci in ({"TRB", "TRA"}, {"IGH", "IGK"}, {"IGH", "IGL"})
            per = [(s["read_clone"] == k)[s["read_group"] == cell].sum()
                   for k in sorted(chains)]
            assert all(10 <= p <= 35 for p in per)


def test_paired_layout(tmp_path):
    """Fragment i's mates are record i of each file, on one template and
    facing each other: the forward mate's start first, the fragment
    between a read's length and the template's; some mates overlap."""
    cfg, mix = _config("bulk-pe"), TINY["bulk-pe"]
    n, length = mix["fragments_per_sample"], cfg["read_length"]
    comp = str.maketrans("ACGT", "TGCA")
    for s in generator.generate_pool(cfg, mix, 31, str(tmp_path)):
        assert s["reads"] == [s["files"]["read1"], s["files"]["read2"]]
        (n1, r1), (n2, r2) = (_reads(p) for p in s["reads"])
        assert n1 == n2 and len(r1) == n and s["n_reads"] == 2 * n
        assert {len(x) for x in r1 + r2} == {length}
        assert set("".join(r1 + r2)) <= set("ACGT")
        rc = s["read_clone"]
        assert (rc[:n] == rc[n:]).all()
        assert (rc >= 0).mean() == pytest.approx(mix["receptor_share"],
                                                 abs=0.01)
        overlap = 0
        for i in np.nonzero(rc[:n] >= 0)[0][:300]:
            t = s["clones"][rc[i]]["template"]
            placed = []
            for m, seq in ((0, r1[i]), (1, r2[i])):
                st = s["read_start"][m * n + i]
                want = t[st:st + length]
                fwd = sum(a != b for a, b in zip(seq, want))
                rev = sum(a != b for a, b in
                          zip(seq.translate(comp)[::-1], want))
                assert min(fwd, rev) <= 5
                placed.append((fwd < rev, st))
            (f1, s1), (f2, s2) = placed
            assert f1 != f2
            first, last = (s1, s2) if f1 else (s2, s1)
            assert 0 <= first <= last
            assert length <= last + length - first <= len(t)
            overlap += last - first < length
        assert 0 < overlap < 300
