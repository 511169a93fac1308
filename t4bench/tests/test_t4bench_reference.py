"""The reference against the port's CPU runs and against the control:
the reference put in the program's place passes at the configuration's
precision (2 bits a base) and fails one bit below."""

import collections
import os

import pytest

from t4bench import run
from t4bench.reference import control, judge
from t4bench_common import bench_limits, tiny_cell

# The limits of the tiny cells: the rich bulk cell's.
CONFIGS = ("bulk-se", "bulk-pe", "sc-10x-5p")
LIMITS = {c: bench_limits() for c in CONFIGS}


@pytest.mark.parametrize("config", CONFIGS)
def test_control_at_both_precisions(tmp_path, config):
    cell = tiny_cell(str(tmp_path), config, LIMITS[config])
    exact = control.control(cell, 2 ** 31 + 9, 2, str(tmp_path / "two"))
    assert exact == {k: 0.0 for k in judge.NUMBERS}
    low = control.control(cell, 2 ** 31 + 9, 1, str(tmp_path / "one"))
    failed = {k for k in judge.NUMBERS if low[k] > cell.limits[k]}
    # At one bit a base the reference keeps every read it kept and more,
    # each written with other bases, and no contig lies on a template base
    # for base (so no V call is judged): every number but v_call_wrong
    # fails.
    assert failed == set(judge.NUMBERS) - {"v_call_wrong"}, low


def test_shipping_path_on_the_cpu_is_correct(tmp_path, monkeypatch):
    """The collect-oracle path with its plain PyTorch DP (the card's path
    short of the kernel) agrees with the reference."""
    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    cell = tiny_cell(str(tmp_path), "bulk-se", LIMITS["bulk-se"])
    r = run.run_cell(cell, 2 ** 31 + 21, 0.5, False, device="cpu",
                     compile_kernels=False)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("config", ["bulk-se", "bulk-pe"])
def test_swapped_gap_counts_are_not_correct(tmp_path, monkeypatch, config):
    """The counts kernel's answer altered where it is produced: the
    shipping path on the CPU with match and mismatch swapped calls other
    V alleles, which ``v_call_wrong`` sees."""
    from t4bench import faults
    from trust4_tpu_torch.ops import dp_counts

    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    monkeypatch.setattr(dp_counts, "banded_affine_counts",
                        dp_counts.banded_affine_counts)
    faults.swap_counts()
    cell = tiny_cell(str(tmp_path), config, LIMITS[config])
    r = run.run_cell(cell, 2 ** 31 + 21, 0.5, False, device="cpu",
                     compile_kernels=False)
    assert not r["correct"], r["checks"]
    assert r["checks"]["v_call_wrong"]["value"] > \
        r["checks"]["v_call_wrong"]["limit"], r["checks"]


def test_cdr3_from_the_table_matches_the_planted(tmp_path):
    from t4bench.data import standin
    from t4bench.traffic import generator

    cell = tiny_cell(str(tmp_path), "sc-10x-5p", LIMITS["sc-10x-5p"])
    table = judge.imgt_table(standin.IMGT_TABLE)
    for s in generator.generate_pool(cell.config, cell.mix, 8,
                                     str(tmp_path / "pool")):
        for c in s["clones"]:
            assert judge.cdr3_of(c, table) == c["cdr3"]


def test_frozen_references_are_the_ports(tmp_path):
    """The frozen writer and tables give the FASTAs the port's tests
    load (trust4_tpu_torch.testing over tests/data)."""
    from t4bench.data import standin
    from trust4_tpu_torch import testing

    ours = standin.write_references(str(tmp_path / "ours"))
    theirs = testing.write_standin_references(str(tmp_path / "theirs"))
    for a, b in zip(ours, theirs):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()


GAP = "N" * judge.GAP_N


def _revcomp(seq):
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _reference(tmp_path, config):
    """One tiny sample of ``config`` and the reference's answer for it."""
    from t4bench.data import standin
    from t4bench.traffic import generator

    cell = tiny_cell(str(tmp_path), config, LIMITS[config])
    coord, _imgt = standin.write_references(str(tmp_path / "ref"))
    sample = generator.generate_pool(cell.config, cell.mix, 2 ** 31 + 31,
                                     str(tmp_path / "pool"), cell.layout)[0]
    ref = judge.Reference(sample, judge.coordinate_genes(coord),
                          judge.imgt_table(standin.IMGT_TABLE),
                          cell.config["read_length"], cell.layout)
    return ref, sample


def test_gapped_contig_in_order_is_placed(tmp_path):
    """A contig that mate scaffolding joined across a gap lies on its
    template piece by piece, on either strand, the gap up to the longest
    fragment."""
    ref, sample = _reference(tmp_path, "bulk-pe")
    top = sample["fragment_max"]
    t = sample["clones"][0]["template"]
    joined = t[:120] + GAP + t[200:320]
    widest = t[:60] + GAP + t[60 + top:120 + top]
    for contig in (joined, _revcomp(joined), widest, _revcomp(widest)):
        assert ref._placed(contig)
    assert ref._contigs([("c0", joined), ("c1", widest)]) == 0.0


def test_gapped_contig_out_of_place_is_off(tmp_path):
    """Pieces out of order, a gap wider than any fragment, or pieces of
    two templates: each such contig is off."""
    ref, sample = _reference(tmp_path, "bulk-pe")
    top = sample["fragment_max"]
    clones = sample["clones"]
    t = clones[0]["template"]
    # A piece of another clone that lies nowhere on the first template.
    other = next(s[200:320] for s in (c["template"] for c in clones[1:])
                 if all(w // 2 != 0 for w, _a in ref._spots(s[200:320])))
    for contig in (t[200:320] + GAP + t[:120],
                   t[:60] + GAP + t[61 + top:121 + top],
                   t[:120] + GAP + other, other + GAP + t[200:320]):
        assert not ref._placed(contig)
        assert not ref._placed(_revcomp(contig))
    assert ref._contigs([("c0", t[200:320] + GAP + t[:120]),
                         ("c1", t[:300])]) == 0.5


def test_single_reads_are_placed_whole(tmp_path):
    """Without pairs no contig is scaffolded: a run of N is judged as
    bases, so the joined contig that pairs would place is off."""
    ref, sample = _reference(tmp_path, "bulk-se")
    assert "fragment_max" not in sample
    t = sample["clones"][0]["template"]
    assert ref._placed(t[:240])
    assert not ref._placed(t[:120] + GAP + t[200:320])


@pytest.mark.parametrize("config", ["bulk-se", "bulk-pe"])
def test_judge_memo_same_numbers(tmp_path, monkeypatch, config):
    """A Reference places each contig once: judging the same program
    outputs a second time on it, or once on a fresh Reference, gives the
    same numbers, and the second time places nothing anew."""
    from t4bench.data import standin
    from t4bench.traffic import generator
    from trust4_tpu_torch.pipeline.run import run_trust4

    monkeypatch.setenv("TRUST4_TPU_DEVICE", "0")
    cell = tiny_cell(str(tmp_path), config, LIMITS[config])
    refs = standin.write_references(str(tmp_path / "ref"))
    sample = generator.generate_pool(cell.config, cell.mix, 2 ** 31 + 43,
                                     str(tmp_path / "pool"), cell.layout)[0]
    prefix = str(tmp_path / "out" / "S")
    os.makedirs(os.path.dirname(prefix))
    run._run_sample(run_trust4, refs, cell, sample, prefix, "cpu")

    def reference():
        return judge.Reference(sample, judge.coordinate_genes(refs[0]),
                               judge.imgt_table(standin.IMGT_TABLE),
                               cell.config["read_length"], cell.layout)

    ref = reference()
    calls = collections.Counter()
    for name in ("_find_place", "_lies_inside"):
        def counted(*args, _real=getattr(ref, name), _name=name):
            calls[(_name,) + args] += 1
            return _real(*args)
        monkeypatch.setattr(ref, name, counted)
    first = ref.judge(prefix)
    placed = dict(calls)
    assert ref.judge(prefix) == first
    assert reference().judge(prefix) == first
    assert dict(calls) == placed and set(placed.values()) == {1}
    contigs = {seq for _h, seq in judge.read_fasta(prefix + "_annot.fa")}
    assert {c[1] for c in placed if c[0] == "_lies_inside"} == contigs
    assert any(c[0] == "_find_place" for c in placed), first
