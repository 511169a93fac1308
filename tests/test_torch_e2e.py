"""End-to-end gate of the port on the CPU: the paired-end gold reads,
from the assembly stage on, with the stand-in references
(trust4_tpu_torch/testing.py), through ``run_trust4(device="cpu")`` in
the default gap mode (every gap fill through the plain PyTorch DP).

Every artifact must be byte-identical to tests/data/gold_* (the report
after sorting, the reference's own gate) and to the JAX package's
``run_trust4`` on the same stand-ins.
"""

import filecmp
import os
import shutil

import pytest

from trust4_tpu_torch import testing
from trust4_tpu_torch.ops import dp_counts, gap_oracle

DATA = os.path.join(os.path.dirname(__file__), "data")
ARTIFACTS = ("_raw.out", "_assembled_reads.fa", "_final.out", "_annot.fa",
             "_cdr3.out")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return testing.write_standin_references(
        str(tmp_path_factory.mktemp("standin_ref"))
    )


def _prefix(tmp_path, name):
    prefix = str(tmp_path / name / "gold")
    os.makedirs(os.path.dirname(prefix))
    for m in (1, 2):
        shutil.copy(os.path.join(DATA, f"gold_toassemble_{m}.fq"),
                    f"{prefix}_toassemble_{m}.fq")
    return prefix


def _run_kw(prefix, refs, **kw):
    return dict(coord_fasta=refs[0], imgt_fasta=refs[1],
                read1_files=[f"{prefix}_toassemble_1.fq"],
                read2_files=[f"{prefix}_toassemble_2.fq"],
                output_prefix=prefix, stage=1, **kw)


def _load_rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


@pytest.mark.parametrize("module", ["trust4_tpu_torch", "trust4_tpu"])
@pytest.mark.parametrize("dump,is_imgt", [("bcrtcr_ref_golden.tsv", False),
                                          ("imgt_ref_golden.tsv", True)])
def test_standin_references_load_to_the_dumps(refs, module, dump, is_imgt):
    """Both packages' loaders give back every dumped row: names,
    consensus, and the CDR coordinates (J genes: the CDR3 anchor only,
    the reference leaves their CDR1/2 uninitialised)."""
    import importlib

    seqset = importlib.import_module(module + ".engine.seqset")
    ss = seqset.SeqSet(9)
    ss.input_ref_fa(refs[1] if is_imgt else refs[0], is_imgt=is_imgt)
    rows = _load_rows(os.path.join(DATA, dump))
    assert len(ss.seqs) == len(rows)
    for sw, row in zip(ss.seqs, rows):
        assert (sw.name, sw.consensus) == (row[0], row[1])
        got = [sw.info[0][0], sw.info[0][1], sw.info[1][0], sw.info[1][1],
               sw.info[2][0], sw.info[2][1]]
        want = [int(x) for x in row[2:8]]
        if is_imgt and seqset.get_gene_type(row[0].split("|")[0]) == 2:
            got, want = got[4:], want[4:]
        assert got == want, row[0]


def test_gold_on_cpu_matches_goldens_and_jax(tmp_path, refs, monkeypatch):
    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    monkeypatch.delenv("TRUST4_TPU_DEVICE_CHECK", raising=False)
    monkeypatch.delenv("TRUST4_TPU_GAP_MESH", raising=False)
    from trust4_tpu.pipeline.run import run_trust4 as jax_run
    from trust4_tpu_torch.pipeline.run import run_trust4

    calls = []
    plain = dp_counts.banded_affine_counts_plain

    def spy(*args, **kw):
        calls.append(len(args[0]))
        return plain(*args, **kw)

    monkeypatch.setattr(dp_counts, "banded_affine_counts_plain", spy)
    gap_oracle.reset_stats()
    port = _prefix(tmp_path, "port")
    run_trust4(**_run_kw(port, refs, device="cpu"))
    ref = _prefix(tmp_path, "jax")
    jax_run(**_run_kw(ref, refs))

    # Both gap batches (quick annotation and annotation) went through
    # the plain DP, every unique tier job once.
    assert gap_oracle.STATS["batches"] == 2
    assert sum(calls) == sum(gap_oracle.STATS["tier_unique"]) > 0
    for suf in ARTIFACTS:
        gold = os.path.join(DATA, "gold" + suf)
        assert filecmp.cmp(port + suf, gold, shallow=False), suf
        assert filecmp.cmp(port + suf, ref + suf, shallow=False), suf
    with open(port + "_report.tsv") as a, open(
            os.path.join(DATA, "gold_report.tsv")) as b:
        assert sorted(a) == sorted(b)
    for suf in ("_report.tsv", "_airr.tsv"):
        assert filecmp.cmp(port + suf, ref + suf, shallow=False), suf


def test_card_run_raises_without_card_or_build(tmp_path, refs, monkeypatch):
    """device="cuda" (the default) on a box that cannot build or launch
    the kernel stops the run before the assembly: no CPU fallback."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    from trust4_tpu_torch.pipeline.run import run_trust4

    prefix = _prefix(tmp_path, "card")
    with pytest.raises(RuntimeError):
        run_trust4(**_run_kw(prefix, refs))
    assert not os.path.exists(prefix + "_raw.out")


def test_gap_mesh_is_not_ported(tmp_path, refs, monkeypatch):
    monkeypatch.setenv("TRUST4_TPU_GAP_MESH", "2")
    from trust4_tpu_torch.pipeline.run import run_trust4

    prefix = _prefix(tmp_path, "mesh")
    shutil.copy(os.path.join(DATA, "gold_final.out"), prefix + "_final.out")
    with pytest.raises(NotImplementedError, match="GAP_MESH"):
        run_trust4(**_run_kw(prefix, refs, device="cpu") | {"stage": 2})


def test_cli_device_flag_and_prefilter(monkeypatch):
    from trust4_tpu_torch import cli
    from trust4_tpu_torch.pipeline import run as run_mod

    seen = {}
    monkeypatch.setattr(run_mod, "run_trust4",
                        lambda *a, **kw: seen.update(kw))
    base = ["run", "-f", "coord.fa", "--ref", "imgt.fa", "-1", "a.fq",
            "-2", "b.fq"]
    assert cli.main(base) == 0 and seen["device"] == "cuda"
    assert cli.main(base + ["--device", "cpu"]) == 0
    assert seen["device"] == "cpu" and seen["use_tpu_prefilter"] is False
    assert cli.main(base + ["--tpuPrefilter", "--device", "cpu"]) == 0
    assert seen["use_tpu_prefilter"] is True and seen["device"] == "cpu"

    from trust4_tpu_torch.pipeline import extract

    for fn in ("run_extractor", "run_barcoded_extractor"):
        monkeypatch.setattr(extract, fn,
                            lambda *a, _fn=fn, **kw: seen.update(kw, fn=_fn))
    assert cli.main(["extract", "-f", "coord.fa", "-u", "r.fq",
                     "--tpuPrefilter"]) == 0
    assert seen["fn"] == "run_extractor" and seen["device"] == "cuda"
    assert cli.main(["extract", "-f", "coord.fa", "-u", "r.fq",
                     "--readFormat", "bc:0:15", "--tpuPrefilter",
                     "--device", "cpu"]) == 0
    assert seen["fn"] == "run_barcoded_extractor"
    assert seen["use_tpu_prefilter"] is True and seen["device"] == "cpu"
    with pytest.raises(SystemExit):
        cli.main(base + ["--device", "tpu"])


def test_extraction_matches_jax(tmp_path, refs):
    """Stage 0 (the copied extractor and its native filter) gives the
    JAX package's candidate reads on a seeded bulk corpus."""
    from tools.make_bench_corpus import make_corpus
    from trust4_tpu.pipeline.extract import run_extractor as jax_extract
    from trust4_tpu_torch.pipeline.extract import run_extractor

    fq = str(tmp_path / "bulk.fq")
    make_corpus(fq, n_reads=20000, ref_fa=refs[0])
    run_extractor(refs[0], [fq], None, str(tmp_path / "port"), threads=2)
    jax_extract(refs[0], [fq], None, str(tmp_path / "jax"), threads=2)
    got = str(tmp_path / "port.fq")
    assert os.path.getsize(got) > 0
    assert filecmp.cmp(got, str(tmp_path / "jax.fq"), shallow=False)
