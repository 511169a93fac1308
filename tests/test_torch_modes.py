"""The mode flags of tests/data/modes/ and the subcommands' ``--device``
through the port on the CPU, held against the JAX package on the same
stand-in references and against the committed goldens (which the
stand-ins reproduce); tests/torch_modes_common.py says what is compared
how.

- repseq: ``trim_level=2``, no mate extension (extract + assemble);
- long reads (extract + assemble);
- ``contigMinCov`` 4 on barcoded single-end reads (``bc:0:15``; a run);
- a jellyfish count file in place of the counting pass (assemble);
- ``ref_is_imgt=False`` (the coordinate file as annotation reference) and
  ``skip_read_realign=True``: runs from the assembly stage on the gold
  reads (tests/data/gold_toassemble_{1,2}.fq, the reference extractor's
  output for the example reads the goldens were made from);
- the ``assemble`` and ``annotate`` subcommands with ``--device cpu``
  against the JAX package's, and without it (the card: they and
  ``smartseq`` raise on a box without one);
- the coordinate-header stand-in keeps the sequences.
"""

import os
import shutil

import pytest

from torch_modes_common import (  # noqa: F401  (fixtures)
    DATA,
    GOLD_READS,
    MODES,
    assert_same_outputs,
    cell_lists,
    clear_device_env,
    coord_refs,
    device_kw,
    lines_sorted,
    module,
    one_thread,
    refs,
    run_in,
)
from trust4_tpu_torch import cli, testing
from trust4_tpu_torch.ops import gap_oracle


def _extract_assemble(reads, **asm_kw):
    def fn(pkg, refs, out):
        module(pkg, "pipeline.extract").run_extractor(
            refs[0], [reads], None, out + "/m_toassemble")
        module(pkg, "pipeline.assembler").Assembler(
            refs[0], output_prefix=out + "/m", **asm_kw, **device_kw(pkg)
        ).run([out + "/m_toassemble.fq"])
    return fn


def _jellyfish(pkg, refs, out):
    module(pkg, "pipeline.assembler").Assembler(
        refs[0], output_prefix=out + "/m",
        kmer_count_file=os.path.join(MODES, "jellyfish_counts.fa"),
        **device_kw(pkg),
    ).run([os.path.join(DATA, "gold_toassemble_1.fq")],
          [os.path.join(DATA, "gold_toassemble_2.fq")])


def _mincov(pkg, refs, out):
    module(pkg, "pipeline.run").run_trust4(
        refs[0], refs[1], single_files=[os.path.join(MODES, "mincov_r1.fq")],
        barcode_files=[os.path.join(MODES, "mincov_bc.fq")],
        read_format="bc:0:15", contig_min_cov=4, output_prefix=out + "/m",
        **device_kw(pkg))


def _from_assembly(**kw):
    def fn(pkg, refs, out):
        prefix = out + "/m"
        for m in (1, 2):
            shutil.copy(os.path.join(DATA, f"gold_toassemble_{m}.fq"),
                        f"{prefix}_toassemble_{m}.fq")
        imgt = refs[0] if kw.get("ref_is_imgt") is False else refs[1]
        module(pkg, "pipeline.run").run_trust4(
            refs[0], imgt, read1_files=[f"{prefix}_toassemble_1.fq"],
            read2_files=[f"{prefix}_toassemble_2.fq"], output_prefix=prefix,
            stage=1, **kw, **device_kw(pkg))
    return fn


# mode -> (run, the golden's file in tests/data/modes, our file)
CASES = {
    "repseq": (_extract_assemble(os.path.join(MODES, "repseq.fq"),
                                 trim_level=2, skip_mate_extension=True),
               "gold_repseq_final.out", "_final.out"),
    "longreads": (_extract_assemble(os.path.join(MODES, "longreads.fq")),
                  "gold_longread_final.out", "_final.out"),
    "contigMinCov": (_mincov, "gold_mincov_final.out", "_final.out"),
    "jellyfish": (_jellyfish, "jellyfish_final.out", "_final.out"),
    "notIMGT": (_from_assembly(ref_is_imgt=False), "notimgt_annot.fa",
                "_annot.fa"),
    "skipReadRealign": (_from_assembly(skip_read_realign=True),
                        "skiprealign_cdr3.out", "_cdr3.out"),
}


@pytest.mark.parametrize("mode", list(CASES))
def test_mode_matches_jax_and_golden(tmp_path, refs, monkeypatch, mode):
    clear_device_env(monkeypatch)
    run, golden, ours = CASES[mode]
    gap_oracle.reset_stats()
    dirs = run_in(tmp_path, lambda pkg, out: run(pkg, refs, out))
    # The port's gap fills went through the collect path and the DP.
    assert gap_oracle.STATS["batches"] >= 1
    assert sum(gap_oracle.STATS["tier_unique"]) > 0
    names = assert_same_outputs(dirs["trust4_tpu_torch"], dirs["trust4_tpu"])
    assert "m" + ours in names
    with open(os.path.join(dirs["trust4_tpu_torch"], "m" + ours)) as a, \
            open(os.path.join(MODES, golden)) as b:
        assert a.read() == b.read(), golden


def test_coordinate_standin_keeps_the_sequences(tmp_path, refs, coord_refs):
    plain = testing.read_coordinate_fasta(refs[0])
    coord = testing.read_coordinate_fasta(coord_refs[0])
    assert [r[:2] for r in plain] == [r[:2] for r in coord]
    with open(refs[1]) as a, open(coord_refs[1]) as b:
        assert a.read() == b.read()
    igh = [r for r in coord if r[0].startswith("IGH")]
    assert igh and all(r[2] == "chr14" and 105_856_119 <= r[3] <= 106_810_621
                       for r in igh)
    chroms = {c for c, _ in testing.BAM_CHROMS}
    assert {r[2] for r in coord} <= chroms


def test_cli_assemble_and_annotate_on_cpu(tmp_path, refs, monkeypatch,
                                          capsys):
    """``assemble`` and ``annotate --device cpu`` on the long reads give
    the JAX package's subcommands' files and annotation, through the
    plain DP (both gap batches)."""
    clear_device_env(monkeypatch)
    longreads = os.path.join(MODES, "longreads.fq")
    annotations = {}

    def run(pkg, out):
        main = module(pkg, "cli").main
        dev = ["--device", "cpu"] if pkg == "trust4_tpu_torch" else []
        prefix = out + "/lr"
        assert main(["assemble", "-f", refs[0], "-u", longreads, "-o",
                     prefix] + dev) == 0
        capsys.readouterr()
        assert main(["annotate", "-f", refs[1], "-a", prefix + "_final.out",
                     "-r", prefix + "_assembled_reads.fa", "-o", prefix]
                    + dev) == 0
        annotations[pkg] = capsys.readouterr().out

    gap_oracle.reset_stats()
    dirs = run_in(tmp_path, run)
    assert gap_oracle.STATS["batches"] == 2
    assert "lr_cdr3.out" in assert_same_outputs(dirs["trust4_tpu_torch"],
                                                dirs["trust4_tpu"])
    assert annotations["trust4_tpu_torch"] == annotations["trust4_tpu"]
    assert annotations["trust4_tpu"].count(">") > 0


def test_cli_device_defaults_to_the_card(tmp_path, refs, monkeypatch):
    """Without ``--device`` the subcommands take the card: each passes
    "cuda" on, and on a box without one the run raises, writing nothing."""
    import torch

    from trust4_tpu_torch.pipeline import annotator, assembler, smartseq

    clear_device_env(monkeypatch)
    seen = {}

    class Spy:
        def __init__(self, *a, **kw):
            seen["device"] = kw["device"]
            raise RuntimeError("spied")

    lists = cell_lists(str(tmp_path))
    argv = {
        "assemble": ["assemble", "-f", refs[0], "-u", GOLD_READS[0], "-o",
                     str(tmp_path / "a")],
        "annotate": ["annotate", "-f", refs[1], "-a",
                     os.path.join(DATA, "gold_final.out"), "-o",
                     str(tmp_path / "n")],
        "smartseq": ["smartseq", "-1", lists[0], "-2", lists[1], "-f",
                     refs[0], "--ref", refs[1], "-o", str(tmp_path / "s")],
    }
    with monkeypatch.context() as mp:
        mp.setattr(assembler, "Assembler", Spy)
        mp.setattr(annotator, "Annotator", Spy)
        mp.setattr(smartseq, "run_smartseq",
                   lambda *a, **kw: seen.update(kw) or 0)
        for name, args in argv.items():
            seen.clear()
            try:
                cli.main(args)
            except RuntimeError:
                pass
            assert seen["device"] == "cuda", name
            seen.clear()
            try:
                cli.main(args + ["--device", "cpu"])
            except RuntimeError:
                pass
            assert seen["device"] == "cpu", name
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    for name, args in argv.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(args)
    assert not os.path.exists(str(tmp_path / "a_final.out"))
    assert len(lines_sorted(str(tmp_path / "s_report.tsv"))) == 1  # header
