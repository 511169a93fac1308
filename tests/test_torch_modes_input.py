"""Barcoded and BAM input through the port on the CPU, held against the
JAX package and against the committed goldens (which the stand-ins
reproduce):

- barcoded ``run`` on tests/data/bc/ (the gold reads with ``bc.fq``'s
  barcodes and the ``bc_wl.txt`` whitelist);
- a bulk BAM from ``testing.write_standin_bam`` and the barcoded
  tests/data/bambc/bc.bam (CB/UB tags), both against the
  coordinate-header stand-in (``write_standin_references(...,
  coordinates=True)``).

tests/torch_modes_common.py says what is compared how.
"""

import os

from torch_modes_common import (  # noqa: F401  (fixtures)
    BAMBC,
    BC,
    GOLD_READS,
    assert_same_outputs,
    clear_device_env,
    coord_refs,
    device_kw,
    lines_sorted,
    module,
    one_thread,
    refs,
    run_in,
    same_as_golden,
)
from trust4_tpu_torch import testing
from trust4_tpu_torch.ops import gap_oracle


def test_bulk_bam_matches_jax(tmp_path, coord_refs, monkeypatch):
    clear_device_env(monkeypatch)
    bam = str(tmp_path / "bulk.bam")
    st = testing.write_standin_bam(bam, coord_refs[0], 800, seed=11)
    assert st["records"] == 1600 and 0 < st["mapped_records"] < 1600

    def run(pkg, out):
        module(pkg, "pipeline.run").run_trust4(
            coord_refs[0], coord_refs[1], bam_file=bam,
            output_prefix=out + "/bam", **device_kw(pkg))

    gap_oracle.reset_stats()
    dirs = run_in(tmp_path, run)
    assert gap_oracle.STATS["batches"] == 2
    names = assert_same_outputs(dirs["trust4_tpu_torch"], dirs["trust4_tpu"])
    # Paired library: both mates, and contigs with CDR3s.
    assert {"bam_toassemble_1.fq", "bam_toassemble_2.fq"} <= set(names)
    port = os.path.join(dirs["trust4_tpu_torch"], "bam")
    assert os.path.getsize(port + "_toassemble_1.fq") > 0
    assert len(lines_sorted(port + "_report.tsv")) > 1


def test_barcoded_bam_matches_jax_and_goldens(tmp_path, coord_refs,
                                              monkeypatch):
    clear_device_env(monkeypatch)

    def run(pkg, out):
        module(pkg, "pipeline.run").run_trust4(
            coord_refs[0], coord_refs[1],
            bam_file=os.path.join(BAMBC, "bc.bam"),
            output_prefix=out + "/bb", bam_barcode_field="CB",
            bam_umi_field="UB", **device_kw(pkg))

    dirs = run_in(tmp_path, run)
    names = assert_same_outputs(dirs["trust4_tpu_torch"], dirs["trust4_tpu"])
    assert "bb_barcode_report.tsv" in names
    port = os.path.join(dirs["trust4_tpu_torch"], "bb")
    for ours, gold in (("_toassemble_bc.fa", "gold_bc.fa"),
                       ("_toassemble_umi.fa", "gold_umi.fa"),
                       ("_toassemble_1.fq", "gold_1.fq"),
                       ("_final.out", "gold_final.out"),
                       ("_cdr3.out", "gold_cdr3.out")):
        same_as_golden(port + ours, os.path.join(BAMBC, gold))


def test_barcoded_run_matches_jax_and_goldens(tmp_path, refs, monkeypatch):
    clear_device_env(monkeypatch)

    def run(pkg, out):
        module(pkg, "pipeline.run").run_trust4(
            refs[0], refs[1], read1_files=[GOLD_READS[0]],
            read2_files=[GOLD_READS[1]],
            barcode_files=[os.path.join(BC, "bc.fq")],
            barcode_whitelist=os.path.join(BC, "bc_wl.txt"),
            output_prefix=out + "/bc", **device_kw(pkg))

    gap_oracle.reset_stats()
    dirs = run_in(tmp_path, run)
    assert gap_oracle.STATS["batches"] == 2
    names = assert_same_outputs(dirs["trust4_tpu_torch"], dirs["trust4_tpu"])
    assert "bc_barcode_report.tsv" in names and "bc_annot.fa" in names
    port = os.path.join(dirs["trust4_tpu_torch"], "bc")
    same_as_golden(port + "_cdr3.out", os.path.join(BC, "gold_cdr3.out"))
    for ours, gold in (("_barcode_report.tsv", "gold_barcode_report.tsv"),
                       ("_report.tsv", "gold_report.tsv"),
                       ("_barcode_airr.tsv", "gold_barcode_airr.tsv")):
        same_as_golden(port + ours, os.path.join(BC, gold), sort=True)
