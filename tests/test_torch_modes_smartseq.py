"""SMART-seq through the port on the CPU: the two cells of
tests/data/smartseq/ through ``run_smartseq(..., device="cpu")`` and
through ``cli smartseq --device cpu``, held against the JAX package's
``run_smartseq`` on the stand-in references and against the committed
goldens (which the stand-ins reproduce).  tests/torch_modes_common.py
says what is compared how.
"""

import os

import pytest

from torch_modes_common import (  # noqa: F401  (fixtures)
    SMARTSEQ,
    assert_same_outputs,
    cell_lists,
    clear_device_env,
    device_kw,
    lines_sorted,
    module,
    one_thread,
    refs,
    run_in,
)
from trust4_tpu_torch import cli
from trust4_tpu_torch.ops import gap_oracle


@pytest.mark.parametrize("entry", ["run_smartseq", "cli"])
def test_smartseq_matches_jax_and_goldens(tmp_path, refs, monkeypatch,
                                          entry):
    clear_device_env(monkeypatch)
    lists = cell_lists(str(tmp_path))

    def run(pkg, out):
        os.makedirs(out + "/tmp")
        if pkg == "trust4_tpu_torch" and entry == "cli":
            monkeypatch.chdir(out + "/tmp")  # the CLI's tmp_dir is "."
            assert cli.main(["smartseq", "-1", lists[0], "-2", lists[1],
                             "-f", refs[0], "--ref", refs[1], "-o",
                             out + "/ss", "--device", "cpu"]) == 0
            monkeypatch.undo()
            clear_device_env(monkeypatch)
        else:
            module(pkg, "pipeline.smartseq").run_smartseq(
                refs[0], refs[1], lists[0], lists[1],
                output_prefix=out + "/ss", tmp_dir=out + "/tmp",
                **device_kw(pkg))
        os.rmdir(out + "/tmp")  # every per-cell file was removed

    gap_oracle.reset_stats()
    dirs = run_in(tmp_path, run)
    assert gap_oracle.STATS["batches"] == 4  # two cells, two batches each
    assert assert_same_outputs(dirs["trust4_tpu_torch"], dirs["trust4_tpu"]
                               ) == ["ss_airr.tsv", "ss_annot.fa",
                                     "ss_report.tsv"]
    port = os.path.join(dirs["trust4_tpu_torch"], "ss")
    for ours, gold in (("_report.tsv", "gold_report_sorted.tsv"),
                       ("_annot.fa", "gold_annot_sorted.txt"),
                       ("_airr.tsv", "gold_airr_sorted.tsv")):
        with open(os.path.join(SMARTSEQ, gold)) as f:
            assert lines_sorted(port + ours) == f.read().splitlines(), gold
