"""The port's bench (``python -m trust4_tpu_torch.bench``) on the CPU:
end to end at 2,000 reads with ``--device cpu`` on the stand-ins (one
round, the barcoded A/B at a few dozen cells, the scale run gated off),
its identity helper, its wedge rule, and its refusal to run without a
card unless asked for the CPU.  The bench's bulk corpus is also run
through the JAX package, whose artifacts must equal the bench's.
"""

import contextlib
import io
import json
import os

import pytest

from trust4_tpu_torch import bench

BENCH_ARGS = ["--device", "cpu", "--reads", "2000", "--rounds", "1",
              "--reps", "1", "--bc-cells", "16", "--dp-n", "64"]


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """One bench run, its work directory kept: (record, stdout, stderr,
    work)."""
    work = str(tmp_path_factory.mktemp("bench"))
    mp = pytest.MonkeyPatch()
    mp.setenv("T4BENCH_SCALE", "0")
    mp.delenv("T4BENCH_BARCODED", raising=False)
    for env in ("TRUST4_TPU_DEVICE", "TRUST4_TPU_DEVICE_CHECK",
                "TRUST4_TPU_GAP_MESH", "TRUST4_TPU_GAP_TEST",
                "TRUST4_REF_DIR"):
        mp.delenv(env, raising=False)
    # The runs' plain DP on two torch threads: an OpenMP team of every core
    # beside other busy processes (pytest-xdist workers) stalls at its
    # barriers.
    mp.setenv("OMP_NUM_THREADS", "2")
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rec = bench.main(BENCH_ARGS + ["--work", work])
    finally:
        mp.undo()
    return rec, out.getvalue(), err.getvalue(), work


def test_last_line_is_bench_py_json(ran):
    rec, out, _err, _work = ran
    lines = out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "e2e_cdr3_wallclock_100k_bulk"
    assert last["value"] == round(rec["bulk"]["t1"]["best_s"]["default"], 2)
    assert last["value"] > 0
    assert last["vs_baseline"] == 0.0  # no reference binaries here
    assert lines[-2] == f"cpu: {os.cpu_count()} cores"


def test_every_part_ran_and_every_run_was_held(ran):
    rec, _out, err, _work = ran
    assert rec["references"] == "stand-ins"
    # One round of default and off at -t 1 and at -t N: four runs, three
    # held against the first off run; the barcoded rep likewise, with the
    # wedge rule's rerun (the plain DP is slower than 3x the native one
    # here) held too.
    assert rec["bulk"]["held"] == 3
    for t in ("t1", f"t{os.cpu_count()}"):
        assert set(rec["bulk"][t]["walls_s"]) == {"default", "off"}
        stages = rec["bulk"][t]["stage_medians_s"]["default"]
        assert {"extract", "assemble", "annotate", "report",
                "boot"} <= set(stages)
    bc = rec["barcoded"]
    assert bc["cells"] == 16 and bc["reads"] > 0
    assert bc["held"] == 1 + len(bc["wedged"])
    assert "scale" not in rec
    assert "897k scale run skipped: T4BENCH_SCALE=0" in err
    assert rec["dp"]["cells_per_s"] > 0
    assert rec["extract_reads_per_s"] > 0
    assert set(rec["import_wall_s"]) == {"cli", "torch", "both"}
    for walls in rec["import_wall_s"].values():
        assert len(walls) == 3 and min(walls) > 0
    for line in ("identity bulk: 3 of 4", "identity barcoded:",
                 "one launch from numpy", "tier-2 launch",
                 "import wall cli", "import wall torch", "import wall both"):
        assert line in err, line


def test_every_run_carries_its_boot_line(ran):
    """Each timed run's [boot] line is in the record: in the shipping
    mode the boot thread loaded torch, with TRUST4_TPU_DEVICE=0 nothing
    did; every run's line is relayed."""
    rec, _out, err, _work = ran
    for t in ("t1", f"t{os.cpu_count()}"):
        boots = rec["bulk"][t]["device_boot"]
        assert len(boots["default"]) == len(boots["off"]) == 1
        for b in boots["default"]:
            assert b["loaded_by"] == bench.BOOT_THREAD + "cpu"
            assert b["import_s"] > 0 and b["ready_wait_s"] >= 0
        for b in boots["off"]:
            assert b == {"loaded_by": "none", "import_s": 0.0,
                         "ready_wait_s": 0.0}
    # 4 bulk runs, the barcoded rep's 2 and its wedge reruns.
    n_runs = 6 + len(rec["barcoded"]["wedged"])
    assert err.count("[boot] torch_loaded_by=") == n_runs
    assert err.count("[boot] torch_loaded_by=none ") == 3


@pytest.mark.parametrize("mode,line,ok", [
    ("0", "[boot] torch_loaded_by=none import_s=0.000 ready_wait_s=0.000",
     True),
    ("0", "[boot] torch_loaded_by=MainThread import_s=2.1 ready_wait_s=0",
     False),
    ("1", "[boot] torch_loaded_by=trust4-gap-prewarm-cuda:0 import_s=5.2 "
     "ready_wait_s=0.4", True),
    ("1", "[boot] torch_loaded_by=elsewhere import_s=0.000 "
     "ready_wait_s=0.000", False),
    ("1", "TRUST4 finishes.", False),
])
def test_device_boot_holds_each_mode(mode, line, ok):
    if ok:
        assert bench.device_boot("x\n" + line + "\n", mode)["import_s"] >= 0
    else:
        with pytest.raises(RuntimeError):
            bench.device_boot(line, mode)


def test_bench_corpus_equals_the_jax_package(ran, tmp_path, monkeypatch):
    """The bench's first TRUST4_TPU_DEVICE=0 run (the one every timed run
    was held to) against the JAX package's run_trust4 on the same corpus
    and stand-ins (its default, the native CPU DP)."""
    _rec, _out, _err, work = ran
    from trust4_tpu.pipeline.run import run_trust4

    for env in ("TRUST4_TPU_DEVICE", "TRUST4_TPU_DEVICE_CHECK",
                "TRUST4_TPU_GAP_MESH"):
        monkeypatch.delenv(env, raising=False)
    ref = os.path.join(work, "ref")
    prefix = str(tmp_path / "jax")
    run_trust4(coord_fasta=os.path.join(ref, "standin_bcrtcr.fa"),
               imgt_fasta=os.path.join(ref, "standin_IMGT+C.fa"),
               single_files=[os.path.join(work, "bulk_reads.fq")],
               output_prefix=prefix, threads=2)
    port = os.path.join(work, "bulk", "off_t1_0", "b")
    bench.same_outputs(prefix, port)
    for suf in ("_final.out", "_annot.fa"):
        assert os.path.getsize(port + suf) > 0, suf


def _artifacts(d, name="run"):
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, name)
    for suf in bench.ARTIFACTS:
        with open(prefix + suf, "w") as f:
            f.write(f"{suf} line 1\n{suf} line 2\n")
    for suf in bench.SORTED_TABLES:
        with open(prefix + suf, "w") as f:
            f.write("#header\nrow a\nrow b\nrow c\n")
    return prefix


def test_identity_raises_on_one_flipped_byte_in_cdr3(tmp_path):
    base = _artifacts(str(tmp_path / "base"))
    other = _artifacts(str(tmp_path / "other"))
    bench.same_outputs(other, base)
    with open(other + "_cdr3.out", "r+b") as f:
        f.seek(3)
        byte = f.read(1)
        f.seek(3)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(bench.OutputMismatch, match="_cdr3.out"):
        bench.same_outputs(other, base)


@pytest.mark.parametrize("suf", bench.SORTED_TABLES)
def test_identity_accepts_table_rows_in_another_order(tmp_path, suf):
    base = _artifacts(str(tmp_path / "base"))
    other = _artifacts(str(tmp_path / "other"))
    with open(other + suf, "w") as f:
        f.write("row c\n#header\nrow a\nrow b\n")
    bench.same_outputs(other, base)
    with open(other + suf, "w") as f:
        f.write("row c\n#header\nrow a\nrow B\n")
    with pytest.raises(bench.OutputMismatch, match=suf):
        bench.same_outputs(other, base)


def test_held_holds_runs_made_before_the_first_off_run(tmp_path):
    """A default run made before the part's first off run is held once
    that run exists; a part with no off run raises."""
    first = _artifacts(str(tmp_path / "d0"))
    off = _artifacts(str(tmp_path / "o0"))
    bad = _artifacts(str(tmp_path / "d1"))
    with open(bad + "_final.out", "a") as f:
        f.write("extra\n")
    held = bench.Held("part")
    held.add(first, bench.MODES["default"])
    assert held.held == 0
    held.add(off, bench.MODES["off"])
    assert held.held == 1
    with pytest.raises(bench.OutputMismatch, match="_final.out"):
        held.add(bad, bench.MODES["default"])
    lonely = bench.Held("lonely")
    lonely.add(first, bench.MODES["default"])
    with pytest.raises(AssertionError, match="no device-off run"):
        lonely.close()


def test_wedge_rule_reruns_a_slow_rep_exactly_once():
    calls = []

    def rerun(rep):
        calls.append(rep)
        return 1.2

    walls = [1.0, 3.5, 0.9]
    wedged = bench.rerun_wedged(walls, off_median=1.0, rerun=rerun)
    assert calls == [1]
    assert walls == [1.0, 1.2, 0.9]
    assert wedged == [(1, 3.5, 1.2)]
    # At the limit (3x the off median, not over it) nothing reruns.
    assert bench.rerun_wedged([3.0, 2.9], 1.0, rerun) == []
    assert calls == [1]


def test_rotation_moves_every_config_through_every_place():
    cfg = ["default", "off", "ref"]
    orders = [bench.rotated(cfg, i) for i in range(3)]
    assert orders == [["default", "off", "ref"], ["off", "ref", "default"],
                      ["ref", "default", "off"]]
    assert bench.rotated(cfg, 3) == cfg


def test_bench_raises_without_a_card_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = tmp_path / "w"
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--reads", "10", "--work", str(work)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--device", "cuda", "--dp-child"])
    assert not work.exists()
