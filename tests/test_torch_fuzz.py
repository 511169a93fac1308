"""The port's differential fuzz harness (trust4_tpu_torch/tools/
fuzz_differential.py) on the CPU.

- Its generators are the JAX harnesses' recipes draw for draw: the JAX
  tools' own ``gen_corpus`` and ``gen`` (taken from tools/*.py, which run
  at import, by their syntax tree) write the same bytes from the same
  seed, long mode apart (its read lengths are the port's).
- One seed gives the same bytes twice.
- ``SEEDS``: the first seeds from 9000 up whose drawn mode is still
  missing (pe, se, repseq, long; barcoded with and without UMI, and one
  with ``--contigMinCov``), chosen by mode, never by outcome.  Each goes
  through three runs whose every file must match (report tables sorted):
  the JAX package's CLI (its default, the native CPU DP), the port on the
  CPU in the shipping mode (the collect path with the plain PyTorch DP)
  and the port with TRUST4_TPU_DEVICE=0.  Only the corpus size is capped
  here (``CAPS``: at most 6 clones, each of depth at most 8), because the
  plain DP took over 100 s on one full long corpus; chip_smoke.py's fuzz
  phase runs the recipes' full sizes on the card.
- The tool: a flipped byte of ``_cdr3.out`` is reported and exits 1; the
  rows of ``_report.tsv`` in another order pass; ``--device cuda`` raises
  without a card; an empty corpus is a mismatch, never an OK.
"""

import ast
import functools
import os
import random
import shutil

import pytest
import torch

from torch_modes_common import clear_device_env, one_thread, refs  # noqa: F401
from trust4_tpu_torch.tools import fuzz_differential as fz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = {"max_clones": 6, "max_depth": 8}
# (kind, seed, features): the first seed from 9000 up that draws each
# feature not yet covered, with CAPS (test_seed_list_is_first_by_mode).
SEEDS = (("bulk", 9000, {"pe"}), ("bulk", 9003, {"se"}),
         ("bulk", 9004, {"long"}), ("bulk", 9041, {"repseq"}),
         ("barcoded", 9000, {"BC", "minCov"}), ("barcoded", 9001, {"UMI"}))
FEATURES = {"bulk": {"pe", "se", "repseq", "long"},
            "barcoded": {"UMI", "BC", "minCov"}}


def _features(mode: str) -> set:
    return {"minCov" if m.startswith("minCov") else m
            for m in mode.split("+")}


def test_seed_list_is_first_by_mode(tmp_path, refs):
    for kind, want in FEATURES.items():
        picked, seen, seed = [], set(), 9000
        while seen != want:
            d = tmp_path / kind / str(seed)
            d.mkdir(parents=True)
            new = _features(fz.GENERATORS[kind](seed, str(d), refs[0],
                                                **CAPS)["mode"]) - seen
            if new:
                picked.append((kind, seed, new))
                seen |= new
            seed += 1
        assert picked == [s for s in SEEDS if s[0] == kind]


def _jax_recipe(tool: str, name: str, ref_dir: str):
    """The function ``name`` of the JAX harness tools/<tool>, with its
    REF directory set to ``ref_dir`` (which holds hg38_bcrtcr.fa)."""
    from trust4_tpu.io.fastx import read_fastx

    path = os.path.join(REPO, "tools", tool)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"random": random, "read_fastx": read_fastx, "REF": ref_dir}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns[name]


def _files(d) -> dict:
    out = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


@pytest.mark.parametrize("kind,seed", [("bulk", 9000), ("bulk", 9003),
                                       ("bulk", 9041), ("barcoded", 9000),
                                       ("barcoded", 9001)])
def test_generators_follow_the_jax_recipes(tmp_path, refs, kind, seed):
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    shutil.copy(refs[0], ref_dir / "hg38_bcrtcr.fa")
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    got = fz.GENERATORS[kind](seed, str(ours), refs[0])
    state = random.getstate()
    try:
        if kind == "bulk":
            paired, n, mode = _jax_recipe(
                "fuzz_differential.py", "gen_corpus", str(ref_dir))(
                    seed, str(theirs))
            assert (got["mode"], got["n"]) == (mode, n)
            assert ("-2" in got["args"]) == paired
            assert ("--repseq" in got["args"]) == (mode == "repseq")
        else:
            use_umi, n = _jax_recipe("fuzz_differential_barcoded.py", "gen",
                                     str(ref_dir))(seed, str(theirs))
            assert got["n"] == n
            assert ("--UMI" in got["args"]) == use_umi
            assert got["mode"].startswith("UMI" if use_umi else "BC")
            assert ("--contigMinCov" in got["args"]) == (seed % 3 == 0)
            if seed % 3 == 0:  # drawn after the generator, as there
                assert got["args"][-1] == str(random.choice([2, 4, 6]))
    finally:
        random.setstate(state)
    assert _files(ours) == _files(theirs)


@pytest.mark.parametrize("kind,seed", [("bulk", 9004), ("barcoded", 9003)])
def test_generator_is_deterministic(tmp_path, refs, kind, seed):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    ra = fz.GENERATORS[kind](seed, str(a), refs[0])
    rb = fz.GENERATORS[kind](seed, str(b), refs[0])
    assert ra["n"] > 0 and ra["mode"] == rb["mode"] and ra["n"] == rb["n"]
    assert _files(a) == _files(b)
    assert [x.replace(str(a), "") for x in ra["args"]] == [
        x.replace(str(b), "") for x in rb["args"]]


@pytest.mark.parametrize("kind,seed,features", SEEDS,
                         ids=[f"{k}-{s}-{'+'.join(sorted(f))}"
                              for k, s, f in SEEDS])
def test_seed_matches_jax_and_device0(tmp_path, monkeypatch, refs, kind,
                                      seed, features):
    from trust4_tpu import cli as jax_cli

    clear_device_env(monkeypatch)
    rec = fz.run_seed(seed, kind, str(tmp_path), refs, device="cpu", **CAPS)
    assert features <= _features(rec["mode"])
    assert rec["mismatches"] == [], rec["mismatches"]
    # The shipping mode took the collect path (the plain DP on the CPU:
    # no launch); TRUST4_TPU_DEVICE=0 did not.
    assert rec["fills"] > 0 and rec["launches"] == 0
    assert rec["off"]["fills"] == 0
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    assert jax_cli.main(["run"] + rec["args"]
                        + ["-o", str(jax_dir / fz.PREFIX)]) == 0
    assert fz.compare_dirs(rec["dirs"]["dev"], str(jax_dir)) == []
    assert fz.compare_dirs(rec["dirs"]["off"], str(jax_dir)) == []


def test_check_mode_seed(tmp_path, monkeypatch, refs):
    """``check``: every gap count of the shipping run asserted against
    the native CPU DP."""
    clear_device_env(monkeypatch)
    rec = fz.run_seed(9003, "bulk", str(tmp_path), refs, device="cpu",
                      check=True, **CAPS)
    assert rec["mismatches"] == [] and rec["fills"] > 0
    assert "TRUST4_TPU_DEVICE_CHECK" not in os.environ


def _capped_generators(monkeypatch):
    """The tool's generators with CAPS in place of the sizes it asks."""
    def capped(gen, seed, out_dir, coord_fa, **_sizes):
        return gen(seed, out_dir, coord_fa, **CAPS)

    monkeypatch.setattr(fz, "GENERATORS", {
        k: functools.partial(capped, g) for k, g in fz.GENERATORS.items()})


def _after_device_run(monkeypatch, edit):
    """Make ``edit(prefix)`` run on the output of each shipping-mode run
    (TRUST4_TPU_DEVICE=1) of the tool."""
    run_cli = fz._run_cli

    def wrapped(argv, env):
        run_cli(argv, env)
        if env["TRUST4_TPU_DEVICE"] == "1":
            edit(argv[argv.index("-o") + 1])

    monkeypatch.setattr(fz, "_run_cli", wrapped)


def test_tool_reports_a_flipped_byte(tmp_path, monkeypatch, capsys):
    clear_device_env(monkeypatch)
    _capped_generators(monkeypatch)

    def flip(prefix):
        path = prefix + "_cdr3.out"
        with open(path, "rb") as f:
            data = bytearray(f.read())
        data[len(data) // 2] ^= 1
        with open(path, "wb") as f:
            f.write(bytes(data))

    _after_device_run(monkeypatch, flip)
    rc = fz.main(["9003", "9004", "--device", "cpu", "--work",
                  str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "seed 9003 se n=48" in out and "['fz_cdr3.out']" in out
    assert "MISMATCHED CORPORA: 1" in out


def test_tool_accepts_report_rows_in_another_order(tmp_path, monkeypatch,
                                                   capsys):
    clear_device_env(monkeypatch)
    _capped_generators(monkeypatch)

    def reverse_rows(prefix):
        path = prefix + "_report.tsv"
        with open(path) as f:
            head, *rows = f.read().splitlines(keepends=True)
        assert rows[::-1] != rows
        with open(path, "w") as f:
            f.write(head + "".join(rows[::-1]))

    _after_device_run(monkeypatch, reverse_rows)
    rc = fz.main(["9000", "9001", "--device", "cpu", "--work",
                  str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert ": OK" in out and "MISMATCHED CORPORA: 0" in out


def test_cuda_raises_without_a_card(tmp_path, monkeypatch, refs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fz.main(["9000", "9001", "--work", str(tmp_path)])
    with pytest.raises(RuntimeError, match="is_available"):
        fz.run_seed(9000, "bulk", str(tmp_path), refs, device="cuda", **CAPS)


def test_empty_corpus_is_a_mismatch(tmp_path, capsys):
    """Genes too short for any fragment draw no read: the generator
    raises and the wave reports the seed as a mismatch."""
    coord = tmp_path / "short.fa"
    coord.write_text(">IGHV1\nACGTACGTAC\n>IGHJ1\nACGTAC\n>IGHC\nACGTAC\n")
    with pytest.raises(ValueError, match="no read"):
        fz.gen_corpus(9000, str(tmp_path), str(coord))
    recs = fz.wave([9000], "barcoded", str(tmp_path),
                   (str(coord), str(coord)), device="cpu")
    assert recs[0]["mismatches"] and "no read" in recs[0]["mismatches"][0]
    assert "seed 9000 - n=0" in capsys.readouterr().out
