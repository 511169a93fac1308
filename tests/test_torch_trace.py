"""The TRUST4_TPU_DEBUG=1 assembly decision trace
(trust4_tpu_torch/tools/debug_trace_check.py) on the CPU.

The gold reads (tests/data/gold_toassemble_{1,2}.fq) through the
assembler at threads 1 on the stand-in coordinate FASTA, each run a child
process whose stdout is the trace (the native engine prints through C
stdio).  Three ways, all byte-identical at 8,234 lines:

- the port with TRUST4_TPU_DEVICE=0 and the JAX package at its default
  (the native CPU DP, no collect path);
- the port's shipping mode (TRUST4_TPU_DEVICE=1: the quick annotation's
  collect-oracle path) and the port with TRUST4_TPU_DEVICE=0.  The tier
  counts are served by the native DP (``global_alignment_counts`` on
  each emitted job, in place of ``banded_affine_counts_plain``), since
  the plain PyTorch DP took about 6 minutes on this batch on an 8-core
  CPU; the counts are the same function (tests/test_torch_gap_oracle.py,
  and the card runs the kernel in chip_smoke.py's trace phase);
- the JAX package forced onto its collect path in process
  (TRUST4_TPU_DEVICE=1, TRUST4_TPU_GAP_INPROC=1, ``_launch_inproc``
  served the same way, as tests/test_gap_oracle.py serves it): the
  collect path's decisions are the reference package's too.

And the tool: a changed line is reported with its neighbours and makes
the exit code 1; a child that fails is reported; ``--device cuda`` raises
without a card; ``--fuzz-seed`` adds the seed's corpus.
"""

import os
import subprocess
import sys

import pytest
import torch

from trust4_tpu_torch import testing
from trust4_tpu_torch.tools import debug_trace_check as dt

GOLD_LINES = 8234
# Counts by the native DP, each job decoded from its code row (0-3 ACGT,
# 4 N) to the strings global_alignment_counts takes.
_SERVE = '''
import numpy as np

def _native_counts(native, tc, tl, pc, pl):
    out = np.zeros((len(tc), 3), dtype=np.int32)
    for j in range(len(tc)):
        t = "".join("ACGTN"[v] for v in tc[j, :tl[j]])
        p = "".join("ACGTN"[v] for v in pc[j, :pl[j]])
        out[j] = native.global_alignment_counts(t, p)
    return out
'''
# The port in the shipping mode, the counts served natively.
PORT_SERVED = _SERVE + '''
import sys
import torch
from trust4_tpu_torch.align import native
from trust4_tpu_torch.ops import dp_counts

def served(t_codes, t_lens, p_codes, p_lens, band_width, packed=False):
    assert not packed
    cnt = _native_counts(native, t_codes.numpy(), t_lens.tolist(),
                         p_codes.numpy(), p_lens.tolist())
    return (torch.zeros(len(cnt), dtype=torch.int32),
            torch.from_numpy(cnt))

dp_counts.banded_affine_counts_plain = served
from trust4_tpu_torch.tools import debug_trace_check
sys.exit(debug_trace_check.main(sys.argv[1:]))
'''
# The JAX package's Assembler (the script's own run); forced onto the
# collect path in process when TRUST4_TPU_GAP_INPROC=1.
JAX_CHILD = _SERVE + '''
import argparse, os, sys
from trust4_tpu.align import native
from trust4_tpu.ops import gap_oracle

if os.environ.get("TRUST4_TPU_GAP_INPROC") == "1":
    gap_oracle.device_available = lambda: True
    gap_oracle._launch_inproc = lambda launches: [
        _native_counts(native, tc, tl, pc, pl)
        for _tier, tc, pc, tl, pl in launches]
ap = argparse.ArgumentParser()
for flag in ("--coord", "--prefix", "--device"):
    ap.add_argument(flag)
ap.add_argument("--child", action="store_true")
ap.add_argument("--reads", nargs="+")
a = ap.parse_args()
from trust4_tpu.pipeline.assembler import Assembler
Assembler(a.coord, output_prefix=a.prefix, threads=1).run(
    a.reads[:1], a.reads[1:] or None)
'''


@pytest.fixture(scope="module")
def coord(tmp_path_factory):
    return testing.write_standin_references(
        str(tmp_path_factory.mktemp("standin_ref")))[0]


@pytest.fixture(scope="module")
def off_trace(coord, tmp_path_factory):
    """The port's TRUST4_TPU_DEVICE=0 trace of the gold reads."""
    d = tmp_path_factory.mktemp("off")
    rc, out, err = dt.trace(dt.GOLD, coord, str(d / "t"), "cpu", "0")
    assert rc == 0, err
    assert "gap DP ran" not in err  # no collect path
    return out


def _jax_env(**kw):
    return dict(JAX_PLATFORMS="cpu", **kw)


def test_device0_trace_matches_jax(coord, off_trace, tmp_path):
    assert off_trace.count(b"\n") == GOLD_LINES
    rc, out, err = dt.trace(dt.GOLD, coord, str(tmp_path / "jax"), "cpu",
                            "auto", launcher=("-c", JAX_CHILD),
                            env=_jax_env())
    assert rc == 0, err
    assert "gap DP ran" not in err
    assert out == off_trace


def test_shipping_trace_matches_device0(coord, off_trace, tmp_path):
    rc, out, err = dt.trace(dt.GOLD, coord, str(tmp_path / "dev"), "cpu",
                            "1", launcher=("-c", PORT_SERVED))
    assert rc == 0, err
    assert "Quick-annotation gap DP ran on cpu (24191 gap fills)." in err
    assert out.count(b"\n") == GOLD_LINES
    assert out == off_trace


def test_jax_forced_collect_trace_matches(coord, off_trace, tmp_path):
    rc, out, err = dt.trace(dt.GOLD, coord, str(tmp_path / "jax1"), "cpu",
                            "1", launcher=("-c", JAX_CHILD),
                            env=_jax_env(TRUST4_TPU_GAP_INPROC="1"))
    assert rc == 0, err
    assert "Quick-annotation gap DP ran on the TPU (24191 gap fills)." in err
    assert out == off_trace


# The tool's own child with one trace line changed in the shipping run.
_FLIP = '''
import os, sys
from trust4_tpu_torch.tools import debug_trace_check
if os.environ["TRUST4_TPU_DEVICE"] == "1":
    real = sys.stdout
    import io
    sys.stdout = io.StringIO()
rc = debug_trace_check.main(sys.argv[1:])
if os.environ["TRUST4_TPU_DEVICE"] == "1":
    lines = sys.stdout.getvalue().splitlines(True)
    lines[2] = "changed\\n"
    real.write("".join(lines))
sys.exit(rc)
'''


def test_compare_reports_the_first_difference(tmp_path, coord):
    """Python-level trace lines only (the reads are too few for the
    native engine to print), so the edit in the child sees them all."""
    reads = tmp_path / "r.fq"
    reads.write_text("".join(f"@r{i}\nACGTACGTACGTACGTACGTAC\n+\n"
                             f"IIIIIIIIIIIIIIIIIIIIII\n" for i in range(3)))
    rec = dt.compare("tiny", [str(reads)], coord, str(tmp_path), "cpu",
                     launcher=("-c", _FLIP))
    assert not rec["ok"]
    assert rec["report"][0] == "tiny: debug traces DIFFER"
    assert rec["report"][1].startswith("first difference at line 3 ")
    assert any(line.startswith("  dev 3: changed")
               for line in rec["report"])
    assert dt.first_difference(b"a\nb\n", b"a\nb\n")[0].startswith(
        "first difference at line 3 (2 vs 2 lines)")


def test_failed_child_is_reported(tmp_path, coord):
    rec = dt.compare("gold", dt.GOLD, coord, str(tmp_path), "cpu",
                     launcher=("-c", "import sys; sys.exit(3)"))
    assert not rec["ok"]
    assert rec["report"][:2] == ["gold: a run failed", "dev exited 3: ..."]


def test_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dt.main(["--device", "cuda"])


def test_tool_runs_a_fuzz_corpus(monkeypatch, capsys):
    """``--fuzz-seed``: a capped se corpus (seed 9003, as
    tests/test_torch_fuzz.py caps it) through the tool on the CPU, the
    shipping mode with the plain DP, beside the gold reads served
    natively."""
    from trust4_tpu_torch.tools import fuzz_differential as fz

    gen = fz.gen_corpus
    monkeypatch.setattr(fz, "gen_corpus", lambda seed, d, coord: gen(
        seed, d, coord, max_clones=6, max_depth=8))
    real = dt.compare

    def compare(name, reads, coord, work, device, launcher=dt.LAUNCHER,
                env=None):
        if name == "gold":
            launcher = ("-c", PORT_SERVED)
        return real(name, reads, coord, work, device, launcher, env)

    monkeypatch.setattr(dt, "compare", compare)
    rc = dt.main(["--device", "cpu", "--fuzz-seed", "9003"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0, out
    assert out[0] == f"gold: debug trace identical ({GOLD_LINES} lines)"
    assert out[1].startswith("seed 9003 se: debug trace identical (")
    assert int(out[1].split("(")[1].split()[0]) > 100


def test_child_trace_goes_to_stdout(coord, tmp_path):
    """The child writes the trace alone on stdout: the run's log lines go
    to stderr."""
    r = subprocess.run(
        [sys.executable, "-m", "trust4_tpu_torch.tools.debug_trace_check",
         "--child", "--coord", coord, "--prefix", str(tmp_path / "t"),
         "--device", "cpu", "--reads", dt.GOLD[0]],
        capture_output=True, text=True, cwd=dt.REPO,
        env=dict(os.environ, TRUST4_TPU_DEBUG="0", TRUST4_TPU_DEVICE="0"))
    assert r.returncode == 0, r.stderr
    assert r.stdout == ""
    assert "Assembled" in r.stderr
