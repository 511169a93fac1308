"""The port's AddressSanitizer check (trust4_tpu_torch/tools/asan_check.py)
on the CPU.

The ASan libraries are built once, into a temporary directory.  Then:

- the tool on one capped bulk seed and one capped barcoded seed (9000:
  pe, and BC with --contigMinCov; capped as tests/test_torch_fuzz.py
  caps them), the gold reads, a small stand-in BAM and the -t 8 seed,
  each in the shipping mode (the collect path, the plain PyTorch DP)
  against TRUST4_TPU_DEVICE=0 under libasan: ``asan check passed``, and
  the child saw the ASan libraries;
- the child refuses to run on the fast libraries, and without libasan;
- the options keep a report fatal: an out-of-bounds read in an
  instrumented library, loaded under the tool's environment, aborts the
  process with the report;
- ``--device cuda`` raises without a card before anything is built.

Skipped only where ``g++ -print-file-name=libasan.so`` names no file
(``asan_check.CXX``).
"""

import os
import subprocess
import sys

import pytest
import torch

from trust4_tpu_torch.tools import asan_check as ac

TOOL = [sys.executable, "-m", "trust4_tpu_torch.tools.asan_check"]
CAPS = ["--max-clones", "6", "--max-depth", "8"]


def _one_thread_env(env=None) -> dict:
    """torch on one thread in the child: an OpenMP team of every core
    beside other busy processes (pytest-xdist workers) stalls at its
    barriers."""
    return dict(env or os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def asan_dir(tmp_path_factory):
    try:
        ac.libasan()
    except RuntimeError as e:
        pytest.skip(str(e))
    d = str(tmp_path_factory.mktemp("asan"))
    ac.build_asan(d)
    return d


def test_tool_passes_on_capped_seeds(asan_dir):
    r = subprocess.run(
        TOOL + ["9000", "9001", "--device", "cpu", "--threads", "2",
                "--bam-pairs", "300", "--asan-dir", asan_dir] + CAPS,
        capture_output=True, text=True, cwd=ac.REPO, timeout=900,
        env=_one_thread_env())
    out = r.stdout.splitlines()
    assert r.returncode == 0, r.stdout + r.stderr[-6000:]
    assert out[0].startswith("asan build: ")
    assert "ASAN_OPTIONS=" + ac.ASAN_OPTIONS + ";" in out[0]
    assert out[1] == (f"asan libraries: 4 loaded from "
                      f"{os.path.realpath(asan_dir)}, __asan_init resolves "
                      "in each; " + os.path.basename(ac.libasan())
                      + " preloaded")
    parts = [line.split(":")[0] for line in out[2:-1]]
    assert parts == ["asan gold", "asan bulk", "asan barcoded", "asan bam",
                     "asan t8"]
    for line in out[2:-1]:
        assert line.endswith(": OK"), line
        assert " corpora=1 " in line and " launches=0" in line
        assert int(line.split("fills=")[1].split()[0]) > 0, line
    assert out[-1] == "asan check passed"


def _child(asan_dir, env):
    return subprocess.run(
        TOOL + ["9000", "9001", "--device", "cpu", "--asan-dir", asan_dir,
                "--child"], capture_output=True, text=True, cwd=ac.REPO,
        timeout=300, env=_one_thread_env(env))


def test_child_refuses_the_fast_libraries(asan_dir):
    env = ac.child_env(asan_dir, "cpu")
    del env["TRUST4_TPU_NATIVE_DIR"]  # the package's own native/
    r = _child(asan_dir, env)
    assert r.returncode != 0
    assert "mapped from outside" in r.stderr
    assert "asan check passed" not in r.stdout


def test_child_refuses_to_run_without_libasan(asan_dir):
    env = ac.child_env(asan_dir, "cpu")
    del env["LD_PRELOAD"]
    r = _child(asan_dir, env)
    assert r.returncode != 0
    assert "asan check passed" not in r.stdout


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_child_env_keeps_reports_fatal(asan_dir, tmp_path, monkeypatch,
                                       device):
    monkeypatch.setenv("ASAN_OPTIONS", "halt_on_error=0")
    monkeypatch.setenv("TRUST4_TPU_DEVICE", "0")
    env = ac.child_env(asan_dir, device)
    opts = env["ASAN_OPTIONS"].split(":")
    assert "abort_on_error=1" in opts
    assert not any(o.startswith(("halt_on_error", "suppressions",
                                 "allow_user_segv_handler")) for o in opts)
    assert ("protect_shadow_gap=0" in opts) == (device == "cuda")
    assert env["LD_PRELOAD"].split()[0] == ac.libasan()
    assert env["TRUST4_TPU_NATIVE_DIR"] == asan_dir
    assert "TRUST4_TPU_DEVICE" not in env
    # A heap overflow in an instrumented library aborts the process.
    src = tmp_path / "oob.cpp"
    src.write_text('extern "C" int oob(int i) {\n'
                   '  int* a = new int[4];\n'
                   '  int v = a[i];\n'
                   '  delete[] a;\n'
                   '  return v;\n'
                   '}\n')
    lib = tmp_path / "liboob.so"
    subprocess.run([ac.CXX, *ac.CXXFLAGS.split(), "-o", str(lib), str(src)],
                   check=True)
    r = subprocess.run(
        [sys.executable, "-c", f"import ctypes; ctypes.CDLL({str(lib)!r})."
         "oob(4); print('survived')"],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0
    assert "survived" not in r.stdout
    assert "AddressSanitizer: heap-buffer-overflow" in r.stderr


def test_cuda_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ac.main(["--asan-dir", str(tmp_path / "asan")])
    assert not (tmp_path / "asan").exists()
