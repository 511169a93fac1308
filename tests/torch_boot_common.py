"""Shared by tests/test_torch_boot*.py: the port's CLI in a child process
that records which thread first asked for ``torch``.

The child puts a finder at the head of ``sys.meta_path``; the import
system asks it for ``torch`` only while torch is not in ``sys.modules``,
so the thread it first sees asking is the one that loaded torch.  At exit
the child prints one line on stderr, ``SPY {json}``: ``first`` (that
thread's name, or null), ``loaded`` ("torch" in sys.modules), ``boot``
(ops/gap_oracle.BOOT) and ``rc``.  ``--torch-absent`` as the first
argument stubs torch out (``sys.modules["torch"] = None``), so that any
import of it raises ImportError.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")

SPY = r"""
import json, sys, threading

class Spy:
    first = None

    def find_spec(self, name, path=None, target=None):
        if name == "torch" and Spy.first is None:
            Spy.first = threading.current_thread().name
        return None

sys.meta_path.insert(0, Spy())
argv = sys.argv[1:]
if argv[:1] == ["--torch-absent"]:
    sys.modules["torch"] = None
    argv = argv[1:]
rc = 1
try:
    from trust4_tpu_torch import cli
    from trust4_tpu_torch.ops import gap_oracle

    rc = cli.main(argv)
finally:
    print("SPY " + json.dumps({
        "first": Spy.first, "loaded": sys.modules.get("torch") is not None,
        "boot": dict(gap_oracle.BOOT), "rc": rc}), file=sys.stderr)
sys.exit(rc)
"""


def spy_cli(argv, mode, cwd, timeout=300, **env):
    """The CLI with ``argv`` under TRUST4_TPU_DEVICE=``mode`` (None: the
    default) in a child; (CompletedProcess, the SPY record)."""
    e = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
             TRUST4_TPU_STAGE_TIMES="1")
    for k in ("TRUST4_TPU_DEVICE", "TRUST4_TPU_DEVICE_CHECK",
              "TRUST4_TPU_GAP_MESH", "TRUST4_TPU_GAP_TEST",
              "TRUST4_TPU_DEVICE_READY_TIMEOUT_S",
              "TRUST4_TPU_DEVICE_TIMEOUT_S"):
        e.pop(k, None)
    if mode is not None:
        e["TRUST4_TPU_DEVICE"] = mode
    e.update(env)
    r = subprocess.run([sys.executable, "-c", SPY, *argv], cwd=cwd, env=e,
                       capture_output=True, text=True, timeout=timeout)
    spy = [line for line in r.stderr.splitlines() if line.startswith("SPY ")]
    assert len(spy) == 1, r.stderr[-3000:]
    return r, json.loads(spy[0][4:])


def same_files(a: str, b: str) -> list:
    """Directories ``a`` and ``b`` hold the same file names, each
    byte-identical; returns the names."""
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for name in names:
        with open(os.path.join(a, name), "rb") as x, \
                open(os.path.join(b, name), "rb") as y:
            assert x.read() == y.read(), name
    return names
