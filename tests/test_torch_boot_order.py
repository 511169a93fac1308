"""The boot-order tool (trust4_tpu_torch/tools/boot_order.py) on the CPU:
each order of the device stack's boot through the port's CLI on a small
bench corpus, the boot thread loading torch in every run, every run's
files byte-identical to the first's, and the launcher's moved boot
starting where it says."""

import os
import subprocess
import sys

from torch_boot_common import REPO
from trust4_tpu_torch.tools import boot_order


def test_every_order_runs_and_every_run_is_held(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for env in ("TRUST4_TPU_DEVICE", "TRUST4_TPU_DEVICE_CHECK",
                "TRUST4_TPU_GAP_MESH", "TRUST4_TPU_GAP_TEST"):
        monkeypatch.delenv(env, raising=False)
    rec = boot_order.main(["--device", "cpu", "--reads", "500",
                           "--rounds", "1", "--threads", "1", "--work",
                           str(tmp_path)])
    assert rec["held"] == len(boot_order.ORDERS) - 1
    runs = rec["t1"]["runs"]
    assert set(runs) == set(boot_order.ORDERS)
    for order, v in runs.items():
        assert len(v) == 1
        assert v[0]["device_boot"]["loaded_by"] == (
            "MainThread" if order == "serial" else "trust4-gap-prewarm-cpu")
        assert v[0]["wall_s"] > v[0]["extract_s"] > 0
    assert rec["device_line"] == f"cpu: {os.cpu_count()} cores"


PROBE = r"""
import os, sys, threading
from trust4_tpu_torch.pipeline import run as run_mod

seen = []


def done():
    print("SEEN", seen, file=sys.stderr, flush=True)
    os._exit(0)


stamp = run_mod._stamp


def probe_stamp(name):
    seen.append(name)
    stamp(name)
    if name == "extract" and "boot" in seen:
        done()


start = threading.Thread.start


def probe_start(self):
    seen.append("boot")
    start(self)
    if "extract" in seen:
        done()


run_mod._stamp = probe_stamp
threading.Thread.start = probe_start
exec(compile(LAUNCH, "launch", "exec"), {"__name__": "__main__"})
"""


def test_the_launcher_moves_the_boot_past_extraction(tmp_path):
    """The ``extract`` order starts the boot thread before extraction's
    stamp, the ``assemble`` and ``serial`` orders just after it (wrappers
    put in place before the launcher's own; the run is cut there)."""
    from trust4_tpu_torch import testing

    coord, imgt = testing.write_standin_references(str(tmp_path / "ref"))
    reads = os.path.join(REPO, "tests", "data", "gold_toassemble_1.fq")
    seen = {}
    for order in ("extract", "assemble", "serial"):
        code = PROBE.replace("LAUNCH", repr(boot_order.LAUNCH))
        r = subprocess.run(
            [sys.executable, "-c", code, order, "run", "-u", reads, "-f",
             coord, "--ref", imgt, "-o", "p", "--od", str(tmp_path / order),
             "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                     TRUST4_TPU_DEVICE="1"))
        line = [x for x in r.stderr.splitlines() if x.startswith("SEEN ")]
        assert r.returncode == 0 and line, r.stderr[-3000:]
        seen[order] = line[0]
    assert seen == {"extract": "SEEN ['boot', '', 'extract']",
                    "assemble": "SEEN ['', 'extract', 'boot']",
                    "serial": "SEEN ['', 'extract', 'boot']"}
