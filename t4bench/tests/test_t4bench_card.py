"""A run on the card (the repo's ``cuda`` marker; skips without one):
the CLI's last line is a correct result on the GPU."""

import json
import subprocess
import sys

import pytest

from t4bench_common import ROOT


@pytest.mark.cuda
def test_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "t4bench.run", "--workload",
         "bulk-se.receptor-rich", "--seed", "4000000003", "--seconds", "5",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().split("\n")[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert "device.idle_share" in result["metrics"]
