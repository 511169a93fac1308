"""The port stands alone: importing any module of trust4_tpu_torch loads
neither jax nor the JAX package, and no source file imports it."""

import os
import pkgutil
import re
import subprocess
import sys

import trust4_tpu_torch

PKG_DIR = os.path.dirname(trust4_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    names = ["trust4_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], "trust4_tpu_torch."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return sorted(names)


def test_every_module_imports_without_jax_or_trust4_tpu():
    mods = _modules()
    for m in ("ops.dp_counts", "ops.dp_scores", "ops.dp_dirs",
              "ops.prefilter", "parallel", "parallel.realign_mesh",
              "parallel.mesh", "parallel.gap_mesh", "parallel.asm_mesh",
              "entry",
              "pipeline.run", "tools", "tools.dp_kernel_lab",
              "tools.vpu_microbench", "tools.fuzz_differential",
              "ops.gap_oracle", "utils.parallel",
              "pipeline.smartseq", "pipeline.bam_extract", "io.bam_native",
              "testing", "cli", "bench"):
        assert "trust4_tpu_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'trust4_tpu' or "
        "m.startswith('trust4_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_the_jax_package():
    pat = re.compile(
        r"^\s*(from|import)\s+(jax|trust4_tpu)(\.|\s|$)", re.M
    )
    offenders = []
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for m in pat.finditer(fh.read()):
                        offenders.append((path, m.group(0).strip()))
    assert not offenders, offenders
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        assert not pat.search(fh.read())
