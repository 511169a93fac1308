"""The port stands alone: importing any module of trust4_tpu_torch loads
neither jax nor the JAX package nor the repository's ``tools`` package,
and no source file (chip_smoke.py included) imports them.  The CLI, the
pipeline, the fork pools and the gap oracle's front load no torch either
(the device stack boots on the gap oracle's thread)."""

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
              "tools.asan_check", "tools.debug_trace_check",
              "tools.make_bench_corpus", "tools.boot_order",
              "utils.nativebuild",
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
        "m.startswith('trust4_tpu.') or m == 'tools' or "
        "m.startswith('tools.'))\n"
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


def test_no_source_imports_the_repo_tools_package():
    """The port's tools are its own (trust4_tpu_torch/tools/): neither a
    module of the port nor chip_smoke.py imports the repository's
    ``tools`` package, nor puts the repository on sys.path for it."""
    pat = re.compile(r"^\s*(from|import)\s+tools(\.|\s|$)", re.M)
    offenders = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            offenders += [(path, m.group(0).strip())
                          for m in pat.finditer(fh.read())]
    assert not offenders, offenders
    code = ("import sys\n"
            "import importlib.util as u\n"
            "spec = u.spec_from_file_location('cs', 'chip_smoke.py')\n"
            "m = u.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'tools' or "
            "k.startswith('tools.') or k == 'jax' or k.startswith('jax.') "
            "or k == 'trust4_tpu' or k.startswith('trust4_tpu.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_cli_pipeline_and_oracle_front_load_no_torch():
    mods = ["trust4_tpu_torch.cli", "trust4_tpu_torch.pipeline.run",
            "trust4_tpu_torch.pipeline.assembler",
            "trust4_tpu_torch.pipeline.annotator",
            "trust4_tpu_torch.pipeline.extract",
            "trust4_tpu_torch.pipeline.report",
            "trust4_tpu_torch.utils.parallel",
            "trust4_tpu_torch.ops.gap_oracle"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'torch' not in sys.modules, sorted(\n"
            "    k for k in sys.modules if k.startswith('torch'))[:5]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
