"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: compared by whole top-level
module names (trust4_tpu_torch begins with trust4_tpu)."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from t4bench_common import ROOT

JAX = {"jax", "jaxlib", "flax", "trust4_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(sub=""):
    return sorted(glob.glob(os.path.join(ROOT, "t4bench", sub, "**", "*.py"),
                            recursive=True))


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(
    p, ROOT))
def test_no_jax(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", _files("reference") + _files("data")
                         + _files("layouts") + _files("traffic"),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert "trust4_tpu_torch" not in _imports(path)


def test_whole_names_are_compared():
    from t4bench.run import forbidden_modules

    assert "trust4_tpu_torch" not in forbidden_modules()


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import t4bench.reference.control, "
            "t4bench.reference.judge, t4bench.data.standin, "
            "t4bench.traffic.generator, t4bench.layouts; "
            "[t4bench.layouts.load(n) for n in "
            "('bulk-se', 'bulk-pe', '10x-5p')]; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'trust4_tpu', 'trust4_tpu_torch', "
            "'torch'}; print(sorted(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
