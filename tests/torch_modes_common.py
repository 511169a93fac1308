"""Shared by tests/test_torch_modes*.py: run one mode through the port
(``device="cpu"``: the plain PyTorch DP through the collect path) and
through the JAX package (its default, the native CPU DP) on the same
stand-in inputs, and compare what each wrote.

Every file a run writes must be byte-identical between the packages,
except the report tables, which are compared after sorting their lines
(the reference's own gate, its row order being free).  Goldens are held
byte for byte, or sorted where the reference's gate sorts.
"""

import importlib
import os

import pytest

from trust4_tpu_torch import testing

DATA = os.path.join(os.path.dirname(__file__), "data")
SORTED = ("_report.tsv", "_barcode_report.tsv", "_airr.tsv",
          "_barcode_airr.tsv")
PACKAGES = ("trust4_tpu_torch", "trust4_tpu")


def module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def device_kw(pkg: str) -> dict:
    return {"device": "cpu"} if pkg == "trust4_tpu_torch" else {}


def clear_device_env(monkeypatch) -> None:
    for env in ("TRUST4_TPU_DEVICE", "TRUST4_TPU_DEVICE_CHECK",
                "TRUST4_TPU_GAP_MESH", "TRUST4_TPU_GAP_TEST"):
        monkeypatch.delenv(env, raising=False)


def lines_sorted(path: str):
    with open(path) as f:
        return sorted(f.read().splitlines())


def assert_same_outputs(port_dir: str, jax_dir: str) -> list:
    """Every file of both directories equal (report tables after sorting);
    returns the names compared."""
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    assert names
    for name in names:
        a = os.path.join(port_dir, name)
        b = os.path.join(jax_dir, name)
        if name.endswith(SORTED):
            assert lines_sorted(a) == lines_sorted(b), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    return names


def run_in(tmp_path, fn) -> dict:
    """fn(pkg, out_dir) for both packages, each in its own directory;
    returns {pkg: out_dir}."""
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        fn(pkg, str(d))
        out[pkg] = str(d)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's plain DP runs on one torch thread: an OpenMP team of
    every core beside other busy processes (pytest-xdist workers) stalls
    at its barriers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODES = os.path.join(DATA, "modes")
BC = os.path.join(DATA, "bc")
BAMBC = os.path.join(DATA, "bambc")
SMARTSEQ = os.path.join(DATA, "smartseq")
GOLD_READS = [os.path.join(DATA, f"gold_toassemble_{m}.fq") for m in (1, 2)]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return testing.write_standin_references(
        str(tmp_path_factory.mktemp("standin_ref")))


@pytest.fixture(scope="module")
def coord_refs(tmp_path_factory):
    return testing.write_standin_references(
        str(tmp_path_factory.mktemp("standin_coord")), coordinates=True)


def same_as_golden(path, golden, sort=False):
    if sort:
        assert lines_sorted(path) == lines_sorted(golden), golden
    else:
        with open(path) as a, open(golden) as b:
            assert a.read() == b.read(), golden


def cell_lists(d):
    for m in (1, 2):
        with open(os.path.join(d, f"list{m}.txt"), "w") as f:
            f.write("".join(os.path.join(SMARTSEQ, f"cell{c}_{m}.fq") + "\n"
                            for c in (1, 2)))
    return os.path.join(d, "list1.txt"), os.path.join(d, "list2.txt")
