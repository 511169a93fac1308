"""The port's copy of the corpus tool (trust4_tpu_torch/tools/
make_bench_corpus.py) writes the same bytes as tools/make_bench_corpus.py
for the same seed and reference, bulk and barcoded."""

import os
import sys

import pytest

from trust4_tpu_torch import testing
from trust4_tpu_torch.tools import make_bench_corpus as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def coord(tmp_path_factory):
    return testing.write_standin_references(
        str(tmp_path_factory.mktemp("standin_ref")))[0]


def _root_tool():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import tools.make_bench_corpus as root

    return root


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", [20260816, 7])
def test_bulk_corpus_is_the_root_tools(tmp_path, coord, seed):
    root = _root_tool()
    a, b = tmp_path / "port.fq", tmp_path / "root.fq"
    port.make_corpus(str(a), n_reads=3000, seed=seed, ref_fa=coord)
    root.make_corpus(str(b), n_reads=3000, seed=seed, ref_fa=coord)
    assert _read(a) == _read(b)
    assert _read(a).count(b"\n") == 4 * 3000


@pytest.mark.parametrize("seed", [20260817, 7])
def test_barcoded_corpus_is_the_root_tools(tmp_path, coord, seed):
    root = _root_tool()
    got = port.make_barcoded_corpus(
        str(tmp_path / "pr.fq"), str(tmp_path / "pb.fq"), n_cells=40,
        seed=seed, ref_fa=coord, n_clones=20)
    want = root.make_barcoded_corpus(
        str(tmp_path / "rr.fq"), str(tmp_path / "rb.fq"), n_cells=40,
        seed=seed, ref_fa=coord, n_clones=20)
    assert got == want > 0
    assert _read(tmp_path / "pr.fq") == _read(tmp_path / "rr.fq")
    assert _read(tmp_path / "pb.fq") == _read(tmp_path / "rb.fq")


def test_reference_has_no_default(tmp_path):
    with pytest.raises(TypeError, match="ref_fa"):
        port.make_corpus(str(tmp_path / "x.fq"), n_reads=10)
