"""The port's realign round against the JAX package, on the CPU.

``trust4_tpu_torch.parallel.realign_round(device="cpu")`` is the round of
trust4_tpu/parallel/realign_mesh.py on one device: it must give the five
outputs of the JAX ``sharded_realign_round`` on a (1, 1) CPU mesh bit for
bit (integer arithmetic end to end), on the gold candidate reads against
the gold contigs (tests/data/gold_final.out), with the stand-in germline
(trust4_tpu_torch/testing.py) in place of the full references.
Chunking the reads must not change any output.
"""

import os

import numpy as np
import pytest

from trust4_tpu_torch import testing
from trust4_tpu_torch.io.fastx import read_fastx
from trust4_tpu_torch.parallel import default_chunk, realign_round
from trust4_tpu_torch.parallel.realign_mesh import (
    build_contig_position_tables,
)

DATA = os.path.join(os.path.dirname(__file__), "data")
NAMES = ("cand", "scores", "ids", "posWeight", "n_cand")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    reads = [r.seq for r in read_fastx(
        [os.path.join(DATA, "gold_toassemble_1.fq"),
         os.path.join(DATA, "gold_toassemble_2.fq")]
    )]
    contigs = []
    with open(os.path.join(DATA, "gold_final.out")) as f:
        for line in f:
            if line.startswith(">"):
                contigs.append(next(f).strip())
    coord, _imgt = testing.write_standin_references(
        str(tmp_path_factory.mktemp("standin_ref")))
    germ, cur = [], []
    with open(coord) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    germ.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip().upper())
    germ.append("".join(cur))
    assert len(reads) > 100 and len(contigs) > 3
    return reads, contigs, germ


def _jax_round(reads, contigs, germ, **kw):
    import jax
    from jax.sharding import Mesh

    from trust4_tpu.parallel import sharded_realign_round

    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1),
                axis_names=("dp", "mp"))
    return sharded_realign_round(mesh, reads, contigs, germ, **kw)


def _assert_same(got, want):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("subset,kw", [
    ("all", {}),
    ("all", {"hit_len": 27, "band": 48}),
    ("short", {}),
    ("one", {}),
])
def test_round_matches_jax(inputs, subset, kw):
    reads, contigs, germ = inputs
    if subset == "short":  # reads cut to 40 bases, a quarter of the contigs
        reads, contigs = [r[:40] for r in reads[:120]], contigs[::4]
    elif subset == "one":
        reads, contigs = reads[:1], contigs[:1]
    got = realign_round(reads, contigs, germ, device="cpu", **kw)
    _assert_same(got, _jax_round(reads, contigs, germ, **kw))
    if subset == "all" and not kw:
        cand, scores, _ids, pw, n_cand = got
        assert n_cand > 50
        assert (scores > -(1 << 29)).sum() > 50 and pw.sum() > 0


@pytest.mark.parametrize("chunk", [1, 37, 256])
def test_chunking_changes_nothing(inputs, chunk):
    reads, contigs, germ = inputs
    whole = realign_round(reads, contigs, germ, device="cpu",
                          chunk=len(reads))
    _assert_same(realign_round(reads, contigs, germ, device="cpu",
                               chunk=chunk), whole)


def test_default_chunk_fits_the_budget():
    from trust4_tpu_torch.parallel import realign_mesh

    for c, w in ((84, 142), (1000, 92), (1, 1), (10 ** 6, 200)):
        chunk = default_chunk(c, w)
        assert chunk >= 1
        assert chunk == 1 or 4 * c * w * chunk <= realign_mesh._GATHER_BYTES


def test_position_tables_match_jax():
    from trust4_tpu.parallel.realign_mesh import (
        build_contig_position_tables as jax_tables,
    )

    rng = np.random.default_rng(4)
    contigs = ["".join(rng.choice(list("ACGTN"), n)) for n in (5, 9, 60, 300)]
    contigs.append("ACGTACGTA" * 20)  # repeated k-mers: first one wins
    np.testing.assert_array_equal(
        build_contig_position_tables(contigs, 9, 7),
        jax_tables(contigs, 9, 7))


def test_round_on_cuda_needs_a_card(inputs):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    reads, contigs, germ = inputs
    with pytest.raises(RuntimeError, match="is_available"):
        realign_round(reads[:2], contigs[:2], germ, device="cuda")
