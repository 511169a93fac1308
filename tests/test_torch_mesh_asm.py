"""The port's per-barcode assembly over ranks
(trust4_tpu_torch/parallel/asm_mesh.py) on the CPU: gloo process groups
between spawned ranks.

A barcoded corpus (tools/make_bench_corpus.make_barcoded_corpus, 120
cells, seed 77, as tests/test_asm_mesh.py builds it) against the
stand-in coordinate FASTA, extracted by the port's barcoded extractor:
about 5,100 reads, so the assembler's partition gate (4,096 reads) cuts
it into whole-barcode spans.  The committed barcoded gold reads
(tests/data/bambc, 198 reads) are below that gate and never reach an
executor.  One world of 8 ranks runs the mesh executor at 1, 2, 4 and 8
ranks (tests/test_asm_mesh.py holds 8 shards); every rank's
``_final.out`` must equal the port's thread pool and the JAX package's
``asm_mesh.mesh_partition_executor`` at the same shard count.
"""

import os

import pytest

from trust4_tpu_torch import testing
from trust4_tpu_torch.parallel import mesh as rank_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = (1, 2, 4, 8)
THREADS = 4


@pytest.fixture(scope="module", autouse=True)
def native_gap_dp():
    """The executor, not the gap DP, is under test here: every assembly of
    this module (and its ranks, which inherit the environment) runs the
    quick annotation's gap DP natively (TRUST4_TPU_DEVICE=0), the JAX
    package's default path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRUST4_TPU_DEVICE", "0")
        yield


def _assemble(assembler_cls, coord, pre, prefix, executor, **kw):
    """``_final.out`` of one assembly, and the span counts the executor
    was handed (after it returned)."""
    calls = []
    asm = assembler_cls(coord, output_prefix=prefix, threads=THREADS, **kw)
    if executor is not None:
        def counting(run_part, bounds, workers):
            out = executor(run_part, bounds, workers)
            calls.append(len(bounds) - 1)
            return out

        asm._partition_executor = counting
    asm.run([pre + ".fq"], None, barcode_files=[pre + "_bc.fa"],
            umi_files=[pre + "_umi.fa"])
    with open(prefix + "_final.out", "rb") as f:
        return f.read(), calls


def _world(coord, pre, root):
    """Rank body: the assembly with the mesh executor at every rank count
    this rank belongs to."""
    import torch.distributed as dist

    from trust4_tpu_torch.parallel import make_mesh, mesh_partition_executor
    from trust4_tpu_torch.pipeline.assembler import Assembler

    rank = dist.get_rank()
    out = {}
    for n in RANKS:
        m = make_mesh((n,), ("dp",), ranks=range(n), device="cpu")
        if m is not None:
            out[n] = _assemble(Assembler, coord, pre,
                               os.path.join(root, f"mesh{n}_r{rank}"),
                               mesh_partition_executor(m), device="cpu")
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import sys

    sys.path.insert(0, REPO)
    from tools.make_bench_corpus import make_barcoded_corpus
    from trust4_tpu_torch.pipeline.extract import run_barcoded_extractor

    d = tmp_path_factory.mktemp("bc_corpus")
    coord = testing.write_standin_references(str(d / "ref"))[0]
    reads, bc = str(d / "reads.fq"), str(d / "bc.fq")
    make_barcoded_corpus(reads, bc, n_cells=120, seed=77, n_clones=40,
                         ref_fa=coord)
    pre = str(d / "x_toassemble")
    run_barcoded_extractor(coord, [reads], None, pre, barcode_files=[bc],
                           umi_files=[bc], read_format="bc:0:15,um:16:25")
    return coord, pre, str(d)


@pytest.fixture(scope="module")
def pool(corpus):
    from trust4_tpu_torch.pipeline.assembler import Assembler

    coord, pre, root = corpus
    final, _ = _assemble(Assembler, coord, pre, os.path.join(root, "pool"),
                         None, device="cpu")
    assert len(final) > 1000
    return final


@pytest.fixture(scope="module")
def world(corpus):
    coord, pre, root = corpus
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(rank_mesh.TIMEOUT_ENV, "60")
        return rank_mesh.spawn(_world, max(RANKS), backend="gloo",
                               device="cpu", args=(coord, pre, root),
                               timeout_s=60)


@pytest.mark.parametrize("n", RANKS)
def test_mesh_executor_final_out_equals_pool_and_jax(corpus, pool, world,
                                                     n):
    from trust4_tpu.parallel import asm_mesh as jax_asm_mesh
    from trust4_tpu.pipeline.assembler import Assembler as JaxAssembler

    coord, pre, root = corpus
    jax_final, jax_calls = _assemble(
        JaxAssembler, coord, pre, os.path.join(root, f"jax{n}"),
        jax_asm_mesh.mesh_partition_executor(jax_asm_mesh.make_mesh(n)))
    assert jax_final == pool and jax_calls and jax_calls[0] >= 2
    members = [r for r, res in enumerate(world) if n in res]
    assert members == list(range(n))
    for r in members:
        final, calls = world[r][n]
        # The partition gate fired and the executor returned: a throw
        # would have stopped the run, not fallen back to the serial loop.
        assert calls == jax_calls, (r, calls)
        assert final == pool, f"{n} ranks, rank {r}"


def test_span_results_travel_as_plain_fields(corpus):
    """A span's SeqSet wrappers point at their native engine and do not
    pickle; the executor ships their plain fields and rebuilds them."""
    import pickle

    import numpy as np

    from trust4_tpu_torch.parallel import asm_mesh
    from trust4_tpu_torch.pipeline.assembler import Assembler

    coord, pre, root = corpus
    parts = []

    def keep(run_part, bounds, workers):
        parts.extend(run_part(bounds[k], bounds[k + 1])
                     for k in range(len(bounds) - 1))
        return parts

    _assemble(Assembler, coord, pre, os.path.join(root, "plain"), keep,
              device="cpu")
    part = parts[0]
    assert len(part[3]) > 0
    with pytest.raises(Exception):
        pickle.dumps(part[3])
    back = asm_mesh._rebuild_part(pickle.loads(pickle.dumps(
        asm_mesh._plain_part(part))))
    for a, b in zip(part[3], back[3]):
        for f in asm_mesh._SHIPPED:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, f
    assert back[4] == part[4] and back[2] == part[2]


def test_failing_executor_stops_the_assembly(corpus):
    """With a plugged-in executor a failure raises: no serial loop in its
    place (the thread pool keeps its serial fallback)."""
    from trust4_tpu_torch.pipeline.assembler import Assembler

    coord, pre, root = corpus

    def broken(run_part, bounds, workers):
        raise RuntimeError("rank lost")

    with pytest.raises(RuntimeError, match="rank lost"):
        _assemble(Assembler, coord, pre, os.path.join(root, "broken"),
                  broken, device="cpu")
    assert not os.path.exists(os.path.join(root, "broken_final.out"))
