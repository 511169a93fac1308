"""The port's rank-sharded gap DP (trust4_tpu_torch/parallel/gap_mesh.py)
on the CPU: gloo process groups between spawned ranks, the plain DP.

One world of 4 ranks serves the sub-meshes of 1, 2 and 4 ranks;
``TRUST4_TPU_GAP_MESH=<n>`` needs a world of exactly n ranks, so the
pipeline stage also runs in a world of 2 and, at 1, in this process
with no process group.  Every result must equal the JAX package's
``mesh_tier_counts`` / mesh pipeline at the same shard count, and the
native DP.  Peers that never arrive, or die, make the others raise
within the collective timeout.
"""

import os
import re
import shutil
import time

import numpy as np
import pytest

from trust4_tpu_torch import testing
from trust4_tpu_torch.ops.gap_oracle import _TIERS
from trust4_tpu_torch.parallel import mesh as rank_mesh

DATA = os.path.join(os.path.dirname(__file__), "data")
# Collective and join deadlines of the spawned worlds (seconds).
PG_TIMEOUT_S = "60"
JOIN_TIMEOUT_S = 60


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch work runs on one thread, as its ranks do: an
    OpenMP team of every core beside other busy processes (pytest-xdist
    workers, the spawned ranks) stalls at its barriers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_pairs(rng, n, hi):
    """tests/test_gap_mesh.py's generator: |t - p| <= 5, so every pair
    fits every tier's band."""
    pairs = []
    for _ in range(n):
        lt = int(rng.integers(0, hi))
        lp = int(np.clip(lt + rng.integers(-5, 6), 0, hi))
        t = "".join(rng.choice(list("ACGTN"), lt, p=[0.24] * 4 + [0.04]))
        if lt and lp and rng.random() < 0.6:
            p_list = list(t[:lp].ljust(lp, "A"))
            for _ in range(int(rng.integers(0, 5))):
                p_list[int(rng.integers(0, lp))] = rng.choice(list("ACGT"))
            p = "".join(p_list)
        else:
            p = "".join(rng.choice(list("ACGT"), lp))
        pairs.append((t, p))
    return pairs


def _tier_inputs(cap):
    from trust4_tpu_torch.ops.dp import encode_for_dp

    pairs = _random_pairs(np.random.default_rng(23 + cap), 61, cap)
    tc, tl = encode_for_dp([t for t, _ in pairs], cap)
    pc, pl = encode_for_dp([p for _, p in pairs], cap)
    return pairs, tc, pc, tl, pl


def _stage_prefix(root, tag):
    """A stage-2 rerun's inputs: the gold reads, contigs and assembled
    reads under a fresh prefix."""
    prefix = os.path.join(root, tag, "gold")
    os.makedirs(os.path.dirname(prefix))
    for suf in ("_toassemble_1.fq", "_toassemble_2.fq", "_final.out",
                "_assembled_reads.fa"):
        shutil.copy(os.path.join(DATA, "gold" + suf), prefix + suf)
    return prefix


def _stage_kw(prefix, refs):
    return dict(read1_files=[prefix + "_toassemble_1.fq"],
                read2_files=[prefix + "_toassemble_2.fq"],
                output_prefix=prefix, stage=2, threads=2)


def _read(prefix):
    out = {}
    for suf in ("_cdr3.out", "_annot.fa"):
        with open(prefix + suf) as f:
            out[suf] = f.read()
    return out


def _port_stage(root, refs, n, tag):
    """The port's stage-2 rerun under TRUST4_TPU_GAP_MESH=n on the CPU;
    returns its artifacts and the rows this rank's DP ran."""
    from trust4_tpu_torch.ops import dp_counts
    from trust4_tpu_torch.pipeline.run import run_trust4

    rows = []
    plain = dp_counts.banded_affine_counts

    def spy(tc, *a, **kw):
        rows.append(len(tc))
        return plain(tc, *a, **kw)

    dp_counts.banded_affine_counts = spy
    os.environ["TRUST4_TPU_GAP_MESH"] = str(n)
    try:
        prefix = _stage_prefix(root, tag)
        run_trust4(refs[0], refs[1], device="cpu", **_stage_kw(prefix, refs))
    finally:
        del os.environ["TRUST4_TPU_GAP_MESH"]
        dp_counts.banded_affine_counts = plain
    return {"artifacts": _read(prefix), "dp_rows": rows}


def _world(root, refs):
    """Rank body: mesh_tier_counts at 1, 2 and 4 ranks per tier, a batch
    that differs on rank 1, and the pipeline stage over the whole
    world."""
    import torch.distributed as dist

    from trust4_tpu_torch.parallel import gap_mesh

    rank, size = dist.get_rank(), dist.get_world_size()
    out = {"counts": {}}
    if size == 4:
        for cap, w, _chunk in _TIERS:
            _pairs, tc, pc, tl, pl = _tier_inputs(cap)
            for n in (1, 2, 4):
                m = gap_mesh.make_mesh(n, device="cpu")
                if m is not None:
                    out["counts"][cap, n] = gap_mesh.mesh_tier_counts(
                        m, tc, pc, tl, pl, w=w)
        m = gap_mesh.make_mesh(2, device="cpu")
        if m is not None:
            _pairs, tc, pc, tl, pl = _tier_inputs(16)
            if rank == 1:
                tc[7, 0] = (tc[7, 0] + 1) % 4
            try:
                gap_mesh.mesh_tier_counts(m, tc, pc, tl, pl, w=16)
                out["disagree"] = None
            except ValueError as e:
                out["disagree"] = str(e)
    out["stage"] = _port_stage(root, refs, size, f"w{size}r{rank}")
    return out


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return testing.write_standin_references(
        str(tmp_path_factory.mktemp("standin_ref")))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, refs):
    root = str(tmp_path_factory.mktemp("gap_worlds"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(rank_mesh.TIMEOUT_ENV, PG_TIMEOUT_S)
        mp.delenv("TRUST4_TPU_GAP_MESH", raising=False)
        mp.delenv("TRUST4_TPU_DEVICE", raising=False)
        mp.delenv("TRUST4_TPU_DEVICE_CHECK", raising=False)
        out = {n: rank_mesh.spawn(_world, n, backend="gloo", device="cpu",
                                  args=(root, refs),
                                  timeout_s=JOIN_TIMEOUT_S)
               for n in (4, 2)}
        out[1] = [{"stage": _port_stage(root, refs, 1, "w1")}]
    return out


@pytest.mark.parametrize("tier", range(len(_TIERS)))
def test_mesh_tier_counts_equal_jax_and_native(worlds, tier):
    from trust4_tpu.align import native as align_native
    from trust4_tpu.parallel import gap_mesh as jax_gap_mesh

    cap, w, _chunk = _TIERS[tier]
    pairs, tc, pc, tl, pl = _tier_inputs(cap)
    want = np.array([align_native.global_alignment_counts(t, p)
                     for t, p in pairs], np.int32)
    for n in (1, 2, 4):
        jax_counts = jax_gap_mesh.mesh_tier_counts(
            jax_gap_mesh.make_mesh(n), tc, pc, tl, pl, w=w)
        np.testing.assert_array_equal(jax_counts, want, err_msg=f"jax {n}")
        members = [r for r, res in enumerate(worlds[4])
                   if (cap, n) in res["counts"]]
        assert members == list(range(n if n > 1 else 4)), (n, members)
        for r in members:
            got = worlds[4][r]["counts"][cap, n]
            assert got.dtype == np.int32 and got.shape == (61, 3)
            np.testing.assert_array_equal(got, jax_counts,
                                          err_msg=f"{n} ranks, rank {r}")


def test_ranks_with_differing_batches_raise(worlds):
    for r in (0, 1):
        assert "different inputs" in worlds[4][r]["disagree"], r
    assert all("disagree" not in res for res in worlds[4][2:])


@pytest.fixture(scope="module")
def single(refs, tmp_path_factory):
    """The port's stage-2 rerun without the mesh: the goldens."""
    from trust4_tpu_torch.pipeline.run import run_trust4

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("TRUST4_TPU_GAP_MESH", raising=False)
        mp.delenv("TRUST4_TPU_DEVICE", raising=False)
        base = _stage_prefix(str(tmp_path_factory.mktemp("single")), "s")
        run_trust4(refs[0], refs[1], device="cpu", **_stage_kw(base, refs))
    want = _read(base)
    for suf, text in want.items():
        with open(os.path.join(DATA, "gold" + suf)) as f:
            assert text == f.read(), suf
    return want


@pytest.mark.parametrize("n", [1, 2, 4])
def test_gap_mesh_stage_equals_single_rank_and_jax(worlds, single, refs, n,
                                                   tmp_path, monkeypatch):
    """The stage-2 rerun under TRUST4_TPU_GAP_MESH=n: every rank's
    _cdr3.out and _annot.fa equal the goldens, the port's run without the
    mesh, and the JAX package's mesh pipeline at n shards; every rank ran
    its share of the DP."""
    from trust4_tpu.pipeline.run import run_trust4 as jax_run

    want = single
    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    monkeypatch.setenv("TRUST4_TPU_GAP_MESH", str(n))
    ref = _stage_prefix(str(tmp_path), "jax")
    jax_run(refs[0], refs[1], **_stage_kw(ref, refs))
    assert _read(ref) == want
    results = worlds[n]
    assert len(results) == n
    rows = [sum(res["stage"]["dp_rows"]) for res in results]
    assert len(set(rows)) == 1 and rows[0] > 0, rows
    for r, res in enumerate(results):
        assert res["stage"]["artifacts"] == want, f"{n} ranks, rank {r}"


def _world8(root, refs):
    """Rank body of the world of 8: mesh_tier_counts over all 8 ranks per
    tier, and the pipeline stage under TRUST4_TPU_GAP_MESH=8."""
    import torch.distributed as dist

    from trust4_tpu_torch.parallel import gap_mesh

    m = gap_mesh.make_mesh(8, device="cpu")
    out = {"counts": {}}
    for cap, w, _chunk in _TIERS:
        _pairs, tc, pc, tl, pl = _tier_inputs(cap)
        out["counts"][cap] = gap_mesh.mesh_tier_counts(m, tc, pc, tl, pl,
                                                       w=w)
    out["stage"] = _port_stage(root, refs, 8, f"w8r{dist.get_rank()}")
    return out


@pytest.mark.slow
def test_eight_ranks_equal_jax(refs, single, tmp_path, monkeypatch):
    """A world of 8 ranks (tests/test_gap_mesh.py holds 8 shards): each
    tier's counts equal the JAX package's mesh_tier_counts at 8 shards,
    and every rank's stage-2 rerun equals the goldens and the JAX mesh
    pipeline at 8.  Marked slow: a world of 8 takes this module past a
    minute on an 8-core box."""
    from trust4_tpu.parallel import gap_mesh as jax_gap_mesh
    from trust4_tpu.pipeline.run import run_trust4 as jax_run

    monkeypatch.setenv(rank_mesh.TIMEOUT_ENV, PG_TIMEOUT_S)
    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    monkeypatch.delenv("TRUST4_TPU_GAP_MESH", raising=False)
    results = rank_mesh.spawn(_world8, 8, backend="gloo", device="cpu",
                              args=(str(tmp_path), refs),
                              timeout_s=2 * JOIN_TIMEOUT_S)
    assert len(results) == 8
    for cap, w, _chunk in _TIERS:
        _pairs, tc, pc, tl, pl = _tier_inputs(cap)
        want = jax_gap_mesh.mesh_tier_counts(jax_gap_mesh.make_mesh(8), tc,
                                             pc, tl, pl, w=w)
        for r, res in enumerate(results):
            np.testing.assert_array_equal(res["counts"][cap], want,
                                          err_msg=f"tier {cap}, rank {r}")
    monkeypatch.setenv("TRUST4_TPU_GAP_MESH", "8")
    ref = _stage_prefix(str(tmp_path), "jax")
    jax_run(refs[0], refs[1], **_stage_kw(ref, refs))
    assert _read(ref) == single
    rows = [sum(res["stage"]["dp_rows"]) for res in results]
    assert len(set(rows)) == 1 and rows[0] > 0, rows
    for r, res in enumerate(results):
        assert res["stage"]["artifacts"] == single, f"rank {r}"


def _absent_peer(how):
    """Rank 1 never enters the collective (it sleeps, or it leaves the
    world and exits); rank 0's all-reduce must raise, and says how long
    it waited."""
    import torch
    import torch.distributed as dist

    m = rank_mesh.make_mesh((2,), ("dp",), device="cpu")
    if dist.get_rank() == 1:
        if how == "sleeps":
            time.sleep(30)
        return None
    t0 = time.monotonic()
    try:
        m.all_reduce(torch.ones(3, dtype=torch.int32), dist.ReduceOp.SUM,
                     "dp")
    except RuntimeError as e:
        raise RuntimeError(
            f"collective raised after {time.monotonic() - t0:.2f} s") from e
    return "no error"


@pytest.mark.parametrize("how", ["sleeps", "leaves"])
def test_absent_peer_raises_within_the_timeout(monkeypatch, how):
    monkeypatch.setenv(rank_mesh.TIMEOUT_ENV, "5")
    with pytest.raises(rank_mesh.RankError) as ei:
        rank_mesh.spawn(_absent_peer, 2, backend="gloo", device="cpu",
                        args=(how,), timeout_s=JOIN_TIMEOUT_S)
    assert ei.value.rank == 0, ei.value
    waited = float(re.search(r"collective raised after ([0-9.]+) s",
                             ei.value.traceback).group(1))
    assert waited <= 10.0, waited


def test_pipeline_mesh_needs_a_world_of_n():
    from trust4_tpu_torch.parallel import gap_mesh

    assert gap_mesh.pipeline_mesh(1, device="cpu").shape == (1,)
    with pytest.raises(RuntimeError,
                       match="torchrun --nproc-per-node 2"):
        gap_mesh.pipeline_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        rank_mesh.make_mesh((2, 2), ("dp", "mp"), device="cpu")


def _cli_rank(prefix, refs):
    """Rank body: ``python -m trust4_tpu_torch run`` as torchrun starts it
    (WORLD_SIZE set), the stage-2 rerun under the 2-rank gap mesh; returns
    the prefix this rank wrote and whether it outlived the run."""
    import torch.distributed as dist

    from trust4_tpu_torch import cli
    from trust4_tpu_torch.pipeline import run as run_mod

    used = []
    real = run_mod.run_trust4

    def spy(*a, **kw):
        used.append(kw["output_prefix"])
        return real(*a, **kw)

    run_mod.run_trust4 = spy
    os.environ["TRUST4_TPU_GAP_MESH"] = "2"
    try:
        rc = cli.main(["run", "-f", refs[0], "--ref", refs[1],
                       "-1", prefix + "_toassemble_1.fq",
                       "-2", prefix + "_toassemble_2.fq", "-o", prefix,
                       "--stage", "2", "-t", "2", "--device", "cpu"])
    finally:
        run_mod.run_trust4 = real
    return dist.get_rank(), rc, used, os.path.exists(
        os.path.dirname(used[0]))


def test_cli_run_over_ranks(refs, tmp_path, monkeypatch):
    monkeypatch.setenv(rank_mesh.TIMEOUT_ENV, PG_TIMEOUT_S)
    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    prefix = _stage_prefix(str(tmp_path), "cli")
    res = rank_mesh.spawn(_cli_rank, 2, backend="gloo", device="cpu",
                          args=(prefix, refs), timeout_s=JOIN_TIMEOUT_S)
    assert res[0] == (0, 0, [prefix], True)
    rank, rc, used, kept = res[1]
    assert (rank, rc, kept) == (1, 0, False) and used[0] != prefix
    for suf, text in _read(prefix).items():
        with open(os.path.join(DATA, "gold" + suf)) as f:
            assert text == f.read(), suf
