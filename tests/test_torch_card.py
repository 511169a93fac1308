"""Tests of the port that need a CUDA card (marker ``cuda``; they skip
without one).  This file imports only the port, never jax, so it also
runs on the machine with the card:

    python -m pytest -m cuda tests/test_torch_card.py

Each kernel must be bit-equal to its plain PyTorch version (integer DP,
tolerance 0), the wrappers must refuse what the kernels do not take, and
the gap oracle, the prefilter, the realign round and ``entry`` on the
card must give the CPU path's results.
"""

import numpy as np
import pytest
import torch

from trust4_tpu_torch.ops import dp_counts, dp_scores, gap_oracle
from trust4_tpu_torch.ops.dp import (
    banded_affine_counts_plain,
    banded_affine_scores_plain,
)
from trust4_tpu_torch.testing import rand_gap_jobs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cap,w", [(16, 16), (48, 24), (144, 48)])
def test_kernel_matches_plain(card, cap, w):
    rng = np.random.default_rng(cap + w)
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, 3000, cap, w)
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
    launches = dp_counts.LAUNCHES
    s_k, c_k = dp_counts.banded_affine_counts(*args, w)
    pk_k = dp_counts.banded_affine_counts(*args, w, packed=True)
    torch.cuda.synchronize()
    assert dp_counts.LAUNCHES == launches + 2
    s_p, c_p = banded_affine_counts_plain(*args, w)
    assert torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
    assert torch.equal(pk_k,
                       banded_affine_counts_plain(*args, w, packed=True))


def _permutations(t_lens, p_lens, seed):
    """The wrappers' order (dp_counts.job_order) and a random
    permutation, on the card."""
    order = dp_counts.job_order(t_lens, p_lens)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        len(p_lens))).to(p_lens.device)
    return order, perm


@pytest.mark.parametrize("cap,w,n", [(16, 16, 65536), (48, 24, 32768),
                                     (144, 48, 16384), (144, 48, 11000),
                                     (48, 24, 33), (144, 48, 1)])
def test_counts_instances_match_plain(card, cap, w, n):
    """Every (W, L) instance the library exports, at the tier chunks, a
    partial chunk and ragged batches, in the wrapper's order and a random
    permutation, in both epilogues."""
    from trust4_tpu_torch.ops.build import instances

    rng = np.random.default_rng(7000 + n + w)
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, n, cap, w)
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
    s_p, c_p = banded_affine_counts_plain(*args, w)
    pk_p = banded_affine_counts_plain(*args, w, packed=True)
    lanes = [ln for ww, ln in instances("dp_counts") if ww == w]
    assert {1, 4, 8} <= set(lanes)
    for order in _permutations(args[1], args[3], n):
        for ln in lanes:
            s_k, c_k = dp_counts.launch(*args, w, False, ln, order)
            pk_k = dp_counts.launch(*args, w, True, ln, order)
            torch.cuda.synchronize()
            assert torch.equal(s_k, s_p) and torch.equal(c_k, c_p), ln
            assert torch.equal(pk_k, pk_p), ln


@pytest.mark.parametrize("shape", ["random", "realign", "ragged"])
def test_scores_instances_match_plain(card, shape):
    """Every (W, L) instance the library exports: random rows at every
    band width, a realign-sized batch (2,300 100-bp reads against windows
    of their length +-10, W=32) and a ragged batch of 33, in the
    wrapper's order and a random permutation."""
    from trust4_tpu_torch.ops.build import instances

    rng = np.random.default_rng(["random", "realign", "ragged"].index(shape))
    for w in dp_scores.BANDS:
        if shape == "realign" and w != 32:
            continue
        n, t_max, p_max = {"random": (3000, 152, 140), "realign":
                           (2300, 110, 100), "ragged": (33, 60, 52)}[shape]
        tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
        pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
        if shape == "realign":
            pl = np.full(n, 100, np.int32)
            tl = (100 + rng.integers(-10, 11, n)).astype(np.int32)
        else:
            tl = rng.integers(0, t_max + 1, n).astype(np.int32)
            pl = np.clip(tl + rng.integers(-w, w, n), 0, p_max).astype(
                np.int32)
        args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
        want = banded_affine_scores_plain(*args, w)
        for order in _permutations(args[1], args[3], w):
            for ww, ln in instances("dp_scores"):
                if ww == w:
                    got = dp_scores.launch(*args, w, ln, order)
                    assert torch.equal(got, want), (w, ln)


def test_choice_tables_name_exported_instances(card):
    from trust4_tpu_torch.ops.build import instances

    from trust4_tpu_torch.ops import dp_dirs

    assert instances("dp_dirs") == list(dp_dirs.INSTANCES)
    for mod, name in ((dp_counts, "dp_counts"), (dp_scores, "dp_scores"),
                      (dp_dirs, "dp_dirs")):
        built = set(instances(name))
        assert {w for w, _ in built} == set(mod.BANDS)
        for (w, _cls), lanes in mod.CHOICE.items():
            assert (w, lanes) in built, (name, w, lanes)


def test_wrapper_checks_inputs(card):
    tc = torch.zeros((4, 16), dtype=torch.int8, device=card)
    tl = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="band_width"):
        dp_counts.banded_affine_counts(tc, tl, tc, tl, 32)
    with pytest.raises(TypeError):
        dp_counts.banded_affine_counts(tc.int(), tl, tc, tl, 16)
    with pytest.raises(ValueError, match="contiguous"):
        dp_counts.banded_affine_counts(tc.t().contiguous().t(), tl, tc, tl,
                                       16)
    with pytest.raises(ValueError, match="one device"):
        dp_counts.banded_affine_counts(tc, tl.cpu(), tc, tl, 16)


def test_gap_oracle_card_matches_cpu(card):
    from trust4_tpu_torch.engine import overlap_native

    class _SW:
        def __init__(self, s):
            self.consensus = s

    rng = np.random.default_rng(31)
    seqs = ["".join(rng.choice(list("ACGTN"), 220)) for _ in range(4)]
    reads = ["".join(rng.choice(list("ACGTN"), 200)) for _ in range(6)]
    eng = overlap_native.NativeOverlapEngine(9)
    for i, s in enumerate(seqs):
        eng.reg_seq(i, True, -1, f"ref{i}", s, None, -1)
    jobs = []
    for _ in range(900):
        t_len = int(rng.choice([6, 12, 30, 44, 120, 160]))
        r_len = max(1, t_len + int(rng.integers(-4, 5)))
        jobs.append((int(rng.integers(0, 6)), 0, 0, int(rng.integers(0, 4)),
                     int(rng.integers(0, 8)) * 5, t_len,
                     int(rng.integers(0, 200 - r_len + 1)), r_len))
    gap_jobs = np.array(jobs, dtype=np.int32)
    sws = [_SW(s) for s in seqs]
    launches = dp_counts.LAUNCHES
    on_card = gap_oracle.gap_counts(eng, reads, gap_jobs, sws, device=card)
    assert dp_counts.LAUNCHES > launches
    np.testing.assert_array_equal(
        on_card,
        gap_oracle.gap_counts(eng, reads, gap_jobs, sws, device="cpu"),
    )


@pytest.mark.parametrize("w", dp_scores.BANDS)
def test_scores_kernel_matches_plain(card, w):
    """Random codes incl. N and pad, any lengths: in band, out of band
    (INT32_MIN), zero-length rows."""
    rng = np.random.default_rng(500 + w)
    n, t_max, p_max = 4000, 152, 140
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = np.clip(tl + rng.integers(-w, w, n), 0, p_max).astype(np.int32)
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
    launches = dp_scores.LAUNCHES
    got = dp_scores.banded_affine_scores(*args, w)
    torch.cuda.synchronize()
    assert dp_scores.LAUNCHES == launches + 1
    assert torch.equal(got, banded_affine_scores_plain(*args, w))


def test_scores_wrapper_checks_inputs(card):
    tc = torch.zeros((4, 16), dtype=torch.int8, device=card)
    tl = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="band_width"):
        dp_scores.banded_affine_scores(tc, tl, tc, tl, 20)
    with pytest.raises(TypeError):
        dp_scores.banded_affine_scores(tc.int(), tl, tc, tl, 32)
    with pytest.raises(ValueError, match="one device"):
        dp_scores.banded_affine_scores(tc, tl.cpu(), tc, tl, 32)


def test_entry_card_matches_cpu(card):
    from trust4_tpu_torch.entry import entry

    fn, args = entry(device="cuda")
    launches = dp_scores.LAUNCHES
    got = fn(*args).cpu()
    assert dp_scores.LAUNCHES == launches + 1
    fn_c, args_c = entry(device="cpu")
    assert torch.equal(got, fn_c(*args_c))


def test_prefilter_and_realign_card_match_cpu(card):
    from trust4_tpu_torch.ops.prefilter import TpuPrefilter
    from trust4_tpu_torch.parallel import realign_round

    rng = np.random.default_rng(77)
    germ = ["".join(rng.choice(list("ACGT"), 400)) for _ in range(30)]
    reads = ["".join(rng.choice(list("ACGT"), 100)) for _ in range(200)]
    reads += [g[i : i + 100] for g in germ[:10] for i in (0, 150, 290)]
    contigs = [g[50:350] for g in germ[:12]]
    for hit_len in (23, 80):
        masks = [TpuPrefilter(germ, hit_len_required=hit_len, device=d)(
            reads, pad_len=100) for d in ("cuda", "cpu")]
        np.testing.assert_array_equal(*masks)
    launches = dp_scores.LAUNCHES
    on_card = realign_round(reads, contigs, germ, device="cuda", chunk=64)
    assert dp_scores.LAUNCHES > launches
    on_cpu = realign_round(reads, contigs, germ, device="cpu")
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert on_cpu[4] > 0 and (on_cpu[1] > -(1 << 29)).sum() > 0


@pytest.mark.parametrize("cap,w", [(16, 16), (48, 24), (144, 48)])
def test_dirs_kernel_matches_plain_and_counts(card, cap, w):
    """Scores and the whole (N, P, W) bits tensor bit-equal to the plain
    version; the decoded counts equal the counts kernel's."""
    from trust4_tpu_torch.ops import dp_dirs
    from trust4_tpu_torch.ops.dp import banded_affine_dirs_plain

    rng = np.random.default_rng(900 + cap)
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, 2000, cap, w)
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
    launches = (dp_dirs.LAUNCHES, dp_dirs.DECODE_LAUNCHES)
    s_k, c_k = dp_dirs.dirs_counts(*args, w)
    torch.cuda.synchronize()
    assert (dp_dirs.LAUNCHES, dp_dirs.DECODE_LAUNCHES) == (
        launches[0] + 1, launches[1] + 1)
    s_p, d_p = banded_affine_dirs_plain(*args, w)
    _s, d_k = dp_dirs.banded_affine_dirs(*args, w)
    assert torch.equal(s_k, s_p) and torch.equal(d_k, d_p)
    assert torch.equal(c_k, dp_counts.banded_affine_counts(*args, w)[1])


@pytest.mark.parametrize("cap,w,n", [(144, 48, 3000), (37, 24, 33)])
def test_dirs_instances_match_plain(card, cap, w, n):
    """Every dirs instance the library exports and the wrapper's choice,
    at a tier shape and at 33 ragged jobs with an odd p_max (blocks of
    bits only 8-byte aligned, a tail of rows at every L): scores and the
    whole (N, P, W) bits tensor bit-equal to the plain version."""
    from trust4_tpu_torch.ops import dp_dirs
    from trust4_tpu_torch.ops.build import instances
    from trust4_tpu_torch.ops.dp import banded_affine_dirs_plain

    rng = np.random.default_rng(9100 + n)
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, n, cap, w)
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
    want = banded_affine_dirs_plain(*args, w)
    lanes = [ln for ww, ln in instances("dp_dirs") if ww == w]
    assert dp_dirs.lanes_for(n, w) in lanes
    for ln in lanes + [None]:
        got = dp_dirs.banded_affine_dirs(*args, w, lanes=ln)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), ln


@pytest.mark.parametrize("cap,w", [(16, 16), (48, 24), (144, 48)])
def test_decoder_kernel_matches_plain_and_counts(card, cap, w):
    """The decoder kernel's counts equal the plain decoder's on the same
    bits and the counts kernel's (#1) on the same jobs."""
    from trust4_tpu_torch.ops import dp_dirs

    rng = np.random.default_rng(9200 + cap)
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, 2000, cap, w)
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
    _s, dirs = dp_dirs.banded_affine_dirs(*args, w)
    launches = dp_dirs.DECODE_LAUNCHES
    got = dp_dirs.decode_dirs_counts(dirs, *args, w=w, p_max=cap)
    torch.cuda.synchronize()
    assert dp_dirs.DECODE_LAUNCHES == launches + 1
    assert got.device.type == "cuda"
    assert torch.equal(got, dp_dirs.decode_dirs_counts_plain(
        dirs, *args, w=w, p_max=cap))
    assert torch.equal(got, dp_counts.banded_affine_counts(*args, w)[1])


def test_dirs_launch_failures_raise(card, monkeypatch):
    """A failed launch of either kernel raises; nothing falls back to the
    plain version or the CPU."""
    from trust4_tpu_torch.ops import build, dp_dirs

    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(9300),
                                             64, 16, 16)
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
    _s, dirs = dp_dirs.banded_affine_dirs(*args, 16)

    class Failing:
        def t4_dp_dirs(self, *a):
            return 719  # cudaErrorLaunchFailure

        t4_dp_decode = t4_dp_dirs

    monkeypatch.setattr(build, "load", lambda name: Failing())
    launches = (dp_dirs.LAUNCHES, dp_dirs.DECODE_LAUNCHES)
    with pytest.raises(RuntimeError, match="t4_dp_decode launch failed"):
        dp_dirs.decode_dirs_counts(dirs, *args, w=16, p_max=16)
    with pytest.raises(RuntimeError, match="t4_dp_dirs launch failed"):
        dp_dirs.banded_affine_dirs(*args, 16)
    with pytest.raises(RuntimeError, match="t4_dp_dirs launch failed"):
        dp_dirs.dirs_counts(*args, 16)
    assert (dp_dirs.LAUNCHES, dp_dirs.DECODE_LAUNCHES) == launches


def test_lab_kernels_match_plain(card):
    """Every built instance of the lab's kernels, each (L, flag) of the
    ablation kernel and each (L, G) of the interleaved one, against its
    plain version, through the wrappers (the scores wrapper's job order)
    and in a random order; an L or a flag set not built raises."""
    from trust4_tpu_torch.tools import dp_kernel_lab as lab

    rng = np.random.default_rng(901)
    n, t_max, p_max = 3001, 152, 140
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = np.clip(tl + rng.integers(-32, 32, n), 0, p_max).astype(np.int32)
    args = dp_counts.to_device_jobs(tc, tl, pc, pl, card)
    perm = torch.from_numpy(rng.permutation(n)).to(card)
    flag_name = {0: None, **{v: k for k, v in lab.ABL_FLAGS.items()}}
    assert lab.instances("abl") == [
        (ln, f) for ln in lab.LANES for f in flag_name]
    assert lab.instances("inter") == [
        (ln, g) for ln in lab.LANES for g in lab.GROUPS]
    want = banded_affine_scores_plain(*args, 32)
    for lanes, g in lab.instances("inter"):
        assert torch.equal(lab.scores_inter(*args, 32, g, lanes), want), \
            (lanes, g)
        assert torch.equal(lab.launch("inter", g, *args, 32, lanes, perm),
                           want), (lanes, g)
    for flags, name in flag_name.items():
        ablate = frozenset([name] if name else [])
        ref = lab.banded_affine_scores_ablated(*args, 32, ablate)
        for lanes in lab.LANES:
            got = lab.scores_abl(*args, 32, ablate, lanes)
            assert torch.equal(got, ref), (name, lanes)
            assert torch.equal(
                lab.launch("abl", flags, *args, 32, lanes, perm), ref), \
                (name, lanes)
            if name is None:
                assert torch.equal(got, dp_scores.launch(
                    *args, 32, lanes, dp_counts.job_order(args[1], args[3])))
    with pytest.raises(ValueError, match="one flag"):
        lab.scores_abl(*args, 32, {"nosub", "noscan"})
    for bad in (2, 32):
        with pytest.raises(ValueError, match="built for L"):
            lab.scores_inter(*args, 32, 2, bad)
        with pytest.raises(ValueError, match="built for L"):
            lab.scores_abl(*args, 32, lanes=bad)


def test_microbench_bodies_match_plain(card):
    from trust4_tpu_torch.tools import vpu_microbench as vb

    for name, w, lanes, _label, _k in vb.CASES:
        x = torch.from_numpy(vb.make_tile(w, lanes)).to(card)
        assert torch.equal(vb.run_body(name, x), vb.plain_body(name, x)), (
            name, w, lanes)


def _two_rank_counts(tc, tl, pc, pl, w):
    """Rank body: mesh_tier_counts over both ranks of the world, and the
    counts kernel's launches on this rank."""
    from trust4_tpu_torch.parallel import gap_mesh

    dp_counts.LAUNCHES = 0
    got = gap_mesh.mesh_tier_counts(gap_mesh.make_mesh(2), tc, pc, tl, pl,
                                    w=w)
    return got, dp_counts.LAUNCHES


def test_gap_mesh_over_two_ranks_on_one_card(card, monkeypatch):
    """Two ranks share the card (gloo, host copies for the collective):
    each launches the counts kernel on its half, and both return the
    single-card counts."""
    from trust4_tpu_torch.parallel import mesh

    monkeypatch.setenv(mesh.TIMEOUT_ENV, "60")
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(7), 3001,
                                             144, 48)
    want = dp_counts.banded_affine_counts(
        *dp_counts.to_device_jobs(tc, tl, pc, pl, card), 48)[1].cpu().numpy()
    res = mesh.spawn(_two_rank_counts, 2, backend="gloo", device="cuda:0",
                     args=(tc, tl, pc, pl, 48), timeout_s=120)
    for got, launches in res:
        np.testing.assert_array_equal(got, want)
        assert launches == 1


def _card_vs_device0(tmp_path, monkeypatch, run):
    """run(out_dir) on the card, then with TRUST4_TPU_DEVICE=0: every file
    byte-identical, and the counts kernel launched on the card."""
    import filecmp
    import os

    dirs = {}
    for mode in ("card", "cpu"):
        d = tmp_path / mode
        d.mkdir()
        if mode == "cpu":
            monkeypatch.setenv("TRUST4_TPU_DEVICE", "0")
        launches = dp_counts.LAUNCHES
        run(str(d))
        torch.cuda.synchronize()
        if mode == "card":
            assert dp_counts.LAUNCHES > launches
        dirs[mode] = str(d)
    names = sorted(os.listdir(dirs["card"]))
    assert names and names == sorted(os.listdir(dirs["cpu"]))
    for n in names:
        assert filecmp.cmp(os.path.join(dirs["card"], n),
                           os.path.join(dirs["cpu"], n), shallow=False), n
    return dirs


def test_barcoded_run_card_matches_device0(card, tmp_path, monkeypatch):
    import os

    from trust4_tpu_torch import testing
    from trust4_tpu_torch.pipeline.run import run_trust4

    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    data = os.path.join(os.path.dirname(__file__), "data")
    coord, imgt = testing.write_standin_references(str(tmp_path / "ref"))
    out = tmp_path / "out"
    out.mkdir()
    _card_vs_device0(out, monkeypatch, lambda d: run_trust4(
        coord, imgt,
        read1_files=[os.path.join(data, "gold_toassemble_1.fq")],
        read2_files=[os.path.join(data, "gold_toassemble_2.fq")],
        barcode_files=[os.path.join(data, "bc", "bc.fq")],
        barcode_whitelist=os.path.join(data, "bc", "bc_wl.txt"),
        output_prefix=os.path.join(d, "bc"), device="cuda"))


def test_bam_run_card_matches_device0(card, tmp_path, monkeypatch):
    import os

    from trust4_tpu_torch import testing
    from trust4_tpu_torch.pipeline.run import run_trust4

    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    coord, imgt = testing.write_standin_references(str(tmp_path / "ref"),
                                                   coordinates=True)
    bam = str(tmp_path / "bulk.bam")
    testing.write_standin_bam(bam, coord, 3000, seed=12)
    out = tmp_path / "out"
    out.mkdir()
    _card_vs_device0(out, monkeypatch, lambda d: run_trust4(
        coord, imgt, bam_file=bam, output_prefix=os.path.join(d, "bam"),
        device="cuda"))


def test_fuzz_seeds_card_match_device0(card, tmp_path, monkeypatch):
    """Three of the fuzz harness's seeds at full size (bulk pe, bulk long,
    barcoded with --contigMinCov): the card in the shipping mode against
    TRUST4_TPU_DEVICE=0, every file byte-identical."""
    from trust4_tpu_torch import testing
    from trust4_tpu_torch.tools import fuzz_differential as fz

    monkeypatch.delenv("TRUST4_TPU_DEVICE", raising=False)
    refs = testing.write_standin_references(str(tmp_path / "ref"))
    for kind, seed in (("bulk", 9000), ("bulk", 9004), ("barcoded", 9000)):
        rec = fz.run_seed(seed, kind, str(tmp_path), refs, device="cuda")
        assert rec["mismatches"] == [], fz.seed_line(rec)
        assert rec["launches"] > 0 and rec["off"]["launches"] == 0


def test_debug_trace_tool_on_card(card):
    """The gold reads' TRUST4_TPU_DEBUG=1 assembly trace in the shipping
    mode on the card, byte-identical to TRUST4_TPU_DEVICE=0's."""
    import os
    import subprocess
    import sys

    from trust4_tpu_torch.tools import debug_trace_check as dt

    r = subprocess.run(
        [sys.executable, "-m", "trust4_tpu_torch.tools.debug_trace_check",
         "--device", "cuda"], capture_output=True, text=True, cwd=dt.REPO,
        timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    assert r.stdout.splitlines() == [
        "gold: debug trace identical (8234 lines)"]


def test_native_dir_on_card(card, tmp_path):
    """TRUST4_TPU_NATIVE_DIR on the card's machine: a fresh process loads
    all four libraries from the named copy of native/."""
    import os

    from test_torch_native_dir import LIBS, loaded_from, native_copy

    d = native_copy(str(tmp_path / "native"))
    maps = loaded_from(d)
    for lib in LIBS:
        assert [os.path.dirname(os.path.realpath(p)) for p in maps[lib]] == [
            os.path.realpath(d)], (lib, maps)
