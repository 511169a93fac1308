"""The port's kernel lab (trust4_tpu_torch/tools/dp_kernel_lab.py) against
the JAX package's tools/dp_kernel_lab.py, on the CPU.

The lab kernels' plain versions are ``banded_affine_scores_plain`` (for
``scores_inter``) and ``banded_affine_scores_ablated`` (for
``scores_abl``).  Here they must equal, bit for bit (integer DP,
tolerance 0), the JAX lab's Pallas kernels in interpret mode on pairs
inside ``band_ok``: ``scores_inter_host`` (G = 2) and ``scores_abl_host``
with no flag, ``nosub`` and ``noscan`` (the other flags remove pieces of
the TPU layout, whose wrong scores depend on that layout).  Each flag's
plain ablated version is pinned on a small case checked by hand, and the
input preparations equal their JAX twins.  The JAX tool is imported by
path; it runs on the CPU.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from trust4_tpu_torch.ops.dp import (
    band_ok,
    banded_affine_scores_plain,
    encode_for_dp,
)
from trust4_tpu_torch.tools import dp_kernel_lab as lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_lab():
    spec = importlib.util.spec_from_file_location(
        "jax_dp_kernel_lab", os.path.join(REPO, "tools", "dp_kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _band_pairs(seed, n=128, length=24, w=32):
    """Mutated copies with N's and lengths inside band_ok at width w."""
    rng = np.random.default_rng(seed)
    tc = rng.integers(0, 4, (n, length)).astype(np.int8)
    pc = tc.copy()
    sub = rng.random((n, length)) < 0.1
    pc[sub] = rng.integers(0, 5, int(sub.sum()))
    tl = rng.integers(1, length + 1, n).astype(np.int32)
    pl = np.clip(tl + rng.integers(-(w - 11), w - 10, n), 1,
                 length).astype(np.int32)
    assert band_ok(tl, pl, w).all()
    return tc, tl, pc, pl


def test_inter_plain_matches_jax_inter_interpret(jax_lab):
    tc, tl, pc, pl = _band_pairs(1)
    want = np.asarray(jax_lab.scores_inter_host(tc, tl, pc, pl, 32, 2))
    np.testing.assert_array_equal(
        lab.scores_inter(*_t(tc, tl, pc, pl), 32, 2).numpy(), want)
    np.testing.assert_array_equal(
        banded_affine_scores_plain(*_t(tc, tl, pc, pl), 32).numpy(), want)


@pytest.mark.parametrize("flag", [None, "nosub", "noscan"])
def test_ablated_plain_matches_jax_abl_interpret(jax_lab, flag):
    """The JAX kernel reads its module's ABL set at trace time: set it,
    clear the jit caches, and restore both afterwards."""
    tc, tl, pc, pl = _band_pairs(2)
    ablate = {flag} if flag else set()
    saved = set(jax_lab.ABL)
    jax_lab.ABL.clear()
    jax_lab.ABL.update(ablate)
    jax.clear_caches()
    try:
        want = np.asarray(jax_lab.scores_abl_host(tc, tl, pc, pl, 32))
    finally:
        jax_lab.ABL.clear()
        jax_lab.ABL.update(saved)
        jax.clear_caches()
    got = lab.scores_abl(*_t(tc, tl, pc, pl), 32, ablate).numpy()
    np.testing.assert_array_equal(got, want)
    if flag:  # the flag changes the scores of these pairs
        assert (got != banded_affine_scores_plain(
            *_t(tc, tl, pc, pl), 32).numpy()).any()


def _score(t, p, flags=()):
    tc, tl = encode_for_dp([t], max(len(t), 1))
    pc, pl = encode_for_dp([p], max(len(p), 1))
    return int(lab.banded_affine_scores_ablated(*_t(tc, tl, pc, pl), 32,
                                                set(flags))[0])


# (text, query, flag, score with all pieces, score with the flag), each
# checked by hand with match +2, mismatch -2, gap open -4, extend -1 and
# the boundaries m[0][j] = -4 - 4j, m[i][0] = -4 - 4i:
HAND_CASES = [
    # four mismatches; with every substitution +2, four matches.
    ("AAAA", "CCCC", "nosub", -8, 8),
    # four matches and a 2-gap at the end (8 - 6); with no horizontal
    # gaps the path must start at m[0][2] = -12 and mismatch GTAC/ACGT.
    ("ACGTAC", "ACGT", "noscan", 2, -20),
    # a match and a 1-gap (2 - 5); with the "vertical" neighbour being
    # the diagonal one, the best is m[1][0] = -8 then the match.
    ("A", "AA", "noshift", -3, -6),
    # A/A then G/C (0); reading row 1's window and base, every diagonal
    # cell compares t[0] with p[0]: two matches.
    ("AG", "AC", "statload", 0, 4),
    ("AG", "AC", "notslice", 0, 4),
    # m[1][0] = -8 then the match A/A (-6); with no column-0 case that
    # cell is out of band and the best is C/A then a 1-gap (-7).
    ("A", "CA", "nojz", -6, -7),
]


@pytest.mark.parametrize("t,p,flag,full,ablated", HAND_CASES)
def test_each_flag_pinned_by_hand(t, p, flag, full, ablated):
    assert _score(t, p) == full
    assert _score(t, p, [flag]) == ablated


def test_nokir_leaves_scores_alone():
    """nokir drops the band masks on base and e.  An unmasked e right of
    the band reaches an in-band cell only by a run of row 0 at least five
    columns past the band, never the best path: the scores do not move
    (the kernel still runs without the masks; the lab times that)."""
    for t, p, _flag, full, _ablated in HAND_CASES:
        assert _score(t, p, ["nokir"]) == full
    rng = np.random.default_rng(4)
    n, t_max, p_max = 300, 40, 40
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = np.clip(tl + rng.integers(-30, 30, n), 0, p_max).astype(np.int32)
    args = _t(tc, tl, pc, pl)
    np.testing.assert_array_equal(
        lab.banded_affine_scores_ablated(*args, 32, {"nokir"}).numpy(),
        banded_affine_scores_plain(*args, 32).numpy())


def test_parse_ablate_and_wrapper_checks():
    assert lab.parse_ablate("") == frozenset()
    assert lab.parse_ablate("nosub, noscan") == {"nosub", "noscan"}
    with pytest.raises(ValueError, match="unknown DP_ABLATE"):
        lab.parse_ablate("nosub,bogus")
    tc, tl, pc, pl = _band_pairs(3, n=8)
    with pytest.raises(ValueError, match="groups"):
        lab.scores_inter(*_t(tc, tl, pc, pl), 32, 3)
    launches = dict(lab.LAUNCHES)
    lab.scores_abl(*_t(tc, tl, pc, pl), 32, {"nosub", "noscan"})
    assert lab.LAUNCHES == launches
    with pytest.raises(ValueError, match="unsupported device"):
        lab.scores_abl(*[a.to("meta") for a in _t(tc, tl, pc, pl)], 32)


@pytest.mark.parametrize("lanes", [None, 1, 4, 8, 16])
def test_lanes_run_the_plain_version_on_the_cpu(lanes):
    """Every built L, and None (each wrapper's default), runs the plain
    version on a CPU tensor and counts no launch; an L the kernels are
    not built for raises ValueError on the CPU as on the card."""
    tc, tl, pc, pl = _band_pairs(5, n=16)
    args = _t(tc, tl, pc, pl)
    launches = dict(lab.LAUNCHES)
    want = banded_affine_scores_plain(*args, 32)
    for g in lab.GROUPS:
        assert torch.equal(lab.scores_inter(*args, 32, g, lanes=lanes), want)
    assert torch.equal(lab.scores_abl(*args, 32, lanes=lanes), want)
    assert torch.equal(
        lab.scores_abl(*args, 32, {"noscan"}, lanes=lanes),
        lab.banded_affine_scores_ablated(*args, 32, {"noscan"}))
    assert lab.LAUNCHES == launches
    for bad in (0, 2, 3, 32):
        with pytest.raises(ValueError, match="built for L"):
            lab.scores_inter(*args, 32, 2, lanes=bad)
        with pytest.raises(ValueError, match="built for L"):
            lab.scores_abl(*args, 32, lanes=bad)


def test_prep_modes_match_jax(jax_lab):
    tc, tl, pc, pl, w = jax_lab.make_inputs(200, 40, 32, seed=5)
    tl = tl.copy()
    tl[::7] = 30  # left bands above 5
    args = _t(tc, tl, pc, pl)
    for got, want in (
        (lab.prep_only(*args, w), jax_lab.prep_only(tc, tl, pc, pl, w)),
        ((lab.transpose_only(args[0]),), (jax_lab.transpose_only(tc),)),
        ((lab.gather_only(args[0], args[1], args[3]),),
         (jax_lab.gather_only(tc, tl, pl),)),
        ((lab.selshift_prep(args[0], args[1], args[3]),),
         (jax_lab.selshift_prep(tc, tl, pl),)),
    ):
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_tool_runs_every_mode_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("DP_ABLATE", "noscan")
    assert lab.main(list(lab.MODES) + ["--device", "cpu", "--n", "64"]) == 0
    out = capsys.readouterr().out
    assert "[abl noscan]" in out and "scores match base: False" in out
    assert "[inter4]" in out and "ms/launch" in out
    res = lab.run_modes(["base", "inter2", "abl"], "cpu", n=64, n_timed=1)
    assert all(r["match_base"] for r in res.values())
