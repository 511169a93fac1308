"""The port's banded scores DP against the JAX package, on the CPU.

``banded_affine_scores_plain`` (trust4_tpu_torch/ops/dp.py) is the plain
version of the scores kernel (csrc/dp_scores.cu) and the spec it is held
to.  Here it must equal, bit for bit (integer DP, tolerance 0):
trust4_tpu's XLA ``banded_affine_scores`` at every compiled band width,
zero-length rows and final cells outside the band included; the Pallas
kernel ``banded_affine_scores_pallas`` in interpret mode inside band_ok;
and the port's host ``global_alignment`` score.  On a CPU tensor the
wrapper ``ops/dp_scores.banded_affine_scores`` is the plain version.
"""

import numpy as np
import pytest
import torch

from trust4_tpu.ops.dp_batch import banded_affine_scores as xla_scores
from trust4_tpu.ops.dp_pallas import banded_affine_scores_pallas
from trust4_tpu_torch.align import host as port_host
from trust4_tpu_torch.ops import dp_scores
from trust4_tpu_torch.ops.dp import (
    band_ok,
    banded_affine_scores_plain,
    encode_for_dp,
)

INT32_MIN = np.iinfo(np.int32).min


def _plain(tc, tl, pc, pl, w):
    return banded_affine_scores_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in (tc, tl, pc, pl)],
        w).numpy()


def _rand_pairs(rng, n, lo=20, hi=120, max_diff=6):
    """Mutated copies (substitutions incl. N) with lengths up to max_diff
    apart: the recipe of tests/test_dp_pallas.py ``_rand_pairs``."""
    pairs = []
    for _ in range(n):
        lt = int(rng.integers(lo, hi))
        lp = int(np.clip(lt + rng.integers(-max_diff, max_diff + 1), 5, hi))
        t = "".join(rng.choice(list("ACGT"), lt))
        p_list = list(t[:lp].ljust(lp, "A"))
        for _ in range(int(rng.integers(0, 6))):
            p_list[int(rng.integers(0, lp))] = rng.choice(list("ACGTN"))
        pairs.append((t, "".join(p_list)))
    return pairs


def _encode(pairs):
    tc, tl = encode_for_dp([t for t, _ in pairs],
                           max(len(t) for t, _ in pairs))
    pc, pl = encode_for_dp([p for _, p in pairs],
                           max(len(p) for _, p in pairs))
    return tc, tl, pc, pl


@pytest.mark.parametrize("w", [16, 24, 32, 48])
def test_plain_matches_xla_in_band_with_zero_rows(w):
    rng = np.random.default_rng(100 + w)
    pairs = _rand_pairs(rng, 160, hi=90, max_diff=w - 11)
    tc, tl, pc, pl = _encode(pairs)
    tl[::17] = 0
    pl[5::19] = 0
    assert band_ok(tl[tl * pl > 0], pl[tl * pl > 0], w).all()
    want = np.asarray(xla_scores(tc, tl, pc, pl, w))
    np.testing.assert_array_equal(_plain(tc, tl, pc, pl, w), want)


@pytest.mark.parametrize("w", [16, 24, 32, 48])
def test_plain_matches_xla_on_arbitrary_rows(w):
    """Random codes incl. N and pad and any lengths: out-of-band final
    cells, rows beyond p_len, lengths of zero."""
    rng = np.random.default_rng(200 + w)
    n, t_max, p_max = 300, 70, 50
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = rng.integers(0, p_max + 1, n).astype(np.int32)
    want = np.asarray(xla_scores(tc, tl, pc, pl, w))
    np.testing.assert_array_equal(_plain(tc, tl, pc, pl, w), want)


def test_plain_matches_pallas_interpret():
    """The size of tests/test_dp_pallas.py:37 on the CPU."""
    pairs = _rand_pairs(np.random.default_rng(3), 16, hi=60)
    tc, tl, pc, pl = _encode(pairs)
    want = np.asarray(banded_affine_scores_pallas(tc, tl, pc, pl, 32))
    np.testing.assert_array_equal(_plain(tc, tl, pc, pl, 32), want)


def test_plain_matches_host_global_alignment():
    pairs = _rand_pairs(np.random.default_rng(7), 40, lo=15, hi=100,
                        max_diff=15)
    got = _plain(*_encode(pairs), 32)
    for i, (t, p) in enumerate(pairs):
        want, _ = port_host.global_alignment(t, p)
        assert got[i] == want, (i, t, p)


@pytest.mark.parametrize("w", [16, 32])
def test_final_cell_outside_band_is_int32_min(w):
    """t_len - p_len >= W-5 puts k_final = t_len-p_len+5 outside the band:
    XLA's out-of-range gather gives INT32_MIN (the Pallas kernel gives
    -2^29 there; the band contract excludes these pairs)."""
    tc = np.zeros((4, 60), np.int8)
    pc = np.zeros((4, 60), np.int8)
    tl = np.array([60, 40, 40 + w - 5, 40 + w - 6], np.int32)
    pl = np.array([0, 10, 40, 40], np.int32)
    want = np.asarray(xla_scores(tc, tl, pc, pl, w))
    got = _plain(tc, tl, pc, pl, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:3], [INT32_MIN] * 3)
    assert got[3] > INT32_MIN


def test_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(11)
    tc, tl, pc, pl = _encode(_rand_pairs(rng, 30))
    args = [torch.from_numpy(a) for a in (tc, tl, pc, pl)]
    launches = dp_scores.LAUNCHES
    # Any band width on the CPU; the kernel takes only dp_scores.BANDS.
    for w in (20, 32):
        np.testing.assert_array_equal(
            dp_scores.banded_affine_scores(*args, w).numpy(),
            _plain(tc, tl, pc, pl, w))
    assert dp_scores.LAUNCHES == launches
    with pytest.raises(ValueError, match="unsupported device"):
        dp_scores.banded_affine_scores(*[a.to("meta") for a in args], 32)
