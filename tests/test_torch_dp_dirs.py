"""The port's traceback-bits DP and its decoder (trust4_tpu_torch/ops/dp.py
``banded_affine_dirs_plain``, ops/dp_dirs.py) against the JAX package's.

The same numpy jobs go through the plain PyTorch version and through
trust4_tpu's XLA mirror ``banded_affine_dirs_xla`` and its Pallas kernel
``banded_affine_dirs_pallas`` (interpret mode on the CPU); the port's
``decode_dirs_counts`` is held against the JAX walker, the native DP's
counts and the port's native twin ``t4_decode_dirs_counts_batch``.
Integer DP: everything is bit-equal (tolerance 0), the whole (N, P, W)
bits tensor included.  The CUDA kernel itself runs only on a card
(tests/test_torch_card.py); its arithmetic runs on the CPU in
tests/test_torch_kernel_host.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from trust4_tpu.ops.dp_pallas import (
    banded_affine_dirs_pallas,
    banded_affine_dirs_xla,
)
from trust4_tpu.ops.dp_pallas import decode_dirs_counts as jax_decode
from trust4_tpu_torch.align.native import global_alignment_counts
from trust4_tpu_torch.ops import dp_dirs
from trust4_tpu_torch.ops.dp import (
    banded_affine_counts_plain,
    banded_affine_dirs_plain,
    encode_for_dp,
)
from trust4_tpu_torch.testing import rand_gap_jobs

BIG_NEG = -(1 << 29)
# The gap-oracle tiers' (cap, band) and one W = 32 shape.
SHAPES = [(16, 16), (48, 24), (40, 32), (144, 48)]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plain(tc, tl, pc, pl, w):
    s, d = banded_affine_dirs_plain(*_t(tc, tl, pc, pl), w)
    return s.numpy(), d.numpy()


def _gap_oracle_pairs(seed, n, hi, w):
    """tests/test_gap_oracle.py ``_rand_pairs`` (N's, zero-length sides,
    indel-heavy pairs), encoded and kept inside the band contract."""
    from test_gap_oracle import _rand_pairs

    pairs = _rand_pairs(np.random.default_rng(seed), n, hi=hi)
    cap = max(max(len(t) for t, p in pairs), max(len(p) for t, p in pairs),
              2)
    tc, tl = encode_for_dp([t for t, _ in pairs], cap)
    pc, pl = encode_for_dp([p for _, p in pairs], cap)
    keep = np.abs(tl - pl) + 11 <= w
    return [(t, p) for (t, p), k in zip(pairs, keep) if k], \
        tc[keep], tl[keep], pc[keep], pl[keep]


@pytest.mark.parametrize("cap,w", SHAPES)
def test_plain_matches_xla_on_tier_jobs(cap, w):
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(cap + w),
                                             200, cap, w)
    want_s, want_d = banded_affine_dirs_xla(tc, tl, pc, pl, w)
    got_s, got_d = _plain(tc, tl, pc, pl, w)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


@pytest.mark.parametrize("w", [16, 24, 32, 48])
def test_plain_matches_xla_on_gap_oracle_pairs(w):
    _pairs, tc, tl, pc, pl = _gap_oracle_pairs(11 + w, 120, 60, w)
    want_s, want_d = banded_affine_dirs_xla(tc, tl, pc, pl, w)
    got_s, got_d = _plain(tc, tl, pc, pl, w)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


@pytest.mark.parametrize("w", [16, 32])
def test_plain_matches_xla_on_arbitrary_rows(w):
    """Random codes incl. N and pad and any lengths: final cells off the
    tile, left bands beyond the pre-shift bucket, rows beyond p_len."""
    rng = np.random.default_rng(300 + w)
    n, t_max, p_max = 200, 40, 50
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = rng.integers(0, p_max + 1, n).astype(np.int32)
    want_s, want_d = banded_affine_dirs_xla(tc, tl, pc, pl, w)
    got_s, got_d = _plain(tc, tl, pc, pl, w)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


def test_plain_matches_pallas_interpret():
    """At most 16 pairs of cap 24 (the Pallas interpreter is slow)."""
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(5), 16,
                                             24, 24)
    want_s, want_d = banded_affine_dirs_pallas(tc, tl, pc, pl, 24)
    got_s, got_d = _plain(tc, tl, pc, pl, 24)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


def test_final_cell_outside_the_tile_scores_big_neg():
    """t_len - p_len >= W-5 puts k_final outside the tile: the masked max
    gives -2^29 (not INT32_MIN as in the scores DP)."""
    w = 16
    tc = np.zeros((4, 60), np.int8)
    pc = np.zeros((4, 60), np.int8)
    tl = np.array([60, 40, 40 + w - 5, 40 + w - 6], np.int32)
    pl = np.array([0, 10, 40, 40], np.int32)
    want_s, _ = banded_affine_dirs_xla(tc, tl, pc, pl, w)
    got_s, _ = _plain(tc, tl, pc, pl, w)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_s[:3], [BIG_NEG] * 3)
    assert got_s[3] > BIG_NEG


def _native_counts(tc, tl, pc, pl):
    return np.array([
        (0, 0, 0) if tl[i] == 0 or pl[i] == 0 else global_alignment_counts(
            "".join("ACGTNP"[c] for c in tc[i, : tl[i]]),
            "".join("ACGTNP"[c] for c in pc[i, : pl[i]]))
        for i in range(len(tl))], dtype=np.int32).reshape(-1, 3)


@pytest.mark.parametrize("cap,w", [(16, 16), (48, 24), (144, 48)])
def test_decode_matches_jax_and_native_dp(cap, w):
    """Tier jobs (zero-length rows included): the port's walker equals
    the JAX walker, the native DP's counts and the counts DP."""
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(50 + w),
                                             150, cap, w)
    assert ((tl == 0) | (pl == 0)).any()
    _s, dirs = _plain(tc, tl, pc, pl, w)
    got = dp_dirs.decode_dirs_counts(torch.from_numpy(dirs), *_t(tc, tl, pc,
                                                               pl),
                                     w=w, p_max=cap).numpy()
    want = np.asarray(jax_decode(dirs, tc, tl, pc, pl, w=w, p_max=cap))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _native_counts(tc, tl, pc, pl))
    _scores, counts = banded_affine_counts_plain(*_t(tc, tl, pc, pl), w)
    np.testing.assert_array_equal(got, counts.numpy())


def test_decode_on_gap_oracle_pairs():
    """The recipe and width of tests/test_gap_oracle.py:54 (("", ""),
    ("ACGT", ""), ("", "ACGT") and ("A", "A") included)."""
    pairs, tc, tl, pc, pl = _gap_oracle_pairs(11, 60, 40, 32)
    _s, dirs = _plain(tc, tl, pc, pl, 32)
    cap = pc.shape[1]
    got = dp_dirs.decode_dirs_counts(torch.from_numpy(dirs), *_t(tc, tl, pc,
                                                               pl),
                                     w=32, p_max=cap).numpy()
    want = np.asarray(jax_decode(dirs, tc, tl, pc, pl, w=32, p_max=cap))
    np.testing.assert_array_equal(got, want)
    for i, (t, p) in enumerate(pairs):
        assert tuple(got[i]) == global_alignment_counts(t, p), (i, t, p)


def _native_decode(dirs, tc, tl, pc, pl, w):
    """The port's native ``t4_decode_dirs_counts_batch`` (libt4align)
    over the same bits."""
    from trust4_tpu_torch.utils.nativebuild import ensure_built

    lib = ctypes.CDLL(ensure_built("libt4align.so"))
    fn = lib.t4_decode_dirs_counts_batch
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                   ctypes.c_char_p, vp]
    fn.restype = ctypes.c_int
    n, p_rows = dirs.shape[:2]
    alphabet = np.frombuffer(b"ACGTNP", np.uint8)
    t_blob = alphabet[tc].tobytes()
    p_blob = alphabet[pc].tobytes()
    left = np.where(tl < pl, 5 + (pl - tl), 5)
    meta6 = np.stack([tl, pl, np.arange(n) * tc.shape[1],
                      np.arange(n) * pc.shape[1], left,
                      np.full(n, p_rows)], axis=1).astype(np.int32)
    job_off = np.arange(n, dtype=np.int64) * p_rows
    dirs = np.ascontiguousarray(dirs)
    out = np.zeros((n, 3), np.int32)
    assert fn(dirs.ctypes.data, job_off.ctypes.data, meta6.ctypes.data, n, w,
              t_blob, p_blob, out.ctypes.data) == 0
    return out


@pytest.mark.parametrize("cap,w", [(16, 16), (48, 24), (144, 48)])
def test_native_decoder_reads_the_same_bits(cap, w):
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(70 + w),
                                             150, cap, w)
    _s, dirs = _plain(tc, tl, pc, pl, w)
    got = dp_dirs.decode_dirs_counts(torch.from_numpy(dirs), *_t(tc, tl, pc,
                                                               pl),
                                     w=w, p_max=cap).numpy()
    np.testing.assert_array_equal(_native_decode(dirs, tc, tl, pc, pl, w),
                                  got)


def test_wrappers_run_the_plain_version_on_cpu():
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(9), 60,
                                             48, 24)
    args = _t(tc, tl, pc, pl)
    launches = dp_dirs.LAUNCHES
    s, d = dp_dirs.banded_affine_dirs(*args, 24)
    want_s, want_d = _plain(tc, tl, pc, pl, 24)
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(d.numpy(), want_d)
    scores, counts = dp_dirs.dirs_counts(*args, 24)
    np.testing.assert_array_equal(scores.numpy(), want_s)
    np.testing.assert_array_equal(
        counts.numpy(), banded_affine_counts_plain(*args, 24)[1].numpy())
    assert dp_dirs.LAUNCHES == launches
    with pytest.raises(ValueError, match="unsupported device"):
        dp_dirs.banded_affine_dirs(*[a.to("meta") for a in args], 24)
