"""The group DP sweeps of the counts and scores kernels, run on the CPU.

csrc/dp_counts_group.cuh and csrc/dp_scores_group.cuh spread a job's band
over a group of L lanes that trade values through the exchange of
csrc/dp_lanes.cuh.  g++ builds them here with the host exchange, which
runs the L lanes of a group in lockstep over arrays, behind a shim that
walks the jobs as the CUDA kernels do: job order[g] in slot g, 32/L groups
to a warp that loops to its longest job's rows, slots past n sweeping
with no job and writing nothing, the result written at index order[g].
Every (W, L) instance must equal the plain PyTorch versions bit for bit.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from trust4_tpu_torch.ops import dp_counts, dp_scores
from trust4_tpu_torch.ops.build import CSRC_DIR
from trust4_tpu_torch.ops.dp import (
    banded_affine_counts_plain,
    banded_affine_scores_plain,
)
from trust4_tpu_torch.testing import rand_gap_jobs

_SHIM = r"""
#include <algorithm>
#include <vector>
#include "dp_counts_group.cuh"
#include "dp_scores_group.cuh"

// The kernels' walk over the jobs: group g takes job order[g]; the groups
// of a warp loop to the longest job's rows among them and sweep the
// widest tile among their narrow_width choices (narrow = 0: the W tile).
template <int W, int L, class F>
static void walk(const int32_t* tl, const int32_t* pl, const int64_t* order,
                 int n, int p_max, int narrow, F job) {
  constexpr int G = 32 / L;
  const int slots = (n + G - 1) / G * G;
  for (int w0 = 0; w0 < slots; w0 += G) {
    int warp_rows = 0, warp_width = t4dp::narrow_width<W, L>(0);
    for (int g = w0; g < w0 + G && g < n; ++g) {
      const int b = (int)order[g];
      warp_rows = std::max(warp_rows, std::min((int)pl[b], p_max));
      warp_width = std::max(
          warp_width, t4dp::narrow_width<W, L>(t4dp::band_need(tl[b], pl[b])));
    }
    if (!narrow) warp_width = W;
    for (int g = w0; g < w0 + G; ++g)
      job(t4dp::HostLanes<L>{warp_rows, warp_width},
          g < n ? (int)order[g] : -1);
  }
}

template <int W, int L>
static void counts(const int8_t* t, const int32_t* tl, const int8_t* p,
                   const int32_t* pl, const int64_t* order, int n, int t_max,
                   int p_max, int narrow, int packed, int32_t* scores,
                   int32_t* out) {
  std::vector<int8_t> none_t(t_max + 1, 0), none_p(p_max + 1, 0);
  walk<W, L>(tl, pl, order, n, p_max, narrow,
             [&](const t4dp::HostLanes<L>& x, int b) {
    int sc[L], pk[L];
    bool own[L];
    t4dp::dp_counts_narrow<W, L>(
        x, b >= 0 ? t4dp::band_need(tl[b], pl[b]) : 0,
        b >= 0 ? t + (size_t)b * t_max : none_t.data(), t_max,
        b >= 0 ? p + (size_t)b * p_max : none_p.data(), p_max,
        b >= 0 ? tl[b] : 0, b >= 0 ? pl[b] : 0, sc, pk, own);
    for (int s = 0; s < L; ++s)
      if (b >= 0 && own[s])
        t4dp::store_counts(packed, b, sc[s], pk[s], scores, out);
  });
}

template <int W, int L>
static void scores_(const int8_t* t, const int32_t* tl, const int8_t* p,
                    const int32_t* pl, const int64_t* order, int n,
                    int t_max, int p_max, int narrow, int32_t* out) {
  std::vector<int8_t> none_t(t_max + 1, 0), none_p(p_max + 1, 0);
  walk<W, L>(tl, pl, order, n, p_max, narrow,
             [&](const t4dp::HostLanes<L>& x, int b) {
    int sc[L];
    bool own[L];
    t4dp::dp_scores_narrow<W, L>(
        x, b >= 0 ? t4dp::band_need(tl[b], pl[b]) : 0,
        b >= 0 ? t + (size_t)b * t_max : none_t.data(), t_max,
        b >= 0 ? p + (size_t)b * p_max : none_p.data(), p_max,
        b >= 0 ? tl[b] : 0, b >= 0 ? pl[b] : 0, sc, own);
    for (int s = 0; s < L; ++s)
      if (b >= 0 && own[s]) out[b] = sc[s];
  });
}

extern "C" int host_counts_group(const int8_t* t, const int32_t* tl,
                                 const int8_t* p, const int32_t* pl,
                                 const int64_t* order, int n, int t_max,
                                 int p_max, int w, int lanes, int narrow,
                                 int packed, int32_t* scores, int32_t* out) {
#define CASE(W_, L_)                                                       \
  if (w == W_ && lanes == L_) {                                            \
    counts<W_, L_>(t, tl, p, pl, order, n, t_max, p_max, narrow, packed,   \
                   scores, out);                                           \
    return 0;                                                              \
  }
  T4DP_COUNTS_INSTANCES(CASE)
#undef CASE
  return 1;
}

extern "C" int host_scores_group(const int8_t* t, const int32_t* tl,
                                 const int8_t* p, const int32_t* pl,
                                 const int64_t* order, int n, int t_max,
                                 int p_max, int w, int lanes, int narrow,
                                 int32_t* out) {
#define CASE(W_, L_)                                                       \
  if (w == W_ && lanes == L_) {                                            \
    scores_<W_, L_>(t, tl, p, pl, order, n, t_max, p_max, narrow, out);    \
    return 0;                                                              \
  }
  T4DP_SCORES_INSTANCES(CASE)
#undef CASE
  return 1;
}
"""


def _instances(macro):
    """(W, L) pairs of an instance list in the group headers."""
    name = "dp_counts_group.cuh" if "COUNTS" in macro else "dp_scores_group.cuh"
    with open(os.path.join(CSRC_DIR, name)) as f:
        text = f.read()
    body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", text).group(1)
    return [(int(a), int(b)) for a, b in
            re.findall(r"X\((\d+), (\d+)\)", body)]


COUNTS = _instances("T4DP_COUNTS_INSTANCES")
SCORES = _instances("T4DP_SCORES_INSTANCES")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("dp_group_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    so = d / "libdp_group_host.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-Wno-unknown-pragmas", "-Wno-maybe-uninitialized", "-D__host__=",
         "-D__device__=", f"-I{CSRC_DIR}", "-o", str(so), str(src)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_counts_group.argtypes = [vp] * 5 + [ci] * 7 + [vp] * 2
    lib.host_scores_group.argtypes = [vp] * 5 + [ci] * 6 + [vp]
    return lib


def _arrays(tc, tl, pc, pl, order):
    tc, pc = np.ascontiguousarray(tc, np.int8), np.ascontiguousarray(pc, np.int8)
    tl, pl = np.ascontiguousarray(tl, np.int32), np.ascontiguousarray(pl, np.int32)
    if order is None:
        order = np.argsort(pl, kind="stable")
    return tc, tl, pc, pl, np.ascontiguousarray(order, np.int64)


def _host_counts(lib, w, lanes, narrow, tc, tl, pc, pl, order=None):
    tc, tl, pc, pl, order = _arrays(tc, tl, pc, pl, order)
    n = len(tl)
    scores = np.full(n, 7, np.int32)
    counts = np.full((n, 3), 7, np.int32)
    packed = np.full(n, 7, np.int32)
    ptrs = [a.ctypes.data for a in (tc, tl, pc, pl, order)]
    for flag, s, out in ((0, scores, counts), (1, None, packed)):
        assert lib.host_counts_group(
            *ptrs, n, tc.shape[1], pc.shape[1], w, lanes, narrow, flag,
            None if s is None else s.ctypes.data, out.ctypes.data) == 0
    return scores, counts, packed


def _host_scores(lib, w, lanes, narrow, tc, tl, pc, pl, order=None):
    tc, tl, pc, pl, order = _arrays(tc, tl, pc, pl, order)
    scores = np.full(len(tl), 7, np.int32)
    assert lib.host_scores_group(
        *[a.ctypes.data for a in (tc, tl, pc, pl, order)], len(tl),
        tc.shape[1], pc.shape[1], w, lanes, narrow, scores.ctypes.data) == 0
    return scores


def _check_counts(lib, w, lanes, tc, tl, pc, pl, order=None):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (tc, tl, pc, pl)]
    want_s, want_c = banded_affine_counts_plain(*args, w)
    want_p = banded_affine_counts_plain(*args, w, packed=True)
    for narrow in (0, 1):
        s, c, p = _host_counts(lib, w, lanes, narrow, tc, tl, pc, pl, order)
        np.testing.assert_array_equal(s, want_s.numpy())
        np.testing.assert_array_equal(c, want_c.numpy())
        np.testing.assert_array_equal(p, want_p.numpy())


def _check_scores(lib, w, lanes, tc, tl, pc, pl, order=None):
    want = banded_affine_scores_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in (tc, tl, pc, pl)],
        w).numpy()
    for narrow in (0, 1):
        np.testing.assert_array_equal(
            _host_scores(lib, w, lanes, narrow, tc, tl, pc, pl, order), want)


def _random_jobs(seed, n, t_max, p_max, spread=None):
    """Codes incl. N and pad; lengths 0..width, p_len within ``spread`` of
    t_len when given (in band and out of band, zero-length rows)."""
    rng = np.random.default_rng(seed)
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    if spread is None:
        pl = rng.integers(0, p_max + 1, n)
    else:
        pl = np.clip(tl + rng.integers(-spread, spread, n), 0, p_max)
    return tc, tl, pc, pl.astype(np.int32)


_TIER_CAP = {16: 16, 24: 48, 48: 144}


@pytest.mark.parametrize("w,lanes", COUNTS)
def test_counts_group_on_tier_jobs(lib, w, lanes):
    rng = np.random.default_rng(300 + w + lanes)
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, 200, _TIER_CAP[w], w)
    _check_counts(lib, w, lanes, tc, tl, pc, pl)


@pytest.mark.parametrize("w,lanes", COUNTS)
def test_counts_group_on_arbitrary_jobs(lib, w, lanes):
    """Arbitrary (t_max, p_max) incl. p_len > p_max (rows stop at p_max),
    the text window clamp (p_max > t_max + 9), left bands past the
    pre-shift bucket, zero-length jobs and final cells off the tile."""
    for seed, (t_max, p_max) in enumerate(((48, 48), (10, 40), (40, 10),
                                           (0, 7), (7, 0))):
        tc, tl, pc, pl = _random_jobs(seed * 31 + w + lanes, 97, t_max, p_max)
        _check_counts(lib, w, lanes, tc, tl, pc, pl)
    # p_len beyond the row width: the kernel stops at p_max.
    tc, tl, pc, pl = _random_jobs(w * lanes, 97, 30, 24, spread=w)
    pl[::3] = 40
    _check_counts(lib, w, lanes, tc, tl, pc, pl)


@pytest.mark.parametrize("w,lanes", SCORES)
def test_scores_group_matches_plain(lib, w, lanes):
    """Arbitrary (t_max, p_max), N and pad codes, lengths in and out of
    band (INT32_MIN off the tile), zero-length rows and empty widths,
    p_len beyond p_max."""
    for seed, (t_max, p_max, spread) in enumerate((
            (40, 40, w), (60, 52, w), (152, 140, w), (10, 60, None),
            (60, 10, None), (0, 7, None), (7, 0, None))):
        tc, tl, pc, pl = _random_jobs(seed * 37 + w + lanes, 97, t_max,
                                      p_max, spread)
        _check_scores(lib, w, lanes, tc, tl, pc, pl)
    tc, tl, pc, pl = _random_jobs(w + lanes, 97, 30, 24, spread=w)
    pl[::3] = 40
    _check_scores(lib, w, lanes, tc, tl, pc, pl)


@pytest.mark.parametrize("n", [1, 31, 33])
@pytest.mark.parametrize("kind", ["counts", "scores"])
def test_ragged_batches_and_shuffled_order(lib, kind, n):
    """Batches that leave warps part empty, in a random job order (the
    kernels take any permutation; the wrappers pass the p_len sort)."""
    insts = COUNTS if kind == "counts" else SCORES
    check = _check_counts if kind == "counts" else _check_scores
    rng = np.random.default_rng(n)
    for w, lanes in insts:
        tc, tl, pc, pl = _random_jobs(n * 7 + w + lanes, n, 48, 44, spread=w)
        check(lib, w, lanes, tc, tl, pc, pl, rng.permutation(n))


def test_instances_cover_the_wrappers_widths():
    assert {w for w, _ in COUNTS} == set(dp_counts.BANDS)
    assert {w for w, _ in SCORES} == set(dp_scores.BANDS)
    for insts in (COUNTS, SCORES):
        assert all(w % lanes == 0 and 32 % lanes == 0 for w, lanes in insts)
        for w in {w for w, _ in insts}:
            assert {1, 4, 8} <= {lanes for ww, lanes in insts if ww == w}


def test_choice_tables_name_built_instances():
    for mod, insts in ((dp_counts, COUNTS), (dp_scores, SCORES)):
        assert set(mod.CHOICE.values()) <= {lanes for _, lanes in insts}
        for (w, _cls), lanes in mod.CHOICE.items():
            assert (w, lanes) in insts, (mod.__name__, w, lanes)
        for w in mod.BANDS:
            for n in (1, 300, 5000, 11000, 16384, 65536):
                assert (w, mod.lanes_for(n, w)) in insts


def test_cuda_sources_include_the_tested_headers():
    for src, header, call in (
            ("dp_counts.cu", "dp_counts_group.cuh",
             "t4dp::dp_counts_narrow<W, L>"),
            ("dp_scores.cu", "dp_scores_group.cuh",
             "t4dp::dp_scores_narrow<W, L>")):
        with open(os.path.join(CSRC_DIR, src)) as f:
            text = f.read()
        assert f'#include "{header}"' in text
        assert call in text
        assert "CudaLanes<L>" in text
