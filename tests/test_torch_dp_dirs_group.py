"""The dirs kernel's lane-group sweep and the decoder kernel's walk, run on
the CPU.

csrc/dp_dirs.cu runs csrc/dp_dirs_group.cuh (a job's band over a group of
L lanes) and csrc/dp_decode.cu runs csrc/dp_decode.cuh (one job's walk).
g++ builds both here with the host exchange (HostLanes: the L lanes of a
group in lockstep over arrays), behind a shim that walks the jobs as the
kernel does: slot g takes job g, a warp 32/L consecutive slots, every
group all p_max rows (nothing is narrowed or reordered), slots past n
sweep with no job and write nothing; each row's bits go straight to the
job's (p_max, W) block (the kernel's shared-memory staging exists only
in the CUDA source; chip_smoke.py's odd-shaped batches check it).

Integer DP, tolerance 0 everywhere: every T4DP_DIRS_INSTANCES entry equals
``banded_affine_dirs_plain`` on the scores and the whole (N, P, W) bits
tensor, one instance per W also the JAX package's XLA function and its
Pallas kernel in interpret mode; the decoder header equals
``decode_dirs_counts_plain``, the JAX walker and the native
``t4_decode_dirs_counts_batch`` on real bits, and the plain decoder and
the JAX walker on random bits, whose walks run into the step cap.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_dp_dirs import (
    SHAPES,
    _gap_oracle_pairs,
    _native_decode,
)
from trust4_tpu.ops.dp_pallas import (
    banded_affine_dirs_pallas,
    banded_affine_dirs_xla,
)
from trust4_tpu.ops.dp_pallas import decode_dirs_counts as jax_decode
from trust4_tpu_torch.ops import dp_dirs
from trust4_tpu_torch.ops.build import CSRC_DIR
from trust4_tpu_torch.ops.dp import banded_affine_dirs_plain
from trust4_tpu_torch.testing import rand_gap_jobs

_SHIM = r"""
#include <cstddef>
#include <vector>
#include "dp_decode.cuh"
#include "dp_dirs_group.cuh"

// The kernel's Out, writing each row's C bytes straight to the job's
// (p_max, W) block.
template <int W>
struct HostRows {
  int8_t* dirs;
  template <int C, int K>
  void row(int, int lane, int i, const uint32_t (&w)[K]) {
    for (int c = 0; c < C; ++c)
      dirs[(size_t)(i - 1) * W + lane * C + c] = int8_t(w[c >> 2] >> (8 * (c & 3)));
  }
  void end_row(int) {}
};

// The kernel's walk: slot g takes job g, a warp 32/L slots; a slot past
// n sweeps a zero-length job on a pad row and writes nothing.
template <int W, int L>
static void dirs(const int8_t* t, const int32_t* tl, const int8_t* p,
                 const int32_t* pl, int n, int t_max, int p_max,
                 int32_t* scores, int8_t* out) {
  constexpr int per_warp = 32 / L;
  const int slots = (n + per_warp - 1) / per_warp * per_warp;
  std::vector<int8_t> none_t(t_max + 1, 5), none_p(p_max + 1, 5),
      none_dirs((size_t)p_max * W + 1);
  for (int g = 0; g < slots; ++g) {
    const bool has = g < n;
    const t4dp::HostLanes<L> x{p_max, W};
    HostRows<W> rows{has ? out + (size_t)g * p_max * W : none_dirs.data()};
    int sc[L];
    bool own[L];
    t4dp::dp_dirs_group<W, L>(
        x, has ? t + (size_t)g * t_max : none_t.data(), t_max,
        has ? p + (size_t)g * p_max : none_p.data(), p_max, has ? tl[g] : 0,
        has ? pl[g] : 0, rows, sc, own);
    for (int s = 0; s < L; ++s)
      if (has && own[s]) scores[g] = sc[s];
  }
}

extern "C" int host_dirs(const int8_t* t, const int32_t* tl, const int8_t* p,
                         const int32_t* pl, int n, int t_max, int p_max,
                         int w, int lanes, int32_t* scores, int8_t* out) {
#define CASE(W_, L_)                                            \
  if (w == W_ && lanes == L_) {                                 \
    dirs<W_, L_>(t, tl, p, pl, n, t_max, p_max, scores, out);   \
    return 0;                                                   \
  }
  T4DP_DIRS_INSTANCES(CASE)
#undef CASE
  return 1;
}

extern "C" int host_decode(const int8_t* d, int stride, const int8_t* t,
                           const int32_t* tl, const int8_t* p,
                           const int32_t* pl, int n, int t_max, int p_codes,
                           int p_max, int w, int steps, int32_t* counts,
                           int32_t* walked) {
  for (int b = 0; b < n; ++b) {
#define CASE(W_)                                                         \
  if (w == W_) {                                                         \
    walked[b] = t4dp::decode_dirs_job<W_>(                               \
        d + (size_t)b * stride, p_max, t + (size_t)b * t_max, t_max,     \
        p + (size_t)b * p_codes, p_codes, tl[b], pl[b], steps,           \
        counts + 3 * (size_t)b);                                         \
    continue;                                                            \
  }
    CASE(16) CASE(24) CASE(32) CASE(48)
#undef CASE
    return 1;
  }
  return 0;
}
"""


def _instances():
    """(W, L) pairs of T4DP_DIRS_INSTANCES in csrc/dp_dirs_group.cuh."""
    with open(os.path.join(CSRC_DIR, "dp_dirs_group.cuh")) as f:
        text = f.read()
    body = re.search(r"#define T4DP_DIRS_INSTANCES\(X\)((?:.*\\\n)*.*)",
                     text).group(1)
    return [(int(a), int(b)) for a, b in
            re.findall(r"X\((\d+), (\d+)\)", body)]


INSTANCES = _instances()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("dp_dirs_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    so = d / "libdp_dirs_host.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-Wno-unknown-pragmas", "-Wno-maybe-uninitialized", "-D__host__=",
         "-D__device__=", f"-I{CSRC_DIR}", "-o", str(so), str(src)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_dirs.argtypes = [vp] * 4 + [ci] * 5 + [vp] * 2
    lib.host_dirs.restype = ci
    lib.host_decode.argtypes = [vp, ci] + [vp] * 4 + [ci] * 6 + [vp] * 2
    lib.host_decode.restype = ci
    return lib


def _c(*arrays):
    return [np.ascontiguousarray(a) for a in arrays]


def _host_dirs(lib, tc, tl, pc, pl, w, lanes):
    tc, tl, pc, pl = _c(tc, tl, pc, pl)
    n, p_max = len(tl), pc.shape[1]
    scores = np.full(n, 7, np.int32)
    bits = np.full((n, p_max, w), 99, np.int8)
    assert lib.host_dirs(*[a.ctypes.data for a in (tc, tl, pc, pl)], n,
                         tc.shape[1], p_max, w, lanes, scores.ctypes.data,
                         bits.ctypes.data) == 0
    return scores, bits


def _host_decode(lib, bits, tc, tl, pc, pl, w, p_max):
    bits, tc, tl, pc, pl = _c(bits, tc, tl, pc, pl)
    n = len(tl)
    counts = np.zeros((n, 3), np.int32)
    walked = np.zeros(n, np.int32)
    assert lib.host_decode(
        bits.ctypes.data, bits[0].size if n else 0, tc.ctypes.data,
        tl.ctypes.data, pc.ctypes.data, pl.ctypes.data, n, tc.shape[1],
        pc.shape[1], p_max, w, dp_dirs.decode_steps(p_max, tc.shape[1]),
        counts.ctypes.data, walked.ctypes.data) == 0
    return counts, walked


def _plain(tc, tl, pc, pl, w):
    s, d = banded_affine_dirs_plain(
        *[torch.from_numpy(a) for a in _c(tc, tl, pc, pl)], w)
    return s.numpy(), d.numpy()


def _batches(w):
    """(name, (t_codes, t_lens, p_codes, p_lens)) of the inputs of
    tests/test_torch_dp_dirs.py at band width w: tier jobs (zero-length
    rows among them), the gap-oracle pairs, arbitrary rows (N and pad
    codes, final cells off the tile, left bands beyond the pre-shift
    bucket), p_len beyond p_max on every third row, and 33 ragged rows
    with an odd p_max, which leave the last warp part empty."""
    cap = dict((ww, c) for c, ww in SHAPES)[w]
    _ts, _ps, *tier = rand_gap_jobs(np.random.default_rng(cap + w), 200,
                                    cap, w)
    _pairs, *pairs = _gap_oracle_pairs(11 + w, 120, 60, w)
    rng = np.random.default_rng(300 + w)
    n, t_max, p_max = 200, 40, 50
    arbitrary = [rng.integers(0, 6, (n, t_max)).astype(np.int8),
                 rng.integers(0, t_max + 1, n).astype(np.int32),
                 rng.integers(0, 6, (n, p_max)).astype(np.int8),
                 rng.integers(0, p_max + 1, n).astype(np.int32)]
    over = [a.copy() for a in arbitrary]
    over[3][::3] = p_max + rng.integers(1, 20, len(over[3][::3]))
    ragged = [rng.integers(0, 6, (33, 41)).astype(np.int8),
              rng.integers(0, 42, 33).astype(np.int32),
              rng.integers(0, 6, (33, 37)).astype(np.int8), None]
    ragged[3] = np.clip(ragged[1] + rng.integers(-w, w, 33), 0,
                        37).astype(np.int32)
    ragged[3][::5] = 0
    return [("tier", tier), ("gap oracle pairs", pairs),
            ("arbitrary", arbitrary), ("p_len > p_max", over),
            ("ragged", ragged)]


@pytest.mark.parametrize("w,lanes", INSTANCES)
def test_group_instance_matches_plain(lib, w, lanes):
    """Scores and the whole (N, P, W) bits tensor, rows beyond p_len and
    cells outside the band included."""
    for name, (tc, tl, pc, pl) in _batches(w):
        assert ((tl == 0) | (pl == 0)).any() or name == "gap oracle pairs"
        want_s, want_d = _plain(tc, tl, pc, pl, w)
        got_s, got_d = _host_dirs(lib, tc, tl, pc, pl, w, lanes)
        np.testing.assert_array_equal(got_s, want_s, err_msg=name)
        np.testing.assert_array_equal(got_d, want_d, err_msg=name)


# One instance per band width against the JAX package, small enough for
# the Pallas interpreter: (W, L, cap).
JAX_CASES = [(16, 16, 16), (24, 8, 24), (32, 4, 24), (48, 1, 24)]


@pytest.mark.parametrize("w,lanes,cap", JAX_CASES)
def test_group_instance_matches_jax(lib, w, lanes, cap):
    """The XLA mirror on tier jobs and on arbitrary rows, the Pallas
    kernel in interpret mode on 16 tier jobs."""
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(40 + w),
                                             100, cap, w)
    rng = np.random.default_rng(41 + w)
    rows = (rng.integers(0, 6, (60, 30)).astype(np.int8),
            rng.integers(0, 31, 60).astype(np.int32),
            rng.integers(0, 6, (60, 34)).astype(np.int8),
            rng.integers(0, 35, 60).astype(np.int32))
    for arrays in ((tc, tl, pc, pl), rows):
        want_s, want_d = banded_affine_dirs_xla(*arrays, w)
        got_s, got_d = _host_dirs(lib, *arrays, w, lanes)
        np.testing.assert_array_equal(got_s, np.asarray(want_s))
        np.testing.assert_array_equal(got_d, np.asarray(want_d))
    few = [a[:16] for a in (tc, tl, pc, pl)]
    want_s, want_d = banded_affine_dirs_pallas(*few, w)
    got_s, got_d = _host_dirs(lib, *few, w, lanes)
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


def _decode_all(bits, tc, tl, pc, pl, w, p_max):
    """The plain decoder's and the JAX walker's counts."""
    plain = dp_dirs.decode_dirs_counts_plain(
        torch.from_numpy(bits), *[torch.from_numpy(a) for a in
                                  _c(tc, tl, pc, pl)],
        w=w, p_max=p_max).numpy()
    jax = np.asarray(jax_decode(bits, tc, tl, pc, pl, w=w, p_max=p_max))
    np.testing.assert_array_equal(plain, jax)
    return plain


@pytest.mark.parametrize("cap,w", SHAPES)
def test_decoder_header_matches_plain_jax_and_native(lib, cap, w):
    """Real bits of tier jobs (zero-length rows included) and of the
    gap-oracle pairs: the header's counts equal the plain decoder's, the
    JAX walker's and the native walker's, and every walk ends at (0, 0)
    within the cap."""
    _ts, _ps, *tier = rand_gap_jobs(np.random.default_rng(80 + w), 150, cap,
                                    w)
    _pairs, *pairs = _gap_oracle_pairs(90 + w, 80, 40, w)
    for tc, tl, pc, pl in (tier, pairs):
        p_max = pc.shape[1]
        _s, bits = _plain(tc, tl, pc, pl, w)
        got, walked = _host_decode(lib, bits, tc, tl, pc, pl, w, p_max)
        np.testing.assert_array_equal(
            got, _decode_all(bits, tc, tl, pc, pl, w, p_max))
        np.testing.assert_array_equal(
            got, _native_decode(bits, tc, tl, pc, pl, w))
        assert (walked < dp_dirs.decode_steps(p_max, tc.shape[1])).all()
        assert (walked >= got.sum(1)).all()


@pytest.mark.parametrize("w", [16, 24, 32, 48])
def test_decoder_header_on_random_bits_pins_the_step_cap(lib, w):
    """Random bits (any byte, so the DFA wanders) over jobs whose lengths
    reach p_max and T, and p_len up to five times p_max, whose walks
    cannot reach (0, 0) within the cap: a walk that stops at the cap must
    give the fixed-step loop's counts, and some do."""
    rng = np.random.default_rng(500 + w)
    n, t_max, p_max = 400, 20, 18
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = rng.integers(0, p_max + 1, n).astype(np.int32)
    pl[::4] = p_max + rng.integers(1, 4 * p_max, len(pl[::4]))
    tl[1::4] = t_max
    pl[1::4] = p_max
    bits = rng.integers(-128, 128, (n, p_max, w)).astype(np.int8)
    got, walked = _host_decode(lib, bits, tc, tl, pc, pl, w, p_max)
    np.testing.assert_array_equal(
        got, _decode_all(bits, tc, tl, pc, pl, w, p_max))
    cap = dp_dirs.decode_steps(p_max, t_max)
    assert (walked == cap).any() and (walked < cap).any()


def test_instances_match_the_wrapper():
    """The header's instance list is the wrapper's: every L in LANES that
    divides a band width, and CHOICE names only built instances."""
    assert INSTANCES == list(dp_dirs.INSTANCES)
    assert len(INSTANCES) == 15
    for (w, _cls), lanes in dp_dirs.CHOICE.items():
        assert (w, lanes) in INSTANCES
    assert {w for w, _ in dp_dirs.CHOICE} == set(dp_dirs.BANDS)


def test_wrappers_on_the_cpu_run_the_plain_versions():
    """On a CPU tensor ``banded_affine_dirs`` (at every built L) and
    ``decode_dirs_counts`` run the plain versions and launch nothing; an L
    not built raises there too."""
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(np.random.default_rng(600), 50,
                                             48, 24)
    args = [torch.from_numpy(a) for a in (tc, tl, pc, pl)]
    want_s, want_d = _plain(tc, tl, pc, pl, 24)
    launches = (dp_dirs.LAUNCHES, dp_dirs.DECODE_LAUNCHES)
    for lanes in (None, 1, 4, 8):
        s, d = dp_dirs.banded_affine_dirs(*args, 24, lanes=lanes)
        np.testing.assert_array_equal(s.numpy(), want_s)
        np.testing.assert_array_equal(d.numpy(), want_d)
    got = dp_dirs.decode_dirs_counts(torch.from_numpy(want_d), *args, w=24,
                                     p_max=48)
    np.testing.assert_array_equal(got.numpy(), _decode_all(
        want_d, tc, tl, pc, pl, 24, 48))
    assert (dp_dirs.LAUNCHES, dp_dirs.DECODE_LAUNCHES) == launches
    for bad in (2, 16, 32):
        with pytest.raises(ValueError, match="not built for L"):
            dp_dirs.banded_affine_dirs(*args, 24, lanes=bad)
    with pytest.raises(ValueError, match="unsupported device"):
        dp_dirs.decode_dirs_counts(torch.from_numpy(want_d).to("meta"),
                                   *args, w=24, p_max=48)
