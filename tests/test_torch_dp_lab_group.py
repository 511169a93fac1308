"""The kernel lab's two kernels' sweeps, run on the CPU.

csrc/dp_lab.cu builds the lab's kernels on the scores kernel's lane-group
design: the ablation kernel runs the scores kernel's own sweep
(csrc/dp_scores_group.cuh) with the pieces its FLAGS name removed, and
the interleaved kernel carries G jobs on each group of L lanes
(csrc/dp_lab.cuh).  g++ builds both here with the host exchange
(HostLanes: the L lanes of a group in lockstep over arrays), behind a shim
that walks the jobs as the CUDA kernels do: slot g takes job order[g], a
group takes G consecutive slots, a warp 32/L groups and loops to the
longest job's rows among its slots, on the widest tile among their
narrow_width choices; slots past n sweep with no job and write nothing.

Every built instance (csrc/dp_lab.cuh: T4DP_ABL_INSTANCES, every (L,
flag); T4DP_INTER_INSTANCES, every (L, G)) must equal its plain PyTorch
version bit for bit (integer DP, tolerance 0): ``banded_affine_scores_
ablated`` per flag, ``banded_affine_scores_plain`` for the interleaved
jobs and for no flag; on the wrapper's job order and on a random one, a
batch that leaves the last warp part empty, rows of many lengths in one
warp, and p_len beyond p_max.  The shim is built once for the module.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from trust4_tpu_torch.ops.build import CSRC_DIR
from trust4_tpu_torch.ops.dp import banded_affine_scores_plain
from trust4_tpu_torch.ops.dp_counts import job_order
from trust4_tpu_torch.tools import dp_kernel_lab as lab

_SHIM = r"""
#include <algorithm>
#include <vector>
#include "dp_lab.cuh"

// The lab kernels' walk: group q of a warp takes the slots q*G ..
// q*G + G-1; a warp (32/L groups) loops to the longest job's rows among
// its slots and sweeps the widest tile among their narrow_width choices
// (narrow = 0: the W tile).  b[j] = -1 marks a slot with no job.
template <int L, int G, class F>
static void walk(const int32_t* tl, const int32_t* pl, const int64_t* order,
                 int n, int p_max, int narrow, F group) {
  constexpr int W = 32, per_warp = 32 / L * G;
  const int slots = (n + per_warp - 1) / per_warp * per_warp;
  for (int w0 = 0; w0 < slots; w0 += per_warp) {
    int warp_rows = 0, warp_width = t4dp::narrow_width<W, L>(0);
    for (int g = w0; g < w0 + per_warp && g < n; ++g) {
      const int b = (int)order[g];
      warp_rows = std::max(warp_rows, std::min((int)pl[b], p_max));
      warp_width = std::max(
          warp_width, t4dp::narrow_width<W, L>(t4dp::band_need(tl[b], pl[b])));
    }
    if (!narrow) warp_width = W;
    for (int q0 = w0; q0 < w0 + per_warp; q0 += G) {
      int b[G];
      for (int j = 0; j < G; ++j) b[j] = q0 + j < n ? (int)order[q0 + j] : -1;
      group(t4dp::HostLanes<L>{warp_rows, warp_width}, b);
    }
  }
}

template <int L, int FLAGS>
static void abl(const int8_t* t, const int32_t* tl, const int8_t* p,
                const int32_t* pl, const int64_t* order, int n, int t_max,
                int p_max, int narrow, int32_t* out) {
  std::vector<int8_t> none_t(t_max + 1, 0), none_p(p_max + 1, 0);
  walk<L, 1>(tl, pl, order, n, p_max, narrow,
             [&](const t4dp::HostLanes<L>& x, const int* b) {
    int sc[L];
    bool own[L];
    const int j = b[0];
    t4dp::dp_scores_narrow<32, L, FLAGS>(
        x, j >= 0 ? t4dp::band_need(tl[j], pl[j]) : 0,
        j >= 0 ? t + (size_t)j * t_max : none_t.data(), t_max,
        j >= 0 ? p + (size_t)j * p_max : none_p.data(), p_max,
        j >= 0 ? tl[j] : 0, j >= 0 ? pl[j] : 0, sc, own);
    for (int s = 0; s < L; ++s)
      if (j >= 0 && own[s]) out[j] = sc[s];
  });
}

template <int L, int G>
static void inter(const int8_t* t, const int32_t* tl, const int8_t* p,
                  const int32_t* pl, const int64_t* order, int n, int t_max,
                  int p_max, int narrow, int32_t* out) {
  std::vector<int8_t> none_t(t_max + 1, 0), none_p(p_max + 1, 0);
  walk<L, G>(tl, pl, order, n, p_max, narrow,
             [&](const t4dp::HostLanes<L>& x, const int* b) {
    const int8_t* tp[G];
    const int8_t* pp[G];
    int t_len[G], p_len[G], sc[G][L];
    bool own[G][L];
    int need = 0;
    for (int j = 0; j < G; ++j) {
      tp[j] = b[j] >= 0 ? t + (size_t)b[j] * t_max : none_t.data();
      pp[j] = b[j] >= 0 ? p + (size_t)b[j] * p_max : none_p.data();
      t_len[j] = b[j] >= 0 ? tl[b[j]] : 0;
      p_len[j] = b[j] >= 0 ? pl[b[j]] : 0;
      if (b[j] >= 0) need = std::max(need, t4dp::band_need(t_len[j], p_len[j]));
    }
    t4dp::dp_inter_narrow<32, L, G>(x, need, tp, t_max, pp, p_max, t_len,
                                    p_len, sc, own);
    for (int j = 0; j < G; ++j)
      for (int s = 0; s < L; ++s)
        if (b[j] >= 0 && own[j][s]) out[b[j]] = sc[j][s];
  });
}

extern "C" int host_abl(const int8_t* t, const int32_t* tl, const int8_t* p,
                        const int32_t* pl, const int64_t* order, int n,
                        int t_max, int p_max, int lanes, int flags,
                        int narrow, int32_t* out) {
#define CASE(L_, F_)                                                    \
  if (lanes == L_ && flags == F_) {                                     \
    abl<L_, F_>(t, tl, p, pl, order, n, t_max, p_max, narrow, out);     \
    return 0;                                                           \
  }
  T4DP_ABL_INSTANCES(CASE)
#undef CASE
  return 1;
}

extern "C" int host_inter(const int8_t* t, const int32_t* tl,
                          const int8_t* p, const int32_t* pl,
                          const int64_t* order, int n, int t_max, int p_max,
                          int lanes, int groups, int narrow, int32_t* out) {
#define CASE(L_, G_)                                                    \
  if (lanes == L_ && groups == G_) {                                    \
    inter<L_, G_>(t, tl, p, pl, order, n, t_max, p_max, narrow, out);   \
    return 0;                                                           \
  }
  T4DP_INTER_INSTANCES(CASE)
#undef CASE
  return 1;
}
"""


def _instances(macro):
    """(L, arg) pairs of an instance list in csrc/dp_lab.cuh."""
    with open(os.path.join(CSRC_DIR, "dp_lab.cuh")) as f:
        text = f.read()
    body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", text).group(1)
    return [(int(a), int(b)) for a, b in
            re.findall(r"X\((\d+), (\d+)\)", body)]


ABL = _instances("T4DP_ABL_INSTANCES")
INTER = _instances("T4DP_INTER_INSTANCES")
FLAG_NAME = {0: None, **{v: k for k, v in lab.ABL_FLAGS.items()}}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("dp_lab_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    so = d / "libdp_lab_host.so"
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-Wno-unknown-pragmas", "-Wno-maybe-uninitialized", "-D__host__=",
         "-D__device__=", f"-I{CSRC_DIR}", "-o", str(so), str(src)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.host_abl, lib.host_inter):
        fn.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        fn.restype = ci
    return lib


def _batches():
    """(name, arrays, order) of the batches every instance sweeps: mixed
    row counts and bands in and out of the tile (N and pad codes, zero
    lengths) in the wrapper's order (dp_counts.job_order) and in a random
    one; 33 rows, which leave the last warp part empty, with p_len beyond
    p_max on every third."""
    rng = np.random.default_rng(77)
    n, t_max, p_max = 301, 60, 52
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = np.clip(tl + rng.integers(-64, 64, n), 0, p_max).astype(np.int32)
    mixed = (tc, tl, pc, pl)
    wrapper = job_order(torch.from_numpy(tl), torch.from_numpy(pl)).numpy()
    n = 33
    tc = rng.integers(0, 6, (n, 30)).astype(np.int8)
    pc = rng.integers(0, 6, (n, 24)).astype(np.int8)
    tl = rng.integers(0, 31, n).astype(np.int32)
    pl = np.clip(tl + rng.integers(-32, 32, n), 0, 24).astype(np.int32)
    pl[::3] = 40
    return [("wrapper order", mixed, wrapper),
            ("random order", mixed, rng.permutation(301)),
            ("ragged", (tc, tl, pc, pl), rng.permutation(n))]


BATCHES = _batches()
_WANT = {}


def _want(flag, i):
    """The plain version's scores of batch i with ``flag`` removed."""
    if (flag, i) not in _WANT:
        args = [torch.from_numpy(a) for a in BATCHES[i][1]]
        _WANT[flag, i] = lab.banded_affine_scores_ablated(
            *args, 32, frozenset([flag] if flag else [])).numpy()
    return _WANT[flag, i]


def _host(fn, lanes, arg, narrow, arrays, order):
    tc, tl, pc, pl = (np.ascontiguousarray(a) for a in arrays)
    order = np.ascontiguousarray(order, np.int64)
    out = np.full(len(tl), 7, np.int32)
    assert fn(*[a.ctypes.data for a in (tc, tl, pc, pl, order)], len(tl),
              tc.shape[1], pc.shape[1], lanes, arg, narrow,
              out.ctypes.data) == 0
    return out


@pytest.mark.parametrize("lanes,flags", ABL)
def test_abl_group_matches_ablated_plain(lib, lanes, flags):
    flag = FLAG_NAME[flags]
    for i, (name, arrays, order) in enumerate(BATCHES):
        want = _want(flag, i)
        for narrow in (0, 1):
            np.testing.assert_array_equal(
                _host(lib.host_abl, lanes, flags, narrow, arrays, order),
                want, err_msg=f"{flag} L={lanes} {name} narrow={narrow}")
        if flag is None:
            np.testing.assert_array_equal(want, banded_affine_scores_plain(
                *[torch.from_numpy(a) for a in arrays], 32).numpy())


@pytest.mark.parametrize("lanes,groups", INTER)
def test_inter_group_matches_plain(lib, lanes, groups):
    for i, (name, arrays, order) in enumerate(BATCHES):
        for narrow in (0, 1):
            np.testing.assert_array_equal(
                _host(lib.host_inter, lanes, groups, narrow, arrays, order),
                _want(None, i),
                err_msg=f"G={groups} L={lanes} {name} narrow={narrow}")


def test_instances_match_the_wrapper():
    """The built instances are every L of the scores kernel's W = 32
    instances with no flag and each flag alone, and with each G; the
    wrapper's default L for scores_inter is one of them."""
    from test_torch_dp_group import SCORES

    assert lab.LANES == tuple(ln for w, ln in SCORES if w == lab.LAB_BAND)
    assert ABL == [(ln, f) for ln in lab.LANES
                   for f in (0, *lab.ABL_FLAGS.values())]
    assert INTER == [(ln, g) for ln in lab.LANES for g in lab.GROUPS]
    assert lab.INTER_LANES in lab.LANES
