"""The CUDA kernels' arithmetic, run on the CPU.

csrc/dp_counts.cuh, csrc/dp_scores.cuh and csrc/dp_dirs.cuh hold the
per-job DP of the counts, scores and dirs kernels, one thread a job, as
``__host__ __device__`` code with no CUDA headers: the sequential models
of the kernels' lane-group sweeps.  g++ builds them here, with both
qualifiers defined empty, into a small host library; each per-job
function must equal its plain PyTorch version (and so the JAX package)
bit for bit: the counts in both epilogues and the whole dirs tensor.
The group sweeps built on these headers run in tests/test_torch_dp_group.py
(kernels #1, #3), tests/test_torch_dp_lab_group.py (the lab's kernels) and
tests/test_torch_dp_dirs_group.py (kernel #4 and its decoder).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from trust4_tpu_torch.ops.build import CSRC_DIR
from trust4_tpu_torch.ops.dp import (
    banded_affine_counts_plain,
    banded_affine_scores_plain,
)
from trust4_tpu_torch.testing import rand_gap_jobs

_SHIM = r"""
#include <cstddef>
#include "dp_counts.cuh"
#include "dp_dirs.cuh"
#include "dp_scores.cuh"

template <int W>
static void run(const int8_t* t, const int32_t* tl, const int8_t* p,
                const int32_t* pl, int n, int t_max, int p_max,
                int32_t* scores, int32_t* packed) {
  for (int b = 0; b < n; ++b)
    t4dp::dp_counts_job<W>(t + (size_t)b * t_max, t_max,
                           p + (size_t)b * p_max, p_max, tl[b], pl[b],
                           &scores[b], &packed[b]);
}

extern "C" int host_dp_counts(const int8_t* t, const int32_t* tl,
                              const int8_t* p, const int32_t* pl, int n,
                              int t_max, int p_max, int w, int32_t* scores,
                              int32_t* packed) {
  switch (w) {
    case 16: run<16>(t, tl, p, pl, n, t_max, p_max, scores, packed); return 0;
    case 24: run<24>(t, tl, p, pl, n, t_max, p_max, scores, packed); return 0;
    case 48: run<48>(t, tl, p, pl, n, t_max, p_max, scores, packed); return 0;
  }
  return 1;
}

template <int W>
static void run_scores(const int8_t* t, const int32_t* tl, const int8_t* p,
                       const int32_t* pl, int n, int t_max, int p_max,
                       int32_t* scores) {
  for (int b = 0; b < n; ++b)
    scores[b] = t4dp::dp_scores_job<W>(t + (size_t)b * t_max, t_max,
                                       p + (size_t)b * p_max, p_max, tl[b],
                                       pl[b]);
}

extern "C" int host_dp_scores(const int8_t* t, const int32_t* tl,
                              const int8_t* p, const int32_t* pl, int n,
                              int t_max, int p_max, int w, int32_t* scores) {
  switch (w) {
    case 16: run_scores<16>(t, tl, p, pl, n, t_max, p_max, scores); return 0;
    case 24: run_scores<24>(t, tl, p, pl, n, t_max, p_max, scores); return 0;
    case 32: run_scores<32>(t, tl, p, pl, n, t_max, p_max, scores); return 0;
    case 48: run_scores<48>(t, tl, p, pl, n, t_max, p_max, scores); return 0;
  }
  return 1;
}

template <int W>
static void run_dirs(const int8_t* t, const int32_t* tl, const int8_t* p,
                     const int32_t* pl, int n, int t_max, int p_max,
                     int32_t* scores, int8_t* dirs) {
  for (int b = 0; b < n; ++b)
    scores[b] = t4dp::dp_dirs_job<W>(t + (size_t)b * t_max, t_max,
                                     p + (size_t)b * p_max, p_max, tl[b],
                                     pl[b], dirs + (size_t)b * p_max * W);
}

extern "C" int host_dp_dirs(const int8_t* t, const int32_t* tl,
                            const int8_t* p, const int32_t* pl, int n,
                            int t_max, int p_max, int w, int32_t* scores,
                            int8_t* dirs) {
  switch (w) {
    case 16: run_dirs<16>(t, tl, p, pl, n, t_max, p_max, scores, dirs); return 0;
    case 24: run_dirs<24>(t, tl, p, pl, n, t_max, p_max, scores, dirs); return 0;
    case 32: run_dirs<32>(t, tl, p, pl, n, t_max, p_max, scores, dirs); return 0;
    case 48: run_dirs<48>(t, tl, p, pl, n, t_max, p_max, scores, dirs); return 0;
  }
  return 1;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("dp_counts_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    so = d / "libdp_counts_host.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-Wno-unknown-pragmas", "-D__host__=", "-D__device__=",
         f"-I{CSRC_DIR}", "-o", str(so), str(src)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_dp_counts.argtypes = [vp] * 4 + [ci] * 4 + [vp] * 2
    lib.host_dp_counts.restype = ci
    lib.host_dp_scores.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    lib.host_dp_scores.restype = ci
    lib.host_dp_dirs.argtypes = [vp] * 4 + [ci] * 4 + [vp] * 2
    lib.host_dp_dirs.restype = ci
    return lib


def _host(lib, tc, tl, pc, pl, w):
    tc, pc = np.ascontiguousarray(tc), np.ascontiguousarray(pc)
    tl, pl = np.ascontiguousarray(tl), np.ascontiguousarray(pl)
    n = len(tl)
    scores = np.empty(n, np.int32)
    packed = np.empty(n, np.int32)
    rc = lib.host_dp_counts(
        tc.ctypes.data, tl.ctypes.data, pc.ctypes.data, pl.ctypes.data, n,
        tc.shape[1], pc.shape[1], w, scores.ctypes.data, packed.ctypes.data,
    )
    assert rc == 0
    return scores, packed


def _plain(tc, tl, pc, pl, w):
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (tc, tl, pc, pl)]
    scores, _counts = banded_affine_counts_plain(*args, w)
    packed = banded_affine_counts_plain(*args, w, packed=True)
    return scores.numpy(), packed.numpy()


@pytest.mark.parametrize("cap,w", [(16, 16), (48, 24), (144, 48)])
def test_header_matches_plain_on_tier_jobs(host_lib, cap, w):
    rng = np.random.default_rng(40 + cap)
    _ts, _ps, tc, tl, pc, pl = rand_gap_jobs(rng, 600, cap, w)
    hs, hp = _host(host_lib, tc, tl, pc, pl, w)
    ps, pp = _plain(tc, tl, pc, pl, w)
    np.testing.assert_array_equal(hs, ps)
    np.testing.assert_array_equal(hp, pp)


@pytest.mark.parametrize("t_max,p_max,w", [(48, 48, 24), (144, 144, 48),
                                           (10, 40, 48), (40, 10, 16)])
def test_header_matches_plain_on_arbitrary_jobs(host_lib, t_max, p_max, w):
    rng = np.random.default_rng(t_max * 7 + p_max)
    n = 400
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = rng.integers(0, p_max + 1, n).astype(np.int32)
    hs, hp = _host(host_lib, tc, tl, pc, pl, w)
    ps, pp = _plain(tc, tl, pc, pl, w)
    np.testing.assert_array_equal(hs, ps)
    np.testing.assert_array_equal(hp, pp)


def test_cuda_source_includes_the_tested_header():
    """The kernel runs the group sweep (tests/test_torch_dp_group.py),
    which builds on this header's constants and edge rules."""
    with open(os.path.join(CSRC_DIR, "dp_counts.cu")) as f:
        src = f.read()
    assert '#include "dp_counts_group.cuh"' in src
    assert "t4dp::dp_counts_narrow<W, L>" in src
    with open(os.path.join(CSRC_DIR, "dp_counts_group.cuh")) as f:
        assert '#include "dp_counts.cuh"' in f.read()


def _host_scores(lib, tc, tl, pc, pl, w):
    tc, pc = np.ascontiguousarray(tc), np.ascontiguousarray(pc)
    tl, pl = np.ascontiguousarray(tl), np.ascontiguousarray(pl)
    scores = np.empty(len(tl), np.int32)
    rc = lib.host_dp_scores(
        tc.ctypes.data, tl.ctypes.data, pc.ctypes.data, pl.ctypes.data,
        len(tl), tc.shape[1], pc.shape[1], w, scores.ctypes.data,
    )
    assert rc == 0
    return scores


@pytest.mark.parametrize("t_max,p_max,w", [(40, 40, 16), (60, 52, 24),
                                           (128, 128, 32), (152, 152, 32),
                                           (10, 60, 48), (60, 10, 32),
                                           (0, 7, 32), (7, 0, 16)])
def test_scores_header_matches_plain(host_lib, t_max, p_max, w):
    """Random codes incl. N and pad, lengths from 0 to the width: in band,
    out of band (INT32_MIN), zero-length rows and empty widths."""
    rng = np.random.default_rng(t_max * 11 + p_max + w)
    n = 300
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = rng.integers(0, p_max + 1, n).astype(np.int32)
    want = banded_affine_scores_plain(
        *[torch.from_numpy(a) for a in (tc, tl, pc, pl)], w).numpy()
    np.testing.assert_array_equal(_host_scores(host_lib, tc, tl, pc, pl, w),
                                  want)


def test_scores_cuda_source_includes_the_tested_header():
    """The kernel runs the group sweep (tests/test_torch_dp_group.py),
    which builds on this header's constants and text clamp."""
    with open(os.path.join(CSRC_DIR, "dp_scores.cu")) as f:
        src = f.read()
    assert '#include "dp_scores_group.cuh"' in src
    assert "t4dp::dp_scores_narrow<W, L>" in src
    with open(os.path.join(CSRC_DIR, "dp_scores_group.cuh")) as f:
        assert '#include "dp_scores.cuh"' in f.read()


def _arbitrary_jobs(seed, n, t_max, p_max, w):
    """Random codes incl. N and pad, lengths from 0 to the width, p_len
    within 2W of t_len: in band, out of band, zero-length rows."""
    rng = np.random.default_rng(seed)
    tc = rng.integers(0, 6, (n, t_max)).astype(np.int8)
    pc = rng.integers(0, 6, (n, p_max)).astype(np.int8)
    tl = rng.integers(0, t_max + 1, n).astype(np.int32)
    pl = np.clip(tl + rng.integers(-2 * w, 2 * w, n), 0, p_max).astype(
        np.int32)
    return tc, tl, pc, pl


def _ptrs(*arrays):
    assert all(a.flags.c_contiguous for a in arrays)
    return [a.ctypes.data for a in arrays]


@pytest.mark.parametrize("cap,w", [(16, 16), (48, 24), (40, 32), (144, 48)])
def test_dirs_header_matches_plain(host_lib, cap, w):
    """Scores and the whole (N, P, W) bits tensor, rows beyond p_len and
    cells outside the band included, on tier jobs and arbitrary rows."""
    from trust4_tpu_torch.ops.dp import banded_affine_dirs_plain

    rng = np.random.default_rng(60 + cap)
    _ts, _ps, *tier = rand_gap_jobs(rng, 300, cap, w)
    for tc, tl, pc, pl in (tier,
                           _arbitrary_jobs(cap + w, 300, cap, cap - 3, w)):
        tc, tl, pc, pl = (np.ascontiguousarray(a) for a in (tc, tl, pc, pl))
        n, p_max = len(tl), pc.shape[1]
        scores = np.empty(n, np.int32)
        dirs = np.empty((n, p_max, w), np.int8)
        assert host_lib.host_dp_dirs(*_ptrs(tc, tl, pc, pl), n, tc.shape[1],
                                     p_max, w, scores.ctypes.data,
                                     dirs.ctypes.data) == 0
        want_s, want_d = banded_affine_dirs_plain(
            *[torch.from_numpy(a) for a in (tc, tl, pc, pl)], w)
        np.testing.assert_array_equal(scores, want_s.numpy())
        np.testing.assert_array_equal(dirs, want_d.numpy())


def test_new_cuda_sources_include_the_tested_headers():
    """Each CUDA source runs the header its CPU tests build: the dirs
    kernel's group sweep and the decoder's walk
    (tests/test_torch_dp_dirs_group.py), the lab's kernels
    (tests/test_torch_dp_lab_group.py)."""
    for src, header, calls in (
            ("dp_dirs.cu", "dp_dirs_group.cuh",
             ["t4dp::dp_dirs_group<W, L>", "CudaLanes<L>"]),
            ("dp_decode.cu", "dp_decode.cuh",
             ["t4dp::decode_dirs_job<W>"]),
            ("dp_lab.cu", "dp_lab.cuh",
             ["t4dp::dp_inter_narrow<W, L, G>",
              "t4dp::dp_scores_narrow<W, L, FLAGS>", "CudaLanes<L>"])):
        with open(os.path.join(CSRC_DIR, src)) as f:
            text = f.read()
        assert f'#include "{header}"' in text
        for call in calls:
            assert call in text, (src, call)
