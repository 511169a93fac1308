"""Build and load the port's hand-written CUDA kernels.

The counterpart of trust4_tpu/utils/jaxcache.py: where the JAX package
caches XLA compilations, the port compiles each ``csrc/<name>.cu`` with
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, at first use, into ``trust4_tpu_torch/build/`` (gitignored),
and loads it with ctypes.  A library's file name carries a hash of the
sources and flags, so an edit rebuilds it; the build runs under a file
lock and renames its output into place, so concurrent processes share
one build.  ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here falls back: a missing ``nvcc``, a failed build or a failed
load raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# ctypes signatures of each library's C entry points.
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dp_counts": {
        "t4_dp_counts": ([_VP] * 5 + [_CI] * 6 + [_VP] * 3, _CI),
        "t4_dp_counts_instances": ([_VP, _CI], _CI),
    },
    "dp_scores": {
        "t4_dp_scores": ([_VP] * 5 + [_CI] * 5 + [_VP] * 2, _CI),
        "t4_dp_scores_instances": ([_VP, _CI], _CI),
    },
    "dp_dirs": {
        "t4_dp_dirs": ([_VP] * 4 + [_CI] * 5 + [_VP] * 3, _CI),
        "t4_dp_dirs_instances": ([_VP, _CI], _CI),
    },
    "dp_decode": {
        "t4_dp_decode": ([_VP, _CI] + [_VP] * 4 + [_CI] * 6 + [_VP] * 3,
                         _CI),
    },
    "dp_lab": {
        "t4_dp_inter": ([_VP] * 5 + [_CI] * 6 + [_VP] * 2, _CI),
        "t4_dp_abl": ([_VP] * 5 + [_CI] * 6 + [_VP] * 2, _CI),
        "t4_dp_lab_instances": ([_CI, _VP, _CI], _CI),
    },
    "microbench": {
        "t4_microbench": ([_CI] * 4 + [_VP] * 2 + [_CI] * 3 + [_VP], _CI),
    },
    "extract_filter": {
        "t4_extract_filter": ([_VP] * 2 + [_CI] * 4 + [_VP] * 2 + [_CI]
                              + [_VP] * 2, _CI),
        "t4_extract_decide": ([_VP, _CI, ctypes.c_int64], _CI),
        "t4_extract_filter_max_seqs": ([], _CI),
        "t4_extract_filter_launches": ([], ctypes.c_longlong),
    },
}

# name -> seconds its nvcc took in this process, and its compiler output
# (-Xptxas -v: registers, spills); empty for a library found built.
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels cannot be built"
        )
    return path


def kernel_names() -> List[str]:
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))
    )


def library_path(name: str) -> str:
    """Build output of csrc/<name>.cu, keyed by the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    deps = [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )
    for p in deps:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Bring every kernel library up to date, one nvcc per source, all
    started together.  Returns {name: library path}."""
    names = kernel_names() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if not os.path.exists(paths[n])]
        if not todo:
            return paths
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC_DIR, n + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_SECONDS[n] = time.perf_counter() - t0
            BUILD_LOG[n] = out
            if proc.returncode != 0:
                failed.append(f"nvcc {n}.cu exited {proc.returncode}:\n{out}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _loaded[name] = lib
    return lib


def instances(name: str) -> List[tuple]:
    """(band width, lanes) pairs that csrc/<name>.cu's library is built
    for (its ``t4_<name>_instances``)."""
    buf = (ctypes.c_int * 128)()
    k = getattr(load(name), f"t4_{name}_instances")(buf, 64)
    return [(buf[2 * i], buf[2 * i + 1]) for i in range(min(k, 64))]
