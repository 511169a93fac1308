"""Microbenchmarks of int32 operation chains on the card: the latency and
throughput of the operations the DP kernels are made of.  The port of
tools/vpu_microbench.py.

Usage (on the card; ``--device cpu`` runs the plain bodies)::

    python -m trust4_tpu_torch.tools.vpu_microbench [--device cuda|cpu]

Each case runs K = 512 operations per element of a (w, lanes) int32 tile,
in one dependent chain, in G interleaved independent chains, or as
independent operations, repeated GRID = 256 times per launch
(csrc/microbench.cu, replacing the Pallas kernel ``kern`` of the JAX
tool's ``bench``), and prints ms per launch and ns per operation, that is
launch time / (GRID x the case's operation count), as the JAX tool does.
``plain_body`` is each body's plain PyTorch version; on the card the
kernel's output must equal it.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from trust4_tpu_torch.tools.dp_kernel_lab import _time_ms

GRID = 256  # tile repeats per launch
K = 512  # operations per element and chain (fixed in csrc/microbench.cu)
ONE, FILL, THRESHOLD = 1, 7, 50  # kernel arguments, so nothing folds

# Body names -> the body index of csrc/microbench.cu.
BODIES = {"chain_max": 0, "inter2": 1, "inter4": 2, "chain_shift": 3,
          "shift_max": 4, "indep_max": 5, "chain_where": 6}

# (body, w, lanes, label, operations per element per launch repeat): the
# JAX tool's main(), l.72-132.
CASES = (
    ("chain_max", 8, 128, "dep max+add chain (8,128)", K),
    ("chain_max", 32, 128, "dep max+add chain (32,128)", K),
    ("chain_max", 32, 512, "dep max+add chain (32,512)", K),
    ("inter2", 32, 128, "2x interleaved chains (32,128)", 2 * K),
    ("inter4", 32, 128, "4x interleaved chains (32,128)", 4 * K),
    ("chain_shift", 8, 128, "dep sublane-shift chain (8,128)", K),
    ("chain_shift", 32, 128, "dep sublane-shift chain (32,128)", K),
    ("chain_shift", 32, 512, "dep sublane-shift chain (32,512)", K),
    ("shift_max", 32, 128, "dep shift+max pairs (32,128)", K),
    ("indep_max", 32, 128, "independent max ops (32,128)", K),
    ("chain_where", 32, 128, "dep where chain (32,128)", K),
)

# Kernel launches made by this process (one per call on a CUDA tensor).
LAUNCHES = 0


def plain_body(name: str, x: torch.Tensor, k: int = K) -> torch.Tensor:
    """The body ``name`` on a (w, lanes) int32 tile with k operations per
    chain, in plain PyTorch."""
    one = torch.tensor(ONE, dtype=torch.int32, device=x.device)
    fill = torch.full((1, x.shape[1]), FILL, dtype=torch.int32,
                      device=x.device)

    def shift_up(v):  # row r takes row r+1; the last row takes fill
        return torch.cat([v[1:], fill])

    if name == "chain_max":
        for _ in range(k // 2):
            x = torch.maximum(x, x + one)
        return x
    if name in ("inter2", "inter4"):
        xs = [x + g for g in range(int(name[5:]))]
        for _ in range(k // 2):
            xs = [torch.maximum(v, v + one) for v in xs]
        acc = xs[0]
        for v in xs[1:]:
            acc = torch.maximum(acc, v)
        return acc
    if name == "chain_shift":
        for _ in range(k):
            x = shift_up(x)
        return x
    if name == "shift_max":
        for _ in range(k // 2):
            x = torch.maximum(x, shift_up(x))
        return x
    if name == "indep_max":
        acc = x
        for i in range(1, k // 2):
            acc = torch.maximum(acc, torch.maximum(x, x + i * one))
        return acc
    if name == "chain_where":
        m = x > THRESHOLD
        for _ in range(k):
            x = torch.where(m, x + one, x)
        return x
    raise ValueError(f"unknown body {name!r}; bodies: {sorted(BODIES)}")


def run_body(name: str, x: torch.Tensor, grid: int = GRID) -> torch.Tensor:
    """The body on the tile x ((w, lanes) int32, w 8 or 32): on a CUDA
    tensor one launch of the kernel, repeating the tile ``grid`` times; on
    a CPU tensor the plain body (once: every repeat gives the same
    tile)."""
    global LAUNCHES
    if name not in BODIES:
        raise ValueError(f"unknown body {name!r}; bodies: {sorted(BODIES)}")
    if x.dim() != 2 or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (w, lanes) int32 tile")
    if x.device.type == "cpu":
        return plain_body(name, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows, lanes = x.shape
    if rows not in (8, 32) or (rows * lanes) % 256 != 0 or grid < 1:
        raise ValueError(f"tile ({rows},{lanes}) x {grid}: rows must be 8 "
                         "or 32, rows*lanes a multiple of 256")
    out = torch.empty_like(x)

    from trust4_tpu_torch.ops.build import load

    lib = load("microbench")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.t4_microbench(BODIES[name], rows, lanes, grid, x.data_ptr(),
                               out.data_ptr(), ONE, FILL, THRESHOLD, stream)
    if rc != 0:
        raise RuntimeError(f"t4_microbench launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def make_tile(w: int, lanes: int) -> np.ndarray:
    """The JAX tool's input: integers 0..99 from seed 0."""
    return np.random.default_rng(0).integers(0, 100, size=(w, lanes),
                                             dtype=np.int32)


def run_cases(device: str = "cuda", n_timed: int = 15) -> List[Dict]:
    """Every case once, checked against its plain body, then timed;
    returns one record per case."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for the plain "
                           "bodies)")
    print(f"device: {device}  GRID={GRID} K={K}", flush=True)
    records = []
    for name, w, lanes, label, k_ops in CASES:
        x = torch.from_numpy(make_tile(w, lanes)).to(device)
        out = run_body(name, x)
        want = plain_body(name, x)
        if not torch.equal(out, want):
            raise AssertionError(f"{label}: kernel differs from the plain "
                                 "body")
        ms = _time_ms(lambda: run_body(name, x), device, n_timed)
        ns_op = ms * 1e6 / (GRID * k_ops)
        print(f"{label:42s} {ms:8.4f} ms/launch  {ns_op:8.4f} ns/op",
              flush=True)
        records.append({"body": name, "w": w, "lanes": lanes, "k_ops": k_ops,
                        "ms": ms, "ns_per_op": ns_op})
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    run_cases(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
