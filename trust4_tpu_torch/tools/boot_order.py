"""Where the device stack's boot starts and is joined, measured on the
port's CLI (the bench's 100k-read bulk corpus, TRUST4_TPU_DEVICE=1):

    python -m trust4_tpu_torch.tools.boot_order --record boot_order.json
    python -m trust4_tpu_torch.tools.boot_order --device cpu --reads 400 \
        --rounds 1 --threads 1                    # a box without a card

Orders, each run a fresh interpreter through ``cli.main`` (the CLI's
import and arguments, as ``python -m trust4_tpu_torch run``):
  extract   the shipping order: ops/gap_oracle's boot thread starts at the
            top of run_trust4, before extraction, and the first gap batch
            joins it after its native dedup;
  switch=S  the same with CPython's switch interval at S seconds from the
            boot's import to the end of its round trips (the interpreter's
            own is 5 ms);
  assemble  the boot starts after extraction, before the assembly (where
            the JAX package starts its device child);
  dedup     started before extraction, joined before the batch's native
            dedup, which needs no torch, instead of past it;
  serial    torch imported on the main thread after extraction, the rest
            of the boot (context, load, round trips) on its thread.
Each is the shipping code with one call moved or wrapped by this tool's
launcher (``gap_oracle.prewarm`` and run.py's stage stamp;
``gap_oracle._import_torch`` and ``_prewarm_body``; or
``gap_oracle.gap_counts`` and the engine's ``dedup_gap_jobs``); the
package itself holds no switch for them.

Per run: the wall, the extract / assemble / annotate stage walls and the
run's [boot] line (torch's import on the boot thread, the main thread's
wait at the joins); every run's artifacts are held byte-identical to the
first run's (trust4_tpu_torch/bench.py ``same_outputs``).  Rounds rotate
the order of the orders.  Per order and thread count the medians, and
last on stdout a JSON line of them; ``--record`` keeps every run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

ORDERS = ("extract", "switch=5e-05", "switch=1e-05", "assemble", "dedup",
          "serial")

LAUNCH = r"""
import sys, time
from trust4_tpu_torch import cli
from trust4_tpu_torch.engine.overlap_native import NativeOverlapEngine
from trust4_tpu_torch.ops import gap_oracle
from trust4_tpu_torch.pipeline import run as run_mod

order, argv = sys.argv[1], sys.argv[2:]
if order.startswith("switch="):
    import_torch, body = gap_oracle._import_torch, gap_oracle._prewarm_body

    def import_at_interval():
        sys.setswitchinterval(float(order[7:]))
        import_torch()

    def body_then_back(device):
        try:
            body(device)
        finally:
            sys.setswitchinterval(0.005)

    gap_oracle._import_torch = import_at_interval
    gap_oracle._prewarm_body = body_then_back
elif order in ("assemble", "serial"):
    real, held = gap_oracle.prewarm, []
    gap_oracle.prewarm = lambda device="cuda": held.append(device)
    stamp = run_mod._stamp

    def stamped(name):
        stamp(name)
        if name == "extract":
            if order == "serial":
                t0 = time.perf_counter()
                import torch
                gap_oracle.BOOT.update(loaded_by="MainThread",
                                       import_s=time.perf_counter() - t0)
            gap_oracle.prewarm = real
            for device in held:
                real(device)

    run_mod._stamp = stamped
elif order == "dedup":
    # The join of the dedup's device ahead of it; gap_counts's own join
    # past the dedup then finds the boot done.
    dedup, devices = NativeOverlapEngine.dedup_gap_jobs, []
    gap_counts = gap_oracle.gap_counts

    def remember_device(*a, device="cuda", **k):
        devices.append(device)
        return gap_counts(*a, device=device, **k)

    def join_then_dedup(self, *a, **k):
        gap_oracle._join(devices[-1])
        return dedup(self, *a, **k)

    gap_oracle.gap_counts = remember_device
    NativeOverlapEngine.dedup_gap_jobs = join_then_dedup
elif order != "extract":
    raise SystemExit(f"unknown order {order!r}")
sys.exit(cli.main(argv))
"""


def run_one(order: str, setup, corpus: str, threads: int,
            prefix: str) -> dict:
    """One CLI run in ``order``; its wall, stage walls and boot line."""
    from trust4_tpu_torch import bench

    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    argv = ["run", "-u", corpus, "-f", setup.coord, "--ref", setup.imgt,
            "-o", os.path.basename(prefix), "--od", os.path.dirname(prefix),
            "-t", str(threads), "--device", setup.device]
    env = dict(os.environ, TRUST4_TPU_DEVICE="1", TRUST4_TPU_STAGE_TIMES="1")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", LAUNCH, order, *argv],
                       capture_output=True, text=True, timeout=1800,
                       cwd=bench.REPO, env=env)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"order {order} exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    stages = bench._stages(r.stderr)
    boot = bench.device_boot(r.stderr, None if order == "serial" else "1")
    bench.say(f"{order} -t{threads}: {wall:.3f}s; extract "
              f"{stages['extract']:.3f} assemble {stages['assemble']:.3f} "
              f"annotate {stages['annotate']:.3f}; "
              + bench._BOOT.search(r.stderr)[0])
    return {"wall_s": wall, "prefix": prefix, "device_boot": boot,
            **{f"{k}_s": stages[k] for k in ("extract", "assemble",
                                             "annotate")}}


KEYS = ("wall_s", "extract_s", "assemble_s", "annotate_s")


def measure(setup, corpus: str, rounds: int, thread_counts) -> dict:
    """Every order at each thread count, rounds rotated; medians."""
    from trust4_tpu_torch import bench

    rec: Dict[str, dict] = {}
    base = None
    for threads in thread_counts:
        runs: Dict[str, List[dict]] = {o: [] for o in ORDERS}
        for i in range(rounds):
            for order in bench.rotated(list(ORDERS), i):
                prefix = os.path.join(setup.work, "boot_order",
                                      f"{order}_t{threads}_{i}", "b")
                runs[order].append(run_one(order, setup, corpus, threads,
                                           prefix))
                if base is None:
                    base = prefix
                else:
                    bench.same_outputs(prefix, base)
        med = {o: {k: float(np.median([r[k] for r in v])) for k in KEYS}
               for o, v in runs.items()}
        for o, v in runs.items():
            for k in ("import_s", "ready_wait_s"):
                med[o][k] = float(np.median([r["device_boot"][k] for r in v]))
            bench.say(f"boot order {o} -t{threads} medians ({rounds} rounds): "
                      + json.dumps({k: round(x, 3)
                                    for k, x in med[o].items()}))
        rec[f"t{threads}"] = {"medians": med, "runs": runs}
    n = sum(len(v) for t in rec.values() for v in t["runs"].values())
    bench.say(f"boot order: {n} runs, every one byte-identical to the first")
    rec["held"] = n - 1
    return rec


def main(argv=None) -> dict:
    from trust4_tpu_torch import bench
    from trust4_tpu_torch.testing import write_standin_references

    p = argparse.ArgumentParser(prog="python -m "
                                "trust4_tpu_torch.tools.boot_order",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--reads", type=int, default=100_000)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--threads", type=int, nargs="+", default=None,
                   help="thread counts (default 1 and os.cpu_count())")
    p.add_argument("--work", default=None)
    p.add_argument("--record", default=None)
    a = p.parse_args(argv)
    work = a.work or tempfile.mkdtemp(prefix="t4boot_")
    try:
        coord, imgt = write_standin_references(os.path.join(work, "ref"))
        setup = bench.Setup(a.device, coord, imgt, "", work)
        bench.prebuild(a.device)
        corpus = bench.ensure_corpus(setup, a.reads)
        rec = measure(setup, corpus, a.rounds,
                      a.threads or sorted({1, setup.nt}))
    finally:
        if a.work is None:
            shutil.rmtree(work, ignore_errors=True)
    rec["device_line"] = bench.device_line(a.device)
    if a.record:
        with open(a.record, "w") as f:
            json.dump(rec, f, indent=1)
    print(rec["device_line"], flush=True)
    print(json.dumps({t: v["medians"] for t, v in rec.items()
                      if t.startswith("t")}), flush=True)
    return rec


if __name__ == "__main__":
    main()
