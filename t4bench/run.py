"""The port's benchmark: whole samples through ``run_trust4`` on the card.

    python3 -m t4bench.run --workload CELL --seed N --seconds S --trace 0|1

run from the root of a checkout.  One run:

1. writes the frozen reference FASTAs and the cell's pool of samples,
   gzip-compressed, generated from the seed (``traffic/generator.py``);
2. brings the kernel and the four native libraries up to date in a child
   process, so this process has loaded no torch (a first run in a
   checkout compiles here, outside every timed number);
3. the cold sample: the clock starts before ``import
   trust4_tpu_torch.pipeline.run`` and stops when ``run_trust4`` returns
   on the pool's first sample: the port's import, the device stack's boot
   on its thread and a first sample beside it;
4. one warm sample; steps 1-4 are the set-up;
5. the window: samples cycle through the pool, back to back, one at a
   time, until the first that ends after ``--seconds``;
6. the reference judges every sample's output files (reference/judge.py)
   against the cell's limits (``workloads/<cell>.json``).

Each sample is one in-process call of ``run_trust4`` in the shipping mode
(every gap-fill tier on the card, ``device="cuda"``), as ``python -m
trust4_tpu_torch run`` makes it.  ``--trace 1`` turns on the program's
``[stage-time]`` lines and a torch.profiler over the window, and reports
the per-layer metrics (the cold sample's wall among them);
``--trace 0`` reports the end-to-end ones.  A
metric is a reader of its own under ``metrics/``, found by its name in
BENCHMARK.json, as a configuration, a traffic mix and a cell's limits
are files found by theirs.

The last line of standard output is the run's JSON result; the numbers
compared, each with its limit, end standard error, after the walls of the
run's phases (``phases (s): pool ... judge ... total ...``: steps 1 and
2, 3, 4, 5 with the profiler's start, the trace's reading, 6) and of its
samples.  Without a card, with
too few cards, or with JAX or the JAX package loaded, the run exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import faulthandler
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "trust4_tpu")
NATIVE_LIBS = ("libt4align.so", "libt4extract.so", "libt4overlap.so",
               "libt4bam.so")
# The environment that selects another mode of the port than the one it
# ships in; removed for the run.
MODE_ENV = ("TRUST4_TPU_DEVICE", "TRUST4_TPU_DEVICE_CHECK",
            "TRUST4_TPU_GAP_TEST", "TRUST4_TPU_NATIVE_DIR",
            "TRUST4_TPU_STAGE_TIMES", "T4_PROF")
STDERR_TAIL = 6000
# The phases of a run, in order: each starts where the one before ends.
PHASES = ("pool", "build", "cold", "warm", "window", "trace", "judge")


class HarnessError(RuntimeError):
    """The run cannot give a result (no card, a failed build, JAX loaded)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with what its names point to."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise HarnessError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = self.entry["chips"]
        cfg = [c for c in bench["configs"]
               if c["name"] == self.entry["config"]][0]
        self.config = load_json(os.path.join(root, cfg["file"]))
        bdir = os.path.join(root, "t4bench")
        self.mix = load_json(os.path.join(bdir, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bdir, "workloads",
                                             name + ".json"))["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.metrics_dir = os.path.join(bdir, "metrics")
        from t4bench import layouts

        self.layout = layouts.load(self.config["layout"],
                                   os.path.join(bdir, "layouts"))

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = os.path.join(self.metrics_dir, metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "t4bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Capture:
    """Standard error of the program while a sample runs: every line
    kept with the clock reading at which it was written (the stage
    stamps mark the ends of the stages)."""

    def __init__(self):
        self.lines: List[tuple] = []
        self._part = ""

    def write(self, s: str) -> int:
        self._part += s
        if "\n" in self._part:
            now = time.perf_counter()
            *done, self._part = self._part.split("\n")
            self.lines.extend((now, line) for line in done)
        return len(s)

    def flush(self) -> None:
        pass


def _run_sample(run_trust4, refs, cell: Cell, sample: dict, prefix: str,
               device: str) -> None:
    kw = dict(cell.config.get("run_args", {}))
    kw.update(cell.layout.run_args(sample))
    run_trust4(refs[0], refs[1], output_prefix=prefix,
               threads=cell.config["threads"], device=device, **kw)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (whole names: trust4_tpu_torch is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def build(root: str) -> None:
    """The counts kernel (nvcc) and the four native libraries (make), in
    a child so that this process loads nothing of the port yet."""
    code = ("from trust4_tpu_torch.ops.build import build_all\n"
            "build_all(['dp_counts'])\n"
            "from trust4_tpu_torch.utils.nativebuild import ensure_built\n"
            f"for t in {NATIVE_LIBS!r}:\n    ensure_built(t)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise HarnessError("build failed:\n" + proc.stdout[-2000:]
                           + proc.stderr[-4000:])


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", compile_kernels: bool = True,
             wrap: Optional[Callable] = None) -> dict:
    """One run of ``cell``; returns the result (module docstring).
    ``device="cpu"`` with ``compile_kernels=False`` is for a box without
    a card: the tests drive the run so, with the program in one of its
    CPU modes and ``wrap`` putting a fault under it."""
    t_start = time.perf_counter()
    for k in MODE_ENV:
        if device == "cuda" or k != "TRUST4_TPU_DEVICE":
            os.environ.pop(k, None)
    if trace:
        os.environ["TRUST4_TPU_STAGE_TIMES"] = "1"
    from t4bench.data import standin
    from t4bench.reference import judge
    from t4bench.traffic import generator

    work = tempfile.mkdtemp(prefix="t4bench-")
    ends = []  # the clock at the end of each of PHASES
    try:
        refs = standin.write_references(os.path.join(work, "ref"))
        pool = generator.generate_pool(cell.config, cell.mix, seed,
                                       os.path.join(work, "pool"),
                                       cell.layout)
        ends.append(time.perf_counter())
        if compile_kernels:
            build(cell.root)
        ends.append(time.perf_counter())
        if device == "cuda" and "torch" in sys.modules:
            raise HarnessError("torch was loaded before the cold sample")

        cap = Capture()
        outs = []  # per sample: pool index, prefix, clock, stderr lines

        def sample(k: int, tag: str):
            prefix = os.path.join(work, "out", tag, "S")
            os.makedirs(os.path.dirname(prefix))
            cap.lines.clear()
            old, sys.stderr = sys.stderr, cap
            t0 = time.perf_counter()
            try:
                fn = run_trust4 if wrap is None else wrap(run_trust4)
                _run_sample(fn, refs, cell, pool[k], prefix, device)
            finally:
                sys.stderr = old
            t1 = time.perf_counter()
            outs.append({"pool": k, "prefix": prefix, "t0": t0, "t1": t1,
                         "stderr": list(cap.lines)})

        # 3. The cold sample, its clock around the port's import.
        t0 = time.perf_counter()
        from trust4_tpu_torch.pipeline.run import run_trust4

        try:
            sample(0, "cold")
        except Exception:
            if device == "cuda":
                _check_card(cell.chips)
            raise
        cold_s = time.perf_counter() - t0
        if device == "cuda":
            _check_card(cell.chips)
        from trust4_tpu_torch.ops import gap_oracle

        boot_line = gap_oracle.boot_line()
        ends.append(time.perf_counter())
        # 4. One warm sample.
        sample(1 % len(pool), "warm")
        ends.append(time.perf_counter())
        setup_s = ends[-1] - t_start

        # 5. The window.
        prof = _Profiler(device) if trace else None
        attempted = failed = 0
        window = []
        error = None
        if prof:
            prof.start()
        w0 = time.perf_counter()
        while True:
            k = attempted % len(pool)
            gap_oracle.reset_stats()
            attempted += 1
            try:
                sample(k, f"w{attempted:03d}")
            except Exception:
                failed += 1
                error = traceback.format_exc()
                break
            window.append(dict(outs[-1], stats=_copy(gap_oracle.STATS),
                               n_reads=pool[k]["n_reads"]))
            if outs[-1]["t1"] - w0 >= seconds:
                break
        ends.append(time.perf_counter())
        w1 = window[-1]["t1"] if window else ends[-1]
        dev = _device(cell.chips) if device == "cuda" else {
            "platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}
        traced = prof.stop(w0, w1, window) if prof else None
        ends.append(time.perf_counter())

        # 6. The reference, once the window has closed.
        table = judge.imgt_table(standin.IMGT_TABLE)
        genes = judge.coordinate_genes(refs[0])
        refs_of = {}
        per_sample = []
        for o in outs:
            missing = judge.missing_outputs(o["prefix"], cell.layout)
            if missing:
                per_sample.append({k: 1e9 for k in judge.NUMBERS})
                error = error or f"missing output {missing}"
                continue
            if o["pool"] not in refs_of:
                refs_of[o["pool"]] = judge.Reference(
                    pool[o["pool"]], genes, table,
                    cell.config["read_length"], cell.layout)
            per_sample.append(refs_of[o["pool"]].judge(o["prefix"]))
            shutil.rmtree(os.path.dirname(o["prefix"]))
        numbers = judge.worst(per_sample)
        ends.append(time.perf_counter())
        correct = (error is None and failed == 0
                   and judge.passes(numbers, cell.limits))

        record = {
            "cold_s": cold_s, "setup_s": setup_s, "boot_line": boot_line,
            "window_s": w1 - w0, "samples": window, "trace": traced,
        }
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = cell.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced:
            dev["busy_s"] = traced["busy_s"]
            dev["window_s"] = traced["window_s"]
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": dev}
        if traced:
            result["breakdown"] = traced["breakdown"]
        result["checks"] = {k: {"value": numbers[k],
                                "limit": cell.limits[k]}
                            for k in judge.NUMBERS}
        result["_error"] = error
        result["_walls"] = [o["t1"] - o["t0"] for o in outs]
        result["_phases"] = dict(
            zip(PHASES, [b - a for a, b in zip([t_start] + ends, ends)]),
            total=time.perf_counter() - t_start)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _copy(stats: dict) -> dict:
    return json.loads(json.dumps(stats))


def _check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise HarnessError("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise HarnessError(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {chips}")


def _device(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


class _Profiler:
    """torch.profiler over the window, CUDA activity only (trace.py)."""

    def __init__(self, device: str):
        self.device = device
        self.prof = None

    def start(self) -> None:
        if self.device != "cuda":
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, w0: float, w1: float, window: list) -> dict:
        from t4bench import trace

        if self.prof is None:
            return trace.empty(w1 - w0)
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        return trace.summarise(self.prof, self.t0, w0, w1, window)


def main(argv=None) -> int:
    faulthandler.enable()
    p = argparse.ArgumentParser(prog="python3 -m t4bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        cell = Cell(a.workload)
        result = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    except HarnessError as e:
        print(f"t4bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"t4bench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    error = result.pop("_error")
    if error:
        print(error[-STDERR_TAIL:], file=sys.stderr)
    print("phases (s): " + " ".join(
        f"{k} {v:.3f}" for k, v in result.pop("_phases").items()),
        file=sys.stderr)
    print("sample walls (s): " + " ".join(
        f"{w:.3f}" for w in result.pop("_walls")), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
