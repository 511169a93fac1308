"""Extraction's bulk stream on its threads and on the card, in turns.

Usage (on the card)::

    python -m trust4_tpu_torch.tools.extract_filter_bench \\
        [--reads 1000000] [--share 0.0025] [--seed 23] [--threads 8] \\
        [--rounds 2] [--record FILE]

Writes one gzip FASTQ sample of 100-base reads shaped like a bulk
benchmark mix (testing.mix_reads: a ``--share`` of them cut from
receptor templates of the stand-in coordinate FASTA, the rest uniform
random).  Then, on the stand-in's index at k = 9 and the sample's hit
length, runs the bulk stream (native/extract_filter.cpp) over the file
on its threads and through the card's decider (ops/extract_filter.py) in
turns (threads, card, card, threads, ``--rounds`` times): each run's
wall and phases (read, filter, write, read_wait) and the tests decided
on the card and on the host; every run's candidate file must equal the
first's.  The kernel alone is timed, and held to the host filter, by
chip_smoke.py's extract phase.

Prints a line a run and a JSON summary last, with the card's name and
power limit.  Raises without a card.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from trust4_tpu_torch import testing
from trust4_tpu_torch.engine.seqset import SeqSet
from trust4_tpu_torch.ops import extract_filter
from trust4_tpu_torch.pipeline import extract_native
from trust4_tpu_torch.pipeline.extract import compute_hit_len_required


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="extract_filter_bench")
    p.add_argument("--reads", type=int, default=1_000_000)
    p.add_argument("--share", type=float, default=0.0025)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--record", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("extract_filter_bench needs a CUDA card")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    work = tempfile.mkdtemp(prefix="xf-bench-")
    try:
        return run(a, device, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(a, device, work) -> int:
    coord = testing.write_standin_references(work, coordinates=True)[0]
    reads = testing.mix_reads(coord, a.reads, a.share, a.seed)
    sample = os.path.join(work, "sample.fq.gz")
    with gzip.open(sample, "wt", compresslevel=1) as f:
        f.writelines(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                     for i, r in enumerate(reads))
    ss = SeqSet(9)
    ss.set_native_only_index()
    ss.input_ref_fa(coord)
    hlr = compute_hit_len_required(sample, False)
    native = extract_native.NativeCandidateFilter(
        [sw.consensus for sw in ss.seqs], 9, ss.radius, hlr)
    card = extract_filter.CardFilter(native, device)

    runs = []
    first = None
    for _ in range(a.rounds):
        for mode in ("threads", "card", "card", "threads"):
            out = os.path.join(work, f"{mode}.fq")
            t0 = time.perf_counter()
            n = native.extract_stream([sample], None, out, None, a.threads,
                                      decider=card if mode == "card" else
                                      None)
            wall = time.perf_counter() - t0
            data = open(out, "rb").read()
            first = data if first is None else first
            if data != first:
                raise AssertionError(f"{mode}: candidate file differs")
            rec = {"mode": mode, "wall_s": wall, "candidates": n,
                   "phases_s": dict(zip(("read", "filter", "write",
                                         "read_wait"),
                                        (x / 1e9 for x in native.phase_ns))),
                   "decided": list(native.decided)}
            print("stream " + json.dumps(rec), flush=True)
            runs.append(rec)
    summary = {"card": card_name(), "reads": a.reads, "share": a.share,
               "hit_len": hlr, "stream": runs,
               "launches": extract_filter.launches()}
    for mode in ("threads", "card"):
        mine = [r for r in runs if r["mode"] == mode]
        summary[mode + "_median"] = {
            k: statistics.median(r["phases_s"][k] for r in mine)
            for k in ("read", "filter", "write", "read_wait")}
        summary[mode + "_median"]["wall_s"] = statistics.median(
            r["wall_s"] for r in mine)
    print(json.dumps(summary), flush=True)
    if a.record:
        with open(a.record, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
