"""A fault planted under the timed path, for reading a number's upper
end on the card: the counts kernel with match and mismatch swapped in
every count it returns, from the warm sample on (the cold sample's boot
checks the kernel's own counts).  The benchmark's own runs do not run
this.

    python3 -m t4bench.faults --workload CELL --seeds S [S ...]
        [--seconds 5]

prints, per seed, the judged numbers beside the cell's limits, and one
JSON line of them all.
"""

from __future__ import annotations

import argparse
import json
import sys


def swap_counts() -> None:
    """Swap match and mismatch in what ``banded_affine_counts`` returns
    (the module attribute that the gap oracle imports at each batch)."""
    from trust4_tpu_torch.ops import dp_counts

    real = dp_counts.banded_affine_counts

    def swapped(*a, **k):
        scores, counts = real(*a, **k)
        return scores, counts[:, [1, 0, 2]].contiguous()

    dp_counts.banded_affine_counts = swapped


def after_cold(plant):
    """A ``run_cell`` wrap that plants the fault at the second sample."""
    calls = [0]

    def wrap(fn):
        calls[0] += 1
        if calls[0] == 2:
            plant()
        return fn

    return wrap


def main(argv=None) -> int:
    from t4bench import run

    p = argparse.ArgumentParser(prog="python3 -m t4bench.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5)
    a = p.parse_args(argv)
    out = {}
    for seed in a.seeds:
        cell = run.Cell(a.workload)
        r = run.run_cell(cell, seed, a.seconds, False,
                         wrap=after_cold(swap_counts))
        out[seed] = {k: v["value"] for k, v in r["checks"].items()}
        for k, v in r["checks"].items():
            print(f"{a.workload} seed {seed} swapped counts: {k} "
                  f"{v['value']!r} limit {v['limit']!r}")
    print(json.dumps({"workload": a.workload, "fault": "swapped counts",
                      "numbers": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
