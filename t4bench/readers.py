"""What the metric readers share: the program's spans and counters as a
run recorded them (run.py's record)."""

from __future__ import annotations

import re
from statistics import mean
from typing import Dict, List, Optional

_STAGE = re.compile(r"^\[stage-time\] (\w+): ([0-9.]+)s")
_BOOT = re.compile(r"^\[boot\] .*import_s=([0-9.]+) ready_wait_s=([0-9.]+)")


def stages(sample: dict) -> Dict[str, float]:
    """A sample's top-level ``[stage-time]`` walls (extract, assemble,
    annotate, report)."""
    out = {}
    for _t, line in sample["stderr"]:
        m = _STAGE.match(line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(2))
    return out


def mean_stage(record: dict, names: List[str]) -> Optional[float]:
    """The mean over the window's samples of the named stages' sum; None
    when the program printed no stage line (tracing off)."""
    per = [stages(s) for s in record["samples"]]
    if not per or not all(any(n in p for n in names) for p in per):
        return None
    return mean(sum(p.get(n, 0.0) for n in names) for p in per)


def mean_stat(record: dict, fn) -> Optional[float]:
    """The mean over the window's samples of ``fn(STATS)``."""
    if not record["samples"]:
        return None
    return mean(fn(s["stats"]) for s in record["samples"])


def boot(record: dict) -> Optional[tuple]:
    """(import_s, ready_wait_s) of the cold sample's ``[boot]`` line."""
    m = _BOOT.match(record["boot_line"])
    return (float(m.group(1)), float(m.group(2))) if m else None
