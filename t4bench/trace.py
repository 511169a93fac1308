"""The device trace of a window: busy time, idle gaps, the costliest ops.

The reader of chip_smoke.py's profiled scale run, copied: torch.profiler
with CUDA activity only, every device operation (kernels, copies, sets)
counted.  Busy time is the union of their intervals, so overlapping
operations count once; the idle gaps are the stretches between them, each
named by the stage the host was in at its middle (the program's
``[stage-time]`` stamps mark where each stage ends).
"""

from __future__ import annotations

import re
from typing import Dict, List

_STAGE = re.compile(r"^\[stage-time\] (\w+): ")
TOP = 10


def empty(window_s: float) -> dict:
    return {"busy_s": 0.0, "window_s": window_s, "device_ops": [],
            "breakdown": {"device_ops": [], "idle_gaps": []}}


def _union(spans: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stage_at(window: List[dict], t: float) -> str:
    """The stage the host was in at clock reading ``t``: the first stage
    stamped at or after ``t`` in the sample that ran then."""
    for s in window:
        if s["t0"] <= t <= s["t1"]:
            for when, line in s["stderr"]:
                m = _STAGE.match(line)
                if m and when >= t:
                    return m.group(1)
            return "after the stages"
    return "between samples"


def summarise(prof, t0: float, w0: float, w1: float,
              window: List[dict]) -> dict:
    """Busy and idle over [w0, w1] (host clock) from ``prof``, whose
    event times count microseconds from ``t0``."""
    from torch.autograd import DeviceType

    spans = []
    by_name: Dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a = t0 + ev.time_range.start / 1e6
        b = t0 + ev.time_range.end / 1e6
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a)
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_s, "window_s": w1 - w0,
        "breakdown": {
            "device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[stage_at(window, (a + b) / 2), b - a]
                          for a, b in gaps[:TOP]],
        },
    }

