"""Kernel lab: variants of the scores DP kernel and the input preparations
around it, timed at the bench shape (65,536 pairs x 152, t 150, p 148,
W = 32).  The port of tools/dp_kernel_lab.py.

Usage (on the card; ``--device cpu`` runs the plain versions)::

    python -m trust4_tpu_torch.tools.dp_kernel_lab [base|inter2|inter4|abl|
        prep|tonly|gonly|selshift ...] [--device cuda|cpu] [--n N]
        [--lanes L]
    DP_ABLATE=nosub python -m trust4_tpu_torch.tools.dp_kernel_lab abl

Modes:

* ``base``: the scores kernel of the main path (ops/dp_scores.py), the
  instance its ``CHOICE`` table picks (or ``--lanes``);
* ``inter2``, ``inter4``: ``scores_inter``, the scores kernel's lane-group
  sweep carrying G = 2 or 4 jobs a group, each step issued for the G jobs
  before the next (csrc/dp_lab.cuh, replacing the Pallas
  ``_dp_kernel_inter``); its plain version is
  ``banded_affine_scores_plain``;
* ``abl``: ``scores_abl``, the scores kernel's own sweep with the pieces
  that ``DP_ABLATE`` names (comma-separated: noshift, statload, notslice,
  nosub, nokir, noscan, nojz; csrc/dp_scores_group.cuh says what each
  removes) removed at compile time (replacing ``_dp_kernel_abl``); its
  plain version is ``banded_affine_scores_ablated``.  Built for no flag
  and for each flag alone;
* ``prep``, ``tonly``, ``gonly``, ``selshift``: the JAX tool's XLA input
  preparations (pad + shift-gather + transpose, transpose, gather,
  select-over-shifts) as torch programs with the same outputs.

The lab kernels are built for every lane count L in ``LANES`` (the scores
kernel's L at W = 32); ``--lanes`` picks one for every scores mode.
Without it ``abl`` and ``base`` take the scores wrapper's L for the batch
(``dp_scores.lanes_for``: 1 at the bench shape) and ``inter2``/``inter4``
take ``INTER_LANES``.  Every scores mode takes its jobs in the scores
wrapper's order (``dp_counts.job_order``) and prints two times: the
wrapper's, the sort included, and the launch alone on a precomputed order
(on the CPU both are the plain version's); the summary compares the
launches.  Times are medians of CUDA-event-timed calls (the host clock on
the CPU), with G cells/s over N x 150 x W cells, as the JAX tool prints
them.  Each scores mode is checked against ``base``: a mode that must
equal it (inter2, inter4, abl with no flag) and does not raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, FrozenSet, Iterable, List, Optional

import numpy as np
import torch

from trust4_tpu_torch.ops.dp import (
    SCORE_GAPEXTEND,
    SCORE_GAPOPEN,
    SCORE_MATCH,
    SCORE_MISMATCH,
    _BIG_NEG,
    _CODE_N,
    _CODE_PAD,
    banded_affine_scores_plain,
)
from trust4_tpu_torch.ops.dp_counts import job_order, to_device_jobs
from trust4_tpu_torch.ops.dp_scores import lanes_for

# The band width the lab kernels are compiled for, the jobs a lane group
# carries in scores_inter, and the lanes per job of their instances: every
# L of the scores kernel's W = 32 instances (csrc/dp_lab.cuh,
# T4DP_ABL_INSTANCES: each L with no flag and each flag alone;
# T4DP_INTER_INSTANCES: each L with each G).
LAB_BAND = 32
GROUPS = (2, 4)
LANES = (1, 4, 8, 16)

# scores_inter's L when none is given: the least L whose G = 4 instance
# does not spill (chip_smoke.py's build phase, PERF.md section 6).
INTER_LANES = 4

# DP_ABLATE names -> the flag bits of csrc/dp_scores_group.cuh
# (t4dp::kAbl*).
ABL_FLAGS = {"noshift": 1, "statload": 2, "notslice": 4, "nosub": 8,
             "nokir": 16, "noscan": 32, "nojz": 64}

# Kernel launches made by this process (one per launch on the card), by
# (kind, L): kind "inter2" or "inter4" (scores_inter with G = 2, 4) or
# "abl" (scores_abl, any flag).
KINDS = ("inter2", "inter4", "abl")
LAUNCHES = {(kind, lanes): 0 for kind in KINDS for lanes in LANES}

MODES = ("base", "inter2", "inter4", "abl", "prep", "tonly", "gonly",
         "selshift")


def parse_ablate(spec: str) -> FrozenSet[str]:
    """``DP_ABLATE``'s comma-separated names as a set; unknown names
    raise."""
    names = frozenset(s.strip() for s in spec.split(",") if s.strip())
    unknown = names - set(ABL_FLAGS)
    if unknown:
        raise ValueError(f"unknown DP_ABLATE flags {sorted(unknown)}; "
                         f"known: {sorted(ABL_FLAGS)}")
    return names


def banded_affine_scores_ablated(
    t_codes: torch.Tensor,  # (N, T) int8
    t_lens: torch.Tensor,  # (N,) int32
    p_codes: torch.Tensor,  # (N, P) int8
    p_lens: torch.Tensor,  # (N,) int32
    band_width: int,
    ablate: Iterable[str] = frozenset(),
) -> torch.Tensor:
    """banded_affine_scores_plain with the pieces ``ablate`` names
    removed, as the ablation kernel removes them (csrc/dp_lab.cuh); with
    no flag it is banded_affine_scores_plain.  The scores are wrong by
    design once a piece is gone: the lab times what each piece costs."""
    ablate = parse_ablate(",".join(ablate))
    n, t_max = t_codes.shape
    p_max = p_codes.shape[1]
    w = band_width
    dev = t_codes.device
    i32 = torch.int32
    go, ge = SCORE_GAPOPEN, SCORE_GAPEXTEND
    go_ge = go + ge
    big_neg = _BIG_NEG

    def where(c, a, b):
        return torch.where(c, a, b).to(i32)

    tl = t_lens.to(i32)
    pl = p_lens.to(i32)
    left = where(tl < pl, 5 + (pl - tl), 5)
    right = where(tl > pl, 5 + (tl - pl), 5)
    neg_inf = ((tl + 1) * (pl + 1) * go)[:, None]

    k_idx = torch.arange(w, dtype=i32, device=dev)[None, :]
    j0 = k_idx - left[:, None]
    in_t0 = (j0 >= 0) & (j0 <= tl[:, None])
    m0 = where(j0 == 0, 0, where(j0 > 0, go + j0 * go, big_neg))
    e0 = where(j0 == 0, 0,
               where(j0 > 0, go + (pl[:, None] + 1) * go, big_neg))
    m = where(in_t0, m0, neg_inf)
    e = where(in_t0, e0, neg_inf)

    if t_max == 0:
        t_codes = torch.full((n, 1), _CODE_PAD, dtype=torch.int8, device=dev)
    tci = t_codes.long()
    t_hi = max(t_max - 1, 0)
    pci = p_codes.to(i32)
    bn_col = torch.full((n, 1), big_neg, dtype=i32, device=dev)
    no_col0 = torch.zeros((n, w), dtype=torch.bool, device=dev)

    def shift(x):  # band neighbour k+1 of the previous row
        if "noshift" in ablate:
            return x
        return torch.cat([x[:, 1:], bn_col], dim=1)

    for i in range(1, p_max + 1):
        # The row whose text window and query base this row reads.
        if "statload" in ablate:
            r = 1
        elif "notslice" in ablate:
            r = 8 * ((i - 1) // 8) + 1
        else:
            r = i
        j_row = i - left[:, None] + k_idx
        in_band = (
            (j_row >= 1)
            & (j_row <= tl[:, None])
            & (j_row <= i + right[:, None])
        )
        in_dp_row = (i <= pl)[:, None]
        col0 = no_col0 if "nojz" in ablate else j_row == 0

        if "nosub" in ablate:
            sub = SCORE_MATCH
        else:
            j_read = r - left[:, None] + k_idx
            tj = torch.gather(tci, 1, torch.clamp(j_read - 1, 0, t_hi).long())
            pi = pci[:, r - 1 : r]
            eq = (tj == pi) | (tj == _CODE_N) | (pi == _CODE_N)
            sub = where(eq, SCORE_MATCH, SCORE_MISMATCH)

        e_new = torch.maximum(shift(e) + ge, shift(m) + go_ge)
        diag = m + sub

        bound_m = go + i * go
        base = torch.maximum(diag, e_new)
        base = where(col0, bound_m, base)
        if "nokir" not in ablate:
            base = where(in_band | col0, base, big_neg)

        if "noscan" in ablate:
            f_new = base
        else:
            t_val = where(col0, bound_m, base + go) + k_idx * (-ge)
            run = torch.cummax(t_val, dim=1).values
            f_new = torch.cat([bn_col, run[:, :-1]], dim=1) - k_idx * (-ge)

        m_new = torch.maximum(base, f_new)
        m_new = where(in_band & in_dp_row, m_new, neg_inf)
        m_new = where(col0 & in_dp_row, bound_m, m_new)
        if "nokir" in ablate:
            e_keep = e_new
        else:
            e_keep = where(in_band & in_dp_row, e_new, neg_inf)

        m = where(in_dp_row, m_new, m)
        e = where(in_dp_row, e_keep, e)

    k_final = (tl - pl + left)[:, None].long()
    inside = (k_final >= 0) & (k_final < w)
    score = torch.gather(m, 1, torch.clamp(k_final, 0, w - 1))
    return where(inside, score, torch.iinfo(i32).min)[:, 0]


def _lanes(lanes: Optional[int], default: Optional[int] = None) -> int:
    """The instance's L: ``lanes``, or ``default`` for None; an L the lab
    kernels are not built for raises."""
    lanes = default if lanes is None else lanes
    if lanes not in LANES:
        raise ValueError(f"lanes {lanes}: the lab kernels are built for L "
                         f"in {LANES}")
    return lanes


def _device_of(t_codes: torch.Tensor) -> str:
    if t_codes.dim() != 2:
        raise ValueError("t_codes must be (N, T)")
    if t_codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t_codes.device}")
    return t_codes.device.type


def launch(kind: str, arg: int, t_codes, t_lens, p_codes, p_lens,
           band_width: int, lanes: int, order: torch.Tensor) -> torch.Tensor:
    """One launch of a lab kernel on CUDA inputs: kind "inter" (arg: G)
    or "abl" (arg: the flag bits, 0 or one flag), the (lanes, arg)
    instance, taking the pairs in ``order`` ((N,) int64 on the card, a
    permutation); the scores are in input order.  The wrappers' own path;
    chip_smoke.py and the card tests call it to time and check every
    instance with the sort left out."""
    from trust4_tpu_torch.ops.dp_scores import _check

    _check(t_codes, t_lens, p_codes, p_lens, band_width)
    if band_width != LAB_BAND:
        raise ValueError(f"the lab kernels are built for W={LAB_BAND}")
    _lanes(lanes)
    if kind == "inter":
        if arg not in GROUPS:
            raise ValueError(f"groups {arg} not in {GROUPS}")
        fn, counter = "t4_dp_inter", f"inter{arg}"
    elif kind == "abl":
        if arg != 0 and arg not in ABL_FLAGS.values():
            raise ValueError(f"flags {arg}: built for no flag or one flag")
        fn, counter = "t4_dp_abl", "abl"
    else:
        raise ValueError(f"kind {kind!r} not in ('inter', 'abl')")
    n = t_codes.shape[0]
    dev = t_codes.device
    scores = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return scores
    if order.dtype != torch.int64 or order.shape != (n,) or \
            order.device != dev:
        raise ValueError("order must be (N,) int64 on the inputs' device")

    from trust4_tpu_torch.ops.build import load

    lib = load("dp_lab")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(
            t_codes.data_ptr(), t_lens.data_ptr(), p_codes.data_ptr(),
            p_lens.data_ptr(), order.data_ptr(), n, t_codes.shape[1],
            p_codes.shape[1], band_width, lanes, arg, scores.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
    LAUNCHES[(counter, lanes)] += 1
    return scores


def instances(kind: str) -> List[tuple]:
    """The (lanes, arg) pairs the built library takes for kind "abl"
    (arg: flag bits) or "inter" (arg: G), from its
    ``t4_dp_lab_instances``."""
    import ctypes

    from trust4_tpu_torch.ops.build import load

    buf = (ctypes.c_int * 128)()
    k = load("dp_lab").t4_dp_lab_instances(
        {"abl": 0, "inter": 1}[kind], buf, 64)
    return [(buf[2 * i], buf[2 * i + 1]) for i in range(min(k, 64))]


def scores_inter(t_codes, t_lens, p_codes, p_lens, band_width: int,
                 groups: int, lanes: Optional[int] = None) -> torch.Tensor:
    """(N,) int32 scores as banded_affine_scores_plain, on the card with
    ``groups`` jobs a lane group and ``lanes`` lanes a group (None:
    INTER_LANES), the jobs in the scores wrapper's order; a CPU tensor
    runs the plain version."""
    if groups not in GROUPS:
        raise ValueError(f"groups {groups} not in {GROUPS}")
    lanes = _lanes(lanes, INTER_LANES)
    if _device_of(t_codes) == "cpu":
        return banded_affine_scores_plain(t_codes, t_lens, p_codes, p_lens,
                                          band_width)
    return launch("inter", groups, t_codes, t_lens, p_codes, p_lens,
                  band_width, lanes, job_order(t_lens, p_lens))


def scores_abl(t_codes, t_lens, p_codes, p_lens, band_width: int,
               ablate: Iterable[str] = frozenset(),
               lanes: Optional[int] = None) -> torch.Tensor:
    """(N,) int32 scores as banded_affine_scores_ablated(..., ablate); on
    the card the scores kernel's sweep with no flag or one flag removed,
    ``lanes`` lanes a job (None: the scores wrapper's L for the batch,
    dp_scores.lanes_for), the jobs in its order; a CPU tensor runs the
    plain version."""
    ablate = parse_ablate(",".join(ablate))
    lanes = _lanes(lanes, lanes_for(t_codes.shape[0], LAB_BAND))
    if _device_of(t_codes) == "cpu":
        return banded_affine_scores_ablated(t_codes, t_lens, p_codes, p_lens,
                                            band_width, ablate)
    if len(ablate) > 1:
        raise ValueError(f"the ablation kernel is built for no flag or one "
                         f"flag, not {sorted(ablate)}")
    flags = sum(ABL_FLAGS[a] for a in ablate)
    return launch("abl", flags, t_codes, t_lens, p_codes, p_lens,
                  band_width, lanes, job_order(t_lens, p_lens))


# ---- the JAX tool's input preparations, as torch programs ----


def _left(t_lens, p_lens):
    tl = t_lens.to(torch.int32)
    pl = p_lens.to(torch.int32)
    return torch.where(tl < pl, 5 + (pl - tl), 5).to(torch.int32)


def _shift_gather(t_codes, left, t_shift_len):
    """ts[n, x] = t_codes[n, x - left[n]] as int32, pad elsewhere."""
    t_max = t_codes.shape[1]
    x = torch.arange(t_shift_len, dtype=torch.int32,
                     device=t_codes.device)[None, :]
    src = x - left[:, None]
    valid = (src >= 0) & (src < t_max)
    got = torch.gather(t_codes.to(torch.int32), 1,
                       torch.clamp(src, 0, t_max - 1).long())
    return torch.where(valid, got, _CODE_PAD).to(torch.int32)


def prep_only(t_codes, t_lens, p_codes, p_lens, band_width: int):
    """The scores shim's device-side prep: lane padding, the shift-gather
    and the transposes; returns (ts_T, ps_T) int32."""
    n, t_max = t_codes.shape
    p_max = p_codes.shape[1]
    lanes = 128
    dev = t_codes.device
    left = _left(t_lens, p_lens)
    pad = (n + lanes - 1) // lanes * lanes - n

    def padb(x, fill):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)])

    t_codes = padb(t_codes, _CODE_PAD)
    p_codes = padb(p_codes, _CODE_PAD)
    left_p = padb(left, 5)
    p_max_pad = (p_max + 7) // 8 * 8
    p_codes = torch.cat(
        [p_codes, torch.full((n + pad, p_max_pad - p_max), _CODE_PAD,
                             dtype=p_codes.dtype, device=dev)], dim=1)
    t_shift_len = max(t_max, p_max_pad) + band_width + 8
    ts = _shift_gather(t_codes, left_p, t_shift_len)
    return ts.t().contiguous(), p_codes.to(torch.int32).t().contiguous()


def transpose_only(t_codes):
    return t_codes.to(torch.int32).t().contiguous()


def gather_only(t_codes, t_lens, p_lens):
    """(N, T + 48) int32: each text row shifted right by its left band."""
    return _shift_gather(t_codes, _left(t_lens, p_lens),
                         t_codes.shape[1] + 48)


def selshift_prep(t_codes, t_lens, p_lens):
    """(T + 48, N) int32, ts_T[x, n] = t_codes[n, x - left[n]] for left
    in 5..47 (pad elsewhere), built with no gather: one select per
    candidate shift on the transposed codes."""
    n, t_max = t_codes.shape
    left = _left(t_lens, p_lens)
    t_shift_len = t_max + 48
    ttT = t_codes.to(torch.int32).t()
    fill = torch.full((48, n), _CODE_PAD, dtype=torch.int32,
                      device=t_codes.device)
    ttT_pad = torch.cat([fill, ttT, fill])
    out = torch.full((t_shift_len, n), _CODE_PAD, dtype=torch.int32,
                     device=t_codes.device)
    for s in range(5, 48):
        seg = ttT_pad[48 - s : 48 - s + t_shift_len]
        out = torch.where(left[None, :] == s, seg, out)
    return out


def make_inputs(n: int = 65536, length: int = 152, w: int = LAB_BAND,
                seed: int = 0):
    """The bench shape: random text rows that double as the queries,
    t_len 150, p_len 148 (numpy, as the JAX tool makes them)."""
    rng = np.random.default_rng(seed)
    tc = rng.integers(0, 4, size=(n, length), dtype=np.int8)
    tl = np.full(n, 150, dtype=np.int32)
    pl = np.full(n, 148, dtype=np.int32)
    return tc, tl, tc, pl, w


def _time_ms(fn, device: str, n: int) -> float:
    """Median ms of n calls after 3 warm-up calls: CUDA events on the
    card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    times = []
    if device == "cuda":
        torch.cuda.synchronize()
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_modes(modes: List[str], device: str = "cuda", n: int = 65536,
              ablate: FrozenSet[str] = frozenset(),
              n_timed: int = 15, lanes: Optional[int] = None
              ) -> Dict[str, dict]:
    """Runs each mode at the bench shape with n pairs; returns {label:
    record}: for every mode ``ms`` (its call, the wrapper's for a scores
    mode) and ``cells_per_s``, and for a scores mode ``launch_ms`` (the
    launch alone, on a precomputed order), ``lanes`` and ``match_base``.
    ``lanes`` picks every scores mode's instance (None: each wrapper's
    default).  Raises where a mode that computes the base scores
    (inter2, inter4, abl with no flag) differs from them."""
    from trust4_tpu_torch.ops import dp_scores

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for the plain "
                           "versions)")
    w = LAB_BAND
    tc, tl, pc, pl, _ = make_inputs(n, 152, w)
    args = to_device_jobs(tc, tl, pc, pl, torch.device(device))
    cells = n * 150 * w
    print(f"device: {device}  N={n} L=150 W={w} "
          f"cells/launch={cells / 1e9:.2f}G", flush=True)
    flags = sum(ABL_FLAGS[a] for a in ablate)
    # scores mode -> (L, its wrapper call, its launch on `order`).
    scores = {
        "base": (_lanes(lanes, lanes_for(n, w)),
                 lambda ln: dp_scores.banded_affine_scores(*args, w),
                 lambda ln, o: dp_scores.launch(*args, w, ln, o)),
        "abl": (_lanes(lanes, lanes_for(n, w)),
                lambda ln: scores_abl(*args, w, ablate, ln),
                lambda ln, o: launch("abl", flags, *args, w, ln, o)),
    }
    for g in GROUPS:
        scores[f"inter{g}"] = (
            _lanes(lanes, INTER_LANES),
            lambda ln, g=g: scores_inter(*args, w, g, ln),
            lambda ln, o, g=g: launch("inter", g, *args, w, ln, o))
    preps = {
        "prep": lambda: prep_only(*args, w)[0],
        "tonly": lambda: transpose_only(args[0]),
        "gonly": lambda: gather_only(args[0], args[1], args[3]),
        "selshift": lambda: selshift_prep(args[0], args[1], args[3]),
    }
    order = job_order(args[1], args[3]) if device == "cuda" else None
    must_match = {"inter2", "inter4"} | ({"abl"} if not ablate else set())
    results: Dict[str, dict] = {}
    ref = None
    for name in modes:
        if name not in scores and name not in preps:
            raise ValueError(f"unknown mode {name!r}; modes: {MODES}")
        label = f"abl {','.join(sorted(ablate)) or '(no flag)'}" \
            if name == "abl" else name
        print(f"[{label}]", flush=True)
        rec = {}
        if name in scores:
            ln, call, launch_on = scores[name]
            out = call(ln)
            if ref is None:
                ref = out if name == "base" else \
                    dp_scores.banded_affine_scores(*args, w)
            ok = bool(torch.equal(ref, out))
            rec.update(lanes=ln, match_base=ok)
            print(f"  L={ln}  scores match base: {ok}", flush=True)
            if not ok and name in must_match:
                bad = torch.nonzero(ref != out)[:5, 0].tolist()
                raise AssertionError(
                    f"{label}: scores differ from base at pairs {bad}")
            rec["ms"] = _time_ms(lambda: call(ln), device, n_timed)
            rec["launch_ms"] = (
                _time_ms(lambda: launch_on(ln, order), device, n_timed)
                if device == "cuda" else rec["ms"])
            rec["cells_per_s"] = cells / (rec["launch_ms"] * 1e-3)
            times = (f"wrapper {rec['ms']:.4f} ms (sort included)  launch "
                     f"{rec['launch_ms']:.4f} ms" if device == "cuda" else
                     f"plain version {rec['ms']:.4f} ms")
            print(f"  {times}  {rec['cells_per_s'] / 1e9:.2f} G cells/s",
                  flush=True)
        else:
            out = preps[name]()
            print(f"  output {tuple(out.shape)} {out.dtype}", flush=True)
            rec["ms"] = _time_ms(preps[name], device, n_timed)
            rec["cells_per_s"] = cells / (rec["ms"] * 1e-3)
            print(f"  {rec['ms']:.4f} ms/launch  "
                  f"{rec['cells_per_s'] / 1e9:.2f} G cells/s", flush=True)
        results[label] = rec
    print("\nsummary (scores modes: "
          + ("the launch alone):" if device == "cuda" else
             "the plain version):"))
    for k, v in results.items():
        at = f" L={v['lanes']}" if "lanes" in v else ""
        print(f"  {k}{at}: {v['cells_per_s'] / 1e9:.2f} G cells/s")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=["base", "inter2", "inter4"],
                    help=f"any of {', '.join(MODES)}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=65536, help="pairs per launch")
    ap.add_argument("--lanes", type=int, default=None, choices=LANES,
                    help="lanes per job of every scores mode's instance "
                         "(default: each wrapper's)")
    a = ap.parse_args(argv)
    run_modes(a.modes or ["base", "inter2", "inter4"], a.device, a.n,
              parse_ablate(os.environ.get("DP_ABLATE", "")), lanes=a.lanes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
