"""The gap oracle's prewarm thread and deadlines (trust4_tpu_torch/ops/
gap_oracle.py), on the CPU: the prewarm joins and re-raises a failing
body, a fork waits for a running prewarm (utils/parallel.FORK_LOCK) but
no longer than the readiness deadline, and the ``TRUST4_TPU_GAP_TEST``
hooks make the readiness wait and the completion probe miss their
deadlines, which raise ``GapDeviceTimeout`` within them, in a direct
call and in a whole run, with no CPU fallback.
"""

import os
import re
import shutil
import threading
import time

import numpy as np
import pytest

from torch_modes_common import one_thread  # noqa: F401  (fixture)
from trust4_tpu_torch import testing
from trust4_tpu_torch.engine import overlap_native
from trust4_tpu_torch.ops import gap_oracle
from trust4_tpu_torch.utils import parallel

DATA = os.path.join(os.path.dirname(__file__), "data")
DEADLINE_S = 2.0


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """No prewarm of an earlier test, no hook, default deadlines; a prewarm
    the hang-ready hook hung (holding the fork lock) is let go after the
    test."""
    monkeypatch.setattr(gap_oracle, "_prewarms", {})
    hang = threading.Event()
    monkeypatch.setattr(gap_oracle, "_HANG", hang)
    for env in (gap_oracle.TEST_HOOK_ENV, gap_oracle.READY_TIMEOUT_ENV,
                gap_oracle.LAUNCH_TIMEOUT_ENV, "TRUST4_TPU_DEVICE",
                "TRUST4_TPU_DEVICE_CHECK"):
        monkeypatch.delenv(env, raising=False)
    yield
    hang.set()
    with parallel.FORK_LOCK:  # the released prewarm has left the lock
        pass


class _SW:
    def __init__(self, s):
        self.consensus = s


def _batch():
    """A native engine, reads, references and 40 gap jobs in tiers 0-1."""
    if not overlap_native.available():
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(17)
    seqs = ["".join(rng.choice(list("ACGT"), 120)) for _ in range(2)]
    reads = ["".join(rng.choice(list("ACGT"), 100)) for _ in range(3)]
    eng = overlap_native.NativeOverlapEngine(9)
    for i, s in enumerate(seqs):
        eng.reg_seq(i, True, -1, f"ref{i}", s, None, -1)
    jobs = np.array([(i % 3, 0, 0, i % 2, i, 10 + i % 30, i, 10 + i % 31)
                     for i in range(40)], np.int32)
    return eng, reads, jobs, [_SW(s) for s in seqs]


def test_prewarm_joins_once_per_process():
    gap_oracle.prewarm("cpu")
    pw = gap_oracle._prewarms["cpu"]
    gap_oracle.wait_ready("cpu")
    assert not pw.thread.is_alive() and pw.error is None
    gap_oracle.prewarm("cpu")
    assert gap_oracle._prewarms["cpu"] is pw
    eng, reads, jobs, sws = _batch()
    got = gap_oracle.gap_counts(eng, reads, jobs, sws, device="cpu")
    every = np.arange(len(jobs), dtype=np.int64)
    np.testing.assert_array_equal(got, eng.gap_counts_cpu(reads, jobs,
                                                          every, 1))
    assert gap_oracle._prewarms["cpu"] is pw


def test_prewarm_reraises_a_failing_body(monkeypatch):
    def boom(device):
        raise ValueError(f"no {device} today")

    monkeypatch.setattr(gap_oracle, "_prewarm_body", boom)
    eng, reads, jobs, sws = _batch()
    with pytest.raises(ValueError, match="no cpu today"):
        gap_oracle.gap_counts(eng, reads, jobs, sws, device="cpu")
    # The failed prewarm is dropped: the next batch starts a new one.
    assert "cpu" not in gap_oracle._prewarms
    monkeypatch.undo()
    monkeypatch.setattr(gap_oracle, "_prewarms", {})
    assert gap_oracle.gap_counts(eng, reads, jobs, sws,
                                 device="cpu").shape == (len(jobs), 3)


def _stamp(chunk):
    return [time.monotonic() for _ in chunk]


def test_fork_waits_for_a_running_prewarm(monkeypatch):
    """A stand-in body that sleeps inside the prewarm; the fork pool
    started meanwhile must not fork until the body has left the lock."""
    started = threading.Event()
    ended = []

    def slow(device):
        started.set()
        time.sleep(1.0)
        ended.append(time.monotonic())

    monkeypatch.setattr(gap_oracle, "_prewarm_body", slow)
    gap_oracle.prewarm("cpu")
    assert started.wait(10)
    t_fork = time.monotonic()
    stamps = parallel.map_fork_chunks(_stamp, list(range(8)), 2)
    assert len(stamps) == 8 and ended
    assert min(stamps) >= ended[0] > t_fork
    gap_oracle.wait_ready("cpu")
    # The other way round: a prewarm started while a pool holds the lock
    # waits for it.
    monkeypatch.setattr(gap_oracle, "_prewarms", {})
    started.clear()
    with parallel.FORK_LOCK:
        gap_oracle.prewarm("cpu")
        time.sleep(0.3)
        assert not started.is_set()
    gap_oracle.wait_ready("cpu")
    assert started.is_set() and len(ended) == 2


def test_fork_beside_a_wedged_prewarm_raises_within_the_deadline(
        monkeypatch):
    """hang-ready wedges the prewarm inside the fork lock, as a prewarm
    stuck in CUDA would: a fork pool started beside it waits no longer
    than the readiness deadline, then raises, and forks nothing."""
    monkeypatch.setenv(gap_oracle.TEST_HOOK_ENV, "hang-ready")
    monkeypatch.setenv(gap_oracle.READY_TIMEOUT_ENV, str(DEADLINE_S))
    gap_oracle.prewarm("cpu")
    t_end = time.monotonic() + 10
    while not parallel.FORK_LOCK.locked():  # the prewarm holds it
        assert time.monotonic() < t_end
        time.sleep(0.01)
    for fork in (parallel.map_fork, parallel.map_fork_chunks):
        t0 = time.monotonic()
        with pytest.raises(gap_oracle.GapDeviceTimeout,
                           match=gap_oracle.READY_TIMEOUT_ENV) as ei:
            fork(_stamp, list(range(8)), 2)
        assert time.monotonic() - t0 >= DEADLINE_S
        waited = float(re.search(r"waited ([0-9.]+) s",
                                 str(ei.value)).group(1))
        assert DEADLINE_S <= waited < DEADLINE_S + 0.5, waited
    assert gap_oracle._prewarms["cpu"].thread.is_alive()


def test_hook_takes_only_its_values(monkeypatch):
    monkeypatch.setenv(gap_oracle.TEST_HOOK_ENV, "hang")
    eng, reads, jobs, sws = _batch()
    with pytest.raises(ValueError, match="hang-ready or hang-launch"):
        gap_oracle.gap_counts(eng, reads, jobs, sws, device="cpu")


@pytest.mark.parametrize("hook,env", [
    ("hang-ready", gap_oracle.READY_TIMEOUT_ENV),
    ("hang-launch", gap_oracle.LAUNCH_TIMEOUT_ENV),
])
def test_hang_raises_within_the_deadline(monkeypatch, hook, env):
    """The wait that misses (the prewarm's join, or the completion polls
    once the batch is launched) raises just after its deadline; the
    prewarm and the DP before the polls are not part of it."""
    eng, reads, jobs, sws = _batch()
    if hook == "hang-launch":
        gap_oracle.wait_ready("cpu")
    monkeypatch.setenv(gap_oracle.TEST_HOOK_ENV, hook)
    monkeypatch.setenv(env, str(DEADLINE_S))
    t0 = time.monotonic()
    with pytest.raises(gap_oracle.GapDeviceTimeout, match=env) as ei:
        gap_oracle.gap_counts(eng, reads, jobs, sws, device="cpu")
    assert time.monotonic() - t0 >= DEADLINE_S
    waited = float(re.search(r"waited ([0-9.]+) s", str(ei.value)).group(1))
    assert DEADLINE_S <= waited < DEADLINE_S + 0.5, waited


def test_a_run_stops_at_the_launch_deadline(tmp_path, monkeypatch):
    """A whole run on the gold reads: the first gap batch misses the
    deadline, the run raises and writes no assembly (no fallback)."""
    from trust4_tpu_torch.pipeline.run import run_trust4

    coord, imgt = testing.write_standin_references(str(tmp_path / "ref"))
    prefix = str(tmp_path / "gold")
    for m in (1, 2):
        shutil.copy(os.path.join(DATA, f"gold_toassemble_{m}.fq"),
                    f"{prefix}_toassemble_{m}.fq")
    monkeypatch.setenv(gap_oracle.TEST_HOOK_ENV, "hang-launch")
    monkeypatch.setenv(gap_oracle.LAUNCH_TIMEOUT_ENV, str(DEADLINE_S))
    gap_oracle.reset_stats()
    t0 = time.monotonic()
    with pytest.raises(gap_oracle.GapDeviceTimeout,
                       match=gap_oracle.LAUNCH_TIMEOUT_ENV):
        run_trust4(coord, imgt, read1_files=[f"{prefix}_toassemble_1.fq"],
                   read2_files=[f"{prefix}_toassemble_2.fq"],
                   output_prefix=prefix, stage=1, device="cpu")
    assert time.monotonic() - t0 >= DEADLINE_S
    assert gap_oracle.STATS["batches"] == 1
    assert not os.path.exists(prefix + "_raw.out")
