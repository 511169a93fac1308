"""Fork-based data parallelism for the host phases.

The reference splits its read/contig sweeps over pthreads in static blocks
(main.cpp:513-626, Annotator.cpp:369-419); every unit of work is
independent (the shared SeqSet is read-only during these phases), so the
parallel results are identical to the serial pass.  Fork workers inherit
the index/profile state copy-on-write — no pickling of the SeqSet.

The pools fork under ``FORK_LOCK``, which the gap oracle's boot thread
(ops/gap_oracle.py) holds while it imports torch, creates the CUDA
context, builds and launches: a worker forked then could inherit an
import lock, a half-loaded torch, or a lock of CUDA or of the allocator
taken by that thread, and hang.  So a fork waits for a running boot, and
a boot waits for a running pool.  A pool waits no longer than the boot's
own deadline, TRUST4_TPU_DEVICE_READY_TIMEOUT_S (default 300): a boot
wedged in the import or in CUDA raises the gap oracle's
``GapDeviceTimeout`` out of the fork site instead of hanging it.  The
names come from the oracle's torch-free front, so a pool loads no torch.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import threading
import time
from typing import Callable, List, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")

_work_fn = None

FORK_LOCK = threading.Lock()


def _fresh_fork_lock() -> None:
    # A worker is forked while its parent holds the lock; the worker's
    # copy is held by no thread of its own.
    global FORK_LOCK
    FORK_LOCK = threading.Lock()


os.register_at_fork(after_in_child=_fresh_fork_lock)


@contextlib.contextmanager
def _fork_lock():
    """FORK_LOCK, waited for until the readiness deadline."""
    from trust4_tpu_torch.ops.gap_oracle import (
        READY_TIMEOUT_ENV,
        GapDeviceTimeout,
    )

    lock = FORK_LOCK
    limit = float(os.environ.get(READY_TIMEOUT_ENV, "300"))
    t0 = time.monotonic()
    if not lock.acquire(timeout=limit):
        raise GapDeviceTimeout(
            f"fork pool: the gap DP boot held the fork lock past "
            f"{READY_TIMEOUT_ENV}={limit:g} s (waited "
            f"{time.monotonic() - t0:.3f} s)")
    try:
        yield
    finally:
        lock.release()


def internal_threads(threads: int) -> int:
    """Effective parallelism for engine-internal phases.

    Our native/fork sweeps are part of the engine's architecture (like the
    reference's worker pools); at -t 1 they default to a bounded internal
    pool (the extract filter set this precedent).  TRUST4_TPU_INTERNAL_THREADS
    overrides (0/1 forces serial).
    """
    env = os.environ.get("TRUST4_TPU_INTERNAL_THREADS")
    if env is not None:
        try:
            v = int(env)
        except ValueError:
            v = 1
        return max(1, v)
    if threads > 1:
        return threads
    return max(1, min(8, os.cpu_count() or 1))


def _invoke(arg):
    return _work_fn(arg)


def map_fork(fn: Callable[[T], R], items: Sequence[T], threads: int) -> List[R]:
    """Order-preserving parallel map over items using forked workers."""
    if threads <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    global _work_fn
    _work_fn = fn
    ctx = mp.get_context("fork")
    chunk = max(1, len(items) // (threads * 4))
    with _fork_lock(), ctx.Pool(threads) as pool:
        try:
            return pool.map(_invoke, items, chunksize=chunk)
        finally:
            _work_fn = None


def map_fork_chunks(
    fn: Callable[[Sequence[T]], List[R]], items: Sequence[T], threads: int
) -> List[R]:
    """Split items into `threads` contiguous blocks (the reference's static
    partition) and concatenate the per-block results."""
    if threads <= 1 or len(items) <= 1:
        return fn(items)
    n = len(items)
    block = (n + threads - 1) // threads
    chunks = [items[i : i + block] for i in range(0, n, block)]
    global _work_fn
    _work_fn = fn
    ctx = mp.get_context("fork")
    with _fork_lock(), ctx.Pool(len(chunks)) as pool:
        try:
            results = pool.map(_invoke, chunks)
        finally:
            _work_fn = None
    out: List[R] = []
    for r in results:
        out.extend(r)
    return out
