"""Wrapper of extraction's candidate filter kernel (csrc/extract_filter.cu).

The bulk stream (native/extract_filter.cpp ``t4x_extract_stream``) tests
every read with the low-complexity guard and HasHitInSet against the
germline index.  ``CardFilter`` puts that test on the card: it copies the
index's direct-addressed tables there (about 2.8 MB at k = 9) and hands
the stream a batch decider, the library's ``t4_extract_decide``, which
copies each packed batch from pinned staging to the card, launches the
kernel, copies the decisions back and waits for them, bounded by
TRUST4_TPU_DEVICE_TIMEOUT_S (as the gap oracle's batches are).  The
stream decides on the host what the kernel leaves undecided (its caps,
csrc/extract_filter.cuh), so its candidate files are the threads' own,
byte for byte.  The staging is made once a process and card.

Nothing falls back: a failed build, load, copy or launch raises, and so
does a batch that is not complete in time.  Which path a stream takes is
pipeline/extract.py's choice (``run_extractor``), on what it can see.
The plain version of the function is engine/overlap.py
``SeqSet.has_hit_in_set`` (and the host's native filter it mirrors).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from trust4_tpu_torch.ops.build import load
from trust4_tpu_torch.pipeline.extract_native import Decider

# A bulk stream batch of pairs, both mates, and its bases at up to 512 a
# read; a batch that does not fit goes to the decider in parts.
READS_CAP = 2 * 16384
BASES_CAP = 512 * READS_CAP


class _Ctx(ctypes.Structure):
    """csrc/extract_filter.cu ``CardCtx``, field for field."""

    _fields_ = [
        ("off", ctypes.c_void_p), ("posts", ctypes.c_void_p),
        ("k", ctypes.c_int32), ("radius", ctypes.c_int32),
        ("hlr", ctypes.c_int32), ("n_seqs", ctypes.c_int32),
        ("h_bases", ctypes.c_void_p), ("h_offs", ctypes.c_void_p),
        ("h_out", ctypes.c_void_p),
        ("d_bases", ctypes.c_void_p), ("d_offs", ctypes.c_void_p),
        ("d_out", ctypes.c_void_p),
        ("stream", ctypes.c_void_p), ("device", ctypes.c_int32),
        ("error", ctypes.c_int32), ("timeout_s", ctypes.c_double),
    ]


_TIMED_OUT = -1  # CardCtx.error of a batch not complete in time

# card -> (pinned host, device) staging: bases, offsets, decisions.
_STAGING: Dict[torch.device, Tuple[List[torch.Tensor], List[torch.Tensor]]] = {}


def _staging(device: torch.device):
    st = _STAGING.get(device)
    if st is None:
        shapes = ((BASES_CAP, torch.uint8), (READS_CAP + 1, torch.int32),
                  (READS_CAP, torch.int8))
        st = ([torch.empty(n, dtype=dt, pin_memory=True) for n, dt in shapes],
              [torch.empty(n, dtype=dt, device=device) for n, dt in shapes])
        _STAGING[device] = st
    return st


def launches() -> int:
    """The kernel's launches in this process (the library's count)."""
    return int(load("extract_filter").t4_extract_filter_launches())


class CardFilter:
    """The card's candidate test for one index, a NativeCandidateFilter's:
    its tables on ``device`` while this object lives.  Pass it to
    ``extract_stream(..., decider=)``, or ``decide`` reads.  An index the
    kernel cannot take raises ValueError: one with no direct-addressed
    tables (k > 12), or with more sequences than a block's shared memory
    holds counts for."""

    def __init__(self, native, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"the card's filter runs on a card, not "
                             f"{self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lib = load("extract_filter")
        view = native.csr_view()
        if view is None or view[2][3] > self._lib.t4_extract_filter_max_seqs():
            raise ValueError("the card's filter does not take this index")
        off, posts, (k, radius, hlr, n_seqs) = view
        self.off = torch.from_numpy(off).to(self.device)
        self.posts = torch.from_numpy(np.ascontiguousarray(posts)).to(
            self.device)
        self.meta = (k, radius, hlr, n_seqs)
        host, dev = _staging(self.device)
        self._ctx = _Ctx(
            self.off.data_ptr(), self.posts.data_ptr(), k, radius, hlr,
            n_seqs, *(t.data_ptr() for t in host),
            *(t.data_ptr() for t in dev), None, self.device.index, 0, 0.0)
        self._decider = Decider(
            ctypes.cast(self._lib.t4_extract_decide, ctypes.c_void_p).value,
            ctypes.addressof(self._ctx), host[0].data_ptr(), BASES_CAP,
            host[1].data_ptr(), host[2].data_ptr(), READS_CAP)

    def as_decider(self) -> Decider:
        """The stream's decider, on the card's current stream, with the
        deadline of TRUST4_TPU_DEVICE_TIMEOUT_S."""
        from trust4_tpu_torch.ops import gap_oracle

        self._ctx.stream = torch.cuda.current_stream(self.device).cuda_stream
        self._ctx.timeout_s = gap_oracle._deadline_s(
            gap_oracle.LAUNCH_TIMEOUT_ENV, "120")
        self._ctx.error = 0
        return self._decider

    def failed(self) -> None:
        """Raise what made the decider fail."""
        from trust4_tpu_torch.ops import gap_oracle

        if self._ctx.error == _TIMED_OUT:
            raise gap_oracle.GapDeviceTimeout(
                f"extraction filter batch on {self.device}: not complete "
                f"within {gap_oracle.LAUNCH_TIMEOUT_ENV}="
                f"{self._ctx.timeout_s:g} s")
        raise RuntimeError(f"extraction filter on {self.device}: cudaError "
                           f"{self._ctx.error}")

    def put(self, seqs: List[str]):
        """The reads packed on the card: (bases, n + 1 offsets, n
        decisions' room)."""
        n = len(seqs)
        data = [s.encode("ascii") for s in seqs]
        offs = np.zeros(n + 1, np.int32)
        np.cumsum([len(d) for d in data], out=offs[1:])
        bases = np.frombuffer(b"".join(data) or b"\0", np.uint8)
        return (torch.from_numpy(bases.copy()).to(self.device),
                torch.from_numpy(offs).to(self.device),
                torch.empty(n, dtype=torch.int8, device=self.device))

    def launch(self, bases, offs, out) -> None:
        """One launch on the card's current stream over reads ``put`` on
        the card; the decisions land in ``out``."""
        k, radius, hlr, n_seqs = self.meta
        with torch.cuda.device(self.device):
            rc = self._lib.t4_extract_filter(
                self.off.data_ptr(), self.posts.data_ptr(), k, radius, hlr,
                n_seqs, bases.data_ptr(), offs.data_ptr(), out.numel(),
                out.data_ptr(),
                torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"t4_extract_filter launch failed: cudaError "
                               f"{rc}")

    def decide(self, seqs: List[str]) -> np.ndarray:
        """(n,) int8 of the kernel's decisions on the reads, one launch: 0
        (not a candidate), -1 / 1 (the HasHitInSet strand) or
        extract_native.UNDECIDED."""
        if not seqs:
            return np.zeros(0, np.int8)
        batch = self.put(seqs)
        self.launch(*batch)
        return batch[2].cpu().numpy()
