"""The port's native extraction stream against the JAX package's.

``t4x_extract_stream`` in ``trust4_tpu_torch/native/extract_filter.cpp``
reads batch k+1 on its own thread while the filter runs batch k; the JAX
package's stream of the same name reads, filters and writes each batch
in turn.  Both filter with one index built from the stand-in reference,
and every case here holds the port's candidate files and count to the
JAX package's, byte for byte: single-end and paired, gzip and plain,
FASTQ and FASTA, chains of files, ragged pairs, samples of 0 reads to
three batches and more, at 1, 2 and 8 threads, and through a batch
decider in place of the threads.  A stream that cannot open its input or
its output raises ``OSError`` at once, and a stream leaves no thread
behind.

The decider is the card kernel's per-read decision
(``csrc/extract_filter.cuh``, one warp of 32 lanes run in turn on one
thread) built here with g++, at its own caps and at tiny ones, which
leave many reads undecided for the stream's host to decide.  The header
is also held to the host filter (``t4x_has_hit`` behind the
low-complexity guard) read by read.
"""

import ctypes
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from trust4_tpu.pipeline import extract_native as jax_native
from trust4_tpu_torch import testing
from trust4_tpu_torch.engine.seqset import SeqSet
from trust4_tpu_torch.ops.build import CSRC_DIR
from trust4_tpu_torch.pipeline import extract_native

from torch_boot_common import REPO

BATCH = 16384
SIZES = [0, 1, BATCH - 1, BATCH, BATCH + 1, 3 * BATCH + 7]
THREADS = [1, 2, 8]
HIT_LEN = 23
_COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stream_ref"))
    fa = testing.write_standin_references(d)[0]
    ss = SeqSet(9)
    ss.set_native_only_index()
    ss.input_ref_fa(fa)
    return [sw.consensus for sw in ss.seqs], ss.radius


@pytest.fixture(scope="module")
def filters(refs):
    """The port's filter and the JAX package's, on one index."""
    seqs, radius = refs
    return (extract_native.NativeCandidateFilter(seqs, 9, radius, HIT_LEN),
            jax_native.NativeCandidateFilter(seqs, 9, radius, HIT_LEN))


POOL = 3 * BATCH + 64


def _write(path, recs, fasta=False, gz=True, wrap=0):
    lines = []
    for name, seq, qual in recs:
        if fasta:
            lines.append(f">{name}\n")
            if wrap:
                lines.extend(seq[i:i + wrap] + "\n"
                             for i in range(0, len(seq), wrap))
            else:
                lines.append(seq + "\n")
        else:
            lines.append(f"@{name}\n{seq}\n+\n{qual}\n")
    data = "".join(lines).encode()
    if gz:
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
    return str(path)


@pytest.fixture(scope="module")
def pools(refs):
    """Per seed, POOL 100-base reads: a fifth cut from the reference
    (either strand, a few substitutions), the rest random; ids carry /1
    or /2 now and then, and a comment.  A sample of n reads is a pool's
    first n."""
    seqs = refs[0]
    out = {}
    for seed in range(1, 6):
        rng = np.random.default_rng(seed)
        bases = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, (POOL, 100))]
        quals = rng.integers(33, 74, (POOL, 100)).astype(np.uint8)
        cut = rng.random(POOL) < 0.2
        recs = []
        for i in range(POOL):
            if cut[i]:
                s = seqs[int(rng.integers(len(seqs)))]
                at = int(rng.integers(max(1, len(s) - 100)))
                r = bytearray(s[at:at + 100].ljust(100, "A").encode())
                for _ in range(int(rng.integers(4))):
                    r[int(rng.integers(100))] = b"ACGT"[int(rng.integers(4))]
                r = r.decode()
                if rng.random() < 0.5:
                    r = r.translate(_COMP)[::-1]
            else:
                r = bases[i].tobytes().decode()
            suffix = ("", "/1", "/2", " comment x")[int(rng.integers(4))]
            recs.append((f"r{seed}_{i}{suffix}", r,
                         quals[i].tobytes().decode()))
        out[seed] = recs
    return out


@pytest.fixture(scope="module")
def inputs(pools, tmp_path_factory):
    """A file of n reads of a seed's pool, written once a form:
    ``inputs(n, seed, fasta=, gz=, wrap=)``."""
    d = tmp_path_factory.mktemp("stream_in")
    made = {}

    def get(n, seed, fasta=False, gz=True, wrap=0):
        key = (n, seed, fasta, gz, wrap)
        if key not in made:
            made[key] = _write(d / f"in{len(made)}", pools[seed][:n],
                               fasta=fasta, gz=gz, wrap=wrap)
        return made[key]

    return get


# The header's host build: host_decide_batch decides n packed reads;
# host_decide is a t4x_decider's decide over a HostCtx; host_fail fails
# at its second batch.
_SHIM = r"""
#include <cstddef>
#include <thread>
#include <vector>
#include "extract_filter.cuh"

namespace {
struct Warp {
  std::vector<uint32_t> cnt;
  uint32_t words[2];
  int32_t round[3 * t4xf::kLanes + 1];
  t4xf::Hit bucket[t4xf::kBucketCap];
  t4xf::Scratch scratch;
  t4xf::Shared sh;
  explicit Warp(int n_seqs) : cnt(n_seqs, 0) {
    sh = t4xf::Shared{cnt.data(), words,  words + 1, round,
                      round + t4xf::kLanes, round + 2 * t4xf::kLanes,
                      bucket, &scratch};
  }
};

void decide(const t4xf::Tables& T, const uint8_t* bases, const int32_t* offs,
            int n, int8_t* out, int threads) {
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; t++)
    ts.emplace_back([&, t] {
      Warp w(T.n_seqs);
      for (int i = t; i < n; i += threads)
        out[i] = (int8_t)t4xf::decide_read(t4xf::HostLanes{}, T,
                                           bases + offs[i],
                                           offs[i + 1] - offs[i], w.sh);
    });
  for (auto& th : ts) th.join();
}
}  // namespace

struct HostCtx {
  const int32_t* off;
  const int32_t* posts;
  int32_t k, radius, hlr, n_seqs;
  const uint8_t* bases;
  const int32_t* offs;
  int8_t* out;
  int32_t threads;
  int64_t calls;
};

extern "C" int host_decide_batch(const int32_t* off, const int32_t* posts,
                                 int k, int radius, int hlr, int n_seqs,
                                 const uint8_t* bases, const int32_t* offs,
                                 int n, int8_t* out, int threads) {
  decide(t4xf::Tables{off, posts, k, radius, hlr, n_seqs}, bases, offs, n,
         out, threads);
  return 0;
}

extern "C" int host_decide(void* ctx, int n, int64_t) {
  HostCtx* c = static_cast<HostCtx*>(ctx);
  c->calls++;
  decide(t4xf::Tables{c->off, c->posts, c->k, c->radius, c->hlr, c->n_seqs},
         c->bases, c->offs, n, c->out, c->threads);
  return 0;
}

extern "C" int host_fail(void* ctx, int n, int64_t n_bases) {
  HostCtx* c = static_cast<HostCtx*>(ctx);
  if (c->calls == 1) return 7;
  return host_decide(ctx, n, n_bases);
}
"""

# The caps of the header's builds: its own, and tiny ones that leave
# reads of over 120 bases, and strands with over 8 hits on their best
# sequence, undecided.
CAPS = {"caps": [], "tiny-caps": ["-DT4XF_MAX_LEN=120",
                                  "-DT4XF_BUCKET_CAP=8"]}


class HostCtx(ctypes.Structure):
    _fields_ = [
        ("off", ctypes.c_void_p), ("posts", ctypes.c_void_p),
        ("k", ctypes.c_int32), ("radius", ctypes.c_int32),
        ("hlr", ctypes.c_int32), ("n_seqs", ctypes.c_int32),
        ("bases", ctypes.c_void_p), ("offs", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("threads", ctypes.c_int32),
        ("calls", ctypes.c_int64),
    ]


@pytest.fixture(scope="module")
def header_builds(tmp_path_factory):
    """caps name -> the g++ build of csrc/extract_filter.cuh."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("extract_filter_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM)
    libs = {}
    for name, flags in CAPS.items():
        so = d / f"lib{name}.so"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-Wall", "-Werror", "-D__host__=", "-D__device__=", *flags,
             f"-I{CSRC_DIR}", "-o", str(so), str(src)],
            check=True, capture_output=True,
        )
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.host_decide_batch.argtypes = ([vp] * 2 + [ci] * 4 + [vp] * 2
                                          + [ci, vp, ci])
        lib.host_decide_batch.restype = ci
        libs[name] = lib
    return libs


def pack(seqs):
    """Reads back to back, and their n + 1 starts."""
    data = [s.encode("ascii") for s in seqs]
    offs = np.zeros(len(data) + 1, np.int32)
    np.cumsum([len(x) for x in data], out=offs[1:])
    return np.frombuffer(b"".join(data) + b"\0", np.uint8), offs


def header_decide(lib, native, seqs):
    """The header's host build's decision of each read."""
    off, posts, (k, radius, hlr, n_seqs) = native.csr_view()
    bases, offs = pack(seqs)
    out = np.zeros(len(seqs), np.int8)
    assert lib.host_decide_batch(
        off.ctypes.data, posts.ctypes.data, k, radius, hlr, n_seqs,
        bases.ctypes.data, offs.ctypes.data, len(seqs), out.ctypes.data,
        4) == 0
    return out


class HostDecider:
    """A stream's decider over the header's host build, with staging of
    its own (a batch of pairs, its bases in parts past 700 KB)."""

    def __init__(self, lib, native, fn="host_decide"):
        self.off, self.posts, meta = native.csr_view()
        self.bases = np.zeros(700_000, np.uint8)
        self.offs = np.zeros(2 * BATCH + 1, np.int32)
        self.out = np.zeros(2 * BATCH, np.int8)
        self.ctx = HostCtx(self.off.ctypes.data, self.posts.ctypes.data,
                           *meta, self.bases.ctypes.data,
                           self.offs.ctypes.data, self.out.ctypes.data, 4, 0)
        self.struct = extract_native.Decider(
            ctypes.cast(getattr(lib, fn), ctypes.c_void_p).value,
            ctypes.addressof(self.ctx), self.bases.ctypes.data,
            len(self.bases), self.offs.ctypes.data, self.out.ctypes.data,
            2 * BATCH)

    def as_decider(self):
        return self.struct


def _both(filters, tmp_path, paths1, paths2, threads, decider=None):
    """Each package's stream over the same inputs: (count, file bytes)."""
    got = []
    for side, f in zip(("torch", "jax"), filters):
        o1 = str(tmp_path / f"{side}_1.fq")
        o2 = str(tmp_path / f"{side}_2.fq") if paths2 else None
        if side == "torch" and decider is not None:
            n = f.extract_stream(paths1, paths2, o1, o2, threads,
                                 decider=decider)
        else:
            n = f.extract_stream(paths1, paths2, o1, o2, threads)
        files = [open(o, "rb").read() for o in (o1, o2) if o]
        got.append((n, files))
    return got


def _assert_same(filters, tmp_path, paths1, paths2, threads, request=None):
    """``threads``: a worker count, or a header build's caps name
    (CAPS), whose decider then filters on 8 workers' host side."""
    decider = None
    caps = threads
    if isinstance(caps, str):
        lib = request.getfixturevalue("header_builds")[caps]
        decider = HostDecider(lib, filters[0])
    (n, files), (want_n, want_files) = _both(
        filters, tmp_path, paths1, paths2, 8 if decider else threads,
        decider)
    assert n == want_n
    assert files == want_files
    if decider is not None:
        card, host = filters[0].decided
        assert (decider.ctx.calls > 0) == (card > 0)
        if caps == "caps":  # no 100-base read meets the header's caps
            assert host == 0
    return n


@pytest.mark.parametrize("threads", THREADS + sorted(CAPS))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_sizes_and_threads(inputs, filters, tmp_path, paired, size,
                           threads, request):
    p1 = inputs(size, 1)
    p2 = inputs(size, 2) if paired else None
    n = _assert_same(filters, tmp_path, [p1], [p2] if paired else None,
                     threads, request)
    if size > 100:
        assert 0 < n < size
    if isinstance(threads, str) and not paired:
        card, host = filters[0].decided
        assert card + host == size
        assert (host > 0) == (threads == "tiny-caps" and size > 100)
    assert filters[0].phase_ns[3] >= 0 and len(filters[0].phase_ns) == 4


# Each layout: (read-1 files, read-2 files or None), as
# (reads, seed, fasta, gz, wrap) a file.
LAYOUTS = {
    "fastq-plain": ([(BATCH + 5, 1, False, False, 0)], None),
    "fastq-plain-pe": ([(BATCH + 5, 1, False, False, 0)],
                       [(BATCH + 5, 2, False, False, 0)]),
    "fasta-gz": ([(BATCH + 5, 1, True, True, 0)], None),
    "fasta-plain-wrapped": ([(2 * BATCH + 3, 1, True, False, 60)], None),
    "fasta-pe": ([(BATCH - 9, 1, True, True, 0)],
                 [(BATCH - 9, 2, True, False, 0)]),
    "chain-se": ([(BATCH - 2, 1, False, True, 0), (7, 3, True, False, 0),
                  (BATCH + 11, 5, False, False, 0)], None),
    "chain-pe": ([(BATCH - 2, 1, False, True, 0),
                  (BATCH + 11, 3, False, False, 0)],
                 [(BATCH + 11, 2, False, False, 0),
                  (BATCH - 2, 4, True, True, 0)]),
    "ragged-mate-short": ([(2 * BATCH + 9, 1, False, True, 0)],
                          [(BATCH + 3, 2, False, True, 0)]),
    "ragged-mate-long": ([(BATCH - 1, 1, False, True, 0)],
                         [(BATCH + 40, 2, False, True, 0)]),
    "ragged-at-batch": ([(BATCH + 1, 1, False, False, 0)],
                        [(BATCH, 2, False, False, 0)]),
}


@pytest.mark.parametrize("threads", [1, 8, "caps"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts(inputs, filters, tmp_path, layout, threads, request):
    def files(specs):
        return [inputs(n, s, fasta=fa, gz=gz, wrap=wrap)
                for n, s, fa, gz, wrap in specs]

    spec1, spec2 = LAYOUTS[layout]
    p1 = files(spec1)
    p2 = files(spec2) if spec2 else None
    n = _assert_same(filters, tmp_path, p1, p2, threads, request)
    assert n > 0


def test_more_workers_than_cores(inputs, filters, tmp_path):
    """The reader beside four filter workers a core: the handoff keeps
    every batch whole and in order."""
    n = 3 * BATCH + 7
    _assert_same(filters, tmp_path, [inputs(n, 1)], [inputs(n, 2)],
                 4 * (os.cpu_count() or 1))


def test_truncated_gzip_reads_as_today(inputs, filters, tmp_path):
    """A gzip stream cut short: what inflates before the cut is read,
    the rest is the end of the file, as in the serial stream."""
    whole = inputs(2 * BATCH, 1)
    data = open(whole, "rb").read()
    cut = tmp_path / "cut.fq.gz"
    cut.write_bytes(data[: len(data) * 3 // 5])
    n = _assert_same(filters, tmp_path, [str(cut)], None, 8)
    assert n > 0


def test_unreadable_file_in_a_chain_is_skipped_as_today(inputs, filters,
                                                         tmp_path):
    p = inputs(BATCH + 3, 1)
    q = inputs(50, 2, gz=False)
    missing = str(tmp_path / "missing.fq")
    _assert_same(filters, tmp_path, [p, missing, q], None, 8)


CHILD = r"""
import json, os, sys
from trust4_tpu_torch.engine.seqset import SeqSet
from trust4_tpu_torch.pipeline import extract_native

fa, cases = json.loads(sys.argv[1])
ss = SeqSet(9)
ss.set_native_only_index()
ss.input_ref_fa(fa)
f = extract_native.NativeCandidateFilter(
    [sw.consensus for sw in ss.seqs], 9, ss.radius, 23)
tasks = lambda: len(os.listdir("/proc/self/task"))
out = []
for p1, p2, o1, o2 in cases:
    before = tasks()
    try:
        n = f.extract_stream(p1, p2, o1, o2, 8)
    except OSError:
        n = "OSError"
    out.append([n, before, tasks()])
print(json.dumps(out))
"""


def test_open_failures_raise_and_no_thread_is_left(inputs, tmp_path):
    """In a child process under a timeout: a missing input (either mate)
    or an output in a missing directory raises OSError, and neither a
    failed nor a finished stream leaves a thread."""
    fa = testing.write_standin_references(str(tmp_path / "ref"))[0]
    good = inputs(BATCH + 5, 1)
    mate = inputs(BATCH + 5, 2)
    missing = str(tmp_path / "missing.fq.gz")
    out = str(tmp_path / "o_1.fq")
    out2 = str(tmp_path / "o_2.fq")
    nodir = str(tmp_path / "no" / "such" / "o.fq")
    cases = [
        [[missing], None, out, None],
        [[good], [missing], out, out2],
        [[good], None, nodir, None],
        [[good], [mate], out, nodir],
        [[good], [mate], out, out2],
        [[good], None, out, None],
    ]
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", CHILD, json.dumps([fa, cases])],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert [g[0] for g in got[:4]] == ["OSError"] * 4
    assert all(isinstance(g[0], int) and g[0] > 0 for g in got[4:])
    for n, before, after in got:
        assert after == before, (n, before, after)


LENGTHS = [8, 9, 50, 100, 150, 250]


@pytest.mark.parametrize("hit_len", [23, 27, 30, 50])
def test_header_decides_as_the_host_filter(refs, header_builds, tmp_path,
                                           hit_len):
    """The header's decision of every read, at its caps and at tiny ones,
    against the host filter's: 0 for a low-complexity read, else
    ``t4x_has_hit``'s strand.  A read the caps leave undecided is the
    stream's host's to decide: at the header's own caps a few of 250
    bases (over 256 hits on one sequence), at tiny ones many."""
    seqs, radius = refs
    native = extract_native.NativeCandidateFilter(seqs, 9, radius, hit_len)
    coord = testing.write_standin_references(str(tmp_path),
                                             coordinates=True)[0]
    templates = [t for t, *_ in testing.clone_templates(coord, 40, hit_len)]
    rng = np.random.default_rng(hit_len)
    reads = [r for n in LENGTHS
             for r in testing.filter_parity_reads(seqs, templates, n, rng)]
    lib = native._lib
    want = np.array([
        0 if lib.t4x_is_low_complexity(r.encode(), len(r)) else
        native.has_hit(r) for r in reads], np.int8)
    assert (want != 0).sum() > len(reads) // 4
    assert (want == -1).sum() > 0 and (want == 1).sum() > 0
    lens = np.array([len(r) for r in reads])
    for caps, share in (("caps", 0.01), ("tiny-caps", 0.1)):
        got = header_decide(header_builds[caps], native, reads)
        undecided = got == extract_native.UNDECIDED
        np.testing.assert_array_equal(got[~undecided], want[~undecided])
        if caps == "caps":
            assert undecided.mean() < share
            assert (lens[undecided] == 250).all()
        else:
            assert undecided.mean() > share


def test_header_decides_as_the_host_filter_on_repeats(refs, header_builds):
    """An index where some k-mers have more than 10,000 postings (a 20-base
    element as 10,001 sequences, and twice in a gene of its own): reads
    across the gene's copies and beside them take the repeats checks,
    the run's one that reads the bucket in its scan order included, and
    reads around the gene's run of 14 A take the windows alike in a row;
    the header decides them as the host does."""
    seqs, radius = refs
    extra, reads = testing.filter_repeats_case()
    native = extract_native.NativeCandidateFilter(seqs + extra, 9, radius,
                                                  23)
    lib = native._lib
    want = np.array([
        0 if lib.t4x_is_low_complexity(r.encode(), len(r)) else
        native.has_hit(r) for r in reads], np.int8)
    assert (want != 0).sum() > len(reads) // 4 and (want == 0).sum() > 0
    got = header_decide(header_builds["caps"], native, reads)
    np.testing.assert_array_equal(got, want)


def test_a_read_past_the_staging_and_a_failing_decider(
        inputs, filters, header_builds, tmp_path):
    """A read longer than the decider's staging is decided on the host;
    a decider that fails ends the stream with an error, and no thread is
    left running."""
    p = inputs(BATCH + 5, 1)
    small = HostDecider(header_builds["caps"], filters[0])
    small.struct.bases_cap = 50
    o = str(tmp_path / "o.fq")
    n = filters[0].extract_stream([p], None, o, None, 8, decider=small)
    assert small.ctx.calls == 0
    assert filters[0].decided == (0, BATCH + 5)
    filters[1].extract_stream([p], None, str(tmp_path / "j.fq"), None, 8)
    assert open(o, "rb").read() == open(tmp_path / "j.fq", "rb").read()
    assert n > 0
    before = len(os.listdir("/proc/self/task"))
    failing = HostDecider(header_builds["caps"], filters[0], "host_fail")
    with pytest.raises(RuntimeError, match="decider failed"):
        filters[0].extract_stream([p], None, o, None, 8, decider=failing)
    assert failing.ctx.calls == 1
    assert len(os.listdir("/proc/self/task")) == before
