"""The port's native extraction stream against the JAX package's.

``t4x_extract_stream`` in ``trust4_tpu_torch/native/extract_filter.cpp``
reads batch k+1 on its own thread while the filter runs batch k; the JAX
package's stream of the same name reads, filters and writes each batch
in turn.  Both filter with one index built from the stand-in reference,
and every case here holds the port's candidate files and count to the
JAX package's, byte for byte: single-end and paired, gzip and plain,
FASTQ and FASTA, chains of files, ragged pairs, samples of 0 reads to
three batches and more, at 1, 2 and 8 threads.  A stream that cannot
open its input or its output raises ``OSError`` at once, and a stream
leaves no thread behind.
"""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from trust4_tpu.pipeline import extract_native as jax_native
from trust4_tpu_torch import testing
from trust4_tpu_torch.engine.seqset import SeqSet
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


def _both(filters, tmp_path, paths1, paths2, threads):
    """Each package's stream over the same inputs: (count, file bytes)."""
    got = []
    for side, f in zip(("torch", "jax"), filters):
        o1 = str(tmp_path / f"{side}_1.fq")
        o2 = str(tmp_path / f"{side}_2.fq") if paths2 else None
        n = f.extract_stream(paths1, paths2, o1, o2, threads)
        files = [open(o, "rb").read() for o in (o1, o2) if o]
        got.append((n, files))
    return got


def _assert_same(filters, tmp_path, paths1, paths2, threads):
    (n, files), (want_n, want_files) = _both(filters, tmp_path, paths1,
                                             paths2, threads)
    assert n == want_n
    assert files == want_files
    return n


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_sizes_and_threads(inputs, filters, tmp_path, paired, size,
                           threads):
    p1 = inputs(size, 1)
    p2 = inputs(size, 2) if paired else None
    n = _assert_same(filters, tmp_path, [p1], [p2] if paired else None,
                     threads)
    if size > 100:
        assert 0 < n < size
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


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts(inputs, filters, tmp_path, layout, threads):
    def files(specs):
        return [inputs(n, s, fasta=fa, gz=gz, wrap=wrap)
                for n, s, fa, gz, wrap in specs]

    spec1, spec2 = LAYOUTS[layout]
    p1 = files(spec1)
    p2 = files(spec2) if spec2 else None
    n = _assert_same(filters, tmp_path, p1, p2, threads)
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
