"""The port's candidate prefilters against the JAX package, on the CPU.

trust4_tpu_torch/ops/prefilter.py copies the numpy table builders and
writes the two jnp prefilters as torch programs.  On the same inputs
(numpy, from seeds; the stand-in germline of trust4_tpu_torch/testing.py
in place of the full germline references) the tables and both masks
must equal the JAX package's bit for bit, and an extraction with the
prefilter on (``device="cpu"``) must write the native extractor's files.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from trust4_tpu.ops import prefilter as jax_pf
from trust4_tpu_torch import testing
from trust4_tpu_torch.engine.seqset import SeqSet
from trust4_tpu_torch.ops import prefilter as port_pf
from trust4_tpu_torch.ops.encode import pack_reads, window_codes_batch

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return testing.write_standin_references(
        str(tmp_path_factory.mktemp("standin_ref"))
    )


@pytest.fixture(scope="module")
def germline(refs):
    ss = SeqSet(9)
    ss.input_ref_fa(refs[0])
    return [sw.consensus for sw in ss.seqs]


@pytest.fixture(scope="module")
def postings(germline):
    return (port_pf.build_posting_tables(germline, 9),
            jax_pf.build_posting_tables(germline, 9))


@pytest.fixture(scope="module")
def reads(germline):
    """Random reads, N-bearing reads and germline fragments of several
    lengths (true candidates), packed like the extractor packs them."""
    rng = np.random.default_rng(5)
    out = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(48)]
    out += ["".join(rng.choice(list("ACGTN"), size=90)) for _ in range(8)]
    frags = [s for s in germline if len(s) > 160][:24]
    out += [s[20:120] for s in frags]
    out += [s[30:60] for s in frags[:8]]
    mat = pack_reads(out, 128)
    codes, valid = window_codes_batch(mat, 9)
    return out, codes, valid


def test_membership_tables_match_jax(germline):
    for mine, theirs in zip(port_pf.build_membership_tables(germline, 9),
                            jax_pf.build_membership_tables(germline, 9)):
        np.testing.assert_array_equal(mine, theirs)
        assert mine.dtype == theirs.dtype


def test_posting_tables_match_jax(postings):
    for mine, theirs in zip(*postings):
        np.testing.assert_array_equal(mine, theirs)
        assert mine.dtype == theirs.dtype


def test_encode_reads_matches_jax():
    reads = ["ACGTACGTACGTNNACGTACG", "TTTTGGGGCCCCAAAATTTT", "ACG", ""]
    for mine, theirs in zip(port_pf.encode_reads(reads, 9, 16),
                            jax_pf.encode_reads(reads, 9, 16)):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("hit_len", [23, 27, 80])
def test_membership_mask_matches_jax(germline, reads, hit_len):
    import jax.numpy as jnp

    _reads, codes, valid = reads
    fwd, rc = port_pf.build_membership_tables(germline, 9)
    want = np.asarray(jax_pf.prefilter_kernel(
        jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(fwd),
        jnp.asarray(rc), 9, hit_len))
    got = port_pf.prefilter_kernel(
        *[torch.from_numpy(a) for a in (codes, valid, fwd, rc)], 9, hit_len)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("hit_len", [23, 27, 80])
def test_cluster_mask_matches_jax(postings, reads, hit_len):
    import jax.numpy as jnp

    _reads, codes, valid = reads
    tables = postings[0]
    want = np.asarray(jax_pf.seq_count_prefilter_kernel(
        jnp.asarray(codes), jnp.asarray(valid),
        *[jnp.asarray(t) for t in tables], 9, hit_len, 10))
    got = port_pf.seq_count_prefilter_kernel(
        torch.from_numpy(codes), torch.from_numpy(valid),
        *[torch.from_numpy(t) for t in tables], 9, hit_len, 10)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if hit_len == 80:
        assert want[:48].sum() <= 4  # selective at long-read thresholds


def test_tpu_prefilter_on_cpu_matches_jax(germline, reads):
    seqs = reads[0]
    port = port_pf.TpuPrefilter(germline, k=9, hit_len_required=23,
                                device="cpu")
    want = jax_pf.TpuPrefilter(germline, k=9, hit_len_required=23)(
        seqs, pad_len=100, fixed_batch=128)
    port_pf.reset_stats()
    got = port(seqs, pad_len=100)
    np.testing.assert_array_equal(got, want)
    assert port_pf.STATS == {"batches": 1, "reads": len(seqs),
                             "passed": int(want.sum())}


def test_numpy_prefilter_matches_jax(germline, reads):
    seqs = reads[0]
    want = jax_pf.NumpyPrefilter(germline, k=9, hit_len_required=27)(
        seqs, pad_len=100)
    got = port_pf.NumpyPrefilter(germline, k=9, hit_len_required=27)(
        seqs, pad_len=100)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)


def test_tpu_prefilter_on_cuda_needs_a_card(germline):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        port_pf.TpuPrefilter(germline[:4], device="cuda")


def test_extraction_with_prefilter_matches_native(tmp_path, refs):
    """Gold candidate reads mixed with random background pairs, paired
    end: the prefilter path (device="cpu", batches of 64 so several run)
    and the native extractor write the same _toassemble files."""
    from trust4_tpu_torch.io.fastx import read_fastx
    from trust4_tpu_torch.pipeline import extract

    rng = np.random.default_rng(9)
    r1 = list(read_fastx(os.path.join(DATA, "gold_toassemble_1.fq")))
    r2 = list(read_fastx(os.path.join(DATA, "gold_toassemble_2.fq")))
    paths = [str(tmp_path / f"in_{m}.fq") for m in (1, 2)]
    with open(paths[0], "w") as f1, open(paths[1], "w") as f2:
        for i in range(len(r1) + 120):
            if i % 4 == 3 or i >= len(r1):
                s1, s2 = ("".join(rng.choice(list("ACGT"), 100))
                          for _ in range(2))
                name = f"bg{i}"
            else:
                a, b = r1[i], r2[i]
                s1, s2, name = a.seq, b.seq, a.id
            f1.write(f"@{name}\n{s1}\n+\n{'I' * len(s1)}\n")
            f2.write(f"@{name}\n{s2}\n+\n{'I' * len(s2)}\n")

    native = extract.run_extractor(refs[0], [paths[0]], [paths[1]],
                                   str(tmp_path / "native"))
    port_pf.reset_stats()
    batched = []
    with open(tmp_path / "pf_1.fq", "w") as f1, \
            open(tmp_path / "pf_2.fq", "w") as f2:
        for a, b in extract.extract_candidates(
                refs[0], [paths[0]], [paths[1]], use_tpu_prefilter=True,
                batch_size=64, device="cpu"):
            batched.append(a.id)
            f1.write(f"@{a.id}\n{a.seq}\n+\n{a.qual}\n")
            f2.write(f"@{b.id}\n{b.seq}\n+\n{b.qual}\n")
    via_run = extract.run_extractor(
        refs[0], [paths[0]], [paths[1]], str(tmp_path / "pf_run"),
        use_tpu_prefilter=True, device="cpu")
    assert port_pf.STATS["batches"] > 2 * 5
    assert len(batched) > 100
    for mine, theirs in ((str(tmp_path / "pf_1.fq"), native[0]),
                         (str(tmp_path / "pf_2.fq"), native[1]),
                         (via_run[0], native[0]), (via_run[1], native[1])):
        assert filecmp.cmp(mine, theirs, shallow=False), mine


@pytest.mark.parametrize("paired", [False, True])
def test_barcoded_extraction_with_prefilter_matches_native(
        tmp_path, refs, germline, paired):
    """Barcoded extraction (germline fragments among random reads, a
    barcode/UMI file): the prefilter path (device="cpu") passes reads to
    the exact test and writes the same files as the default native
    stream."""
    from trust4_tpu_torch.pipeline import extract

    rng = np.random.default_rng(11)
    frags = [s for s in germline if len(s) > 130]
    paths = {m: str(tmp_path / f"{m}.fq") for m in ("r1", "r2", "bc")}
    with open(paths["r1"], "w") as f1, open(paths["r2"], "w") as f2, \
            open(paths["bc"], "w") as fb:
        for i in range(300):
            if i % 3 == 0:
                src = frags[int(rng.integers(len(frags)))]
                at = int(rng.integers(0, len(src) - 100))
                s1 = src[at:at + 100]
            else:
                s1 = "".join(rng.choice(list("ACGT"), 100))
            s2 = s1[::-1]
            bc = "".join(rng.choice(list("ACGT"), 26))
            for f, s in ((f1, s1), (f2, s2), (fb, bc)):
                f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    kw = dict(barcode_files=[paths["bc"]], umi_files=[paths["bc"]],
              read_format="bc:0:15,um:16:25")
    r2 = [paths["r2"]] if paired else None
    native = str(tmp_path / "native")
    extract.run_barcoded_extractor(refs[0], [paths["r1"]], r2, native, **kw)
    port_pf.reset_stats()
    pf = str(tmp_path / "pf")
    extract.run_barcoded_extractor(refs[0], [paths["r1"]], r2, pf,
                                   use_tpu_prefilter=True, device="cpu", **kw)
    assert port_pf.STATS["reads"] == 300 * (2 if paired else 1)
    assert 0 < port_pf.STATS["passed"] < port_pf.STATS["reads"]
    sufs = ["_bc.fa", "_umi.fa"] + (["_1.fq", "_2.fq"] if paired else [".fq"])
    for suf in sufs:
        assert os.path.getsize(native + suf) > 0, suf
        assert filecmp.cmp(pf + suf, native + suf, shallow=False), suf
