"""Candidate read extraction from FASTQ (reference: FastqExtractor.cpp).

A read(-pair) is a candidate when either mate is not low-complexity and has a
chained k-mer hit against the V/D/J/C reference (HasHitInSet).  The candidate
filter is the batched k-mer probe kernel on TPU; this host version mirrors
the reference exactly for the golden path (single-thread semantics).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from trust4_tpu_torch.dna import NUC_TO_NUM
from trust4_tpu_torch.engine.seqset import SeqSet
from trust4_tpu_torch.io.fastx import FastxRecord, read_fastx
from trust4_tpu_torch.ops import gap_oracle
from trust4_tpu_torch.utils import spans


def is_low_complexity(seq: str) -> bool:
    """FastqExtractor.cpp:105-127."""
    cnt = [0, 0, 0, 0, 0]
    n = len(seq)
    for c in seq:
        if c == "N":
            cnt[4] += 1
        else:
            v = NUC_TO_NUM[ord(c) - 65]
            cnt[v] += 1
    if (
        cnt[0] >= n // 2
        or cnt[1] >= n // 2
        or cnt[2] >= n // 2
        or cnt[3] >= n // 2
        or cnt[4] >= n // 10
    ):
        return True
    low = sum(1 for i in range(4) if cnt[i] <= 2)
    return low >= 2


def is_good_candidate(read: str, ref_set: SeqSet) -> bool:
    """FastqExtractor.cpp:129-134."""
    return not is_low_complexity(read) and ref_set.has_hit_in_set(read, 0) != 0


def _read_lengths_head(paths, limit: int):
    """Sequence lengths of the first `limit` records, parsed lazily (the
    whole-file fast path in read_fastx would parse a multi-GB corpus just
    to sample its head)."""
    import gzip

    out = []
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    for p in paths:
        op = gzip.open if str(p).endswith(".gz") else open
        with op(p, "rt") as f:
            first = f.readline()
            if first.startswith("@"):  # FASTQ: fixed 4-line records
                while first:
                    seq = f.readline().strip()
                    f.readline()
                    f.readline()
                    out.append(len(seq))
                    if len(out) >= limit:
                        return out
                    first = f.readline()
            else:  # FASTA (or empty): fall back to the full reader
                for rec in read_fastx([p]):
                    out.append(len(rec.seq))
                    if len(out) >= limit:
                        return out
    return out


def compute_hit_len_required(paths, has_mate: bool) -> int:
    """Adaptive hit length from the first 1000 reads
    (FastqExtractor.cpp:436-454)."""
    hit_len = 27 if has_mate else 23
    total = 0
    n = 0
    for ln in _read_lengths_head(paths, 1000):
        total += ln
        n += 1
        if n >= 1000:
            break
    if n == 0:
        raise ValueError("Read file is empty.")
    if total // (n * 5) > hit_len:
        hit_len = total // (n * 5)
    if hit_len > 101:
        hit_len = 101
    return hit_len


def extract_candidates(
    ref_fa: str,
    read1,
    read2=None,
    kmer_length: int = 9,
    ref_set: Optional[SeqSet] = None,
    use_tpu_prefilter: bool = False,
    batch_size: int = 16384,
    threads: int = 1,
    device: str = "cuda",
) -> Iterator[Tuple[FastxRecord, Optional[FastxRecord]]]:
    """Yield candidate read(-pair)s in input order.

    With use_tpu_prefilter, read batches first pass the conservative
    device cluster prefilter (ops/prefilter.py ``TpuPrefilter``) on
    ``device`` ("cuda", or "cpu" for the same torch program on the host);
    only survivors run the exact host filter, so the candidate set is
    bit-identical either way.
    """
    from trust4_tpu_torch.pipeline import extract_native

    if ref_set is None:
        ref_set = SeqSet(kmer_length)
        if not use_tpu_prefilter and extract_native.available():
            # The native candidate filter owns its own index; skip the
            # host-dict build (only the fallback path would query it).
            ref_set.set_native_only_index()
        ref_set.input_ref_fa(ref_fa)
    hit_len = compute_hit_len_required(read1, read2 is not None)
    ref_set.set_hit_len_required(hit_len)

    native_filter = None
    prefilter = None
    if use_tpu_prefilter:
        from trust4_tpu_torch.ops.prefilter import TpuPrefilter

        prefilter = TpuPrefilter(
            [sw.consensus for sw in ref_set.seqs],
            k=kmer_length,
            hit_len_required=hit_len,
            device=device,
        )
    else:
        if extract_native.available():
            # Exact filter in native code (bit-identical, std::thread).
            native_filter = extract_native.NativeCandidateFilter(
                [sw.consensus for sw in ref_set.seqs],
                kmer_length,
                ref_set.radius,
                hit_len,
            )

    it1 = read_fastx(read1)
    it2 = read_fastx(read2) if read2 is not None else None

    def batches():
        batch = []
        for r1 in it1:
            r2 = next(it2) if it2 is not None else None
            batch.append((r1, r2))
            if len(batch) >= batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    for batch in batches():
        if native_filter is not None:
            nthreads = threads if threads > 1 else (os.cpu_count() or 1)
            good1 = native_filter.filter_batch(
                [r1.seq for r1, _ in batch], threads=nthreads
            )
            if it2 is not None:
                # Mate test only when the first read fails (short-circuit
                # order matches FastqExtractor.cpp:471-477).
                pend = [bi for bi in range(len(batch)) if not good1[bi]]
                if pend:
                    good2 = native_filter.filter_batch(
                        [batch[bi][1].seq for bi in pend], threads=nthreads
                    )
                else:
                    good2 = []
                ok = set(bi for bi in range(len(batch)) if good1[bi])
                ok.update(bi for bi, g in zip(pend, good2) if g)
                for bi in range(len(batch)):
                    if bi in ok:
                        yield batch[bi]
            else:
                for bi in range(len(batch)):
                    if good1[bi]:
                        yield batch[bi]
            continue

        if prefilter is not None:
            pad = max(
                max(len(r1.seq) for r1, _ in batch),
                max((len(r2.seq) for _, r2 in batch if r2 is not None), default=0),
            )
            mask1 = prefilter([r1.seq for r1, _ in batch], pad_len=pad)
            if it2 is not None:
                mask2 = prefilter([r2.seq for _, r2 in batch], pad_len=pad)
            else:
                mask2 = mask1
            survivors = [
                bi for bi in range(len(batch)) if mask1[bi] or mask2[bi]
            ]
        else:
            survivors = list(range(len(batch)))

        if threads > 1 and len(survivors) > 64 and not use_tpu_prefilter:
            # (with the prefilter active this process may hold a CUDA
            # context, which a forked child cannot use; the exact pass over
            # survivors stays serial then, as in the JAX package)
            # The exact filter is per-read independent; fork workers share
            # the index copy-on-write (main.cpp batches of 512*T similarly).
            from trust4_tpu_torch.utils.parallel import map_fork_chunks

            def work(idx_chunk):
                out = []
                for bi in idx_chunk:
                    r1, r2 = batch[bi]
                    good = is_good_candidate(r1.seq, ref_set)
                    if not good and r2 is not None:
                        good = is_good_candidate(r2.seq, ref_set)
                    out.append(good)
                return out

            flags = map_fork_chunks(work, survivors, threads)
            for bi, good in zip(survivors, flags):
                if good:
                    yield batch[bi]
        else:
            for bi in survivors:
                r1, r2 = batch[bi]
                good = is_good_candidate(r1.seq, ref_set)
                if not good and r2 is not None:
                    good = is_good_candidate(r2.seq, ref_set)
                if good:
                    yield r1, r2


def stream_phases(native) -> None:
    """The native stream's phases as the spans' counters extract/read
    (opening, inflating and parsing, one thread: in the bulk stream its
    reader thread, beside the filter), extract/filter (the candidate
    test, on the threads), extract/write (closing included) and, from the
    bulk stream, extract/read_wait (the calling thread waiting for a read
    batch)."""
    for name, ns in zip(("read", "filter", "write", "read_wait"),
                        native.phase_ns):
        spans.counter("extract/" + name, ns)


def run_barcoded_extractor(
    ref_fa: str,
    read1,
    read2=None,
    out_prefix: str = "out",
    barcode_files=None,
    umi_files=None,
    read_format: str = "",
    barcode_whitelist: Optional[str] = None,
    barcode_translate: Optional[str] = None,
    skip_barcode_error_read: bool = False,
    kmer_length: int = 9,
    use_tpu_prefilter: bool = False,
    device: str = "cuda",
) -> None:
    """Barcode/UMI-aware extraction (FastqExtractor.cpp:407-545 single-thread
    flow): candidate test on raw reads, barcode low-complexity guard,
    whitelist correction, translation, and formatted read emission.

    With use_tpu_prefilter, batches of 16384 read tuples first pass the
    device cluster prefilter on ``device``, as in ``extract_candidates``;
    only survivors take the exact test, so the output is unchanged."""
    from trust4_tpu_torch.pipeline.barcode import (
        FORMAT_BARCODE,
        FORMAT_READ1,
        FORMAT_READ2,
        FORMAT_UMI,
        BarcodeCorrector,
        BarcodeTranslator,
        ReadFormatter,
    )

    formatter = ReadFormatter()
    if read_format:
        formatter.init(read_format)
    translator = BarcodeTranslator()
    if barcode_translate:
        translator.set_translate_table(barcode_translate)

    def _build_py_corrector():
        c = BarcodeCorrector()
        c.set_whitelist(barcode_whitelist)
        src = (
            rec.comment if formatter.is_in_comment(FORMAT_BARCODE) else rec.seq
            for rec in read_fastx(barcode_files)
        )
        c.collect_background(src, formatter)
        return c

    corrector = None

    from trust4_tpu_torch.pipeline import extract_native as _xn

    ref_set = SeqSet(kmer_length)
    if not use_tpu_prefilter and _xn.available():
        ref_set.set_native_only_index()
    ref_set.input_ref_fa(ref_fa)
    hit_len = compute_hit_len_required(read1, read2 is not None)
    ref_set.set_hit_len_required(hit_len)

    prefilter = None
    if use_tpu_prefilter:
        from trust4_tpu_torch.ops.prefilter import TpuPrefilter

        prefilter = TpuPrefilter(
            [sw.consensus for sw in ref_set.seqs],
            k=kmer_length,
            hit_len_required=hit_len,
            device=device,
        )

    has_mate = read2 is not None
    has_barcode = barcode_files is not None
    has_umi = umi_files is not None

    # Fully-native streaming loop for the common single-cell case
    # (sequence-sourced --readFormat segments, no whitelist correction or
    # translation): parse, filter, format, and write in C++, bit-identical
    # to the Python loop below (which remains the comment-sourced /
    # corrected / differential path).
    def _paths_l(p):
        if p is None:
            return None
        if isinstance(p, (str, os.PathLike)):
            return [str(p)]
        return [str(x) for x in p]

    if (
        _xn.available()
        and not use_tpu_prefilter
        and not translator.is_set()
        and not any(
            seg.in_comment for cat in formatter.segs for seg in cat
        )
    ):
        import numpy as _np

        rows = [
            (cat, seg.start, seg.end, seg.strand)
            for cat in range(4)
            for seg in formatter.segs[cat]
        ]
        fmt_rows = _np.asarray(rows, dtype=_np.int32).reshape(-1, 4)
        native = _xn.NativeCandidateFilter(
            [sw.consensus for sw in ref_set.seqs], kmer_length,
            ref_set.radius, hit_len,
        )
        p1l, p2l = _paths_l(read1), _paths_l(read2)
        bcl, uml = _paths_l(barcode_files), _paths_l(umi_files)
        umi_alias = has_umi and has_barcode and uml == bcl
        nat_corr = None
        if barcode_whitelist:
            # Native trie: reload the whitelist and re-collect the
            # background counts in C (semantics mirror the Python
            # corrector, which stays as the comment-sourced path and the
            # differential oracle).
            nat_corr = _xn.NativeBarcodeCorrector(barcode_whitelist)
            nat_corr.collect_background(bcl, fmt_rows)
        native.extract_stream_bc(
            p1l, p2l, bcl, None if umi_alias else uml, umi_alias,
            f"{out_prefix}_1.fq" if has_mate else f"{out_prefix}.fq",
            f"{out_prefix}_2.fq" if has_mate else None,
            f"{out_prefix}_bc.fa" if has_barcode else None,
            f"{out_prefix}_umi.fa" if has_umi else None,
            fmt_rows, threads=os.cpu_count() or 1,
            corrector=nat_corr, skip_err=skip_barcode_error_read,
        )
        stream_phases(native)
        return

    if barcode_whitelist:
        corrector = _build_py_corrector()
    fp1 = open(
        f"{out_prefix}_1.fq" if has_mate else f"{out_prefix}.fq", "w"
    )
    fp2 = open(f"{out_prefix}_2.fq", "w") if has_mate else None
    fp_bc = open(f"{out_prefix}_bc.fa", "w") if has_barcode else None
    fp_umi = open(f"{out_prefix}_umi.fa", "w") if has_umi else None

    def output_seq(fp, name, seq, qual, cat):
        s = formatter.extract(seq, cat, True)
        if qual is not None:
            q = formatter.extract(qual, cat, False)
            fp.write(f"@{name}\n{s}\n+\n{q}\n")
        else:
            fp.write(f">{name}\n{s}\n")

    def output_barcode(fp, name, comment, barcode, qual, cat,
                       use_corrector, use_translator):
        """FastqExtractor.cpp:147-198.  Returns 0 to skip the read."""
        if barcode:
            if not formatter.is_in_comment(cat):
                bc = formatter.extract(barcode, cat, True)
            else:
                bc = formatter.extract(comment, cat, True)
            result = 0
            if use_corrector is not None:
                result, bc = use_corrector.correct(bc, qual)
            if result >= 0:
                if use_translator is not None and use_translator.is_set():
                    newbc = use_translator.translate(bc)
                    if not newbc:
                        if skip_barcode_error_read:
                            return 0
                        raise RuntimeError(
                            f"Barcode {bc} does not exist in the translation table."
                        )
                    fp.write(f">{name}\n{newbc}\n")
                else:
                    fp.write(f">{name}\n{bc}\n")
            else:
                if skip_barcode_error_read:
                    return 0
                fp.write(f">{name}\nmissing_barcode\n")
        else:
            if skip_barcode_error_read:
                return 0
            fp.write(f">{name}\nmissing_barcode\n")
        return 1

    from trust4_tpu_torch.pipeline import extract_native

    native_filter = None
    if extract_native.available():
        native_filter = extract_native.NativeCandidateFilter(
            [sw.consensus for sw in ref_set.seqs],
            kmer_length,
            ref_set.radius,
            hit_len,
        )

    it1 = read_fastx(read1)
    it2 = read_fastx(read2) if has_mate else None
    itb = read_fastx(barcode_files) if has_barcode else None
    # 10x runs pass the SAME file as barcode and UMI source (different
    # format slices); alias the records instead of parsing it twice.
    def _paths(p):
        if isinstance(p, (str, os.PathLike)):
            return [str(p)]
        return [str(x) for x in p]

    umi_aliases_barcode = (
        has_umi and has_barcode
        and _paths(umi_files) == _paths(barcode_files)
    )
    itu = (
        read_fastx(umi_files)
        if has_umi and not umi_aliases_barcode
        else None
    )

    def tuples():
        for r1 in it1:
            r2 = next(it2) if it2 is not None else None
            rb = next(itb) if itb is not None else None
            if umi_aliases_barcode:
                ru = rb
            else:
                ru = next(itu) if itu is not None else None
            yield r1, r2, rb, ru

    nthreads = os.cpu_count() or 1

    def exact(seqs):
        if native_filter is not None and seqs:
            return native_filter.filter_batch(seqs, threads=nthreads)
        return [is_good_candidate(s, ref_set) for s in seqs]

    def candidate_tuples():
        batch = []
        def flush():
            # Only reads that pass the prefilter (when it is on) take the
            # exact test; the mate is tested when the first read fails
            # (FastqExtractor.cpp:471-477).
            live = list(range(len(batch)))
            if prefilter is not None:
                pad = max(len(s.seq) for t in batch for s in t[:2]
                          if s is not None)
                mask1 = prefilter([t[0].seq for t in batch], pad_len=pad)
                mask2 = (prefilter([t[1].seq for t in batch], pad_len=pad)
                         if has_mate else mask1)
                live = [bi for bi in live if mask1[bi] or mask2[bi]]
            good1 = exact([batch[bi][0].seq for bi in live])
            pend = [
                bi for bi, g in zip(live, good1)
                if not g and batch[bi][1] is not None
            ]
            good2 = exact([batch[bi][1].seq for bi in pend])
            ok = set(bi for bi, g in zip(live, good1) if g)
            ok.update(bi for bi, g in zip(pend, good2) if g)
            for bi, t in enumerate(batch):
                yield (*t, bi in ok)
        for t in tuples():
            batch.append(t)
            if len(batch) >= 16384:
                yield from flush()
                batch = []
        if batch:
            yield from flush()

    for r1, r2, rb, ru, good in candidate_tuples():
        if good and rb is not None:
            # Guard against barcode==read artifacts (FastqExtractor.cpp:520-526).
            if (
                rb.seq == r1.seq
                or (r2 is not None and rb.seq == r2.seq)
            ) and is_low_complexity(rb.seq):
                good = False
        if not good:
            continue
        barcode_ok = 1
        if rb is not None:
            barcode_ok = output_barcode(
                fp_bc, r1.id, rb.comment, rb.seq, rb.qual, FORMAT_BARCODE,
                corrector, translator,
            )
        if barcode_ok == 0:
            continue
        output_seq(fp1, r1.id, r1.seq, r1.qual, FORMAT_READ1)
        if r2 is not None:
            output_seq(fp2, r1.id, r2.seq, r2.qual, FORMAT_READ2)
        if ru is not None:
            output_barcode(
                fp_umi, r1.id, ru.comment, ru.seq, ru.qual, FORMAT_UMI,
                None, None,
            )
    for fp in (fp1, fp2, fp_bc, fp_umi):
        if fp:
            fp.close()


def card_filter(native, device):
    """The card's candidate filter for ``native``'s index
    (ops/extract_filter.py), or None to filter on the stream's threads.
    The card is taken in the shipping mode (gap_oracle.enabled) on a
    ``cuda`` device once its boot has ended well (gap_oracle.ready): the
    warm samples of a process, not its first, whose extraction runs
    beside the boot's import of torch.  Either path writes the same
    candidate files; an index the kernel cannot take raises."""
    if not (str(device).startswith("cuda") and gap_oracle.enabled()
            and gap_oracle.ready(device)):
        return None
    from trust4_tpu_torch.ops import extract_filter

    return extract_filter.CardFilter(native, device)


def run_extractor(
    ref_fa: str,
    read1,
    read2=None,
    out_prefix: str = "out",
    kmer_length: int = 9,
    use_tpu_prefilter: bool = False,
    threads: int = 1,
    device: str = "cuda",
) -> Tuple[str, Optional[str]]:
    """Write *_toassemble FASTQs like the reference extractor binary.
    ``device`` is where the prefilter runs (use_tpu_prefilter only) and,
    in the shipping mode once the card is up, the candidate test
    (``card_filter``)."""
    native = card = None
    if not use_tpu_prefilter:
        # The reference's index, the hit length and the native filter.
        with spans.span("extract/prepare"):
            from trust4_tpu_torch.pipeline import extract_native

            if extract_native.available():
                ref_set = SeqSet(kmer_length)
                ref_set.set_native_only_index()
                ref_set.input_ref_fa(ref_fa)
                hit_len = compute_hit_len_required(read1, read2 is not None)
                native = extract_native.NativeCandidateFilter(
                    [sw.consensus for sw in ref_set.seqs], kmer_length,
                    ref_set.radius, hit_len,
                )
                del ref_set  # its index is freed inside the span
                card = card_filter(native, device)
    if native is not None:
        # Fully-native streaming loop: parse, filter, and write in C++
        # (bit-identical candidate set and record formatting; the Python
        # loop below is the differential oracle and prefilter path).
        nthreads = threads if threads > 1 else (os.cpu_count() or 1)
        paths1 = [read1] if isinstance(read1, (str, os.PathLike)) else list(read1)
        if read2 is not None:
            paths2 = (
                [read2] if isinstance(read2, (str, os.PathLike)) else list(read2)
            )
            p1, p2 = f"{out_prefix}_1.fq", f"{out_prefix}_2.fq"
            native.extract_stream([str(p) for p in paths1],
                                  [str(p) for p in paths2], p1, p2, nthreads,
                                  decider=card)
        else:
            p1, p2 = f"{out_prefix}.fq", None
            native.extract_stream([str(p) for p in paths1], None, p1, None,
                                  nthreads, decider=card)
        stream_phases(native)
        if spans.on():
            reads = gap_oracle.STATS["extract_reads"]
            for i, n in enumerate(native.decided):
                reads[i] += n
        with spans.span("extract/release"):
            del native, card  # the filter's index and its tables on the card
        return p1, p2

    if read2 is not None:
        p1 = f"{out_prefix}_1.fq"
        p2 = f"{out_prefix}_2.fq"
        with open(p1, "w") as f1, open(p2, "w") as f2:
            for r1, r2 in extract_candidates(
                ref_fa, read1, read2, kmer_length,
                use_tpu_prefilter=use_tpu_prefilter, threads=threads,
                device=device,
            ):
                f1.write(f"@{r1.id}\n{r1.seq}\n+\n{r1.qual}\n")
                f2.write(f"@{r2.id}\n{r2.seq}\n+\n{r2.qual}\n")
        return p1, p2
    p1 = f"{out_prefix}.fq"
    with open(p1, "w") as f1:
        for r1, _ in extract_candidates(
            ref_fa, read1, None, kmer_length,
            use_tpu_prefilter=use_tpu_prefilter, threads=threads,
            device=device,
        ):
            if r1.qual is not None:
                f1.write(f"@{r1.id}\n{r1.seq}\n+\n{r1.qual}\n")
            else:
                f1.write(f">{r1.id}\n{r1.seq}\n")
    return p1, None
