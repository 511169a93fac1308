"""End-to-end pipeline driver: extract -> assemble -> annotate -> report.

Python equivalent of the reference's Perl driver (reference: run-trust4).
Stage gating matches --stage 0..3; inter-stage state lives in the same
prefix-named files, so a run can resume from any stage boundary.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from trust4_tpu_torch.pipeline.annotator import Annotator
from trust4_tpu_torch.pipeline.assembler import Assembler
from trust4_tpu_torch.pipeline.extract import run_barcoded_extractor, run_extractor
from trust4_tpu_torch.pipeline.report import airr_report, barcode_rep, simple_rep


def log(msg: str) -> None:
    print(msg, file=sys.stderr)


_STAGE_TIMES = os.environ.get("TRUST4_TPU_STAGE_TIMES", "0") == "1"
_stage_t0 = [0.0]


def _stamp(name: str) -> None:
    """Logs elapsed wall since the previous stamp when
    TRUST4_TPU_STAGE_TIMES=1; with T4_PROF=1 also drains and prints the
    native engine's phase counters (per-stage deltas, thread-summed)."""
    now = time.perf_counter()
    if _STAGE_TIMES and name:
        log(f"[stage-time] {name}: {now - _stage_t0[0]:.3f}s")
    if name and os.environ.get("T4_PROF", "0") == "1":
        try:
            from trust4_tpu_torch.engine import overlap_native as _on

            p = _on.prof_dump()
            if p is not None:
                log(
                    f"[t4-prof] {name}: hits={p['hits_s']:.2f}s"
                    f" chain={p['chain_s']:.2f}s"
                    f" (gsort={p['gsort_s']:.2f}s lis={p['lis_s']:.2f}s"
                    f" fin={p['gfin_s']:.2f}s)"
                    f" score={p['score_s']:.2f}s (sort={p['sort_s']:.2f}s"
                    f" dp={p['score_dp_s']:.2f}s)"
                    f" n_hits={p['n_hits']} n_ovl={p['n_overlaps']}"
                )
        except Exception:
            pass
    _stage_t0[0] = now


def run_trust4(
    coord_fasta: str,
    imgt_fasta: str,
    read1_files: Optional[List[str]] = None,
    read2_files: Optional[List[str]] = None,
    single_files: Optional[List[str]] = None,
    bam_file: Optional[str] = None,
    output_prefix: str = "TRUST",
    stage: int = 0,
    threads: int = 1,
    skip_mate_extension: bool = False,
    abnormal_unmap_flag: bool = False,
    barcode_files: Optional[List[str]] = None,
    umi_files: Optional[List[str]] = None,
    read_format: str = "",
    barcode_whitelist: Optional[str] = None,
    barcode_translate: Optional[str] = None,
    use_tpu_prefilter: bool = False,
    kmer_size: int = 9,
    trim_level: int = 1,
    contig_min_cov: int = 0,
    min_hit_len: int = -1,
    cgene_end: int = 200,
    skip_read_realign: bool = False,
    no_extraction: bool = False,
    assemble_with_ref: bool = False,
    output_read_assignment: bool = False,
    clean_level: int = 0,
    chains_in_barcode: int = 2,
    ref_is_imgt: bool = True,
    imgt_additional_gap: Optional[str] = None,
    bam_barcode_field: str = "",
    bam_umi_field: str = "",
    mate_id_suffix_len: int = -1,
    device: str = "cuda",
) -> None:
    """``device`` is the torch device of the gap-fill DP and of the
    ``use_tpu_prefilter`` extraction prefilter: "cuda" (the default)
    launches the port's CUDA kernel and runs the prefilter on the card,
    and raises without one; "cpu" runs their plain PyTorch versions."""
    # Large freed stage buffers must stay reusable: this VM's anonymous
    # page faults are ~100MB/s and glibc munmaps every freed >128KB
    # block by default (utils/memarena.py).
    from trust4_tpu_torch.utils.memarena import enable_arena_reuse

    enable_arena_reuse()

    prefix = output_prefix
    paired = bool(read1_files)
    has_barcode = barcode_files is not None or (
        bam_file is not None and bam_barcode_field != ""
    )
    has_umi = umi_files is not None or (
        bam_file is not None and bam_umi_field != ""
    )

    _stamp("")
    # Stage 0: extraction (reference: run-trust4:404-446).
    if stage <= 0 and not no_extraction:
        if bam_file is not None:
            from trust4_tpu_torch.pipeline.bam_extract import run_bam_extractor

            run_bam_extractor(
                coord_fasta,
                bam_file,
                prefix + "_toassemble",
                abnormal_unaligned_flag=abnormal_unmap_flag,
                barcode_field=bam_barcode_field,
                umi_field=bam_umi_field,
                mate_id_len=mate_id_suffix_len,
            )
        elif has_barcode or has_umi or read_format:
            run_barcoded_extractor(
                coord_fasta,
                read1_files if paired else single_files,
                read2_files if paired else None,
                prefix + "_toassemble",
                barcode_files=barcode_files,
                umi_files=umi_files,
                read_format=read_format,
                barcode_whitelist=barcode_whitelist,
                barcode_translate=barcode_translate,
                use_tpu_prefilter=use_tpu_prefilter,
                device=device,
            )
        elif paired:
            run_extractor(
                coord_fasta,
                read1_files,
                read2_files,
                prefix + "_toassemble",
                use_tpu_prefilter=use_tpu_prefilter,
                threads=threads,
                device=device,
            )
        else:
            run_extractor(
                coord_fasta,
                single_files,
                None,
                prefix + "_toassemble",
                use_tpu_prefilter=use_tpu_prefilter,
                threads=threads,
                device=device,
            )

    _stamp("extract")

    if bam_file is not None:
        # The BAM extractor decides SE vs PE from the library stats
        # (run-trust4:452-466 checks which files exist).
        paired = os.path.exists(prefix + "_toassemble_1.fq")

    if no_extraction:
        # run-trust4:410-448: assemble straight from the provided inputs.
        asm_reads = list(read1_files) if paired else list(single_files)
        asm_mates = list(read2_files) if paired else None
    elif paired:
        asm_reads = [prefix + "_toassemble_1.fq"]
        asm_mates = [prefix + "_toassemble_2.fq"]
    else:
        asm_reads = [prefix + "_toassemble.fq"]
        asm_mates = None

    # Build and load the kernel library before the CPU stages, so a
    # missing card or a failed build stops the run up front instead of
    # after the assembly.
    if stage <= 2 and device != "cpu":
        from trust4_tpu_torch.ops import gap_oracle

        if gap_oracle.enabled():
            import torch

            from trust4_tpu_torch.ops.build import load

            load("dp_counts")
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device={device!r} but torch.cuda.is_available() is "
                    "False; pass device='cpu' to run the plain PyTorch DP"
                )

    # Stage 1: assembly (run-trust4:506-508).
    if stage <= 1:
        asm = Assembler(
            imgt_fasta if assemble_with_ref else coord_fasta,
            output_prefix=prefix,
            index_kmer_length=kmer_size,
            trim_level=trim_level,
            constant_gene_end=cgene_end,
            min_hit_len=min_hit_len,
            contig_min_cov=contig_min_cov,
            skip_mate_extension=skip_mate_extension,
            threads=threads,
            device=device,
        )
        asm.run(
            asm_reads,
            asm_mates,
            barcode_files=[prefix + "_toassemble_bc.fa"] if has_barcode else None,
            umi_files=[prefix + "_toassemble_umi.fa"] if has_umi else None,
        )

    _stamp("assemble")

    # Stage 2: annotation (run-trust4:512-550).
    if stage <= 2:
        ann = Annotator(
            imgt_fasta,
            output_prefix=prefix,
            is_imgt=ref_is_imgt,
            imgt_additional_gap=imgt_additional_gap,
            has_barcode=has_barcode,
            has_umi=has_umi,
            threads=threads,
            device=device,
        )
        _sub = _STAGE_TIMES
        _t0 = time.perf_counter()

        def _substamp(what: str) -> None:
            nonlocal _t0
            now = time.perf_counter()
            if _sub:
                log(f"[stage-time]   ann/{what}: {now - _t0:.3f}s")
            _t0 = now

        ann.load_assembly(prefix + "_final.out")
        _substamp("load")
        ann.annotate_all()
        _substamp("annotate")
        with open(prefix + "_annot.fa", "w") as fp:
            ann.write_annotation_fasta(fp)
        ann.write_airr_align(prefix + "_airr_align.tsv")
        _substamp("writers")
        if not skip_read_realign:
            ann.realign_and_write_cdr3(
                prefix + "_assembled_reads.fa",
                prefix + "_cdr3.out",
                read_assignment_path=(
                    prefix + "_assign.out" if output_read_assignment else None
                ),
            )
            _substamp("realign")
        else:
            # run-trust4:521-524: --skipReadRealign uses the
            # consensus-coverage CDR3 writer.
            ann.write_cdr3_from_consensus(prefix + "_cdr3.out")

    _stamp("annotate")

    # Stage 3: reports (run-trust4:553-566).
    if stage <= 3:
        if not has_barcode:
            with open(prefix + "_report.tsv", "w") as fp:
                simple_rep(prefix + "_cdr3.out", fp)
            with open(prefix + "_airr.tsv", "w") as fp:
                airr_report(
                    prefix + "_report.tsv",
                    prefix + "_annot.fa",
                    fp,
                    "simplerep",
                    prefix + "_airr_align.tsv",
                )
        else:
            with open(prefix + "_barcode_report.tsv", "w") as fp:
                barcode_rep(
                    prefix + "_cdr3.out", fp, prefix + "_annot.fa",
                    chains_in_barcode=chains_in_barcode,
                )
            with open(prefix + "_report.tsv", "w") as fp:
                simple_rep(
                    prefix + "_cdr3.out",
                    fp,
                    use_barcode_cnt=True,
                    filter_barcoderep=prefix + "_barcode_report.tsv",
                )
            with open(prefix + "_airr.tsv", "w") as fp:
                airr_report(
                    prefix + "_report.tsv",
                    prefix + "_annot.fa",
                    fp,
                    "simplerep",
                    prefix + "_airr_align.tsv",
                )
            with open(prefix + "_barcode_airr.tsv", "w") as fp:
                airr_report(
                    prefix + "_barcode_report.tsv",
                    prefix + "_annot.fa",
                    fp,
                    "barcoderep",
                    prefix + "_airr_align.tsv",
                )
    _stamp("report")

    # --clean levels (run-trust4:569-582).
    if clean_level > 0:
        import glob as _glob

        log("Remove intermediate files.")
        for f in _glob.glob(prefix + "_toassemble_*"):
            _remove_quiet(f)
        for suffix in (
            "_toassemble.fq", "_assembled_reads.fa", "_final.out",
            "_raw.out", "_airr_align.tsv",
        ):
            _remove_quiet(prefix + suffix)
        if clean_level > 1:
            for suffix in ("_annot.fa", "_report.tsv", "_cdr3.out"):
                _remove_quiet(prefix + suffix)
            if has_barcode:
                _remove_quiet(prefix + "_barcode_report.tsv")

    log("TRUST4 finishes.")


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
