"""Command-line interface mirroring the reference tool family.

Subcommands (reference binaries in parentheses):
  run       end-to-end pipeline (run-trust4)
  extract   FASTQ candidate extraction (fastq-extractor)
  bamextract BAM candidate extraction (bam-extractor)
  assemble  de-novo assembly (trust4)
  annotate  contig annotation + CDR3 calling (annotator)

Usage: python -m trust4_tpu_torch <subcommand> [options]

The gap-fill DP and the `--tpuPrefilter` extraction prefilter run on the
CUDA card unless `--device cpu` (on `run`, `extract`, `assemble`,
`annotate` and `smartseq`) asks for their plain PyTorch versions.

Under torchrun (WORLD_SIZE > 1), `run` joins the ranks' default process
group (NCCL when each rank has a card of its own, gloo on the CPU or
when ranks share a card; parallel/mesh.py) and every rank runs the
pipeline: with TRUST4_TPU_GAP_MESH=<n> the annotation's gap DP is
sharded over the n ranks.  Rank 0 writes `-o`; the other ranks work in a
temporary directory of their own, removed at exit.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys


def _detect_imgt(path: str) -> bool:
    """-f file containing IMGT '.' gaps is promoted to --ref
    (run-trust4:526-540)."""
    with open(path) as fp:
        for line in fp:
            if line.startswith(">"):
                continue
            if "." in line:
                return True
    return False



def _flatfiles(lst):
    """Flatten `action="append", nargs="+"` file lists and expand globs
    (run-trust4 accepts `-1 a.fq b.fq 'c*.fq'` until the next flag and
    globs each token)."""
    import glob as _glob

    out = []
    for group in lst:
        items = group if isinstance(group, list) else [group]
        for item in items:
            hits = sorted(_glob.glob(item))
            out.extend(hits if hits else [item])
    return out


def cmd_run(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch run")
    p.add_argument("-f", dest="coord_fasta", required=True,
                   help="V/D/J/C genomic reference fasta")
    p.add_argument("--ref", dest="imgt_fasta", default="",
                   help="IMGT allele reference fasta")
    p.add_argument("-1", dest="read1", action="append", nargs="+", default=[])
    p.add_argument("-2", dest="read2", action="append", nargs="+", default=[])
    p.add_argument("-u", dest="single", action="append", nargs="+", default=[])
    p.add_argument("-b", dest="bam", default=None)
    p.add_argument("-o", dest="prefix", default="")
    p.add_argument("--od", dest="outdir", default="")
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("--barcode", action="append", nargs="+", default=[])
    p.add_argument("--UMI", action="append", nargs="+", default=[])
    p.add_argument("--readFormat", default="")
    p.add_argument("--barcodeWhitelist", default=None)
    p.add_argument("--barcodeTranslate", default=None)
    p.add_argument("--repseq", action="store_true")
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--skipMateExtension", action="store_true")
    p.add_argument("--abnormalUnmapFlag", action="store_true")
    p.add_argument("--imgtAdditionalGap", default=None)
    p.add_argument("-k", dest="kmerSize", type=int, default=9,
                   help="starting k-mer size for indexing contigs")
    p.add_argument("--barcodeLevel", default="cell",
                   choices=["cell", "molecule"])
    p.add_argument("--contigMinCov", type=int, default=0)
    p.add_argument("--minHitLen", type=int, default=-1)
    p.add_argument("--mateIdSuffixLen", type=int, default=-1)
    p.add_argument("--cgeneEnd", type=int, default=200)
    p.add_argument("--skipReadRealign", action="store_true")
    p.add_argument("--noExtraction", action="store_true")
    p.add_argument("--assembleWithRef", action="store_true")
    p.add_argument("--outputReadAssignment", action="store_true")
    p.add_argument("--clean", type=int, default=0)
    p.add_argument("--tpuPrefilter", action="store_true",
                   help="put the device cluster prefilter before the exact "
                   "candidate filter in extraction")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the gap-fill DP and the prefilter "
                   "(default cuda)")
    args = p.parse_args(argv)
    args.read1 = _flatfiles(args.read1)
    args.read2 = _flatfiles(args.read2)
    args.single = _flatfiles(args.single)
    args.barcode = _flatfiles(args.barcode)
    args.UMI = _flatfiles(args.UMI)

    from trust4_tpu_torch.pipeline.run import run_trust4

    if args.noExtraction and args.bam:
        p.error("--noExtraction option can only be set with -1 -2/-u input.")
    if args.assembleWithRef and not args.imgt_fasta:
        p.error("--assembleWithRef requires --ref.")

    imgt = args.imgt_fasta
    coord = args.coord_fasta
    ref_is_imgt = True
    if not imgt and _detect_imgt(coord):
        # run-trust4:526-540 promotes an IMGT-format -f to --ref.
        imgt = coord
    if not imgt:
        imgt = coord
        ref_is_imgt = False

    prefix = args.prefix
    if not prefix:
        base = None
        if args.bam:
            base = args.bam
        elif args.read1:
            base = args.read1[0]
        elif args.single:
            base = args.single[0]
        prefix = (
            "TRUST_" + os.path.basename(base).split(".")[0] if base else "TRUST"
        )
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        prefix = os.path.join(args.outdir, prefix)

    with _rank_prefix(prefix, args.device) as prefix:
        run_trust4(
            coord,
            imgt,
            read1_files=args.read1 or None,
            read2_files=args.read2 or None,
            single_files=args.single or None,
            bam_file=args.bam,
            output_prefix=prefix,
            stage=args.stage,
            threads=args.threads,
            skip_mate_extension=args.skipMateExtension or args.repseq,
            abnormal_unmap_flag=args.abnormalUnmapFlag,
            barcode_files=(args.barcode or None) if not args.bam else None,
            umi_files=(args.UMI or None) if not args.bam else None,
            read_format=args.readFormat,
            barcode_whitelist=args.barcodeWhitelist,
            barcode_translate=args.barcodeTranslate,
            kmer_size=args.kmerSize,
            trim_level=2 if args.repseq else 1,
            contig_min_cov=args.contigMinCov,
            min_hit_len=args.minHitLen,
            cgene_end=args.cgeneEnd,
            skip_read_realign=args.skipReadRealign,
            no_extraction=args.noExtraction,
            assemble_with_ref=args.assembleWithRef,
            output_read_assignment=args.outputReadAssignment,
            clean_level=args.clean,
            chains_in_barcode=1 if args.barcodeLevel == "molecule" else 2,
            ref_is_imgt=ref_is_imgt,
            imgt_additional_gap=args.imgtAdditionalGap,
            bam_barcode_field=(
                args.barcode[0] if (args.bam and args.barcode) else ""
            ),
            bam_umi_field=args.UMI[0] if (args.bam and args.UMI) else "",
            use_tpu_prefilter=args.tpuPrefilter,
            device=args.device,
        )
    return 0


@contextlib.contextmanager
def _rank_prefix(prefix: str, device: str):
    """The output prefix of this rank.  Outside a torchrun world of more
    than one rank: ``prefix``.  Inside one: the default group is joined
    (unless the caller already did), rank 0 keeps ``prefix``, and every
    other rank gets a private temporary directory holding copies of the
    earlier stages' ``prefix_*`` files, removed at exit."""
    import glob
    import shutil
    import tempfile

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield prefix
        return
    import torch.distributed as dist

    from trust4_tpu_torch.parallel import mesh

    joined = not dist.is_initialized()
    if joined:
        dev = mesh.rank_device(device)
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        mesh.init_world(mesh.choose_backend(dev, local), dev)
    tmp = None
    try:
        if dist.get_rank() > 0:
            tmp = tempfile.mkdtemp(prefix=f"t4rank{dist.get_rank()}_")
            for path in glob.glob(glob.escape(prefix) + "_*"):
                if os.path.isfile(path):
                    shutil.copy(path, tmp)
            prefix = os.path.join(tmp, os.path.basename(prefix))
        dist.barrier()  # the copies are whole before rank 0 writes
        yield prefix
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        if joined:
            dist.destroy_process_group()


def cmd_extract(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch extract")
    p.add_argument("-f", dest="ref", required=True)
    p.add_argument("-1", dest="read1", action="append", nargs="+", default=[])
    p.add_argument("-2", dest="read2", action="append", nargs="+", default=[])
    p.add_argument("-u", dest="single", action="append", nargs="+", default=[])
    p.add_argument("-o", dest="prefix", default="toassemble")
    p.add_argument("--barcode", action="append", nargs="+", default=[])
    p.add_argument("--UMI", action="append", nargs="+", default=[])
    p.add_argument("--readFormat", default="")
    p.add_argument("--barcodeWhitelist", default=None)
    p.add_argument("--barcodeTranslate", default=None)
    p.add_argument("--tpuPrefilter", action="store_true",
                   help="put the device cluster prefilter before the exact "
                   "candidate filter")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the prefilter (default cuda)")
    args = p.parse_args(argv)
    args.read1 = _flatfiles(args.read1)
    args.read2 = _flatfiles(args.read2)
    args.single = _flatfiles(args.single)
    args.barcode = _flatfiles(args.barcode)
    args.UMI = _flatfiles(args.UMI)

    from trust4_tpu_torch.pipeline.extract import (
        run_barcoded_extractor,
        run_extractor,
    )

    r1 = args.read1 or args.single
    r2 = args.read2 or None
    if args.barcode or args.UMI or args.readFormat:
        run_barcoded_extractor(
            args.ref, r1, r2, args.prefix,
            barcode_files=args.barcode or None,
            umi_files=args.UMI or None,
            read_format=args.readFormat,
            barcode_whitelist=args.barcodeWhitelist,
            barcode_translate=args.barcodeTranslate,
            use_tpu_prefilter=args.tpuPrefilter,
            device=args.device,
        )
    else:
        run_extractor(
            args.ref, r1, r2, args.prefix,
            use_tpu_prefilter=args.tpuPrefilter,
            device=args.device,
        )
    return 0


def cmd_bamextract(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch bamextract")
    p.add_argument("-f", dest="ref", required=True)
    p.add_argument("-b", dest="bam", required=True)
    p.add_argument("-o", dest="prefix", default="toassemble")
    p.add_argument("-u", dest="abnormal", action="store_true")
    p.add_argument("--barcode", default="")
    p.add_argument("--UMI", default="")
    p.add_argument("--mateIdSuffixLen", type=int, default=-1)
    args = p.parse_args(argv)

    from trust4_tpu_torch.pipeline.bam_extract import run_bam_extractor

    run_bam_extractor(
        args.ref, args.bam, args.prefix,
        abnormal_unaligned_flag=args.abnormal,
        barcode_field=args.barcode,
        umi_field=args.UMI,
        mate_id_len=args.mateIdSuffixLen,
    )
    return 0


def cmd_assemble(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch assemble")
    p.add_argument("-f", dest="ref", required=True)
    p.add_argument("-1", dest="read1", action="append", nargs="+", default=[])
    p.add_argument("-2", dest="read2", action="append", nargs="+", default=[])
    p.add_argument("-u", dest="single", action="append", nargs="+", default=[])
    p.add_argument("-o", dest="prefix", default="trust")
    p.add_argument("-k", dest="kmer", type=int, default=9)
    p.add_argument("-c", dest="kmerCountFile", default=None,
                   help="jellyfish2 k-mer count dump to use instead of counting")
    p.add_argument("--barcode", action="append", nargs="+", default=[])
    p.add_argument("--UMI", action="append", nargs="+", default=[])
    p.add_argument("--trimLevel", type=int, default=1)
    p.add_argument("--skipMateExtension", action="store_true")
    p.add_argument("--minHitLen", type=int, default=-1)
    p.add_argument("--contigMinCov", type=int, default=0)
    p.add_argument("--cgeneEnd", type=int, default=200)
    p.add_argument("--keepNoBarcode", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the gap-fill DP (default cuda)")
    args = p.parse_args(argv)
    args.read1 = _flatfiles(args.read1)
    args.read2 = _flatfiles(args.read2)
    args.single = _flatfiles(args.single)
    args.barcode = _flatfiles(args.barcode)
    args.UMI = _flatfiles(args.UMI)

    from trust4_tpu_torch.pipeline.assembler import Assembler

    asm = Assembler(
        args.ref,
        output_prefix=args.prefix,
        index_kmer_length=args.kmer,
        trim_level=args.trimLevel,
        constant_gene_end=args.cgeneEnd,
        min_hit_len=args.minHitLen,
        skip_mate_extension=args.skipMateExtension,
        contig_min_cov=args.contigMinCov,
        keep_missing_barcode=args.keepNoBarcode,
        kmer_count_file=args.kmerCountFile,
        device=args.device,
    )
    asm.run(
        args.read1 or args.single,
        args.read2 or None,
        barcode_files=args.barcode or None,
        umi_files=args.UMI or None,
    )
    return 0


def cmd_annotate(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch annotate")
    p.add_argument("-f", dest="ref", required=True)
    p.add_argument("-a", dest="assembly", required=True)
    p.add_argument("-r", dest="reads", default=None)
    p.add_argument("-o", dest="prefix", default="trust")
    p.add_argument("--fasta", action="store_true",
                   help="assembly input is plain fasta/fastq")
    p.add_argument("--barcode", action="store_true")
    p.add_argument("--UMI", action="store_true")
    p.add_argument("--noImpute", action="store_true")
    p.add_argument("--notIMGT", action="store_true")
    p.add_argument("--needReverseComplement", action="store_true")
    p.add_argument("--outputFormat", type=int, default=0)
    p.add_argument("--outputCDR3File", action="store_true")
    p.add_argument("--airrAlignment", action="store_true")
    p.add_argument("--readAssignment", default=None)
    p.add_argument("--imgtAdditionalGap", default=None)
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the gap-fill DP (default cuda)")
    args = p.parse_args(argv)

    from trust4_tpu_torch.pipeline.annotator import Annotator

    ann = Annotator(
        args.ref,
        output_prefix=args.prefix,
        imgt_additional_gap=args.imgtAdditionalGap,
        impute=not args.noImpute,
        need_rc=args.needReverseComplement,
        has_barcode=args.barcode,
        has_umi=args.UMI,
        threads=args.threads,
        device=args.device,
    )
    if args.fasta:
        ann.load_fasta(args.assembly)
    else:
        ann.load_assembly(args.assembly)
    ann.annotate_all()
    if args.outputFormat == 1:
        ann.write_airr_annotation(sys.stdout)
    else:
        ann.write_annotation_fasta(sys.stdout)
    if args.airrAlignment:
        ann.write_airr_align(args.prefix + "_airr_align.tsv")
    if args.reads:
        ann.realign_and_write_cdr3(
            args.reads, args.prefix + "_cdr3.out",
            read_assignment_path=args.readAssignment,
        )
    elif args.outputCDR3File:
        ann.write_cdr3_from_consensus(args.prefix + "_cdr3.out")
    return 0


def cmd_report(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch report")
    p.add_argument("cdr3_file")
    p.add_argument("--junction", default=None)
    p.add_argument("--barcodeCnt", action="store_true")
    p.add_argument("--filterBarcoderep", default=None)
    p.add_argument("--reportPartial", action="store_true")
    p.add_argument("--decimalCnt", action="store_true")
    args = p.parse_args(argv)

    from trust4_tpu_torch.pipeline.report import simple_rep

    simple_rep(
        args.cdr3_file,
        sys.stdout,
        annot_path=args.junction,
        round_down_count=not args.decimalCnt,
        report_partial=args.reportPartial,
        use_barcode_cnt=args.barcodeCnt,
        filter_barcoderep=args.filterBarcoderep,
    )
    return 0


def cmd_barcoderep(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch barcoderep")
    p.add_argument("cdr3_file")
    p.add_argument("-a", dest="annot", default=None)
    p.add_argument("--reportPartial", action="store_true")
    p.add_argument("--noImputation", action="store_true")
    p.add_argument("--imputeBCR", action="store_true")
    p.add_argument("--chainsInBarcode", type=int, default=2)
    args = p.parse_args(argv)
    from trust4_tpu_torch.pipeline.report import barcode_rep

    barcode_rep(
        args.cdr3_file, sys.stdout, args.annot,
        report_partial=args.reportPartial,
        impute=not args.noImputation,
        impute_bcr=args.imputeBCR,
        chains_in_barcode=args.chainsInBarcode,
    )
    return 0


def cmd_airr(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch airr")
    p.add_argument("report_file")
    p.add_argument("annot_file")
    p.add_argument("--format", default="simplerep")
    p.add_argument("--airr-align", dest="airr_align", default=None)
    args = p.parse_args(argv)
    from trust4_tpu_torch.pipeline.report import airr_report

    airr_report(
        args.report_file, args.annot_file, sys.stdout, args.format,
        args.airr_align,
    )
    return 0


def cmd_smartseq(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch smartseq")
    p.add_argument("-1", dest="read1_list", required=True)
    p.add_argument("-2", dest="read2_list", default=None)
    p.add_argument("-f", dest="coord_fasta", required=True)
    p.add_argument("--ref", dest="imgt_fasta", default="")
    p.add_argument("-o", dest="prefix", default="TRUST")
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("--representative", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the gap-fill DP (default cuda)")
    args = p.parse_args(argv)
    from trust4_tpu_torch.pipeline.smartseq import run_smartseq

    run_smartseq(
        args.coord_fasta,
        args.imgt_fasta or args.coord_fasta,
        args.read1_list,
        args.read2_list,
        args.prefix,
        args.representative,
        device=args.device,
    )
    return 0


def cmd_stats(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch stats")
    p.add_argument("-r", dest="repfile", required=True)
    p.add_argument("-f", dest="format", default="TRUST4_report")
    args = p.parse_args(argv)
    from trust4_tpu_torch.scripts.stats import trust_stats

    trust_stats(args.repfile, args.format)
    return 0


def cmd_cluster(argv) -> int:
    p = argparse.ArgumentParser(prog="trust4_tpu_torch cluster")
    p.add_argument("cdr3_file")
    p.add_argument("-s", dest="similarity", type=float, default=0.8)
    p.add_argument("--prefix", default="cluster")
    p.add_argument("--center", action="store_true")
    p.add_argument("--representative", action="store_true")
    p.add_argument("--format", default="cdr3")
    args = p.parse_args(argv)
    from trust4_tpu_torch.scripts.cluster import trust_cluster

    trust_cluster(
        args.cdr3_file, args.similarity, args.prefix, args.representative,
        "center" if args.center else "aggressive", args.format,
    )
    return 0


def cmd_script(argv) -> int:
    """Post-analysis utilities: barcoderep-filter, barcoderep-expand,
    to-10x, filter-annot, full-length, add-seq, imgt-gap, build-db,
    build-imgt."""
    from trust4_tpu_torch.scripts import barcode_utils, build_ref, imgt_gap

    if not argv:
        print(cmd_script.__doc__)
        return 1
    name, rest = argv[0], argv[1:]
    if name == "barcoderep-filter":
        p = argparse.ArgumentParser()
        p.add_argument("-b", dest="b", required=True)
        p.add_argument("-a", dest="a", default=None)
        p.add_argument("--highAbund", type=float, default=50.0)
        p.add_argument("--diffuseFrac", type=float, default=0.02)
        a = p.parse_args(rest)
        barcode_utils.barcoderep_filter(
            a.b, annot=a.a, high_abund=a.highAbund, diffuse_frac=a.diffuseFrac
        )
    elif name == "barcoderep-expand":
        p = argparse.ArgumentParser()
        p.add_argument("-b", dest="b", required=True)
        p.add_argument("--chain", type=int, default=1)
        p.add_argument("--frac", type=float, default=0.1)
        a = p.parse_args(rest)
        barcode_utils.barcoderep_expand(a.b, chain=a.chain, frac=a.frac)
    elif name == "to-10x":
        barcode_utils.barcoderep_to_10x(rest[0], rest[1])
    elif name == "filter-annot":
        barcode_utils.filter_annotated_assembly(rest[0])
    elif name == "full-length":
        barcode_utils.get_full_length_assembly(rest[0])
    elif name == "add-seq":
        barcode_utils.add_sequence_to_cdr3_file(rest[0], rest[1])
    elif name == "imgt-gap":
        p = argparse.ArgumentParser()
        p.add_argument("-i", dest="imgt", required=True)
        p.add_argument("-a", dest="airr", required=True)
        a = p.parse_args(rest)
        imgt_gap.airr_imgt_gap(a.imgt, a.airr)
    elif name == "build-db":
        build_ref.build_database_fa(rest[0], rest[1], rest[2])
    elif name == "build-imgt":
        build_ref.build_imgt_annot(rest[0], rest[1])
    else:
        print(f"Unknown script {name}", file=sys.stderr)
        return 1
    return 0


COMMANDS = {
    "run": cmd_run,
    "extract": cmd_extract,
    "bamextract": cmd_bamextract,
    "assemble": cmd_assemble,
    "annotate": cmd_annotate,
    "report": cmd_report,
    "barcoderep": cmd_barcoderep,
    "airr": cmd_airr,
    "smartseq": cmd_smartseq,
    "stats": cmd_stats,
    "cluster": cmd_cluster,
    "script": cmd_script,
}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        print(f"Unknown subcommand {argv[0]}", file=sys.stderr)
        print(__doc__)
        return 1
    return cmd(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
