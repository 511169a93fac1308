"""SMART-seq per-cell pipeline driver (reference: trust-smartseq.pl).

Runs the full pipeline per cell file, keeps the top representative chains
per cell, and merges per-cell reports/annotations/AIRR tables with cell-id
rewriting.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional


def _pair_chain_type(*genes) -> Optional[int]:
    for g in genes:
        for prefix, t in (
            ("IGH", 0), ("IGK", 1), ("IGL", 1), ("TRA", 2), ("TRB", 3),
            ("TRG", 4), ("TRD", 5),
        ):
            if g.startswith(prefix):
                return t
    return None


def log(msg: str) -> None:
    print(msg, file=sys.stderr)


def run_smartseq(
    coord_fasta: str,
    imgt_fasta: str,
    read1_list: str,
    read2_list: Optional[str] = None,
    output_prefix: str = "TRUST",
    representative_n: int = 1,
    tmp_dir: str = ".",
    device: str = "cuda",
) -> None:
    """``device`` is each cell's ``run_trust4`` device: "cuda" (the
    default) runs the gap-fill DP on the card, "cpu" its plain PyTorch
    version."""
    from trust4_tpu_torch.pipeline.run import run_trust4

    files1 = [l.strip() for l in open(read1_list) if l.strip()]
    files2 = (
        [l.strip() for l in open(read2_list) if l.strip()]
        if read2_list
        else [None] * len(files1)
    )

    fp_report = open(output_prefix + "_report.tsv", "w")
    fp_annot = open(output_prefix + "_annot.fa", "w")
    fp_airr = open(output_prefix + "_airr.tsv", "w")
    fp_report.write(
        "#count\tfrequency\tCDR3nt\tCDR3aa\tV\tD\tJ\tC\tcid\tcid_full_length\n"
    )
    airr_name_to_col = {}
    cell_processed = 0

    tmp_prefix = os.path.join(tmp_dir, "tmp_smartseq")
    for file1, file2 in zip(files1, files2):
        cell_prefix = os.path.basename(file1).split(".")[0]
        if file2:
            run_trust4(
                coord_fasta, imgt_fasta,
                read1_files=[file1], read2_files=[file2],
                output_prefix=tmp_prefix, skip_mate_extension=True,
                device=device,
            )
        else:
            run_trust4(
                coord_fasta, imgt_fasta,
                single_files=[file1], output_prefix=tmp_prefix,
                device=device,
            )

        with open(tmp_prefix + "_report.tsv") as fp:
            lines = fp.read().splitlines()[1:]
        if not lines:
            log(f"WARNING: no assemblies from {cell_prefix}.")
            continue

        cols = lines[0].split("\t")
        main_type = _pair_chain_type(cols[4], cols[6], cols[7])
        representative_cols = [cols]
        cnt1 = 1
        cnt2 = 0
        for line in lines[1:]:
            cols = line.split("\t")
            chain_type = _pair_chain_type(cols[4], cols[6], cols[7])
            add = False
            if chain_type == main_type:
                if cnt1 < representative_n:
                    add = True
                    cnt1 += 1
            elif (
                chain_type is not None
                and main_type is not None
                and chain_type // 2 == main_type // 2
                and chain_type % 2 == 1 - main_type % 2
            ):
                if cnt2 < representative_n:
                    add = True
                    cnt2 += 1
            if add:
                representative_cols.append(cols)
            if cnt1 >= representative_n and cnt2 >= representative_n:
                break

        selected_contigs = {}
        for i, cols in enumerate(representative_cols):
            out_cols = cols[:]
            contig_id = out_cols[8]
            out_cols[8] = f"{cell_prefix}_{contig_id}"
            if contig_id not in selected_contigs:
                selected_contigs[contig_id] = i
            fp_report.write("\t".join(out_cols) + "\n")

        with open(tmp_prefix + "_annot.fa") as fp:
            annot_lines = fp.read().splitlines()
        for i in range(0, len(annot_lines) - 1, 2):
            cols = annot_lines[i].split(" ")
            contig_id = cols[0][1:]
            if contig_id in selected_contigs:
                cols[0] = f">{cell_prefix}_{contig_id}"
                fp_annot.write(" ".join(cols) + "\n" + annot_lines[i + 1] + "\n")

        with open(tmp_prefix + "_airr.tsv") as fp:
            airr_lines = fp.read().splitlines()
        for li, line in enumerate(airr_lines):
            if li == 0:
                if cell_processed == 0:
                    fp_airr.write(line + "\n")
                    for i, c in enumerate(line.split("\t")):
                        airr_name_to_col[c] = i
                continue
            cols = line.split("\t")
            contig_id = cols[0].split("_")[0]
            if contig_id not in selected_contigs:
                continue
            matched = representative_cols[selected_contigs[contig_id]]
            if matched[2] == cols[13]:
                cols[0] = f"{cell_prefix}_{cols[0]}"
                cols[airr_name_to_col["cell_id"]] = cell_prefix
                fp_airr.write("\t".join(cols) + "\n")

        for suffix in (
            "_report.tsv", "_annot.fa", "_airr.tsv", "_airr_align.tsv",
            "_cdr3.out", "_final.out", "_raw.out", "_assembled_reads.fa",
            "_toassemble_1.fq", "_toassemble_2.fq", "_toassemble.fq",
        ):
            try:
                os.remove(tmp_prefix + suffix)
            except FileNotFoundError:
                pass
        cell_processed += 1

    fp_report.close()
    fp_annot.close()
    fp_airr.close()
