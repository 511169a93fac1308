"""The CPU modes never load torch: every CLI subcommand and read mode of
the port (bulk, barcoded, bulk and barcoded BAM, SMART-seq; ``run``,
``extract``, ``bamextract``, ``assemble``, ``annotate``, ``smartseq``)
with TRUST4_TPU_DEVICE=0 and with auto, at -t 1 and -t 2 where the
subcommand takes -t, in a child process that records the first thread to
ask for torch (tests/torch_boot_common.py).  No ``--device`` is passed:
the default names the card, which these modes never touch.
"""

import os

import pytest

from torch_boot_common import DATA, spy_cli

BC = os.path.join(DATA, "bc")
BAMBC = os.path.join(DATA, "bambc")
SMARTSEQ = os.path.join(DATA, "smartseq")
GOLD = [os.path.join(DATA, f"gold_toassemble_{m}.fq") for m in (1, 2)]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """{"plain": (coord, imgt), "coord": (coord, imgt) with coordinates,
    "bam": a bulk stand-in BAM, "lists": the SMART-seq cell lists}."""
    from trust4_tpu_torch import testing

    d = str(tmp_path_factory.mktemp("boot_modes"))
    plain = testing.write_standin_references(os.path.join(d, "ref"))
    coord = testing.write_standin_references(os.path.join(d, "ref"),
                                             coordinates=True)
    bam = os.path.join(d, "bulk.bam")
    testing.write_standin_bam(bam, coord[0], 400, seed=11)
    lists = []
    for m in (1, 2):
        lists.append(os.path.join(d, f"list{m}.txt"))
        with open(lists[-1], "w") as f:
            f.write("".join(os.path.join(SMARTSEQ, f"cell{c}_{m}.fq") + "\n"
                            for c in (1, 2)))
    return {"plain": plain, "coord": coord, "bam": bam, "lists": lists}


def _argv(what, refs, out):
    """(argv, takes -t, a file the run must write)."""
    c, i = refs["plain"]
    cc, ci = refs["coord"]
    pe = ["-1", GOLD[0], "-2", GOLD[1]]
    o = os.path.join(out, "x")
    return {
        "run": (["run", *pe, "-f", c, "--ref", i, "-o", o], True,
                "x_cdr3.out"),
        "run-barcoded": (["run", *pe, "-f", c, "--ref", i, "--barcode",
                          os.path.join(BC, "bc.fq"), "--barcodeWhitelist",
                          os.path.join(BC, "bc_wl.txt"), "-o", o], True,
                         "x_barcode_report.tsv"),
        "run-bam": (["run", "-b", refs["bam"], "-f", cc, "--ref", ci, "-o",
                     o], True, "x_report.tsv"),
        "run-bam-barcoded": (["run", "-b", os.path.join(BAMBC, "bc.bam"),
                              "--barcode", "CB", "--UMI", "UB", "-f", cc,
                              "--ref", ci, "-o", o], True,
                             "x_barcode_report.tsv"),
        "smartseq": (["smartseq", "-1", refs["lists"][0], "-2",
                      refs["lists"][1], "-f", c, "--ref", i, "-o", o], True,
                     "x_report.tsv"),
        "extract": (["extract", "-f", c, *pe, "-o", o], False,
                     "x_1.fq"),
        "bamextract": (["bamextract", "-f", cc, "-b", refs["bam"], "-o", o],
                       False, "x_1.fq"),
        "assemble": (["assemble", "-f", c, *pe, "-o", o], False,
                     "x_final.out"),
        "annotate": (["annotate", "-f", i, "-a",
                      os.path.join(DATA, "gold_final.out"), "-r",
                      os.path.join(DATA, "gold_assembled_reads.fa"), "-o",
                      o], True, "x_cdr3.out"),
    }[what]


CASES = [(what, mode, t)
         for what in ("run", "run-barcoded", "run-bam", "run-bam-barcoded",
                      "smartseq", "annotate")
         for mode in ("0", "auto") for t in (1, 2)] + [
    (what, mode, None) for what in ("extract", "bamextract", "assemble")
    for mode in ("0", "auto")]


@pytest.mark.parametrize("what,mode,threads", CASES)
def test_cpu_modes_never_load_torch(refs, tmp_path, what, mode, threads):
    argv, takes_t, wrote = _argv(what, refs, str(tmp_path))
    assert takes_t == (threads is not None)
    if takes_t:
        argv += ["-t", str(threads)]
    r, spy = spy_cli(argv, mode, str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert spy["first"] is None and not spy["loaded"], spy
    assert spy["boot"] == {}
    assert os.path.getsize(os.path.join(str(tmp_path), wrote)) > 0
