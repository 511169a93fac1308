"""Read layouts, one module a layout: ``layouts/<layout>.py``, found by the
``layout`` name of a configuration, as a metric's reader is found by its
name.  A layout module provides

``generate(rng, cfg, mix, pools, out_dir) -> sample``
    one sample's reads written under ``out_dir`` and what it planted
    (``files``, ``reads``: the cDNA FASTQ or the mates' FASTQs,
    ``n_reads`` (every mate counted), ``clones``,
    ``read_clone``, ``read_start``, ``read_group``: the group a read's
    chain is judged in, such as its cell, or None; for reads in pairs,
    ``fragment_max``: the longest fragment, the widest gap that a contig
    scaffolded by mates may span);
``run_args(sample) -> dict``
    the input keywords of ``run_trust4`` for the sample;
``OUTPUTS``
    the output files (suffixes of the prefix) the judge reads; those
    named ``_toassemble*.fq`` hold the extracted reads, the read table
    in equal shares, one a file, in order (``judge.extraction_files``);
``wrong_barcodes(prefix, sample, kept) -> int``
    kept reads written with another group's barcode;
``reported(prefix, sample) -> {group: [(cdr3, v_calls, j_calls)]}``
    the chains the program's report gives each group;
``write_report(prefix, sample, kept, cdr3, reduce)``
    the control's answers written as the program's report files.

and may provide, where its reads are not one single-end FASTQ
(``reference/judge.py``'s ``hook`` gives the single-end default):

``read_table(sample) -> (n, L) uint8``
    the reference's table of input reads, one row a read, in the order
    of ``read_clone`` and ``read_start``, such as both mates' files
    (default: the rows of the one FASTQ ``sample["reads"]``);
``keep(sample, hit) -> bool (n,)``
    the reads the reference keeps, from whether each row itself shares
    a K-mer with the coordinate genes, such as every mate of a fragment
    of which either mate does (default: ``hit``).

Code shared by every layout tests no layout's name."""

from __future__ import annotations

import importlib.util
import os
from types import ModuleType
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
_LOADED: Dict[str, ModuleType] = {}


def load(name: str, folder: str = HERE) -> ModuleType:
    """The layout module ``<folder>/<name>.py`` (``layouts/`` of this
    checkout by default)."""
    path = os.path.join(folder, name + ".py")
    if path not in _LOADED:
        if not os.path.exists(path):
            raise ValueError(f"no read layout {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            "t4bench_layout_" + name.replace("-", "_").replace(".", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
