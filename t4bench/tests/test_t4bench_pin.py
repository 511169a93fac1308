"""The layouts that cells run stand as they were: for two fixed seeds, the
sha256 of every pool file of the single-end and 10x layouts (the
benchmark's bulk mixes and the tests' tiny ones) and of the frozen
references, and the numbers the judge gives the control's outputs at
both precisions.  The expected values were computed on the harness before
the paired-end layout's hooks went in."""

import hashlib
import json
import os

import pytest

from t4bench.data import standin
from t4bench.reference import control
from t4bench.traffic import generator
from t4bench_common import ROOT, TINY, bench_limits, tiny_cell

SEEDS = (2 ** 31 + 101, 3100000007)


def _mix(name):
    with open(os.path.join(ROOT, "t4bench", "traffic", name + ".json")) as f:
        return json.load(f)


def _config(name):
    with open(os.path.join(ROOT, "t4bench", "configs", name + ".json")) as f:
        return json.load(f)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# config, mix name: the pools pinned.
POOLS = [("bulk-se", "receptor-rich"), ("bulk-se", "receptor-sparse"),
         ("bulk-se", "tiny"), ("sc-10x-5p", "tiny")]

FILES = {
    "bulk-se receptor-rich 2147483749": {
        "s00/reads.fq.gz": "7314a7b92dc38be8a7d80ff37841097016c70a3b903dff74dd9c7d940a1dc4d8",
        "s01/reads.fq.gz": "96eee154b144586f565768d368dc433446ea0bc81a130595ceb6f697d5599db1",
        "s02/reads.fq.gz": "4cb33cdf913d9dc9b4bec29490edae3fa9352d781ae35705d5ef05b2e58c6f49"
    },
    "bulk-se receptor-sparse 2147483749": {
        "s00/reads.fq.gz": "3ae21ad322e05e08e2176b6526e2b118cbf69db70a7171856260c70573f3cc13",
        "s01/reads.fq.gz": "09769dfa1411ea80275f3541b8aa2256664be55f901ab46af981cdb383dee87c"
    },
    "bulk-se tiny 2147483749": {
        "s00/reads.fq.gz": "293fbf170249635459346307f63daae427eba6c643cf78f7ae479a9437fc82ed",
        "s01/reads.fq.gz": "561a8a192a5eb205f36796315d7d488a871afab772191dbfbfef05d6fb414464"
    },
    "sc-10x-5p tiny 2147483749": {
        "s00/R2.fq.gz": "cb4153cb56d6bc5973247e1fb2e8aec0587159af0096f2ce64de02fe2bfff299",
        "s00/R1.fq.gz": "83f094256c7c8d7ee2d87711f0195538d8aa40139f71d33eb519a0d275d0836d",
        "s01/R2.fq.gz": "1e5f3de786f006b7bd60154bfbd3e9460ad06f7daa70007c0ea4746dc1b8900c",
        "s01/R1.fq.gz": "cef92a610ec0b0bf9ce4972ddd4354dd8fcf8c7025f536086ddc6c94f59f82f2"
    },
    "bulk-se receptor-rich 3100000007": {
        "s00/reads.fq.gz": "6808f83a28bc1468cfebba1d8be5f7d6fead304d930d122b82b59500aa41b06c",
        "s01/reads.fq.gz": "6e74759753dc541bcf95ea01b314bc108c332363405f483e0924eebb416a627b",
        "s02/reads.fq.gz": "0ec32d868fe2c271e251eb41fdabe27b31fbaa401df700a421a2db7635e0bc2a"
    },
    "bulk-se receptor-sparse 3100000007": {
        "s00/reads.fq.gz": "e248837ae2fcb478574cd8915cd25b8f15e66e616b67251271a9ce16b8800199",
        "s01/reads.fq.gz": "d39c08df11359381c56a74331ccc6622fdc5217ee2a73f8e632e8fc7393d18ec"
    },
    "bulk-se tiny 3100000007": {
        "s00/reads.fq.gz": "e81d9caeb096017768d73264dbdd89dbb97390dc856bba42021f7ccc64d0fbdd",
        "s01/reads.fq.gz": "1dc86430e2dd708a556b002cf4dad0fcd1292a8838f32287044914ab75953d26"
    },
    "sc-10x-5p tiny 3100000007": {
        "s00/R2.fq.gz": "a0d1c6b7df6923c06218212bf6effa6d458c7d216abb6b88af21f4604b4acada",
        "s00/R1.fq.gz": "6533d0dbee23c09ea31bad8a6b95d8cd7a933f27663a7302779ea0509ec0990d",
        "s01/R2.fq.gz": "64afd044f79f97f265c1a00e1b2bf9e3dc7a48d15b2ca9c9392b0f92f9102882",
        "s01/R1.fq.gz": "ba3e4c5647c78c2c4b44ebbc8896268fdba23a29c19efd26925c255c063b49d4"
    },
    "references": {
        "bcrtcr.fa": "88a265872700567d3c783f8959e4504764b6b5d79f1a7b30bf534cb99774f9a5",
        "IMGT+C.fa": "4c65cc3b53ae9fa06fa3e191b8d3f1692db01c4cd95921a30b9433e3cd7babd7"
    }
}

NUMBERS = {
    "bulk-se 2147483749": {
        "1": {
            "extract_missed": 1.0,
            "extract_extra": 0.9740518962075848,
            "clone_miss": 1.0,
            "v_call_wrong": 0.0,
            "contig_off": 1.0
        },
        "2": {
            "extract_missed": 0.0,
            "extract_extra": 0.0,
            "clone_miss": 0.0,
            "v_call_wrong": 0.0,
            "contig_off": 0.0
        }
    },
    "sc-10x-5p 2147483749": {
        "1": {
            "extract_missed": 2.9769516728624534,
            "extract_extra": 0.9726128793486306,
            "clone_miss": 1.0,
            "v_call_wrong": 0.0,
            "contig_off": 1.0
        },
        "2": {
            "extract_missed": 0.0,
            "extract_extra": 0.0,
            "clone_miss": 0.0,
            "v_call_wrong": 0.0,
            "contig_off": 0.0
        }
    },
    "bulk-se 3100000007": {
        "1": {
            "extract_missed": 1.0,
            "extract_extra": 0.9706666666666667,
            "clone_miss": 1.0,
            "v_call_wrong": 0.0,
            "contig_off": 1.0
        },
        "2": {
            "extract_missed": 0.0,
            "extract_extra": 0.0,
            "clone_miss": 0.0,
            "v_call_wrong": 0.0,
            "contig_off": 0.0
        }
    },
    "sc-10x-5p 3100000007": {
        "1": {
            "extract_missed": 2.9725315515961395,
            "extract_extra": 0.9710896960711638,
            "clone_miss": 1.0,
            "v_call_wrong": 0.0,
            "contig_off": 1.0
        },
        "2": {
            "extract_missed": 0.0,
            "extract_extra": 0.0,
            "clone_miss": 0.0,
            "v_call_wrong": 0.0,
            "contig_off": 0.0
        }
    }
}


def pool_digests(config, mix, seed, tmp):
    """{relative path: sha256} of the pool's files."""
    mix = TINY[config] if mix == "tiny" else _mix(mix)
    out = str(tmp)
    got = {}
    for s in generator.generate_pool(_config(config), mix, seed, out):
        for path in s["files"].values():
            got[os.path.relpath(path, out)] = _sha(path)
            os.remove(path)
    return got


def control_numbers(config, seed, tmp):
    """{resolution: the judged numbers} of the control on the tiny cell."""
    cell = tiny_cell(str(tmp), config, bench_limits())
    return {r: control.control(cell, seed, r, str(tmp / f"r{r}"))
            for r in (1, 2)}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config,mix", POOLS)
def test_pool_bytes(tmp_path, config, mix, seed):
    assert pool_digests(config, mix, seed, tmp_path) == \
        FILES[f"{config} {mix} {seed}"]


def test_references(tmp_path):
    got = {os.path.basename(p): _sha(p)
           for p in standin.write_references(str(tmp_path))}
    assert got == FILES["references"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", ["bulk-se", "sc-10x-5p"])
def test_control_numbers(tmp_path, config, seed):
    got = control_numbers(config, seed, tmp_path)
    assert {str(r): v for r, v in got.items()} == \
        NUMBERS[f"{config} {seed}"]
