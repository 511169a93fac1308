"""trust4_tpu_torch — the PyTorch/CUDA port of trust4_tpu.

A second package beside ``trust4_tpu`` (the JAX reference, which stays as
it is): the same immune-repertoire reconstruction (candidate read
extraction, de-novo contig assembly, IMGT annotation with CDR1/2/3 calls,
clonotype reports), with the device work in PyTorch and CUDA kernels
written by hand for an NVIDIA H100 (``csrc/``, built by ``ops/build.py``).
Module names mirror ``trust4_tpu``.  The package imports torch, numpy and
the standard library, never jax and never ``trust4_tpu``.  The CLI, the
pipeline and the gap oracle's front import no torch: the shipping mode
imports it on the oracle's boot thread, and the CPU modes never do.

Layer map:
  dna, io         — host-side sequence utilities and FASTQ/FASTA/BAM ingest
  align           — the CPU banded-DP family (host oracle + native C++)
  ops             — k-mer programs; dp (plain PyTorch DP), dp_counts (its
                    CUDA kernel wrapper), gap_oracle, build (nvcc + ctypes)
  engine          — SeqSet assembly/annotation engine (native C++ behind it)
  pipeline        — extractor / assembler / annotator / report stages
  testing         — stand-in germline references built from test dumps
"""

__version__ = "0.1.0"
