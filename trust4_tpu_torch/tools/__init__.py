"""Command-line tools of the port (the counterparts of the JAX package's
tools/dp_kernel_lab.py, tools/vpu_microbench.py,
tools/fuzz_differential{,_barcoded}.py, tools/make_bench_corpus.py,
tools/asan_check.sh and tools/debug_trace_check.sh), and boot_order.py,
which measures where the device stack's boot starts and is joined.
Each runs as ``python -m trust4_tpu_torch.tools.<name>`` and does no
work at import."""
