"""Command-line experiment tools of the port (the counterparts of the JAX
package's tools/dp_kernel_lab.py and tools/vpu_microbench.py).  Each runs
as ``python -m trust4_tpu_torch.tools.<name>`` and does no work at
import."""
