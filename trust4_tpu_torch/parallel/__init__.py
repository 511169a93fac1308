"""Device rounds of the pipeline beyond the gap oracle.

Port of trust4_tpu/parallel/.  This slice holds the read-realignment
round on one card (``realign_round``); the process-group forms of the
JAX package's mesh programs (gap_mesh, realign over a 2-D mesh,
asm_mesh) are still to be ported (ROADMAP.md).
"""

from trust4_tpu_torch.parallel.realign_mesh import (  # noqa: F401
    default_chunk,
    realign_round,
)
