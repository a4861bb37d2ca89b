"""Multi-chip partitioning of PSGD training (SURVEY.md §2.4).

The reference is single-device; this package owns the build's distributed
design: a device mesh with a `data` axis (batch parallelism) and a `shard`
axis (preconditioner/optimizer state partitioning, ZeRO-style), sharding
policies per preconditioner family, and a builder that jits an
`opt.step` under those shardings so GSPMD inserts the collectives —
grad/Hvp psums over `data`, r x r Gram-matrix psums over `shard`.
"""
from psgd_tf_tpu.parallel.mesh import make_mesh
from psgd_tf_tpu.parallel.policies import (
    batch_sharding,
    precond_sharding,
    replicated,
    state_sharding,
)
from psgd_tf_tpu.parallel.step import build_sharded_step

__all__ = [
    "make_mesh",
    "batch_sharding",
    "precond_sharding",
    "replicated",
    "state_sharding",
    "build_sharded_step",
]
