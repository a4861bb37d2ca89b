"""psgd_tf_tpu — a JAX PSGD (Preconditioned SGD) framework.

Built from scratch in JAX/XLA with the capabilities of the reference
TensorFlow implementation (lixilinx/psgd_tf): pure-functional pytree
state, static-shape compiled steps, O(n^2) and O(n r) formulations of the
structured linear algebra, and mesh sharding for the preconditioner
state. It runs on an NVIDIA GPU (and on the CPU for tests).

Public surface:
  - groups.{dense,diag,xmat,shift,splu,kron,lra}: preconditioner families
    with a uniform init/update/apply contract.
  - hvp: exact (forward-over-reverse) and finite-difference Hessian-vector
    products.
  - optim.PSGD: one optimizer over every family, with the reference's full
    hyperparameter surface.
  - parallel: mesh/sharding policies for multi-chip state partitioning.
"""
from psgd_tf_tpu import hvp, utils
from psgd_tf_tpu.groups import dense, diag, kron, lra, shift, splu, xmat
from psgd_tf_tpu.optim.psgd import PSGD, PSGDState, Hyper
from psgd_tf_tpu.optim.uvd import UVd

__version__ = "0.1.0"

__all__ = [
    "PSGD",
    "UVd",
    "PSGDState",
    "Hyper",
    "hvp",
    "utils",
    "dense",
    "diag",
    "kron",
    "lra",
    "shift",
    "splu",
    "xmat",
]
