"""Auxiliary subsystems (SURVEY.md §5): checkpoint/resume, structured
metrics, finite-checks, profiling annotations and the compile-cache
location — all absent in the reference (optimizer state lived only in
process tf.Variables,
/root/reference/preconditioned_stochastic_gradient_descent.py:688-690)."""
from psgd_tf_tpu.utils import checkpoint, checks, compile_cache, metrics, profiling

__all__ = ["checkpoint", "checks", "compile_cache", "metrics", "profiling"]
