"""Device-mesh construction.

Axes:
  data  — batch parallelism; loss/grad/Hvp reductions all-reduce here.
  shard — preconditioner-state partitioning (rows of U/V/d, rows of dense
          Q, the splu tails); the LRA r x r Grams and max-abs step
          normalizers psum here.

The cards of one host are joined all to all (NVLink), so the mapping of
named axes onto devices carries no topology choice; across hosts the same
code works after `jax.distributed.initialize()`.
"""
from __future__ import annotations

import jax
from jax.sharding import AxisType, Mesh


def make_mesh(
    data: int | None = None,
    shard: int = 1,
    devices=None,
) -> Mesh:
    """Build a (data, shard) mesh. `data=None` uses all remaining devices.

    Axes are `AxisType.Auto` (GSPMD propagation): the library annotates
    state shardings at jit boundaries and XLA propagates through the
    preconditioner algebra, inserting collectives where contractions cross
    the `shard` axis. (jax 0.9's default Explicit mode would instead demand
    `out_sharding` at every ambiguous contraction inside the family
    updates.)
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % shard:
            raise ValueError(f"{n} devices not divisible by shard={shard}")
        data = n // shard
    if data * shard > n:
        raise ValueError(f"mesh {data}x{shard} needs {data * shard} devices, have {n}")
    return jax.make_mesh(
        (data, shard),
        ("data", "shard"),
        axis_types=(AxisType.Auto, AxisType.Auto),
        devices=devices[: data * shard],
    )
