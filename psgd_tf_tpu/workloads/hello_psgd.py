"""Rosenbrock hello-world (reference parity: /root/reference/hello_psgd.py).

Dense preconditioner with init scale 0.1, precond lr 0.2, param lr 0.5,
500 iterations (ref :8, :25-27). The reference runs eager; here the whole
step is one jitted function — the first-compile cost amortizes across the
loop, and the same code runs on the CPU or a GPU unchanged.
"""
from __future__ import annotations

from functools import partial

import jax

from psgd_tf_tpu import PSGD
from psgd_tf_tpu.models import rosenbrock


def run(
    steps: int = 500,
    preconditioner: str = "dense",
    seed: int = 0,
    lr_params: float = 0.5,
    lr_preconditioner: float = 0.2,
) -> dict:
    params = rosenbrock.init()
    opt = PSGD(
        preconditioner=preconditioner,
        rank=2,
        init_scale=0.1,
        lr_params=lr_params,
        lr_preconditioner=lr_preconditioner,
    )
    state = opt.init(params, jax.random.PRNGKey(seed))
    step = jax.jit(partial(opt.step, rosenbrock.loss))
    key = jax.random.PRNGKey(seed + 1)
    loss = None
    for _ in range(steps):
        key, sub = jax.random.split(key)
        params, state, aux = step(params, state, sub)
        loss = aux["loss"]
    final = float(loss)
    return {"loss": final, "success": final < 1e-4, "steps": steps}


if __name__ == "__main__":
    print(run())
