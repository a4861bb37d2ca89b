"""LSTM delayed-XOR with Kronecker preconditioners.

Reference parity: /root/reference/lstm_with_xor_problem.py — seq_len 100,
batch 128, hidden 30, (dense, dense) Kron identity Qs, lr 0.02, grad-norm
clip 1.0, success when train loss < 0.1 within max_iters (ref :8-9,
:64-74). README.md:46 expects success "in most of the runs".
"""
from __future__ import annotations

from functools import partial

import jax

from psgd_tf_tpu import PSGD
from psgd_tf_tpu.data import xor
from psgd_tf_tpu.models import lstm


def run(
    max_iters: int = 100_000,
    seq_len: int = 100,
    batch_size: int = 128,
    hidden: int = 30,
    seed: int = 0,
    lr: float = 0.02,
    check_every: int = 100,
) -> dict:
    key = jax.random.PRNGKey(seed)
    k_init, k_opt, key = jax.random.split(key, 3)
    params = lstm.init(k_init, dim_hidden=hidden)
    opt = PSGD(
        preconditioner="kron",
        kron_formats=[("dense", "dense")] * 2,
        lr_params=lr,
        lr_preconditioner=0.01,
        grad_clip_max_norm=1.0,  # ref :65
    )
    state = opt.init(params, k_opt)
    step = jax.jit(partial(opt.step, lstm.loss))

    loss = None
    for it in range(max_iters):
        key, k_data, k_step = jax.random.split(key, 3)
        x, y = xor.batch(k_data, batch_size, seq_len)
        params, state, aux = step(params, state, k_step, x, y)
        # poll the device only every `check_every` steps so the host never
        # serializes the device stream (the reference checks every iter, ref :71)
        if (it + 1) % check_every == 0:
            loss = float(aux["loss"])
            if loss < 0.1:  # ref :72
                return {"loss": loss, "success": True, "steps": it + 1}
    return {"loss": loss, "success": False, "steps": max_iters}


if __name__ == "__main__":
    print(run())
