"""LeNet5 digit classification with (dense, dense) Kronecker preconditioners.

Reference parity: /root/reference/mnist_with_lenet5.py — batch 64, lr 0.1
annealed by 0.01^(1/9) per epoch over 10 epochs, grad-norm clip
0.1*sqrt(num_params), identity Kron Qs (ref :59-63, :76). The reference's
README claims < 0.7% test error on real MNIST (README.md:44).

Data: real MNIST idx files when `data_dir` is given, else the HARD
procedural digit set (hermetic environments have no egress;
data/mnist.synthetic_hard) whose affine/noise/occlusion augmentation
leaves LeNet5 at a non-zero error plateau, so the success criterion below
can actually fail (the easy set sits at 0.0%, testing nothing). The training
step is one jitted function; the lr anneal rides the traced `lr_params`
hyperparameter (`PSGD.set_hyper`), so rescheduling never recompiles.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from psgd_tf_tpu import PSGD
from psgd_tf_tpu.data import mnist
from psgd_tf_tpu.models import lenet5


def run(
    epochs: int = 10,
    steps_per_epoch: int = 200,
    batch_size: int = 64,
    seed: int = 0,
    data_dir: str | None = None,
    lr: float = 0.1,
    eval_size: int = 2000,
) -> dict:
    key = jax.random.PRNGKey(seed)
    k_init, k_opt, k_eval, key = jax.random.split(key, 4)
    params = lenet5.init(k_init)
    num_params = sum(p.size for p in jax.tree_util.tree_leaves(params))

    opt = PSGD(
        preconditioner="kron",
        kron_formats=[("dense", "dense")] * 5,   # ref :61-62
        lr_params=lr,
        lr_preconditioner=0.1,
        grad_clip_max_norm=0.1 * num_params**0.5,  # ref :63
    )
    state = opt.init(params, k_opt)
    step = jax.jit(partial(opt.step, lenet5.loss))
    eval_err = jax.jit(lenet5.error_rate)

    if data_dir is not None:
        x_train, y_train, x_test, y_test = mnist.load_idx(data_dir)
        x_train, y_train = jnp.asarray(x_train), jnp.asarray(y_train)
        x_test, y_test = jnp.asarray(x_test), jnp.asarray(y_test)

        def get_batch(k):
            idx = jax.random.randint(k, (batch_size,), 0, x_train.shape[0])
            return x_train[idx], y_train[idx]

        test_batch = (x_test, y_test)
    else:
        get_batch = lambda k: mnist.synthetic_hard(k, batch_size)
        test_batch = mnist.synthetic_hard(k_eval, eval_size)

    anneal = 0.01 ** (1.0 / 9.0)  # ref :76
    best_err = 1.0
    first = loss = None
    for epoch in range(epochs):
        for _ in range(steps_per_epoch):
            key, sub, kb = jax.random.split(key, 3)
            params, state, aux = step(params, state, sub, *get_batch(kb))
            if first is None:
                first = float(aux["loss"])
            loss = aux["loss"]
        err = float(eval_err(params, *test_batch))
        best_err = min(best_err, err)
        state = PSGD.set_hyper(state, lr_params=lr * anneal ** (epoch + 1))
    # Discriminating target: on the hard synthetic set a PSGD-trained
    # LeNet5 plateaus at a few percent; plain SGD at the same budget sits
    # several points higher, and an untrained net at 90%. 5% fails for any
    # broken optimizer/model path.
    # With real idx data the reference's own <0.7% claim is the bar.
    target = 0.007 if data_dir is not None else 0.05
    return {
        "loss": float(loss),
        "first_loss": first,
        "best_test_error": best_err,
        "success": best_err < target,
        "steps": epochs * steps_per_epoch,
    }


if __name__ == "__main__":
    print(run())
