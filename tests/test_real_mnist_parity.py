"""Real-MNIST quality parity with the reference's headline claim.

The reference trains LeNet5 with (dense, dense) Kronecker preconditioners
to < 0.7% test error on real MNIST (/root/reference/README.md:44,
mnist_with_lenet5.py:74-75). Hermetic hosts have no egress and ship no idx
files, so this test AUTO-SKIPS unless the four idx files are staged and
pointed at via the `PSGD_TF_TPU_MNIST_DIR` environment variable:

    train-images-idx3-ubyte[.gz]   train-labels-idx1-ubyte[.gz]
    t10k-images-idx3-ubyte[.gz]    t10k-labels-idx1-ubyte[.gz]

Staging (any machine with egress; files are the classic LeCun/mirror set,
e.g. https://storage.googleapis.com/cvdf-datasets/mnist/):

    mkdir -p /data/mnist && cd /data/mnist && \
      curl -O https://storage.googleapis.com/cvdf-datasets/mnist/train-images-idx3-ubyte.gz  # etc
    PSGD_TF_TPU_MNIST_DIR=/data/mnist python -m pytest tests/test_real_mnist_parity.py -v

The run matches the reference's budget: batch 64, 10 epochs of
len(train)/64 steps, lr 0.1 annealed 0.01^(1/9) per epoch. When the
files are absent, the workload's hard-synthetic surrogate
(data/mnist.synthetic_hard, criterion < 5%) carries quality coverage
instead.
"""
import os

import pytest


def _mnist_dir() -> str | None:
    d = os.environ.get("PSGD_TF_TPU_MNIST_DIR")
    if not d:
        return None
    for stem in ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                 "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"):
        if not any(os.path.exists(os.path.join(d, stem + ext))
                   for ext in ("", ".gz")):
            return None
    return d


@pytest.mark.skipif(
    _mnist_dir() is None,
    reason="real MNIST idx files not staged (set PSGD_TF_TPU_MNIST_DIR; "
    "see module docstring for the staging recipe)",
)
def test_lenet5_beats_reference_error_bar():
    from psgd_tf_tpu.workloads import mnist_lenet5

    r = mnist_lenet5.run(
        epochs=10,
        steps_per_epoch=60000 // 64,  # ref mnist_with_lenet5.py:70 (full sweep)
        batch_size=64,
        data_dir=_mnist_dir(),
    )
    assert r["best_test_error"] < 0.007, (
        f"real-MNIST parity: best test error {r['best_test_error']:.4%} "
        "missed the reference's < 0.7% bar (/root/reference/README.md:44)"
    )
