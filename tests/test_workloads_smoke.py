"""Tiny-setting smoke runs of every workload module on the CPU mesh —
catches API rot between the workload layer, models, data, and the
optimizer without full-size budgets."""
import jax.numpy as jnp

from psgd_tf_tpu.models import nmt
from psgd_tf_tpu.workloads import (
    all_preconditioners,
    hello_psgd,
    lstm_xor,
    mnist_lenet5,
    nmt_attention,
    rnn_xor_lra,
)


def test_hello_psgd_smoke():
    r = hello_psgd.run(steps=20)
    assert jnp.isfinite(r["loss"]) and r["steps"] == 20


def test_all_preconditioners_smoke():
    r = all_preconditioners.run("lra", steps=5, rank=3)
    assert jnp.isfinite(r["loss"])


def test_mnist_lenet5_smoke():
    r = mnist_lenet5.run(epochs=1, steps_per_epoch=2, batch_size=8, eval_size=64)
    assert 0.0 <= r["best_test_error"] <= 1.0
    assert r["success"] in (True, False)  # discriminating: CAN be False


def test_lstm_xor_smoke():
    r = lstm_xor.run(max_iters=4, seq_len=8, batch_size=8, hidden=4, check_every=2)
    assert jnp.isfinite(r["loss"])


def test_rnn_xor_lra_smoke():
    r = rnn_xor_lra.run(
        max_iters=4, seq_len=8, batch_size=8, hidden=4, rank=2,
        switch_to_fd_at=2, check_every=2,
    )
    assert jnp.isfinite(r["loss"])


def test_nmt_attention_smoke():
    cfg = nmt.Config(vocab_src=16, vocab_tgt=16, embed=8, units=12, attn=4)
    r = nmt_attention.run(steps=3, batch_size=4, max_len=6, cfg=cfg)
    assert 0.0 <= r["token_accuracy"] <= 1.0
    assert r["success"] is False  # 3 steps cannot hit the 0.75 bar


def test_nmt_attention_unequal_vocabs_stay_finite():
    """Source and target vocabularies of different sizes (the reference's
    9414 / 4935): every synthetic token id fits both, so the loss is
    finite from the first step."""
    cfg = nmt.Config(vocab_src=40, vocab_tgt=24, embed=8, units=12, attn=4)
    r = nmt_attention.run(steps=2, batch_size=8, max_len=6, cfg=cfg)
    assert jnp.isfinite(r["first_loss"]) and jnp.isfinite(r["loss"])


def test_nmt_attention_sharded_smoke():
    """The workload's mesh path runs the full sharded step end to end."""
    from psgd_tf_tpu.parallel import make_mesh

    cfg = nmt.Config(vocab_src=16, vocab_tgt=16, embed=8, units=12, attn=4)
    mesh = make_mesh(data=4, shard=2)
    r = nmt_attention.run(steps=2, batch_size=8, max_len=6, cfg=cfg, mesh=mesh)
    assert jnp.isfinite(r["loss"])
