"""Seq2seq + attention translation with mixed Kronecker formats.

Reference parity: /root/reference/neural_machine_translation_with_attention.py —
per-layer mixed Kron formats (ref :99-148, reproduced by
`models.nmt.kron_formats`), both exact-Hvp and finite-difference-Hvp train
steps (ref :173-234; FD noted ~1.3x faster, ref :239-240).

Data: the real spa-eng corpus when `data_path` is given (the reference's
own pipeline — 30k examples, word tokenizers, 80/20 split, batch 64,
lr 0.02 FD-Hvp over 10 epochs, ref :69-80 and :236-241; staging recipe in
data/spa_eng.py), else the procedural reversal-translation pair (no
egress; see data.translation).

This is also the multi-chip flagship: pass `mesh` to shard the batch over
the data axis and replicate params/preconditioner state — see
psgd_tf_tpu.parallel for the sharded training-step builder.
"""
from __future__ import annotations

from functools import partial

import jax

from psgd_tf_tpu import PSGD
from psgd_tf_tpu.data import translation
from psgd_tf_tpu.models import nmt


def synthetic_batch(key, cfg: nmt.Config, batch_size: int, max_len: int):
    """A (src, tgt) batch of the procedural reversal task whose token ids
    fit both vocabularies (the task maps content tokens one to one)."""
    content = min(cfg.vocab_src, cfg.vocab_tgt) - translation.SPECIALS
    return translation.batch(key, batch_size, max_len, content)


def run(
    steps: int = 1000,
    batch_size: int = 64,
    max_len: int = 16,
    seed: int = 0,
    exact_hvp: bool = False,
    cfg: nmt.Config = nmt.Config(),
    lr: float | None = None,  # default 0.05 synthetic, 0.02 real (ref :238)
    mesh=None,
    data_path: str | None = None,
    epochs: int = 10,
    num_examples: int = 30000,
    embed: int = 256,
    units: int = 1024,
) -> dict:
    """`mesh` (a jax.sharding.Mesh with (data, shard) axes, e.g. from
    parallel.make_mesh) runs the whole training step sharded: the batch
    over `data`, preconditioner state per the family policy.

    `data_path` points at a staged spa-eng corpus (file/dir/zip; see
    data/spa_eng.py). It switches the model to the reference's real-run
    dimensions (embed 256, units 1024, attn 10, vocab from the fitted
    tokenizers — ref :81-85), trains `epochs` x len(train)//batch_size
    steps at the reference's lr 0.02 default unless overridden, and
    reports masked val loss + val token accuracy."""
    if data_path is not None:
        # real mode is epoch-based and sizes the model from the corpus:
        # loudly reject synthetic-mode knobs instead of silently ignoring
        # them (a `--set steps=20` quick run must not become a multi-hour
        # full-budget run)
        if steps != 1000:
            raise ValueError(
                "steps applies to the synthetic task only; the real-corpus "
                "run is epoch-based — use epochs=/num_examples= instead"
            )
        if cfg != nmt.Config():
            raise ValueError(
                "cfg applies to the synthetic task only; the real-corpus "
                "run derives vocab from the tokenizers — use embed=/units="
            )
        return _run_real(data_path, batch_size=batch_size, seed=seed,
                         exact_hvp=exact_hvp, lr=0.02 if lr is None else lr,
                         epochs=epochs, num_examples=num_examples, mesh=mesh,
                         embed=embed, units=units)
    lr = 0.05 if lr is None else lr
    key = jax.random.PRNGKey(seed)
    k_init, k_opt, key = jax.random.split(key, 3)
    params = nmt.init(k_init, cfg)
    opt = PSGD(
        preconditioner="kron",
        kron_formats=nmt.kron_formats(cfg),
        lr_params=lr,
        lr_preconditioner=lr,
        grad_clip_max_norm=1.0,
        exact_hessian_vector_product=exact_hvp,
    )
    state = opt.init(params, k_opt)
    if mesh is not None:
        from psgd_tf_tpu.parallel import build_sharded_step

        step = build_sharded_step(opt, nmt.loss, mesh, state, params, donate=False)
    else:
        step = jax.jit(partial(opt.step, nmt.loss))
    token_acc = jax.jit(nmt.token_accuracy)

    first = None
    loss = None
    for _ in range(steps):
        key, k_data, k_step = jax.random.split(key, 3)
        src, tgt = synthetic_batch(k_data, cfg, batch_size, max_len)
        params, state, aux = step(params, state, k_step, src, tgt)
        if first is None:
            first = float(aux["loss"])
        loss = aux["loss"]

    # held-out evaluation batch: teacher-forced token accuracy. An
    # untrained model scores ~1/vocab (~4%); 0.75 at the default 1000 steps
    # is the discriminating bar — a "loss halved" criterion couldn't fail.
    key, k_eval = jax.random.split(key)
    eval_src, eval_tgt = synthetic_batch(k_eval, cfg, 256, max_len)
    acc = float(token_acc(params, eval_src, eval_tgt))
    return {
        "loss": float(loss),
        "first_loss": first,
        "token_accuracy": acc,
        "success": acc > 0.75,
        "steps": steps,
    }


def _run_real(
    data_path: str,
    batch_size: int = 64,
    seed: int = 0,
    exact_hvp: bool = False,
    lr: float = 0.02,          # "A value around 1e-2 will be good" (ref :236-238)
    epochs: int = 10,          # ref :237
    num_examples: int = 30000, # ref :69
    mesh=None,
    embed: int = 256,          # ref :83; shrinkable for smoke tests
    units: int = 1024,         # ref :84
) -> dict:
    """The reference's real spa-eng run (ref :69-80, :236-241): word-level
    tokenizers, 80/20 split, batch 64 with drop-remainder, FD-Hvp default.
    Success = val token accuracy > 0.5 at the full budget — the tutorial
    model family reaches well past that in 10 epochs; an untrained model
    sits near the unigram ceiling (~0.35 on this corpus, mostly PAD-free
    '<end>'/punctuation mass), so 0.5 requires genuine learning."""
    import numpy as np

    from psgd_tf_tpu.data import spa_eng

    ds = spa_eng.load(data_path, num_examples=num_examples, seed=seed)
    cfg = nmt.Config(
        vocab_src=ds.src_tok.vocab_size,
        vocab_tgt=ds.tgt_tok.vocab_size,
        embed=embed,
        units=units,
        attn=10,     # ref :121-125
    )
    key = jax.random.PRNGKey(seed)
    k_init, k_opt, key = jax.random.split(key, 3)
    params = nmt.init(k_init, cfg)
    opt = PSGD(
        preconditioner="kron",
        kron_formats=nmt.kron_formats(cfg),
        lr_params=lr,
        lr_preconditioner=lr,
        grad_clip_max_norm=1.0,
        exact_hessian_vector_product=exact_hvp,
    )
    state = opt.init(params, k_opt)
    if mesh is not None:
        from psgd_tf_tpu.parallel import build_sharded_step

        step = build_sharded_step(opt, nmt.loss, mesh, state, params, donate=False)
    else:
        step = jax.jit(partial(opt.step, nmt.loss))
    token_acc = jax.jit(nmt.token_accuracy)
    val_loss_fn = jax.jit(nmt.loss)

    rng = np.random.default_rng(seed + 1)
    n_train = ds.src_train.shape[0]
    steps_per_epoch = n_train // batch_size  # drop remainder (ref :80)
    if epochs < 1 or steps_per_epoch < 1:
        raise ValueError(
            f"no training steps: epochs={epochs}, train split {n_train} "
            f"rows < batch_size={batch_size} — shrink batch_size or stage "
            "more examples"
        )
    loss = None
    for _ in range(epochs):
        order = rng.permutation(n_train)
        for b in range(steps_per_epoch):
            idx = order[b * batch_size : (b + 1) * batch_size]
            key, k_step = jax.random.split(key)
            params, state, aux = step(
                params, state, k_step, ds.src_train[idx], ds.tgt_train[idx]
            )
            loss = aux["loss"]

    # teacher-forced val metrics, batched so the (val, S, vocab) logits
    # tensor never materializes whole
    accs, losses, tok_w, pos_w = [], [], [], []
    for b in range(0, ds.src_val.shape[0], batch_size):
        s = slice(b, b + batch_size)  # tail chunk included (one extra compile)
        accs.append(float(token_acc(params, ds.src_val[s], ds.tgt_val[s])))
        losses.append(float(val_loss_fn(params, ds.src_val[s], ds.tgt_val[s])))
        # token_accuracy is per-non-PAD-token, loss is per-position: each
        # batch figure must re-aggregate with ITS denominator or the
        # corpus number is biased toward short-sentence batches
        tok_w.append(int(np.sum(ds.tgt_val[s][:, 1:] != 0)))
        pos_w.append(ds.tgt_val[s][:, 1:].size)
    acc = float(np.average(accs, weights=tok_w))
    return {
        "loss": float(loss),
        "val_loss": float(np.average(losses, weights=pos_w)),
        "token_accuracy": acc,
        "success": acc > 0.5,
        "steps": epochs * steps_per_epoch,
        "vocab_src": cfg.vocab_src,
        "vocab_tgt": cfg.vocab_tgt,
    }


if __name__ == "__main__":
    print(run())
