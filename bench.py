"""Benchmark harness for an NVIDIA GPU. Prints ONE JSON line on stdout:

    {"metric": ..., "value": N, "unit": ..., "device": {...}, "detail": {...}}

Headline metric: LeNet5 digit-classification training steps/sec at batch
64 with (dense, dense) Kronecker preconditioners — the reference's
canonical workload (the reference's mnist_with_lenet5.py). Also measured
and reported on stderr: preconditioner update+apply throughput (nnz/s)
for every family, where nnz counts the preconditioner state entries
touched per update+apply pair, and the NMT step at the reference's
dimensions. The device, the card and its power limit travel with the
result. Exits non-zero without a GPU, and when any row raised.
"""
from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_chained(step_fn, make_state, iters: int = 100, reps: int = 3):
    """Per-iteration device time of `state -> state`, measured as the
    slope between a short and a long scan-chained execution.

    Chaining iterations through one lax.scan gives sequential data
    dependencies; fresh inputs per rep. Timing the SAME body at two chain
    lengths and taking (t_long - t_short) / (iters_long - iters_short)
    cancels the fixed cost of launching one execution."""

    def build(length):
        @jax.jit
        def run(state):
            return jax.lax.scan(
                lambda c, _: (step_fn(c), None), state, None, length=length
            )[0]
        return run

    # size the long chain to >= ~0.4s of device work, from a warm short run
    short = iters
    run_s = build(short)
    jax.block_until_ready(run_s(make_state(0)))
    t0 = time.perf_counter()
    jax.block_until_ready(run_s(make_state(99)))
    est = max((time.perf_counter() - t0) / short, 1e-7)
    long_ = min(max(5 * short, int(0.4 / est)), 50 * short)
    run_l = build(long_)
    jax.block_until_ready(run_l(make_state(0)))

    slopes = []
    for rep in range(1, reps + 1):
        state = make_state(rep)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        jax.block_until_ready(run_s(state))
        t_s = time.perf_counter() - t0
        state = make_state(rep + 100)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        jax.block_until_ready(run_l(state))
        t_l = time.perf_counter() - t0
        slopes.append((t_l - t_s) / (long_ - short))
    slopes.sort()
    med = slopes[len(slopes) // 2]
    # every rep's slope travels with the result, so the artifact carries
    # its own error bars
    spread = {
        "slopes_us": [round(s * 1e6, 3) for s in slopes],
        "rel_spread": round((slopes[-1] - slopes[0]) / max(med, 1e-12), 4),
    }
    return med, spread


def bench_lenet5_steps_per_sec(batch_size: int = 64, chain: int = 200) -> float:
    """Steps/sec of the full PSGD training step, measured as a
    scan-compiled training loop over pre-generated batches — robust to
    host-dispatch latency."""
    from psgd_tf_tpu import PSGD
    from psgd_tf_tpu.data import mnist
    from psgd_tf_tpu.models import lenet5

    key = jax.random.PRNGKey(0)
    params = lenet5.init(key)
    num_params = sum(p.size for p in jax.tree_util.tree_leaves(params))
    opt = PSGD(
        preconditioner="kron",
        kron_formats=[("dense", "dense")] * 5,
        lr_params=0.1,
        lr_preconditioner=0.1,
        grad_clip_max_norm=0.1 * num_params**0.5,
    )
    state = opt.init(params, key)
    xs, ys = mnist.synthetic(key, batch_size * 8)
    xs = xs.reshape(8, batch_size, 28, 28, 1)
    ys = ys.reshape(8, batch_size)

    def build(length):
        @jax.jit
        def train(params, state, key):
            def body(carry, i):
                params, state, key = carry
                key, sub = jax.random.split(key)
                p, s, aux = opt.step(
                    lenet5.loss, params, state, sub, xs[i % 8], ys[i % 8]
                )
                return (p, s, key), aux["loss"]

            (params, state, _), losses = jax.lax.scan(
                body, (params, state, key), jnp.arange(length)
            )
            return params, state, losses[-1]
        return train

    short, long_ = chain, 5 * chain
    run_s, run_l = build(short), build(long_)
    jax.block_until_ready(run_s(params, state, key))  # warm both compiles
    jax.block_until_ready(run_l(params, state, key))
    slopes = []
    for rep in range(1, 4):
        # fresh key per rep; the slope between short and long chains
        # cancels the fixed per-execution cost (see time_chained)
        k1, k2 = jax.random.PRNGKey(rep), jax.random.PRNGKey(rep + 100)
        jax.block_until_ready((k1, k2))
        t0 = time.perf_counter()
        jax.block_until_ready(run_s(params, state, k1))
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(run_l(params, state, k2))
        t_l = time.perf_counter() - t0
        slopes.append((t_l - t_s) / (long_ - short))
    return 1.0 / min(s for s in slopes if s > 0)


def family_nnz(family: str, n: int, rank: int = 10) -> int:
    """Preconditioner state entries touched per update+apply pair."""
    family = family.split("_")[0]
    return {
        "lra": 2 * n * rank + n,
        "splu": 2 * n * rank + 2 * (n - rank),
        "dense": n * (n + 1) // 2,
        "diag": n,
        "xmat": 2 * n,
        "shift": 2 * n,
    }[family]


def bench_family_nnz_per_sec(family: str, n: int, rank: int = 10,
                             iters: int = 100, dtype=jnp.float32):
    """Sequential update+apply throughput on a flat n-parameter problem.
    Returns (nnz/s, slope spread dict). `dtype=bfloat16` benches the
    bf16-state path."""
    from psgd_tf_tpu.groups import base

    family = family.split("_")[0]  # splu_big -> splu (streaming regime row)
    fam = base.FLAT_FAMILIES[family]

    def make_state(rep: int):
        key = jax.random.PRNGKey(rep)
        if family == "lra":
            st = fam.init(key, n, rank=rank, dtype=dtype)
        elif family == "splu":
            st = fam.init(n, rank=rank, dtype=dtype)
        else:
            st = fam.init(n, dtype=dtype)
        v = jax.random.normal(jax.random.fold_in(key, 1), (n,), dtype)
        h = jax.random.normal(jax.random.fold_in(key, 2), (n,), dtype)
        return st, v, h, key

    nnz = family_nnz(family, n, rank)

    def step(carry):
        st, v, h, key = carry
        key = jax.random.fold_in(key, 7)
        st = fam.update(st, v, h, step=1e-4, key=key)
        pre = fam.apply(st, v)
        # thread the apply result back so neither op is dead code
        return st, v + 1e-30 * pre, h, key

    dt, spread = time_chained(step, make_state, iters=iters)
    return nnz / dt, spread


def bench_kron_sparse_gelem_per_sec(
    fmt: tuple[str, str], shape: tuple[int, int], passes: int | None = None,
    iters: int = 10,
):
    """Sparse-format Kronecker update+apply throughput at reference-envelope
    probe shapes (ref README.md:54: (norm, dense) to [1e6, 1e3],
    (norm, scale) to [1e6, 1e6] of STATE; the m x n PROBES bound what any
    implementation can materialize). Returns (probe Gelem/s, model GB/s,
    spread): elem = m*n per update+apply pair; the byte model counts
    `passes` m x n fp32 passes per pair (default: dG once + dX twice for
    the arrow-coupled pairs, dG and dX once for (dense, scale), plus the
    apply's G read and out write).
    """
    from psgd_tf_tpu.groups import kron

    m, n = shape
    arrow = "norm" in fmt
    if passes is None:
        passes = (3 if arrow else 2) + 2

    def make_state(rep: int):
        key = jax.random.PRNGKey(rep)
        st = kron.init(shape, fmt=fmt, init_scale=0.9)
        dX = jax.random.normal(jax.random.fold_in(key, 1), shape)
        dG = jax.random.normal(jax.random.fold_in(key, 2), shape)
        return st, dX, dG

    def step(carry):
        st, dX, dG = carry
        st = kron.update(st, dX, dG, step=1e-4)
        out = kron.apply(st, dG)
        # thread the apply result as the NEXT Hvp probe: a full data
        # dependency (so neither op is dead code) with no extra traffic
        # (`dX + 1e-30 * out` would materialize a fresh copy of dX every
        # iteration). Values: P ~ (0.9)^4 I per apply, so dG decays
        # ~0.66x/iter; chain lengths here stay far from the ~1e-38 flush
        # point, and the op count is value-independent.
        return st, dX, out

    dt, spread = time_chained(step, make_state, iters=iters, reps=3)
    elems = float(m) * float(n)
    return elems / dt, passes * elems * 4.0 / dt / 1e9, spread


def bench_nmt_step_us(exact: bool = False) -> float:
    """Full PSGD training-step time on the NMT flagship (mixed per-layer
    kron formats, ref nmt:99-148), batch 64 — FD Hvp by default (the
    reference's noted-faster configuration, ref nmt:239-240)."""
    from psgd_tf_tpu import PSGD
    from psgd_tf_tpu.data import translation
    from psgd_tf_tpu.models import nmt

    cfg = nmt.Config()
    key = jax.random.PRNGKey(0)
    params = nmt.init(key, cfg)
    src, tgt = translation.batch(jax.random.fold_in(key, 1), 64, 16)
    opt = PSGD(
        preconditioner="kron", kron_formats=nmt.kron_formats(cfg),
        lr_params=0.05, lr_preconditioner=0.05, grad_clip_max_norm=1.0,
        exact_hessian_vector_product=exact,
    )
    state = opt.init(params, key)

    def step(carry):
        p, s, k = carry
        k, sub = jax.random.split(k)
        p, s, _ = opt.step(nmt.loss, p, s, sub, src, tgt)
        return (p, s, k)

    dt, spread = time_chained(
        step, lambda rep: (params, state, jax.random.PRNGKey(rep)), iters=30
    )
    return dt * 1e6, spread


def bench_nmt_ref_dims(iters: int = 8):
    """The NMT workload at the REFERENCE's real dimensions: embed 256,
    units 1024, vocab 9414/4935, batch 64, sequence lengths 16/11
    (ref :68-86; `models.nmt.ref_config`). Tokens are synthetic.

    Returns the phases dict in us. Phases are CUMULATIVE:
    value_and_grad / + FD Hvp pair / + kron Q-update / full PSGD step
    (apply + clip + descend)."""
    from psgd_tf_tpu import PSGD, hvp
    from psgd_tf_tpu.groups import kron
    from psgd_tf_tpu.models import nmt

    cfg = nmt.ref_config()
    key = jax.random.PRNGKey(0)
    params = nmt.init(key, cfg)
    src = jax.random.randint(
        jax.random.fold_in(key, 1), (64, 18), 3, cfg.vocab_src)
    tgt = jax.random.randint(
        jax.random.fold_in(key, 2), (64, 13), 3, cfg.vocab_tgt)

    fmts = nmt.kron_formats(cfg)
    shapes = nmt.layer_shapes(cfg)

    opt = PSGD(
        preconditioner="kron", kron_formats=fmts,
        lr_params=0.02, lr_preconditioner=0.02, grad_clip_max_norm=1.0,
        exact_hessian_vector_product=False,
    )
    state = opt.init(params, key)
    lr_pre = 0.02

    def tree_fold(p, *trees):
        # fold outputs back into the carry so no phase is dead code
        out = p
        for tr in trees:
            out = jax.tree_util.tree_map(
                lambda a, g: a - 1e-30 * g.astype(a.dtype), out, tr)
        return out

    def ph_grad(carry):
        p, pc, k = carry
        k = jax.random.fold_in(k, 1)
        _, grads = hvp.grad_only(nmt.loss, p, src, tgt)
        return tree_fold(p, grads), pc, k

    def ph_hvp(carry):
        p, pc, k = carry
        k = jax.random.fold_in(k, 1)
        v = hvp.random_like(k, p)
        _, grads, hvs = hvp.finite_diff(nmt.loss, p, v, src, tgt)
        return tree_fold(p, grads, hvs), pc, k

    def ph_qupd(carry):
        p, pc, k = carry
        k = jax.random.fold_in(k, 1)
        v = hvp.random_like(k, p)
        _, grads, hvs = hvp.finite_diff(nmt.loss, p, v, src, tgt)
        v_l = [x.astype(jnp.float32) for x in v]
        h_l = [x.astype(jnp.float32) for x in hvs]
        pc = kron.update_multi(pc, v_l, h_l, step=lr_pre)
        return tree_fold(p, grads), pc, k

    def ph_full(carry):
        p, s, k = carry
        k, sub = jax.random.split(k)
        p, s, _ = opt.step(nmt.loss, p, s, sub, src, tgt)
        return p, s, k

    kron_states = [
        kron.init(s, fmt=f, init_scale=1.0) for s, f in zip(shapes, fmts)
    ]
    phases = {}
    for name, fn, carry0 in (
        ("grad", ph_grad, lambda rep: (params, kron_states,
                                       jax.random.PRNGKey(rep))),
        ("hvp", ph_hvp, lambda rep: (params, kron_states,
                                     jax.random.PRNGKey(rep))),
        ("qupd", ph_qupd, lambda rep: (params, kron_states,
                                       jax.random.PRNGKey(rep))),
        ("full", ph_full, lambda rep: (params, state,
                                       jax.random.PRNGKey(rep))),
    ):
        dt, spread = time_chained(fn, carry0, iters=iters)
        phases[name] = {"us": dt * 1e6, "spread": spread}
        log(f"nmt_ref phase {name:4s}: {dt * 1e6:8.0f} us "
            f"(spread {spread['rel_spread']:.1%})")
    return phases


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return (out.stdout or out.stderr).strip()


def main() -> int:
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count(), "card": card()}
    log(f"device: {device}")
    if dev.platform != "gpu":
        log(f"bench: needs an NVIDIA GPU; JAX found {dev.platform}")
        return 2
    from psgd_tf_tpu.utils import compile_cache

    compile_cache.enable()
    results = {}
    failed = []

    # (row name, family, n, chain iters, state dtype)
    rows = [
        ("diag", "diag", 1 << 22, 100, jnp.float32),
        ("xmat", "xmat", 1 << 22, 100, jnp.float32),
        ("shift", "shift", 1 << 22, 100, jnp.float32),
        ("lra", "lra", 1 << 20, 100, jnp.float32),
        ("lra_bf16", "lra", 1 << 20, 100, jnp.bfloat16),
        ("splu", "splu", 1 << 16, 100, jnp.float32),
        ("splu_big", "splu_big", 1 << 20, 100, jnp.float32),
        ("dense", "dense", 1 << 12, 100, jnp.float32),
        ("dense_8k", "dense", 1 << 13, 20, jnp.float32),
        ("dense_16k", "dense", 1 << 14, 8, jnp.float32),
    ]
    for rowname, famname, n, iters, dtype in rows:
        try:
            nps, spread = bench_family_nnz_per_sec(
                famname, n, iters=iters, dtype=dtype)
            results[f"{rowname}_nnz_per_sec"] = nps
            results[f"{rowname}_slopes_us"] = spread["slopes_us"]
            results[f"{rowname}_rel_spread"] = spread["rel_spread"]
            log(f"{rowname:8s} n={n:>8d}  {nps/1e9:8.3f} Gnnz/s"
                f" (spread {spread['rel_spread']:.1%})")
        except Exception as exc:  # noqa: BLE001 — report, continue, fail
            log(f"{rowname} bench failed: {exc}")
            failed.append(rowname)

    # sparse-format kron pairs at reference-envelope probe shapes
    # (README.md:54): (fmt, shape, byte-model passes or None, iters).
    # kron_ns_wide keeps m modest because the m x n probe itself is the
    # memory limiter (a (1e4, 1e6) probe would be 40 GB).
    kron_shapes = {
        "kron_nd": (("norm", "dense"), (131072, 512), None, 10),
        "kron_ns": (("norm", "scale"), (65536, 8192), None, 10),
        "kron_ns_wide": (("norm", "scale"), (512, 1_000_000), 5, 6),
        "kron_ds": (("dense", "scale"), (512, 131072), None, 10),
    }
    for name, (fmt, shape, passes, iters) in kron_shapes.items():
        try:
            gps, gbs, spread = bench_kron_sparse_gelem_per_sec(
                fmt, shape, passes=passes, iters=iters
            )
            results[f"{name}_gelem_per_sec"] = gps / 1e9
            results[f"{name}_model_gb_per_sec"] = gbs
            results[f"{name}_slopes_us"] = spread["slopes_us"]
            results[f"{name}_rel_spread"] = spread["rel_spread"]
            log(f"{name} {fmt} {shape}  {gps/1e9:8.3f} Gelem/s"
                f" (spread {spread['rel_spread']:.1%})")
        except Exception as exc:  # noqa: BLE001
            log(f"{name} bench failed: {exc}")
            failed.append(name)

    try:
        nmt_us, nmt_spread = bench_nmt_step_us()
        results["nmt_fd_step_us"] = nmt_us
        results["nmt_fd_slopes_us"] = nmt_spread["slopes_us"]
        results["nmt_fd_rel_spread"] = nmt_spread["rel_spread"]
        log(f"nmt mixed-kron FD step (toy dims, vocab 32/embed 64/"
            f"units 128): {nmt_us:.0f} us/step "
            f"(spread {nmt_spread['rel_spread']:.1%})")
    except Exception as exc:  # noqa: BLE001
        log(f"nmt bench failed: {exc}")
        failed.append("nmt_fd")

    # the flagship at the REFERENCE's real dimensions (embed 256, units
    # 1024, vocab 9414/4935, batch 64) with cumulative phases
    try:
        phases = bench_nmt_ref_dims()
        for pname, ph in phases.items():
            results[f"nmt_ref_{pname}_us"] = ph["us"]
            results[f"nmt_ref_{pname}_rel_spread"] = ph["spread"]["rel_spread"]
        log(f"nmt_ref_dims full FD step: {phases['full']['us']:.0f} us "
            f"(grad {phases['grad']['us']:.0f} / +hvp "
            f"{phases['hvp']['us']:.0f} / +qupd {phases['qupd']['us']:.0f})")
    except Exception as exc:  # noqa: BLE001
        log(f"nmt_ref_dims bench failed: {exc}")
        failed.append("nmt_ref")

    sps = bench_lenet5_steps_per_sec()
    results["lenet5_steps_per_sec"] = sps
    log(f"lenet5 kron(dense,dense) batch=64: {sps:.2f} steps/s")

    print(
        json.dumps(
            {
                "metric": "lenet5_kron_steps_per_sec",
                "value": round(sps, 3),
                "unit": "steps/s",
                "device": device,
                "failed": failed,
                "detail": {
                    k: round(val, 3) if isinstance(val, (int, float))
                    else val
                    for k, val in results.items()
                },
            }
        )
    )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
