"""Multi-PROCESS (multi-controller) dryrun: the pod-slice execution model
on one machine.

Every other distributed artifact in this repo (tests, dryrun, SCALING)
runs ONE process with 8 virtual devices — single-controller GSPMD. The
north star is multi-host pod-slice scaling (BASELINE.md), whose execution
model is different in kind: one JAX controller per host, a mesh spanning
processes, per-process data feeding, and cross-process collectives. This
tool exercises exactly that, locally: it spawns TWO worker processes x 4
CPU devices each, wires them with `jax.distributed.initialize` (Gloo
collectives), and validates 10-step sharded PSGD trajectories against an
in-process single-device replay with the same probes/coins, under BOTH
mesh/process alignments:

  * dp-cross (default device order): the `data` axis spans processes —
    gradient/Hvp psums ride the inter-process link, preconditioner shard
    collectives stay intra-process (the realistic pod layout: DP over
    DCN, state sharding over ICI). The batch is fed per-process: each
    worker materializes only ITS half of the global batch
    (`jax.make_array_from_process_local_data`).
  * shard-cross (interleaved device order): the `shard` axis spans
    processes — the psum'd rank-space Grams, pmax'd step normalizers,
    and TP param gathers all cross the process boundary, and kron-tp's
    parameter shards physically live on different processes.

Families: lra + splu + tensor-parallel kron in dp-cross; lra + kron-tp in
shard-cross. What this proves that nothing else in the repo does (VERDICT
r3 ask #1): `parallel.build_sharded_step` compiles and runs under
multi-controller SPMD (docs/design.md:119's so-far-untested claim), with
host-local -> global promotion for params/state and trajectory parity
with the single-process math.

Run:  python tools/multiproc_dryrun.py           (launcher; ~3 min)
      python tools/multiproc_dryrun.py --worker N    (internal)

Reference: the reference is single-device TF (SURVEY.md §2.4); this axis
exists because BASELINE.md demands it.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the launcher binds port 0 and passes the OS-chosen port down via env,
# so concurrent invocations (or a TIME_WAIT socket from a crashed run)
# can't collide on a hard-coded coordinator address
COORD_ENV = "PSGD_MP_COORD"
NPROC = 2
LOCAL_DEVICES = 4
STEPS = 10


# --------------------------------------------------------------- worker

def worker(process_id: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", LOCAL_DEVICES)
    jax.distributed.initialize(
        coordinator_address=os.environ[COORD_ENV], num_processes=NPROC,
        process_id=process_id,
    )
    assert jax.device_count() == NPROC * LOCAL_DEVICES
    assert jax.local_device_count() == LOCAL_DEVICES

    import numpy as np
    import jax.numpy as jnp
    from functools import partial
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from psgd_tf_tpu import PSGD
    from psgd_tf_tpu.parallel import build_sharded_step, make_mesh, policies

    # ---- model 1: the 6-layer MLP of the single-process dryrun --------
    key = jax.random.PRNGKey(0)
    widths = [(24, 24)] * 6
    mlp = [
        0.5 * jax.random.normal(jax.random.fold_in(key, i), s)
        for i, s in enumerate(widths)
    ]
    batch_global = 2 * NPROC * LOCAL_DEVICES  # 16 rows, 4-way data axis
    x_full = jax.random.normal(jax.random.fold_in(key, 99), (batch_global, 24))

    def mlp_loss(ws, x):
        y = x
        for w in ws:
            y = jnp.tanh(y @ w)
        return jnp.mean(jnp.sum(y * y, axis=-1))

    # ---- model 2: the NMT flagship at toy dims (VERDICT r4 ask #3:
    # BASELINE config 5 is "NMT sharded over a multi-host mesh" — the
    # cross-process dryrun must run the flagship, not just the MLP).
    # Mixed per-layer kron formats, per-process (src, tgt) feeding, and
    # the checkpoint+resume leg below runs on the NMT train state.
    from psgd_tf_tpu.data import translation
    from psgd_tf_tpu.models import nmt

    nmt_cfg = nmt.Config()
    nmt_params = nmt.init(jax.random.fold_in(key, 7), nmt_cfg)
    src_full, tgt_full = translation.batch(
        jax.random.fold_in(key, 8), batch_global, 8,
        nmt_cfg.vocab_src - translation.SPECIALS,
    )

    devs = jax.devices()  # ordered by process: [p0 x4, p1 x4]

    def interleaved(ds):
        """(4, 2) mesh order in which BOTH axes mix the two processes:
        rows (a0,b0),(b1,a1),(a2,b2),(b3,a3) -> every data column and
        every shard row contains devices of both processes."""
        a, b = ds[:LOCAL_DEVICES], ds[LOCAL_DEVICES:]
        order = [a[0], b[0], b[1], a[1], a[2], b[2], b[3], a[3]]
        return order

    meshes = {
        "dp-cross": make_mesh(data=4, shard=2, devices=devs),
        "shard-cross": make_mesh(data=4, shard=2, devices=interleaved(devs)),
    }

    def globalize(tree, shardings):
        """Promote host-local (full-value) arrays to global arrays under
        ANY sharding/ordering: every process holds the full value, the
        callback materializes exactly its addressable shards."""
        def one(x, sh):
            x = np.asarray(x)
            return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])
        return jax.tree_util.tree_map(one, tree, shardings)

    # name -> (opt, param_specs, mesh_names, params, loss_fn, data, ckpt)
    # `data` is a tuple of per-step batch arrays (fed per-process over the
    # data axis under dp-cross); `ckpt` marks the orbax save/restore/resume
    # leg (runs under dp-cross).
    configs = {
        "lra": (PSGD(preconditioner="lra", rank=4, lr_params=0.05,
                     grad_clip_max_norm=1.0), None,
                ("dp-cross", "shard-cross"), mlp, mlp_loss, (x_full,), True),
        "splu": (PSGD(preconditioner="splu", rank=4, lr_params=0.05,
                      grad_clip_max_norm=1.0), None, ("dp-cross",),
                 mlp, mlp_loss, (x_full,), False),
        "kron-tp": (
            PSGD(preconditioner="kron",
                 kron_formats=[("dense", "dense")] * len(mlp),
                 kron_batched=False, lr_params=0.05, grad_clip_max_norm=1.0),
            [P(None, "shard") if i % 2 == 0 else P("shard", None)
             for i in range(len(mlp))],
            ("dp-cross", "shard-cross"), mlp, mlp_loss, (x_full,), False,
        ),
        # the FLAGSHIP: mixed per-layer kron formats exactly as the
        # reference assigns them (models/nmt.kron_formats), trained on
        # per-process (src, tgt) halves of a real batch pipeline
        "nmt": (
            PSGD(preconditioner="kron",
                 kron_formats=nmt.kron_formats(nmt_cfg),
                 lr_params=0.05, grad_clip_max_norm=1.0,
                 exact_hessian_vector_product=False),
            None, ("dp-cross", "shard-cross"), nmt_params, nmt.loss,
            (src_full, tgt_full), True,
        ),
    }

    failures = []
    for name, (opt, param_specs, mesh_names, params0, loss_fn, data,
               do_ckpt) in configs.items():
        for mesh_name in mesh_names:
            mesh = meshes[mesh_name]
            rep = NamedSharding(mesh, P())
            # NOT hash(name): Python string hashing is per-process
            # randomized, and a process-dependent key would feed the two
            # controllers of one SPMD computation DIFFERENT probes (found
            # r4: it inflated the replay deviation ~3x and made the two
            # processes print different losses)
            import zlib

            k_fam = jax.random.fold_in(key, zlib.crc32(name.encode()))
            k_opt, k_run = jax.random.split(k_fam)
            state = opt.init(params0, k_opt)

            if param_specs is None:
                param_sh = [rep] * len(params0)
            else:
                param_sh = [NamedSharding(mesh, sp) for sp in param_specs]
            state_sh = policies.state_sharding(mesh, state)

            sharded = build_sharded_step(
                opt, loss_fn, mesh, state, params0, donate=False,
                param_specs=param_specs,
            )
            single = jax.jit(partial(opt.step, loss_fn))

            if mesh_name == "dp-cross":
                # true per-process feeding: this worker materializes only
                # ITS half of each batch array (data rows {0,1} / {2,3})
                rows = batch_global // NPROC
                lo, hi = process_id * rows, (process_id + 1) * rows
                data_g = tuple(
                    jax.make_array_from_process_local_data(
                        NamedSharding(mesh, P("data")),
                        np.asarray(arr[lo:hi]), arr.shape,
                    )
                    for arr in data
                )
            else:
                data_g = tuple(
                    globalize(arr, NamedSharding(mesh, P("data")))
                    for arr in data
                )

            p_s = globalize(params0, param_sh)
            s_s = globalize(state, state_sh)
            p_1, s_1 = params0, state
            k = k_run
            losses_s = []
            for _ in range(STEPS):
                k, sub = jax.random.split(k)
                p_s, s_s, aux_s = sharded(
                    p_s, s_s, globalize(sub, rep), *data_g)
                p_1, s_1, aux_1 = single(p_1, s_1, sub, *data)
                losses_s.append(float(aux_s["loss"]))

            ok = all(np.isfinite(losses_s)) and losses_s[-1] < losses_s[0]
            # full-trajectory parameter agreement; TP shards live on BOTH
            # processes under shard-cross, so allgather before comparing
            worst = 0.0
            for a, b in zip(p_s, p_1):
                a_np = np.asarray(
                    multihost_utils.process_allgather(a, tiled=True)
                )
                scale = float(jnp.max(jnp.abs(b))) + 1e-6
                worst = max(
                    worst, float(np.max(np.abs(a_np - np.asarray(b)))) / scale
                )
            ok = ok and worst < 2e-2
            line = (f"[mp-dryrun p{process_id}] {name} @ {mesh_name}: "
                    f"{losses_s[0]:.4f}->{losses_s[-1]:.4f} "
                    f"(rel dev {worst:.1e})" + ("" if ok else "  FAIL"))
            print(line, flush=True)
            if not ok:
                failures.append(f"{name}@{mesh_name}")

            if do_ckpt and mesh_name == "dp-cross":
                # orbax per-host shards (docs/design.md failure/recovery
                # story): every process participates in the save of the
                # SHARDED train state — including the NMT train state
                # with its mixed-format kron factors — then restores into
                # the same sharding policy and resumes one more step
                from psgd_tf_tpu.utils import checkpoint as ckpt

                ckdir = os.path.join(os.environ["PSGD_MP_CKPT_DIR"], name)
                ckpt.save(ckdir, 1, {"params": p_s, "opt": s_s})
                multihost_utils.sync_global_devices("ckpt_saved")
                restored = ckpt.restore(ckdir, 1,
                                        like={"params": p_s, "opt": s_s})
                r_leaves = jax.tree_util.tree_leaves(restored["params"])
                for a, b in zip(r_leaves, p_s, strict=True):
                    assert a.sharding == b.sharding
                    # bitwise roundtrip on every addressable shard. (An
                    # earlier revision tolerated "replica drift across
                    # ranks" — that drift was a bug in THIS tool: string
                    # hash() is per-process randomized, so the two
                    # controllers derived different PRNG keys and fed one
                    # SPMD computation different probes. With consistent
                    # inputs the replicas are bitwise identical across
                    # devices and processes — verified by a standalone
                    # 2-process probe — and the checkpoint must be too.)
                    for sa, sb in zip(a.addressable_shards,
                                      b.addressable_shards):
                        np.testing.assert_array_equal(
                            np.asarray(sa.data), np.asarray(sb.data))
                k, sub = jax.random.split(k)
                _, _, aux_r = sharded(
                    restored["params"], restored["opt"], globalize(sub, rep),
                    *data_g,
                )
                assert np.isfinite(float(aux_r["loss"]))
                print(f"[mp-dryrun p{process_id}] orbax per-host-shard "
                      f"checkpoint roundtrip + resume OK ({name})",
                      flush=True)

    multihost_utils.sync_global_devices("mp_dryrun_done")
    if failures:
        print(f"[mp-dryrun p{process_id}] FAILURES: {failures}", flush=True)
        sys.exit(1)
    print(f"[mp-dryrun p{process_id}] OK", flush=True)


# -------------------------------------------------------------- launcher

def main() -> None:
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
        return

    import socket
    import tempfile

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # each worker pins the CPU backend itself
    env["PSGD_MP_CKPT_DIR"] = tempfile.mkdtemp(prefix="psgd_mp_ckpt_")

    # The OS-assigned free port is probed by bind-then-close, so there is
    # an unavoidable TOCTOU window before worker 0's gRPC coordinator
    # rebinds it (holding it open doesn't help: the coordinator's bind
    # would then collide with OURS). Instead, recognize the bind-failure
    # signature in the worker logs and retry the whole launch on a fresh
    # port (ADVICE r4) — a lost race is loud and self-healing rather than
    # a flaky failure.
    for attempt in range(3):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            env[COORD_ENV] = f"localhost:{s.getsockname()[1]}"
        logs = [
            tempfile.NamedTemporaryFile(
                mode="w+", prefix=f"psgd_mp_w{i}_", suffix=".log", delete=False
            )
            for i in range(NPROC)
        ]
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", str(i)],
                env=env, stdout=log, stderr=subprocess.STDOUT,
            )
            for i, log in enumerate(logs)
        ]
        rcs = [p.wait() for p in procs]
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
            os.unlink(log.name)  # contents echoed below; don't leak /tmp files
        for i, text in enumerate(texts):
            sys.stdout.write(text if text.endswith("\n") or not text
                             else text + "\n")
        ok = all(rc == 0 for rc in rcs)
        port_lost = not ok and any(
            "address already in use" in t.lower() for t in texts
        )
        if ok or not port_lost:
            break
        print(f"multiproc_dryrun: coordinator port race lost "
              f"(attempt {attempt + 1}); retrying on a fresh port", flush=True)
    print(f"multiproc_dryrun: {NPROC} processes x {LOCAL_DEVICES} devices "
          f"-> {'OK' if ok else f'FAIL (rcs={rcs})'}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
