"""Pytest hook for the multi-process (multi-controller) dryrun.

The dryrun itself (tools/multiproc_dryrun.py) spawns 2 worker processes
x 4 CPU devices over Gloo and validates sharded trajectories + the orbax
per-host-shard checkpoint roundtrip — see its docstring. It takes ~2-3 minutes of wall clock and cannot
run INSIDE this pytest process (the workers need their own JAX runtimes
wired by `jax.distributed.initialize`, and this process has already
initialized a backend), so the test shells out.

Gated by `PSGD_TF_TPU_MP_TEST=1` to keep the default suite within its
time budget:

    PSGD_TF_TPU_MP_TEST=1 python -m pytest tests/test_multiproc_dryrun.py -v
"""
import os
import subprocess
import sys

import pytest

TOOL = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                    "multiproc_dryrun.py")


@pytest.mark.skipif(
    os.environ.get("PSGD_TF_TPU_MP_TEST") != "1",
    reason="multi-process dryrun is ~3 min; set PSGD_TF_TPU_MP_TEST=1 "
    "(or run `python tools/multiproc_dryrun.py` directly)",
)
def test_multiproc_dryrun_passes():
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, TOOL], env=env, capture_output=True, text=True,
        timeout=900,  # ~7 min with the NMT flagship leg (r5)
    )
    sys.stdout.write(proc.stdout[-2000:])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
