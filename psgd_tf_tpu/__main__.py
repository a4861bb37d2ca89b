"""CLI: run any workload with config files and overrides.

    python -m psgd_tf_tpu list
    python -m psgd_tf_tpu run mnist_lenet5 --set epochs=3 --set lr=0.05
    python -m psgd_tf_tpu run nmt_attention --config my.json
    python -m psgd_tf_tpu bench
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

from psgd_tf_tpu import config as config_mod
from psgd_tf_tpu.utils import compile_cache

WORKLOADS = [
    "hello_psgd",
    "all_preconditioners",
    "mnist_lenet5",
    "lstm_xor",
    "rnn_xor_lra",
    "nmt_attention",
]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="psgd_tf_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list workloads and their config schemas")

    runp = sub.add_parser("run", help="run a workload")
    runp.add_argument("workload", choices=WORKLOADS)
    runp.add_argument("--config", help="JSON config file")
    runp.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override one config key (repeatable)",
    )

    sub.add_parser("bench", help="run the benchmark harness")

    args = parser.parse_args(argv)

    if args.cmd == "list":
        for name in WORKLOADS:
            mod = importlib.import_module(f"psgd_tf_tpu.workloads.{name}")
            print(f"{name}: {json.dumps(config_mod.schema(mod.run), default=str)}")
        return 0

    compile_cache.enable()
    if args.cmd == "bench":
        import bench  # repo-root harness

        return bench.main()

    mod = importlib.import_module(f"psgd_tf_tpu.workloads.{args.workload}")
    kwargs = config_mod.load(mod.run, args.config, args.set)
    result = mod.run(**kwargs)
    print(json.dumps(result, default=str))
    return 0 if result.get("success", True) else 1


if __name__ == "__main__":
    sys.exit(main())
