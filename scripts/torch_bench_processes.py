#!/usr/bin/env python3
"""A bench script run in several processes, with the spread of its
timings across them beside the spread within one.

    python3 scripts/torch_bench_processes.py --out results/TORCH_BENCH.json \
        -- scripts/torch_bench.py --train-scaling

Runs the script (with its own flags, after ``--``) ``N_PROCESSES`` times
one after the other, each process writing its own results file (its
``--out`` in a temporary directory), then writes the first process's
results into ``--out``, keeping that file's other keys, with
``across_processes`` beside every timing spread: each process's median,
their min and max, and their range over their median
(``utils/bench_protocol.py::merge_processes``).  A failing process fails
the run.  Needs the card, as the script does.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fcl_taco2_tpu_torch.utils import timing  # noqa: E402
from fcl_taco2_tpu_torch.utils.bench_protocol import (  # noqa: E402
    merge_processes, write)

N_PROCESSES = 2


def run_processes(script, script_args, n=N_PROCESSES):
    """The results payloads of ``n`` runs of ``script``, one process
    each."""
    payloads = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(n):
            out = os.path.join(tmp, f"process{i}.json")
            print(f"[processes] {os.path.basename(script)} process {i + 1} "
                  f"of {n}", flush=True)
            subprocess.run([sys.executable, script, *script_args,
                            "--out", out], check=True)
            with open(out) as f:
                payloads.append(json.load(f))
    return payloads


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    timing.require_card()
    merged = merge_processes(run_processes(args.script, args.script_args))
    merged["processes"] = N_PROCESSES
    write(args.out, **merged)
    if "metric" in merged:
        print(json.dumps(merged), flush=True)
    print(f"wrote {args.out} ({N_PROCESSES} processes)")


if __name__ == "__main__":
    main()
