#!/usr/bin/env python3
"""The host's regroup-plan builders: numpy against the native C++ ones
(scripts/bench_native.py's protocol, the port's builders).  Host-only:
no card is used, and the record names the host CPU.

    python3 scripts/torch_bench_native.py [--reps 200]
        [--out results/TORCH_NATIVE_runtime.json]

The plan a training batch needs (B = 16, 96 phonemes an utterance,
Poisson(8) durations clipped to 1..50; flat, and classed with classes 8,
16, 32, 50), built by ``ops/regroup.py`` (numpy) and by
``data/native.py`` (``csrc/fclrt.cpp``, built with the host's C++
compiler) over 16 distinct batches; the four builders timed in turns, one
call a reading, host clock.
"""

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

B, TMAX, MEAN_DUR, MAX_DUR = 16, 96, 8, 50
CLASSES = (8, 16, 32, 50)
N_BATCHES = 16


def batch(seed):
    """One batch's (durations, olens, Lmax)."""
    rng = np.random.default_rng(seed)
    durations = np.clip(rng.poisson(MEAN_DUR, (B, TMAX)), 1,
                        MAX_DUR).astype(np.int32)
    olens = durations.sum(1).astype(np.int32)
    Lmax = int(np.ceil(olens.max() / 64) * 64)
    return durations, olens, Lmax


def batches():
    """The 16 batches and the class caps fitted to all of them."""
    from fcl_taco2_tpu_torch.ops.regroup import duration_class_caps
    bs = [batch(s) for s in range(N_BATCHES)]
    caps = duration_class_caps([b[0][i] for b in bs for i in range(B)],
                               CLASSES, B, cap_bucket=64)
    return bs, caps


def host():
    """The host CPU's model name and core count."""
    name = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"cpu": name, "cores": os.cpu_count(),
            "machine": platform.machine()}


def plan_rows(reps):
    """ms of each builder, the four timed in turns, and the speedups."""
    from fcl_taco2_tpu_torch.data import native
    from fcl_taco2_tpu_torch.ops.regroup import build_classed_plan, build_plan
    native.build()
    bs, caps = batches()
    builders = {
        "flat_numpy": lambda d, o, L: build_plan(d, o, MAX_DUR, B * TMAX, L),
        "flat_native": lambda d, o, L: native.build_plan_native(
            d, o, MAX_DUR, B * TMAX, L),
        "classed_numpy": lambda d, o, L: build_classed_plan(
            d, o, CLASSES, caps, L),
        "classed_native": lambda d, o, L: native.build_classed_plan_native(
            d, o, CLASSES, caps, L),
    }
    per = {k: [] for k in builders}
    for fn in builders.values():
        fn(*bs[0])  # warm (native: loads the library)
    for r in range(reps):
        for name, fn in builders.items():
            t0 = time.perf_counter()
            fn(*bs[r % len(bs)])
            per[name].append(1e3 * (time.perf_counter() - t0))
    from fcl_taco2_tpu_torch.utils.timing import spread
    rows = {f"{k}_ms": spread(v) for k, v in per.items()}
    for kind in ("flat", "classed"):
        rows[f"{kind}_native_speedup"] = (
            rows[f"{kind}_numpy_ms"]["median"]
            / rows[f"{kind}_native_ms"]["median"])
    return rows, caps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--out", default=os.path.join(
        REPO, "results", "TORCH_NATIVE_runtime.json"))
    args = p.parse_args(argv)
    rows, caps = plan_rows(args.reps)
    out = {"host": host(), "seed": list(range(N_BATCHES)),
           "protocol": {
               "what": "host regroup-plan build a training batch: the four "
                       f"builders in turns, {args.reps} readings of one "
                       f"call each over {N_BATCHES} distinct batches, host "
                       "clock; no card involved",
               "shapes": {"B": B, "Tmax": TMAX, "mean_dur": MEAN_DUR,
                          "max_dur": MAX_DUR, "classes": list(CLASSES),
                          "class_caps": [int(c) for c in caps]}},
           "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
