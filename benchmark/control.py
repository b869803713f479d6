"""The output check's two readings for one cell, on the card at the cell's
own size: the program's numbers on many seeds (the lower reading) and the
control's (the upper reading), in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control-seeds 3]

For each seed the cell's program runs a short window as a run does, then
its sampled answers are compared with the reference.  The control is
named in the cell's limits file: ``{"control": {"program_options":
{...}}}`` runs the program again with that option (its own path one
precision below the stated one, such as int8 codes); otherwise the control
is the reference itself computed one precision below
(``reference/precision.py``), on the same sampled calls.  Each fault of
the driver's ``fault_answers`` is planted too: in the sampled answers
(serving) or in the reference put in the program's place (training).  One JSON line a reading, then a summary line of
each number's largest program reading and smallest reading of the
control and of each fault.
"""

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _measure(driver, config, mix, seed, seconds, device, options=None):
    from benchmark.harness import Run
    drv = driver.Driver(config, mix, seed, device, options=options)
    drv.build()
    drv.warm()
    run = Run(config, mix)
    drv.window(run, seconds)
    drv.free()
    gc.collect()
    return drv, run


def readings(spec, cell, seeds, seconds, control_seeds, device="cuda",
             config_override=None, mix_override=None, emit=print):
    """{"program": [numbers a seed], "control": [numbers a seed]}, and
    for a driver that plants faults in the reference (training), each
    fault's numbers a seed under its name."""
    import torch
    from benchmark import harness
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, config, mix, driver, limits = harness.resolve(spec, cell)
    config = {**config, **(config_override or {})}
    mix = {**mix, **(mix_override or {})}
    options = limits.get("control", {}).get("program_options")
    out = {"program": [], "control": []}
    for k, seed in enumerate(seeds):
        drv, run = _measure(driver, config, mix, seed, seconds, device)
        nums = drv.check()
        out["program"].append(nums)
        emit(json.dumps({"seed": seed, "side": "program",
                         "calls": run.attempted, "failed": run.failed,
                         **nums, **getattr(drv, "look", {})}))
        if k >= control_seeds:
            continue
        if options:
            ctrl, _ = _measure(driver, config, mix, seed, seconds, device,
                               options)
            nums = ctrl.check()
        else:
            nums = drv.check(drv.control_answers())
        out["control"].append(nums)
        emit(json.dumps({"seed": seed, "side": "control", **nums}))
        for name, answers in getattr(drv, "fault_answers",
                                     lambda: {})().items():
            nums = drv.check(answers)
            out.setdefault(name, []).append(nums)
            emit(json.dumps({"seed": seed, "side": name, **nums}))
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args()
    from benchmark import harness
    spec = harness.load_spec(ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    r = readings(spec, args.workload, seeds, args.seconds,
                 args.control_seeds)
    keys = r["program"][0].keys()
    print(json.dumps({
        "workload": args.workload, "seconds": time.perf_counter() - t0,
        "lower": {k: max(n[k] for n in r["program"]) for k in keys},
        "upper": {side: {k: min(n[k] for n in r[side]) for k in keys}
                  for side in r if side != "program" and r[side]}}))


if __name__ == "__main__":
    main()
