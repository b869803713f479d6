"""The benchmark's harness, driven by ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The harness finds by name:

- ``benchmark/configs/<config>.json``: the model's sizes and precision;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, read by the
  one corpus generator (``benchmark/corpus.py``); its ``entry`` names the
  driver, ``benchmark/drivers/<entry>.py``, the closed loop around one
  entry point of the program;
- ``benchmark/metrics/<metric>.py``: one reader a metric, ``read(run)``
  -> a number or None (nothing to read: the metric is left out);
- ``benchmark/limits/<cell>.json``: the limit of each number the output
  check compares (the numbers a driver's check gives that have no limit
  there are not compared).

A run: set-up (the program, its weights from the seed, every shape the
cell's traffic uses warmed), ``--seconds`` of traffic, with ``--trace 1``
a short traced sub-window after it, the peak memory read, the program
freed, then the output check against the plain reference.  The result is
one JSON line on standard output, the compared numbers and their limits
the last lines on standard error.
"""

import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "fcl_taco2_tpu")


class Run:
    """What a run measured, for the metric readers.

    ``calls``: one dict a call completed in the window (``utts``: (phonemes,
    frames) of each utterance; a driver may add more); ``latencies``: the
    host clock's seconds of each; ``window_s``: the window's seconds, from
    the first call to the end of the last; ``traced``: None, or the traced
    sub-window's ``dev`` events, ``window_s``, ``calls`` and ``idle_gaps``.
    """

    def __init__(self, config, mix):
        self.config, self.mix = config, mix
        self.calls, self.latencies = [], []
        self.window_s = 0.0
        self.attempted = self.failed = 0
        self.traced = None


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(root):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(spec, name):
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")


def config_of(spec, cell):
    for c in spec["configs"]:
        if c["name"] == cell["config"]:
            return c
    raise SystemExit(f"benchmark: no config {cell['config']!r}")


def cell_metrics(spec, cell, trace):
    """The metrics the cell reports: its end-to-end ones (those that list
    it or list no cells), or with ``trace`` the per-layer ones that list
    it (every per-layer metric lists its cells)."""
    name = cell["name"]
    if trace:
        return [m for m in spec["per_layer"] if name in m["workloads"]]
    return [m for m in spec["end_to_end"]
            if name in m.get("workloads", [name])]


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(spec, cell_name):
    """(cell, configuration, mix, driver module, limits) by name."""
    cell = find_cell(spec, cell_name)
    entry = config_of(spec, cell)
    config = load_json(os.path.join(os.path.dirname(HERE), entry["file"]))
    mix = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    driver = load_module("drivers", mix["entry"])
    limits = load_json(os.path.join(HERE, "limits", cell_name + ".json"))
    return cell, config, mix, driver, limits


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def checks_ok(checks):
    return all(v <= lim for v, lim in checks.values())


def run_cell(spec, cell_name, seed, seconds, trace, t_start,
             device="cuda", config_override=None, mix_override=None):
    """Run one cell once; prints the result line and returns the exit
    code.  ``config_override`` and ``mix_override`` (tests on the CPU)
    replace groups of the configuration and of the mix."""
    import torch
    # fp32 work in fp32, as every configuration states (cuDNN would
    # otherwise take TF32 for fp32 convolutions)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell, config, mix, driver, limits = resolve(spec, cell_name)
    config = {**config, **(config_override or {})}
    mix = {**mix, **(mix_override or {})}
    on_card = device == "cuda"
    drv = driver.Driver(config, mix, seed, device)
    drv.build()
    drv.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    g = drv.graphs()
    if g is not None:
        print(f"benchmark: set-up captured {len(g.entries)} CUDA graph(s) "
              f"in {g.capture_s:.2f} s (pool {g.pool_bytes / 2 ** 20:.0f} "
              "MiB)", file=sys.stderr)

    run = Run(config, mix)
    drv.window(run, seconds)
    if on_card:
        from benchmark.trace import clocks
        window_clocks = clocks()  # the card's state as the window ends
    if trace:
        drv.trace(run)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    drv.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.check()
    checks = {k: (float(v), float(limits[k]))
              for k, v in numbers.items() if k in limits}
    print(f"benchmark: the output check took "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    missing = [k for k in limits if k != "control" and k not in numbers]
    if missing:
        print(f"benchmark: the check gave no {missing}", file=sys.stderr)
    correct = (run.failed == 0 and run.attempted > 0 and not missing
               and checks_ok(checks))

    device_info = {"platform": "gpu" if on_card else "cpu", "count": 1,
                   "memory_peak_bytes": int(peak)}
    if on_card:
        from benchmark.trace import card
        device_info["kind"], device_info["card"] = card()
        device_info["clocks"] = window_clocks
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info}
    if trace and run.traced is not None:
        from benchmark.trace import busy_s, top_device_ops
        tr = run.traced
        device_info["busy_s"] = busy_s(tr["dev"])
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": top_device_ops(tr["dev"]),
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    # after the window and the output check alike: whatever this process
    # loaded, the program or the check
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
