"""The span marks (``utils/spans.py``, ``csrc/spans.cu``) held to the card's
own clocks, on one NVIDIA GPU.

    python3 scripts/torch_span_check.py [--sleep-cycles N] [--replays R]

Prints one JSON line:

- ``resolution``: one graph of 256 back-to-back spans, each holding one
  interval between two marks; the intervals' smallest non-zero value,
  their greatest common divisor and their median, ns (the step of
  ``%globaltimer`` and a mark's cost);
- ``sleep``: one graph of a span around ``torch.cuda._sleep``, replayed
  ``R`` times under ``torch.profiler``: the span's ns a replay against
  the traced sleep kernel's mean ns and the traced replay's whole
  length;
- ``mark_cost``: a graph of 1,000 empty spans against an empty graph
  (one kernel), CUDA events over 50 replays each, µs a mark.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from fcl_taco2_tpu_torch.utils import spans  # noqa: E402


def capture(fn, dev):
    """(graph, its spans.Capture): ``fn(capture)`` captured between an
    opening and a closing mark, as ``Graphed`` captures."""
    cap = spans.start_capture(dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            cap.begin()
            fn(cap)
            cap.end()
    finally:
        spans.stop_capture()
    torch.cuda.synchronize()
    return graph, cap


def region_ns(cap, dev):
    values = spans.read(dev)
    return {name: values[slot] for name, slot in cap.regions.items()}


def resolution(dev, n=256):
    def body(cap):
        for i in range(n):
            cap.enter(f"d{i}")
            cap.exit()
    graph, cap = capture(body, dev)
    graph.replay()
    torch.cuda.synchronize()
    got = region_ns(cap, dev)
    deltas = [got[f"d{i}"] for i in range(n)]
    nonzero = [d for d in deltas if d > 0]
    return {"min_nonzero_ns": min(nonzero) if nonzero else None,
            "gcd_ns": math.gcd(*deltas), "median_ns":
            statistics.median(deltas), "zeros": len(deltas) - len(nonzero)}


def sleep_check(dev, cycles, replays):
    from torch.profiler import ProfilerActivity, profile
    graph, cap = capture(
        lambda c: (c.enter("sleep"), torch.cuda._sleep(cycles), c.exit()),
        dev)
    before = region_ns(cap, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    after = region_ns(cap, dev)
    kernels = [(e.name(), e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()]
    sleeps = [b - a for n, a, b in kernels if "spin" in n or "sleep" in n]
    span_ns = (after["sleep"] - before["sleep"]) / replays
    traced = sum(sleeps) / len(sleeps) if sleeps else None
    whole = ((after["sleep"] + after[spans.OTHER])
             - (before["sleep"] + before[spans.OTHER])) / replays
    return {"span_ns": span_ns, "traced_kernel_ns": traced,
            "span_over_traced": span_ns / traced if traced else None,
            "replay_ns": whole, "kernels_seen": len(sleeps),
            "kernel_names": sorted({n for n, _, _ in kernels})[:4]}


def mark_cost(dev, n=1000, replays=50):
    x = torch.zeros(1, device=dev)

    def body(cap):
        for _ in range(n):
            cap.enter("m")
            cap.exit()
        x.add_(1)

    marked, _ = capture(body, dev)
    empty = torch.cuda.CUDAGraph()
    with torch.cuda.graph(empty):
        x.add_(1)

    def ms(graph):
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / replays

    a, b = ms(marked), ms(empty)
    # a graph of n empty spans holds 2n + 2 marks
    return {"marked_ms": a, "empty_ms": b,
            "us_a_mark": 1e3 * (a - b) / (2 * n + 2)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sleep-cycles", type=int, default=2_000_000)
    ap.add_argument("--replays", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_span_check.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": smi, "resolution": resolution(dev),
           "sleep": sleep_check(dev, args.sleep_cycles, args.replays),
           "mark_cost": mark_cost(dev)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
