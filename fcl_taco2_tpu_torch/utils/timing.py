"""Timers, spreads, device traces and roofline bounds for measuring the
port on an NVIDIA GPU (the port's own module; the JAX package timed
inside ``jax.jit`` loops instead).

Every timer here needs the card: a time taken on the host CPU is never
reported under a device metric's name.  ``card()`` names the card and its
power limit (``nvidia-smi``), which every recorded number carries.

- ``median_ms``: CUDA events around single calls, median.
- ``queued_ms``: the card's time a call over calls queued behind a
  ``torch.cuda._sleep``, so the host's launch time stays out of a short
  kernel's reading.
- ``timed``: one call between two ``torch.cuda.synchronize()``, host
  clock; ``host_median_ms``: the median of several such calls;
  ``enqueue_ms``: the host's time to return from a call, whose work the
  card may still be running.
- ``interleaved_ms``: several variants timed in turns (a/b/c/a/b/c), so
  drift of the card's clocks over the run lands on every variant alike;
  each reading carries the card's clocks read just after it
  (``clocks``: SM and memory MHz, power, temperature and the driver's
  clock-event reasons, from NVML).
- ``spread``: median, min, max and the sample count of a list of times,
  with p90 where at least ten samples lie beyond it, and the range of the
  clocks the readings carry.
- ``device_events`` / ``busy_ms`` / ``top_kernels`` / ``device_busy_ms``:
  a ``torch.profiler`` trace's device intervals, their union and their
  split by kernel label and class (elementwise, GEMM, other);
  ``range_events``: a trace's device intervals split by the
  ``record_function`` range each kernel was launched in.
- ``bound_ms``: the least time of a piece of work on an H100 (bytes over
  the memory rate, operations over the peak of their type).
"""

import ctypes
import functools
import os
import re
import subprocess
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
            torch.int8: 989e12,  # int8 codes are multiplied as bf16
            "tf32": 495e12}      # dense TF32 tensor cores
TF32_PASSES = 3  # fp32 products on tensor cores: 3xTF32 for fp32 accuracy


# NVML's clock-event reasons (nvml.h, nvmlClocksEventReason*)
CLOCK_EVENT_REASONS = {0x1: "gpu_idle", 0x2: "applications_clocks",
                       0x4: "sw_power_cap", 0x8: "hw_slowdown",
                       0x10: "sync_boost", 0x20: "sw_thermal",
                       0x40: "hw_thermal", 0x80: "hw_power_brake",
                       0x100: "display_clocks"}


def require_card():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: this measurement "
                           "runs on an NVIDIA GPU and has no CPU path")


@functools.lru_cache(maxsize=None)
def card():
    """The card this process measures on: ``name``, ``power_limit`` and
    ``smi`` (the line ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints), SM count, memory, torch and CUDA
    versions.  Raises without a card."""
    require_card()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    return {"name": torch.cuda.get_device_name(0),
            "power_limit": smi.rsplit(",", 1)[-1].strip(),
            "smi": smi, "sm_count": props.multi_processor_count,
            "memory_gib": round(props.total_memory / 2 ** 30, 2),
            "torch": torch.__version__, "cuda": torch.version.cuda}


@functools.lru_cache(maxsize=None)
def _nvml():
    """(NVML library, handle of this process's card), or None where the
    driver's NVML library does not load."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if lib.nvmlInit_v2() != 0:
        return None
    index = torch.cuda.current_device()
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    if visible and all(v.isdigit() for v in visible):
        index = int(visible[index])
    handle = ctypes.c_void_p()
    if lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(index),
                                         ctypes.byref(handle)) != 0:
        return None
    return lib, handle


def clocks():
    """The card's state now, from NVML: SM and memory clocks (MHz), power
    draw (W), temperature (C) and the bitmask of the driver's clock-event
    reasons (``CLOCK_EVENT_REASONS``); None without NVML."""
    nv = _nvml()
    if nv is None:
        return None
    lib, h = nv
    u, r = ctypes.c_uint(), ctypes.c_ulonglong()

    def read(name, *args):
        call = getattr(lib, name, None)
        return call is not None and call(h, *args) == 0

    return {
        "sm_mhz": u.value if read("nvmlDeviceGetClockInfo", 1,
                                  ctypes.byref(u)) else None,
        "mem_mhz": u.value if read("nvmlDeviceGetClockInfo", 2,
                                   ctypes.byref(u)) else None,
        "power_w": u.value / 1e3 if read("nvmlDeviceGetPowerUsage",
                                         ctypes.byref(u)) else None,
        "temp_c": u.value if read("nvmlDeviceGetTemperature", 0,
                                  ctypes.byref(u)) else None,
        "reasons": r.value if read(
            "nvmlDeviceGetCurrentClocksThrottleReasons",
            ctypes.byref(r)) else None}


def clock_range(readings):
    """[min, max] of each clock, power and temperature among ``readings``
    (``clocks()`` dicts; None entries skipped) and every clock-event
    reason any of them names; None without readings."""
    readings = [c for c in readings if c]
    if not readings:
        return None
    out = {}
    for key in ("sm_mhz", "mem_mhz", "power_w", "temp_c"):
        v = [c[key] for c in readings if c.get(key) is not None]
        if v:
            out[key] = [min(v), max(v)]
    bits = 0
    for c in readings:
        bits |= c.get("reasons") or 0
    out["reasons"] = [name for bit, name in CLOCK_EVENT_REASONS.items()
                      if bits & bit]
    return out


class Readings(list):
    """Times in ms, one a reading, with the card's ``clocks()`` read just
    after each (``.clocks``)."""

    def __init__(self, values=(), clock_log=()):
        super().__init__(values)
        self.clocks = list(clock_log)

    def add(self, ms):
        """Append one reading and the clocks now."""
        self.append(ms)
        self.clocks.append(clocks())

    def scaled(self, k):
        """Every reading times ``k`` (ms a step from ms a chain), the
        clocks kept."""
        return Readings([m * k for m in self], self.clocks)


def median_ms(fn, reps, warmup=1):
    """Median ms of ``reps`` calls of ``fn``, each between two CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def queued_ms(fn, calls, reps=5, sleep_cycles=50_000_000):
    """Median over ``reps`` readings of the card's ms a call of ``fn``:
    each reading queues ``calls`` calls between two CUDA events behind a
    ``torch.cuda._sleep`` of ``sleep_cycles`` (~25 ms at 1.98 GHz), which
    the host's enqueue has to fit inside, so the calls run back to back.
    One call first, unqueued (builds and warms up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def timed(fn):
    """(fn(), its host-clock ms), the device synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def enqueue_ms(fn, reps=3):
    """``Readings`` of the host ms ``fn()`` takes to return, the card
    synchronized before each call (and after it, outside the reading):
    near the wall time of a call where the host holds the card back, far
    under it where the card's queue runs ahead of the host."""
    out = Readings()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.add(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return out


def host_median_ms(fn, reps=5):
    """Median ms of ``reps`` calls of ``fn``, each ``timed``, after one
    warm-up call."""
    fn()
    return float(np.median([timed(fn)[1] for _ in range(reps)]))


def interleaved_ms(calls, reps, n_iters=1, warmup=1):
    """``calls``: {tag: fn}.  Each fn is called ``warmup`` times first;
    then ``reps`` rounds call every fn in turn (a/b/c/a/b/c), each
    reading ``n_iters`` back-to-back calls between two synchronizations
    of the card, host clock.  Returns {tag: ``Readings``}: ``reps``
    readings of ms a call, each with the clocks just after it."""
    for fn in calls.values():
        for _ in range(warmup):
            fn()
    per = {tag: Readings() for tag in calls}
    for _ in range(reps):
        for tag, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_iters):
                fn()
            torch.cuda.synchronize()
            per[tag].add(1e3 * (time.perf_counter() - t0) / n_iters)
    return per


def spread(samples):
    """Median, min, max and count of ``samples``; ``p90`` too where at
    least ten samples lie beyond it (100 or more samples); ``clocks``
    (``clock_range``) where the samples are ``Readings`` with clocks."""
    a = np.asarray(samples, np.float64)
    out = {"median": float(np.median(a)), "min": float(a.min()),
           "max": float(a.max()), "n": int(a.size)}
    if a.size * 0.1 >= 10:
        out["p90"] = float(np.percentile(a, 90))
    cl = clock_range(getattr(samples, "clocks", ()))
    if cl:
        out["clocks"] = cl
    return out


def _trace(fn, host=True):
    """The raw events of a ``torch.profiler`` trace (host and device, or
    the device's alone) of one ``fn()`` call.  They are read directly:
    building the profiler's event tree for the CPU ops of a few eager
    steps takes tens of seconds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.profiler.kineto_results.events()


def _device(e):
    """A device event that is work (a kernel, a copy), not the device
    span of a ``record_function`` range."""
    from torch.autograd import DeviceType
    return e.device_type() == DeviceType.CUDA and not e.is_user_annotation()


def device_events(fn, host=True):
    """(name, start ns, end ns) of every device event (kernels, copies)
    in a ``torch.profiler`` trace of one ``fn()`` call; ``host=False``
    leaves the host's ops out of the trace (less work on the host while
    ``fn`` runs)."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in _trace(fn, host)
            if _device(e)]


def idle_gaps(events, n=5):
    """The device's idle time between the first event's start and the
    last one's end, in ms, and the ``n`` longest gaps: (ms, the label of
    the event before, of the event after)."""
    gaps, idle, end, before = [], 0, None, None
    for name, a, b in sorted(events, key=lambda e: e[1]):
        if end is not None and a > end:
            idle += a - end
            gaps.append(((a - end) / 1e6, kernel_label(before),
                         kernel_label(name)))
        if end is None or b > end:
            end, before = b, name
    return idle / 1e6, sorted(gaps, reverse=True)[:n]


def split_by_ranges(host, device, names):
    """Device events by the host range they were launched in.  ``host``:
    (name, correlation id, thread, start ns, end ns) of host events, the
    ranges among them; ``device``: (name, start ns, end ns, linked
    correlation id).  A device event is in range R when the host event
    that launched it (its linked correlation id) started inside R on R's
    thread; a range nested in another counts for the inner one.  Returns
    {name in ``names``: [(name, start, end)], None: the rest}."""
    spans = sorted((a, b, t, n) for n, _, t, a, b in host if n in names)
    launch = {c: (t, a) for n, c, t, a, _ in host if n not in names}
    out = {n: [] for n in names}
    out[None] = []
    for name, a, b, corr in device:
        key = None
        if corr in launch:
            t, at = launch[corr]
            inside = [(sa, n) for sa, sb, st, n in spans
                      if st == t and sa <= at <= sb]
            if inside:
                key = max(inside)[1]
        out[key].append((name, a, b))
    return out


def range_events(fn, names):
    """The device events of one ``fn()`` call split by the
    ``record_function`` range of ``names`` that launched them
    (``split_by_ranges``); ``fn`` runs eagerly, as a graph replay has no
    host ops to attribute."""
    from torch.autograd import DeviceType
    events = list(_trace(fn))
    host = [(e.name(), e.correlation_id(), e.start_thread_id(),
             e.start_ns(), e.end_ns()) for e in events
            if e.device_type() == DeviceType.CPU]
    device = [(e.name(), e.start_ns(), e.end_ns(),
               e.linked_correlation_id()) for e in events if _device(e)]
    return split_by_ranges(host, device, set(names))


def busy_ms(events):
    """The union of the events' intervals in ms; None without events."""
    busy, end = 0, None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6 if busy > 0 else None


def kernel_label(name):
    """A short label of a CUDA kernel's name: the kernel and the last op
    named in its template arguments (``elementwise_kernel:MulFunctor``,
    ``vectorized_elementwise_kernel:CUDAFunctor_add``); a name without
    such parts cut to 60 characters."""
    parts = [t for t in re.findall(r"\w*(?:Functor|_kernel|Kernel|gemm)\w*",
                                   name)
             if not t.startswith("gpu_kernel_impl")]
    if not parts:
        return name[:60]
    label = parts[0] if len(parts) == 1 else f"{parts[0]}:{parts[-1]}"
    return label[:60]


def kernel_class(label):
    """elementwise, gemm or other."""
    if "elementwise" in label or "Functor" in label:
        return "elementwise"
    if any(k in label for k in ("gemm", "nvjet", "cutlass", "Kernel2")):
        return "gemm"
    return "other"


def top_kernels(events, n=10):
    """The ``n`` kernel labels with the most device time: (label, ms,
    count), and the device ms and count of each kernel class."""
    by, classes = {}, {}
    for name, a, b in events:
        label = kernel_label(name)
        for table, key in ((by, label), (classes, kernel_class(label))):
            ms, k = table.get(key, (0.0, 0))
            table[key] = (ms + (b - a) / 1e6, k + 1)
    top = [(label, ms, k) for label, (ms, k) in
           sorted(by.items(), key=lambda kv: -kv[1][0])[:n]]
    return top, classes


def device_busy_ms(fn):
    """Device busy time of one ``fn()`` call: the union of the device
    events' intervals; None where the trace holds no device event."""
    return busy_ms(device_events(fn))


def bound_ms(nbytes, ops, wdt):
    """(least ms, "bytes" or "operations"): ``nbytes`` over the H100's
    memory rate against ``ops`` over the peak of type ``wdt`` (a key of
    ``PEAK_OPS``), whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[wdt]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")

