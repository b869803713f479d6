"""The traced sub-window and the card's identity: a ``torch.profiler``
trace (host and device activity) read as plain intervals, their union,
the device's idle gaps labelled by the host op that was running, the
card's name and power limit, and its clocks from NVML.  The interval arithmetic is the benchmark's
own copy, so the yardstick does not move when the program's measurement
code does.
"""

import bisect
import ctypes
import functools
import os
import re
import subprocess
import time

import torch


def card():
    """(name, ``nvidia-smi``'s name and power limit line)."""
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    return name, smi


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
    """The card's SM and memory clocks (MHz), power draw (W) and the
    bitmask of the driver's clock-event reasons now, from NVML; None
    without NVML."""
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
        "reasons": r.value if read(
            "nvmlDeviceGetCurrentClocksThrottleReasons",
            ctypes.byref(r)) else None}


def record(fn, host=True):
    """Run ``fn()`` under the profiler.  Returns (device events, host
    events, window seconds): device events (name, start ns, end ns) of
    kernels and copies, host events (name, start ns, end ns, thread; none
    with ``host=False``, which traces the card alone and leaves the host
    nearly as fast as untraced), and the host clock's seconds from before
    ``fn`` to after the card finished it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), e.start_ns(), e.end_ns(),
                         e.start_thread_id()))
    return dev, host, window


def busy_s(events):
    """Seconds covered by the union of the events' intervals."""
    busy, end = 0, None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e9


def gaps(events):
    """The idle intervals (start ns, end ns) between the first device
    event's start and the last one's end."""
    out, end = [], None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is not None and a > end:
            out.append((end, a))
        if end is None or b > end:
            end = b
    return out


def kernel_label(name):
    """A short label of a kernel's name: the kernel and the last functor
    or kernel named in its template arguments; other names cut to 60
    characters."""
    parts = [t for t in re.findall(r"\w*(?:Functor|_kernel|Kernel|gemm)\w*",
                                   name)
             if not t.startswith("gpu_kernel_impl")]
    if not parts:
        return name[:60]
    label = parts[0] if len(parts) == 1 else f"{parts[0]}:{parts[-1]}"
    return label[:60]


def top_device_ops(events, n=10):
    """[label, seconds] of the ``n`` labels with the most device time."""
    by = {}
    for name, a, b in events:
        k = kernel_label(name)
        by[k] = by.get(k, 0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(dev, host, n=10, lookback=4000):
    """[host op, seconds] of the ``n`` host ops under which the card sat
    idle longest: each idle gap goes to the innermost host op (the latest
    to start) that spans the gap's middle, or to "no host op"."""
    spans = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in spans]
    by = {}
    for a, b in gaps(dev):
        mid = (a + b) // 2
        k = "no host op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - lookback, -1), -1):
            if spans[j][2] >= mid:
                k = spans[j][0]
                break
        by[k] = by.get(k, 0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
