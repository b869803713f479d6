"""CUDA graphs of the port's steps: the counterpart of the JAX package's
``jax.jit`` (serving per bucket, the stream's stages, the train, KD and
eval steps).

``Graphed`` wraps a function ``fn(inputs, generator)`` of a tree of
tensors (tuples, lists, dicts, named tuples; other leaves are static).
On the card each static key (the caller's key, the tree's structure, every
tensor's shape and dtype and every non-tensor leaf) gets one CUDA graph:

- static input buffers on the card, filled by a copy before each replay
  (an input may come from the host);
- ``warmup`` eager runs on a side stream (PyTorch's rule before a
  capture), from a copy of the tensors the caller names in ``restore``,
  which are put back afterwards, so a train step's first replay starts
  from the state it was given;
- the capture, into one memory pool per device that every graph shares
  (``torch.cuda.graph_pool_handle``); ``capture_s`` and ``pool_bytes``
  (the device memory the pool reserved during the capture) per key;
- the replay.  Draws come from the caller's generator at its state at
  replay time: a graph-private generator, registered with every graph,
  takes the caller's state before the replay and gives it back after,
  so a replay draws what an eager call from that state draws and leaves
  the caller's generator where the eager call leaves it.  Outputs are
  cloned out of the graph's buffers (the next replay of any graph of the
  pool may reuse them).

Nothing falls back to eager on the card: a capture or replay error
raises.  On the CPU the function runs eagerly.

Launch counts: the kernel wrappers count a launch through
``count_launch``.  Inside a capture nothing runs, so the capture records
which wrapper launched and how often, and every replay adds that to the
wrappers' ``launches``.  ``tally`` does the same for any counter (the
mesh's all-reduce calls and bytes, ``parallel/mesh.py``).

Spans and replays (``utils/spans.py``): every capture opens and closes
with a span mark and records the marks of the spans its function enters,
so each replay splits its own device time by span.  Each replay's host
time inside ``graph.replay()`` adds to ``launch_ns``, except a key's
first replay (the graph's upload), kept apart as ``upload_ns``, and a
replay under a profiler, which is only counted (``traced``) and leaves
the spans' slots as they were: CUPTI slows a traced launch and replay,
so the counters hold untraced replays only.  ``stats()`` gives them,
and the spans' device ns, for every key.

Collectives: a function whose ``mesh`` (``parallel/mesh.py``) reduces over
NCCL captures its all-reduces with it; each rank replays its own graph,
and the ranks' graphs meet in the captured collectives.  So every rank
must capture the same keys at the same step: before a capture the ranks
compare a digest of the key (one eager all-gather, ``Mesh.check_same``),
and a mismatch raises instead of leaving a rank waiting in a collective.
"""

import gc
import hashlib
import time
import weakref

import torch
from torch.utils import _pytree as pytree

from fcl_taco2_tpu_torch.utils import spans

_recording = None  # {wrapper: launches} of the capture in progress
_tallies = None    # [(counter, key, n)] of the capture in progress
_pools = {}        # device index -> (the shared pool, its keeper graph)
_said = set()      # reasons printed once
_live = weakref.WeakSet()  # every Graphed of the process, for spans.totals


def live():
    """Every ``Graphed`` of the process that is still referenced."""
    return list(_live)


def capturing():
    """True while the current CUDA stream is being captured."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _outside_graphed(what):
    return RuntimeError(f"{what} was captured outside utils/graphs.py::"
                        "Graphed, which alone counts a graph's work")


def count_launch(fn):
    """Count one launch of the kernel wrapper ``fn`` on the card: now, or,
    inside a capture, once per replay of the graph."""
    if capturing():
        if _recording is None:
            raise _outside_graphed(fn.__name__)
        _recording[fn] = _recording.get(fn, 0) + 1
    else:
        fn.launches += 1


def tally(counter, key, n):
    """Add ``n`` to ``counter[key]`` now, or, inside a capture, once per
    replay of the graph (as ``count_launch``)."""
    if capturing():
        if _tallies is None:
            raise _outside_graphed(f"a tally of {key!r}")
        _tallies.append((counter, key, n))
    else:
        counter[key] += n


def say_once(reason):
    """Print ``reason`` the first time it comes (why a path stays eager)."""
    if reason not in _said:
        _said.add(reason)
        print(reason, flush=True)


def pool(device):
    """The one graph memory pool of ``device``.  A pool is released when
    the last graph captured into it dies, and its handle cannot be used
    again, so a one-op keeper graph holds it for the process."""
    idx = torch.device(device).index or 0
    if idx not in _pools:
        handle = torch.cuda.graph_pool_handle()
        keeper = torch.cuda.CUDAGraph()
        x = torch.zeros(1, device=device)
        with torch.cuda.graph(keeper, pool=handle):
            x.add_(1)
        _pools[idx] = (handle, keeper, x)
    return _pools[idx][0]


def pool_reserved_bytes(device):
    """Device memory held by ``device``'s shared graph pool now (from the
    caching allocator's snapshot; None where it has no pool id)."""
    idx = torch.device(device).index or 0
    if idx not in _pools:
        return 0
    want = tuple(_pools[idx][0])
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == want)


class _Entry:
    def __init__(self, graph, statics, out, launches, tallies, capture_s,
                 pool_bytes, marks):
        self.graph = graph
        self.statics = statics        # the leaves; tensors are the buffers
        self.out = out
        self.launches = launches
        self.tallies = tallies
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes
        self.marks = marks            # the capture's spans.Capture
        self.replays = 0
        self.traced = 0               # replays under a profiler
        self.launch_ns = 0            # host ns in replay() ...
        self.timed = 0                # ... of these: untraced, not first
        self.upload_ns = None         # host ns of the first replay

    def count_replay(self, ns, traced):
        """Add one replay's launches and tallies to their counters.  Its
        ``ns`` in ``graph.replay()`` go to ``upload_ns`` (the key's first
        replay) or ``launch_ns``, unless it ran under a profiler
        (``traced``: counted only)."""
        self.replays += 1
        if traced:
            self.traced += 1
        elif self.replays == 1:
            self.upload_ns = ns
        else:
            self.launch_ns += ns
            self.timed += 1
        for fn, n in self.launches.items():
            fn.launches += n
        for counter, key, n in self.tallies:
            counter[key] += n


def _signature(leaf):
    if torch.is_tensor(leaf):
        return ("tensor", tuple(leaf.shape), leaf.dtype)
    return leaf


def key_digest(full):
    """An int64 digest of a static key's tree structure, shapes, dtypes
    and static leaves (not the caller's part, which may name objects of
    this process), equal on every rank that captures the same graph."""
    _, spec, sigs = full
    raw = hashlib.sha256(repr((spec, sigs)).encode()).digest()
    return int.from_bytes(raw[:8], "little", signed=True)


class Graphed:
    """``fn(inputs, generator)`` as CUDA graphs on ``device``, one per
    static key; see the module docstring.  ``name`` labels the captures
    in ``stats``; ``warmup`` eager runs precede each capture.  ``mesh``:
    the ranks whose collectives the function captures; they check that
    they capture the same key before each capture."""

    def __init__(self, fn, device, name, warmup=2, mesh=None):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.warmup = warmup
        self.mesh = mesh
        self.entries = {}
        self._gen = None
        _live.add(self)

    def _key(self, key, inputs):
        leaves, spec = pytree.tree_flatten(inputs)
        return (key, spec, tuple(_signature(x) for x in leaves)), leaves, spec

    def captured(self, key, inputs):
        return self._key(key, inputs)[0] in self.entries

    def __call__(self, key, inputs, generator=None, restore=()):
        """``fn(inputs, generator)``: on the card a replay of ``key``'s
        graph (captured first when new, ``restore`` naming the tensors
        the function writes), eagerly on the CPU."""
        if self.device.type != "cuda":
            return self.fn(inputs, generator)
        entry, leaves = self.prepare(key, inputs, generator, restore)
        for dst, src in zip(entry.statics, leaves):
            if torch.is_tensor(dst):
                dst.copy_(src, non_blocking=True)
        gen = self._generator()
        if generator is not None:
            gen.set_state(generator.get_state())
        traced = torch.autograd._profiler_enabled()
        held = entry.marks.hold() if traced else None
        t0 = time.perf_counter_ns()
        entry.graph.replay()
        ns = time.perf_counter_ns() - t0
        if held is not None:
            entry.marks.restore(held)
        if generator is not None:
            generator.set_state(gen.get_state())
        entry.count_replay(ns, traced)
        return pytree.tree_map(
            lambda t: t.clone() if torch.is_tensor(t) else t, entry.out)

    def _generator(self):
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        return self._gen

    def prepare(self, key, inputs, generator=None, restore=()):
        """Capture ``key``'s graph unless it exists; returns (its entry,
        the inputs' leaves)."""
        global _recording, _tallies
        full, leaves, spec = self._key(key, inputs)
        entry = self.entries.get(full)
        if entry is not None:
            return entry, leaves
        if self.mesh is not None:
            self.mesh.check_same(key_digest(full),
                                 f"{self.name}'s graph key {full[2]}")
        t0 = time.perf_counter()
        dev = self.device
        statics = [x.detach().to(dev, copy=True) if torch.is_tensor(x)
                   else x for x in leaves]
        args = pytree.tree_unflatten(statics, spec)
        gen = self._generator()
        start = (generator.get_state() if generator is not None
                 else gen.get_state())
        saved = [t.detach().clone() for t in restore]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                gen.set_state(start)
                self.fn(args, gen)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():  # the warm-up's writes are undone
            for t, s in zip(restore, saved):
                t.copy_(s)
        torch.cuda.synchronize(dev)
        del saved
        # unreachable graphs (held in reference cycles) are destroyed now:
        # a graph destroyed by the collector during a capture would end
        # the capture, so the collector is off until it ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        _recording, _tallies = {}, []
        try:
            handle = pool(dev)
            marks = spans.start_capture(dev)
            torch.cuda.empty_cache()  # as the capture does first
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            gen.set_state(start)
            with torch.cuda.graph(graph, pool=handle):
                marks.begin()
                out = self.fn(args, gen)
                marks.end()
            torch.cuda.synchronize(dev)
            launches, tallies = _recording, _tallies
        finally:
            _recording = _tallies = None
            spans.stop_capture()
            if collecting:
                gc.enable()
        entry = _Entry(graph, statics, out, launches, tallies,
                       time.perf_counter() - t0,
                       torch.cuda.memory_reserved(dev) - reserved, marks)
        self.entries[full] = entry
        return entry, leaves

    @property
    def capture_s(self):
        return sum(e.capture_s for e in self.entries.values())

    @property
    def pool_bytes(self):
        return sum(e.pool_bytes for e in self.entries.values())

    def stats(self, values=None):
        """One row a captured key: name, key, capture seconds, pool bytes,
        replays (``traced`` of them under a profiler), the kernels each
        replay launches, the host ns inside ``graph.replay()``
        (``launch_ns`` over ``timed`` replays, the first apart as
        ``upload_ns``) and ``spans``: {span: {"ns": device ns over the
        untraced replays, "count": occurrences}}, read from the span
        slots' ``values`` (``spans.read``; read here when not given), and
        ``counters`` where the capture counts any (``spans.count``)."""
        if values is None and self.entries:
            values = spans.read(self.device)
        rows = []
        for k, e in self.entries.items():
            row = {"name": self.name, "key": repr(k[0]),
                   "capture_s": e.capture_s, "pool_bytes": e.pool_bytes,
                   "replays": e.replays, "traced": e.traced,
                   "launches": {fn.__name__: n
                                for fn, n in e.launches.items()},
                   "launch_ns": e.launch_ns, "timed": e.timed,
                   "upload_ns": e.upload_ns,
                   "spans": e.marks.totals(values, e.replays - e.traced)}
            if e.marks.counters:
                row["counters"] = e.marks.counter_totals(values)
            rows.append(row)
        return rows
