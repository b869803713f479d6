"""The port's spans: named layer boundaries that the host and, inside the
CUDA graphs, the card itself stamp.

``span(name)`` is a context manager.  While a profiler runs it opens
``torch.profiler.record_function(name)``, so an eager trace and the host's
time keep the name, on the profiler's own clock (without one it records
nothing on the host, where each range would cost a dispatcher call on
every serving call).  While a ``utils/graphs.py::Graphed`` capture is in
progress it also captures a one-thread mark kernel (``csrc/spans.cu``)
at its entry and at its exit.  A replay has no host ops, so these marks
are what splits a replayed graph's device time by layer.

Regions.  Each captured graph owns a ``last`` slot and a region a span
name (``OTHER``: its time outside every span), int64 slots of one buffer
a device, fixed on the host at capture time.  The graph opens with a
mark that only sets ``last``; every later mark reads ``%globaltimer``,
adds ``now - last`` to the region that ends there and sets ``last``:

- entering a span ends the enclosing region (the outer span's, or
  ``OTHER``);
- leaving a span ends its own region, and the enclosing one resumes;
- the graph closes with a mark that ends ``OTHER``.

So each span's region accumulates its self time, and the regions of one
replay partition the replay's device time from its first node to its
last.  Copies outside the graph, graphs on other streams and eager runs
(a capture's warm-ups, the gloo paths, the CPU) land in no region; marks
are captured only, so eager runs and CPU runs launch none.

``backward_span(name)`` spans the backward of a stretch of autograd ops
(``ops/rnn_vjp.py::scan_plain``): identity functions at the stretch's
inputs and outputs, whose backwards leave and enter the span.  The
autograd engine runs ready nodes latest-created first, so the stretch's
backward nodes run between those two.

A replay under a profiler leaves its graph's slots as they were
(``Capture.hold``/``restore`` around it, ``utils/graphs.py``): CUPTI
slows a traced replay, so the slots hold untraced replays only.

Counters.  ``count(name, value)`` inside a capture adds a device
tensor's sum to the graph's slot ``name`` at every replay: what only the
card knows, such as the steps an AR loop ran before its last row ended.
Counter slots lie among the graph's span slots (a traced replay leaves
them as they were too) and are never part of a replay's device time.

``totals()`` reads the buffer (one small copy to the host, made only
when asked) and sums every live ``Graphed``'s captures by graph name;
``None`` when nothing was captured (a CPU run).
"""

import ctypes

import torch
from torch.profiler import record_function

from fcl_taco2_tpu_torch.utils.cuda_build import Entry

SLOTS = 1 << 16        # int64 slots a device: every graph's stamp and regions
OTHER = "graph.other"  # a graph's device time outside every span

_buffers = {}  # device index -> _Buffer
_active = None  # the Capture in progress (set by utils/graphs.py::Graphed)
_MARK = Entry("spans", "span_mark_launch",
              [ctypes.c_void_p, ctypes.c_int, ctypes.c_int])


class _Buffer:
    """One device's slots: allocated once, before the first capture and
    outside the graph pool; slot 0 takes the warm-up mark."""

    def __init__(self, device):
        self.slots = torch.zeros(SLOTS, dtype=torch.int64, device=device)
        self.used = 1

    def mark(self, last, region):
        """One mark on the current stream (region -1: none)."""
        _MARK.launch(self.slots.data_ptr(), last, region,
                     device=self.slots.device)

    def alloc(self):
        if self.used >= SLOTS:
            raise RuntimeError(f"the span buffer's {SLOTS} slots are all "
                               "taken by captured graphs")
        self.used += 1
        return self.used - 1


class Capture:
    """The marks of one graph's capture, in the slots of ``buf`` (a
    ``_Buffer``: ``alloc()`` gives a free slot, ``slots`` is the tensor).
    ``launch(last, region)`` captures one mark (region -1: none).
    ``seq`` records the region each mark ends (None for the opening
    mark), ``counts`` each span's entries a replay, ``regions`` each
    region's slot, ``counters`` each counter's slot."""

    def __init__(self, buf, launch):
        self.buf, self.launch = buf, launch
        self.last = buf.alloc()
        self.stop = self.last + 1
        self.regions = {}
        self.counts = {}
        self.counters = {}
        self.seq = []
        self.stack = [OTHER]

    def _slot(self):
        # one capture at a time, so a graph's slots are contiguous
        slot = self.buf.alloc()
        self.stop = slot + 1
        return slot

    def _mark(self, ends):
        self.seq.append(ends)
        if ends is not None and ends not in self.regions:
            self.regions[ends] = self._slot()
        self.launch(self.last, -1 if ends is None else self.regions[ends])

    def begin(self):
        self._mark(None)

    def enter(self, name):
        self._mark(self.stack[-1])
        self.stack.append(name)
        self.counts[name] = self.counts.get(name, 0) + 1

    def exit(self):
        self._mark(self.stack.pop())

    def end(self):
        if len(self.stack) != 1:
            raise RuntimeError(f"spans {self.stack[1:]} were left open at "
                               "the end of a capture")
        self._mark(OTHER)

    def count(self, name, value):
        """Capture the add of ``value``'s sum to counter ``name``."""
        if name not in self.counters:
            self.counters[name] = self._slot()
        slot = self.counters[name]
        self.buf.slots[slot:slot + 1].add_(
            value.sum().to(torch.int64).reshape(1))

    def hold(self):
        """A copy of this graph's slots, taken on the current stream."""
        return self.buf.slots[self.last:self.stop].clone()

    def restore(self, held):
        """The slots set back to ``held`` on the current stream, after a
        replay that should not count."""
        self.buf.slots[self.last:self.stop].copy_(held)

    def totals(self, values, replays):
        """{span: {"ns", "count"}} of ``replays`` replays, from the slots'
        ``values``."""
        return {name: {"ns": int(values[slot]),
                       "count": self.counts.get(name, 1) * replays}
                for name, slot in self.regions.items()}

    def counter_totals(self, values):
        """{counter: its sum over the untraced replays}."""
        return {name: int(values[slot])
                for name, slot in self.counters.items()}


def start_capture(device):
    """The ``Capture`` of a graph about to be captured on ``device``, made
    the active one.  The first call on a device allocates its buffer and
    runs one mark eagerly, so the library is loaded before any capture."""
    global _active
    idx = torch.device(device).index or 0
    if idx not in _buffers:
        buf = _Buffer(device)
        buf.mark(0, -1)
        _buffers[idx] = buf
    buf = _buffers[idx]
    _active = Capture(buf, buf.mark)
    return _active


def stop_capture():
    global _active
    _active = None


def _capture_here():
    """The active capture, where this thread's stream is being captured."""
    cap = _active
    if cap is not None and torch.cuda.is_current_stream_capturing():
        return cap
    return None


def count(name, value):
    """Add the sum of ``value`` (a tensor on the card) to counter ``name``
    of the graph being captured, once a replay; nothing outside a
    capture."""
    cap = _capture_here()
    if cap is not None:
        cap.count(name, value)


def _open_range(name):
    """``record_function(name)`` entered, while a profiler runs."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = record_function(name)
    rf.__enter__()
    return rf


class span:
    """The block as span ``name``: a ``record_function`` range while a
    profiler runs and, inside a capture, marks on the card."""

    __slots__ = ("name", "_range", "_cap")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = _open_range(self.name)
        self._cap = _capture_here()
        if self._cap is not None:
            self._cap.enter(self.name)
        return self

    def __exit__(self, *exc):
        if self._cap is not None:
            self._cap.exit()
        if self._range is not None:
            self._range.__exit__(*exc)


class _Edge(torch.autograd.Function):
    """Identity; its backward enters the span (``first``: the identity at
    the stretch's outputs, which runs first) or leaves it (the one at its
    inputs, which runs last)."""

    @staticmethod
    def forward(ctx, bs, first, *xs):
        ctx.bs, ctx.first = bs, first
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.first:
            ctx.bs.enter()
        else:
            ctx.bs.leave()
        return (None, None, *grads)


class backward_span:
    """Span ``name`` around the backward of the autograd ops between
    ``inputs(...)`` and ``outputs(...)``: pass every tensor the stretch
    reads through ``inputs`` and every tensor it returns through
    ``outputs``.  Both return their arguments (views of the tensors that
    need a gradient); without a gradient to take they change nothing.
    Gradients pass through unchanged."""

    def __init__(self, name):
        self.name = name
        self.on = False
        self._range = self._cap = None

    def _wrap(self, first, ts):
        idx = [i for i, t in enumerate(ts)
               if torch.is_tensor(t) and t.requires_grad]
        if not idx:
            return ts
        out = list(ts)
        for i, t in zip(idx, _Edge.apply(self, first,
                                         *[ts[i] for i in idx])):
            out[i] = t
        return tuple(out)

    def inputs(self, *ts):
        if not torch.is_grad_enabled():
            return ts
        out = self._wrap(False, ts)
        self.on = out is not ts
        return out

    def outputs(self, *ts):
        return self._wrap(True, ts) if self.on else ts

    def enter(self):
        self._range = _open_range(self.name)
        self._cap = _capture_here()
        if self._cap is not None:
            self._cap.enter(self.name)

    def leave(self):
        if self._cap is not None:
            self._cap.exit()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._range = self._cap = None


def read(device):
    """The used slots of ``device``'s buffer on the host (one copy), or
    None where nothing was captured there."""
    buf = _buffers.get(torch.device(device).index or 0)
    return None if buf is None else buf.slots[:buf.used].tolist()


def totals():
    """Every live ``Graphed``'s captures summed by graph name, or None
    where nothing was captured: {graph name: {"replays" (the untraced
    replays the slots hold), "traced" (replays under a profiler, not in
    the slots), "launch_ns" (host ns inside ``graph.replay()`` over
    "timed" replays: untraced, each key's first left out), "upload_ns"
    (the keys' first replays), "device_ns" (all regions, ``OTHER``
    included), "spans": {span: {"ns", "count" (occurrences), "replays"
    (of the keys that hold it)}}, and, where the graph counts any,
    "counters": {counter: its sum over the untraced replays}}}."""
    from fcl_taco2_tpu_torch.utils import graphs
    values, rows = {}, []
    for g in graphs.live():
        if g.device.type != "cuda" or not g.entries:
            continue
        idx = g.device.index or 0
        if idx not in values:
            values[idx] = read(g.device)
        rows += g.stats(values[idx])
    if not rows:
        return None
    out = {}
    for r in rows:
        replays = r["replays"] - r["traced"]
        g = out.setdefault(r["name"], {
            "replays": 0, "traced": 0, "launch_ns": 0, "timed": 0,
            "upload_ns": 0, "device_ns": 0, "spans": {}})
        g["replays"] += replays
        g["traced"] += r["traced"]
        g["launch_ns"] += r["launch_ns"]
        g["timed"] += r["timed"]
        g["upload_ns"] += r["upload_ns"] or 0
        for name, s in r["spans"].items():
            g["device_ns"] += s["ns"]
            gs = g["spans"].setdefault(name, {"ns": 0, "count": 0,
                                              "replays": 0})
            gs["ns"] += s["ns"]
            gs["count"] += s["count"]
            gs["replays"] += replays
        for name, v in r.get("counters", {}).items():
            gc = g.setdefault("counters", {})
            gc[name] = gc.get(name, 0) + v
    return out
