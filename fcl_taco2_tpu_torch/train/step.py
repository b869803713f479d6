"""Train and eval steps (port of ``fcl_taco2_tpu/train/step.py:33-67``,
``:129-174`` and ``:176-188``): forward + hand-built decoder backward +
clip + non-finite guard + update, and the eval forward, for the model's
own loss and for knowledge distillation.

The step is three parts, each a public function so a caller can time them
apart: ``loss_and_grads`` (forward and backward), ``apply_update`` (the
optimizer) and the BatchNorm state write-back inside it.

``make_chained_train_step`` (``step.py:70-127``) runs K steps a dispatch.
On the card its steps are replays of one CUDA graph of the whole step
(the device cache's batch assembly included, ``data/device_cache.py``),
captured once over static buffers: the plan pack (or the batch), the
parameters, the optimizer state and the BatchNorm statistics, all
updated in place.  The step's draws come from the card's default
generator, which a graph replay reads at replay time: the loop re-seeds
it with ``step_seed(seed, step)`` before each replay, so replay k draws
the masks an eager step k draws.  On the CPU the chain is K eager steps.

Data parallel (``mesh`` of more than one rank, ``parallel/``): each rank
runs the step on its share of the global batch, whose losses divide by
the global batch's counts (``ops/masking.py``) and whose BatchNorm
statistics are every rank's (``ops/conv.py::synced_batch_norm``); the
gradients and the report values are then summed over the ranks in one
flat all-reduce, before the non-finite guard and the clip, so every rank
takes the same decisions and applies the same update, and the
parameters stay equal without a broadcast.  Each rank draws from its own
generator (``step_generator(..., rank)``).  The chained step stays
single-process, as in JAX.
"""

import time

import torch

from fcl_taco2_tpu_torch.ops.conv import synced_batch_norm
from fcl_taco2_tpu_torch.ops.rnn import step_seed
from fcl_taco2_tpu_torch.train.optim import global_norm


def _sum_over_ranks(mesh, grads, report):
    """Gradients and report values summed over the ranks, in one flat
    fp32 all-reduce (each rank's values are its share of the global
    batch's, over the global denominators)."""
    if mesh is None or not mesh.distributed:
        return grads, report
    keys = sorted(report)
    vals = [report[k].detach().float().reshape(1) for k in keys]
    mesh.all_reduce_list_(list(grads) + vals)
    return grads, {k: v.reshape(()) for k, v in zip(keys, vals)}


def loss_and_grads(model, batch, generator, loss_fn=None, mesh=None):
    """Forward and backward of ``loss_fn`` (default ``model.loss_fn``) in
    train mode.  Returns (report, new_state, grads): ``grads`` follows
    ``model.parameters()`` (zeros for a parameter the loss does not
    reach, as JAX gives) and ``report`` gains ``grad_norm``, the global
    norm of the raw gradients.  With a ``mesh`` of several ranks,
    ``grads`` and ``report`` are the global batch's (summed over the
    ranks)."""
    params = list(model.parameters())
    loss_fn = loss_fn or model.loss_fn
    with synced_batch_norm(mesh):
        loss, (report, new_state, _) = loss_fn(batch, generator, train=True)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    grads, report = _sum_over_ranks(mesh, grads, dict(report))
    report["grad_norm"] = global_norm(grads)
    return report, new_state, grads


@torch.no_grad()
def _update_in_place(ts, tx, grads, new_state):
    tx.update(list(ts.model.parameters()), grads, ts.opt_state)
    buffers = dict(ts.model.named_buffers())
    for name, value in new_state.items():
        buffers[name].copy_(value)


def apply_update(ts, tx, grads, new_state):
    """The optimizer step on the model's parameters (in place) and the
    BatchNorm running statistics written back; returns the next
    ``TrainState``."""
    _update_in_place(ts, tx, grads, new_state)
    ts.step += 1
    return ts


def pack_report(report):
    """A step's report dict -> (sorted keys, one fp32 vector): the
    packed form the trainer moves to the host (``step.py:636-649``)."""
    keys = sorted(report)
    return keys, torch.stack([report[k].detach().float() for k in keys])


def make_train_step(tx, loss_fn=None, mesh=None):
    """Returns step(train_state, batch, generator) -> (train_state,
    report); ``train_state.model`` is updated in place.  ``loss_fn``
    replaces ``train_state.model.loss_fn`` (KD).  ``mesh``: the ranks
    of a data-parallel run (``batch`` is then this rank's share of the
    global batch, ``parallel/distributed.py::make_global_batch``)."""

    def step(ts, batch, generator):
        report, new_state, grads = loss_and_grads(ts.model, batch,
                                                  generator, loss_fn, mesh)
        return apply_update(ts, tx, grads, new_state), report

    return step


def make_eval_step(loss_fn=None, mesh=None):
    """Eval step: the report only, model state untouched
    (``step.py:176-188``); with a ``mesh``, summed over its ranks."""

    @torch.no_grad()
    def step(ts, batch, generator):
        _, (report, _, _) = (loss_fn or ts.model.loss_fn)(batch, generator,
                                                          train=False)
        return _sum_over_ranks(mesh, [], dict(report))[1]

    return step


def make_kd_train_step(kd, tx, mesh=None):
    """KD step (``step.py:129-159``): the frozen teacher's forward and the
    student's update; ``train_state.model`` is ``kd.student``, so the
    update and ``grad_norm`` cover the student and its ``kd_proj``
    only.  The same as ``make_train_step(tx, kd.loss_fn, mesh)``; the
    name is the JAX package's, for code ported from it."""
    return make_train_step(tx, kd.loss_fn, mesh)


def make_kd_eval_step(kd, mesh=None):
    """KD eval step (``step.py:162-174``): teacher and student in eval
    mode, the report only.  The same as ``make_eval_step(kd.loss_fn,
    mesh)``; the name is the JAX package's, for code ported from it."""
    return make_eval_step(kd.loss_fn, mesh)


def step_generator(seed, step, device, rank=0):
    """The ``torch.Generator`` of train step ``step`` on rank ``rank`` of
    a data-parallel run: a function of ``(seed, step, rank)`` only, so a
    resumed run replays its draws and no two ranks draw the same masks.
    Rank 0 draws what a single-process run draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step) if rank == 0
                    else step_seed(seed, step, rank))
    return gen


def _state_tensors(ts):
    """Every tensor a train step writes: parameters, buffers, optimizer
    state (lists and counters)."""
    out = list(ts.model.parameters()) + list(ts.model.buffers())
    for v in ts.opt_state.values():
        if isinstance(v, list):
            out.extend(v)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


class ChainedTrainStep:
    """``make_chained_train_step``'s product: ``chain(ts, items, seed)``
    runs ``len(items)`` optimizer steps and returns (ts, reports), reports
    a (K, n_keys) fp32 tensor in ``report_keys`` order.

    ``items``: with ``assemble`` (``DeviceBatchCache.assemble``) a (K, P)
    int32 tensor of plan packs on the device; without it, a list of K
    ``Batch``es on the device.  Step k draws from
    ``step_seed(seed, ts.step)``, as the single step does.

    On the card the first call (or ``prepare``) captures the graph:
    ``WARMUP`` eager iterations on a side stream, which PyTorch needs
    before a capture, run from a copy of the state that is put back
    afterwards, so the run's first graphed step starts from the state
    the caller passed.  ``capture_s`` and ``pool_bytes`` (the graph's
    private memory pool, reserved bytes) record the capture.  A capture
    or replay error raises; there is no eager fallback.
    """

    WARMUP = 3

    def __init__(self, tx, loss_fn=None, assemble=None):
        self.tx = tx
        self.loss_fn = loss_fn
        self.assemble = assemble
        self.report_keys = None
        self.graph = None
        self.capture_s = 0.0
        self.pool_bytes = 0

    # ---- the step body, shared by the eager and the captured form ----

    def _body(self, ts, batch, generator):
        report, new_state, grads = loss_and_grads(ts.model, batch,
                                                  generator, self.loss_fn)
        _update_in_place(ts, self.tx, grads, new_state)
        keys, packed = pack_report(report)
        self.report_keys = keys
        return packed

    def _batch(self, item):
        return self.assemble(item) if self.assemble is not None else item

    def __call__(self, ts, items, seed):
        device = next(ts.model.parameters()).device
        if device.type != "cuda":
            reports = []
            for item in items:
                reports.append(self._body(
                    ts, self._batch(item),
                    step_generator(seed, ts.step, device)))
                ts.step += 1
            return ts, torch.stack(reports)
        if self.graph is None:
            self.prepare(ts, items[0], seed)
        gen = torch.cuda.default_generators[device.index or 0]
        reports = []
        for item in items:
            self._fill(item)
            gen.manual_seed(step_seed(seed, ts.step))
            self.graph.replay()
            reports.append(self.out.clone())  # the next replay rewrites it
            ts.step += 1
        return ts, torch.stack(reports)

    def _fill(self, item):
        if self.assemble is not None:
            self.static_in.copy_(item, non_blocking=True)
        else:
            for dst, src in zip(_leaves(self.static_in), _leaves(item)):
                dst.copy_(src, non_blocking=True)

    def prepare(self, ts, item, seed):
        """Capture the graph of one step (on the card; a no-op on the
        CPU), with ``item`` as the warm-up's input."""
        device = next(ts.model.parameters()).device
        if device.type != "cuda" or self.graph is not None:
            return
        from fcl_taco2_tpu_torch.data.loader import _map_batch
        t0 = time.perf_counter()
        self.tx.counters_on(ts.opt_state, device)
        self.static_in = (item.clone() if self.assemble is not None
                          else _map_batch(torch.clone, item))
        self._fill(item)
        gen = torch.cuda.default_generators[device.index or 0]
        saved = [t.detach().clone() for t in _state_tensors(ts)]
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                gen.manual_seed(step_seed(seed, ts.step))
                self._body(ts, self._batch(self.static_in), gen)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        gen.manual_seed(step_seed(seed, ts.step))
        with torch.cuda.graph(graph):
            self.out = self._body(ts, self._batch(self.static_in), gen)
        torch.cuda.synchronize(device)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        with torch.no_grad():  # the warm-up's updates are undone
            for t, s in zip(_state_tensors(ts), saved):
                t.copy_(s)
        del saved
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


def _leaves(tree):
    from fcl_taco2_tpu_torch.data.loader import _map_batch
    out = []
    _map_batch(out.append, tree)
    return out


def make_chained_train_step(tx, loss_fn=None, assemble=None):
    """K optimizer steps a dispatch (``step.py:689-745``); see
    ``ChainedTrainStep``."""
    return ChainedTrainStep(tx, loss_fn, assemble)
