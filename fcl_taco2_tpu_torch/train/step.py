"""Train and eval steps (port of ``fcl_taco2_tpu/train/step.py:33-67``,
``:129-174`` and ``:176-188``): forward + hand-built decoder backward +
clip + non-finite guard + update, and the eval forward, for the model's
own loss and for knowledge distillation.

The step is three parts, each a public function so a caller can time them
apart: ``loss_and_grads`` (forward and backward), ``apply_update`` (the
optimizer) and the BatchNorm state write-back inside it.

Compiled as in JAX (``step.py:59-188``): on the card every train, KD and
eval step of one process is a replay of a CUDA graph per batch shape
(``TrainStep``, ``EvalStep``, ``utils/graphs.py``), captured over static
buffers: the batch (or the device cache's plan pack, assembled inside
the graph), the parameters, the optimizer state and the BatchNorm
statistics, all updated in place.  A replay draws from the step's
generator at its state (``step_generator(seed, step)``), so replay k
draws the masks an eager step k draws.  ``make_chained_train_step``
(``step.py:70-127``) runs K such replays a dispatch.  On the CPU the
steps run eagerly.

Data parallel (``mesh`` of more than one rank, ``parallel/``): each rank
runs the step on its share of the global batch, whose losses divide by
the global batch's counts (``ops/masking.py``) and whose BatchNorm
statistics are every rank's (``ops/conv.py::synced_batch_norm``); the
gradients and the report values are then summed over the ranks in one
flat all-reduce, before the non-finite guard and the clip, so every rank
takes the same decisions and applies the same update, and the
parameters stay equal without a broadcast.  Each rank draws from its own
generator (``step_generator(..., rank)``).  Over NCCL a multi-rank step is
a CUDA graph too, its all-reduces (the gradient bucket, the reports, the
synchronized BatchNorm's) captured inside it, as JAX compiles them into
the step's program (``step.py:58-67``); the ranks check that they capture
the same batch shape (``utils/graphs.py``).  Over gloo, whose collectives
run on the host, multi-rank steps stay eager.  The chained step stays
single-process, as in JAX.

Spans (``utils/spans.py``): ``train.forward`` (the batch's assembly and
the loss's forward, a KD teacher's included), ``train.backward``
(``torch.autograd.grad``) and ``train.optim`` (clip, the optimizer and
the BatchNorm write-back); the scans and the regroup gathers open their
own inside them (``scan.fwd``, ``scan.bwd``, ``regroup.bwd``).
"""

import torch

from fcl_taco2_tpu_torch.ops.conv import synced_batch_norm
from fcl_taco2_tpu_torch.ops.rnn import step_seed
from fcl_taco2_tpu_torch.parallel.mesh import capture_plan
from fcl_taco2_tpu_torch.train.optim import global_norm
from fcl_taco2_tpu_torch.utils.graphs import Graphed
from fcl_taco2_tpu_torch.utils.spans import span


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
        with span("train.forward"):
            loss, (report, new_state, _) = loss_fn(batch, generator,
                                                   train=True)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    grads, report = _sum_over_ranks(mesh, grads, dict(report))
    report["grad_norm"] = global_norm(grads)
    return report, new_state, grads


@torch.no_grad()
def _update_in_place(ts, tx, grads, new_state):
    with span("train.optim"):
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


def make_train_step(tx, loss_fn=None, mesh=None, graphed=True):
    """Returns step(train_state, batch, generator) -> (train_state,
    report); ``train_state.model`` is updated in place.  ``loss_fn``
    replaces ``train_state.model.loss_fn`` (KD).  ``mesh``: the ranks
    of a data-parallel run (``batch`` is then this rank's share of the
    global batch, ``parallel/distributed.py::make_global_batch``).  On the
    card each batch shape is one CUDA graph of the whole step (``TrainStep``),
    as JAX compiles the step per shape; ``graphed=False`` keeps it eager."""
    return TrainStep(tx, loss_fn, mesh, graphed=graphed)


def make_eval_step(loss_fn=None, mesh=None, graphed=True):
    """Eval step: the report only, model state untouched
    (``step.py:176-188``); with a ``mesh``, summed over its ranks.  On the
    card a CUDA graph per batch shape (``EvalStep``)."""
    return EvalStep(loss_fn, mesh, graphed=graphed)


def make_kd_train_step(kd, tx, mesh=None, graphed=True):
    """KD step (``step.py:129-159``): the frozen teacher's forward and the
    student's update; ``train_state.model`` is ``kd.student``, so the
    update and ``grad_norm`` cover the student and its ``kd_proj``
    only.  The same as ``make_train_step(tx, kd.loss_fn, mesh)``; the
    name is the JAX package's, for code ported from it."""
    return make_train_step(tx, kd.loss_fn, mesh, graphed=graphed)


def make_kd_eval_step(kd, mesh=None, graphed=True):
    """KD eval step (``step.py:162-174``): teacher and student in eval
    mode, the report only.  The same as ``make_eval_step(kd.loss_fn,
    mesh)``; the name is the JAX package's, for code ported from it."""
    return make_eval_step(kd.loss_fn, mesh, graphed=graphed)


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


class _GraphStats:
    """What a step's captures cost: ``captured``, ``capture_s`` (seconds,
    the warm-ups included) and ``pool_bytes`` (device memory the shared
    graph pool reserved during them)."""

    graphs = None

    @property
    def captured(self):
        return self.graphs is not None and bool(self.graphs.entries)

    @property
    def capture_s(self):
        return 0.0 if self.graphs is None else self.graphs.capture_s

    @property
    def pool_bytes(self):
        return 0 if self.graphs is None else self.graphs.pool_bytes


class TrainStep(_GraphStats):
    """One optimizer step: ``step(ts, item, generator)`` -> (ts, report).

    ``item``: a ``Batch`` on the device, or with ``assemble``
    (``DeviceBatchCache.assemble``) a plan pack, assembled inside the
    step.  On the card (one process) the whole step (assembly, forward,
    backward, update and the BatchNorm write-back) is a CUDA graph per
    item shape (``utils/graphs.py``), captured at the first item of that
    shape after ``WARMUP`` eager steps from a copy of the state that is
    put back, so the first replay starts from the state it was given.
    The graph updates the parameters, the optimizer state and the
    statistics in place; a replay draws from ``generator`` at its state.
    ``capture_s`` and ``pool_bytes`` sum the captures.  A capture or
    replay error raises; there is no eager fallback.
    """

    WARMUP = 3

    def __init__(self, tx, loss_fn=None, mesh=None, assemble=None,
                 graphed=True):
        self.tx = tx
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.assemble = assemble
        ok, self._graph_mesh = capture_plan(mesh, "train step")
        self.graphed = graphed and ok
        self.graphs = None
        self.report_keys = None
        self._ts = None

    def _report(self, ts, batch, generator):
        report, new_state, grads = loss_and_grads(ts.model, batch, generator,
                                                  self.loss_fn, self.mesh)
        _update_in_place(ts, self.tx, grads, new_state)
        return report

    def _graph_fn(self, item, generator):
        report = self._report(self._ts, self._batch(item), generator)
        self.report_keys, packed = pack_report(report)
        return packed

    def _batch(self, item):
        if self.assemble is None:
            return item
        with span("train.forward"):
            return self.assemble(item)

    def _graphs(self, ts):
        device = next(ts.model.parameters()).device
        if not self.graphed or device.type != "cuda":
            return None
        if self.graphs is None:
            self.graphs = Graphed(self._graph_fn, device, "train_step",
                                  warmup=self.WARMUP, mesh=self._graph_mesh)
        self.tx.counters_on(ts.opt_state, device)
        self._ts = ts
        return self.graphs

    def __call__(self, ts, item, generator):
        graphs = self._graphs(ts)
        if graphs is None:
            report = self._report(ts, self._batch(item), generator)
        else:
            packed = graphs(id(ts.model), item, generator,
                            restore=_state_tensors(ts))
            report = dict(zip(self.report_keys, packed))
        ts.step += 1
        return ts, report

    def prepare(self, ts, item, generator):
        """Capture the graph of ``item``'s shape now (on the card; a no-op
        on the CPU or when captured)."""
        graphs = self._graphs(ts)
        if graphs is not None:
            graphs.prepare(id(ts.model), item, generator,
                           restore=_state_tensors(ts))


class EvalStep(_GraphStats):
    """The eval forward: ``step(ts, batch, generator)`` -> report, the
    model untouched; on the card a CUDA graph per batch shape, as
    ``TrainStep``."""

    def __init__(self, loss_fn=None, mesh=None, graphed=True):
        self.loss_fn = loss_fn
        self.mesh = mesh
        ok, self._graph_mesh = capture_plan(mesh, "eval step")
        self.graphed = graphed and ok
        self.graphs = None
        self.report_keys = None
        self._model = None

    @torch.no_grad()
    def _report(self, model, batch, generator):
        _, (report, _, _) = (self.loss_fn or model.loss_fn)(
            batch, generator, train=False)
        return _sum_over_ranks(self.mesh, [], dict(report))[1]

    def _graph_fn(self, batch, generator):
        self.report_keys, packed = pack_report(
            self._report(self._model, batch, generator))
        return packed

    def __call__(self, ts, batch, generator):
        device = next(ts.model.parameters()).device
        if not self.graphed or device.type != "cuda":
            return self._report(ts.model, batch, generator)
        if self.graphs is None:
            self.graphs = Graphed(self._graph_fn, device, "eval_step",
                                  mesh=self._graph_mesh)
        self._model = ts.model
        packed = self.graphs(id(ts.model), batch, generator)
        return dict(zip(self.report_keys, packed))


class ChainedTrainStep:
    """``make_chained_train_step``'s product: ``chain(ts, items, seed)``
    runs ``len(items)`` optimizer steps and returns (ts, reports), reports
    a (K, n_keys) fp32 tensor in ``report_keys`` order.

    ``items``: with ``assemble`` (``DeviceBatchCache.assemble``) a (K, P)
    int32 tensor of plan packs on the device (or a list of them); without
    it, a list of K ``Batch``es on the device.  Step k draws from
    ``step_generator(seed, ts.step)``, as the single step does.  Each step
    is a ``TrainStep``: on the card a replay of one CUDA graph of the
    whole step, the batch assembly included; an epoch's remainder steps
    (a chain of one) replay the same graph.
    """

    def __init__(self, tx, loss_fn=None, assemble=None):
        self.step = TrainStep(tx, loss_fn, assemble=assemble)

    @property
    def report_keys(self):
        return self.step.report_keys

    @property
    def graphs(self):
        return self.step.graphs

    @property
    def captured(self):
        return self.step.captured

    @property
    def capture_s(self):
        return self.step.capture_s

    @property
    def pool_bytes(self):
        return self.step.pool_bytes

    def __call__(self, ts, items, seed):
        device = next(ts.model.parameters()).device
        reports = []
        for item in items:
            ts, report = self.step(ts, item,
                                   step_generator(seed, ts.step, device))
            if self.report_keys is None:  # eager: keys of this report
                self.step.report_keys, _ = pack_report(report)
            reports.append(torch.stack(
                [report[k].detach().float() for k in self.report_keys]))
        return ts, torch.stack(reports)

    def prepare(self, ts, item, seed):
        """Capture the graph of one step (on the card; a no-op on the
        CPU), with ``item`` as the warm-up's input."""
        device = next(ts.model.parameters()).device
        self.step.prepare(ts, item, step_generator(seed, ts.step, device))


def make_chained_train_step(tx, loss_fn=None, assemble=None):
    """K optimizer steps a dispatch (``step.py:689-745``); see
    ``ChainedTrainStep``."""
    return ChainedTrainStep(tx, loss_fn, assemble)
