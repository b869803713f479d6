"""Train and eval steps (port of ``fcl_taco2_tpu/train/step.py:33-67``,
``:129-174`` and ``:176-188``): forward + hand-built decoder backward +
clip + non-finite guard + update, and the eval forward, for the model's
own loss and for knowledge distillation.

The step is three parts, each a public function so a caller can time them
apart: ``loss_and_grads`` (forward and backward), ``apply_update`` (the
optimizer) and the BatchNorm state write-back inside it.
"""

import torch

from fcl_taco2_tpu_torch.train.optim import global_norm


def loss_and_grads(model, batch, generator, loss_fn=None):
    """Forward and backward of ``loss_fn`` (default ``model.loss_fn``) in
    train mode.  Returns (report, new_state, grads): ``grads`` follows
    ``model.parameters()`` (zeros for a parameter the loss does not
    reach, as JAX gives) and ``report`` gains ``grad_norm``, the global
    norm of the raw gradients."""
    params = list(model.parameters())
    loss_fn = loss_fn or model.loss_fn
    loss, (report, new_state, _) = loss_fn(batch, generator, train=True)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    report = dict(report)
    report["grad_norm"] = global_norm(grads)
    return report, new_state, grads


@torch.no_grad()
def apply_update(ts, tx, grads, new_state):
    """The optimizer step on the model's parameters (in place) and the
    BatchNorm running statistics written back; returns the next
    ``TrainState``."""
    tx.update(list(ts.model.parameters()), grads, ts.opt_state)
    buffers = dict(ts.model.named_buffers())
    for name, value in new_state.items():
        buffers[name].copy_(value)
    ts.step += 1
    return ts


def make_train_step(tx, loss_fn=None):
    """Returns step(train_state, batch, generator) -> (train_state,
    report); ``train_state.model`` is updated in place.  ``loss_fn``
    replaces ``train_state.model.loss_fn`` (KD)."""

    def step(ts, batch, generator):
        report, new_state, grads = loss_and_grads(ts.model, batch,
                                                  generator, loss_fn)
        return apply_update(ts, tx, grads, new_state), report

    return step


def make_eval_step(loss_fn=None):
    """Eval step: the report only, model state untouched
    (``step.py:176-188``)."""

    @torch.no_grad()
    def step(ts, batch, generator):
        _, (report, _, _) = (loss_fn or ts.model.loss_fn)(batch, generator,
                                                          train=False)
        return report

    return step


def make_kd_train_step(kd, tx):
    """KD step (``step.py:129-159``): the frozen teacher's forward and the
    student's update; ``train_state.model`` is ``kd.student``, so the
    update and ``grad_norm`` cover the student and its ``kd_proj``
    only.  The same as ``make_train_step(tx, kd.loss_fn)``; the name is
    the JAX package's, for code ported from it."""
    return make_train_step(tx, kd.loss_fn)


def make_kd_eval_step(kd):
    """KD eval step (``step.py:162-174``): teacher and student in eval
    mode, the report only.  The same as ``make_eval_step(kd.loss_fn)``;
    the name is the JAX package's, for code ported from it."""
    return make_eval_step(kd.loss_fn)
