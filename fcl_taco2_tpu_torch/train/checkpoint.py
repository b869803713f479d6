"""Checkpoints in the JAX package's flax-msgpack layout (port of
``fcl_taco2_tpu/train/checkpoint.py``).

One msgpack file carries ``params``, ``model_state``, ``opt_state``,
``step``, ``epoch`` and ``best_val``, with the resolved model config in a
``model.json`` sidecar.  ``params`` (with a KD student's ``kd_proj``) and
``model_state`` are the JAX package's trees (``utils/params.py::params_to_numpy``; lists stored as
flax's ``{"0": ..., "1": ...}`` maps), so a JAX-written checkpoint's
weights load into the port and a port-written one's load in JAX with
``load_params_only``.  ``opt_state`` is written in optax's layout (flax's
``to_state_dict`` of the JAX package's optax chain, ``optax_layout``) when
the ``TrainState`` carries its optimizer (``tx``, as the trainers' do), so
either package resumes the other's snapshots; without it, in the port's
own tree (``train/optim.py``'s dict, keyed by parameter name, counters as
ints), which ``restore_checkpoint`` also reads.  Resumes are exact.  The
codec is ``utils/msgpack.py`` (the GPU host has no msgpack or flax).
"""

import dataclasses
import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from fcl_taco2_tpu_torch.models.config import ModelConfig
from fcl_taco2_tpu_torch.utils import msgpack
from fcl_taco2_tpu_torch.utils.params import (jax_leaf, param_tree,
                                              params_from_jax,
                                              params_to_numpy,
                                              relayout_tensor)


def save_model_json(exp_dir, cfg: ModelConfig, extra: Optional[dict] = None):
    """``model.json`` (``checkpoint.py:24-31``), readable by both
    packages."""
    os.makedirs(exp_dir, exist_ok=True)
    payload = {"model_config": dataclasses.asdict(cfg)}
    if extra:
        payload.update(extra)
    with open(os.path.join(exp_dir, "model.json"), "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)


def load_model_json(exp_dir):
    with open(os.path.join(exp_dir, "model.json")) as f:
        payload = json.load(f)
    return ModelConfig(**payload["model_config"]), payload


def _flax_state_dict(tree):
    """flax ``to_state_dict``: lists become ``{"0": ..., "1": ...}``."""
    if isinstance(tree, dict):
        return {str(k): _flax_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _flax_state_dict(v) for i, v in enumerate(tree)}
    return tree


# optimizer state: per-parameter lists <-> maps keyed by parameter name
_OPT_LISTS = ("mu", "nu", "acc_grads")


def _opt_tree(opt_state, names):
    return {k: (dict(zip(names, v)) if k in _OPT_LISTS else v)
            for k, v in opt_state.items()}


# --------------------------------------------------------------------------
# the optimizer state in optax's layout
# --------------------------------------------------------------------------

def optax_layout(tx):
    """The tree that flax's ``to_state_dict`` makes of the optax state the
    JAX package's ``build_optimizer`` (``optim.py:30-72``) builds for the
    settings of ``tx`` (a ``train.optim.Optimizer``): nested dicts whose
    string leaves name the state's entries, empty dicts for optax's empty
    states.  As read from optax 0.2.6, outermost first:

    - ``accum_grad`` > 1, ``MultiSteps``: {mini_step, gradient_step,
      inner_opt_state: <below>, acc_grads, skip_state: {}};
    - ``freeze_mods``: {0: masked zeroing {inner_state: {}}, 1: <below>};
    - ``nan_guard``, ``apply_if_finite``: {notfinite_count, last_finite,
      total_notfinite, inner_state: <below>};
    - the chain: [clip {} if grad_clip > 0], the core, [masked zeroing if
      freeze_mods], keyed 0, 1, ...;
    - the core, a chain: scale_by_adam {count, mu, nu}, then adam: the
      rate {}; adamw: decay {}, the rate {}; lamb: decay {}, trust ratio
      {}, the rate {}; noam: the schedule {count}.

    Beside ``Optimizer.init``'s entries it names ``last_finite`` (true
    unless the last emitted step was skipped: ``notfinite_count == 0``)
    and ``gradient_step`` (emitted steps, applied or skipped: ``count +
    total_notfinite``), both determined by the port's counters."""
    core = [{"count": "count", "mu": "mu", "nu": "nu"}]
    if tx.name == "noam":
        core.append({"count": "count"})
    else:
        core += [{}] * (3 if tx.name == "lamb" else
                        2 if tx.weight_decay else 1)
    masked = {"inner_state": {}}
    parts = [{}] if tx.grad_clip and tx.grad_clip > 0 else []
    parts += [_seq(core)] + ([masked] if tx.freeze_mods else [])
    node = _seq(parts)
    if tx.nan_guard:
        node = {"notfinite_count": "notfinite_count",
                "last_finite": "last_finite",
                "total_notfinite": "total_notfinite", "inner_state": node}
    if tx.freeze_mods:
        node = _seq([masked, node])
    if tx.accum_grad > 1:
        node = {"mini_step": "mini_step", "gradient_step": "gradient_step",
                "inner_opt_state": node, "acc_grads": "acc_grads",
                "skip_state": {}}
    return node


def _seq(items):
    return {str(i): v for i, v in enumerate(items)}


def to_optax(tx, opt, names):
    """A host copy of the port's optimizer state (counters as ints or 0-d
    tensors, per-parameter lists of CPU tensors in ``names`` order) ->
    optax's tree (``optax_layout``): int32 counters, ``last_finite`` a
    bool, moments in the JAX params tree's layout."""
    count = int(opt["count"])
    nf, tot = int(opt.get("notfinite_count", 0)), \
        int(opt.get("total_notfinite", 0))

    def value(name):
        if name in _OPT_LISTS:
            return _flax_state_dict(param_tree(zip(names, opt[name])))
        if name == "last_finite":
            return np.asarray(nf == 0)
        n = count + tot if name == "gradient_step" else int(opt[name])
        return np.asarray(n, np.int32)

    def fill(node):
        if isinstance(node, str):
            return value(node)
        return {k: fill(v) for k, v in node.items()}

    return fill(optax_layout(tx))


def _read_layout(layout, saved, out, where="opt_state"):
    if isinstance(layout, str):
        out.setdefault(layout, saved)  # noam: the adam count comes first
        return
    if not isinstance(saved, dict) or set(saved) != set(layout):
        got = sorted(saved) if isinstance(saved, dict) else type(saved)
        raise ValueError(f"{where}: keys {got} are not optax's "
                         f"{sorted(layout)} for this optimizer")
    for k, v in layout.items():
        _read_layout(v, saved[k], out, f"{where}/{k}")


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


def from_optax(tx, saved, names):
    """Inverse of ``to_optax``: optax's tree -> the entries of
    ``tx.init``'s dict, per-parameter entries as {name: tensor} in the
    port's layout (``restore_checkpoint`` copies them into the live
    state).  Raises where the tree is not the layout ``tx`` has."""
    got = {}
    _read_layout(optax_layout(tx), saved, got)
    paths = {n: tuple(str(p) for p in jax_leaf(n)[0]) for n in names}
    out = {}
    for k in ("count", "notfinite_count", "total_notfinite", "mini_step"):
        if k in got:
            out[k] = int(got[k])
    for k in _OPT_LISTS:
        if k not in got:
            continue
        have = set(_leaf_paths(got[k]))
        if have != set(paths.values()):
            raise ValueError(f"opt_state {k}: leaves "
                             f"{sorted(have ^ set(paths.values()))} differ "
                             "from the model's parameters")
        out[k] = {}
        for n, path in paths.items():
            leaf = got[k]
            for p in path:
                leaf = leaf[p]
            if not isinstance(leaf, torch.Tensor):  # bf16 comes as a tensor
                leaf = torch.from_numpy(np.array(leaf))
            out[k][n] = relayout_tensor(leaf, jax_leaf(n)[1])
    return out


def _host_tree(ts, host_tensors):
    """The checkpoint payload of a host copy of ``ts``'s tensors."""
    names = [n for n, _ in ts.model.named_parameters()]
    sd_keys = list(ts.model.state_dict().keys())
    sd = dict(zip(sd_keys, host_tensors["state_dict"]))
    params, model_state = params_to_numpy(sd)
    if ts.tx is not None:
        opt = to_optax(ts.tx, host_tensors["opt_state"], names)
    else:
        opt = _opt_tree(
            {k: ([t.numpy() if t.dtype != torch.bfloat16 else t for t in v]
                 if k in _OPT_LISTS else int(v))  # counters as ints
             for k, v in host_tensors["opt_state"].items()}, names)
    return {"params": _flax_state_dict(params),
            "model_state": _flax_state_dict(model_state),
            "opt_state": opt, "step": int(host_tensors["step"])}


def start_state_fetch(ts, opt_state_dtype=None):
    """Start the device -> host copy of a ``TrainState``; returns a
    zero-argument finisher that waits for it and builds the payload.

    On the card the tensors are first cloned on the current stream (fresh
    buffers, ordered after the step that wrote them, so later in-place
    updates cannot reach the snapshot), then copied to pinned host memory
    on a side stream; the finisher may run on another thread.
    ``opt_state_dtype`` (e.g. ``"bfloat16"``) narrows the optimizer's
    float32 tensors (``checkpoint.py:40-81``); restore casts back."""
    narrow = None if opt_state_dtype is None \
        else getattr(torch, opt_state_dtype)
    sd = [t.detach() for t in ts.model.state_dict().values()]
    opt = {k: ([t.detach() for t in v] if k in _OPT_LISTS else v)
           for k, v in ts.opt_state.items()}

    def snap(t, opt_leaf):
        if not isinstance(t, torch.Tensor):  # an int counter
            return t
        if opt_leaf and narrow is not None and t.dtype == torch.float32:
            return t.to(narrow)
        return t.clone()

    dev_sd = [snap(t, False) for t in sd]
    dev_opt = {k: ([snap(t, True) for t in v] if k in _OPT_LISTS
                   else snap(v, False))
               for k, v in opt.items()}
    step = int(ts.step)
    on_cuda = any(t.is_cuda for t in dev_sd)
    if not on_cuda:
        host = {"state_dict": dev_sd, "opt_state": dev_opt, "step": step}
        return lambda: _host_tree(ts, host)

    side = torch.cuda.Stream(device=dev_sd[0].device)
    side.wait_stream(torch.cuda.current_stream(dev_sd[0].device))

    def to_host(t):
        if not isinstance(t, torch.Tensor):
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        t.record_stream(side)
        return h

    with torch.cuda.stream(side):
        host = {"state_dict": [to_host(t) for t in dev_sd],
                "opt_state": {k: ([to_host(t) for t in v]
                                  if k in _OPT_LISTS else to_host(v))
                              for k, v in dev_opt.items()},
                "step": step}
        done = torch.cuda.Event()
        done.record(side)

    def finish():
        done.synchronize()
        return _host_tree(ts, host)

    return finish


def _write(path, blob):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn file


def _payload(host, epoch, best_val):
    return dict(host, epoch=int(epoch),
                best_val=float("inf") if best_val is None
                else float(best_val))


def save_checkpoint(path, ts=None, epoch: int = 0,
                    best_val: Optional[float] = None,
                    host: Optional[dict] = None):
    """Write one checkpoint file (``checkpoint.py:97-114``); ``host`` is a
    payload from ``start_state_fetch(...)()``."""
    if host is None:
        host = start_state_fetch(ts)()
    _write(path, msgpack.serialize(_payload(host, epoch, best_val)))


class AsyncCheckpointWriter:
    """Checkpoint writes that overlap training (``checkpoint.py:117-287``).

    ``submit`` starts the device -> host copy at once (on a side stream)
    and hands the wait, the msgpack encoding and the file writes to a
    background thread; it never blocks.  While a job is in flight,
    droppable jobs (periodic snapshots) are skipped (``skipped``) and
    must-write jobs (``model.loss.best``, the final snapshot) wait in a
    slot keyed by path, a newer one superseding an unwritten older one
    (``coalesced``).  Background errors are raised at the next ``submit``
    or at ``wait``, which drains everything.  ``last_bg`` holds the last
    job's phase times and bytes.
    """

    def __init__(self, opt_state_dtype=None):
        self._lock = threading.Lock()
        self._thread = None
        self._pending = {}     # path -> (finish, epoch, best_val)
        self._err = []
        self._opt_state_dtype = opt_state_dtype
        self.skipped = 0
        self.coalesced = 0
        self.last_bg = {}
        self.last_bg_s = 0.0

    def _busy_locked(self):
        return (self._thread is not None and self._thread.is_alive()) \
            or bool(self._pending)

    def submit(self, ts, jobs, droppable=False):
        """jobs: (path, epoch, best_val) or (path, epoch, best_val, must)
        written from ONE copy.  Returns False if every job was skipped."""
        self._raise_bg_errors()

        def must(j):
            return j[3] if len(j) > 3 else not droppable

        with self._lock:
            busy = self._busy_locked()
        kept = [j for j in jobs if must(j)] if busy else list(jobs)
        self.skipped += len(jobs) - len(kept)
        if not kept:
            return False
        finish = start_state_fetch(ts, opt_state_dtype=self._opt_state_dtype)
        triples = [(j[0], j[1], j[2]) for j in kept]
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                for path, epoch, best_val in triples:
                    if path in self._pending:
                        self.coalesced += 1
                    self._pending[path] = (finish, epoch, best_val)
            else:
                self._start_locked([(finish, triples)])
        return True

    def _take_pending_locked(self):
        groups = {}
        for path, (finish, epoch, best_val) in self._pending.items():
            groups.setdefault(id(finish), (finish, []))[1].append(
                (path, epoch, best_val))
        self._pending = {}
        return list(groups.values())

    def _start_locked(self, bundles):
        self._thread = threading.Thread(target=self._work, args=(bundles,),
                                        daemon=True)
        self._thread.start()

    def _work(self, bundles):
        t0 = time.perf_counter()
        bg = {"files": sum(len(jobs) for _, jobs in bundles),
              "fetch_s": 0.0, "serialize_s": 0.0, "write_s": 0.0,
              "bytes": 0}
        try:
            for finish, jobs in bundles:
                t1 = time.perf_counter()
                host = finish()
                t2 = time.perf_counter()
                bg["fetch_s"] += t2 - t1
                blobs = {}
                for path, epoch, best_val in jobs:
                    key = (int(epoch), float("inf") if best_val is None
                           else float(best_val))
                    if key not in blobs:
                        blobs[key] = msgpack.serialize(
                            _payload(host, *key))
                t3 = time.perf_counter()
                bg["serialize_s"] += t3 - t2
                for path, epoch, best_val in jobs:
                    key = (int(epoch), float("inf") if best_val is None
                           else float(best_val))
                    _write(path, blobs[key])
                    bg["bytes"] += len(blobs[key])
                bg["write_s"] += time.perf_counter() - t3
        except Exception as e:  # raised on the loop's thread later
            self._err.append(e)
        finally:
            for k in ("fetch_s", "serialize_s", "write_s"):
                bg[k] = round(bg[k], 4)
            bg["total_s"] = round(time.perf_counter() - t0, 4)
            self.last_bg = bg
            self.last_bg_s = bg["total_s"]
            with self._lock:
                if self._pending:
                    self._start_locked(self._take_pending_locked())

    def _raise_bg_errors(self):
        if self._err:
            errs, self._err = list(self._err), []
            for e in errs[1:]:
                print("AsyncCheckpointWriter: additional background "
                      f"failure: {e!r}", flush=True)
            raise errs[0]

    def wait(self):
        """Drain the running job and the pending ones, then raise the
        first background failure."""
        while True:
            with self._lock:
                t = self._thread
            if t is not None and t.is_alive():
                t.join()
                continue  # the worker may have chained a pending bundle
            with self._lock:
                if self._pending:
                    self._start_locked(self._take_pending_locked())
                    continue
                self._thread = None
                break
        self._raise_bg_errors()


def read_checkpoint(path):
    """The raw payload of a checkpoint file (flax's layout)."""
    with open(path, "rb") as f:
        return msgpack.restore(f.read())


def _load_weights(model, payload):
    """Strict, except that a KD snapshot's ``kd_proj`` is ignored by a
    model without projections, as flax's ``from_state_dict`` ignores it
    for a plain student template."""
    sd = params_from_jax(payload["params"], payload["model_state"])
    if not hasattr(model, "kd_proj"):
        sd = {k: v for k, v in sd.items() if not k.startswith("kd_proj.")}
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()})


def restore_checkpoint(path, template=None):
    """Returns (TrainState, epoch, best_val) (``checkpoint.py:289-322``).
    With a ``template`` TrainState, its model and optimizer state are
    overwritten in place (shapes checked, dtypes cast back to the live
    ones); without one, the raw payload takes the state's place.  The
    optimizer state may be in optax's layout (written by either package;
    read through ``template.tx``) or in the port's own."""
    payload = read_checkpoint(path)
    epoch = int(payload.get("epoch", 0))
    best_val = float(payload.get("best_val", float("inf")))
    if template is None:
        return payload, epoch, best_val
    _load_weights(template.model, payload)
    names = [n for n, _ in template.model.named_parameters()]
    saved = payload["opt_state"]
    if "mu" not in saved:  # optax's layout (the port's own has "mu" on top)
        if template.tx is None:
            raise ValueError("an optimizer state in optax's layout needs "
                             "the template's optimizer (TrainState.tx)")
        saved = from_optax(template.tx, saved, names)
    if set(saved) != set(template.opt_state):
        raise ValueError(f"optimizer state keys {sorted(saved)} do not "
                         f"match the live ones {sorted(template.opt_state)}")
    with torch.no_grad():
        for k, live in template.opt_state.items():
            if k not in _OPT_LISTS:  # a counter: kept where it lives
                if isinstance(live, torch.Tensor):
                    live.fill_(int(saved[k]))
                else:
                    template.opt_state[k] = int(saved[k])
                continue
            for name, t in zip(names, live):
                v = saved[k][name]
                v = v if isinstance(v, torch.Tensor) \
                    else torch.from_numpy(np.array(v))
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"{k}[{name}]: saved shape "
                                     f"{tuple(v.shape)} != {tuple(t.shape)}")
                t.copy_(v.to(t.dtype))
    template.step = int(payload["step"])
    return template, epoch, best_val


def load_params_only(path, model):
    """Load a checkpoint's ``params`` and ``model_state`` (written by
    either package) into ``model`` (``checkpoint.py:325-333``)."""
    _load_weights(model, read_checkpoint(path))
    return model
