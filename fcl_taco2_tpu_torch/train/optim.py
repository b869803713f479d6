"""Optimizers: adam / adamw / noam / lamb with global-norm clipping, the
non-finite guard and gradient accumulation (port of
``fcl_taco2_tpu/train/optim.py``, with optax's semantics).

Reference: adam(lr=1e-3, eps=1e-6, wd=0) or espnet noam or apex FusedLAMB
(tts.py:396-412), grad-norm clip 1.0 (tts_train.py:243), NaN-grad skip
(tts.py:175-178), gradient accumulation (tts.py:156-170).  The update
rules are optax's, written out over lists of tensors with PyTorch's
multi-tensor (``torch._foreach_*``) ops:

- ``clip_by_global_norm``: unchanged when ``norm < max``, else
  ``g / norm * max`` (``clip_grad_norm_`` divides by ``norm + 1e-6``).
- Adam: ``mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps)``, ``eps`` outside
  the root; adamw adds ``weight_decay * param`` before the learning rate;
  LAMB (``optax.lamb``) then scales each tensor's update by
  ``|param| / |update|`` (1 where either norm is 0).
- noam: ``lr * model_size^-0.5 * min(t^-0.5, t * warmup^-1.5)``, t counting
  applied updates from 1.
- ``apply_if_finite``: a step whose gradients hold a non-finite value
  leaves parameters and moments as they are and is counted; it never gives
  up.
- ``MultiSteps``: the running mean of ``accum_grad`` gradients feeds one
  update.

- ``freeze_mods`` (``optim.py:51-76``): frozen gradients are zeroed
  before everything else (so the clip's global norm covers the trainable
  set and a non-finite value in a frozen subtree cannot veto a step), and
  frozen parameters never receive an update (so adamw/lamb decay cannot
  move them).

The state is a plain dict (``init``), checkpointed as is.  Its counters
(``count``, ``notfinite_count``, ``total_notfinite``, ``mini_step``) are
int64 tensors on the parameters' device, and every decision of a step
(skip a non-finite step, emit an accumulated update, the noam rate, the
bias corrections) is made on the device with ``torch.where``: ``update``
never reads a value back to the host, so a CUDA graph can replay it.
Checkpoints store the counters as ints (``train/checkpoint.py``).
"""

import math

import torch

B1, B2 = 0.9, 0.999


def noam_schedule(lr_factor: float, model_size: int, warmup_steps: int):
    """espnet NoamOpt learning rate at optimizer count ``count`` (0-based;
    noam counts from 1), ``optim.py:17-27``: a float for an int count, an
    fp32 device scalar for a tensor count (as the JAX schedule computes
    it)."""
    scale = lr_factor * model_size ** -0.5

    def schedule(count):
        if isinstance(count, torch.Tensor):
            step = count.to(torch.float32) + 1.0
            return scale * torch.minimum(step.pow(-0.5),
                                         step * warmup_steps ** -1.5)
        step = float(count) + 1.0
        return scale * min(step ** -0.5, step * warmup_steps ** -1.5)

    return schedule


def global_norm(tensors):
    """optax ``global_norm``: the L2 norm of all the tensors together."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)))


def _all_finite(tensors):
    """One device scalar: every element of every tensor is finite."""
    maxes = torch._foreach_norm(tensors, ord=math.inf)
    return torch.isfinite(torch.stack(maxes)).all()


_COUNTERS = ("count", "notfinite_count", "total_notfinite", "mini_step")


class Optimizer:
    """``build_optimizer``'s product: ``init(params, names)`` -> state and
    ``update(params, grads, state)``, which steps ``params`` in place.
    ``params`` and ``grads`` are equal-length lists of tensors, ``state`` a
    dict of tensors keyed as in the JAX package's optax state."""

    def __init__(self, name, lr, eps, weight_decay, grad_clip, accum_grad,
                 noam_model_size, noam_warmup, nan_guard, freeze_mods=()):
        if name not in ("adam", "noam", "lamb"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.eps = 1e-9 if name == "noam" else eps
        self.b2 = 0.98 if name == "noam" else B2
        # optax.adam(noam schedule) takes no weight decay (optim.py:36-39)
        self.weight_decay = 0.0 if name == "noam" else weight_decay
        self.lr = (noam_schedule(lr, noam_model_size, noam_warmup)
                   if name == "noam" else (lambda count: lr))
        self.grad_clip = grad_clip
        self.accum_grad = max(1, int(accum_grad))
        self.nan_guard = nan_guard
        self.freeze_mods = tuple(freeze_mods or ())
        self.frozen = None  # one flag a parameter, set by init

    def init(self, params, names=None):
        """``names``: the parameters' ``state_dict`` names, needed (and
        read) only with ``freeze_mods``."""
        params = list(params)
        if self.freeze_mods:
            if names is None:
                raise ValueError("freeze_mods selects parameters by name: "
                                 "call init(params, names)")
            from fcl_taco2_tpu_torch.train.finetune import freeze_mask_fn
            self.frozen = freeze_mask_fn(self.freeze_mods)(list(names))
        dev = params[0].device if params else torch.device("cpu")

        def zero():
            return torch.zeros((), dtype=torch.int64, device=dev)

        state = {"count": zero(),
                 "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
        if self.nan_guard:
            state.update(notfinite_count=zero(), total_notfinite=zero())
        if self.accum_grad > 1:
            state.update(mini_step=zero(),
                         acc_grads=[torch.zeros_like(p) for p in params])
        return state

    @staticmethod
    def counters_on(state, device):
        """Counters given as ints (a restored or hand-made state) become
        device tensors; runs before any capture, in the first call."""
        for k in _COUNTERS:
            v = state.get(k)
            if v is not None and not isinstance(v, torch.Tensor):
                state[k] = torch.tensor(int(v), dtype=torch.int64,
                                        device=device)

    @torch.no_grad()
    def update(self, params, grads, state):
        """One call per gradient; the parameters move unless the gradients
        are still accumulating or the step is skipped as non-finite."""
        self.counters_on(state, params[0].device)
        grads = list(grads)
        if self.frozen is not None:
            grads = [torch.zeros_like(g) if f else g
                     for g, f in zip(grads, self.frozen)]
        apply = None  # device bool: this call moves the parameters
        if self.accum_grad > 1:
            acc, n = state["acc_grads"], state["mini_step"]
            # Welford mean: acc + (g - acc) / (n + 1)
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_mul_(diff, 1.0 / (n + 1).to(torch.float32))
            torch._foreach_add_(acc, diff)
            apply = n == self.accum_grad - 1
            n.copy_(torch.where(apply, 0, n + 1))
            grads = [a.clone() for a in acc]
            for a in acc:  # reset after an emit
                a.masked_fill_(apply, 0.0)
        if self.nan_guard:
            finite = _all_finite(grads)
            bad = ~finite if apply is None else apply & ~finite
            ok = finite if apply is None else apply & finite
            nc = state["notfinite_count"]
            nc.copy_(torch.where(bad, nc + 1, torch.where(ok, 0, nc)))
            state["total_notfinite"].add_(bad.to(torch.int64))
            apply = ok
        if apply is not None:  # a skipped call draws on zeros
            zero = grads[0].new_zeros(())
            grads = [torch.where(apply, g, zero) for g in grads]
        if self.grad_clip and self.grad_clip > 0:
            # g / norm * max past the limit, g / 1 * 1 below it: the
            # choice stays on the device (no host sync)
            norm = global_norm(grads)
            below = norm < self.grad_clip
            one = torch.ones_like(norm)
            grads = torch._foreach_div(grads, torch.where(below, one, norm))
            torch._foreach_mul_(grads, torch.where(
                below, one, torch.full_like(norm, self.grad_clip)))
        self._adam_step(params, grads, state, apply)

    def _adam_step(self, params, grads, state, apply):
        """The core update; with ``apply`` (a device bool) False, the
        moments, the count and the parameters keep their values exactly
        (decay factors 1, increments 0)."""
        count = state["count"]
        lr = self.lr(count)
        mu, nu = state["mu"], state["nu"]
        if apply is None:
            count.add_(1)
            b1, c1, b2, c2 = B1, 1.0 - B1, self.b2, 1.0 - self.b2
        else:
            okf = apply.to(torch.float32)
            count.add_(apply.to(torch.int64))
            b1, c1 = torch.where(apply, B1, 1.0), (1.0 - B1) * okf
            b2, c2 = torch.where(apply, self.b2, 1.0), (1.0 - self.b2) * okf
            lr = lr * okf
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, c1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), c2))
        t = count.clamp(min=1).to(torch.float32)
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(B1, t))
        nu_hat = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, t))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        if self.name == "lamb":
            p_norms = torch._foreach_norm(params)
            u_norms = torch._foreach_norm(upd)
            for u, pn, un in zip(upd, p_norms, u_norms):
                ratio = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(pn), pn / un)
                u.mul_(ratio)
        torch._foreach_mul_(upd, -lr)
        if self.frozen is not None:  # frozen parameters never move
            keep = [not f for f in self.frozen]
            params = [p for p, k in zip(params, keep) if k]
            upd = [u for u, k in zip(upd, keep) if k]
            if not params:
                return
        torch._foreach_add_(params, upd)


def build_optimizer(name="adam", lr=1e-3, eps=1e-6, weight_decay=0.0,
                    grad_clip=1.0, accum_grad=1, noam_model_size=512,
                    noam_warmup=25000, nan_guard=True, freeze_mods=None):
    """The JAX package's ``build_optimizer`` (``optim.py:30-72``):
    ``name`` adam (adamw when ``weight_decay`` > 0), noam (adam with
    b2=0.98, eps=1e-9 on the noam schedule) or lamb; ``freeze_mods``:
    module prefixes (``train/finetune.py``) kept out of the update."""
    return Optimizer(name, lr, eps, weight_decay, grad_clip, accum_grad,
                     noam_model_size, noam_warmup, nan_guard, freeze_mods)
