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

The state is a plain dict (``init``), checkpointed as is.
"""

import math

import torch

B1, B2 = 0.9, 0.999


def noam_schedule(lr_factor: float, model_size: int, warmup_steps: int):
    """espnet NoamOpt learning rate at optimizer count ``count`` (0-based;
    noam counts from 1), ``optim.py:17-27``."""

    def schedule(count):
        step = float(count) + 1.0
        return (lr_factor * model_size ** -0.5
                * min(step ** -0.5, step * warmup_steps ** -1.5))

    return schedule


def global_norm(tensors):
    """optax ``global_norm``: the L2 norm of all the tensors together."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)))


def _all_finite(tensors):
    """One device scalar: every element of every tensor is finite."""
    maxes = torch._foreach_norm(tensors, ord=math.inf)
    return torch.isfinite(torch.stack(maxes)).all()


class Optimizer:
    """``build_optimizer``'s product: ``init(params)`` -> state and
    ``update(params, grads, state)``, which steps ``params`` in place.
    ``params`` and ``grads`` are equal-length lists of tensors, ``state`` a
    dict of tensors and ints keyed as in the JAX package's optax state."""

    def __init__(self, name, lr, eps, weight_decay, grad_clip, accum_grad,
                 noam_model_size, noam_warmup, nan_guard):
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

    def init(self, params):
        state = {"count": 0,
                 "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
        if self.nan_guard:
            state.update(notfinite_count=0, total_notfinite=0)
        if self.accum_grad > 1:
            state.update(mini_step=0,
                         acc_grads=[torch.zeros_like(p) for p in params])
        return state

    @torch.no_grad()
    def update(self, params, grads, state):
        """One call per gradient; the parameters move unless the gradients
        are still accumulating or the step is skipped as non-finite."""
        if self.accum_grad > 1:
            acc, n = state["acc_grads"], state["mini_step"]
            # Welford mean: acc + (g - acc) / (n + 1)
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_add_(acc, diff, alpha=1.0 / (n + 1))
            if n < self.accum_grad - 1:
                state["mini_step"] = n + 1
                return
            state["mini_step"] = 0
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
        if self.nan_guard:
            if not bool(_all_finite(grads)):
                state["notfinite_count"] += 1
                state["total_notfinite"] += 1
                return
            state["notfinite_count"] = 0
        if self.grad_clip and self.grad_clip > 0:
            # g / norm * max past the limit, g / 1 * 1 below it: the
            # choice stays on the device (no host sync)
            norm = global_norm(grads)
            below = norm < self.grad_clip
            one = torch.ones_like(norm)
            grads = torch._foreach_div(grads, torch.where(below, one, norm))
            torch._foreach_mul_(grads, torch.where(
                below, one, torch.full_like(norm, self.grad_clip)))
        self._adam_step(params, grads, state)

    def _adam_step(self, params, grads, state):
        lr = self.lr(state["count"])
        state["count"] += 1
        t = state["count"]
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, 1.0 - B1 ** t)
        nu_hat = torch._foreach_div(nu, 1.0 - self.b2 ** t)
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
        torch._foreach_add_(params, upd)


def build_optimizer(name="adam", lr=1e-3, eps=1e-6, weight_decay=0.0,
                    grad_clip=1.0, accum_grad=1, noam_model_size=512,
                    noam_warmup=25000, nan_guard=True, freeze_mods=None):
    """The JAX package's ``build_optimizer`` (``optim.py:30-72``):
    ``name`` adam (adamw when ``weight_decay`` > 0), noam (adam with
    b2=0.98, eps=1e-9 on the noam schedule) or lamb."""
    if freeze_mods:
        raise NotImplementedError(
            "freeze_mods is not ported yet: it comes with the fine-tuning "
            "slice (ROADMAP A2)")
    return Optimizer(name, lr, eps, weight_decay, grad_clip, accum_grad,
                     noam_model_size, noam_warmup, nan_guard)
