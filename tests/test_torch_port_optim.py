"""The port's optimizers (``train/optim.py``) against the JAX package's optax
chains (``fcl_taco2_tpu/train/optim.py``) on the same gradient trees:
adam, adamw, noam and lamb for three steps each, global-norm clipping, a
non-finite gradient (skipped and counted) and gradient accumulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcl_taco2_tpu.train.optim import build_optimizer as jax_optimizer
from fcl_taco2_tpu_torch.train.optim import build_optimizer, noam_schedule

TOL = 1e-6
SHAPES = {"a": (7, 5), "b": (5,), "c": (3, 4, 2), "zero": (4,)}


def _trees(seed, n, scale=1.0, nan_at=None):
    """Initial params and ``n`` gradient trees (numpy); the ``zero``
    leaf starts at 0 (LAMB's unit trust ratio)."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    params["zero"][:] = 0.0
    grads = [{k: (scale * rng.normal(size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(n)]
    if nan_at is not None:
        grads[nan_at]["b"][2] = np.nan
    return params, grads


def _run_both(kw, params, grads):
    tx = jax_optimizer(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    ptx = build_optimizer(**kw)
    keys = sorted(SHAPES)
    pp = [torch.from_numpy(params[k].copy()) for k in keys]
    ps = ptx.init(pp)
    for g in grads:
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        ptx.update(pp, [torch.from_numpy(g[k]) for k in keys], ps)
        for k, t in zip(keys, pp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=TOL, err_msg=k)
    return js, ps


@pytest.mark.parametrize("kw", [
    dict(name="adam", lr=1e-2),
    dict(name="adam", lr=1e-2, weight_decay=0.1),   # adamw
    dict(name="noam", lr=10.0, noam_model_size=64, noam_warmup=4),
    dict(name="lamb", lr=1e-2, weight_decay=0.01),
], ids=["adam", "adamw", "noam", "lamb"])
def test_three_steps_match_optax(kw):
    params, grads = _trees(0, 3, scale=0.1)
    _run_both(dict(kw, grad_clip=0.0), params, grads)


def test_clip_by_global_norm_matches_optax():
    params, grads = _trees(1, 3, scale=3.0)  # global norm ~ 3*sqrt(50)
    _run_both(dict(name="adam", lr=1e-2, grad_clip=1.0), params, grads)


def test_non_finite_gradient_is_skipped_and_counted():
    params, grads = _trees(2, 4, scale=0.1, nan_at=1)
    js, ps = _run_both(dict(name="adam", lr=1e-2), params, grads)
    assert ps["total_notfinite"] == int(js.total_notfinite) == 1
    assert ps["notfinite_count"] == int(js.notfinite_count) == 0
    assert ps["count"] == 3  # three applied updates of four


def test_gradient_accumulation_matches_multisteps():
    params, grads = _trees(3, 4, scale=0.5)
    _, ps = _run_both(dict(name="adam", lr=1e-2, accum_grad=2), params,
                      grads)
    assert ps["count"] == 2 and ps["mini_step"] == 0


def test_noam_counts_from_one():
    sched = noam_schedule(10.0, 64, 4)
    assert sched(0) == pytest.approx(10.0 * 64 ** -0.5 * 4 ** -1.5)
    assert sched(3) == pytest.approx(10.0 * 64 ** -0.5 * 4 ** -0.5)
