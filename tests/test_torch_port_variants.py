"""The config matrix against JAX: each of
``tests/test_config_variants.py``'s 15 ``VARIANTS`` (stacked and
zero-layer encoder BiLSTM, decoder depth, reduction factor 2, no
BatchNorm, no masking, no prenet or postnet, ...) on the same weights
(drawn by the port's initializer and handed to JAX through the bridge)
and the same batch, dropouts 0: ``loss_fn`` with its report terms and
every gradient leaf (1e-5 relative / 1e-4 of a leaf's max), the new
BatchNorm statistics, and ``synthesize`` with the durations given (3e-4,
``tests/test_torch_parity.py``'s limit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcl_taco2_tpu.models import Tacotron2SA as JaxModel
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA as PortModel
from fcl_taco2_tpu_torch.utils.params import params_to_numpy

from helpers import synthetic_batch, tiny_config
from test_config_variants import VARIANTS
from torch_port_helpers import (NO_DROPOUT, max_abs_err, max_rel_err,
                                port_batch, port_config, port_grads_as_jax,
                                port_model, port_state_as_jax)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4   # max|a-b| / max|a| per leaf
STATE_ATOL = 1e-5
MEL_ATOL = 3e-4
BUDGET = 32        # >= every utterance's duration sum (5 tokens x 6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models: one intra-op thread is as fast, and the test workers
    sharing the cores do not oversubscribe them (spinning thread pools
    slowed these tests twentyfold under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_jax(name):
    cfg = tiny_config(**NO_DROPOUT, **VARIANTS[name])
    jm = JaxModel(cfg)
    sd = PortModel(port_config(cfg), device="cpu", seed=0).state_dict()
    params, state = jax.tree_util.tree_map(jnp.asarray,
                                           params_to_numpy(sd))
    batch = synthetic_batch(cfg, B=3, Tmax=5, seed=1)

    @jax.jit
    def jax_run(p):
        def loss_of(q):
            return jm.loss_fn(q, state, batch, jax.random.PRNGKey(2),
                              train=True)
        (loss, (rep, new_state, _)), grads = jax.value_and_grad(
            loss_of, has_aux=True)(p)
        out = jm.synthesize(p, state, batch.tokens, batch.ilens,
                            jax.random.PRNGKey(3), frame_budget=BUDGET,
                            durations=batch.durations)
        return loss, rep, new_state, grads, out

    jl, jrep, jstate, jgrads, jout = jax_run(params)

    pm = port_model(cfg, params, state)
    loss, (rep, new_state, _) = pm.loss_fn(
        port_batch(batch), torch.Generator().manual_seed(0), train=True)
    loss.backward()
    assert set(rep) == set(jrep)
    for k in rep:
        np.testing.assert_allclose(float(rep[k]), float(jrep[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert max_rel_err(jgrads, port_grads_as_jax(pm)) < GRAD_RTOL
    pstate = port_state_as_jax(pm, new_state)
    if jax.tree_util.tree_leaves(jstate):  # no_bn has no statistics
        assert max_abs_err(jstate, pstate) < STATE_ATOL
    else:
        assert not jax.tree_util.tree_leaves(pstate)

    pm = port_model(cfg, params, state)
    out = pm.synthesize(torch.tensor(np.asarray(batch.tokens)),
                        torch.tensor(np.asarray(batch.ilens)), 0, BUDGET,
                        durations=torch.tensor(np.asarray(batch.durations)))
    np.testing.assert_array_equal(out["olens"].numpy(),
                                  np.asarray(jout["olens"]))
    np.testing.assert_allclose(out["mel"].numpy(), np.asarray(jout["mel"]),
                               atol=MEL_ATOL)
