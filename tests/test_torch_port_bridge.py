"""The weight bridge: JAX (params, state) -> port state_dict -> JAX is
exact, and every tensor lands in the port's modules (strict load); the
port's trees have JAX's structure with and without BatchNorm, so JAX's
loss and checkpoint loader take them."""

import numpy as np
import jax
import pytest

from fcl_taco2_tpu.models import Tacotron2SA as JModel
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA as PortModel
from fcl_taco2_tpu_torch.utils.params import params_from_jax, params_to_numpy

from helpers import tiny_config
from torch_port_helpers import np_tree, port_config


def test_params_round_trip_is_exact():
    # elayers=2 exercises blstm_extra; spk_embed_dim the widened dec_idim
    cfg = tiny_config(elayers=2, spk_embed_dim=3)
    params, state = JModel(cfg).init(jax.random.PRNGKey(0))
    params, state = np_tree(params), np_tree(state)
    sd = params_from_jax(params, state)
    model = PortModel(port_config(cfg), device="cpu")
    model.load_state_dict(sd)  # strict: no missing or unexpected keys
    p2, s2 = params_to_numpy(model.state_dict())
    for want, got in ((params, p2), (state, s2)):
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(want))
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # a layout spot check: nn.Linear stores (out, in)
    np.testing.assert_array_equal(
        sd["decoder.feat_out.weight"].numpy(),
        params["decoder"]["feat_out"]["w"].T)


# --------------------------------------------------------------------------
# configs without BatchNorm (ROADMAP C1): the empty bns lists JAX carries
# --------------------------------------------------------------------------


def _no_bn_port_trees(seed=0):
    cfg = tiny_config(use_batch_norm=False)
    model = PortModel(port_config(cfg), device="cpu", seed=seed)
    return cfg, model, params_to_numpy(model.state_dict())


@pytest.mark.parametrize("use_batch_norm", [True, False],
                         ids=["bn", "no_bn"])
def test_port_trees_have_jax_structure(use_batch_norm):
    cfg = tiny_config(use_batch_norm=use_batch_norm)
    want = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0))
    model = PortModel(port_config(cfg), device="cpu")
    got = params_to_numpy(model.state_dict())
    for w, g in zip(want, got):
        assert (jax.tree_util.tree_structure(g)
                == jax.tree_util.tree_structure(w))
        for a, b in zip(jax.tree_util.tree_leaves(w),
                        jax.tree_util.tree_leaves(g)):
            assert tuple(a.shape) == b.shape


def test_jax_loss_runs_on_port_no_bn_trees():
    """JAX's loss_fn on the port's trees of a no-BatchNorm config (it
    raised KeyError: 'bns' before) equals the port's own loss."""
    import torch
    from helpers import synthetic_batch
    from torch_port_helpers import NO_DROPOUT, port_batch

    cfg = tiny_config(use_batch_norm=False, **NO_DROPOUT)
    model = PortModel(port_config(cfg), device="cpu", seed=0)
    params, state = params_to_numpy(model.state_dict())
    batch = synthetic_batch(cfg, B=3, Tmax=5, seed=1)
    jl, _ = jax.jit(lambda p, s: JModel(cfg).loss_fn(
        p, s, batch, jax.random.PRNGKey(0), train=True))(params, state)
    loss, _ = model.loss_fn(port_batch(batch), torch.Generator())
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


def test_port_no_bn_checkpoint_loads_in_jax(tmp_path):
    """A port-written checkpoint of a no-BatchNorm model loads through
    JAX's load_params_only with its params and state templates."""
    from fcl_taco2_tpu.train.checkpoint import load_params_only
    from fcl_taco2_tpu.utils.device import zeros_like_shapes
    from fcl_taco2_tpu_torch.train.checkpoint import save_checkpoint
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState

    cfg, model, (params, state) = _no_bn_port_trees()
    tx = build_optimizer()
    path = str(tmp_path / "snapshot.ep.1")
    save_checkpoint(path, TrainState(model, tx.init(list(
        model.parameters())), 2), 1)
    pt, st = zeros_like_shapes(JModel(cfg).init, jax.random.PRNGKey(0))
    got_p, got_s = load_params_only(path, pt, st)
    for want, got in ((params, got_p), (state, got_s)):
        assert (jax.tree_util.tree_structure(np_tree(got))
                == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(np_tree(got_p))):
        np.testing.assert_array_equal(a, b)
    assert got_s == {"decoder": {"postnet": {"bns": []}},
                     "encoder": {"convs": {"bns": []}}}
