"""The weight bridge: JAX (params, state) -> port state_dict -> JAX is
exact, and every tensor lands in the port's modules (strict load)."""

import numpy as np
import jax

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
