"""The reference's PyTorch checkpoints in the port
(``fcl_taco2_tpu_torch/utils/torch_import.py``), held to the JAX
package's import (``fcl_taco2_tpu/utils/torch_import.py``):

- a reference state dict imports to the same weights as JAX's import,
  compared through the bridge (``params_to_numpy``), for the BatchNorm,
  no-BatchNorm and ``zoneout_rate=0`` (bare LSTMCell) layouts;
- export -> import is exact, and export writes the reference's keys;
- the amp ``{"model": ...}`` file with DataParallel ``module.`` prefixes
  loads;
- a checkpoint written by ``tests/test_checkpoint_import_e2e.py``'s
  reference-topology torch model: the port's ``synthesize`` reproduces
  that model's own forward within the 3e-4 the JAX test holds JAX to.
"""

import jax
import numpy as np
import pytest
import torch

from fcl_taco2_tpu.utils import torch_import as jax_import
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA as PortModel
from fcl_taco2_tpu_torch.utils import torch_import as port_import
from fcl_taco2_tpu_torch.utils.params import params_to_numpy

from helpers import tiny_config
from torch_port_helpers import np_tree, port_config

LAYOUTS = {"bn": {}, "no_bn": dict(use_batch_norm=False),
           "zoneout0": dict(zoneout_rate=0.0), "elayers2": dict(elayers=2)}


def _reference_sd(cfg, seed=0):
    """A reference-layout state dict (numpy), written by the JAX package's
    export from seeded weights (the port's initializer, through the
    bridge), with non-trivial BatchNorm statistics."""
    model = PortModel(port_config(cfg), device="cpu", seed=seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.copy_(torch.rand(b.shape) + (0.5 if "var" in name else 0.0))
    params, state = params_to_numpy(model.state_dict())
    return jax_import.export_reference_state_dict(params, state, cfg)


@pytest.mark.parametrize("kw", LAYOUTS.values(), ids=LAYOUTS.keys())
def test_import_matches_jax(kw):
    cfg = tiny_config(**kw)
    sd = _reference_sd(cfg)
    assert ("dec.lstm.0.cell.weight_ih" in sd) == (cfg.zoneout_rate > 0)
    want = np_tree(jax_import.import_reference_state_dict(sd, cfg))
    got = params_to_numpy(
        port_import.import_reference_state_dict(sd, port_config(cfg)))
    lw, tw = jax.tree_util.tree_flatten(want)
    lg, tg = jax.tree_util.tree_flatten(got)
    assert tw == tg
    for a, b in zip(lw, lg):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", LAYOUTS.values(), ids=LAYOUTS.keys())
def test_export_import_roundtrip(kw):
    cfg = port_config(tiny_config(**kw))
    model = PortModel(cfg, device="cpu", seed=3)
    sd = model.state_dict()
    ref = port_import.export_reference_state_dict(sd, cfg)
    assert set(ref) == set(_reference_sd(tiny_config(**kw)))
    back = port_import.import_reference_state_dict(ref, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_load_amp_checkpoint_with_module_prefix(tmp_path):
    """amp_checkpoint files wrap the state dict as {'model': sd}
    (tts.py:190-198); DataParallel 'module.' prefixes are stripped."""
    cfg = port_config(tiny_config())
    src = PortModel(cfg, device="cpu", seed=1)
    with torch.no_grad():  # non-trivial running statistics
        for name, b in src.named_buffers():
            b.copy_(torch.rand(b.shape) + (0.5 if "var" in name else 0.0))
    ref = port_import.export_reference_state_dict(src.state_dict(), cfg)
    path = str(tmp_path / "amp_checkpoint_100.pt")
    torch.save({"model": {"module." + k: v for k, v in ref.items()},
                "optimizer": {}, "amp": {}}, path)
    got = port_import.load_reference_checkpoint(
        path, PortModel(cfg, device="cpu", seed=2))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)


def test_reference_checkpoint_reproduces_torch_forward(tmp_path):
    from test_checkpoint_import_e2e import RefModel, cfg_nodrop

    cfg = cfg_nodrop()
    tm = RefModel(cfg)
    tm.randomize(11)
    tm.eval()
    path = str(tmp_path / "amp_checkpoint_900.pt")
    torch.save({"model": tm.state_dict(), "optimizer": {}, "amp": {}}, path)
    model = port_import.load_reference_checkpoint(
        path, PortModel(port_config(cfg), device="cpu", seed=0))
    torch.testing.assert_close(  # BN state from the file, not from init
        model.state_dict()["encoder.convs.bns.0.running_mean"],
        tm.enc.convs[0][1].running_mean, rtol=0, atol=0)

    tokens = torch.tensor([[1, 4, 2, 3, 0, 0]])
    ilens = torch.tensor([4])
    durs = torch.tensor([[3, 2, 4, 1, 0, 0]], dtype=torch.int32)
    F = 16
    with torch.no_grad():
        out = model.synthesize(tokens, ilens, 0, F, durations=durs)
        mel_t, L, d_pred = tm.inference(tokens, ilens, durs.long(), F, cfg)
        out2 = model.synthesize(tokens, ilens, 0, F)
    assert int(out["olens"][0]) == L == 10
    np.testing.assert_allclose(out["mel"][0].numpy(), mel_t, atol=3e-4)
    # duration-predictor inference from the same imported weights rounds
    # as the reference does (clamped round(exp - 1))
    np.testing.assert_array_equal(
        out2["d_outs"][0, :4].numpy(),
        np.minimum(d_pred.numpy()[0, :4], cfg.max_dur))
