"""Shared fixtures of the port's tests: the same config and weights in the
JAX package and in the port (weights through the bridge)."""

import dataclasses

import numpy as np
import jax

from fcl_taco2_tpu_torch.models.config import ModelConfig as PortConfig
from fcl_taco2_tpu_torch.models.decoder import Decoder
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA as PortModel
from fcl_taco2_tpu_torch.utils.params import params_from_jax


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_config(jcfg):
    return PortConfig(**dataclasses.asdict(jcfg))


def port_model(jcfg, params, state):
    """A CPU ``Tacotron2SA`` of the port holding the JAX weights."""
    model = PortModel(port_config(jcfg), device="cpu")
    model.load_state_dict(params_from_jax(np_tree(params), np_tree(state)))
    return model


def port_decoder(jcfg, dec_params, dec_state):
    """A CPU ``Decoder`` of the port holding JAX ``decoder_init`` weights."""
    sd = params_from_jax({"decoder": np_tree(dec_params)},
                         {"decoder": np_tree(dec_state)})
    dec = Decoder(port_config(jcfg), device="cpu")
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()})
    return dec


def segment_inputs(idim, dur, D, seed=0):
    """(enc_seg, frame_mask, position) numpy arrays for durations ``dur``
    (the layout synthesize builds)."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(len(dur), idim)).astype(np.float32)
    d = np.arange(D)[None, :]
    frame_mask = d < dur[:, None]
    position = np.where(frame_mask, d / np.maximum(dur[:, None], 1),
                        0.0).astype(np.float32)
    return enc, frame_mask, position


def port_pwg(jcfg, params):
    """A CPU ``ParallelWaveGAN`` of the port holding JAX ``pwg_init``
    weights, and its config."""
    from fcl_taco2_tpu_torch.utils.params import pwg_params_from_jax
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN, PWGConfig
    cfg = PWGConfig(**dataclasses.asdict(jcfg))
    model = ParallelWaveGAN(cfg, device="cpu")
    model.load_state_dict(pwg_params_from_jax(np_tree(params)))
    return model, cfg
