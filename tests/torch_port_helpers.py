"""Shared fixtures of the port's tests: the same config and weights in the
JAX package and in the port (weights through the bridge)."""

import dataclasses

import numpy as np
import jax
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

NO_DROPOUT = dict(dropout_rate=0.0, zoneout_rate=0.0,
                  duration_predictor_dropout_rate=0.0,
                  pitch_predictor_dropout_rate=0.0,
                  pitch_embed_dropout_rate=0.0,
                  energy_predictor_dropout_rate=0.0,
                  energy_embed_dropout_rate=0.0)


def port_batch(batch):
    """A JAX ``Batch`` of arrays -> the port's ``Batch`` of CPU tensors."""
    import torch
    from fcl_taco2_tpu_torch.models.taco2_sa import Batch, SegClass

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    d = {k: t(v) for k, v in batch._asdict().items() if k != "seg_classes"}
    if batch.seg_classes is not None:
        d["seg_classes"] = tuple(SegClass(*[t(x) for x in c])
                                 for c in batch.seg_classes)
    return Batch(**d)


def port_grads_as_jax(model, grads=None):
    """Gradients of a port model's parameters (``.grad`` unless ``grads``,
    a list in ``model.parameters()`` order, is given) as the JAX params
    tree of numpy arrays."""
    import torch
    from fcl_taco2_tpu_torch.utils.params import params_to_numpy

    names = [n for n, _ in model.named_parameters()]
    if grads is None:
        grads = [p.grad for p in model.parameters()]
    sd = {n: torch.zeros_like(p) if g is None else g
          for (n, p), g in zip(model.named_parameters(), grads)}
    assert list(sd) == names
    return params_to_numpy(sd)[0]


def max_rel_err(tree_a, tree_b):
    """max over leaves of max|a-b| / max|a| (``test_decoder_vjp.py:24``),
    the trees compared leaf by leaf with matching structure."""
    la = jax.tree_util.tree_leaves(np_tree(tree_a))
    lb = jax.tree_util.tree_leaves(np_tree(tree_b))
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(a - b)) / (1e-8 + np.max(np.abs(a))))
               for a, b in zip(la, lb))


def max_abs_err(tree_a, tree_b):
    la = jax.tree_util.tree_leaves(np_tree(tree_a))
    lb = jax.tree_util.tree_leaves(np_tree(tree_b))
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(a, np.float64)
                                   - np.asarray(b, np.float64))))
               for a, b in zip(la, lb))


def port_state_as_jax(model, new_state=None):
    """A port model's BatchNorm running statistics (its buffers, with
    ``new_state`` entries in their place) as the JAX state tree."""
    from fcl_taco2_tpu_torch.utils.params import params_to_numpy

    sd = dict(model.named_buffers())
    sd.update(new_state or {})
    return params_to_numpy(sd)[1]


class HostRead(RuntimeError):
    pass


class CaptureSafe(TorchDispatchMode):
    """Raises ``HostRead`` on an op a CUDA graph capture cannot hold."""

    READS = {"_local_scalar_dense", "is_nonzero", "nonzero", "masked_select",
             "item"}
    INDEXED = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.READS:
            raise HostRead(name)
        if name in self.INDEXED and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            raise HostRead(f"{name} with a boolean index")
        return func(*args, **(kwargs or {}))
