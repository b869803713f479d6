"""The reference's PyTorch checkpoints <-> the port's ``Tacotron2SA`` (port
of ``fcl_taco2_tpu/utils/torch_import.py``).

The reference saves torch state dicts (chainer torch_snapshot 'model' entry
or amp_checkpoint_N.pt {'model': ...}, the reference's tts.py:190-198,
553-554), keyed by the module tree of
nets/teacher_training/e2e_tts_tacotron2_sa.py.  The port's modules hold
the same tensors in the same PyTorch layouts under other names, so both
directions are renames (``_key_pairs``, the JAX key map of
``torch_import.py:87-138`` written as one table):

    reference key                               port key
    enc.embed.weight                            encoder.embed.weight
    enc.convs.{i}.0.weight                      encoder.convs.convs.{i}.weight
    enc.convs.{i}.1.{w,b,running_*}             encoder.convs.bns.{i}.*
    enc.blstm.{w}_l{k}[_reverse]                encoder.blstm.{k}.{fwd,bwd}.{w}
    {pred}.conv.{i}.0.{weight,bias}             {pred}.convs.{i}.*
    {pred}.conv.{i}.2.{weight,bias}             {pred}.lns.{i}.*  (espnet's
                                                channel LayerNorm)
    {pred}.linear.{weight,bias}                 {pred}.linear.*
    {pitch,energy}_embed.0.{weight,bias}        {pitch,energy}_embed.*
    dec.prenet.prenet.{i}.0.{weight,bias}       decoder.prenet.layers.{i}.*
    dec.lstm.{i}.cell.{w}                       decoder.lstm.{i}.{w}
    dec.feat_out.weight                         decoder.feat_out.weight
    dec.postnet.postnet.{i}.0.weight            decoder.postnet.convs.{i}.*
    dec.postnet.postnet.{i}.1.*                 decoder.postnet.bns.{i}.*

A ZoneOutCell wraps each decoder LSTMCell as ``.cell``; with
``zoneout_rate=0`` the reference stores the bare cell (decoder_sa.py:366-369),
so import takes either and export writes what the config's model has.
BatchNorm entries exist only with ``use_batch_norm``.  Keys the config's
model does not use are ignored, as the JAX import ignores them.
"""

import numpy as np
import torch

_BN = ("weight", "bias", "running_mean", "running_var")
_WB = ("weight", "bias")
_LSTM = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _key_pairs(cfg):
    """(reference key, port key) for every tensor of ``cfg``'s model; the
    decoder LSTMs' reference keys carry the ZoneOutCell's ``.cell``."""
    pairs = [("enc.embed.weight", "encoder.embed.weight")]

    def conv_bn_stack(ref, port, n):
        for i in range(n):
            pairs.append((f"{ref}.{i}.0.weight", f"{port}.convs.{i}.weight"))
            if cfg.use_batch_norm:
                pairs.extend((f"{ref}.{i}.1.{x}", f"{port}.bns.{i}.{x}")
                             for x in _BN)

    def variance(name, n):
        for i in range(n):
            pairs.extend((f"{name}.conv.{i}.0.{x}", f"{name}.convs.{i}.{x}")
                         for x in _WB)
            pairs.extend((f"{name}.conv.{i}.2.{x}", f"{name}.lns.{i}.{x}")
                         for x in _WB)
        pairs.extend((f"{name}.linear.{x}", f"{name}.linear.{x}")
                     for x in _WB)

    if cfg.econv_layers > 0:
        conv_bn_stack("enc.convs", "encoder.convs", cfg.econv_layers)
    for k in range(cfg.elayers):
        for sfx, d in (("", "fwd"), ("_reverse", "bwd")):
            pairs.extend((f"enc.blstm.{w}_l{k}{sfx}",
                          f"encoder.blstm.{k}.{d}.{w}") for w in _LSTM)
    variance("duration_predictor", cfg.duration_predictor_layers)
    if cfg.use_fe_condition:
        variance("pitch_predictor", cfg.pitch_predictor_layers)
        variance("energy_predictor", cfg.energy_predictor_layers)
        for name in ("pitch_embed", "energy_embed"):
            pairs.extend((f"{name}.0.{x}", f"{name}.{x}") for x in _WB)
    for i in range(cfg.prenet_layers):
        pairs.extend((f"dec.prenet.prenet.{i}.0.{x}",
                      f"decoder.prenet.layers.{i}.{x}") for x in _WB)
    for i in range(cfg.dlayers):
        pairs.extend((f"dec.lstm.{i}.cell.{w}", f"decoder.lstm.{i}.{w}")
                     for w in _LSTM)
    pairs.append(("dec.feat_out.weight", "decoder.feat_out.weight"))
    if cfg.postnet_layers > 0:
        conv_bn_stack("dec.postnet.postnet", "decoder.postnet",
                      cfg.postnet_layers)
    return pairs


def import_reference_state_dict(sd, cfg):
    """A reference torch state dict (tensors or arrays) -> the port's
    ``state_dict`` for a ``Tacotron2SA`` of ``cfg`` (CPU float tensors)."""
    out = {}
    for ref, port in _key_pairs(cfg):
        if ref not in sd and ".cell." in ref:  # zoneout_rate=0: bare cell
            ref = ref.replace(".cell.", ".", 1)
        if ref not in sd:
            raise KeyError(f"{ref!r} is not in the reference state dict")
        v = sd[ref]
        out[port] = (v.detach().cpu().clone() if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v)))
    return out


def load_reference_checkpoint(path, model):
    """Load a reference snapshot or amp checkpoint file (``{"model": sd}``,
    tts.py:190-198; a DataParallel ``module.`` prefix is stripped) into
    ``model`` (a ``Tacotron2SA``) and return it.  Only tensors and plain
    containers are unpickled (``weights_only``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model" in payload:
        payload = payload["model"]  # amp checkpoint layout
    sd = {(k[7:] if k.startswith("module.") else k): v
          for k, v in payload.items()}
    port = import_reference_state_dict(sd, model.cfg)
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in port.items()})
    return model


def export_reference_state_dict(state_dict, cfg):
    """Inverse of ``import_reference_state_dict``: the port's
    ``state_dict`` -> the reference's keys (CPU tensors), ``.cell`` only
    when ``cfg.zoneout_rate`` > 0 (the reference's ZoneOutCell)."""
    cell = cfg.zoneout_rate > 0.0
    out = {}
    for ref, port in _key_pairs(cfg):
        if not cell:
            ref = ref.replace(".cell.", ".", 1)
        out[ref] = state_dict[port].detach().cpu().clone()
    return out
