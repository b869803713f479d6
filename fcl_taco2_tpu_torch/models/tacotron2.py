"""Tacotron2 (Shen et al. 2018, arXiv:1712.05884) with location-sensitive
attention, as espnet builds it for LJSpeech
(``egs/ljspeech/tts1/conf/tuning/train_pytorch_tacotron2.v3.yaml``;
``espnet/nets/pytorch_backend/tacotron2/{encoder,decoder}.py``): the
autoregressive baseline that FCL-taco2's semi-autoregressive decoder is
cut from.  Inference only.

The encoder is FCL-taco2's (``models/encoder.py``).  The decoder runs one
AR loop over the whole utterance; each step attends over the encoder
memory with ``AttLoc`` (``models/attention.py``) queried by the first
LSTM's previous state::

    att_c, alpha = AttLoc(enc, h0, w_cum)
    p  = prenet(prev_out)                  dropout 0.5 on at inference
    h0 = ZoneOutLSTM0([att_c, p]);  h1 = ZoneOutLSTM1(h0)
    out_t = [h1, att_c] @ W_feat;   stop_t = [h1, att_c] @ w_prob + b_prob

and the postnet adds its residual.  A row stops after the step whose
``sigmoid(stop_t) >= threshold``, within ``ilen * minlenratio`` and
``ilen * maxlenratio`` frames, or at lengths the caller pins.  The loop
runs in one kernel launch on the card (``ops/attn_decode_cuda.py``).
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from fcl_taco2_tpu_torch.models import components as C
from fcl_taco2_tpu_torch.models.attention import AttLoc, project_memory
from fcl_taco2_tpu_torch.models.decoder import apply_postnet_inference
from fcl_taco2_tpu_torch.models.encoder import Encoder, encoder_apply
from fcl_taco2_tpu_torch.models.taco2_sa import _cast_floats
from fcl_taco2_tpu_torch.ops import attn_decode_cuda as K
from fcl_taco2_tpu_torch.ops.masking import lengths_to_non_pad_mask
from fcl_taco2_tpu_torch.utils import spans
from fcl_taco2_tpu_torch.utils.cuda_build import cached_pack, kernel_seed
from fcl_taco2_tpu_torch.utils.device import resolve_device
from fcl_taco2_tpu_torch.utils.spans import span


@dataclass(frozen=True)
class Tacotron2Config:
    """espnet's Tacotron2 options (the v3 LJSpeech recipe's values as
    defaults).  ``aconv_filts`` is the location filter's half width (taps
    2 aconv_filts + 1).  ``compute_dtype`` is the encoder's and postnet's
    type and the decoder loop's weight type."""
    idim: int
    odim: int = 80
    embed_dim: int = 512
    elayers: int = 1
    eunits: int = 512
    econv_layers: int = 3
    econv_chans: int = 512
    econv_filts: int = 5
    use_residual: bool = False
    dlayers: int = 2
    dunits: int = 1024
    prenet_layers: int = 2
    prenet_units: int = 256
    postnet_layers: int = 5
    postnet_chans: int = 512
    postnet_filts: int = 5
    use_batch_norm: bool = True
    use_concate: bool = True
    reduction_factor: int = 1
    dropout_rate: float = 0.5
    zoneout_rate: float = 0.1
    atype: str = "location"
    adim: int = 512
    aconv_chans: int = 32
    aconv_filts: int = 15
    cumulate_att_w: bool = True
    threshold: float = 0.5
    minlenratio: float = 0.0
    maxlenratio: float = 10.0
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        supported = dict(atype="location", dlayers=2, prenet_layers=2,
                         reduction_factor=1, use_concate=True,
                         cumulate_att_w=True)
        for k, v in supported.items():
            if getattr(self, k) != v:
                raise ValueError(f"Tacotron2 here takes {k}={v!r}, got "
                                 f"{getattr(self, k)!r}")
        if self.elayers < 1 or not 0.0 < self.threshold < 1.0:
            raise ValueError("Tacotron2 needs elayers >= 1 and a threshold "
                             "in (0, 1)")


class T2Decoder(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        H, E = cfg.dunits, cfg.eunits
        self.att = AttLoc(E, H, cfg.adim, cfg.aconv_chans, cfg.aconv_filts,
                          device=device)
        self.prenet = C.Prenet(cfg.odim, cfg.prenet_layers, cfg.prenet_units,
                               device=device)
        self.lstm = nn.ModuleList(
            nn.LSTMCell(E + cfg.prenet_units if i == 0 else H, H,
                        device=device) for i in range(cfg.dlayers))
        self.feat_out = nn.Linear(H + E, cfg.odim, bias=False, device=device)
        self.prob_out = nn.Linear(H + E, 1, device=device)
        self.postnet = C.ConvBNStack(
            cfg.postnet_layers, cfg.odim, cfg.postnet_chans, cfg.odim,
            cfg.postnet_filts, last_is_out=True, use_bn=cfg.use_batch_norm,
            device=device)


def _init_(model, seed):
    """Seeded parameters: the embedding N(0, 1) with its padding row zero,
    BatchNorm as built, every other tensor U(+-1/sqrt(fan_in))."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".bns." in name:
                continue
            if name == "encoder.embed.weight":
                x = torch.randn(p.shape, generator=gen)
                x[0] = 0.0
            else:
                fan = p.shape[1:].numel() if p.dim() > 1 else p.shape[0]
                x = (torch.rand(p.shape, generator=gen) * 2 - 1) \
                    / math.sqrt(fan)
            p.copy_(x)


class Tacotron2(nn.Module):
    """Tacotron2 with location-sensitive attention, inference.  ``device``
    defaults to the card; ``device="cpu"`` runs the plain PyTorch path."""

    def __init__(self, cfg, device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg, device=dev)
        self.decoder = T2Decoder(cfg, device=dev)
        _init_(self, seed)
        self.eval()

    @property
    def device(self):
        return self.decoder.feat_out.weight.device

    def compute_model(self):
        """This model with its parameters in ``cfg.compute_dtype``."""
        return _cast_floats(self, getattr(torch, self.cfg.compute_dtype))

    def packed_decoder(self):
        """The loop's weights packed for the kernel once, until the
        decoder's parameters change."""
        return cached_pack(self, "attn", self.decoder.parameters(),
                           lambda: K.pack_attn_weights(
                               K.decoder_weights(self.decoder)))

    @torch.no_grad()
    def synthesize(self, tokens, ilens, rng, frame_budget: int,
                   lengths=None, with_att=False):
        """Batched synthesis on the model's device.

        Args:
            tokens: (B, Tmax) int (PAD=0); ilens: (B,) lengths.
            rng: int seed, ``torch.Generator`` or a (1,) int32 tensor, the
                prenet dropout's seed itself.
            frame_budget: the frames a row may have (the output's length).
            lengths: optional (B,) int: each row's frames, pinned
                (espnet's minlen = maxlen); else each row stops at its
                stop token within ``minlenratio`` and ``maxlenratio``.
            with_att: return the attention weights (B, budget, Tmax).
        Returns dict(mel (B, budget, odim) f32, olens (B,), stop (B,
        budget) logits, steps (1,): the loop's steps, att).

        Nothing is read back to the host on the card and every shape is
        static, so a CUDA graph captures the call (``infer/synth.py``).
        Spans (``utils/spans.py``): ``serve.frontend`` (the encoder and
        the memory's projection), ``serve.decoder`` (the loop),
        ``serve.postnet`` (the postnet and the mask); counters ``ar.steps``
        (the loop's steps) and ``ar.frames`` (the frames kept).
        """
        m = self.compute_model()
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        dev = m.device
        with span("serve.frontend"):
            hs = encoder_apply(m.encoder, cfg, tokens, ilens)
            pe = project_memory(m.decoder.att, hs)
        with span("serve.decoder"):
            seed = kernel_seed(rng, dev)
            lo, hi = K.length_bounds(ilens, frame_budget, lengths,
                                     cfg.minlenratio, cfg.maxlenratio)
            res = K.attn_decode(
                K.decoder_weights(m.decoder), hs, pe, ilens, lo, hi, seed,
                budget=frame_budget, zoneout=cfg.zoneout_rate,
                dropout=cfg.dropout_rate,
                thr_logit=math.log(cfg.threshold / (1.0 - cfg.threshold)),
                weights_dtype=dtype,
                packed=m.packed_decoder() if hs.is_cuda else None,
                with_att=with_att)
        spans.count("ar.steps", res["steps"])
        spans.count("ar.frames", res["olens"])
        with span("serve.postnet"):
            olens = res["olens"].to(torch.int64)
            seq_mask = lengths_to_non_pad_mask(olens, frame_budget)
            after = apply_postnet_inference(m.decoder, cfg,
                                            res["out"].to(dtype),
                                            seq_mask=seq_mask)
            after = after * seq_mask[..., None].to(after.dtype)
        return {"mel": after.float(), "olens": olens, "stop": res["stop"],
                "steps": res["steps"], "att": res["att"]}

    # ---- what ``infer/synth.py::Synthesizer`` asks of the model it serves

    def serve_options(self, quantize="none", decoder_backend="auto",
                      ragged_decode=True, sharded=False):
        """No serving keywords: the loop has one route, unquantized, and
        its answer is not split over ranks."""
        if quantize != "none" or sharded:
            raise ValueError("Tacotron2 is served unquantized on one card")
        return {}

    def serve_plan(self, token_lists, lengths, rows, Tmax, d_factor,
                   frame_per_token):
        """(frames the batch needs, True, the pinned lengths padded to
        (rows,) int32): the longest pinned length, else the most a stop
        token may take (``maxlenratio`` times the phonemes), so the budget
        is never short."""
        if d_factor != 1.0:
            raise ValueError("Tacotron2 takes no speaking rate")
        pinned = np.zeros(rows, np.int32)
        if lengths is None:
            return (max(int(len(t) * self.cfg.maxlenratio)
                        for t in token_lists), True, pinned)
        pinned[:len(lengths)] = lengths
        return int(max(lengths)), True, pinned

    def serve(self, tokens, ilens, rng, frame_budget, targets, d_factor):
        """``synthesize`` with ``targets`` as the pinned lengths
        (``d_factor`` is 1, as ``serve_plan`` holds)."""
        return self.synthesize(tokens, ilens, rng, frame_budget,
                               lengths=targets)
