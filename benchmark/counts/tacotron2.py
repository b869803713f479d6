"""Operations and bytes of Tacotron2 with location-sensitive attention
from a configuration's widths and an utterance's real lengths, counted as
``counts/taco2.py`` counts (two operations a multiply-add of every matrix
product and convolution, elementwise work left out, the inputs' own
lengths only: ``L`` phonemes, ``frames`` the frames kept).  The attention
is counted as the model states it: the location convolution, then its
projection."""

from benchmark.counts.taco2 import encoder_flops, postnet_flops


def memory_flops(mc, L):
    """The encoder memory's projection ``enc @ W_enc``, once a call."""
    return 2 * L * mc["eunits"] * mc["adim"]


def attention_position_flops(mc):
    """One position's share of a step's attention: the location
    convolution and its projection, the dot with ``gvec``, the context."""
    C, A = mc["aconv_chans"], mc["adim"]
    taps = 2 * mc["aconv_filts"] + 1
    return 2 * C * taps + 2 * C * A + 2 * A + 2 * mc["eunits"]


def decoder_step_flops(mc, L):
    """One frame of one utterance of ``L`` phonemes: the query, the
    attention over its positions, the prenet, both LSTM cells, feat_out and
    prob_out."""
    H, E, U, O = mc["dunits"], mc["eunits"], mc["prenet_units"], mc["odim"]
    query = 2 * H * mc["adim"]
    prenet = 2 * (O * U + U * U)
    lstm0 = 2 * (E + U + H) * 4 * H
    lstm1 = 2 * (H + H) * 4 * H
    out = 2 * (H + E) * (O + 1)
    return (query + L * attention_position_flops(mc) + prenet + lstm0
            + lstm1 + out)


def decoder_loop_bytes(mc, utts, weight_bytes):
    """Least bytes of the loop kernel for ``utts`` ((phonemes, frames) a
    utterance): its weights once (``weight_bytes`` an element), each
    utterance's memory and projection read once (bf16 and fp32), each
    frame and stop logit written once (fp32)."""
    H, E, U, O = mc["dunits"], mc["eunits"], mc["prenet_units"], mc["odim"]
    C, A = mc["aconv_chans"], mc["adim"]
    taps = 2 * mc["aconv_filts"] + 1
    weights = (H * A + C * taps + C * A + A + O * U + U * U
               + (E + U + H) * 4 * H + 2 * H * 4 * H + (H + E) * (O + 1))
    per_utt = sum(L * (E * 2 + A * 4) + f * (O + 1) * 4 for L, f in utts)
    return weights * weight_bytes + per_utt


def synth_flops(mc, L, frames):
    """Text -> mel of one utterance: ``L`` phonemes, ``frames`` frames."""
    return (encoder_flops(mc, L) + memory_flops(mc, L)
            + frames * decoder_step_flops(mc, L)
            + postnet_flops(mc, frames))
