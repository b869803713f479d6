"""Operations and bytes of FCL-taco2 from a configuration's widths and an
utterance's real lengths.

Operations are the multiply-adds of every matrix product and convolution,
two operations each; elementwise work is not counted.  Lengths are the
inputs' own: ``L`` phonemes, ``frames`` the sum of the durations.  Padding,
the unused part of a frame budget and whatever tiling a kernel picks are
not counted, so a count moves only when the inputs move.
"""


def _conv(cin, cout, width):
    return 2 * cin * cout * width


def _lstm_step(inp, hidden):
    return 2 * (inp + hidden) * 4 * hidden


def encoder_flops(mc, L):
    """Embedding (no products), the convolutions, the BiLSTM."""
    f, cin = 0, mc["embed_dim"]
    for _ in range(mc["econv_layers"]):
        f += L * _conv(cin, mc["econv_chans"], mc["econv_filts"])
        cin = mc["econv_chans"]
    h = mc["eunits"] // 2
    for _ in range(mc["elayers"]):
        f += 2 * L * _lstm_step(cin, h)
        cin = mc["eunits"]
    return f


def _predictor(mc, prefix, L):
    f, cin = 0, mc["eunits"]
    chans, k = mc[prefix + "_chans"], mc[prefix + "_kernel_size"]
    for _ in range(mc[prefix + "_layers"]):
        f += L * _conv(cin, chans, k)
        cin = chans
    return f + L * 2 * chans


def adaptor_flops(mc, L, predict_durations=False):
    """The predictors and the pitch and energy embeddings (the duration
    predictor only where durations are predicted)."""
    f = _predictor(mc, "duration_predictor", L) if predict_durations else 0
    if mc["use_fe_condition"]:
        f += _predictor(mc, "pitch_predictor", L)
        f += _predictor(mc, "energy_predictor", L)
        f += L * _conv(1, mc["eunits"], mc["pitch_embed_kernel_size"])
        f += L * _conv(1, mc["eunits"], mc["energy_embed_kernel_size"])
    return f


def decoder_segment_flops(mc):
    """A phoneme segment's step-invariant products: its encoder vector's
    share of the first LSTM's gates and of the output projection."""
    return 2 * mc["eunits"] * (4 * mc["dunits"] + mc["odim"])


def decoder_step_flops(mc):
    """One frame of one segment in the AR loop: the prenet, the first
    LSTM's prenet, position and recurrent products, the second LSTM, the
    output projection."""
    U, H, O = mc["prenet_units"], mc["dunits"], mc["odim"]
    prenet = 2 * (O * U + U * U)
    lstm0 = 2 * (U + 1 + H) * 4 * H
    lstm1 = 2 * (H + H) * 4 * H
    return prenet + lstm0 + lstm1 + 2 * H * O


def decoder_loop_bytes(mc, n_segments, frames, weight_bytes):
    """Least bytes of the AR loop kernel: its weight matrices once (in
    ``weight_bytes`` an element), each segment's gate and output vectors
    read once (fp32), each frame written once (fp32)."""
    U, H, O = mc["prenet_units"], mc["dunits"], mc["odim"]
    weights = O * U + U * U + U * 4 * H + 3 * H * 4 * H + H * O
    return (weights * weight_bytes + n_segments * (4 * H + O + 1) * 4
            + frames * O * 4)


def postnet_flops(mc, frames):
    f, cin = 0, mc["odim"]
    for i in range(mc["postnet_layers"]):
        cout = mc["odim"] if i == mc["postnet_layers"] - 1 \
            else mc["postnet_chans"]
        f += frames * _conv(cin, cout, mc["postnet_filts"])
        cin = cout
    return f


def synth_flops(mc, L, frames, predict_durations=False):
    """Text -> mel of one utterance: ``L`` phonemes, ``frames`` frames."""
    return (encoder_flops(mc, L) + adaptor_flops(mc, L, predict_durations)
            + L * decoder_segment_flops(mc)
            + frames * decoder_step_flops(mc) + postnet_flops(mc, frames))
