"""``benchmark/counts`` against operations and bytes counted by hand at a
tiny shape."""

from benchmark.counts import peaks, pwg, taco2

MC = {"embed_dim": 4, "econv_layers": 1, "econv_chans": 6, "econv_filts": 3,
      "elayers": 1, "eunits": 8, "dunits": 5, "prenet_units": 3, "odim": 2,
      "postnet_layers": 2, "postnet_chans": 7, "postnet_filts": 3,
      "use_fe_condition": True,
      "duration_predictor_layers": 1, "duration_predictor_chans": 3,
      "duration_predictor_kernel_size": 3,
      "pitch_predictor_layers": 1, "pitch_predictor_chans": 3,
      "pitch_predictor_kernel_size": 3,
      "energy_predictor_layers": 2, "energy_predictor_chans": 2,
      "energy_predictor_kernel_size": 1,
      "pitch_embed_kernel_size": 3, "energy_embed_kernel_size": 1}

VC = {"layers": 2, "stacks": 1, "residual_channels": 2, "gate_channels": 4,
      "skip_channels": 3, "aux_channels": 2, "kernel_size": 3,
      "upsample_scales": [2, 3], "aux_context_window": 1}


def test_taco2_counts_by_hand():
    L, frames = 3, 10
    enc = L * 2 * 4 * 6 * 3 + 2 * L * 2 * (6 + 4) * 16  # conv + BiLSTM h=4
    assert taco2.encoder_flops(MC, L) == enc
    pitch = L * 2 * 8 * 3 * 3 + L * 2 * 3
    energy = L * (2 * 8 * 2 * 1 + 2 * 2 * 2 * 1) + L * 2 * 2
    embeds = L * 2 * 8 * 3 + L * 2 * 8 * 1
    assert taco2.adaptor_flops(MC, L) == pitch + energy + embeds
    dur = L * 2 * 8 * 3 * 3 + L * 2 * 3
    assert taco2.adaptor_flops(MC, L, True) == pitch + energy + embeds + dur
    step = 2 * (2 * 3 + 3 * 3) + 2 * (3 + 1 + 5) * 20 + 2 * 10 * 20 \
        + 2 * 5 * 2
    assert taco2.decoder_step_flops(MC) == step
    assert taco2.decoder_segment_flops(MC) == 2 * 8 * (20 + 2)
    post = frames * (2 * 2 * 7 * 3 + 2 * 7 * 2 * 3)
    assert taco2.postnet_flops(MC, frames) == post
    assert taco2.synth_flops(MC, L, frames) == (
        enc + pitch + energy + embeds + L * 2 * 8 * 22 + frames * step
        + post)
    weights = 2 * 3 + 3 * 3 + 3 * 20 + 3 * 5 * 20 + 5 * 2
    assert taco2.decoder_loop_bytes(MC, 4, frames, 2) == (
        2 * weights + 4 * (20 + 2 + 1) * 4 + frames * 2 * 4)


def test_pwg_counts_by_hand():
    block = 2 * 2 * 4 * 3 + 2 * 2 * 4 + 2 * 2 * 3 + 2 * 2 * 2
    assert pwg.stack_flops_per_sample(VC) == 2 * 2 + 2 * block + 2 * 9 + 2 * 3
    assert pwg.hop(VC) == 6
    frames = 5
    up = frames * 2 * 2 * 2 * 3 + 10 * 2 * 2 * 5 + 30 * 2 * 2 * 7
    assert pwg.upsample_flops(VC, frames) == up
    assert pwg.vocode_flops(VC, frames) == up + 30 * \
        pwg.stack_flops_per_sample(VC)
    w = 2 * 2 + 2 * (2 * 4 * 3 + 4 + 2 * 4 + 2 * 5 + 3 + 2) + 9 + 3 + 3 + 1
    assert pwg.stack_bytes(VC, 30) == 4 * w + 30 * 4 * 4


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(989e12, 0, peaks.BF16_FLOPS) == 1.0
    assert peaks.bound_s(0, 3.35e12, peaks.BF16_FLOPS) == 1.0
    assert peaks.FP32_3XTF32_FLOPS == 165e12
