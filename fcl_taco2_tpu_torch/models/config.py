"""Model hyperparameter schema (the port's own copy of
``fcl_taco2_tpu/models/config.py``: same fields, properties and
validation, so a ``model.json`` loads in both packages).

Knob names mirror the reference CLI flags (tts_train.py:22-372 and
nets/teacher_training/e2e_tts_tacotron2_sa.py:138-287) so the yaml configs in
conf/ stay interchangeable.  Teacher defaults == conf/
train_pytorch_tacotron2.sa.yaml; the student overrides dims to 256/128
(conf/train_pytorch_tacotron2.sa.student.yaml).

Pitch/energy predictor dims are hard-coded in the reference ctor
(e2e_tts_tacotron2_sa.py:419-451); here they are explicit fields with those
values as defaults.
"""

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    idim: int  # vocabulary size (phonemes incl. PAD=0)
    odim: int = 80  # mel bins

    # encoder (encoder_sa.py:23-37)
    embed_dim: int = 512
    elayers: int = 1
    eunits: int = 512
    econv_layers: int = 3
    econv_chans: int = 512
    econv_filts: int = 5
    use_residual: bool = False

    # decoder (decoder_sa.py:303-322)
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

    # regularization
    dropout_rate: float = 0.5
    zoneout_rate: float = 0.1
    # zoneout mask generator: 'rbg' lowers to XLA RngBitGenerator (the TPU
    # hardware PRNG) and generates all 2*dlayers step masks in one call —
    # measured ~20% off the teacher decoder train scan vs per-mask threefry
    # (results/PALLAS_decoder.json train_scan_experiments); 'threefry' keeps
    # jax's default counter-based stream (bit-reproducible across backends)
    zoneout_rng: str = "rbg"

    # losses (e2e_tts_tacotron2_sa.py:26-82: use_masking gates the mel and
    # pitch/energy criteria; the duration loss is always masked, :560-565)
    use_masking: bool = True
    use_weighted_masking: bool = False

    # duration predictor (espnet DurationPredictor wiring,
    # e2e_tts_tacotron2_sa.py:406-414)
    duration_predictor_layers: int = 2
    duration_predictor_chans: int = 384
    duration_predictor_kernel_size: int = 3
    duration_predictor_dropout_rate: float = 0.1
    duration_predictor_offset: float = 1.0

    # prosody conditioning (e2e_tts_tacotron2_sa.py:416-471)
    use_fe_condition: bool = True
    append_position: bool = True
    pitch_predictor_layers: int = 2
    pitch_predictor_chans: int = 384
    pitch_predictor_kernel_size: int = 3
    pitch_predictor_dropout_rate: float = 0.5
    pitch_embed_kernel_size: int = 9
    pitch_embed_dropout_rate: float = 0.5
    energy_predictor_layers: int = 2
    energy_predictor_chans: int = 384
    energy_predictor_kernel_size: int = 3
    energy_predictor_dropout_rate: float = 0.5
    energy_embed_kernel_size: int = 9
    energy_embed_dropout_rate: float = 0.5

    # optional multi-speaker conditioning (e2e_tts_tacotron2_sa.py:555-557:
    # L2-normalized speaker embedding concatenated to encoder outputs)
    spk_embed_dim: int = 0  # 0 = single speaker (reference default None)

    # static shape budget: max frames per phoneme segment
    # (reference caps at 50, preprocess.py:203)
    max_dur: int = 50

    # duration-classed training decoder (SURVEY hard part #1 dual
    # bucketing): ascending per-class duration caps; a segment scans only
    # its class's cap instead of max_dur (mean LJSpeech duration is ~8
    # frames vs the 50 cap, so the single-class scan wastes ~84% of its
    # steps on padding).  () = single-class (exact legacy shapes); the last
    # entry is implicitly max_dur.  Losses are exactly equal either way
    # (per-segment recurrences are independent; padding is never read).
    duration_classes: tuple = ()

    # numerics: 'bfloat16' runs matmuls in bf16 on the MXU (losses, BN and
    # softmax-free reductions stay fp32); 'float32' for parity tests.
    compute_dtype: str = "bfloat16"

    # rematerialize the decoder scan step on backward: trades ~1 extra
    # forward of the step for O(D) less saved activation memory (enables
    # ~2x larger batches; jax.checkpoint per SURVEY HBM guidance)
    remat_decoder: bool = False

    # custom-VJP decoder backward ("strategy B" of results/
    # PALLAS_decoder.json train_kernel_roofline): the teacher-forced scan
    # saves (gates, h, c) per step, the backward is a reverse scan carrying
    # only (dh, dc), and ALL weight gradients are post-scan batched GEMMs
    # (ops/rnn_vjp.py) — instead of XLA's scan transpose, which
    # read-modify-writes the (3H,4H) fp32 dW accumulators in HBM every
    # step (measured 19.85 ms backward vs a 10.07 ms bound at B=16).
    # Loss-neutral (identical forward math); gradients equal autodiff to
    # reduction-order. Ignored when remat_decoder asks for the autodiff
    # path explicitly.
    decoder_custom_vjp: bool = True

    # unroll factor of the teacher-forced decoder scan(s).  Under the
    # custom VJP (default) it unrolls BOTH the forward and reverse scans,
    # amortizing per-iteration loop overhead without touching weight
    # gradients (those are post-scan GEMMs).  Under the autodiff path
    # (decoder_custom_vjp=False / remat) it also amortizes the scan
    # transpose's per-step (3H,4H) fp32 dW accumulator traffic — but
    # measured SLOWER there at 4/8 (bytes_accessed grows with unroll,
    # results/PALLAS_decoder.json decoder_scan_unroll).  Loss-neutral
    # (same math, same RNG streams).
    decoder_scan_unroll: int = 1

    def __post_init__(self):
        """Every field is either honored or loudly rejected — a config must
        never lie (silently-ignored knobs were a round-1 defect)."""
        if self.elayers < 0 or self.econv_layers < 0:
            raise ValueError("elayers/econv_layers must be >= 0")
        if self.elayers > 0 and self.eunits % 2 != 0:
            raise ValueError("eunits must be even (eunits//2 per direction, "
                             "encoder_sa.py:96-99)")
        if self.elayers == 0 and self.econv_layers == 0:
            raise ValueError("encoder needs at least convs or a BiLSTM")
        if self.dlayers < 1:
            raise ValueError("dlayers must be >= 1 (decoder_sa.py:360)")
        if self.reduction_factor < 1:
            raise ValueError("reduction_factor must be >= 1")
        if self.max_dur % self.reduction_factor != 0:
            raise ValueError(
                f"max_dur ({self.max_dur}) must be divisible by "
                f"reduction_factor ({self.reduction_factor}): the decoder "
                "emits reduction_factor frames per step over a static "
                "max_dur frame bucket")
        if self.prenet_layers < 0 or self.postnet_layers < 0:
            raise ValueError("prenet_layers/postnet_layers must be >= 0")
        if self.use_masking and self.use_weighted_masking:
            raise ValueError("use_masking and use_weighted_masking are "
                             "mutually exclusive (e2e_tts_tacotron2_sa.py:39)")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype}")
        if self.zoneout_rng not in ("rbg", "threefry"):
            raise ValueError(f"unsupported zoneout_rng {self.zoneout_rng} "
                             "(choose 'rbg' or 'threefry')")
        # normalize to a tuple so a model.json round trip (json lists)
        # compares equal to the constructed config
        dc = tuple(int(d) for d in self.duration_classes)
        object.__setattr__(self, "duration_classes", dc)
        if list(dc) != sorted(set(dc)):
            raise ValueError(
                f"duration_classes must be strictly ascending, got {dc}")
        if dc and (dc[0] < 1 or dc[-1] > self.max_dur):
            raise ValueError(
                f"duration_classes must lie in [1, max_dur={self.max_dur}] "
                f"(the top class is implicitly max_dur), got {dc}")
        if any(d % self.reduction_factor
               for d in self.effective_duration_classes):
            raise ValueError(
                f"every duration class must be divisible by "
                f"reduction_factor ({self.reduction_factor}), got {dc}")
        if self.spk_embed_dim < 0:
            raise ValueError("spk_embed_dim must be >= 0")

    @property
    def effective_duration_classes(self):
        """Normalized class caps: user tuple with max_dur appended as the
        implicit top class; () stays () (single-class legacy path)."""
        dc = tuple(int(d) for d in self.duration_classes)
        if dc and dc[-1] != self.max_dur:
            dc = dc + (self.max_dur,)
        return dc

    @property
    def enc_odim(self):
        """Encoder output width: eunits after the BiLSTM; with elayers=0 the
        conv (or embedding) output passes straight through
        (encoder_sa.py:96-99, 144-145)."""
        if self.elayers > 0:
            return self.eunits
        return self.econv_chans if self.econv_layers > 0 else self.embed_dim

    @property
    def dec_idim(self):
        return self.enc_odim + self.spk_embed_dim

    @property
    def effective_prenet_units(self):
        """prenet_layers=0 feeds the raw previous frame to the LSTM
        (decoder_sa.py:358, 497: prenet_units falls back to odim)."""
        return self.prenet_units if self.prenet_layers > 0 else self.odim

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def teacher_config(idim, **overrides):
    """FCL-taco2-T (conf/train_pytorch_tacotron2.sa.teacher.yaml)."""
    return ModelConfig(idim=idim, **overrides)


def student_config(idim, **overrides):
    """FCL-taco2-S (conf/train_pytorch_tacotron2.sa.student.yaml:
    everything 256, postnet 128, dunits 256)."""
    base = dict(
        embed_dim=256, eunits=256, econv_chans=256, dunits=256,
        prenet_units=256, postnet_chans=128,
    )
    base.update(overrides)
    return ModelConfig(idim=idim, **base)
