"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and
prints no result):

1. Device: name and power limit (nvidia-smi), TF32 switches off.
2. Build: ``csrc/ar_decode.cu``, ``csrc/pwg_stream.cu``,
   ``csrc/regroup.cu``, ``csrc/attn_decode.cu`` and ``csrc/blstm.cu``
   with nvcc for sm_90a,
   and ``csrc/fclrt.cpp`` (the plan builder) with g++, from the checkout,
   the compilers started together.
3. Decoder kernels vs plain versions on the card, full width, dropout 0:
   ``fused_ar_decode`` (student weights; fp32, bf16) and
   ``fused_ar_decode_hbm`` (teacher weights; bf16, int8), P = 96 and
   2048, ragged on and off, and the streamed mode (teacher weights in
   fp32, P = 96 ragged); max abs error against the stated tolerance; the
   launch's mode (weights stationary in shared memory or streamed), grid,
   cluster, shared memory a block, grid barriers a step; median ms of the
   kernel alone (packed weights, prepared operands) and of the call, us a
   step, plain ms, bound; and the batch-16 decode (P = 1536) alone.
4. Dropout statistics of the kernel's Philox draws.
5. PWG kernels vs plain versions at ``PWGConfig()`` (PWG v1): one-shot
   ``pwg_generate_streaming`` at B=1, Tm=1536 (the text -> wav path's
   budget) and B=8, Tm=512, timed as the kernel alone (prepared aux,
   packed weights) and as the whole call (upsample + launch), and the
   kernel alone at B=16, Tm=1536 (no plain version: minutes);
   ``pwg_stream_step`` chained in Vh=4096 chunks over the B=1 utterance,
   each step against its plain version and the chain bit-equal to the
   one-shot kernel; a step timed alone and ten back to back.  Each
   launch's grid, block tiles and grid barriers are logged, and the
   card's clocks (NVML) beside each kernel's time; bounds at the TF32
   tensor cores (3 passes) beside fp32.
5b. The regroup gathers' backward (``[regroup]``, after ``[pwg]``):
   ``csrc/regroup.cu`` against its plain version (autograd's indexing
   backward, ``index_put_`` with accumulation) on the eight gathers of a
   KD step at the training cells' shapes (batch 64, Lmax 1,024, classes
   (8, 16, 32, 50): four token gathers at 256 and scatters at 80 and
   3 x 256, bf16), bit-equal with the padded positions' gradients zero;
   the card's ms of each (calls queued behind a sleep, so the host's
   launch stays out) beside its bound (bytes once).
5c. Tacotron2's attention decode kernel (``[attn_decode]``, after
   ``[regroup]``): ``csrc/attn_decode.cu`` at the published widths of
   ``benchmark/configs/tacotron2-ljspeech.json`` (bf16 weights) on a
   batch of ``tacotron2-synth-b16``'s shapes (B=16 of 12..112 phonemes,
   T=128, lengths pinned to Poisson(8) durations' sums, up to ~950 steps,
   dropout 0.5) against its plain version on the same card inputs
   (lengths and steps exact, frames, stop logits and attention weights
   within ``TOL_ATTN``, and the plain version without the location term
   beyond it); the kernel's ms beside the plain version's and the bound
   the benchmark's roofline counts; ``Synthesizer``'s replays, the
   counter zeroed just before them, one launch each (of the attention
   kernel and of the serving BiLSTM's).
5d. The serving encoder's BiLSTM (``[blstm]``, after ``[attn_decode]``):
   ``csrc/blstm.cu`` against its plain version (``ops/rnn.py::bilstm``,
   the loop) on the same card inputs at the synth cells' shapes (B=16,
   H=256, Tmax 96 and 128, the lengths of a call of 12..112 phonemes) and
   the tts cell's (B=1, H=128, 96 phonemes), bf16: the largest gap within
   ``TOL_BLSTM`` and the share of bit-equal values; the call's ms (queued
   behind a sleep) beside its bound (bytes once: both W_hh, both
   directions' xproj and the output, over 3.35 TB/s), the loop's ms on
   the same inputs, PyTorch's one library call for the same function
   (``nn.LSTM(bidirectional=True)`` over ``pack_padded_sequence``, cuDNN;
   the kernels line's ``library_ms``) and the serial-step floor (the same
   call at H=6, B=1 and the same steps: what the chain of steps costs
   with no work in them); then a teacher ``Synthesizer`` at batch 16, the counter zeroed
   after its capture: one launch a replay, and ``blstm.steps`` the
   batch's longest row each replay.  Every main path below logs its
   ``bilstm_infer`` launches; the training steps launch none (their
   evaluations do).
6. Main paths, with the headline benchmark's protocol (bench.py: idim 70,
   odim 80, 96 phonemes, Poisson(8) durations clipped to [1, 50], seed 0,
   durations given), seeded full-width weights, bf16 compute.  Text ->
   mel: ``Synthesizer.synth_batch`` for teacher batch 1, teacher batch
   16, teacher batch 1 int8, student batch 1, and teacher batch 16 with
   ``decoder_backend="hybrid"`` and ``"scan"`` beside ``auto`` (frames/s
   of each; at dropout 0 hybrid's mels within 2e-3 of auto's, or no
   further than the scan's).  Text -> wav:
   ``TTSPipeline.tts_batch`` for student batch 1, teacher batch 1,
   teacher batch 16 (RTF).  Streaming: ``StreamTTS`` for the student
   (time to first audio, x realtime), and its exactness against
   synthesize + the one-shot kernel at dropout 0, fp32.  Launch counters
   are zeroed just before each case's main-path call and must be non-zero
   after it.  Reference checkpoints (``[import]``, after the text -> mel
   cases): the seeded teacher exported to the reference's keys
   (``export_reference_state_dict``), saved as an amp checkpoint with
   DataParallel ``module.`` prefixes and loaded into a fresh model
   (``load_reference_checkpoint``); its batch-1 ``synthesize`` (bf16,
   dropout 0) must equal the source model's (``torch.equal``) through
   ``fused_ar_decode_hbm``, counted like the cases above.  On the card
   ``Synthesizer``, ``TTSPipeline`` and ``StreamTTS`` replay CUDA graphs
   (``utils/graphs.py``); their launch counts include every replay.
6b. Compiled execution (``[compiled]``, after ``[stream]``): each CUDA
   graph against the same call run eagerly, bit for bit, for the same
   generator state: the teacher_b1, teacher_b16, teacher_b1_int8 and
   student_b1 mels (the capture must hold the decoder's cluster launch),
   a re-dispatch from a saved state, two states that must differ, the
   prenet keep rate of 8 replays' seeds (within 4 standard errors), the
   tts_student_b1 wav and every stream_student chunk; batch-1 ms eager
   beside graphed with the frontend / decode / rest split, RTF and time
   to first audio both ways, each graph's capture seconds, pool MiB and
   replays.  Then, under deterministic algorithms (fp32, TF32 off), 4
   graphed single train steps and eval steps of FCL-taco2-T on device
   cache batches and 4 graphed KD steps (remat on and off) and KD eval
   steps against eager ones from the same state: losses, reports and
   every parameter and buffer bit-equal; and the graphed bf16 single
   step's time (the chain's is ``[graph]``'s).  Between the two, the
   paths graphed last (``compiled_routes``), each bit-equal to its eager
   call with both times: teacher_b16 on the ``scan`` and ``hybrid``
   routes (dropout 0.5), the scan's loop to ``max_dur`` timed against the
   loop cut at the batch's bound, ``fcl_vocode``'s bucket, a
   ``vocode_chunked`` utterance and one preprocessing bucket.  ``scripts/
   torch_compiled_phase.py`` runs this phase alone.
6c. The bench scripts (``[bench]``, after ``[compiled]``): each card
   script, loaded from its file, and its ``smoke()``
   (``scripts/torch_bench.py``, ``torch_bench_kd``,
   ``torch_bench_stream``, ``torch_bench_train_loop``, ``torch_bench_pwg``,
   ``torch_bench_decoder``, ``torch_train_roofline``: their measurement
   functions at full width, one reading each, as ``--smoke`` runs them);
   every row must name this card and its power limit and every timing in
   it (median, min, max) be finite and positive, and the launch counters,
   zeroed before the first script, must show all five kernels launched by
   the bench paths.  The timers are ``fcl_taco2_tpu_torch/utils/
   timing.py``'s and the bench batch ``utils/bench_protocol.py``'s,
   which this script imports too.
7. Training (``[train]``), after the serving paths; no decoder or PWG
   kernel may launch in it (the JAX package has no Pallas kernel on the
   training path), and the regroup gathers' backward must (here and in
   every training phase below); the serving BiLSTM launches in no
   training step, only in the trainers' evaluations (``EvalStep`` calls,
   counted apart).  The hand-built
   decoder backward against autograd through the plain loop at
   FCL-taco2-T width (fp32, TF32 off,
   dropouts and zoneout 0, one 96-phoneme utterance, classed and
   single-class plans; loss within 1e-6, every gradient leaf within
   1e-4); the teacher train step at the bench protocol
   (bench.py:342-447: B=16, 96 phonemes, bf16, Adam lr 1e-3, clip 1.0;
   classes 8,16,32,50 and none):
   step ms by CUDA events (median of 10 after 3 warm-up), the
   synchronized forward / backward / optimizer split, frames/s, device
   busy time from a ``torch.profiler`` trace, peak memory, first and last
   loss; and ``fcl_train.main`` at FCL-taco2-S width on a learnable
   synthetic corpus, 2 epochs then a resume for a third (the loss falls,
   the resume starts at the saved step, the files restore, and the
   optimizer state restored from the snapshot, written back in optax's
   layout, equals the file's bit for bit: mu, nu and the counters).
8. Knowledge distillation (``[kd]``), no decoder or PWG kernel may
   launch: the KD loss with its captures through the hand-built backward
   and through checkpointed steps (remat) against autograd through the
   plain loop (FCL-taco2-S from FCL-taco2-T at full width, fp32, TF32 off,
   dropouts 0, one 96-phoneme utterance, classed and single-class; loss
   within 1e-6, gradient leaves within 1e-4); the KD step at
   scripts/bench_kd.py's protocol (B=16, 96 phonemes, Poisson(8)
   durations, seed 0, bf16, classes 8,16,32,50) with remat on and off,
   timed as the train step is, as the graph replay the trainer runs;
   ``fcl_train`` trains a full-width teacher
   for one epoch on the learnable corpus and ``fcl_train --perform-KD
   True`` distils the full-width student from it for 2 epochs (the loss
   falls, log.jsonl has the KD terms).
9. The CLIs (``[cli]``) on those two checkpoints, the launch counters
   zeroed before each call and the call's kernels required to launch;
   each timed call decodes the 49-utterance train manifest after a
   warm-up call on the 7-utterance validation manifest: ``fcl_synth``
   with corpus durations on the teacher (``fused_ar_decode_hbm``), the
   student (``fused_ar_decode``, twice with one seed: byte-equal arks)
   and the teacher with ``--quantize int8`` (7 batches of 8, one in
   flight; decode.txt's frames/s and batch walls); ``fcl_vocode`` on the
   student's feats.scp (``pwg_generate_streaming``); ``fcl_tts`` batch
   (``pwg_generate_streaming``) and ``--stream`` (``pwg_stream_step``) on
   a copy of the student whose duration predictor gives about 8 frames a
   phoneme; ``fcl_eval`` (finite MCD).  Frames/s, RTF and time to first
   audio as the CLIs print them.
10. The device cache and the chained train step (``[graph]``, after
   ``[train]``), FCL-taco2-T at full width, the bench batch protocol
   (B=16 utterances of 96 phonemes, Poisson(8) durations) through
   ``DeviceBatchCache``, classed (8,16,32,50) and single-class (its eager
   references are ``make_train_step(graphed=False)``); no
   decoder or PWG kernel may launch: 8 steps as 2 chains of 4 replays of
   one CUDA graph against 8 eager steps from the same state and seed
   (fp32, TF32 off, dropout and zoneout at their published rates,
   deterministic algorithms on: each loss within 1e-6 relative, every
   parameter and BatchNorm buffer within 1e-5 of max|a|, bit-equality
   printed), two consecutive single replays drawing different zoneout
   masks (read from the graph's own buffers through
   ``Decoder.mask_taps``) at the zoneout rate; the
   bf16 step eager against graphed (ms a step over 5 chains of 4 after
   one, min and max, device busy share of one profiled chain, capture
   seconds, graph pool, peak memory); and ``fcl_train`` with no runtime
   flags (the cache is built and 4 steps run a dispatch) against
   ``--device-cache off --steps-per-dispatch 1`` (graphed single steps)
   and ``--steps-per-dispatch 4``, epoch walls.  The
   native plan builder must be the converter's.
11. Fine-tuning (``[finetune]``, after ``[cli]``), no kernel but the
   regroup gathers' backward may launch:
   ``fcl_train`` FCL-taco2-T with ``--enc-init``/``--dec-init`` from the
   ``[kd]`` teacher, ``--freeze-mods enc.`` and ``--preprocess-conf``
   (utterance CMVN + a frequency mask), 2 epochs: the selected tensors
   equal the checkpoint's bit for bit after ``init_state``, the frozen
   parameters are bit-unchanged after the epochs and the others moved;
   then the student with ``--profile-dir``: the Chrome trace exists and
   holds CUDA kernel events.
12. Preprocessing (``[preprocess]``, after ``[finetune]``), no kernel but
   the training epoch's regroup gathers' backward may launch:
   ``audio/synthcorpus.generate_corpus`` writes 128 utterances
   (seed 0, 24-80 phones: ~6.5 s mean, LJSpeech-like lengths); the
   frontend (``Frontend``, default config) on the card against its CPU
   path on the same wavs (log10-mel 1e-4 abs, energy 1e-4 of the max,
   voicing equal on 99.9% of frames, f0 1 cent; flips printed); the
   port's ``yin_f0`` on CUDA tensors meets the F0 goldens' budgets
   (``tests/test_f0_goldens.py``'s, copied); ``fcl_preprocess --device
   cuda`` end to end (audio seconds per wall second, its five stages,
   the frontend's device ms per bucket, peak memory, the manifests'
   utterance counts) and one ``fcl_train`` epoch at FCL-taco2-S width on
   the manifests it wrote (finite loss).
13. The quality protocol in small (``[quality]``, after
   ``[preprocess]``, on its features: 112 training, 8 validation and 8
   test utterances): ``fcl_train`` trains FCL-taco2-T with its defaults
   (bf16, the device cache, graphed chains) for QUALITY_EPOCHS epochs at
   batch 16 (a chain of 4 and 3 single replays an epoch; the epoch walls
   are logged as ``[compiled]``'s);
   ``fcl_synth`` decodes the test utterances with ground-truth and
   predicted durations and with ground-truth durations in int8
   (``fused_ar_decode_hbm``), ``fcl_train --perform-KD True`` distils
   FCL-taco2-S for a few epochs and its decodes run ``fused_ar_decode``;
   ``fcl_eval`` scores each (MCD / L1 / RMSE), beside the two MCD floors
   and the predict-the-train-mean L1 (``scripts/torch_mcd_benchmark.py``'s
   ``floors``).  Fails unless the teacher's ground-truth-duration L1 is at
   most 0.9 x that L1 floor and its best validation loss is under half
   the first epoch's, or unless a decode's kernel did not launch (the
   counters zeroed before each decode).
14. Data parallel (``[parallel]``, after ``[quality]``): 2 ranks of
   ``parallel/_mp_worker.py --width full`` share card 0 over gloo (NCCL
   refuses two ranks on one device; this is no scaling measurement): the
   FCL-taco2-T fp32 step on the B=16 bench batch (8 utterances a rank,
   dropouts 0, Adam lr 1e-4) for 3 steps with a snapshot after 2, one KD
   step of FCL-taco2-S, sharded serving of both (2 bench utterances a
   rank, fp32 and bf16 compute, durations given; ``fused_ar_decode`` and
   ``fused_ar_decode_hbm`` must launch on both ranks) and synchronized
   BatchNorm; a fresh 2-rank run resumes the snapshot for 2 steps.
   Losses, grad norms and checksums are held to one process on the same
   global batch (rtol 2e-4); the mels at ``[kernel]``'s limit for the
   kernel's weight dtype (fp32 compute, against one process's batch of
   4) or for bf16 (bf16 compute, against one process decoding each
   rank's rows as a batch of 2, the batch of 4 logged beside it);
   BatchNorm at 1e-5; the all-reduced MiB, calls and ms a step are
   logged, and the ranks' reason for staying eager (gloo).  Then one
   NCCL rank in this process (a world of one process group, so the same
   data-parallel path, ``nccl_twins``): the fp32 teacher train and eval
   steps and the KD step (remat on and off) with its eval step, graphed
   with their all-reduces inside, against their ``graphed=False`` twins
   over 4 steps under deterministic algorithms (bit-equal, equal
   ``Mesh.stats`` calls and bytes a step) and the graphed losses against
   the undistributed steps (rtol 2e-4); the bf16 teacher and KD steps'
   ms graphed and eager (``nccl_bf16_timing``); sharded bf16 serving at
   batch 2 graphed against eager, bit for bit.
15. One JSON line of the kernels (launches: every main path above, the
   CLIs, ``[quality]``'s decodes and the ranks of ``[parallel]``
   included; ``attn_decode``'s from ``[attn_decode]``'s replays;
   ``bilstm_infer``'s from every serving path and evaluation), the
   nvidia-smi line,
   and last the result line
   ``{"ok": true, "device": {...}}``.  Each phase's seconds are logged
   (``[phase]``).
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fcl_taco2_tpu_torch.utils.bench_protocol import tf32, train_batch
from fcl_taco2_tpu_torch.utils.timing import (TF32_PASSES, bound_ms, busy_ms,
                                              clocks, device_busy_ms,
                                              device_events, host_median_ms,
                                              median_ms, timed, top_kernels)

IDIM, ODIM = 70, 80
N_PHONES, MEAN_DUR, MAX_DUR = 96, 8, 50
TOL_F32 = 1e-4
TOL_F32_WHY = ("fp32 products in another summation order than the "
               "plain version's GEMMs, carried through up to 50 AR steps")
TOL_BF16 = 2e-3
TOL_BF16_WHY = ("activations are rounded to bf16 before each product, so "
                "a last-bit difference in a sum can flip one rounding "
                "(2^-8 relative) that the AR feedback carries on")
TOL_PWG = 1e-4
TOL_PWG_WHY = ("fp32 products summed in another order than the plain "
               "version's GEMMs (or cuDNN's convs), through 30 residual "
               "layers")
TOL_STREAM = 1e-3
TOL_STREAM_WHY = ("fp32 model: the chunked decode, the windowed postnet and "
                  "the windowed upsampler sum in other orders than the "
                  "whole-utterance calls (cuDNN picks per length)")
SAMPLE_RATE = 22050


def log(*a):
    print(*a, flush=True)


def durations(rng, n):
    return np.clip(rng.poisson(MEAN_DUR, n), 1, MAX_DUR).astype(np.int32)


def segment_batch(cfg, P, seed, ragged):
    """Decoder inputs as synthesize builds them (sorted when ragged)."""
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    rng = np.random.default_rng(seed)
    dur = durations(rng, P)
    if ragged:
        dur = np.sort(dur)[::-1].copy()
    dur_t = torch.from_numpy(dur).cuda()
    d = torch.arange(cfg.max_dur, device="cuda")[None, :]
    fm = d < dur_t[:, None]
    pos = torch.where(fm, d.float() / dur_t[:, None].float(), 0.0)
    enc = torch.from_numpy(
        rng.normal(size=(P, cfg.dec_idim)).astype(np.float32)).cuda()
    bounds = K.tile_step_bounds(dur_t) if ragged else None
    return enc, pos, fm, bounds


def work(cfg, P, bounds, D, wdt, resident, bdt):
    """Least bytes and operations of one decode call at these inputs:
    every input read once, the output written once; the loop runs each
    row to its tile's bound."""
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    H, U, O, I = cfg.dunits, cfg.prenet_units, cfg.odim, cfg.dec_idim
    G = 4 * H
    esize = torch.empty((), dtype=wdt).element_size()
    bsize = torch.empty((), dtype=bdt).element_size()
    w_bytes = (O * U + U * U + U * G + G + H * O) * esize \
        + 3 * H * G * bsize + (2 * U + 3 * G) * 4
    if bdt == torch.int8:
        w_bytes += 3 * G * 4  # scales
    if resident:
        act_bytes = P * I * 4 + (I * G + I * O) * esize + G * 4
    else:
        act_bytes = P * (G + O) * 4
    act_bytes += P * D * 4 + P * D * O * 4  # position in, frames out
    if bounds is not None:
        act_bytes += bounds.numel() * 4
    row_steps = (K._row_bounds(bounds, P, D, "cpu").sum().item()
                 if bounds is not None else P * D)
    macs_step = O * U + U * U + U * G + G + 3 * H * G + H * O
    ops = 2 * row_steps * macs_step
    if resident:
        ops += 2 * P * (I * G + I * O)
    return w_bytes + act_bytes, ops


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    """The CUDA sources and the native plan builder at once, one
    compiler each."""
    from fcl_taco2_tpu_torch.data import native
    from fcl_taco2_tpu_torch.utils.cuda_build import build
    t0 = time.perf_counter()
    names = ("ar_decode", "pwg_stream", "regroup", "attn_decode", "blstm")
    with ThreadPoolExecutor(len(names) + 1) as pool:
        plan_lib = pool.submit(native.build)
        built = list(pool.map(build, names))
        plan_lib = plan_lib.result()
    log(f"[build] {', '.join(p.name for p, _ in built)} and "
        f"{plan_lib.name} in {time.perf_counter() - t0:.1f} s")
    for _, compiler_log in built:
        for line in compiler_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")


MMA = {True: "3xTF32 mma.sync m16n8k8", False: "bf16 mma.sync m16n8k16"}


def decoder_case(model, P, ragged, wdt, fn):
    """One kernel-vs-plain case: the packed weights, the launch of the
    kernel alone (prepared operands) and the wrapper's call."""
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    from fcl_taco2_tpu_torch.utils.cuda_build import seed_tensor
    cfg = model.cfg
    dp = model.decoder.jax_layout()
    enc, pos, fm, bounds = segment_batch(cfg, P, 0, ragged)
    resident = fn is K.fused_ar_decode
    pk = K.pack_decoder_weights(dp, cfg.dec_idim, wdt)
    kw = dict(zoneout=cfg.zoneout_rate, dropout=0.0, weights_dtype=wdt,
              bounds=bounds)
    if resident:
        t = {"enc": enc, "pos": pos,
             "enc_gates": torch.empty(P, 4 * pk.H, device="cuda"),
             "enc_out": torch.empty(P, pk.odim, device="cuda")}
    else:
        with torch.no_grad():
            eg, eo = K._hoisted_enc(enc, pk._asdict())
        t = {"pos": pos, "enc_gates": eg.contiguous(),
             "enc_out": eo.contiguous()}

    # the seed as the main path gives it: a (1,) int32 tensor on the card
    seed = seed_tensor(0, torch.device("cuda"))

    def alone():
        return K._launch(pk, resident=resident, tensors=t, P=P,
                         D=cfg.max_dur, bounds=bounds,
                         zoneout=cfg.zoneout_rate, dropout=0.0, seed=seed)

    def call():
        return fn(dp, enc, pos, seed, packed=pk, **kw)
    steps = int(K._row_bounds(bounds, P, cfg.max_dur, "cuda").max())
    return dp, enc, pos, fm, bounds, kw, alone, call, steps


def phase_kernels(models):
    """Each decoder entry against its plain version at full width, timed
    as the kernel alone (packed weights, prepared operands) and as the
    wrapper's call."""
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    rows = []
    cases = [("fused_ar_decode", K.fused_ar_decode, K.fused_ar_decode_plain,
              "student", wdt, P, ragged)
             for P in (96, 2048) for ragged in (True, False)
             for wdt in (torch.float32, torch.bfloat16)]
    cases += [("fused_ar_decode_hbm", K.fused_ar_decode_hbm,
               K.fused_ar_decode_hbm_plain, "teacher", wdt, P, ragged)
              for P in (96, 2048) for ragged in (True, False)
              for wdt in (torch.bfloat16, torch.int8)]
    # streamed mode: fp32 teacher slices (426 KB a block) do not fit
    cases.append(("fused_ar_decode_hbm", K.fused_ar_decode_hbm,
                  K.fused_ar_decode_hbm_plain, "teacher", torch.float32, 96,
                  True))
    for name, fn, plain, model_key, wdt, P, ragged in cases:
        model = models[model_key]
        cfg = model.cfg
        dp, enc, pos, fm, bounds, kw, alone, call, steps = decoder_case(
            model, P, ragged, wdt, fn)
        with torch.no_grad():
            got = call()
            info = dict(K.last_launch)
            want = plain(dp, enc, pos, 0, **kw)
            torch.cuda.synchronize()
            err = float(((got - want) * fm[..., None]).abs().max())
            tol, why = (TOL_F32, TOL_F32_WHY) if wdt == torch.float32 \
                else (TOL_BF16, TOL_BF16_WHY)
            ms = median_ms(alone, 5)
            call_ms = median_ms(call, 5)
            clk = clocks()
            plain_ms = median_ms(lambda: plain(dp, enc, pos, 0, **kw), 3)
        # int8 streams codes; the resident weights stay bf16
        rdt = torch.bfloat16 if wdt == torch.int8 else wdt
        nbytes, ops = work(cfg, P, bounds, cfg.max_dur, rdt,
                           fn is K.fused_ar_decode, wdt)
        if wdt == torch.float32:  # 3xTF32 products, fp32 bound beside
            b_ms, b_by = bound_ms(nbytes, TF32_PASSES * ops, "tf32")
            b32_ms, _ = bound_ms(nbytes, ops, torch.float32)
            b_dtype = "tf32 x3"
        else:
            b_ms, b_by = bound_ms(nbytes, ops, wdt)
            b32_ms, b_dtype = None, "bf16"
        mode = "stationary" if info["stationary"] else "streamed"
        row = dict(name=name, P=P, ragged=ragged,
                   weights=str(wdt).replace("torch.", ""),
                   max_abs_err=err, tol=tol, ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   bound_dtype=b_dtype, bound_fp32_ms=b32_ms, mode=mode,
                   grid=info["grid"], cluster=info["cluster"],
                   cooperative=info["cooperative"],
                   units_per_block=info["units_per_block"],
                   smem_bytes=info["smem_bytes"],
                   barriers_per_step=info["barriers_per_step"],
                   steps=steps, us_per_step=1e3 * ms / max(steps, 1),
                   clocks=clk)
        rows.append(row)
        log(f"[kernel] {name} P={P} ragged={ragged} "
            f"weights={row['weights']}: max_abs_err={err:.3e} (tol {tol:g}: "
            f"{why}); {mode}, grid {info['grid']} x {info['block_threads']} "
            f"threads, cluster {info['cluster']} ("
            f"{'cooperative' if info['cooperative'] else 'occupancy-checked'}"
            f" launch), {info['units_per_block']} units a "
            f"block, {info['smem_bytes']} B dynamic shared memory a block, "
            f"{info['barriers_per_step']} grid barriers a step, tensor-core "
            f"products ({MMA[wdt == torch.float32]}); "
            f"{steps} steps, {row['us_per_step']:.2f} us a step; kernel "
            f"alone {ms:.3f} ms, call {call_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {b_dtype}"
            + (f"; fp32 CUDA cores {b32_ms:.4f} ms" if b32_ms else "")
            + ")")
        if not np.isfinite(err) or err > tol:
            raise RuntimeError(f"{name} disagrees with its plain version: "
                               f"{row}")
        if ms > plain_ms:
            log(f"[kernel] note: {name} P={P} ragged={ragged} "
                f"weights={row['weights']} is slower than its plain version")
    # the batch-16 decode of the main path (P = 1536, ragged)
    dp, enc, pos, fm, bounds, kw, alone, call, steps = decoder_case(
        models["teacher"], 1536, True, torch.bfloat16, K.fused_ar_decode_hbm)
    with torch.no_grad():
        ms = median_ms(alone, 5)
    log(f"[kernel] fused_ar_decode_hbm P=1536 ragged=True weights=bfloat16 "
        f"(teacher batch 16): kernel alone {ms:.3f} ms, {steps} steps, "
        f"{1e3 * ms / steps:.2f} us a step")
    return rows


def phase_dropout(models):
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    for rate in (0.1, 0.5, 0.9):
        m = K.dropout_keep_mask(7, rate, 1024, 1024, step=3, layer=1)
        keep = float((m > 0).float().mean())
        kept = m[m > 0]
        log(f"[dropout] rate={rate}: keep fraction {keep:.5f} "
            f"(want {1 - rate} +- 5e-3), kept values "
            f"{float(kept.min()):.6f}..{float(kept.max()):.6f} "
            f"(want {1 / (1 - rate):.6f})")
        if abs(keep - (1 - rate)) > 5e-3:
            raise RuntimeError(f"dropout keep fraction {keep} at {rate}")
        if not torch.allclose(kept, torch.full_like(kept, 1 / (1 - rate))):
            raise RuntimeError("kept dropout values are not 1/(1-rate)")
    # in the decode: two seeds differ, and inverted dropout keeps the
    # output's scale near the deterministic one (test_decoder_pallas.py:59)
    model = models["teacher"]
    cfg = model.cfg
    dp = model.decoder.jax_layout()
    enc, pos, _, bounds = segment_batch(cfg, 96, 1, True)
    with torch.no_grad():
        outs = [K.fused_ar_decode_hbm(dp, enc, pos, s, dropout=r,
                                      zoneout=cfg.zoneout_rate,
                                      bounds=bounds)
                for s, r in ((0, 0.5), (1, 0.5), (0, 0.0))]
    if torch.equal(outs[0], outs[1]):
        raise RuntimeError("two dropout seeds gave the same decode")
    rms = [float(o.square().mean().sqrt()) for o in outs]
    ratio = (rms[0] + rms[1]) / (2 * rms[2])
    log(f"[dropout] seeds 0/1 differ; output RMS ratio with dropout 0.5 "
        f"vs none {ratio:.3f} (want 0.7..1.4)")
    if not 0.7 < ratio < 1.4:
        raise RuntimeError(f"dropout output RMS ratio {ratio}")


def _counters():
    from fcl_taco2_tpu_torch.ops import blstm_cuda as BK
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    from fcl_taco2_tpu_torch.ops import regroup_cuda as R
    from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC
    return {"fused_ar_decode": K.fused_ar_decode,
            "fused_ar_decode_hbm": K.fused_ar_decode_hbm,
            "pwg_generate_streaming": PC.pwg_generate_streaming,
            "pwg_stream_step": PC.pwg_stream_step,
            "gather_backward": R.gather_backward,
            "bilstm_infer": BK.bilstm_infer}


TRAIN_KERNEL = "gather_backward"  # the one kernel a training step runs
EVAL_KERNEL = "bilstm_infer"  # the trainers' evaluations serve the encoder
EVALS = {"launches": 0}  # EVAL_KERNEL's launches inside EvalStep calls


def _count_evaluations_apart(on):
    """While on, the launches of EVAL_KERNEL made inside an ``EvalStep``
    call (the trainers' evaluations, which serve the encoder) leave its
    counter for ``EVALS``, so a training phase holds everything else,
    its steps included, to none."""
    from fcl_taco2_tpu_torch.train.step import EvalStep
    plain = getattr(EvalStep.__call__, "plain", None)
    if plain is not None:
        EvalStep.__call__ = plain
    if not on:
        return
    plain = EvalStep.__call__
    kernel = _counters()[EVAL_KERNEL]

    def apart(self, *args, **kwargs):
        before = kernel.launches
        try:
            return plain(self, *args, **kwargs)
        finally:
            EVALS["launches"] += kernel.launches - before
            kernel.launches = before

    apart.plain = plain
    EvalStep.__call__ = apart


def check_training_counts(phase, counts):
    """A training phase launches the regroup gathers' backward and no
    decoder, PWG or BiLSTM kernel outside its evaluations, whose BiLSTM
    launches ``zero_counts(evaluations_apart=True)`` counted apart."""
    _count_evaluations_apart(False)
    serving = {k: v for k, v in counts.items() if k != TRAIN_KERNEL and v}
    if serving or not counts[TRAIN_KERNEL]:
        raise RuntimeError(f"{phase}: want {TRAIN_KERNEL} and no serving "
                           f"kernel launched, got {counts}")
    log(f"{phase}: the evaluations launched {EVAL_KERNEL} "
        f"{EVALS['launches']} times (counted apart)")


def zero_counts(evaluations_apart=False):
    """Zero the launch counters; with ``evaluations_apart`` (a training
    phase, until its ``check_training_counts``) count EVAL_KERNEL's
    launches inside evaluations apart."""
    for fn in _counters().values():
        fn.launches = 0
    EVALS["launches"] = 0
    _count_evaluations_apart(evaluations_apart)


def read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def protocol():
    """The headline benchmark's utterances: one of 96 phonemes, and a
    batch of 16 of 48..96 phonemes, with Poisson(8) durations."""
    rng = np.random.default_rng(0)
    dur1 = durations(rng, N_PHONES)
    tok1 = rng.integers(1, IDIM, N_PHONES).astype(np.int32)
    lens16 = np.concatenate([[N_PHONES], rng.integers(48, N_PHONES + 1, 15)])
    toks16 = [rng.integers(1, IDIM, n).astype(np.int32) for n in lens16]
    durs16 = [durations(rng, n) for n in lens16]
    return tok1, dur1, toks16, durs16


def phase_main_path(models, kind):
    """The four text -> mel serving cases; returns the launch counts."""
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    tok1, dur1, toks16, durs16 = protocol()
    cases = (
        ("teacher_b1", "teacher", 1, "none", [tok1], [dur1],
         K.fused_ar_decode_hbm),
        ("teacher_b16", "teacher", 16, "none", toks16, durs16,
         K.fused_ar_decode_hbm),
        ("teacher_b1_int8", "teacher", 1, "int8", [tok1], [dur1],
         K.fused_ar_decode_hbm),
        ("student_b1", "student", 1, "none", [tok1], [dur1],
         K.fused_ar_decode),
    )
    launches = dict.fromkeys(_counters(), 0)
    for tag, mkey, B, quantize, toks, durs, kernel in cases:
        synth = Synthesizer(models[mkey], batch_size=B, quantize=quantize)
        zero_counts()
        mels, stats = synth.synth_batch(toks, 0, durations=durs)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"[main] {tag}: launches {counts}")
        if kernel.launches == 0:
            raise RuntimeError(f"{tag}: the main path did not launch "
                               f"{kernel.__name__}")
        for k, v in counts.items():
            launches[k] += v
        # the checks: finite, olens == duration sums, zero past olens
        want_len = [int(d.sum()) for d in durs]
        got_len = [m.shape[0] for m in mels]
        if got_len != want_len:
            raise RuntimeError(f"{tag}: olens {got_len} != {want_len}")
        if not all(np.isfinite(m).all() for m in mels):
            raise RuntimeError(f"{tag}: non-finite mel")
        tokens, ilens, dd = _padded(toks, durs, B, synth.tok_bucket)
        full = synth.model.synthesize(tokens, ilens, 0, stats["budget"],
                                      durations=dd, quantize=quantize,
                                      prequant=synth.options["prequant"])
        olens = full["olens"].cpu().numpy()
        mel = full["mel"].cpu().numpy()
        for i, n in enumerate(olens[:len(toks)]):
            if np.any(mel[i, n:] != 0):
                raise RuntimeError(f"{tag}: frames past olens not zero")
        fps = []
        for rep in range(6):
            torch.cuda.synchronize()
            _, st = synth.synth_batch(toks, rep, durations=durs)
            fps.append(st["frames_per_sec"])
        log(f"[main] {tag} on {kind}: median {np.median(fps[1:]):.1f} "
            f"frames/s over {len(fps) - 1} reps after warm-up "
            f"(min {min(fps[1:]):.1f}, max {max(fps[1:]):.1f}; "
            f"{sum(want_len)} frames, budget {stats['budget']})")
        breakdown(synth, tokens, ilens, dd, stats["budget"], tag, kind)
    for k, v in main_hybrid(models, kind, toks16, durs16).items():
        launches[k] += v
    return launches


TOL_HYBRID = 2e-3  # [kernel]'s bf16 limit


def main_hybrid(models, kind, toks16, durs16):
    """teacher_b16 with ``decoder_backend="hybrid"`` (the head tile on
    the streaming kernel, the rest on the plain scan in bf16) against
    ``auto`` (the streaming kernel over every tile) and ``scan`` (no
    kernel): frames/s of each, median of 5 after a warm-up, at dropout 0.
    hybrid's mels must be within TOL_HYBRID of auto's, or no further from
    them than the scan's are (hybrid's rows are auto's or the scan's).
    Returns the launch counts of the checked calls."""
    import dataclasses
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    cfg = dataclasses.replace(models["teacher"].cfg, dropout_rate=0.0)
    model = Tacotron2SA(cfg, seed=2)
    model.load_state_dict(models["teacher"].state_dict())
    launches = dict.fromkeys(_counters(), 0)
    mels, fps = {}, {}
    for backend in ("auto", "hybrid", "scan"):
        synth = Synthesizer(model, batch_size=16, decoder_backend=backend)
        zero_counts()
        mels[backend], _ = synth.synth_batch(toks16, 0, durations=durs16)
        torch.cuda.synchronize()
        counts = read_counts()
        if (K.fused_ar_decode_hbm.launches == 0) != (backend == "scan"):
            raise RuntimeError(f"teacher_b16 {backend}: launches {counts}")
        for k, v in counts.items():
            launches[k] += v
        runs = []
        for rep in range(6):
            torch.cuda.synchronize()
            runs.append(synth.synth_batch(toks16, rep,
                                          durations=durs16)[1]
                        ["frames_per_sec"])
        fps[backend] = "{:.1f} frames/s (min {:.1f}, max {:.1f})".format(
            np.median(runs[1:]), min(runs[1:]), max(runs[1:]))

    def gap(b):
        return max(float(np.abs(x - y).max())
                   for x, y in zip(mels["auto"], mels[b]))

    tol = max(TOL_HYBRID, gap("scan"))
    log(f"[main] teacher_b16 decoder backends on {kind} (dropout 0, bf16, "
        f"median of 5 after warm-up): auto {fps['auto']}, hybrid "
        f"{fps['hybrid']}, scan {fps['scan']}; mel max abs vs auto: hybrid "
        f"{gap('hybrid'):.3e}, scan {gap('scan'):.3e} (hybrid's tol "
        f"{tol:.3e}: {TOL_HYBRID} or the scan's gap); launches {launches}")
    if not gap("hybrid") <= tol:
        raise RuntimeError(f"hybrid vs auto: mel gap {gap('hybrid'):.3e} > "
                           f"{tol:.3e}")
    return launches


def phase_import(models, kind):
    """The reference's checkpoint layout on the card: the seeded teacher's
    weights exported to the reference's keys, saved as an amp checkpoint
    with DataParallel ``module.`` prefixes, loaded into a fresh model;
    ``synthesize`` on the batch-1 protocol batch (bf16, dropout 0) must
    equal the source model's bit for bit, through
    ``fused_ar_decode_hbm``.  Returns the launch counts of the loaded
    model's call."""
    import dataclasses
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    from fcl_taco2_tpu_torch.utils.torch_import import (
        export_reference_state_dict, load_reference_checkpoint)
    tok1, dur1, _, _ = protocol()
    cfg = dataclasses.replace(models["teacher"].cfg, dropout_rate=0.0)
    src = Tacotron2SA(cfg, seed=2)
    src.load_state_dict(models["teacher"].state_dict())
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "amp_checkpoint_100.pt")
        ref = export_reference_state_dict(src.state_dict(), cfg)
        torch.save({"model": {"module." + k: v for k, v in ref.items()},
                    "optimizer": {}, "amp": {}}, path)
        size = os.path.getsize(path)
        dst = load_reference_checkpoint(path, Tacotron2SA(cfg, seed=3))
    tokens, ilens, dd = _padded([tok1], [dur1], 1, 32)  # Synthesizer's
    budget = -(-int(dur1.sum()) // 64) * 64
    want = src.synthesize(tokens, ilens, 0, budget, durations=dd)
    torch.cuda.synchronize()
    zero_counts()
    got = dst.synthesize(tokens, ilens, 0, budget, durations=dd)
    torch.cuda.synchronize()
    counts = read_counts()
    same = {k: torch.equal(got[k], want[k])
            for k in ("mel", "olens", "d_outs")}
    log(f"[import] teacher full width -> export_reference_state_dict "
        f"({len(ref)} reference keys) -> torch.save amp layout with "
        f"'module.' ({size / 2 ** 20:.1f} MiB) -> load_reference_checkpoint"
        f" into a fresh Tacotron2SA: synthesize batch 1 (96 phonemes, bf16,"
        f" dropout 0) torch.equal {all(same.values())} {same}; launches "
        f"{counts} on {kind}")
    if not all(same.values()):
        raise RuntimeError(f"import: the loaded model's output differs {same}")
    if K.fused_ar_decode_hbm.launches == 0:
        raise RuntimeError("import: fused_ar_decode_hbm did not launch")
    return counts


def breakdown(synth, tokens, ilens, dd, budget, tag, kind):
    """Host-clock split of one synthesize call, each stage synchronized:
    frontend (synth_frontend: encoder + predictors), decode
    (decode_segments) and the rest (plan, frame scatter, postnet)."""
    m = synth.model
    stage_ms = {"synth_frontend": [], "decode_segments": []}

    def wrap(name):
        orig = getattr(m, name)

        def timed_stage(*a, **k):
            out, ms = timed(lambda: orig(*a, **k))
            stage_ms[name].append(ms)
            return out
        setattr(m, name, timed_stage)

    for name in stage_ms:
        wrap(name)
    try:
        rows = []
        for _ in range(4):
            for ms in stage_ms.values():
                ms.clear()
            _, total = timed(lambda: m.synthesize(
                tokens, ilens, 0, budget, durations=dd,
                quantize=synth.options["quantize"],
                prequant=synth.options["prequant"]))
            rows.append((total, stage_ms["synth_frontend"][0],
                         stage_ms["decode_segments"][0]))
    finally:
        for name in stage_ms:
            delattr(m, name)  # back to the class methods
    total, front, dec = np.median(np.array(rows[1:]), axis=0)
    log(f"[breakdown] {tag} on {kind}: synthesize {total:.2f} ms = "
        f"frontend {front:.2f} + decode {dec:.2f} + plan/scatter/postnet "
        f"{total - front - dec:.2f} (host clock, synchronized, median of 3)")


def pwg_work(cfg, B, positions, inputs_floats, state=False):
    """Least bytes and operations of one PWG call producing ``positions``
    samples a row: the weights once, the inputs (``inputs_floats`` a row),
    noise and wav, the state in and out for a stream step; 2 x the
    stack's multiply-adds per sample (the fp32 function's operations)."""
    from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC
    C, G, S, A, L = (cfg.residual_channels, cfg.gate_channels,
                     cfg.skip_channels, cfg.aux_channels, cfg.layers)
    macs = L * (3 * C * G + A * G + G // 2 * (S + C)) + S * S + S
    w = (L * ((3 * C + A) * G + G + G // 2 * (S + C) + S + C)
         + 2 * C + S * S + 2 * S + 1)
    nbytes = 4 * (w + B * (inputs_floats + 2 * positions))
    if state:
        delay = PC._round8(PC.total_delay(cfg))
        sum_bw = sum(PC._buf_width(d) for d in cfg.dilations)
        nbytes += 4 * 2 * B * (delay * (A + S) + sum_bw * C)
    return nbytes, 2 * macs * B * positions


def pwg_bounds(cfg, B, positions, inputs_floats, state=False):
    """The PWG kernel's bound at the type it multiplies in (TF32 tensor
    cores, three passes a product), and the fp32 CUDA-core bound of the
    same function beside it."""
    nbytes, ops = pwg_work(cfg, B, positions, inputs_floats, state)
    b_ms, b_by = bound_ms(nbytes, TF32_PASSES * ops, "tf32")
    b32_ms, _ = bound_ms(nbytes, ops, torch.float32)
    return dict(bound_ms=b_ms, bound_by=b_by, bound_dtype="tf32 x3",
                bound_fp32_ms=b32_ms)


def kd_step_gathers():
    """The eight regroup gathers of a KD step at the training cells'
    shapes (``bench_protocol.cell_plans``): (tag, leading dims of x,
    index arrays, valid, width) for the student's four class token
    gathers (256 wide) and the scatters of its mel (80) and of its three
    KD captures (256)."""
    from fcl_taco2_tpu_torch.utils.bench_protocol import cell_plans
    dur, _, plan, _ = cell_plans()
    rows = sum(c.frame_mask.size for c in plan.classes)
    out = [(f"tokens{c.dur_cap}", dur.shape, (c.seg_utt, c.seg_tok),
            c.frame_mask[:, 0], 256) for c in plan.classes]
    return out + [(f"scatter{C}", (rows,), (plan.utt_gather,), plan.utt_mask,
                   C) for C in (ODIM, 256, 256, 256)]


def phase_regroup(smi, kind):
    """``csrc/regroup.cu`` against its plain version (autograd's indexing
    backward) on a KD step's eight gathers, bf16, the padded positions'
    gradients zero: bit-equal; the card's ms of each queued behind a sleep
    (``timing.queued_ms``) beside its bound.  Returns the kernels row."""
    from fcl_taco2_tpu_torch.ops import regroup_cuda as R
    from fcl_taco2_tpu_torch.utils.timing import queued_ms
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    tot = dict(kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for tag, lead, idx, valid, C in kd_step_gathers():
        idx = tuple(torch.from_numpy(np.asarray(i)).to(dev) for i in idx)
        valid = torch.from_numpy(np.asarray(valid)).to(dev)
        g = torch.randn(*valid.shape, C, generator=gen, device=dev).to(dt)
        g = g * valid[..., None].to(dt)
        got = R.gather_backward(g, idx, valid, lead)
        launch = dict(R.last_launch)
        want = R.gather_backward_plain(g, idx, valid, lead)
        if not torch.equal(got, want):
            raise RuntimeError(f"[regroup] {tag}: the kernel's gradient "
                               f"differs from autograd's")
        n, rows = valid.numel(), int(np.prod(lead))
        # bytes once: g read, grad_x written, the plan's indices and mask
        nbytes = (n + rows) * C * 2 + n * (4 * len(idx) + 1)
        b_ms, _ = bound_ms(nbytes, 0, dt)
        k_ms = queued_ms(lambda: R.gather_backward(g, idx, valid, lead), 20)
        p_ms = queued_ms(
            lambda: R.gather_backward_plain(g, idx, valid, lead), 3)
        for key, v in (("kernel_ms", k_ms), ("plain_ms", p_ms),
                       ("bound_ms", b_ms)):
            tot[key] += v
        log(f"[regroup] {tag}: {n} positions ({n - int(valid.sum())} "
            f"padded) -> {rows} x {C} bf16, bit-equal; launch {launch}; "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"(bytes) | {smi}")
    log(f"[regroup] a KD step's eight gathers on {kind}: kernel "
        f"{tot['kernel_ms']:.3f} ms, plain {tot['plain_ms']:.2f} ms, bound "
        f"{tot['bound_ms']:.4f} ms (roofline share "
        f"{tot['bound_ms'] / tot['kernel_ms']:.1%}) | {smi}")
    return dict(tot, shape="a KD step's 8 gathers: B=64 Lmax=1024 "
                "classes 8,16,32,50; tokens 4x256, scatters 80+3x256, bf16",
                launch=launch)


def phase_pwg_kernels():
    """Both PWG entries against their plain versions at PWG v1."""
    from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC
    from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN, PWGConfig,
                                                 upsample_mel)
    cfg = PWGConfig()
    pwg = ParallelWaveGAN(cfg, seed=0)
    packed = PC.pack_pwg_weights(pwg, cfg)
    A, hop = cfg.aux_channels, cfg.hop
    delay = PC._round8(PC.total_delay(cfg))
    rows = {}
    main = None
    for B, Tm, check in ((1, 1536, True), (8, 512, True), (16, 1536, False)):
        g = torch.Generator(device="cuda").manual_seed(B)
        mel = torch.randn(B, Tm, A, generator=g, device="cuda")
        noise = torch.randn(B, Tm * hop, generator=g, device="cuda")
        W = Tm * hop

        def call():
            return PC.pwg_generate_streaming(pwg, cfg, mel, noise,
                                             packed=packed)

        # the kernel alone: prepared aux, packed weights
        with torch.no_grad():
            aux = upsample_mel(pwg, cfg, mel)
        k_ms = median_ms(lambda: PC._launch(packed, cfg, aux, noise, 0, W,
                                            W + delay, None), 5)
        info = dict(PC.last_launch)
        del aux
        call_ms = median_ms(call, 5)
        row = dict(ms=k_ms, call_ms=call_ms, clocks=clocks(),
                   grid=info["grid"],
                   block_rows=info["block_rows"],
                   block_tiles=info["block_tiles"],
                   barriers=info["barriers"],
                   **pwg_bounds(cfg, B, W, Tm * A))
        line = (f"[pwg] pwg_generate_streaming B={B} Tm={Tm} (W={W}): "
                f"kernel alone {k_ms:.3f} ms, whole call (upsample + "
                f"launch) {call_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
                f"(operations, tf32 x3; fp32 CUDA cores "
                f"{row['bound_fp32_ms']:.4f} ms), "
                f"{B * W / k_ms / 1e3:.2f} Msamples/s; grid {info['grid']} "
                f"blocks, {info['block_tiles']} block tiles of "
                f"{info['block_rows']} rows a phase, {info['barriers']} "
                f"grid barriers a call, {info['groups']} warp groups and "
                f"{info['smem_bytes']} B of shared memory a block")
        if check:
            got = call()
            want = PC.pwg_generate_streaming_plain(pwg, cfg, mel, noise)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            row["max_abs_err"] = err
            row["plain_ms"] = median_ms(
                lambda: PC.pwg_generate_streaming_plain(pwg, cfg, mel,
                                                        noise), 2, warmup=0)
            line += (f"; max_abs_err={err:.3e} (tol {TOL_PWG:g}: "
                     f"{TOL_PWG_WHY}; output scale "
                     f"{float(want.abs().max()):.3f}), plain "
                     f"{row['plain_ms']:.3f} ms")
            if not np.isfinite(err) or err > TOL_PWG:
                log(line)
                raise RuntimeError(f"pwg_generate_streaming disagrees with "
                                   f"its plain version: {err}")
            if main is None:
                main = (mel, noise, got)
        else:
            line += " (no plain version at this size: it would take minutes)"
        rows[(B, Tm)] = row
        log(line)

    # stream steps of Vh = 4096 over the B = 1 utterance
    mel, noise, oneshot = main
    W = mel.shape[1] * hop
    Vh = 4096
    n = -(-(W + delay) // Vh)
    aux = torch.zeros(1, n * Vh, A, device="cuda")
    aux[:, :W] = upsample_mel(pwg, cfg, mel)
    nz = torch.zeros(1, n * Vh, device="cuda")
    nz[:, :W] = noise
    st = PC.pwg_stream_state(cfg, 1)
    st_plain = PC.pwg_stream_state(cfg, 1)
    outs, errs, mid = [], [], None
    with torch.no_grad():
        for j in range(n):
            # the position as the stream gives it: (start, W) on the card
            args = (aux[:, j * Vh:(j + 1) * Vh], nz[:, j * Vh:(j + 1) * Vh],
                    PC.stream_pos(j * Vh, W, "cuda"))
            if j == n // 2:
                mid = (st, args)
            wav, st = PC.pwg_stream_step(packed, cfg, st, *args)
            wp, st_plain = PC.pwg_stream_step_plain(packed, cfg, st_plain,
                                                    *args)
            pairs = zip([wav, st["aux_hist"], st["acc"], *st["bufs"]],
                        [wp, st_plain["aux_hist"], st_plain["acc"],
                         *st_plain["bufs"]])
            errs.append(max(float((a - b).abs().max()) for a, b in pairs))
            outs.append(wav)
    chain = torch.cat(outs, dim=1)[:, delay:delay + W]
    chain_err = float((chain - oneshot).abs().max())
    exact = torch.equal(chain, oneshot)
    err = max(errs)
    st_mid, args = mid
    def step():
        return PC.pwg_stream_step(packed, cfg, st_mid, *args)
    ms = median_ms(step, 10)
    info = dict(PC.last_launch)
    # ten calls between two events: the host's launch gaps overlap the
    # card's work, where a single call's events also time its launch
    ms_back_to_back = median_ms(lambda: [step() for _ in range(10)], 5) / 10
    clk = clocks()
    plain_ms = median_ms(
        lambda: PC.pwg_stream_step_plain(packed, cfg, st_mid, *args), 3)
    rows["step"] = dict(max_abs_err=err, ms=ms,
                        ms_back_to_back=ms_back_to_back, clocks=clk,
                        plain_ms=plain_ms,
                        grid=info["grid"], block_rows=info["block_rows"],
                        block_tiles=info["block_tiles"],
                        barriers=info["barriers"],
                        **pwg_bounds(cfg, 1, Vh, Vh * A, state=True))
    log(f"[pwg] pwg_stream_step Vh={Vh} x {n} steps: max_abs_err vs plain "
        f"(wav and state, every step) {err:.3e} (tol {TOL_PWG:g}: "
        f"{TOL_PWG_WHY}); chain vs one-shot kernel {chain_err:.3e} "
        f"(bit-exact: {exact}); kernel {ms:.3f} ms a step "
        f"({ms_back_to_back:.3f} back to back; clocks {clk}), plain "
        f"{plain_ms:.3f} ms, bound {rows['step']['bound_ms']:.4f} ms "
        f"(operations, tf32 x3; fp32 CUDA cores "
        f"{rows['step']['bound_fp32_ms']:.4f} ms); grid {info['grid']} "
        f"blocks, {info['block_tiles']} block tiles of {info['block_rows']} "
        f"rows a phase, {info['barriers']} grid barriers a call, "
        f"{info['groups']} warp groups and {info['smem_bytes']} B of shared "
        f"memory a block")
    if not np.isfinite(err) or err > TOL_PWG:
        raise RuntimeError(f"pwg_stream_step disagrees with its plain "
                           f"version: {err}")
    if not exact:
        raise RuntimeError(f"chained pwg_stream_step calls are not bit-equal "
                           f"to the one-shot kernel: {chain_err}")
    return pwg, rows


def phase_tts(models, pwg, kind):
    """Text -> wav through ``TTSPipeline.tts_batch``; returns launches."""
    from fcl_taco2_tpu_torch.infer import TTSPipeline
    from fcl_taco2_tpu_torch.vocoder.pwg import pwg_generate
    from fcl_taco2_tpu_torch.vocoder.pwg_cuda import vocode
    tok1, dur1, toks16, durs16 = protocol()
    cases = (("tts_student_b1", "student", [tok1], [dur1], "fused_ar_decode"),
             ("tts_teacher_b1", "teacher", [tok1], [dur1],
              "fused_ar_decode_hbm"),
             ("tts_teacher_b16", "teacher", toks16, durs16,
              "fused_ar_decode_hbm"))
    launches = dict.fromkeys(_counters(), 0)
    hop = pwg.cfg.hop
    for tag, mkey, toks, durs, decoder in cases:
        pipe = TTSPipeline(models[mkey], pwg)
        zero_counts()
        wavs, stats = pipe.tts_batch(toks, 0, durations=durs)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"[tts] {tag}: launches {counts}")
        for k in (decoder, "pwg_generate_streaming"):
            if counts[k] == 0:
                raise RuntimeError(f"{tag}: the main path did not launch {k}")
        for k, v in counts.items():
            launches[k] += v
        want = [int(d.sum()) * hop for d in durs]
        if [len(w) for w in wavs] != want:
            raise RuntimeError(f"{tag}: wav lengths {[len(w) for w in wavs]}"
                               f" != olens * hop {want}")
        if not all(np.isfinite(w).all() for w in wavs):
            raise RuntimeError(f"{tag}: non-finite wav")
        rtf = [pipe.tts_batch(toks, rep, durations=durs)[1]["rtf_x"]
               for rep in range(5)]
        log(f"[tts] {tag} on {kind}: RTF (audio s / wall s) median "
            f"{np.median(rtf):.1f} over 5 reps after warm-up (min "
            f"{min(rtf):.1f}, max {max(rtf):.1f}; {stats['audio_sec']:.2f} "
            f"s of audio from {stats['frames']} frames; the whole budget of "
            f"{len(toks)} x {tts_budget(toks)} frames is vocoded)")
        # one call split into synthesize and vocode (synchronized)
        B = len(toks)
        tokens, ilens, dd = _padded(toks, durs, B, 16)
        budget = tts_budget(toks)
        noise = torch.randn(B, budget * hop, device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(0))
        rows = []
        for _ in range(4):
            out, syn_ms = timed(lambda: pipe.model.synthesize(
                tokens, ilens, 0, budget, durations=dd,
                quantize=pipe.quantize, prequant=pipe.prequant))
            mel = out["mel"].to(pipe.pwg_dtype).float()
            nzr = noise.to(pipe.pwg_dtype).float()
            wav, voc_ms = timed(lambda: vocode(pipe.pwg, pipe.pwg_cfg, mel,
                                                nzr, packed=pipe.packed))
            rows.append((syn_ms, voc_ms))
        syn_ms, voc_ms = np.median(np.array(rows[1:]), axis=0)
        log(f"[breakdown] {tag} on {kind}: synthesize {syn_ms:.2f} ms + "
            f"vocode {voc_ms:.2f} ms (host clock, synchronized, median of 3)")
        if tag == "tts_student_b1":
            # the kernel's wav against the conv graph on the same inputs
            with torch.no_grad():
                ref = pwg_generate(pipe.pwg, pipe.pwg_cfg, mel, nzr)
            err = float((wav - ref).abs().max())
            log(f"[tts] {tag}: wav vs pwg_generate (the conv graph) "
                f"max_abs_err={err:.3e} (tol {TOL_PWG:g}: {TOL_PWG_WHY})")
            if not np.isfinite(err) or err > TOL_PWG:
                raise RuntimeError(f"{tag}: wav disagrees with the graph")
    return launches


def tts_budget(toks, frame_per_token=16):
    """TTSPipeline.tts_batch's frame budget: tokens padded to a multiple
    of 16, times frame_per_token, rounded up to 256."""
    Tmax = (max(len(t) for t in toks) + 15) // 16 * 16
    return (Tmax * frame_per_token + 255) // 256 * 256


def timed_stream(st, tokens, durs, seed, noise=None):
    """Wall clock around the yields (scripts/bench_stream.py): time to
    first audio (ms), x realtime, joined audio."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttfa, chunks = None, []
    for chunk in st.stream(tokens, seed, durations=durs, noise=noise):
        if ttfa is None:
            ttfa = time.perf_counter() - t0
        chunks.append(chunk)
    wall = time.perf_counter() - t0
    audio = np.concatenate(chunks)
    return 1e3 * ttfa, audio.size / SAMPLE_RATE / wall, audio, len(chunks)


def phase_stream(models, pwg, kind):
    """Streaming TTS through ``StreamTTS``; returns launches."""
    from fcl_taco2_tpu_torch.infer import StreamTTS
    from fcl_taco2_tpu_torch.models import Tacotron2SA, student_config
    from fcl_taco2_tpu_torch.vocoder.pwg_cuda import pwg_generate_streaming
    tok1, dur1, _, _ = protocol()
    st = StreamTTS(models["student"], pwg)
    zero_counts()
    _, _, audio, n_chunks = timed_stream(st, tok1, dur1, 0)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[stream] student: launches {counts}")
    for k in ("fused_ar_decode", "pwg_stream_step"):
        if counts[k] == 0:
            raise RuntimeError(f"stream: the main path did not launch {k}")
    F = int(dur1.sum())
    if audio.size != F * pwg.cfg.hop or not np.isfinite(audio).all():
        raise RuntimeError(f"stream: {audio.size} samples (want "
                           f"{F * pwg.cfg.hop}) or non-finite")
    reps = [timed_stream(st, tok1, dur1, r)[:2] for r in range(5)]
    ttfa, xrt = np.median(np.array(reps), axis=0)
    log(f"[stream] student on {kind}: time to first audio median "
        f"{ttfa:.1f} ms (min {min(r[0] for r in reps):.1f}), x realtime "
        f"median {xrt:.1f} (min {min(r[1] for r in reps):.1f}) over 5 reps "
        f"after warm-up; {audio.size / SAMPLE_RATE:.2f} s of audio in "
        f"{n_chunks} chunks, vocode_frames {st.Fv}, chunk_phonemes {st.Pc}")

    # exactness: dropout 0, fp32, the given noise, against synthesize +
    # the one-shot kernel
    m0 = Tacotron2SA(student_config(IDIM, odim=ODIM, dropout_rate=0.0,
                                    compute_dtype="float32"), seed=0)
    st0 = StreamTTS(m0, pwg)
    hop = pwg.cfg.hop
    noise = np.random.default_rng(1).normal(size=F * hop).astype(np.float32)
    _, _, got, _ = timed_stream(st0, tok1, dur1, 0, noise=noise)
    tokens, ilens, dd = _padded([tok1], [dur1], 1, 8)
    out = st0.model.synthesize(tokens, ilens, 0, 1024, durations=dd)
    want = pwg_generate_streaming(
        pwg, pwg.cfg, out["mel"][:, :F],
        torch.from_numpy(noise)[None].cuda())[0].cpu().numpy()
    err = float(np.abs(got - want).max())
    log(f"[stream] joined chunks vs synthesize + one-shot "
        f"pwg_generate_streaming (dropout 0, fp32): max_abs_err={err:.3e} "
        f"(tol {TOL_STREAM:g}: {TOL_STREAM_WHY}; scale "
        f"{float(np.abs(want).max()):.3f})")
    if not np.isfinite(err) or err > TOL_STREAM:
        raise RuntimeError(f"stream disagrees with the one-shot path: {err}")
    return counts


# ---------------------------------------------------------------------------
# [compiled]: CUDA graphs wherever the JAX package jits
# ---------------------------------------------------------------------------

KEEP_SIGMAS = 4.0  # a keep rate's limit, in standard errors of its mean


def _graph_rows(*graphed):
    """Capture seconds, pool MiB, replays and kernels of each graph."""
    rows = [r for g in graphed for r in g.stats()]
    for r in rows:
        r["pool_mib"] = r.pop("pool_bytes") / 2 ** 20
    return rows


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def graphed_split(synth, tokens, ilens, dd, budget):
    """A batch's synthesize split as graphs: the frontend alone, the
    decode alone (``decode_segments`` on the operands an eager call
    gave it) and the whole call; the rest is the difference.  Host ms,
    synchronized, median of 5 replays after one."""
    from fcl_taco2_tpu_torch.utils.graphs import Graphed
    m, gen = synth.model, torch.Generator(device="cuda").manual_seed(0)
    seen = {}
    orig = m.decode_segments

    def spy(*a, **k):
        seen["a"], seen["k"] = a, k
        return orig(*a, **k)

    m.decode_segments = spy
    try:
        m.synthesize(tokens, ilens, 0, budget, durations=dd,
                     quantize=synth.options["quantize"],
                     prequant=synth.options["prequant"])
    finally:
        del m.decode_segments
    enc, dur, pos, fm, _ = seen["a"]
    kw = dict(seen["k"])
    tb, sb = kw.pop("tile_bounds"), kw.pop("step_bound")
    fe = Graphed(lambda x, g: m.synth_frontend(x[0], x[1], durations=x[2]),
                 "cuda", "split.frontend")
    dec = Graphed(lambda x, g: orig(x[0], x[1], x[2], x[3], g,
                                    tile_bounds=x[4], step_bound=x[5], **kw),
                  "cuda", "split.decode")
    args = (tokens, ilens, dd, torch.tensor(1.0), True, budget)
    ms = {"frontend": host_median_ms(
              lambda: fe(None, (tokens, ilens, dd), gen)),
          "decode": host_median_ms(
              lambda: dec(None, (enc, dur, pos, fm, tb, sb), gen)),
          "total": host_median_ms(lambda: synth.graphs(None, args, gen))}
    ms["rest"] = ms["total"] - ms["frontend"] - ms["decode"]
    return ms


def eager_split(synth, tokens, ilens, dd, budget):
    """The same split eagerly (``breakdown``'s stages, median of 3)."""
    m = synth.model
    stage = {}
    orig = {n: getattr(m, n) for n in ("synth_frontend", "decode_segments")}

    def wrap(name):
        def timed_stage(*a, **k):
            out, stage[name] = timed(lambda: orig[name](*a, **k))
            return out
        setattr(m, name, timed_stage)

    for n in orig:
        wrap(n)
    rows = []
    try:
        for _ in range(4):
            _, total = timed(lambda: m.synthesize(
                tokens, ilens, 0, budget, durations=dd,
                quantize=synth.options["quantize"],
                prequant=synth.options["prequant"]))
            rows.append((total, stage["synth_frontend"],
                         stage["decode_segments"]))
    finally:
        for n in orig:
            delattr(m, n)
    total, front, dec = np.median(np.array(rows[1:]), axis=0)
    return {"frontend": front, "decode": dec, "total": total,
            "rest": total - front - dec}


def compiled_serving(models, pwg, kind, smi):
    """Graphed serving against eager, bit for bit, for the same generator
    state: the four synthesize cases, a re-dispatch from a saved state,
    two states that must differ, the replays' prenet keep rate, the
    student's text -> wav and every chunk of its stream; batch-1 ms eager
    beside graphed with the frontend / decode / rest split, time to first
    audio, capture seconds and pool MiB.  Returns the launch counts of
    the graphed calls."""
    from fcl_taco2_tpu_torch.infer import StreamTTS, Synthesizer, TTSPipeline
    from fcl_taco2_tpu_torch.utils.cuda_build import kernel_seed
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    tok1, dur1, toks16, durs16 = protocol()
    launches = dict.fromkeys(_counters(), 0)
    graphs, out = [], {"device": smi}
    cases = (("teacher_b1", "teacher", 1, "none", [tok1], [dur1]),
             ("teacher_b16", "teacher", 16, "none", toks16, durs16),
             ("teacher_b1_int8", "teacher", 1, "int8", [tok1], [dur1]),
             ("student_b1", "student", 1, "none", [tok1], [dur1]))
    for tag, mkey, B, quantize, toks, durs in cases:
        g = Synthesizer(models[mkey], batch_size=B, quantize=quantize)
        e = Synthesizer(models[mkey], batch_size=B, quantize=quantize)
        e.graphed = False
        zero_counts()
        mg, st = g.synth_batch(toks, 0, durations=durs)
        torch.cuda.synchronize()
        counts = read_counts()
        captured = dict(K.last_launch)  # the capture's decoder launch
        for k, v in counts.items():
            launches[k] += v
        me, _ = e.synth_batch(toks, 0, durations=durs)
        bit = _same(mg, me)
        row = {"bit_equal": bit, "launches": counts,
               "decoder_launch_in_capture": captured}
        for name, s in (("graphed", g), ("eager", e)):
            walls = [s.synth_batch(toks, r, durations=durs)[1]
                     for r in range(6)][1:]
            row[name] = {"ms": float(np.median([w["wall_sec"] * 1e3
                                                for w in walls])),
                         "frames_per_s": float(np.median(
                             [w["frames_per_sec"] for w in walls]))}
        if B == 1:
            tokens, ilens, dd = _padded(toks, durs, B, g.tok_bucket)
            row["graphed"]["split"] = graphed_split(g, tokens, ilens, dd,
                                                    st["budget"])
            row["eager"]["split"] = eager_split(e, tokens, ilens, dd,
                                                st["budget"])
        out[tag] = row
        graphs.append(g.graphs)
        log(f"[compiled] {tag}: graphed vs eager mels bit-equal {bit}; "
            f"synth_batch ms (median of 5 after one, copy back included) "
            f"graphed {row['graphed']['ms']:.3f} vs eager "
            f"{row['eager']['ms']:.3f}, frames/s {row['graphed']['frames_per_s']:.1f}"
            f" vs {row['eager']['frames_per_s']:.1f}"
            + ("".join(f"; {n} split " + " + ".join(
                f"{k} {row[n]['split'][k]:.3f}"
                for k in ("frontend", "decode", "rest")) + " = "
                f"{row[n]['split']['total']:.3f} ms"
                for n in ("graphed", "eager")) if B == 1 else "")
            + f"; launches (the capture's warm-ups and the replay) {counts}; "
            f"the decoder launch the graph holds: cluster "
            f"{captured['cluster']}, cooperative {captured['cooperative']}, "
            f"captured {captured['captured']}, grid {captured['grid']} on "
            f"{kind} | {smi}")
        if captured["captured"] != 1:
            raise RuntimeError(f"compiled {tag}: the decoder was not "
                               "captured")
        if not bit:
            raise RuntimeError(f"compiled {tag}: graphed mels differ from "
                               "eager ones")
        if tag != "student_b1":
            continue
        # a re-dispatch from a saved state, two states, the keep rate
        gen = torch.Generator(device="cuda").manual_seed(3)
        pend = g._dispatch(toks, gen, targets=durs)
        args = (*pend["args"], pend["gen_state"])
        again = g._run(*args, pend["gen"], pend["budget"], 1.0)
        eager = e._run(*args, torch.Generator(device="cuda"),
                       pend["budget"], 1.0)
        other = g._run(*pend["args"], torch.Generator(device="cuda")
                       .manual_seed(4).get_state(), pend["gen"],
                       pend["budget"], 1.0)
        redo = torch.equal(again["mel"], pend["out"]["mel"]) and \
            torch.equal(again["mel"], eager["mel"])
        differ = not torch.equal(other["mel"], again["mel"])
        cfg = g.model.cfg
        masks, seeds = [], []
        for s in range(8):
            gs = torch.Generator(device="cuda").manual_seed(100 + s)
            state = gs.get_state()
            g._run(*pend["args"], state, gs, pend["budget"], 1.0)
            gs.set_state(state)  # the replay's first draw: its kernel seed
            seeds.append(int(kernel_seed(gs, torch.device("cuda"))))
            masks += [K.dropout_keep_mask(seeds[-1], cfg.dropout_rate, 96,
                                          cfg.prenet_units, step=t, layer=l)
                      for t in range(4) for l in range(2)]
        kept = torch.stack(masks) > 0
        keep = float(kept.float().mean())
        sigma = (cfg.dropout_rate * (1 - cfg.dropout_rate)
                 / kept.numel()) ** 0.5
        z = abs(keep - (1 - cfg.dropout_rate)) / sigma
        log(f"[compiled] student_b1 re-dispatch from a saved state: replay "
            f"== first replay == eager {redo}; another state's mel differs "
            f"{differ}; prenet keep rate over 8 replays' seeds {seeds[:3]}.."
            f" (4 steps x 2 layers x 96 x {cfg.prenet_units} each) {keep:.5f}"
            f" (want {1 - cfg.dropout_rate}, {z:.2f} standard errors; limit "
            f"{KEEP_SIGMAS})")
        if not (redo and differ and z < KEEP_SIGMAS
                and len(set(seeds)) == len(seeds)):
            raise RuntimeError("compiled: re-dispatch, states or keep rate")
        out["redispatch_equal"], out["keep_rate"] = redo, keep

    # text -> wav and the stream (the student)
    pg = TTSPipeline(models["student"], pwg)
    pe = TTSPipeline(models["student"], pwg)
    pe.graphed = False
    zero_counts()
    wg, _ = pg.tts_batch([tok1], 0, durations=[dur1])
    torch.cuda.synchronize()
    counts = read_counts()
    for k, v in counts.items():
        launches[k] += v
    we, _ = pe.tts_batch([tok1], 0, durations=[dur1])
    bit = _same(wg, we)
    rtf = {}
    for name, p in (("graphed", pg), ("eager", pe)):
        rtf[name] = float(np.median([p.tts_batch([tok1], r, durations=[dur1])
                                     [1]["rtf_x"] for r in range(5)]))
    graphs.append(pg.graphs)
    out["tts_student_b1"] = {"bit_equal": bit, "rtf": rtf,
                             "launches": counts}
    log(f"[compiled] tts_student_b1: graphed vs eager wav bit-equal {bit}; "
        f"RTF median of 5 graphed {rtf['graphed']:.1f} vs eager "
        f"{rtf['eager']:.1f}; launches {counts} on {kind}")
    if not bit:
        raise RuntimeError("compiled tts_student_b1: wavs differ")
    sg = StreamTTS(models["student"], pwg)
    se = StreamTTS(models["student"], pwg)
    se.eager = set(se.graphs)
    zero_counts()
    cg = list(sg.stream(tok1, 0, durations=dur1))
    torch.cuda.synchronize()
    counts = read_counts()
    for k, v in counts.items():
        launches[k] += v
    ce = list(se.stream(tok1, 0, durations=dur1))
    bit = _same(cg, ce)
    ttfa = {}
    for name, s in (("graphed", sg), ("eager", se)):
        reps = [timed_stream(s, tok1, dur1, r)[:2] for r in range(5)]
        ttfa[name] = [float(v) for v in np.median(np.array(reps), axis=0)]
    graphs += list(sg.graphs.values())
    out["stream_student"] = {"bit_equal": bit, "chunks": len(cg),
                             "ttfa_ms_xrt": ttfa, "launches": counts}
    log(f"[compiled] stream_student: {len(cg)} chunks graphed vs eager "
        f"bit-equal {bit}; time to first audio median of 5 graphed "
        f"{ttfa['graphed'][0]:.2f} ms vs eager {ttfa['eager'][0]:.2f} ms, "
        f"x realtime {ttfa['graphed'][1]:.1f} vs {ttfa['eager'][1]:.1f}; "
        f"launches {counts} on {kind}")
    if not bit:
        raise RuntimeError("compiled stream_student: chunks differ")
    from fcl_taco2_tpu_torch.utils.graphs import pool_reserved_bytes
    out["graphs"] = _graph_rows(*graphs)
    pool = pool_reserved_bytes("cuda")
    out["pool_mib"] = None if pool is None else pool / 2 ** 20
    log("[compiled] captures (seconds with the warm-ups, pool MiB newly "
        "reserved by the capture, replays, kernels a replay): "
        + json.dumps(out["graphs"]) + "; the shared graph pool holds "
        + ("not measured" if pool is None else f"{pool / 2 ** 20:.1f} MiB")
        + " after every serving capture of the run so far")
    log("[compiled] " + json.dumps({k: v for k, v in out.items()
                                    if k != "graphs"}))
    return launches


def compiled_steps(smi, kind, n=4):
    """Graphed train, KD and eval steps against eager, bit for bit over
    ``n`` steps from the same state and seeds (fp32, TF32 off,
    deterministic algorithms, dropout and zoneout at their published
    rates): the teacher's single step and eval step on device-cache
    batches, the KD step with remat on and off and the KD eval step on
    the bench batch; then the graphed single step's time beside
    ``[graph]``'s chain.  No decoder or PWG kernel runs."""
    from fcl_taco2_tpu_torch.models import student_config, teacher_config
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import (make_eval_step,
                                                make_kd_eval_step,
                                                make_kd_train_step,
                                                make_train_step,
                                                step_generator)
    dev = TRAIN_DEVICE
    rows = {}

    def run(name, steps, states, batches, evals):
        losses = [[], []]
        for j, b in enumerate(batches):
            for i in range(2):
                ts, rep = steps[i](states[i], b(j),
                                   step_generator(0, states[i].step, dev))
                states[i] = ts
                losses[i].append(float(rep["loss"]))
        bit = losses[0] == losses[1] and all(
            torch.equal(a, b) for a, b in zip(
                states[0].model.state_dict().values(),
                states[1].model.state_dict().values()))
        reports = [[{k: float(v) for k, v in evals[i](
            states[i], b(j), step_generator(7, j, dev)).items()}
            for j, b in enumerate(batches)] for i in range(2)]
        rows[name] = {"bit_equal": bit, "losses": losses[1],
                      "eval_bit_equal": reports[0] == reports[1],
                      "capture_s": steps[1].capture_s,
                      "graph_pool_mib": steps[1].pool_bytes / 2 ** 20}
        log(f"[compiled] {name}: {len(batches)} graphed steps vs eager from "
            f"the same state and seeds: losses and every parameter and "
            f"buffer bit-equal {bit} (losses {losses[1][0]:.4f} -> "
            f"{losses[1][-1]:.4f}); eval reports bit-equal "
            f"{rows[name]['eval_bit_equal']}; capture "
            f"{steps[1].capture_s:.2f} s ({steps[1].WARMUP} warm-up steps), "
            f"pool {steps[1].pool_bytes / 2 ** 20:.1f} MiB | {smi}")
        if not (bit and rows[name]["eval_bit_equal"]):
            raise RuntimeError(f"compiled {name}: graphed differs from eager")

    with tempfile.TemporaryDirectory() as root, tf32(False), \
            deterministic() as nondet:
        utts = graph_corpus(os.path.join(root, "corpus"), 48)
        models = graph_models()
        cfg = teacher_config(IDIM, odim=ODIM, compute_dtype="float32",
                             duration_classes=DURATION_CLASSES)
        dc, packs, pairs = graph_setup(cfg, utts, n, models)
        states = [ts for ts, _ in pairs]
        steps = [make_train_step(tx, graphed=g)
                 for (_, tx), g in zip(pairs, (False, True))]
        evals = [make_eval_step(graphed=g) for g in (False, True)]
        run("train_step", steps, states, [lambda j: dc.assemble(packs[j])]
            * n, evals)
        del models, dc, states, steps, pairs
        for remat in (True, False):
            kw = dict(odim=ODIM, duration_classes=DURATION_CLASSES,
                      remat_decoder=remat, compute_dtype="float32")
            kds = [KDStudent(student_config(IDIM, **kw),
                             teacher_config(IDIM, **kw), device=dev, seed=0)
                   for _ in range(2)]
            batch, _ = train_batch(TRAIN_B, kds[0].scfg
                                   .effective_duration_classes, dev)
            states, steps = [], []
            for kd, g in zip(kds, (False, True)):
                tx = build_optimizer(name="adam", lr=1e-3, grad_clip=1.0)
                names, params = zip(*kd.student.named_parameters())
                states.append(TrainState(kd.student, tx.init(params, names),
                                         0, tx))
                steps.append(make_kd_train_step(kd, tx, graphed=g))
            evals = [make_kd_eval_step(kd, graphed=g)
                     for kd, g in zip(kds, (False, True))]
            run(f"kd_step_remat_{'on' if remat else 'off'}", steps, states,
                [lambda j: batch] * n, evals)
            del kds, states, steps, evals
    from fcl_taco2_tpu_torch.utils.graphs import pool_reserved_bytes
    pool = pool_reserved_bytes("cuda")
    rows["pool_mib"] = None if pool is None else pool / 2 ** 20
    log(f"[compiled] deterministic algorithms on; ops without a "
        f"deterministic version: {sorted(nondet) or 'none'}; the shared "
        f"graph pool holds "
        + ("not measured" if pool is None else f"{pool / 2 ** 20:.1f} MiB")
        + " after the step captures")
    rows["single_step_timing"] = train_step_timing(
        smi, kind, DURATION_CLASSES, graphed=True)
    log("[compiled] " + json.dumps({"steps": rows, "device": smi}))


def _bit_row(tag, graphed, eager, ms, counts, smi, extra=""):
    """Log and check one graphed-against-eager case of
    ``compiled_routes``; returns its row."""
    bit = _same(graphed, eager)
    log(f"[compiled] {tag}: graphed vs eager bit-equal {bit}; ms (median "
        f"of 5 after one, synchronized) graphed {ms['graphed']:.3f} vs "
        f"eager {ms['eager']:.3f}{extra}; launches {counts} | {smi}")
    if not bit:
        raise RuntimeError(f"compiled {tag}: graphed differs from eager")
    return {"bit_equal": bit, "ms": ms, "launches": counts}


def compiled_routes(models, pwg, kind, smi):
    """The paths graphed since the JAX package's last eager ones were
    ported, each against its eager call bit for bit: teacher_b16 on the
    ``scan`` and ``hybrid`` routes (published dropout 0.5, so the replays'
    prenet draws are checked too), with the scan's extra steps (it runs to
    the static step count) timed against the loop cut at the bound;
    ``fcl_vocode``'s bucket (a 200-frame mel, bucket 256); a
    ``vocode_chunked`` utterance (400 frames, chunks of 64); one
    preprocessing bucket (4 utterances of 3-4 s).  Returns the launch
    counts of the graphed calls."""
    from fcl_taco2_tpu_torch.audio.preprocess import (Frontend,
                                                      PreprocessConfig)
    from fcl_taco2_tpu_torch.cli.fcl_vocode import BucketVocoder
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.infer.pipeline import vocode_chunked
    from fcl_taco2_tpu_torch.models.decoder import decoder_inference
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    from fcl_taco2_tpu_torch.utils.graphs import Graphed
    from fcl_taco2_tpu_torch.vocoder.pwg_cuda import pack_pwg_weights
    _, _, toks16, durs16 = protocol()
    launches = dict.fromkeys(_counters(), 0)
    out = {}

    def graphed_launches(fn):
        zero_counts()
        res = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        for k, v in counts.items():
            launches[k] += v
        return res, counts

    for backend in ("scan", "hybrid"):
        g = Synthesizer(models["teacher"], batch_size=16,
                        decoder_backend=backend)
        e = Synthesizer(models["teacher"], batch_size=16,
                        decoder_backend=backend)
        e.graphed = False
        (mg, st), counts = graphed_launches(
            lambda: g.synth_batch(toks16, 0, durations=durs16))
        me, _ = e.synth_batch(toks16, 0, durations=durs16)
        ms = {n: float(np.median([s.synth_batch(toks16, r, durations=durs16)
                                  [1]["wall_sec"] * 1e3
                                  for r in range(6)][1:]))
              for n, s in (("graphed", g), ("eager", e))}
        if (counts["fused_ar_decode_hbm"] == 0) != (backend == "scan") or \
                not g.graphs.entries:
            raise RuntimeError(f"compiled teacher_b16 {backend}: launches "
                               f"{counts}, graphs {len(g.graphs.entries)}")
        out[f"teacher_b16_{backend}"] = _bit_row(
            f"teacher_b16 {backend} (dropout 0.5, synth_batch)", mg, me, ms,
            counts, smi)
        if backend != "scan":
            continue
        # the scan's loop to S = max_dur against the loop cut at the
        # batch's bound (the eager route before it was graphed)
        m, seen = g.model, {}
        orig = m.decode_segments

        def spy(*a, **k):
            seen["a"], seen["k"] = a, k
            return orig(*a, **k)

        tokens, ilens, dd = _padded(toks16, durs16, 16, g.tok_bucket)
        m.decode_segments = spy
        try:
            m.synthesize(tokens, ilens, 0, st["budget"], durations=dd,
                         decoder_backend="scan")
        finally:
            del m.decode_segments
        enc, dur, pos, fm, gen = seen["a"]
        sb = seen["k"]["step_bound"]
        bound, S = int(sb), fm.shape[1]
        dec, cfg = m.decoder, m.cfg
        scan = Graphed(lambda x, gn: decoder_inference(
            dec, cfg, x[0], x[1], x[2], x[3], gn, step_bound=x[4]), "cuda",
            "scan_decode")
        with torch.no_grad():
            steps = {
                "graphed_S": host_median_ms(lambda: scan(
                    None, (enc, dur, pos, fm, sb), gen)),
                "eager_S": host_median_ms(lambda: decoder_inference(
                    dec, cfg, enc, dur, pos, fm, gen, step_bound=sb)),
                "eager_bound": host_median_ms(lambda: decoder_inference(
                    dec, cfg, enc, dur, pos[:, :bound], fm[:, :bound],
                    gen))}
        out["scan_steps"] = {"S": S, "bound": bound, "P": fm.shape[0],
                             "ms": steps}
        log(f"[compiled] teacher_b16 scan decode (P {fm.shape[0]}, "
            f"{enc.dtype}): "
            f"the loop to S = {S} steps, graphed {steps['graphed_S']:.3f} "
            f"ms, eager {steps['eager_S']:.3f} ms, against the eager loop "
            f"cut at the batch's bound of {bound} steps "
            f"{steps['eager_bound']:.3f} ms (median of 5 after one) | {smi}")

    # fcl_vocode's bucket and a vocode_chunked utterance
    rng = np.random.default_rng(0)
    mel = (rng.normal(size=(400, pwg.cfg.aux_channels)) * 0.5).astype(
        np.float32)
    packed = pack_pwg_weights(pwg, pwg.cfg)
    vg = BucketVocoder(pwg, pwg.cfg, packed=packed)
    ve = BucketVocoder(pwg, pwg.cfg, packed=packed)
    ve.graphed = False

    def gen0():
        return torch.Generator(device="cuda").manual_seed(0)

    wg, counts = graphed_launches(lambda: vg(mel[:200], gen0()))
    we = ve(mel[:200], gen0())
    ms = {n: host_median_ms(lambda v=v: v(mel[:200], gen0()))
          for n, v in (("graphed", vg), ("eager", ve))}
    if counts["pwg_generate_streaming"] == 0:
        raise RuntimeError(f"compiled fcl_vocode: launches {counts}")
    out["fcl_vocode"] = _bit_row("fcl_vocode bucket (200 frames -> 256)",
                                 [wg], [we], ms, counts, smi)
    noise = torch.randn(400 * pwg.cfg.hop, generator=gen0(),
                        device="cuda")

    def chunked(graphed):
        return np.concatenate(list(vocode_chunked(
            pwg, pwg.cfg, mel, noise, chunk_frames=64, graphed=graphed)))

    cg, counts = graphed_launches(lambda: chunked(True))
    ms = {n: host_median_ms(lambda f=f: chunked(f))
          for n, f in (("graphed", True), ("eager", False))}
    out["vocode_chunked"] = _bit_row(
        "vocode_chunked (400 frames, chunks of 64, pwg_generate)", [cg],
        [chunked(False)], ms, counts, smi)

    # one preprocessing bucket
    pcfg = PreprocessConfig()
    t = np.arange(88200) / SAMPLE_RATE
    wavs = [(0.3 * np.sin(2 * np.pi * f * t[:n]) + 0.01 * rng.normal(
        size=n)).astype(np.float32)
        for f, n in ((110, 66150), (180, 72000), (220, 80000), (300, 88200))]
    fg = Frontend(pcfg)
    fe = Frontend(pcfg)
    fe.graphed = False
    if len(list(fg._buckets(wavs))) != 1:
        raise RuntimeError("compiled frontend: not one bucket")
    featg, counts = graphed_launches(lambda: fg.process(wavs))
    feate = fe.process(wavs)
    ms = {}
    for n, f in (("graphed", fg), ("eager", fe)):
        f.bucket_stats.clear()
        for _ in range(6):
            f.process(wavs)
        ms[n] = float(np.median([b["ms"] for b in f.bucket_stats][1:]))
    out["frontend"] = _bit_row(
        f"preprocessing bucket ({len(wavs)} rows x "
        f"{fg.bucket_stats[-1]['samples']} samples: STFT, mel, energy, "
        f"YIN; device ms between events around the call)",
        [x for r in featg for x in r], [x for r in feate for x in r], ms,
        counts, smi)
    log("[compiled] " + json.dumps({"routes": out, "device": smi}))
    return launches


def phase_compiled(models, pwg, smi, kind):
    """CUDA graphs wherever the JAX package jits: serving, then the
    steps.  Returns the serving calls' launch counts."""
    launches = compiled_serving(models, pwg, kind, smi)
    for k, v in compiled_routes(models, pwg, kind, smi).items():
        launches[k] += v
    zero_counts(evaluations_apart=True)
    compiled_steps(smi, kind)
    counts = read_counts()
    check_training_counts("[compiled] steps", counts)
    launches[TRAIN_KERNEL] += counts[TRAIN_KERNEL]
    return launches


# ---------------------------------------------------------------------------
# [bench]: the bench scripts' measurements, once each
# ---------------------------------------------------------------------------

BENCH_SCRIPTS = ("torch_bench", "torch_bench_kd", "torch_bench_stream",
                 "torch_bench_train_loop", "torch_bench_pwg",
                 "torch_bench_decoder", "torch_train_roofline")


def _spreads(x):
    """Every timing spread (a dict with median, min, max and n) in x."""
    if isinstance(x, dict):
        if {"median", "min", "max", "n"} <= set(x):
            yield x
            return
        for v in x.values():
            yield from _spreads(v)
    elif isinstance(x, list):
        for v in x:
            yield from _spreads(v)


def phase_bench(smi, kind):
    """Each card bench script's ``smoke()`` (its measurement functions at
    full width, one reading each, as ``--smoke`` runs them): every row
    names this card and its power limit, and every timing in it is finite
    and positive; the bench paths together launch all four kernels.
    Returns the launch counts."""
    zero_counts()
    for name in BENCH_SCRIPTS:
        t0 = time.perf_counter()
        rows = bench_script(name).smoke()
        for row in rows:
            spreads = list(_spreads(row))
            bad = [s for s in spreads for k in ("median", "min", "max")
                   if not (np.isfinite(s[k]) and s[k] > 0)]
            if row.get("card") != smi or not spreads or bad:
                raise RuntimeError(f"[bench] {name}: row {row.get('name')} "
                                   f"card {row.get('card')!r} (want {smi!r}),"
                                   f" {len(spreads)} timings, bad {bad}")
        log(f"[bench] {name}.smoke() on {kind}: {len(rows)} rows in "
            f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
                f"{r.get('name')} {next(_spreads(r))['median']:.4g}"
                for r in rows))
    counts = read_counts()
    log(f"[bench] launches {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise RuntimeError(f"[bench]: the bench paths did not launch "
                           f"{missing}")
    return counts


TRAIN_DEVICE = "cuda"  # the [train] phase's device
TRAIN_B = 16                      # bench.py:335, the teacher's batch
DURATION_CLASSES = (8, 16, 32, 50)  # bench.py:339, the CLI default
TOL_LOSS_VJP = 1e-6
TOL_GRAD_VJP = 1e-4
TOL_VJP_WHY = ("the same forward math op for op (loss); each weight "
               "gradient one GEMM over all S*P step rows instead of "
               "autograd's per-step sums (gradients, max|a-b|/max|a| a "
               "leaf)")
# FCL-taco2-S (models/config.py::student_config) through fcl_train's flags
STUDENT_ARGS = ["--embed-dim", "256", "--eunits", "256", "--econv-chans",
                "256", "--dunits", "256", "--prenet-units", "256",
                "--postnet-chans", "128"]
NO_DROPOUT = dict(dropout_rate=0.0, zoneout_rate=0.0,
                  duration_predictor_dropout_rate=0.0,
                  pitch_predictor_dropout_rate=0.0,
                  pitch_embed_dropout_rate=0.0,
                  energy_predictor_dropout_rate=0.0,
                  energy_embed_dropout_rate=0.0)


def bench_script(name):
    """The module of ``scripts/<name>.py`` (a bench script), loaded from
    its file."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train_vjp_check(smi):
    """The hand-built decoder backward against autograd through the plain
    loop, FCL-taco2-T at full width, fp32, TF32 off, every dropout and
    zoneout 0, one 96-phoneme utterance, classed and single-class plans."""
    from fcl_taco2_tpu_torch.models import Tacotron2SA, teacher_config
    cfg = teacher_config(IDIM, odim=ODIM, compute_dtype="float32",
                         **NO_DROPOUT)
    model = Tacotron2SA(cfg, device=TRAIN_DEVICE, seed=0)
    params = list(model.parameters())
    for classes in (DURATION_CLASSES, ()):
        batch, _ = train_batch(1, classes, TRAIN_DEVICE)
        out = {}
        with tf32(False):
            for custom in (True, False):
                model.cfg = cfg.replace(decoder_custom_vjp=custom,
                                        duration_classes=classes)
                gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(0)
                loss, _ = model.loss_fn(batch, gen)
                out[custom] = (float(loss), torch.autograd.grad(loss, params))
        model.cfg = cfg
        (l1, g1), (l0, g0) = out[True], out[False]
        loss_err = abs(l1 - l0) / abs(l0)
        grad_err, worst = max(
            (float((a - b).abs().max() / (a.abs().max() + 1e-30)), n)
            for (n, _), a, b in zip(model.named_parameters(), g0, g1))
        tag = "classed" if classes else "single-class"
        log(f"[train] vjp teacher {tag} fp32 TF32 off: loss {l1:.6f} vs "
            f"autograd {l0:.6f} rel err {loss_err:.2e} (tol "
            f"{TOL_LOSS_VJP:g}); worst gradient leaf {worst} "
            f"{grad_err:.2e} (tol {TOL_GRAD_VJP:g}: {TOL_VJP_WHY}) | {smi}")
        if not loss_err <= TOL_LOSS_VJP:
            raise RuntimeError(f"train vjp {tag}: loss {l1} vs {l0}")
        if not grad_err <= TOL_GRAD_VJP:
            raise RuntimeError(f"train vjp {tag}: gradient {worst} "
                               f"{grad_err}")


def train_step_timing(smi, kind, classes, warmup=3, reps=10,
                      kd_remat=None, graphed=False):
    """The teacher train step at the bench protocol (bench.py:383-447):
    B=16, bf16 compute, Adam lr 1e-3, clip 1.0; CUDA events around whole
    steps, then synchronized forward / backward / optimizer splits.  With
    ``kd_remat`` True or False, the KD step instead (scripts/bench_kd.py:
    the full-width student distilled from the full-width teacher, the
    same batch), with ``remat_decoder`` on or off.  ``graphed``: the step
    as the trainers run it on the card, a CUDA graph replay (the first
    warm-up step captures it); else eager."""
    from fcl_taco2_tpu_torch.models import (Tacotron2SA, student_config,
                                            teacher_config)
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.train.loop import step_generator
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import apply_update, make_train_step
    tag = "classed " + ",".join(map(str, classes)) if classes \
        else "single-class"
    if kd_remat is None:
        model = Tacotron2SA(teacher_config(IDIM, odim=ODIM,
                                           duration_classes=classes),
                            device=TRAIN_DEVICE, seed=0)
        loss_fn = model.loss_fn
        head = (f"[{'compiled' if graphed else 'train'}] teacher "
                f"B={TRAIN_B} bf16 {tag} {'graphed' if graphed else 'eager'}"
                " single step")
    else:
        kw = dict(odim=ODIM, duration_classes=classes,
                  remat_decoder=kd_remat)
        kd = KDStudent(student_config(IDIM, **kw), teacher_config(IDIM, **kw),
                       device=TRAIN_DEVICE, seed=0)
        model, loss_fn = kd.student, kd.loss_fn
        head = (f"[kd] KD step (student from teacher) B={TRAIN_B} bf16 "
                f"{tag} remat {'on' if kd_remat else 'off'} "
                f"{'graphed' if graphed else 'eager'}")
    cfg = model.cfg
    tx = build_optimizer(name="adam", lr=1e-3, grad_clip=1.0)
    ts = TrainState(model, tx.init(list(model.parameters())), 0)
    step = make_train_step(tx, loss_fn, graphed=graphed)
    batch, olens = train_batch(TRAIN_B, cfg.effective_duration_classes,
                               TRAIN_DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warmup + reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ts, report = step(ts, batch, step_generator(0, ts.step, TRAIN_DEVICE))
        end.record()
        end.synchronize()
        losses.append(float(report["loss"]))
        if i >= warmup:
            times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = []
    params = list(model.parameters())
    for _ in range(3):
        gen = step_generator(0, ts.step, TRAIN_DEVICE)
        (loss, (_, new_state, _)), fwd = timed(
            lambda: loss_fn(batch, gen))
        grads, bwd = timed(lambda: torch.autograd.grad(loss, params))
        _, opt = timed(lambda: apply_update(ts, tx, list(grads), new_state))
        split.append((fwd, bwd, opt))
    fwd, bwd, opt = np.median(np.array(split), axis=0)
    ms = float(np.median(times))
    busy = device_busy_ms(lambda: step(ts, batch, step_generator(
        0, ts.step, TRAIN_DEVICE)))
    frames = int(olens.sum())
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{head}: non-finite loss {losses}")
    log(f"{head} on {kind}: step "
        f"{ms:.2f} ms median of {reps} after {warmup} warm-up (min "
        f"{min(times):.2f}, max {max(times):.2f}; CUDA events around the "
        f"whole step); split forward {fwd:.2f} + backward {bwd:.2f} + "
        f"optimizer {opt:.2f} ms (host clock, synchronized, median of 3); "
        f"{frames / ms * 1e3:.0f} frames/s ({frames} frames); device busy "
        f"{_busy_text(busy, ms)}; peak memory {peak:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} | {smi}")
    row = {"classes": list(classes), "step_ms": ms,
           "step_ms_min": min(times), "step_ms_max": max(times),
           "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
           "frames_per_s": frames / ms * 1e3, "peak_gib": peak,
           "device_busy_ms": busy,
           "device_idle_share": None if busy is None else 1 - busy / ms,
           "loss_first": losses[0], "loss_last": losses[-1]}
    if kd_remat is not None:
        row["kd_remat"] = kd_remat
    row["graphed"] = graphed
    if graphed:
        row.update(capture_s=step.capture_s,
                   graph_pool_mib=step.pool_bytes / 2 ** 20)
    return row


def _busy_text(busy, ms):
    if busy is None:
        return "not measured (the profiler trace held no device time)"
    return (f"{busy:.2f} ms of the {ms:.2f} ms step (union of the device "
            f"events of one profiled step over the median step; idle share "
            f"{1 - busy / ms:.2f})")


def train_cli_check(smi):
    """``fcl_train.main`` at FCL-taco2-S full width on a learnable corpus:
    2 epochs, then a resume from the snapshot for a third."""
    from fcl_taco2_tpu_torch.cli.fcl_train import main as fcl_train
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train import checkpoint as ckpt
    torch.cuda.reset_peak_memory_stats()  # the trainer logs its own peak
    with tempfile.TemporaryDirectory() as root:
        train_json, valid_json = write_learnable_corpus(
            root, 49, 7, vocab=IDIM, odim=ODIM, length=(24, 49),
            max_dur=MAX_DUR, mean_dur=MEAN_DUR)
        exp = os.path.join(root, "exp")
        args = ["--train-json", train_json, "--valid-json", valid_json,
                "--outdir", exp, "--batch-size", "8", "--minibatches", "6",
                "--seed", "0", "--device", TRAIN_DEVICE, *STUDENT_ARGS]
        t0 = time.perf_counter()
        ts2 = fcl_train(args + ["--epochs", "2"])
        t_two = time.perf_counter() - t0
        with open(os.path.join(exp, "log.jsonl")) as f:
            log_rows = [json.loads(line) for line in f]
        l1, l2 = (r["main/loss"] for r in log_rows[:2])
        snap = os.path.join(exp, "snapshot.ep.2")
        saved_step = ckpt.read_checkpoint(snap)["step"]
        ts3 = fcl_train(args + ["--epochs", "3", "--resume", snap])
        with open(os.path.join(exp, "log.jsonl")) as f:
            third = [json.loads(line) for line in f][2]
        cfg, _ = ckpt.load_model_json(exp)
        if cfg != ts3.model.cfg:
            raise RuntimeError("train cli: model.json != the trained config")
        for name in ("snapshot.ep.1", "snapshot.ep.2", "model.loss.best",
                     "snapshot.ep.3"):
            m = ckpt.load_params_only(
                os.path.join(exp, name),
                Tacotron2SA(cfg, device=TRAIN_DEVICE, seed=1))
            if not all(torch.isfinite(p).all() for p in m.parameters()):
                raise RuntimeError(f"train cli: {name} restores non-finite")
        # the last snapshot holds the run's final state exactly
        for a, b in zip(ts3.model.state_dict().values(),
                        m.state_dict().values()):
            if not torch.equal(a, b):
                raise RuntimeError("train cli: snapshot.ep.3 != the run")
        n_opt, opt_diff = restored_opt_state_diff(snap, cfg, ts3.tx)
        if opt_diff:
            raise RuntimeError(f"train cli: the restored optimizer state "
                               f"differs from snapshot.ep.2's: {opt_diff}")
    log(f"[train] fcl_train student full width, batch 8, 6 steps an epoch: "
        f"mean loss epoch 1 {l1:.4f}, epoch 2 {l2:.4f}; resumed from "
        f"snapshot.ep.2 (step {saved_step}) for epoch {third['epoch']}, "
        f"ended at step {ts3.step} (epoch 3 loss "
        f"{third['main/loss']:.4f}); model.json, snapshot.ep.1-3 and "
        f"model.loss.best restore; the restored optimizer state (optax's "
        f"layout, {n_opt} leaves: mu, nu, counters) equals snapshot.ep.2's "
        f"bit for bit; 2 epochs in {t_two:.1f} s wall, peak "
        f"memory {log_rows[1].get('max_memory_allocated_gib')} GiB | {smi}")
    if not l2 < l1:
        raise RuntimeError(f"train cli: loss did not fall ({l1} -> {l2})")
    if ts2.step != saved_step or third["epoch"] != 3 \
            or ts3.step != saved_step + 6 or third["step"] != ts3.step:
        raise RuntimeError(f"train cli: saved step {saved_step}, resumed "
                           f"run ended at {ts3.step} ({third})")


def restored_opt_state_diff(path, cfg, tx):
    """Restore ``path`` into a fresh state with optimizer ``tx`` and write
    its optimizer state back in optax's layout: (leaves, the paths of the
    leaves that differ from the file's in value, dtype or shape)."""
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train import checkpoint as ckpt
    from fcl_taco2_tpu_torch.train.state import TrainState
    model = Tacotron2SA(cfg, device=TRAIN_DEVICE, seed=1)
    names, params = zip(*model.named_parameters())
    ts = TrainState(model, tx.init(params, names), 0, tx)
    ckpt.restore_checkpoint(path, ts)
    again = ckpt.to_optax(tx, ts.opt_state, list(names))
    saved = ckpt.read_checkpoint(path)["opt_state"]
    leaves, diff = 0, []

    def walk(a, b, where):
        nonlocal leaves
        if isinstance(a, dict) or isinstance(b, dict):
            if not (isinstance(a, dict) and isinstance(b, dict)
                    and set(a) == set(b)):
                diff.append(where)
                return
            for k in a:
                walk(a[k], b[k], f"{where}/{k}")
            return
        leaves += 1
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape \
                or not np.array_equal(a, b):
            diff.append(where)

    walk(again, saved, "opt_state")
    return leaves, diff


def phase_train(smi, kind):
    """Training on the card: the hand-built backward held to autograd, the
    teacher step at the bench protocol (classed and single-class), and the
    trainer end to end with a resume.  No decoder or PWG kernel runs; the
    regroup gathers' backward does."""
    zero_counts(evaluations_apart=True)
    t0 = time.perf_counter()
    train_vjp_check(smi)
    rows = [train_step_timing(smi, kind, classes)
            for classes in (DURATION_CLASSES, ())]
    train_cli_check(smi)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[train] kernel launches during the phase {counts} (the training "
        f"path runs only {TRAIN_KERNEL}); phase "
        f"{time.perf_counter() - t0:.1f} s")
    check_training_counts("[train]", counts)
    log("[train] " + json.dumps({"train_steps": rows, "device": smi}))


# FCL-taco2-T's widths for fcl_train's --teacher-config, in JSON (also
# valid yaml; the GPU host has no PyYAML)
TEACHER_CONF = {"embed-dim": 512, "eunits": 512, "econv-chans": 512,
                "dunits": 1024, "prenet-units": 256, "postnet-chans": 512}
KD_KEYS = ("main/encoder_loss", "main/decoder_loss", "main/prosody_loss",
           "main/output_l1_loss")


def kd_vjp_check(smi):
    """The KD loss (captures on) through the hand-built backward and
    through checkpointed steps (remat) against autograd through the plain
    loop: FCL-taco2-S distilled from FCL-taco2-T at full width, fp32, TF32
    off, every dropout and zoneout 0, one 96-phoneme utterance, classed
    and single-class plans."""
    from fcl_taco2_tpu_torch.models import student_config, teacher_config
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    kw = dict(odim=ODIM, compute_dtype="float32", **NO_DROPOUT)
    kd = KDStudent(student_config(IDIM, **kw), teacher_config(IDIM, **kw),
                   device=TRAIN_DEVICE, seed=0)
    cfg = kd.student.cfg
    params = list(kd.student.parameters())
    names = [n for n, _ in kd.student.named_parameters()]
    for classes in (DURATION_CLASSES, ()):
        batch, _ = train_batch(1, classes, TRAIN_DEVICE)
        out = {}
        with tf32(False):
            for path, over in (("autograd", dict(decoder_custom_vjp=False)),
                               ("hand-built", {}),
                               ("remat", dict(remat_decoder=True))):
                kd.student.cfg = cfg.replace(duration_classes=classes,
                                             **over)
                gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(0)
                loss, _ = kd.loss_fn(batch, gen)
                out[path] = (float(loss.detach()),
                             torch.autograd.grad(loss, params))
        kd.student.cfg = cfg
        l0, g0 = out["autograd"]
        tag = "classed" if classes else "single-class"
        for path in ("hand-built", "remat"):
            l1, g1 = out[path]
            loss_err = abs(l1 - l0) / abs(l0)
            grad_err, worst = max(
                (float((a - b).abs().max() / (a.abs().max() + 1e-30)), n)
                for n, a, b in zip(names, g0, g1))
            log(f"[kd] {path} vs autograd, KD loss with captures, {tag}, "
                f"fp32 TF32 off: loss {l1:.6f} vs {l0:.6f} rel err "
                f"{loss_err:.2e} (tol {TOL_LOSS_VJP:g}); worst gradient leaf "
                f"{worst} {grad_err:.2e} (tol {TOL_GRAD_VJP:g}: "
                f"{TOL_VJP_WHY}) | {smi}")
            if not loss_err <= TOL_LOSS_VJP:
                raise RuntimeError(f"kd {path} {tag}: loss {l1} vs {l0}")
            if not grad_err <= TOL_GRAD_VJP:
                raise RuntimeError(f"kd {path} {tag}: gradient {worst} "
                                   f"{grad_err}")


def kd_trainers(smi, root):
    """``fcl_train`` trains FCL-taco2-T at full width for one epoch on a
    learnable corpus; ``fcl_train --perform-KD True`` distils FCL-taco2-S
    from its checkpoint for 2 epochs (remat on, the KD default).  Returns
    (teacher checkpoint, student checkpoint, train manifest, validation
    manifest)."""
    from fcl_taco2_tpu_torch.cli.fcl_train import main as fcl_train
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    from fcl_taco2_tpu_torch.train import checkpoint as ckpt
    train_json, valid_json = write_learnable_corpus(
        root, 49, 7, vocab=IDIM, odim=ODIM, length=(24, 49),
        max_dur=MAX_DUR, mean_dur=MEAN_DUR)
    common = ["--train-json", train_json, "--valid-json", valid_json,
              "--batch-size", "8", "--minibatches", "6", "--seed", "0",
              "--device", TRAIN_DEVICE]
    teacher, student = os.path.join(root, "teacher"), os.path.join(root,
                                                                   "student")
    t0 = time.perf_counter()
    fcl_train(common + ["--outdir", teacher, "--epochs", "1"] + [
        a for k, v in TEACHER_CONF.items() for a in (f"--{k}", str(v))])
    t_teacher = time.perf_counter() - t0
    tckpt = os.path.join(teacher, "model.loss.best")
    tconf = os.path.join(root, "teacher.json")
    with open(tconf, "w") as f:
        json.dump(TEACHER_CONF, f)
    torch.cuda.reset_peak_memory_stats()  # the KD trainer logs its own
    t0 = time.perf_counter()
    ts = fcl_train(common + [
        "--outdir", student, "--epochs", "2", "--perform-KD", "True",
        "--teacher-config", tconf, "--teacher-checkpoint", tckpt,
        *STUDENT_ARGS])
    t_kd = time.perf_counter() - t0
    with open(os.path.join(student, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    l1, l2 = (r["main/loss"] for r in rows[:2])
    cfg, extra = ckpt.load_model_json(student)
    sckpt = os.path.join(student, "model.loss.best")
    log(f"[kd] fcl_train teacher full width, batch 8, 6 steps: 1 epoch in "
        f"{t_teacher:.1f} s; fcl_train --perform-KD True student full "
        f"width (remat {cfg.remat_decoder}): mean loss epoch 1 {l1:.4f}, "
        f"epoch 2 {l2:.4f} (KD terms epoch 2: "
        + ", ".join(f"{k[5:]} {rows[1][k]:.4f}" for k in KD_KEYS)
        + f"); 2 epochs ({ts.step} steps) in {t_kd:.1f} s wall, peak "
        f"memory {rows[1].get('max_memory_allocated_gib')} GiB | {smi}")
    missing = [k for k in KD_KEYS if k not in rows[0]]
    if missing:
        raise RuntimeError(f"kd cli: log.jsonl lacks {missing}")
    if not l2 < l1:
        raise RuntimeError(f"kd cli: loss did not fall ({l1} -> {l2})")
    if not cfg.remat_decoder or extra["teacher_checkpoint"] != tckpt \
            or "kd_proj" not in ckpt.read_checkpoint(sckpt)["params"]:
        raise RuntimeError("kd cli: model.json or the snapshot is wrong")
    return tckpt, sckpt, train_json, valid_json


def phase_kd(smi, kind, root):
    """KD on the card: the hand-built backward with captures held to
    autograd, the KD step at scripts/bench_kd.py's protocol with remat on
    and off, and the two trainers end to end.  No decoder or PWG kernel
    runs."""
    zero_counts(evaluations_apart=True)
    kd_vjp_check(smi)
    rows = [train_step_timing(smi, kind, DURATION_CLASSES, kd_remat=remat,
                              graphed=True)
            for remat in (True, False)]
    ckpts = kd_trainers(smi, root)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[kd] kernel launches during the phase {counts} (the KD path runs "
        f"only {TRAIN_KERNEL})")
    check_training_counts("[kd]", counts)
    log("[kd] " + json.dumps({"kd_steps": rows, "device": smi}))
    return ckpts


# ---------------------------------------------------------------------------
# [graph]: the device cache and the chained step as CUDA graph replays
# ---------------------------------------------------------------------------

TOL_GRAPH_LOSS = 1e-6
TOL_GRAPH_STATE = 1e-5
TOL_GRAPH_WHY = ("the same kernels in the same order with the same draws, "
                 "deterministic algorithms on: any difference is a fault "
                 "of the capture; without them the gathers' atomic "
                 "backward sums differ at 1e-7 and Adam amplifies that "
                 "to 1e-4 in a few steps")
GRAPH_CHAIN = 4  # fcl_train's auto chain with the device cache


class deterministic:
    """``torch.use_deterministic_algorithms`` (warn only) and cuDNN's
    deterministic choice inside the block, the previous switches restored
    after it; yields a set that receives the ops the warnings name."""

    def __enter__(self):
        import warnings
        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     torch.backends.cudnn.deterministic)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        self.caught = warnings.catch_warnings(record=True)
        self.records = self.caught.__enter__()
        warnings.simplefilter("always")
        self.ops = set()
        return self.ops

    def __exit__(self, *exc):
        self.caught.__exit__(*exc)
        for w in self.records:
            if "deterministic" in str(w.message):
                self.ops.add(str(w.message).split(" does not")[0][:80])
        torch.use_deterministic_algorithms(self.prev[0],
                                           warn_only=self.prev[1])
        torch.backends.cudnn.deterministic = self.prev[2]


def graph_corpus(root, n):
    """``n`` utterances of the bench protocol (96 phonemes, Poisson(8)
    durations clipped to [1, 50], idim 70, odim 80) written as a
    manifest; returns (utterances, converter fitted to them)."""
    from fcl_taco2_tpu_torch.data.converter import BatchConverter
    from fcl_taco2_tpu_torch.data.manifest import load_manifest
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    train_json, _ = write_learnable_corpus(
        root, n, 1, vocab=IDIM, odim=ODIM, length=(N_PHONES, N_PHONES + 1),
        max_dur=MAX_DUR, mean_dur=MEAN_DUR)
    return load_manifest(train_json)


def graph_models():
    """Two FCL-taco2-T models on the card (eager, graphed) and their
    seeded initial weights, shared by the [graph] cases."""
    from fcl_taco2_tpu_torch.models import Tacotron2SA, teacher_config
    models = [Tacotron2SA(teacher_config(IDIM, odim=ODIM),
                          device=TRAIN_DEVICE, seed=0) for _ in range(2)]
    init = {k: v.clone() for k, v in models[0].state_dict().items()}
    return models, init


def graph_setup(cfg, utts, n_steps, models, seed=0):
    """The two models reset to their initial weights under ``cfg`` with
    fresh optimizers (eager, graphed), the device cache over ``utts`` and
    ``n_steps`` plan packs of B=16 batches."""
    from fcl_taco2_tpu_torch.data.converter import BatchConverter
    from fcl_taco2_tpu_torch.data.device_cache import DeviceBatchCache
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    conv = BatchConverter(max_dur=cfg.max_dur, batch_size=TRAIN_B,
                          seg_bucket=64, odim=ODIM, cache={},
                          duration_classes=cfg.effective_duration_classes)
    conv.fit_corpus(utts)
    dc = DeviceBatchCache(conv, utts, TRAIN_DEVICE)
    rng = np.random.default_rng(seed)
    packs = torch.from_numpy(np.stack([
        dc.plan([utts[i] for i in rng.permutation(len(utts))[:TRAIN_B]])
        for _ in range(n_steps)])).to(TRAIN_DEVICE)
    states = []
    for model in models[0]:
        model.cfg = cfg
        model.load_state_dict(models[1])
        tx = build_optimizer(name="adam", lr=1e-3, grad_clip=1.0)
        names, params = zip(*model.named_parameters())
        states.append((TrainState(model, tx.init(params, names), 0), tx))
    return dc, packs, states


def graph_agreement(smi, utts, classes, models):
    """fp32, TF32 off, dropout and zoneout at the published rates: 8
    graphed steps (2 chains of 4) against 8 eager single steps from the
    same state and seed; then two single replays draw different zoneout
    masks."""
    from fcl_taco2_tpu_torch.models import teacher_config
    from fcl_taco2_tpu_torch.train.step import (make_chained_train_step,
                                                make_train_step,
                                                step_generator)
    cfg = teacher_config(IDIM, odim=ODIM, compute_dtype="float32",
                         duration_classes=classes)
    dc, packs, [(ts_e, tx_e), (ts_g, tx_g)] = graph_setup(cfg, utts, 8,
                                                          models)
    tag = "classed" if classes else "single-class"
    with tf32(False), deterministic() as nondet:
        step = make_train_step(tx_e, graphed=False)
        eager = []
        for j in range(8):
            ts_e, rep = step(ts_e, dc.assemble(packs[j]),
                             step_generator(0, ts_e.step, TRAIN_DEVICE))
            eager.append(float(rep["loss"]))
        chain = make_chained_train_step(tx_g, assemble=dc.assemble)
        graphed = []
        for c in range(2):
            ts_g, reps = chain(ts_g, packs[4 * c:4 * c + 4], 0)
            graphed += reps[:, chain.report_keys.index("loss")].tolist()
        state_err, worst, bit = 0.0, None, graphed == eager
        for (name, a), b in zip(ts_e.model.state_dict().items(),
                                ts_g.model.state_dict().values()):
            bit &= torch.equal(a, b)
            if torch.is_floating_point(a):
                err = float((a - b).abs().max() / (a.abs().max() + 1e-30))
                if err >= state_err:
                    state_err, worst = err, name
        # two single replays more: the zoneout masks the graph draws
        ts_g.model.decoder.mask_taps = taps = []
        probe = make_chained_train_step(tx_g, assemble=dc.assemble)
        probe.prepare(ts_g, packs[0], 0)
        n = len(cfg.effective_duration_classes) if classes else 1
        drawn = []
        for j in range(2):
            ts_g, _ = probe(ts_g, packs[j:j + 1], 0)
            drawn.append([t.clone() for t in taps[-n:]])
        ts_g.model.decoder.mask_taps = None
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(graphed, eager))
    same_masks = all(torch.equal(a, b) for a, b in zip(*drawn))
    keep = float(torch.cat([t.flatten() for t in drawn[0]]).float().mean())
    log(f"[graph] deterministic algorithms on for the comparison (the "
        f"gathers' backward accumulates by sort, cuDNN picks deterministic "
        f"convs); ops without a deterministic version: "
        f"{sorted(nondet) or 'none'}")
    log(f"[graph] teacher B={TRAIN_B} fp32 TF32 off {tag}, dropout "
        f"{cfg.dropout_rate} zoneout {cfg.zoneout_rate}: 8 graphed steps "
        f"(2 chains of {GRAPH_CHAIN}) vs 8 eager steps from the same state "
        f"and seed: worst loss rel err {loss_err:.2e} (tol "
        f"{TOL_GRAPH_LOSS:g}), worst parameter/buffer {worst} "
        f"{state_err:.2e} of max|a| (tol {TOL_GRAPH_STATE:g}: "
        f"{TOL_GRAPH_WHY}); bit-equal: {bit}; losses {eager[0]:.4f} -> "
        f"{eager[-1]:.4f}; replays 1 and 2 drew "
        f"{'the SAME' if same_masks else 'different'} zoneout masks (keep "
        f"share {keep:.4f}, rate {cfg.zoneout_rate}); capture "
        f"{chain.capture_s:.2f} s | {smi}")
    if not loss_err <= TOL_GRAPH_LOSS:
        raise RuntimeError(f"graph {tag}: losses {graphed} vs {eager}")
    if not state_err <= TOL_GRAPH_STATE:
        raise RuntimeError(f"graph {tag}: {worst} off by {state_err}")
    if same_masks or not drawn[0]:
        raise RuntimeError(f"graph {tag}: two replays drew the same masks")
    if abs(keep - cfg.zoneout_rate) > 5e-3:
        raise RuntimeError(f"graph {tag}: zoneout keep share {keep}")
    return {"classes": list(classes), "loss_rel_err": loss_err,
            "state_rel_err": state_err, "bit_equal": bit,
            "replay_masks_differ": not same_masks}


def graph_timing(smi, kind, utts, classes, models, chains=5, warmup=1):
    """bf16 at the bench protocol: ms a step over ``chains`` chains of 4
    after ``warmup`` chains, eager (assemble + step, 4 a chain) against
    graphed (4 replays a chain), CUDA events around each chain; the
    device busy share of one profiled chain each, capture seconds, graph
    pool and peak memory."""
    from fcl_taco2_tpu_torch.models import teacher_config
    from fcl_taco2_tpu_torch.train.step import (make_chained_train_step,
                                                make_train_step,
                                                step_generator)
    cfg = teacher_config(IDIM, odim=ODIM, duration_classes=classes)
    n = GRAPH_CHAIN * (chains + warmup)
    dc, packs, [(ts_e, tx_e), (ts_g, tx_g)] = graph_setup(cfg, utts, n,
                                                          models)
    step = make_train_step(tx_e, graphed=False)

    def eager_chain(c):
        nonlocal ts_e
        for j in range(GRAPH_CHAIN * c, GRAPH_CHAIN * (c + 1)):
            ts_e, rep = step(ts_e, dc.assemble(packs[j]),
                             step_generator(0, ts_e.step, TRAIN_DEVICE))
        return rep["loss"]

    chain = make_chained_train_step(tx_g, assemble=dc.assemble)

    last = []

    def graphed_chain(c):
        nonlocal ts_g
        ts_g, reps = chain(ts_g, packs[GRAPH_CHAIN * c:GRAPH_CHAIN
                                       * (c + 1)], 0)
        last[:] = [reps]
        return reps

    row = {"classes": list(classes)}
    for name, fn in (("eager", eager_chain), ("graphed", graphed_chain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for c in range(chains + warmup):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(c)
            end.record()
            end.synchronize()
            if c >= warmup:
                times.append(start.elapsed_time(end) / GRAPH_CHAIN)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = float(np.median(times))
        events = device_events(lambda: fn(chains + warmup - 1))
        busy = busy_ms(events)
        busy = None if busy is None else busy / GRAPH_CHAIN
        row[name] = {"step_ms": ms, "step_ms_min": min(times),
                     "step_ms_max": max(times), "device_busy_ms": busy,
                     "device_idle_share": None if busy is None
                     else 1 - busy / ms, "peak_gib": peak}
        log(f"[graph] teacher B={TRAIN_B} bf16 "
            f"{'classed' if classes else 'single-class'} {name} on {kind}: "
            f"{ms:.2f} ms a step, median of {chains} chains of "
            f"{GRAPH_CHAIN} after {warmup} (min {min(times):.2f}, max "
            f"{max(times):.2f}; CUDA events around each chain); device "
            f"busy {_busy_text(busy, ms)}; peak memory {peak:.2f} GiB | "
            f"{smi}")
    top, classes = top_kernels(events)
    top = [(k, round(t / GRAPH_CHAIN, 3), c // GRAPH_CHAIN)
           for k, t, c in top]
    classes = {k: (round(t / GRAPH_CHAIN, 3), c // GRAPH_CHAIN)
               for k, (t, c) in classes.items()}
    log(f"[graph] graphed step's device time by kernel class (ms a step, "
        f"launches a step): {classes}; top {len(top)} kernels: {top}")
    row["graphed"].update(top_kernels=top, kernel_classes=classes, capture_s=chain.capture_s,
                          graph_pool_gib=chain.pool_bytes / 2 ** 30)
    log(f"[graph] capture {chain.capture_s:.2f} s (3 warm-up steps on a "
        f"side stream from a copy of the state, then the capture), graph "
        f"pool {chain.pool_bytes / 2 ** 30:.2f} GiB; graphed / eager "
        f"{row['graphed']['step_ms'] / row['eager']['step_ms']:.3f} | {smi}")
    if not torch.isfinite(last[0]).all():
        raise RuntimeError("graph timing: non-finite report")
    return row


def graph_cli_check(smi, root):
    """``fcl_train`` with no runtime flags (auto: the device cache and 4
    steps a dispatch) against ``--device-cache off --steps-per-dispatch
    1`` on the learnable corpus, FCL-taco2-T widths, 2 epochs of 8 steps
    each; epoch-2 walls compared."""
    from fcl_taco2_tpu_torch.cli.fcl_train import main as fcl_train
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    train_json, valid_json = write_learnable_corpus(
        root, 64, 8, vocab=IDIM, odim=ODIM, length=(24, 49),
        max_dur=MAX_DUR, mean_dur=MEAN_DUR)
    rows = {}
    for name, extra in (
            ("auto", []),
            ("off", ["--device-cache", "off", "--steps-per-dispatch", "1"]),
            ("off_chain", ["--device-cache", "off", "--steps-per-dispatch",
                           "4"])):
        exp = os.path.join(root, f"graph_{name}")
        fcl_train(["--train-json", train_json, "--valid-json", valid_json,
                   "--outdir", exp, "--batch-size", "8", "--epochs", "2",
                   "--minibatches", "8",
                   "--seed", "0", "--device", TRAIN_DEVICE, *extra] + [
            a for k, v in TEACHER_CONF.items() for a in (f"--{k}", str(v))])
        with open(os.path.join(exp, "log.jsonl")) as f:
            rows[name] = [json.loads(line) for line in f]
    auto, off, off_chain = rows["auto"], rows["off"], rows["off_chain"]
    log(f"[graph] fcl_train teacher widths, batch 8, 8 steps an epoch: "
        f"auto (device cache {auto[0]['device_cache']}, "
        f"{auto[0]['steps_per_dispatch']} steps a dispatch, "
        f"{auto[1]['dispatches']} dispatches an epoch, capture "
        f"{auto[0]['capture_s']:.2f} s, graph pool "
        f"{auto[0].get('graph_pool_bytes', 0) / 2 ** 20:.0f} MiB) epoch "
        f"walls {auto[0]['train_wall_s']:.2f} / "
        f"{auto[1]['train_wall_s']:.2f} s, step p50 "
        f"{auto[1]['step_ms_p50']:.1f} ms; --device-cache off "
        f"--steps-per-dispatch 1 (graphed single steps): "
        f"{off[0]['train_wall_s']:.2f} / "
        f"{off[1]['train_wall_s']:.2f} s, step p50 "
        f"{off[1]['step_ms_p50']:.1f} ms; --device-cache off "
        f"--steps-per-dispatch 4 (graphed, streamed batches): "
        f"{off_chain[0]['train_wall_s']:.2f} / "
        f"{off_chain[1]['train_wall_s']:.2f} s; epoch-2 loss "
        f"{auto[1]['main/loss']:.4f} / {off[1]['main/loss']:.4f} / "
        f"{off_chain[1]['main/loss']:.4f} | {smi}")
    if not (auto[0]["device_cache"] and auto[0]["steps_per_dispatch"] == 4
            and auto[1]["dispatches"] == 2 and auto[1]["steps"] == 8):
        raise RuntimeError(f"fcl_train auto: not the cache with 4 steps a "
                           f"dispatch: {auto[1]}")
    if off[0]["device_cache"] or off[0]["steps_per_dispatch"] != 1:
        raise RuntimeError(f"fcl_train off: {off[0]}")
    if off_chain[1]["device_cache"] or off_chain[1]["dispatches"] != 2:
        raise RuntimeError(f"fcl_train off, 4 a dispatch: {off_chain[1]}")
    if not all(np.isfinite(r["main/loss"]) for r in auto + off + off_chain):
        raise RuntimeError("fcl_train: non-finite loss")
    return {"auto_epoch_wall_s": [r["train_wall_s"] for r in auto],
            "off_epoch_wall_s": [r["train_wall_s"] for r in off],
            "off_chain_epoch_wall_s": [r["train_wall_s"]
                                       for r in off_chain],
            "auto_step_ms_p50": auto[1]["step_ms_p50"],
            "off_step_ms_p50": off[1]["step_ms_p50"]}


def phase_graph(smi, kind):
    """The device cache and the chained step as CUDA graph replays at
    FCL-taco2-T width: agreement with eager steps (fp32) and the masks of
    consecutive replays, classed and single-class; bf16 step times eager
    against graphed; ``fcl_train``'s defaults.  No decoder or PWG kernel
    runs."""
    from fcl_taco2_tpu_torch.data.native import native_available
    if not native_available():
        raise RuntimeError("the native plan builder did not build")
    zero_counts(evaluations_apart=True)
    with tempfile.TemporaryDirectory() as root:
        utts = graph_corpus(os.path.join(root, "corpus"), 48)
        models = graph_models()
        agree = [logged(graph_agreement, smi, utts, c, models)
                 for c in (DURATION_CLASSES, ())]
        timing = [logged(graph_timing, smi, kind, utts, c, models)
                  for c in (DURATION_CLASSES, ())]
        del models
        cli = logged(graph_cli_check, smi, root)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[graph] kernel launches during the phase {counts} (the training "
        f"path runs only {TRAIN_KERNEL}); native plan builder in use")
    check_training_counts("[graph]", counts)
    log("[graph] " + json.dumps({"agreement": agree, "timing": timing,
                                  "fcl_train": cli, "device": smi}))


# ---------------------------------------------------------------------------
# [finetune]: partial init, freezing, the transform and the trace
# ---------------------------------------------------------------------------

PREPROCESS_CONF = {"process": [
    {"type": "utterance_cmvn", "norm_vars": True},
    {"type": "freq_mask", "F": 10, "n_mask": 1}]}


def phase_finetune(smi, kind, root, tckpt, train_json, valid_json):
    """``fcl_train`` FCL-taco2-T with ``--enc-init``/``--dec-init`` from
    the [kd] teacher, ``--freeze-mods enc.`` and ``--preprocess-conf``
    (2 epochs), then the student with ``--profile-dir`` (2 epochs)."""
    from fcl_taco2_tpu_torch.cli.fcl_train import main as fcl_train
    from fcl_taco2_tpu_torch.train import checkpoint as ckpt
    from fcl_taco2_tpu_torch.train.loop import Trainer
    from fcl_taco2_tpu_torch.train.profiler import TRACE_FILE
    from fcl_taco2_tpu_torch.utils.params import params_from_jax
    zero_counts(evaluations_apart=True)
    conf = os.path.join(root, "preprocess.json")
    with open(conf, "w") as f:
        json.dump(PREPROCESS_CONF, f)
    common = ["--train-json", train_json, "--valid-json", valid_json,
              "--batch-size", "8", "--minibatches", "6", "--seed", "1",
              "--epochs", "2", "--device", TRAIN_DEVICE]
    init_states = []
    orig = Trainer.init_state

    def init_state(self):  # record the state init_state hands the loop
        ts = orig(self)
        init_states.append({k: v.clone()
                            for k, v in ts.model.state_dict().items()})
        return ts

    Trainer.init_state = init_state
    try:
        ts = fcl_train(common + [
            "--outdir", os.path.join(root, "finetune"), "--enc-init", tckpt,
            "--dec-init", tckpt, "--freeze-mods", "enc.",
            "--preprocess-conf", conf] + [
            a for k, v in TEACHER_CONF.items() for a in (f"--{k}", str(v))])
    finally:
        Trainer.init_state = orig
    payload = ckpt.read_checkpoint(tckpt)
    donor = params_from_jax(payload["params"], payload["model_state"])
    init = init_states[0]
    sel = [k for k in init if k.startswith(("encoder.", "decoder."))]
    not_copied = [k for k in sel if not torch.equal(init[k].cpu(),
                                                    donor[k])]
    params = dict(ts.model.named_parameters())
    frozen = [k for k in params if k.startswith("encoder.")]
    moved_frozen = [k for k in frozen if not torch.equal(params[k],
                                                         init[k])]
    others = [k for k in params if not k.startswith("encoder.")]
    still = [k for k in others if torch.equal(params[k], init[k])]
    with open(os.path.join(root, "finetune", "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    log(f"[finetune] fcl_train teacher widths, --enc-init/--dec-init from "
        f"the [kd] teacher, --freeze-mods enc., --preprocess-conf "
        f"utterance_cmvn + freq_mask (device cache "
        f"{rows[0]['device_cache']}, {rows[0]['steps_per_dispatch']} step "
        f"a dispatch), 2 epochs ({ts.step} steps): {len(sel)} selected "
        f"tensors equal the checkpoint after init_state "
        f"({len(not_copied)} differ); {len(frozen)} frozen parameters, "
        f"{len(moved_frozen)} moved; {len(others) - len(still)} of "
        f"{len(others)} others moved; loss {rows[0]['main/loss']:.4f} -> "
        f"{rows[1]['main/loss']:.4f} | {smi}")
    if not_copied or moved_frozen or not sel or not frozen:
        raise RuntimeError(f"finetune: not copied {not_copied[:3]}, frozen "
                           f"but moved {moved_frozen[:3]}")
    if len(still) > len(others) // 10:
        raise RuntimeError(f"finetune: {len(still)} trainable tensors did "
                           f"not move: {still[:5]}")
    if rows[0]["device_cache"]:
        raise RuntimeError("finetune: the cache was built under a host "
                           "transform")
    prof = os.path.join(root, "profile")
    ts = fcl_train(common + ["--outdir", os.path.join(root, "profiled"),
                             "--profile-dir", prof, *STUDENT_ARGS])
    path = os.path.join(prof, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"[finetune] fcl_train student --profile-dir: {path} "
        f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, {len(events)} events, "
        f"{len(kernels)} CUDA kernel events over epoch 1 | {smi}")
    if not kernels:
        raise RuntimeError("finetune: the trace holds no CUDA kernel event")
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[finetune] kernel launches during the phase {counts} (the "
        f"training path runs only {TRAIN_KERNEL})")
    check_training_counts("[finetune]", counts)


# [preprocess]: a synthetic corpus at LJSpeech-like lengths (~6.5 s mean,
# <= ~11 s, 22,050 Hz), the default PreprocessConfig (80 mels, n_fft 1024,
# hop 256, fmin 80, fmax 7600, 2^21 samples a bucket)
PRE_DEVICE = "cuda"
PRE_UTTS, PRE_PHONES = 128, (24, 80)
PRE_SPLIT = 8  # validation and test utterances of the CLI's split
TOL_MEL = 1e-4       # log10-mel, abs
TOL_EN = 1e-4        # energy, abs over the utterance's max energy
TOL_VOICED = 0.999   # share of frames with equal voicing
TOL_CENTS = 1.0      # f0 on frames voiced in both
TOL_PRE_WHY = ("the same frames, window, filterbank and YIN steps (the "
               "STFT in fp64 rounded to complex64, the mel product and YIN "
               "in fp32): cuFFT against pocketfft and other summation "
               "orders")
# tests/test_f0_goldens.py:24-32 (the test imports JAX, so the budgets are
# copied): (min voicing F1, max median cents, max octave-error rate)
F0_BUDGETS = {
    "vibrato": (0.97, 15.0, 0.01),
    "octave_trap": (0.97, 10.0, 0.01),
    "creaky_low": (0.97, 15.0, 0.01),
    "noisy": (0.95, 15.0, 0.01),
    "breathy": (0.95, 15.0, 0.01),
    "speechlike": (0.95, 15.0, 0.01),
    "onsets": (0.88, 10.0, 0.01),
}


def f0_metrics(est, truth):
    """``tests/test_f0_goldens.py::_metrics``: voicing F1, median cents and
    octave-error rate on frames voiced in both."""
    T = min(len(est), len(truth))
    est, truth = est[:T], truth[:T]
    tv, ev = truth > 0, est > 0
    tp = int((tv & ev).sum())
    fp = int((~tv & ev).sum())
    fn = int((tv & ~ev).sum())
    f1 = 2 * tp / max(2 * tp + fp + fn, 1)
    both = tv & ev
    if both.sum() <= 10:
        raise RuntimeError("f0 goldens: almost no matched frames")
    cents = 1200.0 * np.abs(np.log2(est[both] / truth[both]))
    return f1, float(np.median(cents)), float((cents > 600).mean())


def frontend_agreement(cfg, wavs, smi):
    """``Frontend`` on the card against its CPU path on the same wavs."""
    from fcl_taco2_tpu_torch.audio.preprocess import Frontend
    fe = Frontend(cfg, PRE_DEVICE)
    fe.process(wavs)  # warm-up: cuFFT plans of every bucket size
    cold_ms = [st["ms"] for st in fe.bucket_stats]
    fe.bucket_stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = fe.process(wavs)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = Frontend(cfg, "cpu").process(wavs)
    t_cpu = time.perf_counter() - t0
    mel_err = max(float(np.abs(a[0] - b[0]).max())
                  for a, b in zip(card, host))
    en_err = max(float(np.abs(a[2] - b[2]).max() / b[2].max())
                 for a, b in zip(card, host))
    frames = sum(len(b[1]) for b in host)
    flips = sum(int(((a[1] > 0) != (b[1] > 0)).sum())
                for a, b in zip(card, host))
    cents = max(float(np.abs(1200.0 * np.log2(a[1][v] / b[1][v])).max())
                for a, b in zip(card, host)
                for v in [(a[1] > 0) & (b[1] > 0)] if v.any())
    ms = [st["ms"] for st in fe.bucket_stats]
    log(f"[preprocess] Frontend {PRE_DEVICE} vs cpu on {len(wavs)} "
        f"utterances ({frames} frames, {len(ms)} buckets): log10-mel max "
        f"abs {mel_err:.3e} (tol {TOL_MEL}), energy {en_err:.3e} of the "
        f"max (tol {TOL_EN}), voicing flips {flips} of {frames} (equal "
        f"share {1 - flips / frames:.6f}, tol {TOL_VOICED}), f0 max "
        f"{cents:.4f} cents on frames voiced in both (tol {TOL_CENTS}): "
        f"{TOL_PRE_WHY}; card {t_card:.3f} s wall, device ms per bucket "
        f"{[round(m, 3) for m in ms]} (sum {sum(ms):.3f}; the warm-up "
        f"call's, with cuFFT's plans made, {[round(m, 3) for m in cold_ms]}"
        f"); cpu {t_cpu:.3f} s | {smi}")
    if mel_err > TOL_MEL or en_err > TOL_EN or cents > TOL_CENTS \
            or 1 - flips / frames < TOL_VOICED:
        raise RuntimeError("preprocess: the card's frontend disagrees with "
                           "its CPU path")
    return {"mel_err": mel_err, "en_err": en_err, "flips": flips,
            "frames": frames, "max_cents": cents, "bucket_ms": ms,
            "cold_ms": cold_ms, "card_s": t_card, "cpu_s": t_cpu}


def f0_goldens_on_card(smi):
    """The port's ``yin_f0`` on CUDA tensors against
    ``tests/fixtures/f0_goldens.npz``'s analytic ground truth."""
    from fcl_taco2_tpu_torch.ops.f0 import yin_f0
    z = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "fixtures", "f0_goldens.npz"))
    names = sorted({k.rsplit("_", 1)[0] for k in z.files
                    if k.endswith("_signal")})
    if set(names) != set(F0_BUDGETS):
        raise RuntimeError(f"f0 goldens: cases {names}")
    rows, failures = {}, []
    for name in names:
        x = torch.from_numpy(z[f"{name}_signal"].astype(np.float32)
                             / 32767.0).to(PRE_DEVICE)
        f0 = yin_f0(x, device=PRE_DEVICE)
        if f0.device != x.device:
            raise RuntimeError("f0 goldens: yin_f0 left the card")
        f1, cents, octave = f0_metrics(f0.cpu().numpy(), z[f"{name}_f0"])
        rows[name] = (round(f1, 4), round(cents, 2), round(octave, 4))
        min_f1, max_cents, max_oct = F0_BUDGETS[name]
        if f1 < min_f1 or cents > max_cents or octave > max_oct:
            failures.append(name)
    log(f"[preprocess] yin_f0 on {PRE_DEVICE}, F0 goldens (voicing F1, "
        f"median cents, octave-error rate): {rows}; budgets met "
        f"{not failures} | {smi}")
    if failures:
        raise RuntimeError(f"f0 goldens: budgets missed by {failures}")
    return rows


def phase_preprocess(smi, kind, root):
    """Preprocessing on the card: a synthetic corpus, the frontend against
    its CPU path, the F0 goldens, ``fcl_preprocess`` end to end (stages,
    audio seconds per wall second, peak memory) and one ``fcl_train``
    epoch at FCL-taco2-S width on the manifests it wrote.  No decoder or
    PWG kernel may launch."""
    import re
    from glob import glob
    from fcl_taco2_tpu_torch.audio.preprocess import (PreprocessConfig,
                                                      read_wav)
    from fcl_taco2_tpu_torch.audio.synthcorpus import generate_corpus
    from fcl_taco2_tpu_torch.cli import fcl_preprocess
    from fcl_taco2_tpu_torch.cli.fcl_train import main as fcl_train
    zero_counts(evaluations_apart=True)
    t0 = time.perf_counter()
    corpus = generate_corpus(os.path.join(root, "corpus"), n_utts=PRE_UTTS,
                             seed=0, min_phones=PRE_PHONES[0],
                             max_phones=PRE_PHONES[1])
    t_gen = time.perf_counter() - t0
    wavs = [read_wav(p)[0]
            for p in sorted(glob(os.path.join(corpus, "wavs", "*.wav")))]
    lens = np.array([len(w) for w in wavs]) / SAMPLE_RATE
    audio_s = float(lens.sum())
    log(f"[preprocess] generate_corpus {PRE_UTTS} utterances, seed 0, "
        f"{PRE_PHONES[0]}-{PRE_PHONES[1]} phones: {audio_s:.1f} s of audio "
        f"(mean {lens.mean():.2f} s, max {lens.max():.2f} s) in "
        f"{t_gen:.1f} s")
    agree = frontend_agreement(PreprocessConfig(), wavs, smi)
    goldens = f0_goldens_on_card(smi)

    feat = os.path.join(root, "features")
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fcl_preprocess.main([
        "--data-root", corpus, "--textgrid-root", os.path.join(corpus, "tg"),
        "--feature-root", feat, "--n-val", str(PRE_SPLIT), "--n-test",
        str(PRE_SPLIT), "--device", PRE_DEVICE], log=lines.append)
    t_cli = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    stages = {m.group(1): float(m.group(2)) for m in
              (re.match(r"\s*stage (\w+): ([\d.]+) s", line)
               for line in lines) if m}
    bucket_ms = next((line.split("device ms ")[1] for line in lines
                      if "device ms " in line), "")
    n_utts = {}
    for mode in ("train", "val", "test"):
        with open(os.path.join(feat, f"{mode}_data.json")) as f:
            n_utts[mode] = len(json.load(f)["utts"])
    over = sum(np.load(p).max() > 50 for p in
               glob(os.path.join(feat, "durations_MFA", "*.npy")))
    log(f"[preprocess] fcl_preprocess --device {PRE_DEVICE}: "
        f"{audio_s:.1f} s of audio in {t_cli:.2f} s wall = "
        f"{audio_s / t_cli:.1f} audio s per wall s; stages (s) {stages}; "
        f"frontend device ms per bucket {bucket_ms}; peak memory "
        f"{peak:.1f} MiB; manifests {n_utts} = {sum(n_utts.values())} of "
        f"{PRE_UTTS} ({over} with a phoneme over max_dur 50) on {kind} | "
        f"{smi}")
    if sum(n_utts.values()) != PRE_UTTS - over or len(stages) != 5:
        raise RuntimeError(f"preprocess: manifests {n_utts}, {over} over "
                           f"max_dur, stages {stages}")
    exp = os.path.join(root, "pre_exp")
    ts = fcl_train(["--train-json", os.path.join(feat, "train_data.json"),
                    "--valid-json", os.path.join(feat, "val_data.json"),
                    "--outdir", exp, "--batch-size", "8", "--epochs", "1",
                    "--seed", "0", "--device", TRAIN_DEVICE, *STUDENT_ARGS])
    with open(os.path.join(exp, "log.jsonl")) as f:
        row = json.loads(f.readline())
    log(f"[preprocess] fcl_train FCL-taco2-S on the written manifests: "
        f"{ts.step} steps, epoch loss {row['main/loss']:.4f}, validation "
        f"{row.get('validation/main/loss')}")
    if not np.isfinite(row["main/loss"]) or ts.step == 0:
        raise RuntimeError(f"preprocess: training on the manifests {row}")
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[preprocess] kernel launches during the phase {counts} (the "
        f"preprocessing path runs none; its training epoch only "
        f"{TRAIN_KERNEL})")
    check_training_counts("[preprocess]", counts)
    return {"audio_s": audio_s, "cli_s": t_cli, "stages": stages,
            "peak_mib": peak, "manifests": n_utts, "frontend": agree,
            "goldens": goldens}


# [quality]: FCL-taco2-T trained at full width with fcl_train's defaults
# (bf16, the device cache, graphed chains of 4) on [preprocess]'s 112
# training utterances, then a KD student.  Batch 16 makes 7 steps an
# epoch: a chain of 4 and a remainder of 3 single replays of the chain's
# graph (the epoch wall is logged as [compiled]'s).  The epoch count is
# PERF.md's prediction for convergence in about 2.5 minutes: 150 epochs
# passed the gate by 0.853 x at batch 14, too close for a run that is not
# bit-reproducible.
QUALITY_BATCH = 16
QUALITY_EPOCHS = 200
QUALITY_KD_EPOCHS = 3
QUALITY_TEACHER_ARGS = []  # fcl_train's defaults are FCL-taco2-T's
QUALITY_STUDENT_CONF = os.path.join("conf", "train_fcl_taco2.student.yaml")
QUALITY_TEACHER_CONF = os.path.join("conf", "train_fcl_taco2.teacher.yaml")
L1_GATE = 0.9    # teacher gt-duration L1 <= this x the predict-mean L1
VAL_GATE = 0.5   # best validation loss < this x the first epoch's


def phase_quality(smi, kind, root, feat=None):
    """The quality protocol in small (``scripts/torch_mcd_benchmark.py``'s
    calls) on [preprocess]'s features: the teacher trained with
    ``fcl_train``'s defaults, its test-shard decodes with ground-truth and
    predicted durations (``fused_ar_decode_hbm``, bf16) and with
    ground-truth durations in int8 (``--quantize int8``), a KD student and
    its decodes (``fused_ar_decode``), each scored by ``fcl_eval``, beside
    the floors.  Fails unless the teacher's ground-truth-duration L1 is
    at most L1_GATE x the predict-the-train-mean L1 and its best
    validation loss is under VAL_GATE x the first epoch's, or unless a
    decode's kernel did not launch.  ``feat``: the features (default
    ``root/features``).  Returns the decodes' launch counts."""
    from fcl_taco2_tpu_torch.cli.fcl_train import main as fcl_train
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "scripts"))
    from torch_mcd_benchmark import decode_and_eval, floors
    feat = feat or os.path.join(root, "features")
    data = ["--train-json", os.path.join(feat, "train_data.json"),
            "--valid-json", os.path.join(feat, "val_data.json"),
            "--batch-size", str(QUALITY_BATCH), "--seed", "137",
            "--device", TRAIN_DEVICE]
    exp, exp_s = os.path.join(root, "q_teacher"), os.path.join(root,
                                                               "q_student")
    t0 = time.perf_counter()
    # one snapshot at the end (and model.loss.best): a full-width state
    # each epoch would write ~350 MB an epoch to the disk
    fcl_train([*QUALITY_TEACHER_ARGS, *data, "--outdir", exp,
               "--epochs", str(QUALITY_EPOCHS),
               "--save-interval-epochs", str(QUALITY_EPOCHS)])
    t_teacher = time.perf_counter() - t0
    with open(os.path.join(exp, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    val = [r["validation/main/loss"] for r in rows]
    best = int(np.argmin(val))
    log(f"[quality] fcl_train FCL-taco2-T (its defaults: device cache "
        f"{rows[-1].get('device_cache')}, {rows[-1].get('steps_per_dispatch')}"
        f" steps a dispatch), {len(rows)} epochs of "
        f"{rows[-1].get('dispatches')} dispatches in {t_teacher:.1f} s: "
        f"train loss {rows[0]['main/loss']:.4f} -> {rows[-1]['main/loss']:.4f}"
        f", validation {val[0]:.4f} -> best {val[best]:.4f} (epoch "
        f"{best + 1}) -> last {val[-1]:.4f} | {smi}")
    walls = [r["train_wall_s"] for r in rows]
    log(f"[compiled] epoch wall at batch {QUALITY_BATCH} on the "
        f"{rows[-1].get('steps')} steps of [preprocess]'s training split "
        f"({rows[-1].get('dispatches')} dispatches: chains of "
        f"{rows[-1].get('steps_per_dispatch')} and the remainder's single "
        f"replays): first epoch {walls[0]:.3f} s (capture "
        f"{rows[0].get('capture_s', 0):.2f} s, pool "
        f"{rows[0].get('graph_pool_bytes', 0) / 2 ** 20:.1f} MiB), later "
        f"epochs median {np.median(walls[1:]):.3f} s (min "
        f"{min(walls[1:]):.3f}, max {max(walls[1:]):.3f}); eval "
        f"{np.median([r.get('eval_s', 0) for r in rows[1:]]):.3f} s an "
        f"epoch | {smi}")

    launches = dict.fromkeys(_counters(), 0)
    results = {}

    def decode(ckpt, tag, kernel, extra=()):
        zero_counts()
        results[tag] = decode_and_eval(feat, os.path.join(root, f"q_{tag}"),
                                       ckpt, TRAIN_DEVICE, extra)
        torch.cuda.synchronize()
        counts = read_counts()
        for k, v in counts.items():
            launches[k] += v
        log(f"[quality] {tag}: {json.dumps(results[tag])}; launches "
            f"{counts}")
        if counts[kernel.__name__] == 0:
            raise RuntimeError(f"quality {tag}: {kernel.__name__} did not "
                               f"launch")

    ckpt = os.path.join(exp, "model.loss.best")
    gt = ["--use-gt-durations"]
    decode(ckpt, "gt_dur", K.fused_ar_decode_hbm, gt)
    decode(ckpt, "pred_dur", K.fused_ar_decode_hbm)
    decode(ckpt, "gt_dur_int8", K.fused_ar_decode_hbm,
           [*gt, "--quantize", "int8"])

    t0 = time.perf_counter()
    fcl_train(["--config", os.path.join(here, QUALITY_STUDENT_CONF), *data,
               "--outdir", exp_s, "--epochs", str(QUALITY_KD_EPOCHS),
               "--save-interval-epochs", str(QUALITY_KD_EPOCHS),
               "--perform-KD", "True", "--share-proj", "True",
               "--teacher-config", os.path.join(here, QUALITY_TEACHER_CONF),
               "--teacher-checkpoint", ckpt])
    t_kd = time.perf_counter() - t0
    with open(os.path.join(exp_s, "log.jsonl")) as f:
        kd_rows = [json.loads(line) for line in f]
    log(f"[quality] fcl_train --perform-KD True FCL-taco2-S "
        f"({QUALITY_STUDENT_CONF}), {len(kd_rows)} epochs in {t_kd:.1f} s: "
        f"loss {kd_rows[0]['main/loss']:.4f} -> "
        f"{kd_rows[-1]['main/loss']:.4f}, validation "
        f"{kd_rows[-1].get('validation/main/loss')}")
    ckpt_s = os.path.join(exp_s, "model.loss.best")
    decode(ckpt_s, "student_gt_dur", K.fused_ar_decode, gt)
    decode(ckpt_s, "student_pred_dur", K.fused_ar_decode)

    fl = floors(feat)
    l1, l1_floor = results["gt_dur"]["l1"], fl["predict_mean_l1"]
    log(f"[quality] floors on the {results['gt_dur']['n_utts']} test "
        f"utterances: {json.dumps(fl)}; teacher gt-duration L1 {l1:.4f} = "
        f"{l1 / l1_floor:.3f} x the predict-mean L1 (gate {L1_GATE}); best "
        f"validation loss {val[best]:.4f} = {val[best] / val[0]:.3f} x the "
        f"first epoch's (gate {VAL_GATE}); MCD floors logged, not gated; "
        f"launches {launches} on {kind}")
    log("[quality] " + json.dumps({
        "teacher_epochs": len(rows), "teacher_s": t_teacher,
        "kd_epochs": len(kd_rows), "kd_s": t_kd, "floors": fl,
        "results": results, "validation": [val[0], val[best], val[-1]],
        "device": smi}))
    if not l1 <= L1_GATE * l1_floor:
        raise RuntimeError(f"quality: teacher gt-duration L1 {l1:.4f} > "
                           f"{L1_GATE} x the predict-mean L1 {l1_floor:.4f}")
    if not val[best] < VAL_GATE * val[0]:
        raise RuntimeError(f"quality: best validation loss {val[best]:.4f} "
                           f"not under {VAL_GATE} x the first {val[0]:.4f}")
    return launches


PAR_TIMEOUT = 900  # seconds a spawned rank may take
TOL_PAR = 2e-4     # losses and checksums, relative (tests/test_parallel.py)
TOL_PAR_WHY = ("fp32, TF32 off: the same math, the ranks' sums of local "
               "terms over the global denominators in another order than "
               "one process's global sums")
TOL_BN = 1e-5


def spawn_ranks(n, out, *extra):
    """``n`` ranks of ``parallel/_mp_worker.py`` at full width, all on
    card 0 over gloo (NCCL refuses two ranks on one device); returns rank
    0's result and arrays.  Each rank logs to ``<out>.<rank>.log``; when
    one fails, or at the time limit, every rank is killed (a rank whose
    peer died would wait in a collective) and the logs' ends raised."""
    from fcl_taco2_tpu_torch.parallel.distributed import free_port
    port = free_port()
    logs = [f"{out}.{i}.log" for i in range(n)]
    procs = []
    for i in range(n):
        with open(logs[i], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "fcl_taco2_tpu_torch.parallel._mp_worker",
                 "--process-id", str(i), "--num-processes", str(n),
                 "--port", str(port), "--device", "cuda:0", "--backend",
                 "gloo", "--width", "full", "--out", out, *extra],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f,
                stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.perf_counter() - t0 > PAR_TIMEOUT:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        tails = []
        for path in logs:
            with open(path) as f:
                tails.append(f.read()[-6000:])
        codes = [p.returncode for p in procs]
        raise RuntimeError(f"parallel: ranks ended {codes}:\n"
                           + "\n====\n".join(tails))
    with open(out) as f:
        result = json.load(f)
    with np.load(out + ".npz") as z:
        return result, {k: z[k] for k in z.files}


def _close(name, got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))
    log(f"[parallel] {name}: {np.asarray(got).ravel()[:4].tolist()} vs "
        f"{np.asarray(want).ravel()[:4].tolist()} (error / limit "
        f"{err:.3g})")
    if not err <= 1.0:
        raise RuntimeError(f"parallel: {name} differs: {got} vs {want}")


def phase_parallel(smi, kind, root):
    """Data parallel on the one card (``[parallel]``): 2 ranks sharing
    card 0 over gloo (``parallel/_mp_worker.py --width full``) train
    FCL-taco2-T on the benchmark's B=16 batch (8 utterances a rank, fp32,
    dropouts 0, Adam lr 1e-4: ``_mp_worker.LR`` says why) for 3 steps
    (snapshot after 2), distil FCL-taco2-S from it for one step, serve
    both sharded (2 utterances a rank) in fp32 compute (the decoder
    kernels keep their weight dtypes), held to one process's batch of 4,
    and in bf16 compute, held to one process's batches of each rank's 2
    rows, and run the synchronized BatchNorm check;
    a fresh 2-rank run resumes the snapshot for 2 steps; all held to one
    process on the same global batch.  The gloo ranks stay eager and say
    why.  Then one rank over NCCL (a world of one process group, so the
    same data-parallel path), its steps and sharded serving graphed with
    their all-reduces inside (``nccl_twins``), against their eager twins
    bit for bit and against the undistributed steps.  The decoder kernel
    launches of the two gloo ranks and of the NCCL rank are returned."""
    import torch.distributed as dist
    from fcl_taco2_tpu_torch.ops.conv import batch_norm_train
    from fcl_taco2_tpu_torch.ops.masking import lengths_to_non_pad_mask
    from fcl_taco2_tpu_torch.parallel import _mp_worker as W
    from fcl_taco2_tpu_torch.parallel.distributed import (free_port,
                                                          initialize)
    from fcl_taco2_tpu_torch.parallel.mesh import make_mesh
    torch.cuda.empty_cache()
    with tf32(False):
        t0 = time.perf_counter()
        ref, ref_sum, ref_mid, ref_norms = W.run_training_steps(
            4, checksum_steps=(2, 3), device="cuda", width="full")
        ref_kd, ref_kd_sum = W.run_kd_steps(1, device="cuda", width="full")
        ref_serve = W.run_serving(device="cuda", width="full")
        ref_share = W.run_serving(device="cuda", width="full", shares=2)
        torch.cuda.synchronize()
        log(f"[parallel] one process: 4 teacher steps, a KD step, teacher "
            f"and student serving (fp32 and bf16 compute, batches of 4 and "
            f"of 2) in {time.perf_counter() - t0:.1f} s; losses {ref}")
        ckpt = os.path.join(root, "par.ckpt")
        t0 = time.perf_counter()
        a, arrays = spawn_ranks(
            2, os.path.join(root, "par_a.json"), "--mode", "all", "--steps",
            "3", "--save-ckpt", ckpt, "--save-step", "2")
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        b, _ = spawn_ranks(2, os.path.join(root, "par_b.json"), "--mode",
                           "dp", "--steps", "2", "--resume-ckpt", ckpt)
        t_b = time.perf_counter() - t0
    log(f"[parallel] 2 ranks sharing {kind} over {a['backend']} (not "
        f"scaling: one card, time-sliced): {a['seconds']:.1f} s of work in "
        f"{t_a:.1f} s wall (3 steps, KD, serving, BatchNorm); the resumed "
        f"pair {t_b:.1f} s | {smi}")
    _close("2-rank teacher losses vs 1", a["dp"]["losses"], ref[:3],
           TOL_PAR)
    _close("2-rank teacher grad norms vs 1", a["dp"]["grad_norms"],
           ref_norms[:3], TOL_PAR)
    _close("2-rank params checksum vs 1", a["dp"]["checksum"], ref_mid[3],
           TOL_PAR)
    _close("resumed 2-rank losses (steps 3-4) vs 1", b["dp"]["losses"],
           ref[2:4], TOL_PAR)
    _close("resumed 2-rank checksum vs 1", b["dp"]["checksum"], ref_sum,
           TOL_PAR)
    _close("2-rank KD loss vs 1", a["kd"]["losses"], ref_kd, TOL_PAR)
    _close("2-rank KD checksum vs 1", a["kd"]["checksum"], ref_kd_sum,
           TOL_PAR)
    # fp32 compute: against one process decoding the batch of 4 at once;
    # bf16 compute: against one process decoding each rank's 2 rows as a
    # batch (the same shapes: bf16 products round by the batch's size,
    # so a batch of 4 is logged beside it, not held to the limit)
    tol = {"teacher": (TOL_BF16, "bf16 weights: " + TOL_BF16_WHY),
           "student": (TOL_F32, "fp32 weights: " + TOL_F32_WHY),
           "teacher_bf16": (TOL_BF16, "bf16 compute: " + TOL_BF16_WHY),
           "student_bf16": (TOL_BF16, "bf16 compute: " + TOL_BF16_WHY)}

    def mel_err(xs, ys):
        return max(float(np.max(np.abs(x - y), initial=0.0))
                   for x, y in zip(xs, ys))
    for name, (limit, why) in tol.items():
        bf16 = name.endswith("_bf16")
        mels, frames = (ref_share if bf16 else ref_serve)[name]
        got = [arrays[f"serve_{name}/{i}"] for i in range(len(mels))]
        err = mel_err(got, mels)
        by_batch = mel_err(ref_serve[name][0], ref_share[name][0])
        log(f"[parallel] sharded {name} serving (2 utterances a rank): "
            f"max |mel - one process's at batch {2 if bf16 else 4}| "
            f"{err:.3g} (limit {limit}, {why}); frames "
            f"{a[f'serve_{name}']['total_frames']} vs {frames}; one "
            f"process at batch 4 vs 2: {by_batch:.3g}")
        if err > limit or a[f"serve_{name}"]["total_frames"] != frames:
            raise RuntimeError(f"parallel: sharded {name} serving differs")
    launches = a["launches"]
    log(f"[parallel] decoder kernel launches by rank {launches}")
    for k, by_rank in launches.items():
        if min(by_rank) == 0:
            raise RuntimeError(f"parallel: {k} did not launch on every "
                               f"rank: {by_rank}")
    x, gy, w, b_, rm, rv, lens = W.bn_inputs()
    for case in ("masked", "unmasked"):
        t = {k: torch.tensor(v, device="cuda", requires_grad=k != "gy")
             for k, v in dict(x=x, gy=gy, w=w, b=b_).items()}
        mask = lengths_to_non_pad_mask(torch.tensor(lens, device="cuda"),
                                       x.shape[1]) if case == "masked" \
            else None
        y, (nm, nv) = batch_norm_train(
            t["x"], t["w"], t["b"], torch.tensor(rm, device="cuda"),
            torch.tensor(rv, device="cuda"), mask=mask)
        (y * t["gy"]).sum().backward()
        for k, v in dict(y=y, dx=t["x"].grad, dw=t["w"].grad,
                         db=t["b"].grad, mean=nm, var=nv).items():
            _close(f"synced BatchNorm {case} {k}", arrays[f"bn_{case}/{k}"],
                   v.detach().cpu().numpy(), TOL_BN, TOL_BN)
    per = a["dp"]["allreduce_per_step"]
    log(f"[parallel] per train step over gloo on {kind}: "
        f"{per['bytes'] / 2 ** 20:.1f} MiB all-reduced in "
        f"{per['calls']:.0f} calls (one gradient bucket, the rest "
        f"BatchNorm's), {per['seconds'] * 1e3:.1f} ms | {smi}")
    # one rank over NCCL: the same path, its collectives on a world of 1,
    # graphed with its all-reduces inside each step's graph
    with open(os.path.join(root, "par_a.json.0.log")) as f:
        reasons = sorted({line.strip() for line in f if "stay eager" in line})
    log(f"[parallel] the gloo ranks said: {reasons}")
    if not reasons or any("nccl" in r.lower() for r in reasons):
        raise RuntimeError(f"parallel: gloo's eager reason {reasons}")
    initialize(f"localhost:{free_port()}", 1, 0, backend="nccl",
               device="cuda:0")
    try:
        mesh = make_mesh()
        with tf32(False), deterministic() as nondet:
            twins = nccl_twins(smi, kind, mesh)
        log(f"[parallel] deterministic algorithms on; ops without a "
            f"deterministic version: {sorted(nondet) or 'none'}")
        nccl_bf16_timing(smi, kind, mesh, torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
    train = twins["train"]["graphed"]
    _close("1-rank NCCL graphed losses vs undistributed", train["losses"],
           ref[:4], TOL_PAR)
    _close("1-rank NCCL graphed grad norms vs undistributed",
           train["grad_norms"], ref_norms[:4], TOL_PAR)
    for k in launches:  # the NCCL rank's serving beside the gloo ranks'
        launches[k] = list(launches[k]) + [twins["launches"][k]]
    return launches


NCCL_TIMED = 5  # steps timed after the compared ones, CUDA events


def nccl_twins(smi, kind, mesh, n=4):
    """One rank over NCCL (``make_mesh()`` on a world of one process
    group: the data-parallel path, its collectives on the card), each
    graphed path against its ``graphed=False`` twin from the same state
    and seeds: ``_mp_worker``'s full-width teacher train and eval steps
    and its KD step (remat on and off) with the KD eval step, over ``n``
    steps on the bench batch (losses, grad norms, every parameter and
    buffer, eval reports bit-equal; ``Mesh.stats`` calls and bytes a step
    equal, the graphed ones counted per replay), then sharded serving of
    the bf16 teacher and student at batch 2 (mels bit-equal, calls and
    bytes a call equal).  Step ms: CUDA events around ``NCCL_TIMED`` more
    steps.  Returns {"train", "kd_remat_on", "kd_remat_off": {"graphed",
    "eager": rows}, "serve": ..., "launches": the graphed serving's}."""
    import dataclasses

    import torch.distributed as dist
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.parallel import _mp_worker as W
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import (make_eval_step,
                                                make_kd_eval_step,
                                                make_kd_train_step,
                                                make_train_step,
                                                step_generator)
    dev = torch.device("cuda", 0)
    cfg, tcfg, scfg = W._configs("full")
    batch = W._upload(mesh, W._bench_batch(), dev)

    def state(model):
        tx = build_optimizer(lr=W.LR["full"], grad_clip=1.0)
        names, ps = zip(*model.named_parameters())
        mesh.broadcast_module_(model)
        return TrainState(model, tx.init(ps, names), 0, tx), tx

    def teacher(graphed):
        ts, tx = state(Tacotron2SA(cfg, device=dev, seed=0))
        return (ts, make_train_step(tx, mesh=mesh, graphed=graphed),
                make_eval_step(mesh=mesh, graphed=graphed))

    def kd(remat):
        def make(graphed):
            k = KDStudent(dataclasses.replace(scfg, remat_decoder=remat),
                          tcfg, device=dev, seed=0)
            mesh.broadcast_module_(k.teacher)
            ts, tx = state(k.student)
            return (ts, make_kd_train_step(k, tx, mesh, graphed=graphed),
                    make_kd_eval_step(k, mesh, graphed=graphed))
        return make

    def gen(step):
        return step_generator(W.TINY_STEPS_SEED, step, dev, mesh.rank)

    def per_call(fn, calls):
        before = dict(mesh.stats)
        out = [fn() for _ in range(calls)]
        torch.cuda.synchronize()
        return out, {k: (mesh.stats[k] - before[k]) / calls
                     for k in ("calls", "bytes")}

    def run(make, graphed):
        ts, step, evals = make(graphed)
        step.prepare(ts, batch, gen(0))  # the capture: before the count
        holder = [ts]

        def one():
            holder[0], rep = step(holder[0], batch, gen(holder[0].step))
            return rep
        reps, per_step = per_call(one, n)
        row = {"losses": [float(r["loss"]) for r in reps],
               "grad_norms": [float(r["grad_norm"]) for r in reps],
               "per_step": per_step,
               "state": {k: v.detach().clone() for k, v in
                         holder[0].model.state_dict().items()}}
        def ev():
            return evals(holder[0], batch, step_generator(7, 0, dev))
        ev()  # the capture: before the count
        evs, row["per_eval"] = per_call(ev, 2)
        row["eval"] = [{k: float(v) for k, v in e.items()} for e in evs]
        times = []
        for _ in range(NCCL_TIMED):
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            one()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        row["ms"] = float(np.median(times))
        row["capture_s"] = step.capture_s
        return row

    out = {}
    for name, make in (("train", teacher), ("kd_remat_on", kd(True)),
                       ("kd_remat_off", kd(False))):
        eager, graphed = run(make, False), run(make, True)
        bit = (eager["losses"] == graphed["losses"]
               and eager["grad_norms"] == graphed["grad_norms"]
               and eager["eval"] == graphed["eval"]
               and eager["state"].keys() == graphed["state"].keys()
               and all(torch.equal(eager["state"][k], graphed["state"][k])
                       for k in eager["state"]))
        same_stats = (eager["per_step"] == graphed["per_step"]
                      and eager["per_eval"] == graphed["per_eval"])
        for r in (eager, graphed):
            del r["state"], r["eval"]
        out[name] = {"graphed": graphed, "eager": eager, "bit_equal": bit}
        log(f"[parallel] 1 rank over {dist.get_backend()}, {name}: {n} "
            f"graphed steps (all-reduces captured) vs their graphed=False "
            f"twin: losses, grad norms, every parameter and buffer and the "
            f"eval reports bit-equal {bit} (losses "
            f"{graphed['losses'][0]:.4f} -> {graphed['losses'][-1]:.4f}); "
            f"Mesh.stats a step graphed {graphed['per_step']} vs eager "
            f"{eager['per_step']}, an eval {graphed['per_eval']} vs "
            f"{eager['per_eval']}; step ms (CUDA events, median of "
            f"{NCCL_TIMED}) graphed {graphed['ms']:.2f} vs eager "
            f"{eager['ms']:.2f}; capture {graphed['capture_s']:.2f} s on "
            f"{kind} | {smi}")
        if not (bit and same_stats):
            raise RuntimeError(f"parallel NCCL {name}: graphed differs from "
                               f"eager (bit-equal {bit}, stats {same_stats})")
    toks, durs, _, _ = W.serve_requests("full")
    models = W._serve_models("full", None, dev)
    launches = dict.fromkeys(_counters(), 0)
    for name in ("teacher_bf16", "student_bf16"):
        g = Synthesizer(models[name], batch_size=2, device=dev, mesh=mesh)
        e = Synthesizer(models[name], batch_size=2, device=dev, mesh=mesh)
        e.graphed = False
        zero_counts()
        g.synth_batch(toks[:2], W.SERVE_SEED, durations=durs[:2])
        torch.cuda.synchronize()
        for k, v in read_counts().items():
            launches[k] += v
        rows = {}
        for tag, s_ in (("graphed", g), ("eager", e)):
            res, per = per_call(lambda: s_.synth_batch(
                toks[:2], W.SERVE_SEED, durations=durs[:2]), 6)
            rows[tag] = {"mels": res[0][0], "per_call": per,
                         "ms": float(np.median([r[1]["wall_sec"] * 1e3
                                                for r in res[1:]]))}
        bit = _same(rows["graphed"]["mels"], rows["eager"]["mels"])
        same_stats = rows["graphed"]["per_call"] == rows["eager"]["per_call"]
        log(f"[parallel] 1 rank over {dist.get_backend()}, sharded "
            f"{name} serving (batch 2, durations given): graphed (the "
            f"gather's all-reduce captured) vs eager mels bit-equal {bit}; "
            f"Mesh.stats a call {rows['graphed']['per_call']} vs "
            f"{rows['eager']['per_call']}; synth_batch ms (median of 5 "
            f"after one) graphed {rows['graphed']['ms']:.3f} vs eager "
            f"{rows['eager']['ms']:.3f}; graphs {len(g.graphs.entries)} on "
            f"{kind} | {smi}")
        if not (bit and same_stats and g.graphs.entries):
            raise RuntimeError(f"parallel NCCL serving {name}: graphed "
                               f"differs from eager")
        out[f"serve_{name}"] = {k: {"per_call": v["per_call"], "ms": v["ms"]}
                                for k, v in rows.items()}
    out["launches"] = launches
    log("[parallel] " + json.dumps({"nccl": {k: v for k, v in out.items()
                                             if k != "launches"},
                                    "device": smi}))
    return out


def nccl_bf16_timing(smi, kind, mesh, dev, timed=4):
    """The steps a user of ``fcl_train --n-devices`` runs, on the NCCL
    mesh: FCL-taco2-T (bf16, published dropouts, classes 8,16,32,50) and
    the KD step (remat on and off) on the bench batch, graphed and eager
    (``graphed=False``), TF32 as the run leaves it: ms a step by CUDA
    events, median of ``timed`` after the capture (graphed) or one step
    (eager), beside ``[train]``'s and ``[kd]``'s single-process steps."""
    import torch.distributed as dist
    from fcl_taco2_tpu_torch.models import (Tacotron2SA, student_config,
                                            teacher_config)
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.parallel import _mp_worker as W
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import (make_kd_train_step,
                                                make_train_step,
                                                step_generator)
    kw = dict(odim=ODIM, duration_classes=DURATION_CLASSES)
    batch = W._upload(mesh, W._bench_batch(), dev)
    rows = {}
    for name in ("teacher", "kd_remat_on", "kd_remat_off"):
        for graphed in (False, True):
            tx = build_optimizer(name="adam", lr=1e-3, grad_clip=1.0)
            if name == "teacher":
                model = Tacotron2SA(teacher_config(IDIM, **kw), device=dev,
                                    seed=0)
                step = make_train_step(tx, mesh=mesh, graphed=graphed)
            else:
                scfg = student_config(IDIM, remat_decoder=name.endswith(
                    "on"), **kw)
                kd = KDStudent(scfg, teacher_config(IDIM, **kw), device=dev,
                               seed=0)
                model = kd.student
                step = make_kd_train_step(kd, tx, mesh, graphed=graphed)
            names, ps = zip(*model.named_parameters())
            ts = TrainState(model, tx.init(ps, names), 0, tx)
            step.prepare(ts, batch, step_generator(0, 0, dev))
            if not graphed:
                ts, _ = step(ts, batch, step_generator(0, ts.step, dev))
            times = []
            for _ in range(timed):
                e0, e1 = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                e0.record()
                ts, _ = step(ts, batch, step_generator(0, ts.step, dev))
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            rows.setdefault(name, {})["graphed" if graphed else "eager"] = {
                "ms": float(np.median(times)), "capture_s": step.capture_s}
            del model, step, ts
        r = rows[name]
        log(f"[parallel] 1 rank over {dist.get_backend()}, {name} bf16 "
            f"step on the bench batch (B=16, published dropouts): graphed "
            f"{r['graphed']['ms']:.2f} ms vs eager {r['eager']['ms']:.2f} "
            f"ms (CUDA events, median of {timed}); capture "
            f"{r['graphed']['capture_s']:.2f} s on {kind} | {smi}")
    return rows


def speaking_student(student, root):
    """A copy of the student checkpoint whose duration predictor gives
    about MEAN_DUR frames a phoneme (its linear head's weights scaled by
    0.1, its bias log(MEAN_DUR + 1)), for ``fcl_tts``, which decodes
    predicted durations only: a checkpoint a few steps old predicts near
    zero.  Every other weight is the distilled student's."""
    from fcl_taco2_tpu_torch.cli.fcl_synth import load_acoustic_model
    from fcl_taco2_tpu_torch.train import checkpoint as ckpt
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    model = load_acoustic_model(student, device=TRAIN_DEVICE)
    with torch.no_grad():
        lin = model.duration_predictor.linear
        lin.weight.mul_(0.1)
        lin.bias.fill_(float(np.log(MEAN_DUR + 1.0)))
    exp = os.path.join(root, "student_tts")
    ckpt.save_model_json(exp, model.cfg)
    path = os.path.join(exp, "model.loss.best")
    ckpt.save_checkpoint(path, TrainState(model, build_optimizer().init(
        list(model.parameters())), 1), 1)
    return path


def _decode_txt(out):
    """``fcl_synth``'s decode.txt -> (per-utterance (frames, batch wall),
    the summary lines)."""
    utts, summary = [], {}
    with open(os.path.join(out, "decode.txt")) as f:
        for line in f.read().splitlines():
            w = line.split()
            if len(w) == 2:
                summary[w[0]] = float(w[1])
            else:
                utts.append((int(w[2]), float(w[4])))
    return utts, summary


def phase_cli(smi, kind, root, ckpts):
    """The serving and scoring CLIs on the [kd] phase's checkpoints, each
    call run with the launch counters zeroed just before it.  Every timed
    call decodes the 49-utterance train manifest (7 batches of 8 for
    ``fcl_synth``, so the 1-deep overlap runs) after a warm-up call of the
    same CLI and checkpoint on the 7-utterance validation manifest.
    ``fcl_synth`` feeds the corpus durations; ``fcl_tts`` runs
    ``speaking_student``.  Returns the launches."""
    from fcl_taco2_tpu_torch.cli import fcl_eval, fcl_synth, fcl_tts
    from fcl_taco2_tpu_torch.cli import fcl_vocode
    from fcl_taco2_tpu_torch.data.manifest import (load_durations,
                                                   load_manifest)
    from fcl_taco2_tpu_torch.infer import synth as synth_mod
    from fcl_taco2_tpu_torch.infer.ark import read_ark_matrix
    teacher, student, manifest, warm_manifest = ckpts
    speaker = speaking_student(student, root)
    n_utts = len(load_manifest(manifest))
    out = {k: os.path.join(root, k) for k in (
        "synth_teacher", "synth_student", "synth_student_again",
        "synth_int8", "wav", "tts", "stream")}
    synth = ["--use-gt-durations", "--seed", "1", "--device", TRAIN_DEVICE]
    tts = ["--model", speaker, "--device", TRAIN_DEVICE]
    # (tag, CLI, its flags but the manifest and output, output flag,
    #  output key, kernels, warm up first)
    cases = (
        ("fcl_synth teacher", fcl_synth.main, ["--model", teacher, *synth],
         "--out", "synth_teacher", ("fused_ar_decode_hbm",), True),
        ("fcl_synth student", fcl_synth.main, ["--model", student, *synth],
         "--out", "synth_student", ("fused_ar_decode",), True),
        ("fcl_synth student, same seed", fcl_synth.main, [
            "--model", student, *synth], "--out", "synth_student_again",
         ("fused_ar_decode",), False),
        ("fcl_synth teacher --quantize int8", fcl_synth.main, [
            "--model", teacher, "--quantize", "int8", *synth], "--out",
         "synth_int8", ("fused_ar_decode_hbm",), True),
        ("fcl_tts student", fcl_tts.main, tts, "--outdir", "tts",
         ("fused_ar_decode", "pwg_generate_streaming"), True),
        ("fcl_tts student --stream", fcl_tts.main, tts + ["--stream"],
         "--outdir", "stream", ("fused_ar_decode", "pwg_stream_step"), True),
    )
    # whether each batch's readback was still in flight when the next
    # batch had been dispatched (the overlap did work), per fcl_synth call
    inflight = []
    consume = synth_mod.Synthesizer._consume

    def watched_consume(self, pend):
        event = pend["host"][1]  # _start_readback's (tensors, event)
        inflight.append(event is not None and not event.query())
        return consume(self, pend)

    def run(tag, main, argv, kernels):
        zero_counts()
        t0 = time.perf_counter()
        result = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for k in kernels:
            if counts[k] == 0:
                raise RuntimeError(f"{tag}: the CLI did not launch {k}")
        for k, v in counts.items():
            launches[k] += v
        return result, wall, counts

    launches = dict.fromkeys(_counters(), 0)
    synth_mod.Synthesizer._consume = watched_consume
    try:
        for tag, main, argv, flag, key, kernels, warm in cases:
            if warm:
                _, wall, counts = run(tag, main, argv + [
                    "--json", warm_manifest, flag, out[key] + "_warm"],
                    kernels)
                log(f"[cli] {tag} warm-up on the validation manifest: "
                    f"{wall:.2f} s wall with model loading; launches "
                    f"{counts}")
            inflight.clear()
            result, wall, counts = run(tag, main, argv + [
                "--json", manifest, flag, out[key]], kernels)
            if isinstance(result, dict):
                what = ", ".join(f"median {k} {v:.1f}"
                                 for k, v in result.items())
            else:
                utts, summary = _decode_txt(out[key])
                walls = sorted({w for _, w in utts})
                what = (f"{len(inflight)} batches, frames/s mean "
                        f"{summary['mean_frames_per_sec']:.1f} total "
                        f"{summary['total_frames_per_sec']:.1f} p50 "
                        f"{summary['p50_frames_per_sec']:.1f} p95 "
                        f"{summary['p95_frames_per_sec']:.1f}, batch walls "
                        f"{walls[0] * 1e3:.1f}-{walls[-1] * 1e3:.1f} ms, "
                        f"readback still in flight at the next dispatch "
                        f"for {sum(inflight[:-1])} of {len(inflight) - 1} "
                        f"batches")
                if len(utts) != n_utts or len(inflight) != 7 \
                        or not 0 < walls[0] <= walls[-1] < wall:
                    raise RuntimeError(f"{tag}: decode.txt {utts}")
            log(f"[cli] {tag} on {kind}, {n_utts} utterances: {what} (as "
                f"the CLI writes it); {wall:.2f} s wall with model "
                f"loading; launches {counts}")
    finally:
        synth_mod.Synthesizer._consume = consume
    _, wall, counts = run("fcl_vocode student", fcl_vocode.main, [
        "--feats-scp", os.path.join(out["synth_student"], "feats.scp"),
        "--outdir", out["wav"], "--device", TRAIN_DEVICE],
        ("pwg_generate_streaming",))
    log(f"[cli] fcl_vocode on the student's {n_utts} mels: {wall:.2f} s "
        f"wall with model loading; launches {counts}")
    # each decode: every utterance, its corpus frames, finite values
    want = {u.uttid: int(load_durations(u).sum())
            for u in load_manifest(manifest)}
    for k in ("synth_teacher", "synth_student", "synth_int8"):
        with open(os.path.join(out[k], "feats.scp")) as f:
            mats = {u: read_ark_matrix(ptr) for u, ptr in
                    (line.split() for line in f.read().splitlines())}
        if {u: m.shape for u, m in mats.items()} \
                != {u: (n, ODIM) for u, n in want.items()} \
                or not all(np.isfinite(m).all() for m in mats.values()):
            raise RuntimeError(f"{k}: wrong frames or non-finite mels")
    arks = []
    for k in ("synth_student", "synth_student_again"):
        with open(os.path.join(out[k], "feats.ark"), "rb") as f:
            arks.append(f.read())
    if arks[0] != arks[1]:
        raise RuntimeError("fcl_synth: two runs with one seed wrote "
                           "different arks")
    summary = fcl_eval.main(["--feats-scp", os.path.join(
        out["synth_student"], "feats.scp"), "--json", manifest])
    log(f"[cli] the three decodes hold {sum(want.values())} frames of "
        f"{len(want)} utterances, finite; fcl_synth student twice with seed "
        f"1: feats.ark byte-equal ({len(arks[0])} bytes); fcl_eval on the "
        f"student's feats.scp: {json.dumps(summary)}")
    if not np.isfinite(summary["mcd"]) or summary["n_utts"] != n_utts:
        raise RuntimeError(f"fcl_eval: {summary}")
    for k in ("wav", "tts", "stream"):
        sizes = [os.path.getsize(os.path.join(out[k], n))
                 for n in os.listdir(out[k])]
        if len(sizes) != n_utts or min(sizes) <= 44:  # 44: the wav header
            raise RuntimeError(f"{k}: {len(sizes)} wavs, sizes {sizes}")
    return launches


TOL_ATTN = 2e-2
TOL_ATTN_WHY = ("bf16 activations before each product on both sides; a "
                "last-bit difference in a sum flips one rounding, which the "
                "loop's feedback carries over the whole utterance")


def t2_batch(B=16, seed=0):
    """A ``tacotron2-synth-b16`` call's shapes: B utterances of N(71, 22)
    phonemes clipped to 12..112 (the first 112), tokens 1..69, each
    pinned to the sum of its Poisson(8) durations clipped to 1..50."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(rng.normal(71, 22, B)), 12, 112).astype(int)
    lens[0] = 112
    toks = [rng.integers(1, IDIM, n).astype(np.int32) for n in lens]
    frames = [int(durations(rng, n).sum()) for n in lens]
    return toks, frames


def phase_attn_decode(smi, kind):
    """Tacotron2's attention decode kernel (``csrc/attn_decode.cu``) at the
    published widths (``benchmark/configs/tacotron2-ljspeech.json``, bf16
    weights) on a batch of the cell's shapes (``t2_batch``: B=16, T=128,
    frame budget 1,024, dropout 0.5) against its plain version on the same
    card inputs: lengths and steps exact, frames, stop logits and
    attention weights within ``TOL_ATTN`` of the plain version's largest,
    and the plain version with the location term dropped beyond it (a
    kernel that lost the term fails).  The kernel's ms (CUDA events) beside
    the plain version's and the bound (``benchmark/counts/tacotron2.py``,
    the roofline metric's count); then the launches of ``Synthesizer``'s
    replays.  Returns (the kernels row, the launches)."""
    import copy
    from benchmark.counts import tacotron2 as counts
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.models.attention import project_memory
    from fcl_taco2_tpu_torch.models.encoder import encoder_apply
    from fcl_taco2_tpu_torch.models.tacotron2 import (Tacotron2,
                                                      Tacotron2Config)
    from fcl_taco2_tpu_torch.ops import attn_decode_cuda as A
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "benchmark", "configs",
                           "tacotron2-ljspeech.json")) as f:
        mc = json.load(f)["model"]
    cfg = Tacotron2Config(**mc)
    model = Tacotron2(cfg, seed=0)
    m = model.compute_model()
    toks, frames = t2_batch()
    B, budget = len(toks), -(-max(frames) // 256) * 256
    tokens, ilens, _ = _padded(toks, [np.zeros(len(t), np.int32)
                                      for t in toks], B, 32)
    lengths = torch.tensor(frames, device="cuda")
    kw = dict(budget=budget, zoneout=cfg.zoneout_rate,
              dropout=cfg.dropout_rate, thr_logit=0.0)
    seed = torch.tensor([2 ** 31 - 99], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        hs = encoder_apply(m.encoder, cfg, tokens, ilens)
        pe = project_memory(m.decoder.att, hs)
        lo, hi = A.length_bounds(ilens, budget, lengths)
        w = A.decoder_weights(m.decoder)
        packed = m.packed_decoder()

        def kernel():
            return A.attn_decode(w, hs, pe, ilens, lo, hi, seed,
                                 packed=packed, with_att=True, **kw)

        def plain(weights=w):
            return A.attn_decode_plain(weights, hs, pe, ilens, lo, hi, seed,
                                       **kw)

        got = kernel()
        launch = dict(A.last_launch)
        want = plain()
        no_loc = dict(w, att=copy.deepcopy(w["att"]))
        no_loc["att"].loc_conv.weight.zero_()
        fault = plain(no_loc)
    if not (torch.equal(got["olens"], want["olens"])
            and torch.equal(got["olens"].cpu(),
                            torch.tensor(frames, dtype=torch.int32))
            and int(got["steps"]) == int(want["steps"]) == max(frames)):
        raise RuntimeError(f"[attn_decode] lengths {got['olens'].tolist()} "
                           f"/ {int(got['steps'])} steps, plain "
                           f"{want['olens'].tolist()} / "
                           f"{int(want['steps'])}, pinned {frames}")

    def gap(a, b):
        return {k: float((a[k] - b[k]).abs().max()
                         / (b[k].abs().max() + 1e-6))
                for k in ("out", "stop", "att")}

    err, fault_err = gap(got, want), gap(fault, want)
    log(f"[attn_decode] B={B} T={tokens.shape[1]} budget {budget}, "
        f"{max(frames)} steps, frames {sum(frames)}: kernel against plain "
        + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
        + f" (tolerance {TOL_ATTN}: {TOL_ATTN_WHY}); launch {launch}; the "
        "plain version without the location term " + ", ".join(
            f"{k} {v:.2e}" for k, v in fault_err.items()))
    if max(err.values()) > TOL_ATTN:
        raise RuntimeError(f"[attn_decode] kernel against plain {err} > "
                           f"{TOL_ATTN}")
    if max(fault_err.values()) <= TOL_ATTN:
        raise RuntimeError(f"[attn_decode] the location term moves the "
                           f"answer by {fault_err} only: the tolerance "
                           f"{TOL_ATTN} cannot see a kernel that drops it")
    with torch.no_grad():
        k_ms = median_ms(kernel, 5)
        p_ms = median_ms(plain, 1, warmup=0)
    utts = [(len(t), f) for t, f in zip(toks, frames)]
    ops = sum(f * counts.decoder_step_flops(mc, L) for L, f in utts)
    b_ms, by = bound_ms(counts.decoder_loop_bytes(mc, utts, 2), ops,
                        torch.bfloat16)
    log(f"[attn_decode] kernel {k_ms:.3f} ms ({1e3 * k_ms / max(frames):.2f}"
        f" us a step), plain {p_ms:.1f} ms, bound {b_ms:.4f} ms ({by}; "
        f"roofline share {b_ms / k_ms:.2%}) | {smi}")

    synth = Synthesizer(model, batch_size=B, tok_bucket=32, frame_bucket=256)
    synth.synth_batch(toks, 0, lengths=frames)  # captures the graph
    from fcl_taco2_tpu_torch.ops import blstm_cuda as BK
    A.attn_decode.launches = BK.bilstm_infer.launches = 0
    calls = 4
    for rep in range(calls):
        mels, _ = synth.synth_batch(toks, rep + 1, lengths=frames)
    launches = A.attn_decode.launches
    if BK.bilstm_infer.launches != calls:
        raise RuntimeError(f"[attn_decode] {calls} Synthesizer calls "
                           f"launched the serving BiLSTM "
                           f"{BK.bilstm_infer.launches} times")
    if launches != calls or [x.shape[0] for x in mels] != frames:
        raise RuntimeError(f"[attn_decode] {calls} Synthesizer calls "
                           f"launched the kernel {launches} times")
    log(f"[attn_decode] Synthesizer on {kind}: {calls} calls, {launches} "
        f"launches of the attention kernel and {BK.bilstm_infer.launches} "
        f"of the serving BiLSTM (one each a replay of the synthesize "
        f"graph)")
    return dict(kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                err=err, tol=TOL_ATTN, weights="bfloat16", launch=launch,
                shape=f"B={B} T={tokens.shape[1]} budget {budget}, "
                f"{max(frames)} steps, dropout 0.5"), launches


TOL_BLSTM = 2e-2
TOL_BLSTM_WHY = ("both sides round at the same points; a last-bit "
                 "difference of the recurrent product's fp32 sum (another "
                 "summation order) flips one bf16 rounding of a gate now "
                 "and then, and the recurrence carries it on")


def blstm_case(H, d_in, lens, T, seed=0):
    """bf16 LSTM cells of ``H`` units a direction over ``d_in`` inputs
    (uniform in +-1/sqrt(H), as ``nn.LSTMCell``), inputs (B, T, d_in) and
    the lengths ``lens``, on the card."""
    import torch.nn as nn
    g = torch.Generator().manual_seed(seed)
    cells = []
    for _ in range(2):
        c = nn.LSTMCell(d_in, H)
        with torch.no_grad():
            for p in c.parameters():
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1)
                        / H ** 0.5)
        cells.append(c.to("cuda", torch.bfloat16))
    xs = torch.randn(len(lens), T, d_in, generator=g).to("cuda",
                                                         torch.bfloat16)
    return cells, xs, torch.tensor(lens, device="cuda")


LIBRARY_BLSTM = ("nn.LSTM(bidirectional=True) over pack_padded_sequence "
                 "(cuDNN), packing and padding included")


def library_bilstm(cells, lengths, T):
    """PyTorch's one call for the same function: ``nn.LSTM(bidirectional=
    True)`` with the two cells' weights, over ``pack_padded_sequence``
    (state frozen past each length, the reverse direction from the row's
    last token), padded back to T.  Returns call(xs)."""
    import torch.nn as nn
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence
    fwd, bwd = cells
    lstm = nn.LSTM(fwd.weight_ih.shape[1], fwd.weight_hh.shape[1],
                   batch_first=True, bidirectional=True).to(
                       fwd.weight_ih.device, fwd.weight_ih.dtype)
    with torch.no_grad():
        for sfx, c in (("", fwd), ("_reverse", bwd)):
            for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(lstm, f"{n}_l0{sfx}").copy_(getattr(c, n))
    lstm.flatten_parameters()
    lens_host = lengths.cpu()

    def call(xs):
        packed = pack_padded_sequence(xs, lens_host, batch_first=True,
                                      enforce_sorted=False)
        return pad_packed_sequence(lstm(packed)[0], batch_first=True,
                                   total_length=T)[0]

    return call


def phase_blstm(smi, kind):
    """The serving BiLSTM kernel (``csrc/blstm.cu``) against the loop it
    replaced at the serving cells' shapes, its ms beside the loop's,
    PyTorch's one library call for the same function (``library_bilstm``),
    its bound and the serial-step floor; then its launches and steps in a
    teacher ``Synthesizer``'s replays.  Returns the kernels row."""
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.models import Tacotron2SA, teacher_config
    from fcl_taco2_tpu_torch.ops import blstm_cuda as BK
    from fcl_taco2_tpu_torch.ops.rnn import bilstm
    from fcl_taco2_tpu_torch.utils.timing import HBM_BYTES_PER_S, queued_ms
    toks, _ = t2_batch()  # a synth call's phoneme counts, 12..112
    lens16 = [len(t) for t in toks]
    rows = {}
    for tag, H, d_in, lens, T in (
            ("synth T=96", 256, 512, [min(n, 96) for n in lens16], 96),
            ("synth T=128", 256, 512, lens16, 128),
            ("tts", 128, 256, [N_PHONES], N_PHONES)):
        cells, xs, il = blstm_case(H, d_in, lens, T)
        tiny, xt, it = blstm_case(6, 8, [max(lens)], T, seed=1)
        packed_call = library_bilstm(cells, il, T)
        with torch.no_grad():
            got = BK.bilstm_infer(*cells, xs, il)
            want = bilstm(*cells, xs, il)
            lib = packed_call(xs)
            launch = dict(BK.last_launch)
            err = float((got.float() - want.float()).abs().max())
            equal = float((got == want).float().mean())
            lib_err = float((lib.float() - want.float()).abs().max())
            k_ms = queued_ms(lambda: BK.bilstm_infer(*cells, xs, il), 20)
            f_ms = queued_ms(lambda: BK.bilstm_infer(*tiny, xt, it), 20)
            l_ms = queued_ms(lambda: packed_call(xs), 20)
            p_ms = median_ms(lambda: bilstm(*cells, xs, il), 3)
        B, steps = len(lens), max(lens)
        nbytes = 2 * (4 * H * H + B * T * 4 * H) * 2 + B * T * 2 * H * 2
        b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        log(f"[blstm] {tag}: B={B} H={H} T={T}, {steps} steps; kernel "
            f"against the loop: max abs gap {err:.3e} (tolerance "
            f"{TOL_BLSTM}: {TOL_BLSTM_WHY}), {equal:.4f} of the values "
            f"bit-equal; launch {launch}; call {k_ms:.4f} ms "
            f"({1e3 * k_ms / steps:.2f} us a step), serial-step floor "
            f"{f_ms:.4f} ms (H=6, B=1, {steps} steps), library {l_ms:.4f} "
            f"ms ({LIBRARY_BLSTM}; max abs gap to the loop {lib_err:.3e}), "
            f"loop {p_ms:.3f} ms, bound {b_ms:.5f} ms (bytes once) | {smi}")
        if err > TOL_BLSTM or not torch.isfinite(got.float()).all():
            raise RuntimeError(f"[blstm] {tag}: kernel against the loop "
                               f"{err} > {TOL_BLSTM}")
        rows[tag] = dict(kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         library=LIBRARY_BLSTM, library_err=lib_err,
                         bound_ms=b_ms, bound_by="bytes", floor_ms=f_ms,
                         err=err, bit_equal=equal, tol=TOL_BLSTM,
                         steps=steps, shape=f"B={B} H={H} T={T}",
                         launch=launch)

    model = Tacotron2SA(teacher_config(IDIM, odim=ODIM), seed=0)
    synth = Synthesizer(model, batch_size=16)
    durs = [np.full(len(t), 4, np.int32) for t in toks]
    synth.synth_batch(toks, 0, durations=durs)  # captures the graph
    BK.bilstm_infer.launches = 0
    calls = 4
    for rep in range(calls):
        synth.synth_batch(toks, rep + 1, durations=durs)
    torch.cuda.synchronize()
    stats = [r for r in synth.graphs.stats()
             if "blstm.steps" in r.get("counters", {})]
    steps = [r["counters"]["blstm.steps"] for r in stats]
    replays = sum(r["replays"] for r in stats)
    if BK.bilstm_infer.launches != calls or \
            steps != [replays * max(lens16)]:
        raise RuntimeError(f"[blstm] {calls} Synthesizer calls launched "
                           f"the kernel {BK.bilstm_infer.launches} times, "
                           f"blstm.steps {steps} over {replays} replays "
                           f"(want {max(lens16)} each)")
    log(f"[blstm] teacher Synthesizer B=16 on {kind}: {calls} calls, "
        f"{BK.bilstm_infer.launches} launches (one a replay); blstm.steps "
        f"{steps[0]} over {replays} replays ({max(lens16)} a replay, the "
        f"batch's longest row)")
    return rows["synth T=128"] | {"shapes": rows}


def _padded(toks, durs, B, bucket):
    Tmax = -(-max(len(t) for t in toks) // bucket) * bucket
    tokens = torch.zeros(B, Tmax, dtype=torch.int64)
    ilens = torch.zeros(B, dtype=torch.int64)
    dd = torch.zeros(B, Tmax, dtype=torch.int32)
    for i, (t, d) in enumerate(zip(toks, durs)):
        tokens[i, :len(t)] = torch.from_numpy(t.astype(np.int64))
        ilens[i] = len(t)
        dd[i, :len(t)] = torch.from_numpy(d)
    return tokens.cuda(), ilens.cuda(), dd.cuda()


def logged(fn, *args):
    """``fn(*args)``, its wall seconds logged under the function's name."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def timed_phase(name, fn, *args):
    """``fn(*args)``, its wall seconds logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    kind = torch.cuda.get_device_name(0)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fcl_taco2_tpu_torch.models import (Tacotron2SA, student_config,
                                            teacher_config)
    timed_phase("build", phase_build)
    t0 = time.perf_counter()
    models = {
        "teacher": Tacotron2SA(teacher_config(IDIM, odim=ODIM), seed=0),
        "student": Tacotron2SA(student_config(IDIM, odim=ODIM), seed=0),
    }
    log(f"[init] seeded full-width teacher and student in "
        f"{time.perf_counter() - t0:.1f} s")
    # phases 3-5 run at dropout 0 where they compare (the configs keep
    # the published 0.5 for the main paths)
    rows = timed_phase("kernels", phase_kernels, models)
    timed_phase("dropout", phase_dropout, models)
    pwg, pwg_rows = timed_phase("pwg", phase_pwg_kernels)
    regroup_row = timed_phase("regroup", phase_regroup, smi, kind)
    attn_row, attn_launches = timed_phase("attn_decode", phase_attn_decode,
                                          smi, kind)
    blstm_row = timed_phase("blstm", phase_blstm, smi, kind)
    launches = timed_phase("main", phase_main_path, models, kind)
    for k, v in timed_phase("import", phase_import, models, kind).items():
        launches[k] += v
    for name, phase in (("tts", phase_tts), ("stream", phase_stream)):
        for k, v in timed_phase(name, phase, models, pwg, kind).items():
            launches[k] += v
    for k, v in timed_phase("compiled", phase_compiled, models, pwg, smi,
                            kind).items():
        launches[k] += v
    del models
    for k, v in timed_phase("bench", phase_bench, smi, kind).items():
        launches[k] += v
    timed_phase("train", phase_train, smi, kind)
    timed_phase("graph", phase_graph, smi, kind)
    with tempfile.TemporaryDirectory() as root:
        ckpts = timed_phase("kd", phase_kd, smi, kind, root)
        for k, v in timed_phase("cli", phase_cli, smi, kind, root,
                                ckpts).items():
            launches[k] += v
        timed_phase("finetune", phase_finetune, smi, kind, root, ckpts[0],
                    *ckpts[2:])
        timed_phase("preprocess", phase_preprocess, smi, kind, root)
        for k, v in timed_phase("quality", phase_quality, smi, kind,
                                root).items():
            launches[k] += v
        for k, v in timed_phase("parallel", phase_parallel, smi, kind,
                                root).items():
            launches[k] += sum(v)
    log(f"[phase] all: {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, replaces, main_P in (
            ("fused_ar_decode", "fcl_taco2_tpu/ops/decoder_pallas.py:66",
             96),
            ("fused_ar_decode_hbm",
             "fcl_taco2_tpu/ops/decoder_pallas.py:170", 96)):
        # the main path's shape: batch 1 (P = 96), ragged, auto's dtype
        main = [r for r in rows if r["name"] == name and r["P"] == main_P
                and r["ragged"]][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fcl_taco2_tpu_torch/csrc/ar_decode.cu",
            "replaces": replaces, "launches": launches[name],
            "library_ms": None,
            **{k: v for k, v in main.items() if k not in ("name", "tol")}})
    # the text -> wav path's shape (B = 1, 1536 frames) and the stream's
    # (Vh = 4096 samples a step)
    for name, replaces, key, shape in (
            ("pwg_generate_streaming",
             "fcl_taco2_tpu/vocoder/pwg_pallas.py:109", (1, 1536),
             "B=1 Tm=1536"),
            ("pwg_stream_step", "fcl_taco2_tpu/vocoder/pwg_pallas.py:266",
             "step", "B=1 Vh=4096")):
        row = pwg_rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fcl_taco2_tpu_torch/csrc/pwg_stream.cu",
            "replaces": replaces, "launches": launches[name],
            **row, "library_ms": None, "weights": "float32",
            "shape": shape})
    kernels.append({
        "name": "gather_backward", "route": "cuda",
        "source": "fcl_taco2_tpu_torch/csrc/regroup.cu",
        "replaces": None, "launches": launches["gather_backward"],
        "library_ms": None, **regroup_row})
    kernels.append({
        "name": "bilstm_infer", "route": "cuda",
        "source": "fcl_taco2_tpu_torch/csrc/blstm.cu",
        "replaces": None, "launches": launches["bilstm_infer"],
        **blstm_row})
    kernels.append({
        "name": "attn_decode", "route": "cuda",
        "source": "fcl_taco2_tpu_torch/csrc/attn_decode.cu",
        "replaces": None, "launches": attn_launches, "library_ms": None,
        **attn_row})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
