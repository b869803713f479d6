"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and
prints no result):

1. Device: name and power limit (nvidia-smi), TF32 switches off.
2. Build: ``csrc/ar_decode.cu`` with nvcc for sm_90a, from the checkout.
3. Kernel vs plain version on the card, full width, dropout 0:
   ``fused_ar_decode`` (student weights; fp32, bf16) and
   ``fused_ar_decode_hbm`` (teacher weights; bf16, int8), P = 96 and
   2048, ragged on and off; max abs error against the stated tolerance,
   median ms of each.
4. Dropout statistics of the kernel's Philox draws.
5. Main path: ``Synthesizer.synth_batch`` with the headline benchmark's
   protocol (bench.py: idim 70, odim 80, 96 phonemes, Poisson(8)
   durations clipped to [1, 50], seed 0, durations given), seeded
   full-width weights, bf16 compute: teacher batch 1, teacher batch 16,
   teacher batch 1 int8, student batch 1.  Launch counters are zeroed
   just before each case's main-path call and must be non-zero after it.
6. One JSON line of the kernels, the nvidia-smi line, and last the
   result line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

IDIM, ODIM = 70, 80
N_PHONES, MEAN_DUR, MAX_DUR = 96, 8, 50
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
            torch.int8: 989e12}  # int8 codes are multiplied as bf16
TOL_F32 = 1e-4
TOL_F32_WHY = ("fp32 products in another summation order than the "
               "plain version's GEMMs, carried through up to 50 AR steps")
TOL_BF16 = 2e-3
TOL_BF16_WHY = ("activations are rounded to bf16 before each product, so "
                "a last-bit difference in a sum can flip one rounding "
                "(2^-8 relative) that the AR feedback carries on")


def log(*a):
    print(*a, flush=True)


def median_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def bound_ms(nbytes, ops, wdt):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[wdt]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    from fcl_taco2_tpu_torch.utils.cuda_build import build
    t0 = time.perf_counter()
    path, compiler_log = build("ar_decode")
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(models):
    """Each kernel against its plain version at full width."""
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    rows = []
    for name, fn, plain, model_key, wdts in (
            ("fused_ar_decode", K.fused_ar_decode, K.fused_ar_decode_plain,
             "student", (torch.float32, torch.bfloat16)),
            ("fused_ar_decode_hbm", K.fused_ar_decode_hbm,
             K.fused_ar_decode_hbm_plain, "teacher",
             (torch.bfloat16, torch.int8))):
        model = models[model_key]
        cfg = model.cfg
        dp = model.decoder.jax_layout()
        for P in (96, 2048):
            for ragged in (True, False):
                enc, pos, fm, bounds = segment_batch(cfg, P, 0, ragged)
                for wdt in wdts:
                    kw = dict(zoneout=cfg.zoneout_rate, dropout=0.0,
                              weights_dtype=wdt, bounds=bounds)
                    with torch.no_grad():
                        got = fn(dp, enc, pos, 0, **kw)
                        want = plain(dp, enc, pos, 0, **kw)
                        torch.cuda.synchronize()
                        err = ((got - want) * fm[..., None]).abs().max()
                        err = float(err)
                        tol, why = (TOL_F32, TOL_F32_WHY) \
                            if wdt == torch.float32 else (TOL_BF16,
                                                          TOL_BF16_WHY)
                        ms = median_ms(lambda: fn(dp, enc, pos, 0, **kw), 5)
                        plain_ms = median_ms(
                            lambda: plain(dp, enc, pos, 0, **kw), 3)
                    # int8 streams codes; the resident weights stay bf16
                    rdt = torch.bfloat16 if wdt == torch.int8 else wdt
                    nbytes, ops = work(cfg, P, bounds, cfg.max_dur, rdt,
                                       fn is K.fused_ar_decode, wdt)
                    b_ms, b_by = bound_ms(nbytes, ops, wdt)
                    row = dict(name=name, P=P, ragged=ragged,
                               weights=str(wdt).replace("torch.", ""),
                               max_abs_err=err, tol=tol, ms=ms,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by)
                    rows.append(row)
                    log(f"[kernel] {name} P={P} ragged={ragged} "
                        f"weights={row['weights']}: max_abs_err={err:.3e} "
                        f"(tol {tol:g}: {why}) kernel {ms:.3f} ms, plain "
                        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                        f"({b_by})")
                    if not np.isfinite(err) or err > tol:
                        raise RuntimeError(f"{name} disagrees with its "
                                           f"plain version: {row}")
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


def phase_main_path(models, kind):
    """The four serving cases; returns (launch counts, frames/s lines)."""
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    rng = np.random.default_rng(0)
    dur1 = durations(rng, N_PHONES)
    tok1 = rng.integers(1, IDIM, N_PHONES).astype(np.int32)
    lens16 = np.concatenate([[N_PHONES], rng.integers(48, N_PHONES + 1, 15)])
    toks16 = [rng.integers(1, IDIM, n).astype(np.int32) for n in lens16]
    durs16 = [durations(rng, n) for n in lens16]
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
    launches = {"fused_ar_decode": 0, "fused_ar_decode_hbm": 0}
    for tag, mkey, B, quantize, toks, durs, kernel in cases:
        synth = Synthesizer(models[mkey], batch_size=B, quantize=quantize)
        K.fused_ar_decode.launches = K.fused_ar_decode_hbm.launches = 0
        mels, stats = synth.synth_batch(toks, 0, durations=durs)
        torch.cuda.synchronize()
        counts = {"fused_ar_decode": K.fused_ar_decode.launches,
                  "fused_ar_decode_hbm": K.fused_ar_decode_hbm.launches}
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
        tokens, ilens, dd = _padded(toks, durs, B, synth)
        full = synth.model.synthesize(tokens, ilens, 0, stats["budget"],
                                      durations=dd, quantize=quantize,
                                      prequant=synth.prequant)
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
    return launches


def breakdown(synth, tokens, ilens, dd, budget, tag, kind):
    """Host-clock split of one synthesize call, each stage synchronized:
    frontend (synth_frontend: encoder + predictors), decode
    (decode_segments) and the rest (plan, frame scatter, postnet)."""
    m = synth.model
    stage_ms = {"synth_frontend": [], "decode_segments": []}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

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
                quantize=synth.quantize, prequant=synth.prequant))
            rows.append((total, stage_ms["synth_frontend"][0],
                         stage_ms["decode_segments"][0]))
    finally:
        for name in stage_ms:
            delattr(m, name)  # back to the class methods
    total, front, dec = np.median(np.array(rows[1:]), axis=0)
    log(f"[breakdown] {tag} on {kind}: synthesize {total:.2f} ms = "
        f"frontend {front:.2f} + decode {dec:.2f} + plan/scatter/postnet "
        f"{total - front - dec:.2f} (host clock, synchronized, median of 3)")


def _padded(toks, durs, B, synth):
    Tmax = -(-max(len(t) for t in toks) // synth.tok_bucket) \
        * synth.tok_bucket
    tokens = torch.zeros(B, Tmax, dtype=torch.int64)
    ilens = torch.zeros(B, dtype=torch.int64)
    dd = torch.zeros(B, Tmax, dtype=torch.int32)
    for i, (t, d) in enumerate(zip(toks, durs)):
        tokens[i, :len(t)] = torch.from_numpy(t.astype(np.int64))
        ilens[i] = len(t)
        dd[i, :len(t)] = torch.from_numpy(d)
    return tokens.cuda(), ilens.cuda(), dd.cuda()


def main():
    smi = phase_device()
    kind = torch.cuda.get_device_name(0)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fcl_taco2_tpu_torch.models import (Tacotron2SA, student_config,
                                            teacher_config)
    phase_build()
    t0 = time.perf_counter()
    models = {
        "teacher": Tacotron2SA(teacher_config(IDIM, odim=ODIM), seed=0),
        "student": Tacotron2SA(student_config(IDIM, odim=ODIM), seed=0),
    }
    log(f"[init] seeded full-width teacher and student in "
        f"{time.perf_counter() - t0:.1f} s")
    # phases 3-4 run at dropout 0 where they compare (the configs keep
    # the published 0.5 for the main path)
    rows = phase_kernels(models)
    phase_dropout(models)
    launches = phase_main_path(models, kind)

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
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "weights": main["weights"], "P": main_P})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
