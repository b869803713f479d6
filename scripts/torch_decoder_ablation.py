"""Where the time of the port's AR-decoder kernel goes, on one NVIDIA GPU.

    python3 scripts/torch_decoder_ablation.py [variant ...]

Builds edited copies of ``fcl_taco2_tpu_torch/csrc/ar_decode.cu`` (with
``csrc/tf32.cuh`` inlined), all compilers started together, and times each
copy's kernel alone (packed weights, prepared operands; CUDA events, median
of 10) at the main path's shapes: teacher P=96 ragged bf16 and int8,
student P=96 ragged fp32, teacher P=1536 ragged bf16 (the batch-16 decode)
and P=2048 unragged bf16.  Each line gives the copy's max abs error against
the plain version beside its time: ablations drop work, so only their time
means anything; the other variants must stay within the smoke run's limits.

    base        the kernel as committed; also traced once (``mark``) for
                a per-phase breakdown summed over the steps
    no_sync     the grid-wide barriers replaced by block barriers
    no_row      the fused [feat_out + prenet] phase removed from the loop
    no_lstm     both LSTM phases removed from the loop
    no_aload    the products' activation fragments not loaded
    no_bload    the products' weight fragments not loaded
    fences      full fences around the grid barrier's release and acquire
    lstm_unr8, row_unr8   twice the k16 steps of loads in flight a warp
    rotate      each block starts its K walks at its own k16 step
    precise     the cell update's sigmoid and tanh at full precision

Prints one line per measurement, with the card's name and power limit first.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fcl_taco2_tpu_torch.ops import decoder_cuda as K  # noqa: E402
from fcl_taco2_tpu_torch.utils import cuda_build as CB  # noqa: E402
from fcl_taco2_tpu_torch.utils.timing import median_ms  # noqa: E402

LSTM_UNR = "  constexpr int UNR = sizeof(AT) == 4 ? 2 : 4;\n  constexpr int NT"
ROW_UNR = "  constexpr int UNR = sizeof(AT) == 4 ? 2 : 4;\n  for (int n0"
VARIANTS = {
    "base": [],
    "no_sync": [("    grid_sync(bar, target);\n    mark(trace, t,",
                 "    __syncthreads();\n    mark(trace, t,")],
    "no_row": [("    row_phase(c, t);\n", "")],
    "no_lstm": [("    lstm_phase<WT, BT, NT8>(c, 0, t, w, stationary, "
                 "n_pairs, xbuf);\n", ""),
                ("    lstm_phase<WT, BT, NT8>(c, 1, t, w, stationary, "
                 "n_pairs, xbuf);\n", "")],
    # the products' operands not loaded (zero fragments)
    "no_aload": [("      a[u][0] = ALoad<AT, AG>::ld(pa + 16 * (kg + u));\n"
                  "      a[u][1] = ALoad<AT, AG>::ld(pa + 8L * lda + 16 * "
                  "(kg + u));", "      a[u][0] = a[u][1] = AF{};")],
    "no_bload": [("        b[u][n] = BLoad<BT>::ld(pb[n] + (long)(kg + u) * "
                  "128);",
                  "        b[u][n] = BF{};")],
    # full fences around the barrier's release add and acquire spin
    "fences": [("  if (threadIdx.x == 0) {\n    asm volatile(\"red.release",
                "  if (threadIdx.x == 0) {\n    __threadfence();\n"
                "    asm volatile(\"red.release"),
               ("    } while (v < target);\n  }",
                "    } while (v < target);\n    __threadfence();\n  }")],
    # twice the k16 steps of loads in flight
    "lstm_unr8": [(LSTM_UNR, "  constexpr int UNR = sizeof(AT) == 4 ? 4 : 8;"
                   "\n  constexpr int NT")],
    "row_unr8": [(ROW_UNR, "  constexpr int UNR = sizeof(AT) == 4 ? 4 : 8;"
                  "\n  for (int n0")],
    # each block starts its K walks at its own k16 step, so the blocks do
    # not read the same activation lines of L2 at the same time
    "rotate": [
        ("int nvalid = NT) {", "int nvalid = NT, int k0 = 0) {"),
        ("  int kg = 0;\n", "  auto rot = [&](int k) { return k + k0 < kgn ? "
         "k + k0 : k + k0 - kgn; };\n  int kg = 0;\n"),
        ("16 * (kg + u))", "16 * rot(kg + u))"),
        ("(long)(kg + u) * 128);", "(long)rot(kg + u) * 128);"),
        ("16 * kg)", "16 * rot(kg))"),
        ("(long)kg * 128)", "(long)rot(kg) * 128)"),
        ("Kx, Bx, bsx, xn);",
         "Kx, Bx, bsx, xn, NT, xn ? (s * 13) % xn : 0);"),
        ("c.Hp, Bh, bsh, hn);",
         "c.Hp, Bh, bsh, hn, NT, hn ? (s * 13) % hn : 0);")],
    # the cell update's sigmoid and tanh at full precision
    "precise": [("  return __fdividef(1.0f, 1.0f + __expf(-x));",
                 "  return 1.0f / (1.0f + expf(-x));"),
                ("  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;",
                 "  return tanhf(x);")],
}


def source():
    return (CB.CSRC / "ar_decode.cu").read_text().replace(
        '#include "tf32.cuh"', (CB.CSRC / "tf32.cuh").read_text())


def build_variant(name, edits):
    src = source()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    CB.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = CB.BUILD_DIR / f"dec_ablation_{name}.cu"
    cu.write_text(src)
    so, log = CB.build(cu)
    spills = [ln.strip() for ln in log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")]
    return so, spills


def use_library(path):
    K._AR_DECODE.bind(CB.load_library(path))


def case(model, P, ragged, wdt, seed=0):
    """Prepared operands of one kernel-alone launch and its plain output."""
    cfg = model.cfg
    dp = model.decoder.jax_layout()
    rng = np.random.default_rng(seed)
    dur = np.clip(rng.poisson(8, P), 1, 50).astype(np.int32)
    if ragged:
        dur = np.sort(dur)[::-1].copy()
    dur_t = torch.from_numpy(dur).cuda()
    d = torch.arange(cfg.max_dur, device="cuda")[None, :]
    fm = d < dur_t[:, None]
    pos = torch.where(fm, d.float() / dur_t[:, None].float(), 0.0)
    enc = torch.from_numpy(
        rng.normal(size=(P, cfg.dec_idim)).astype(np.float32)).cuda()
    bounds = K.tile_step_bounds(dur_t) if ragged else None
    resident = wdt == torch.float32
    pk = K.pack_decoder_weights(dp, cfg.dec_idim, wdt)
    kw = dict(zoneout=cfg.zoneout_rate, dropout=0.0, weights_dtype=wdt,
              bounds=bounds)
    plain = K.fused_ar_decode_plain if resident else \
        K.fused_ar_decode_hbm_plain
    with torch.no_grad():
        want = plain(dp, enc, pos, 0, **kw)
        if resident:
            t = {"enc": enc, "pos": pos,
                 "enc_gates": torch.empty(P, 4 * pk.H, device="cuda"),
                 "enc_out": torch.empty(P, pk.odim, device="cuda")}
        else:
            eg, eo = K._hoisted_enc(enc, pk._asdict())
            t = {"pos": pos, "enc_gates": eg.contiguous(),
                 "enc_out": eo.contiguous()}

    def launch(trace=None):
        return K._launch(pk, resident=resident, tensors=t, P=P,
                         D=cfg.max_dur, bounds=bounds,
                         zoneout=cfg.zoneout_rate, dropout=0.0, seed=0,
                         trace=trace)
    return launch, want, fm


PHASES = ("fused feat_out+prenet", "barrier 1", "LSTM 0", "barrier 2",
          "LSTM 1", "barrier 3")


def breakdown(launch, D):
    """Per-phase time of one traced launch, summed over the steps (us):
    a work phase from its earliest start to its last block's end, a
    barrier from that end to the last block's release."""
    trace = torch.zeros((D + 1) * 7 * 1024, dtype=torch.int64,
                        device="cuda")
    launch(trace)
    torch.cuda.synchronize()
    grid = K.last_launch["grid"]
    ev = trace[:(D + 1) * 7 * grid].view(D + 1, 7, grid).double()
    steps = int((ev[:, 0] > 0).all(dim=1).sum())
    ev = ev[:steps]
    start, last = ev.min(dim=2).values, ev.max(dim=2).values
    parts = []
    for i in range(6):
        if i % 2 == 0:  # work: earliest start to the last block's end
            parts.append(last[:, i + 1] - start[:, i])
        else:  # barrier: the last block's arrival to the last release
            parts.append(last[:, i + 1] - last[:, i])
    tot = [float(p.sum()) / 1e3 for p in parts]
    return steps, tot


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_decoder_ablation: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[ablation] {smi}", flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build_variant(n, VARIANTS[n]), names)))
    for n, (_, spills) in built.items():
        if spills:
            print(f"[ablation] {n}: ptxas {'; '.join(spills)}", flush=True)
    from fcl_taco2_tpu_torch.models import (Tacotron2SA, student_config,
                                            teacher_config)
    teacher = Tacotron2SA(teacher_config(70, odim=80), seed=0)
    student = Tacotron2SA(student_config(70, odim=80), seed=0)
    shapes = [("teacher P=96 ragged bf16", teacher, 96, True, torch.bfloat16),
              ("teacher P=96 ragged int8", teacher, 96, True, torch.int8),
              ("student P=96 ragged fp32", student, 96, True, torch.float32),
              ("teacher P=1536 ragged bf16", teacher, 1536, True,
               torch.bfloat16),
              ("teacher P=2048 bf16", teacher, 2048, False, torch.bfloat16)]
    cases = [(label, *case(m, P, r, w)) for label, m, P, r, w in shapes]
    for n in names:
        use_library(built[n][0])
        if n == "base":
            for label, launch, _, _ in cases:
                steps, tot = breakdown(launch, 50)
                print(f"[trace] {label}: {steps} steps, "
                      + ", ".join(f"{p} {t:.1f} us ({t / steps:.2f} a step)"
                                  for p, t in zip(PHASES, tot)), flush=True)
        for label, launch, want, fm in cases:
            got = launch()
            torch.cuda.synchronize()
            err = float(((got - want) * fm[..., None]).abs().max())
            ms = median_ms(launch, 10)
            print(f"[ablation] {n:12s} {label}: {ms:.3f} ms kernel alone, "
                  f"max_abs_err vs plain {err:.3e}; {K.last_launch}",
                  flush=True)


if __name__ == "__main__":
    main()
