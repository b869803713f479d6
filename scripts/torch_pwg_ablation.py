"""Where the time of the port's PWG kernel goes, on one NVIDIA GPU.

    python3 scripts/torch_pwg_ablation.py

Builds ablated copies of ``fcl_taco2_tpu_torch/csrc/pwg_stream.cu`` with
``csrc/tf32.cuh`` inlined (each
drops one part of the work, so its output is wrong and only its time
means anything) and times each, kernel alone, on the text -> wav path's
shape (PWG v1, B=1, Tm=1536: 393,216 samples) and on a 4096-sample stream
step, CUDA events, median of 5 and 10:

    base       the kernel as committed
    no_sync    the grid-wide barriers removed
    one_pass   one TF32 product (hi.hi) instead of three
    no_split   the operands passed unsplit (3 products of the raw bits)
    no_mma     no tensor-core products (the compiler drops their loads)
    no_gather  the A tiles left unloaded
    one_group  one group of 8 warps a block instead of two (right output)

Then the committed kernel at other rows per grid-wide phase
(``pwg_cuda.ROWS_PER_PHASE``) at B=1, 8 and 16.  Prints one line per
measurement, with the card's name and power limit first.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fcl_taco2_tpu_torch.utils import cuda_build as CB  # noqa: E402
from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC  # noqa: E402
from fcl_taco2_tpu_torch.utils.timing import median_ms  # noqa: E402
from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN,  # noqa: E402
                                             PWGConfig, upsample_mel)

MMA3 = """  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);"""
SPLIT = """  hi = __float_as_uint(x) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;"""
GATHER = """      if (src != nullptr)
        cp16(dst + 4 * c4, src);
      else
        st4(dst + 4 * c4, zero);"""
VARIANTS = {
    "base": [],
    "no_sync": [("grid.sync();", "")],
    "one_pass": [(MMA3, "  mma_tf32(c, ah, bh[0], bh[1]);")],
    "no_split": [(SPLIT, "  hi = __float_as_uint(x);\n  lo = 0u;")],
    "no_mma": [(MMA3, "")],
    "no_gather": [(GATHER, "      if (rt < 0) st4(dst + 4 * c4, zero);")],
    "one_group": [("const int NG = smem_bytes(2, a->K1p) <= (size_t)optin"
                   " ? 2 : 1;", "const int NG = 1;")],
}


def build_variant(name, edits):
    # the shared TF32 header inlined, so its parts can be edited too
    src = (CB.CSRC / "pwg_stream.cu").read_text().replace(
        '#include "tf32.cuh"', (CB.CSRC / "tf32.cuh").read_text())
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    CB.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = CB.BUILD_DIR / f"ablation_{name}.cu"
    cu.write_text(src)
    return CB.build(cu)[0]


def use_library(path):
    PC._PWG.bind(CB.load_library(path))


def inputs(pwg, cfg, B, Tm):
    g = torch.Generator(device="cuda").manual_seed(B)
    mel = torch.randn(B, Tm, cfg.aux_channels, generator=g, device="cuda")
    noise = torch.randn(B, Tm * cfg.hop, generator=g, device="cuda")
    with torch.no_grad():
        return upsample_mel(pwg, cfg, mel), noise


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_pwg_ablation: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[ablation] {smi}", flush=True)
    cfg = PWGConfig()
    pwg = ParallelWaveGAN(cfg, seed=0)
    packed = PC.pack_pwg_weights(pwg, cfg)
    delay = PC._round8(PC.total_delay(cfg))
    aux, noise = inputs(pwg, cfg, 1, 1536)
    W = aux.shape[1]
    Vh = 4096
    state = PC.pwg_stream_state(cfg, 1)

    def oneshot():
        return PC._launch(packed, cfg, aux, noise, 0, W, W + delay, None)

    def step():
        return PC._launch(packed, cfg, aux[:, :Vh], noise[:, :Vh], 0, W, Vh,
                          state)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS,
                                           VARIANTS.values())))
    for name, path in libs.items():
        use_library(path)
        ms = median_ms(oneshot, 5)
        step_ms = median_ms(step, 10)
        print(f"[ablation] {name}: one-shot B=1 Tm=1536 {ms:.3f} ms, "
              f"stream step Vh={Vh} {step_ms:.3f} ms", flush=True)

    use_library(libs["base"])
    default = PC.ROWS_PER_PHASE
    for B, Tm in ((1, 1536), (8, 512), (16, 1536)):
        aux, noise = inputs(pwg, cfg, B, Tm)
        W = aux.shape[1]
        for rows in (8192, default, 32768, 65536):
            PC.ROWS_PER_PHASE = rows
            ms = median_ms(lambda: PC._launch(packed, cfg, aux, noise, 0, W,
                                              W + delay, None), 3)
            print(f"[ablation] rows a phase {rows}: B={B} Tm={Tm} kernel "
                  f"{ms:.3f} ms, {PC.last_launch['barriers']} grid "
                  f"barriers", flush=True)
        PC.ROWS_PER_PHASE = default
        del aux, noise


if __name__ == "__main__":
    main()
