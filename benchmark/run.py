"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix, driver
and metric readers are found by the names in ``BENCHMARK.json``
(``benchmark/harness.py``).  Exits with 2 and prints no result where the
cell's cards are missing.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one process with few threads: the host's side of a call stays steady
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from benchmark import harness
    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return harness.run_cell(spec, args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T0)


if __name__ == "__main__":
    sys.exit(main())
