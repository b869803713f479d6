"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``fcl_taco2_tpu_torch/_build/lib<name>-<hash>.so`` (the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags,
so an edited source or header rebuilds).
Nothing is imported or compiled at module import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}  # name -> ctypes.CDLL, one load per process


def nvcc_path():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's kernels build with it")
    return found


def build(name):
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns (path, compiler log); the log holds ptxas' register and
    shared-memory report when it compiled."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a half-written library never loads
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load_library(name):
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name not in _loaded:
        path, _ = build(name)
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
