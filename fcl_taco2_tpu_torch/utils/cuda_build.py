"""The one seam between the port's Python and its native code: every
source under ``csrc/`` is built, loaded, typed, launched, checked and
counted here.  A kernel's wrapper keeps only its own kernel's rules:
shapes, scratch sizes, geometry and its plain version.

``build(name)`` compiles ``csrc/<name>.cu`` with nvcc (``csrc/fclrt.cpp``,
the host plan builder, with the C++ compiler) into
``fcl_taco2_tpu_torch/_build/lib<stem>-<hash>.so`` unless it is there; the
hash covers the source, for CUDA sources the headers ``csrc/*.cuh``, and
the flags.  ``load_library`` loads a library once a process.  Nothing is
compiled at import time.

Every kernel entry is ``int <name>_launch(const <Name>Args*, [int kind,]
void* stream, <Name>LaunchInfo*)``: the operands in one struct, a kind
code where it has several instantiations (``KIND`` for a float type), the
stream, and a struct it fills with the launch's geometry; it returns a
``cudaError_t``.  Each wrapper mirrors both structs as ctypes structures
of the same names (``tests/test_torch_port_runtime.py`` holds the mirrors
to ``csrc/``).  ``Entry.launch`` calls an entry on the operands' device's
current stream, raises on a nonzero code, fills the entry's ``last`` (the
wrapper's ``last_launch``) and counts the wrapper's launch
(``utils/graphs.py::count_launch``: inside a capture, once a replay).  The
span mark and the dropout mask take scalars in place of the struct.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
KIND = {torch.float32: 0, torch.bfloat16: 1}  # an entry's kind of a dtype

_loaded = {}  # source path -> ctypes.CDLL, one load per process


def r16(x):
    """``x`` rounded up to a multiple of 16 (a k16 step, an m16 tile)."""
    return -(-x // 16) * 16


def nvcc_path():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's kernels build with it")
    return found


def cxx_path():
    """The C++ compiler: ``$CXX``, else ``g++``, else ``c++``; None when
    none is on PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def source(name):
    """``csrc/<name>.cu``, ``csrc/<name>`` for a file name, or a path."""
    if isinstance(name, Path):
        return name
    return CSRC / (name if "." in name else f"{name}.cu")


def build(name):
    """Compile ``source(name)`` unless an up-to-date library exists.
    Returns (path, compiler log: for CUDA, ptxas' registers and shared
    memory when it compiled)."""
    src = source(name)
    if src.suffix == ".cu":
        compiler, flags = nvcc_path(), NVCC_FLAGS
        headers = sorted(CSRC.glob("*.cuh"))
    else:
        compiler, flags, headers = cxx_path(), CXX_FLAGS, []
        if compiler is None:
            raise FileNotFoundError("no C++ compiler (g++/c++) on PATH")
    h = hashlib.sha256(src.read_bytes())
    for header in headers:
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    lib = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, f"-I{CSRC}", "-o", tmp,
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a half-written library never loads
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load_library(name):
    """Build (if needed) and load ``source(name)``; cached per process.
    A path to a built library loads as it is."""
    key = source(name)
    if key not in _loaded:
        path = key if key.suffix == ".so" else build(key)[0]
        _loaded[key] = ctypes.CDLL(str(path))
    return _loaded[key]


def struct(cls, **fields):
    """A ctypes mirror ``cls`` of its fields: a tensor as its data
    pointer, None as null, a number as it is."""
    return cls(**{k: v.data_ptr() if torch.is_tensor(v) else v
                  for k, v in fields.items()})


class Entry:
    """The ``extern "C"`` entry ``name`` of ``csrc/<library>.cu``, typed
    at its first launch: ``params`` (ctypes types) before the stream,
    ``info`` (a ctypes structure) after it, or no info."""

    def __init__(self, library, name, params, info=None):
        self.library, self.name = library, name
        self.params, self.info = tuple(params), info
        self.last = {}  # the newest launch's info (the wrapper's last_launch)
        self._fn = None

    @classmethod
    def kernel(cls, library, name, args, info, kind=False):
        """An entry of the convention: ``args`` its ``*Args`` mirror."""
        return cls(library, name,
                   [ctypes.POINTER(args)] + [ctypes.c_int] * bool(kind), info)

    def bind(self, lib):
        """Type the entry in ``lib`` (a loaded library) and launch it from
        there on."""
        fn = getattr(lib, self.name)
        fn.argtypes = [*self.params, ctypes.c_void_p] + (
            [] if self.info is None else [ctypes.POINTER(self.info)])
        fn.restype = ctypes.c_int
        self._fn = fn

    def launch(self, *args, device, count=None, context=""):
        """Call the entry with ``args`` (structs by reference) on
        ``device``'s current stream; raise on a nonzero code, naming the
        entry, the CUDA error and ``context``; fill ``last``; count one
        launch of ``count`` (a kernel wrapper) when given."""
        if self._fn is None:
            self.bind(load_library(self.library))
        info = None if self.info is None else self.info()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._fn(*(ctypes.byref(a) if isinstance(a, ctypes.Structure)
                         else a for a in args), ctypes.c_void_p(stream),
                       *(() if info is None else (ctypes.byref(info),)))
        got = {} if info is None else {n: getattr(info, n)
                                       for n, _ in info._fields_}
        if err != 0:
            raise RuntimeError(f"{self.name} failed with CUDA error {err} "
                               f"({context}; launch info {got})")
        self.last.clear()
        self.last.update(got)
        if count is not None:  # graphs imports spans, which imports this
            from fcl_taco2_tpu_torch.utils.graphs import count_launch
            count_launch(count)


def operand(t, name, shape, dtype, device, *, cast=False, align16=False):
    """``t`` as a kernel operand: on ``device`` and of ``shape``, else a
    ValueError naming ``name``.  Of ``dtype`` and contiguous, else a
    ValueError, or with ``cast`` a cast and contiguous copy; with
    ``align16`` copied where it does not start on 16 bytes (a kernel that
    reads rows as 16-byte vectors)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if cast:
        t = t.to(dtype).contiguous()
    elif t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    elif not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if align16 and t.data_ptr() % 16:
        t = t.clone()
    return t


def seed_value(seed):
    """The host value of a seed given as an int or a one-element tensor
    (the plain versions' reading; a host read)."""
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


def seed_tensor(seed, device):
    """``seed`` as the kernels take it: a (1,) int32 tensor on ``device``.
    A tensor passes through (checked); an int becomes one by a copy from
    the host, which a CUDA graph capture cannot record."""
    if torch.is_tensor(seed):
        return operand(seed, "seed", (1,), torch.int32, device)
    s = int(seed) & 0xFFFFFFFF
    return torch.tensor([s - (1 << 32) if s >= 1 << 31 else s],
                        dtype=torch.int32, device=device)


def make_generator(rng, device):
    """A ``torch.Generator`` from an int seed (or a one-element seed
    tensor, read on the host), or ``rng`` itself."""
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_value(rng))
    return gen


def kernel_seed(rng, device):
    """The decoder kernels' prenet-dropout seed, a (1,) int32 tensor on
    ``device``: ``rng`` itself when it is one, else drawn from the
    generator (or from one seeded with the int) on the device, never
    read back, so a CUDA graph draws a fresh seed each replay."""
    if torch.is_tensor(rng):
        return seed_tensor(rng, device)
    gen = make_generator(rng, device)
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         device=gen.device).to(torch.int32)


def cached_pack(owner, slot, params, make, extra=()):
    """``make()``, kept on ``owner`` under ``slot`` and made again only
    when one of ``params`` changes (its storage or its version: an
    in-place update) or ``extra`` does."""
    key = (tuple((p.data_ptr(), p._version) for p in params), extra)
    packs = owner.__dict__.setdefault("_packs", {})
    hit = packs.get(slot)
    if hit is None or hit[0] != key:
        hit = packs[slot] = (key, make())
    return hit[1]
