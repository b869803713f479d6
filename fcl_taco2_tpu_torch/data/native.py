"""ctypes bindings of the port's native plan builder (``csrc/fclrt.cpp``;
port of ``fcl_taco2_tpu/data/native.py``).

The library is compiled with the C++ compiler at first use into
``fcl_taco2_tpu_torch/_build/libfclrt-<hash>.so`` by
``utils/cuda_build.py``.  ``build_plan_native`` and
``build_classed_plan_native`` are drop-ins for ``ops/regroup.py``'s numpy
builders, bit-equal to them.  Where no C++ compiler is found,
``native_available()`` is False and the converter uses the numpy builders;
that is said once on stderr.  A compiler that fails on the source raises.
"""

import ctypes
import sys
import threading

import numpy as np

from fcl_taco2_tpu_torch.ops.regroup import (ClassedPlan, ClassPlan,
                                             RegroupPlan)
from fcl_taco2_tpu_torch.utils import cuda_build
from fcl_taco2_tpu_torch.utils.cuda_build import cxx_path as compiler

SOURCE = "fclrt.cpp"
BUILD_DIR = cuda_build.BUILD_DIR  # where build() puts the library

_lock = threading.Lock()
_lib = None
_tried = False


def build():
    """Compile ``csrc/fclrt.cpp`` unless an up-to-date library exists;
    returns its path."""
    return cuda_build.build(SOURCE)[0]


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if compiler() is None:
            print("native plan builder: no C++ compiler (g++/c++) on PATH; "
                  "the batch converter uses the numpy plan builders "
                  "(bit-equal, slower)", file=sys.stderr, flush=True)
            return None
        lib = cuda_build.load_library(SOURCE)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.fclrt_build_plan.restype = ctypes.c_int32
        lib.fclrt_build_plan.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, u8p, f32p, i32p, u8p,
        ]
        lib.fclrt_build_classed_plan.restype = ctypes.c_int32
        lib.fclrt_build_classed_plan.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, u8p, u8p, f32p, i32p, u8p,
        ]
        _lib = lib
        return _lib


def native_available():
    """True when the library is built and loaded (building it at the first
    call)."""
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native plan builder is unavailable: no C++ "
                           "compiler")
    return lib


def build_plan_native(durations, olens, max_dur, n_seg_padded, max_olen):
    """Native ``RegroupPlan`` builder; the contract of
    ``ops/regroup.build_plan``."""
    lib = _lib_or_raise()
    durations = np.ascontiguousarray(durations, np.int32)
    B, Tmax = durations.shape
    P, D = n_seg_padded, max_dur
    seg_utt = np.empty(P, np.int32)
    seg_tok = np.empty(P, np.int32)
    seg_start = np.empty(P, np.int32)
    seg_dur = np.empty(P, np.int32)
    frame_mask = np.empty((P, D), np.uint8)
    position = np.empty((P, D), np.float32)
    utt_gather = np.empty((B, max_olen), np.int32)
    utt_mask = np.empty((B, max_olen), np.uint8)
    n = lib.fclrt_build_plan(durations, B, Tmax, D, P, max_olen,
                             seg_utt, seg_tok, seg_start, seg_dur,
                             frame_mask.reshape(-1), position.reshape(-1),
                             utt_gather.reshape(-1), utt_mask.reshape(-1))
    if n < 0:
        raise ValueError(
            f"plan overflow: P={P}, max_dur={D}, max_olen={max_olen}")
    seg_mask = np.zeros(P, bool)
    seg_mask[:n] = True
    return RegroupPlan(seg_utt, seg_tok, seg_start, seg_dur, seg_mask,
                       frame_mask.astype(bool), position, utt_gather,
                       utt_mask.astype(bool), int(n))


def build_classed_plan_native(durations, olens, class_durs, class_caps,
                              max_olen):
    """Native ``ClassedPlan`` builder; the contract of
    ``ops/regroup.build_classed_plan``."""
    lib = _lib_or_raise()
    durations = np.ascontiguousarray(durations, np.int32)
    olens = np.ascontiguousarray(olens, np.int32)
    B, Tmax = durations.shape
    class_durs = tuple(int(d) for d in class_durs)
    class_caps = tuple(int(c) for c in class_caps)
    if list(class_durs) != sorted(set(class_durs)):
        raise ValueError(f"class_durs must be strictly ascending, got "
                         f"{class_durs}")
    if len(class_caps) != len(class_durs):
        raise ValueError("class_caps/class_durs length mismatch")
    durs_arr = np.asarray(class_durs, np.int32)
    caps_arr = np.asarray(class_caps, np.int32)
    n_classes = len(class_durs)
    rows = int(caps_arr.sum())
    cells = int((caps_arr.astype(np.int64) * durs_arr).sum())
    seg_utt = np.empty(rows, np.int32)
    seg_tok = np.empty(rows, np.int32)
    seg_start = np.empty(rows, np.int32)
    seg_dur = np.empty(rows, np.int32)
    seg_mask = np.empty(rows, np.uint8)
    frame_mask = np.empty(cells, np.uint8)
    position = np.empty(cells, np.float32)
    utt_gather = np.empty((B, max_olen), np.int32)
    utt_mask = np.empty((B, max_olen), np.uint8)
    n = lib.fclrt_build_classed_plan(
        durations, B, Tmax, olens, durs_arr, caps_arr, n_classes,
        max_olen, seg_utt, seg_tok, seg_start, seg_dur, seg_mask,
        frame_mask, position, utt_gather.reshape(-1),
        utt_mask.reshape(-1))
    if n == -2:
        raise ValueError(
            f"duration exceeds top class cap {class_durs[-1]}")
    if n == -3:
        raise ValueError(
            f"utterance frames exceed max_olen={max_olen}")
    if n < 0:
        raise ValueError(
            f"segments overflow the duration-class capacities "
            f"{class_caps}; enlarge the caps (converter fit_corpus "
            "derives safe ones)")
    classes = []
    r = c = 0
    for i in range(n_classes):
        P_c, D_c = class_caps[i], class_durs[i]
        classes.append(ClassPlan(
            D_c, seg_utt[r:r + P_c], seg_tok[r:r + P_c],
            seg_start[r:r + P_c], seg_dur[r:r + P_c],
            seg_mask[r:r + P_c].astype(bool),
            frame_mask[c:c + P_c * D_c].reshape(P_c, D_c).astype(bool),
            position[c:c + P_c * D_c].reshape(P_c, D_c)))
        r += P_c
        c += P_c * D_c
    return ClassedPlan(tuple(classes), utt_gather,
                       utt_mask.astype(bool), int(n))
