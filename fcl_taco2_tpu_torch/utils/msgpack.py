"""A small msgpack encoder and decoder for flax's checkpoint layout.

The GPU host has neither ``msgpack`` nor ``flax``, so the port carries its
own codec of the subset ``flax.serialization.msgpack_serialize`` writes
and ``msgpack_restore`` reads (``fcl_taco2_tpu/train/checkpoint.py``):

- maps with string keys (written in sorted key order, as flax's tree
  traversal writes them), arrays (lists and tuples), strings, bin, ints,
  floats (64-bit; 32-bit read), booleans and nil;
- ext type 1, flax's ndarray: the payload is the msgpack of
  ``(shape, dtype name, C-order bytes)``.  ``bfloat16`` arrays come back
  as ``torch.bfloat16`` tensors (numpy has no such dtype), every other
  dtype as a numpy array; ``torch.Tensor`` leaves are written like numpy
  arrays;
- ext type 3, flax's numpy scalar: the same payload, read as a 0-d value;
- flax's chunked form of arrays over 2**30 bytes
  (``{"__msgpack_chunked_array__": True, "shape", "chunks"}``), in both
  directions.
"""

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

def _pack_int(out, v):
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= hi:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if v >= lo:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_len(out, n, fix_base, fix_max, codes):
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, hi in codes:
        if n <= hi:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_bin(out, b):
    _pack_len(out, len(b), None, 0, ((0xC4, ">B", 0xFF),
                                     (0xC5, ">H", 0xFFFF),
                                     (0xC6, ">I", 0xFFFFFFFF)))
    out += b


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += bytes([0xC7, n])
    elif n <= 0xFFFF:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += data


def _array_payload(arr):
    """flax ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = tuple(t.shape), "bfloat16"
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    else:
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    return serialize([list(shape), name, raw])


def _nbytes(x):
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x):
    """flax ``_chunk``: a flat array in pieces of at most 2**30 bytes."""
    flat = (x.detach().cpu().reshape(-1) if isinstance(x, torch.Tensor)
            else np.asarray(x).reshape(-1))
    itemsize = _nbytes(flat[:1]) if len(flat) else 1
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    chunks = [flat[i:i + size] for i in range(0, len(flat), size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out, x):
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, ((0xD9, ">B", 0xFF),
                                          (0xDA, ">H", 0xFFFF),
                                          (0xDB, ">I", 0xFFFFFFFF)))
        out += b
    elif isinstance(x, (bytes, bytearray)):
        _pack_bin(out, bytes(x))
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                          (0xDF, ">I", 0xFFFFFFFF)))
        for k in x:
            if not isinstance(k, str):
                raise TypeError(f"map keys must be strings, got {k!r}")
        for k in sorted(x):  # flax writes maps in sorted key order
            _pack(out, k)
            _pack(out, x[k])
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                          (0xDD, ">I", 0xFFFFFFFF)))
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(out, _chunk(x))
        else:
            _pack_ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    else:
        raise TypeError(f"cannot msgpack {type(x).__name__}")


def serialize(tree):
    """flax ``msgpack_serialize``: ``tree`` (see the module docstring) as
    msgpack bytes."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARR = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _array_from_payload(data):
    shape, name, raw = _unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        flat = np.frombuffer(bytes(raw), dtype=np.int16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(bytes(raw), dtype=np.dtype(name)).reshape(shape)


def _ext(code, data):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        a = _array_from_payload(data)
        return a[()] if isinstance(a, np.ndarray) else a.reshape(())
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unpack(r):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0x80 <= b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _STR:
        return bytes(r.take(r.unpack(_STR[b]))).decode("utf-8")
    if b in _BIN:
        return bytes(r.take(r.unpack(_BIN[b])))
    if b in _ARR:
        return [_unpack(r) for _ in range(r.unpack(_ARR[b]))]
    if b in _MAP:
        return _unpack_map(r, r.unpack(_MAP[b]))
    if b in _FIXEXT or b in _EXT:
        n = _FIXEXT[b] if b in _FIXEXT else r.unpack(_EXT[b])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _unpack_map(r, n):
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _unpackb(data):
    """Decode one msgpack object."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def restore(data):
    """flax ``msgpack_restore``: the tree, arrays unchunked."""
    return _unchunk(_unpackb(data))
