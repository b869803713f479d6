"""Pure-Python Kaldi ark/scp float-matrix writer and reader (the port's
copy of ``fcl_taco2_tpu/infer/ark.py``).

The reference writes decoded mels with kaldiio.WriteHelper('ark,scp:...')
(tts.py:652) so the external parallel-wavegan-decode CLI can
read them (inference_teacher.sh:20-23).  This writer emits the same binary
format (no kaldiio dependency): per record
    "<uttid> \\0B FM \\x04<rows:int32> \\x04<cols:int32> <row-major f32>"
plus an scp index line "<uttid> <arkpath>:<offset>".
"""

import struct

import numpy as np


class ArkScpWriter:
    def __init__(self, ark_path: str, scp_path: str):
        self.ark_path = ark_path
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write(self, uttid: str, mat: np.ndarray):
        mat = np.ascontiguousarray(mat, dtype=np.float32)
        if mat.ndim != 2:
            raise ValueError(f"expected a matrix, got shape {mat.shape}")
        self._ark.write(uttid.encode("utf-8") + b" ")
        offset = self._ark.tell()
        self._ark.write(b"\0B")
        self._ark.write(b"FM ")
        self._ark.write(b"\x04" + struct.pack("<i", mat.shape[0]))
        self._ark.write(b"\x04" + struct.pack("<i", mat.shape[1]))
        self._ark.write(mat.tobytes())
        self._scp.write(f"{uttid} {self.ark_path}:{offset}\n")

    def close(self):
        self._ark.close()
        self._scp.close()


def read_ark_matrix(path_with_offset: str) -> np.ndarray:
    """Read back one matrix from 'path:offset' (for tests / tooling)."""
    path, offset = path_with_offset.rsplit(":", 1)
    with open(path, "rb") as f:
        f.seek(int(offset))
        header = f.read(2)
        if header != b"\0B":
            raise ValueError("not a kaldi binary record")
        token = f.read(3)
        if token != b"FM ":
            raise ValueError(f"unsupported kaldi matrix type {token!r}")
        assert f.read(1) == b"\x04"
        rows = struct.unpack("<i", f.read(4))[0]
        assert f.read(1) == b"\x04"
        cols = struct.unpack("<i", f.read(4))[0]
        data = np.frombuffer(f.read(rows * cols * 4), np.float32)
        return data.reshape(rows, cols).copy()
