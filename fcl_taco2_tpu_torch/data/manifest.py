"""Corpus manifest (the port's copy of ``fcl_taco2_tpu/data/manifest.py``):
espnet-style data.json, schema-compatible with the reference's preprocess
output (preprocess.py:199-241) so reference-preprocessed corpora load
unchanged.  ``h5py`` is imported only inside the hdf5 branches.

Per utterance the json carries:
    input[0] mel      {'feat': <npy>, 'filetype': 'npy', 'shape': [L, odim]}
    input[1] duration {'feat': <npy>, 'shape': [T, 1]}
    input[2] f0       {'feat': <npy>, 'shape': [T, 1]}
    input[3] energy   {'feat': <npy>, 'shape': [T, 1]}
    output[0] text    {'tokenid': '1 5 2 ...', 'shape': [T, V]}

The loader below is the TTS io path of the reference's
LoadInputsAndTargets(mode='tts', use_second_target + f0/energy unpack,
io_utils_fcl.py:297-390).  Supported filetypes (io_utils_fcl.py:392-501):
'npy', 'npz' ('path:key'), 'mat'/'vec' (kaldi binary ark pointers
'path:offset', read with our pure-python reader), 'scp' ('path:key'),
'hdf5' ('path:key'), 'sound' (wav), 'sound.hdf5' ('path:key', wav-encoded
datasets, see SoundHDF5File), and 'pt' (torch tensors).  Optional eos
append (io_utils_fcl.py:325-326, eos id = vocab_size - 1 from the output
shape, :166) and 'spembs' entries (xvector manifests) are supported.
"""

import functools
import io
import json
from typing import Dict, List, NamedTuple

import numpy as np
import torch


class Utterance(NamedTuple):
    uttid: str
    tokenids: np.ndarray      # (T,) int32 (incl. appended eos if pad_eos)
    n_tokens: int
    n_frames: int
    mel_path: str
    dur_path: str
    f0_path: str
    energy_path: str
    filetypes: tuple = ("npy", "npy", "npy", "npy")
    spemb_path: str = ""      # optional speaker-embedding pointer
    spemb_filetype: str = "npy"
    eos_appended: bool = False  # tokenids carries a trailing eos token


class SoundHDF5File:
    """Audio collections in one HDF5 file (io_utils_fcl.py:501-581):
    each dataset holds an ENCODED audio byte blob; __getitem__ decodes to
    (array, rate).

    The reference encodes via soundfile (flac by default); soundfile is not
    available here, so this implementation reads/writes WAV blobs with
    scipy (format='wav').  Reading a flac-encoded reference file raises a
    clear error instead of mis-decoding.
    """

    def __init__(self, filepath, mode="r", dtype="int16"):
        import h5py

        self.filepath = filepath
        self.dtype = dtype
        self.file = h5py.File(filepath, mode)

    def __setitem__(self, name, data):
        from scipy.io import wavfile

        array, rate = data
        buf = io.BytesIO()
        wavfile.write(buf, rate, np.asarray(array))
        self.file.create_dataset(name, data=np.void(buf.getvalue()))

    def __getitem__(self, key):
        from scipy.io import wavfile

        blob = self.file[key][()].tobytes()
        if blob[:4] != b"RIFF":
            raise NotImplementedError(
                f"{self.filepath}:{key} is not WAV-encoded (probably flac "
                "from the reference's soundfile writer); re-encode as wav "
                "or convert the corpus with cli/fcl_preprocess.py")
        rate, array = wavfile.read(io.BytesIO(blob))
        return array.astype(self.dtype), rate

    def keys(self):
        return self.file.keys()

    def __contains__(self, item):
        return item in self.file

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.file.close()

    def close(self):
        self.file.close()


SUPPORTED_FILETYPES = ("npy", "npz", "mat", "vec", "scp", "hdf5", "sound",
                       "sound.hdf5", "pt")


@functools.lru_cache(maxsize=8)
def _scp_index(path):
    """Parse a kaldi scp text file into {key: ark_pointer}."""
    index = {}
    with open(path) as f:
        for line in f:
            key, pointer = line.strip().split(None, 1)
            index[key] = pointer
    return index


def _load_feat(path, filetype):
    """Read one feature by filetype (io_utils_fcl.py:392-501 analogue)."""
    if filetype == "npy":
        return np.load(path)
    if filetype == "npz":  # 'file:key'
        fname, key = path.rsplit(":", 1)
        with np.load(fname) as z:
            return z[key]
    if filetype in ("mat", "vec"):  # kaldi binary ark pointer 'file:offset'
        from fcl_taco2_tpu_torch.infer.ark import read_ark_matrix
        return read_ark_matrix(path)
    if filetype == "scp":  # 'file.scp:key' -> ark pointer lookup
        from fcl_taco2_tpu_torch.infer.ark import read_ark_matrix
        fname, key = path.rsplit(":", 1)
        return read_ark_matrix(_scp_index(fname)[key])
    if filetype == "hdf5":  # 'file:key'
        import h5py
        fname, key = path.rsplit(":", 1)
        with h5py.File(fname, "r") as f:
            return f[key][()]
    if filetype == "sound":  # raw audio file, PCM16 (io_utils_fcl.py:431-443)
        from scipy.io import wavfile
        _, array = wavfile.read(path)
        return array.astype(np.int16)
    if filetype == "sound.hdf5":  # 'file:key' (io_utils_fcl.py:418-430)
        fname, key = path.rsplit(":", 1)
        with SoundHDF5File(fname, "r", dtype="int16") as f:
            array, _ = f[key]
        return array
    if filetype == "pt":  # torch tensor file (io_utils_fcl.py:465-473)
        return torch.load(path, map_location="cpu",
                          weights_only=True).numpy()
    raise NotImplementedError(f"filetype {filetype!r} is not supported "
                              f"(supported: {SUPPORTED_FILETYPES})")


def load_manifest(json_path: str, pad_eos: bool = False) -> List[Utterance]:
    """Parse a data.json.  ``pad_eos`` appends eos (= vocab_size - 1, the
    output shape's last id, io_utils_fcl.py:166, 325-326) to each token
    sequence; the eos token gets a zero duration so it maps to no frames
    (zero-duration segments are dropped by the regroup, matching the
    reference's zero-length phoneme handling)."""
    with open(json_path) as f:
        js = json.load(f)["utts"]
    utts = []
    for uttid in sorted(js.keys()):
        entry = js[uttid]
        inputs = {i["name"]: i for i in entry["input"]}
        output = entry["output"][0]
        names = ("input1", "input2", "input3", "input4")
        filetypes = tuple(inputs[n].get("filetype", "npy") for n in names)
        for ft in filetypes:
            if ft not in SUPPORTED_FILETYPES:
                raise NotImplementedError(
                    f"filetype {ft!r} for {uttid}: supported filetypes are "
                    f"{SUPPORTED_FILETYPES}")
        tokenids = np.asarray([int(t) for t in output["tokenid"].split()],
                              np.int32)
        if pad_eos:
            eos = int(output["shape"][1]) - 1
            tokenids = np.append(tokenids, np.int32(eos))
        spemb = inputs.get("spembs", {})
        utts.append(Utterance(
            uttid=uttid,
            tokenids=tokenids,
            n_tokens=len(tokenids),
            n_frames=int(inputs["input1"]["shape"][0]),
            mel_path=inputs["input1"]["feat"],
            dur_path=inputs["input2"]["feat"],
            f0_path=inputs["input3"]["feat"],
            energy_path=inputs["input4"]["feat"],
            filetypes=filetypes,
            spemb_path=spemb.get("feat", ""),
            spemb_filetype=spemb.get("filetype", "npy"),
            eos_appended=pad_eos,
        ))
    return utts


def load_features(utt: Utterance):
    """Read one utterance's features from disk (host side, worker thread)."""
    ft = utt.filetypes
    mel = _load_feat(utt.mel_path, ft[0]).astype(np.float32)  # (L, odim)
    dur = _load_feat(utt.dur_path, ft[1]).reshape(-1).astype(np.int32)
    f0 = _load_feat(utt.f0_path, ft[2]).reshape(-1, 1).astype(np.float32)
    energy = _load_feat(utt.energy_path,
                        ft[3]).reshape(-1, 1).astype(np.float32)
    if utt.eos_appended:
        # per-token tracks gain a zero entry for the appended eos token
        dur = np.append(dur, np.int32(0))
        f0 = np.concatenate([f0, np.zeros((1, 1), np.float32)])
        energy = np.concatenate([energy, np.zeros((1, 1), np.float32)])
    if len(dur) != utt.n_tokens:
        raise ValueError(
            f"{utt.uttid}: {len(dur)} durations vs {utt.n_tokens} tokens")
    return mel, dur, f0, energy


def load_durations(utt: Utterance):
    """Read ONLY the utterance's duration vector (cheap: durations are a
    tiny per-utterance file) — used by the converter's duration-class
    capacity fit without pulling the mels."""
    dur = _load_feat(utt.dur_path, utt.filetypes[1]).reshape(-1)
    dur = dur.astype(np.int32)
    if utt.eos_appended:
        dur = np.append(dur, np.int32(0))
    return dur


def load_spemb(utt: Utterance):
    """Read the utterance's speaker-embedding vector (io_utils_fcl.py:
    330-336, 355-361), or None when the manifest has no spembs entry."""
    if not utt.spemb_path:
        return None
    vec = _load_feat(utt.spemb_path, utt.spemb_filetype)
    return np.asarray(vec, np.float32).reshape(-1)


def load_vocab(phn2idx_path: str) -> Dict[str, int]:
    """phn2idx.json written by preprocessing (PAD=0,
    preprocess.py:277-291)."""
    with open(phn2idx_path) as f:
        raw = json.load(f)
    return {k: int(v) for k, v in raw.items()}
