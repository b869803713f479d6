"""The port's manifest loading across every reference filetype —
npy/npz/mat/vec/scp/hdf5/sound/sound.hdf5/pt (io_utils_fcl.py:392-501
parity) — plus eos append (:325-326) and speaker-embedding entries
(:330-336): ``tests/test_manifest_filetypes.py`` pointed at
``fcl_taco2_tpu_torch``, the same files and the same asserts."""

import json
import os

import numpy as np
import pytest

from fcl_taco2_tpu_torch.data.manifest import (SoundHDF5File,
                                               load_features, load_manifest,
                                               load_spemb)
from fcl_taco2_tpu_torch.infer.ark import ArkScpWriter


def test_mat_and_hdf5_filetypes(tmp_path):
    import h5py

    rng = np.random.default_rng(0)
    mel = rng.normal(size=(12, 8)).astype(np.float32)
    dur = np.array([[3.0], [4.0], [5.0]])
    f0 = rng.normal(size=(3, 1)).astype(np.float32)
    en = rng.normal(size=(3, 1)).astype(np.float32)

    ark = os.path.join(str(tmp_path), "mel.ark")
    scp = os.path.join(str(tmp_path), "mel.scp")
    with ArkScpWriter(ark, scp) as w:
        w.write("utt1", mel)
    with open(scp) as f:
        mel_ptr = f.read().split()[1]

    h5 = os.path.join(str(tmp_path), "feats.h5")
    with h5py.File(h5, "w") as f:
        f["utt1_f0"] = f0
    dur_npy = os.path.join(str(tmp_path), "dur.npy")
    en_npy = os.path.join(str(tmp_path), "en.npy")
    np.save(dur_npy, dur)
    np.save(en_npy, en)

    js = {"utts": {"utt1": {
        "input": [
            {"feat": mel_ptr, "filetype": "mat", "name": "input1",
             "shape": [12, 8]},
            {"feat": dur_npy, "filetype": "npy", "name": "input2",
             "shape": [3, 1]},
            {"feat": f"{h5}:utt1_f0", "filetype": "hdf5", "name": "input3",
             "shape": [3, 1]},
            {"feat": en_npy, "filetype": "npy", "name": "input4",
             "shape": [3, 1]},
        ],
        "output": [{"name": "target1", "shape": [3, 10],
                    "tokenid": "1 2 3"}],
        "utt2spk": "LJ"}}}
    path = os.path.join(str(tmp_path), "data.json")
    with open(path, "w") as f:
        json.dump(js, f)

    utts = load_manifest(path)
    m, d, p, e = load_features(utts[0])
    np.testing.assert_allclose(m, mel, atol=1e-6)
    np.testing.assert_array_equal(d, [3, 4, 5])
    np.testing.assert_allclose(p, f0)
    np.testing.assert_allclose(e, en)


def _manifest_for(tmp_path, entries, tokenid="1 2 3", vocab=10,
                  extra_inputs=()):
    js = {"utts": {"utt1": {
        "input": [
            {"feat": entries[i][0], "filetype": entries[i][1],
             "name": f"input{i+1}",
             "shape": [12, 8] if i == 0 else [3, 1]}
            for i in range(4)
        ] + list(extra_inputs),
        "output": [{"name": "target1", "shape": [3, vocab],
                    "tokenid": tokenid}],
        "utt2spk": "LJ"}}}
    path = os.path.join(str(tmp_path), "data.json")
    with open(path, "w") as f:
        json.dump(js, f)
    return path


def test_npz_scp_pt_filetypes(tmp_path):
    import torch

    rng = np.random.default_rng(1)
    mel = rng.normal(size=(12, 8)).astype(np.float32)
    dur = np.array([3, 4, 5], np.int32)
    f0 = rng.normal(size=(3, 1)).astype(np.float32)
    en = rng.normal(size=(3, 1)).astype(np.float32)

    npz = os.path.join(str(tmp_path), "feats.npz")
    np.savez(npz, utt1_mel=mel, utt1_f0=f0)
    ark = os.path.join(str(tmp_path), "en.ark")
    scp = os.path.join(str(tmp_path), "en.scp")
    with ArkScpWriter(ark, scp) as w:
        w.write("utt1", en)
    pt = os.path.join(str(tmp_path), "dur.pt")
    torch.save(torch.from_numpy(dur), pt)

    path = _manifest_for(tmp_path, [
        (f"{npz}:utt1_mel", "npz"),
        (pt, "pt"),
        (f"{npz}:utt1_f0", "npz"),
        (f"{scp}:utt1", "scp"),
    ])
    m, d, p, e = load_features(load_manifest(path)[0])
    np.testing.assert_allclose(m, mel, atol=1e-6)
    np.testing.assert_array_equal(d, dur)
    np.testing.assert_allclose(p, f0)
    np.testing.assert_allclose(e, en, atol=1e-6)


def test_sound_and_sound_hdf5_filetypes(tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(2)
    audio = rng.integers(-3000, 3000, 160).astype(np.int16)
    wav = os.path.join(str(tmp_path), "a.wav")
    wavfile.write(wav, 16000, audio)
    from fcl_taco2_tpu_torch.data.manifest import _load_feat
    got = _load_feat(wav, "sound")
    np.testing.assert_array_equal(got, audio)

    h5 = os.path.join(str(tmp_path), "a.wav.h5")
    f = SoundHDF5File(h5, "w")
    f["utt1"] = (audio, 16000)
    f.close()
    got2 = _load_feat(f"{h5}:utt1", "sound.hdf5")
    np.testing.assert_array_equal(got2, audio)


def test_unknown_filetype_rejected(tmp_path):
    dummy = os.path.join(str(tmp_path), "x.npy")
    np.save(dummy, np.zeros((3, 1)))
    path = _manifest_for(tmp_path, [(dummy, "flac.ogg")] + [(dummy,
                                                             "npy")] * 3)
    with pytest.raises(NotImplementedError):
        load_manifest(path)


def test_pad_eos_appends_last_vocab_id(tmp_path):
    rng = np.random.default_rng(3)
    mel = rng.normal(size=(12, 8)).astype(np.float32)
    paths = {}
    for name, arr in [("mel", mel), ("dur", np.array([[3], [4], [5]])),
                      ("f0", rng.normal(size=(3, 1)).astype(np.float32)),
                      ("en", rng.normal(size=(3, 1)).astype(np.float32))]:
        p = os.path.join(str(tmp_path), f"{name}.npy")
        np.save(p, arr)
        paths[name] = p
    path = _manifest_for(tmp_path, [(paths["mel"], "npy"),
                                    (paths["dur"], "npy"),
                                    (paths["f0"], "npy"),
                                    (paths["en"], "npy")], vocab=10)
    utt = load_manifest(path, pad_eos=True)[0]
    assert utt.n_tokens == 4
    assert utt.tokenids[-1] == 9  # vocab_size - 1 (io_utils_fcl.py:166)
    m, d, p, e = load_features(utt)
    assert len(d) == 4 and d[-1] == 0  # eos maps to zero frames
    assert p.shape == (4, 1) and e.shape == (4, 1)
    # default: no eos
    assert load_manifest(path)[0].n_tokens == 3


def test_spembs_reach_the_batch(tmp_path):
    """spembs flow manifest -> converter -> Batch (round-1 gap: parsed but
    never loaded)."""
    from fcl_taco2_tpu_torch.data.converter import BatchConverter

    rng = np.random.default_rng(4)
    mel = rng.normal(size=(12, 8)).astype(np.float32)
    spemb = rng.normal(size=(16,)).astype(np.float32)
    paths = {}
    for name, arr in [("mel", mel), ("dur", np.array([[3], [4], [5]])),
                      ("f0", rng.normal(size=(3, 1)).astype(np.float32)),
                      ("en", rng.normal(size=(3, 1)).astype(np.float32)),
                      ("spemb", spemb)]:
        p = os.path.join(str(tmp_path), f"{name}.npy")
        np.save(p, arr)
        paths[name] = p
    path = _manifest_for(
        tmp_path, [(paths["mel"], "npy"), (paths["dur"], "npy"),
                   (paths["f0"], "npy"), (paths["en"], "npy")],
        extra_inputs=[{"feat": paths["spemb"], "filetype": "npy",
                       "name": "spembs", "shape": [16]}])
    utts = load_manifest(path)
    np.testing.assert_allclose(load_spemb(utts[0]), spemb)

    conv = BatchConverter(max_dur=6, batch_size=2, odim=8)
    batch = conv(utts)
    assert batch.spembs is not None and batch.spembs.shape == (2, 16)
    np.testing.assert_allclose(batch.spembs[0], spemb)
    np.testing.assert_array_equal(batch.spembs[1], 0.0)  # pad utterance
