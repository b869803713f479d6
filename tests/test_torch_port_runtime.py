"""The port's single-card runtime pieces against the JAX package:
``data/transform.py`` (``--preprocess-conf``) bit-equal to JAX's for each
op and mode with the same seed, and its rejections (as
``tests/test_transform.py``); the native plan builder
(``csrc/fclrt.cpp`` through ``data/native.py``) bit-equal to the port's
numpy builders and to JAX's native builder, flat and classed, overflow
errors included; ``profile_dir`` writing a trace on the CPU;
``cost_analysis``; and ``_not_ported`` refusing only multi-device runs."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from fcl_taco2_tpu.data import transform as jtransform
from fcl_taco2_tpu_torch.data import transform as ptransform

from test_data_pipeline import write_corpus


def _need_cxx():
    """Skip (inside the test) where no C++ compiler is on PATH."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler on PATH")


def _stats(tmp_path, kind):
    rng = np.random.default_rng(1)
    mean = rng.normal(size=8).astype(np.float32)
    std = (np.abs(rng.normal(size=8)) + 0.5).astype(np.float32)
    if kind == "npy":
        path = tmp_path / "stats.npy"
        np.save(path, np.stack([mean, std]))
    else:
        path = tmp_path / "stats.npz"
        np.savez(path, mean=mean, std=std)
    return str(path)


CONFS = {
    "utterance_cmvn": [{"type": "utterance_cmvn"}],
    "utterance_cmvn_vars": [{"type": "utterance_cmvn", "norm_vars": True}],
    "global_cmvn_npy": [{"type": "global_cmvn", "stats": "npy"}],
    "cmvn_npz_means": [{"type": "cmvn", "stats": "npz", "norm_vars": False}],
    "gain": [{"type": "gain", "factor": 2.5}],
    "freq_mask": [{"type": "freq_mask", "F": 4, "n_mask": 2}],
    "time_mask": [{"type": "time_mask", "T": 10, "n_mask": 2}],
    "chain": [{"type": "utterance_cmvn", "norm_vars": True},
              {"type": "freq_mask", "F": 3},
              {"type": "time_mask", "T": 6}],
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CONFS))
def test_transformation_matches_jax(tmp_path, name, train):
    process = [dict(c) for c in CONFS[name]]
    for c in process:
        if "stats" in c:
            c["stats"] = _stats(tmp_path, c["stats"])
    conf = {"process": process}
    a = ptransform.Transformation(conf, seed=3)
    b = jtransform.Transformation(conf, seed=3)
    rng = np.random.default_rng(0)
    for _ in range(4):  # the stochastic ops' draws go on in step
        x = rng.normal(3.0, 2.0, (int(rng.integers(20, 50)), 8))
        np.testing.assert_array_equal(a(x, train=train), b(x, train=train))
    assert repr(a) == repr(b)


def test_transformation_reads_a_json_conf_file(tmp_path):
    path = tmp_path / "conf.json"
    path.write_text(json.dumps({"process": CONFS["chain"]}))
    x = np.random.default_rng(0).normal(size=(30, 8))
    np.testing.assert_array_equal(
        ptransform.Transformation(str(path), seed=1)(x, train=True),
        jtransform.Transformation(str(path), seed=1)(x, train=True))


def test_transformation_rejections(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown transform"):
        ptransform.Transformation({"process": [{"type": "nope"}]})
    with pytest.raises(ValueError, match="process"):
        ptransform.Transformation({"steps": []})
    bad = tmp_path / "bad.json"
    bad.write_text("not json {{")
    with pytest.raises(Exception):
        ptransform.Transformation(str(bad))

    def shorten(conf):
        return lambda x, train, rng: x[:-1]

    for mod in (ptransform, jtransform):
        monkeypatch.setitem(mod._REGISTRY, "shorten", shorten)
        t = mod.Transformation({"process": [{"type": "shorten"}]})
        with pytest.raises(ValueError, match="frame count"):
            t(np.zeros((5, 8), np.float32))


def test_converter_applies_transform_per_mode(tmp_path):
    """As ``tests/test_transform.py``: the converter's hook scales the mel
    and leaves the other features; train-only ops act in train mode."""
    from fcl_taco2_tpu_torch.data.converter import BatchConverter
    from fcl_taco2_tpu_torch.data.manifest import load_manifest
    utts = load_manifest(write_corpus(str(tmp_path)))
    plain = BatchConverter(max_dur=6, batch_size=2, odim=8)
    hooked = BatchConverter(max_dur=6, batch_size=2, odim=8,
                            transform=ptransform.Transformation(
                                {"process": [{"type": "gain",
                                              "factor": 2.0}]}))
    a, b = plain(utts[:2]), hooked(utts[:2])
    np.testing.assert_allclose(b.mel, 2.0 * a.mel, rtol=1e-6)
    np.testing.assert_array_equal(a.durations, b.durations)
    masked = BatchConverter(max_dur=6, batch_size=2, odim=8, cache={},
                            transform=ptransform.Transformation(
                                {"process": [{"type": "freq_mask",
                                              "F": 8}]}))
    np.testing.assert_array_equal(masked(utts[:2]).mel, a.mel)  # eval
    masked.transform_train = True
    assert any((masked(utts[:2]).mel != a.mel).any() for _ in range(5))


# --------------------------------------------------------------------------
# the native plan builder
# --------------------------------------------------------------------------

def _flat_cases():
    for seed in range(5):
        rng = np.random.default_rng(seed)
        dur = rng.integers(0, 8, (4, 9)).astype(np.int32)
        dur[:, 0] = np.maximum(dur[:, 0], 1)
        yield dur, dur.sum(1).astype(np.int32)


def test_native_flat_plan_matches_numpy_and_jax():
    _need_cxx()
    from fcl_taco2_tpu.data.native import build_plan_native as jax_native
    from fcl_taco2_tpu_torch.data.native import build_plan_native
    from fcl_taco2_tpu_torch.ops.regroup import build_plan
    for dur, olens in _flat_cases():
        Lmax = int(olens.max()) + 3
        got = build_plan_native(dur, olens, 7, 40, Lmax)
        for want in (build_plan(dur, olens, 7, 40, Lmax),
                     jax_native(dur, olens, 7, 40, Lmax)):
            assert got.n_segments == want.n_segments
            for f in got._fields:
                np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                              np.asarray(getattr(want, f)),
                                              err_msg=f)
                assert np.asarray(getattr(got, f)).dtype == \
                    np.asarray(getattr(want, f)).dtype, f


def test_native_classed_plan_matches_numpy_and_jax():
    _need_cxx()
    from fcl_taco2_tpu.data.native import \
        build_classed_plan_native as jax_native
    from fcl_taco2_tpu_torch.data.native import build_classed_plan_native
    from fcl_taco2_tpu_torch.ops.regroup import build_classed_plan
    for i, (dur, olens) in enumerate(_flat_cases()):
        Lmax = int(olens.max()) + 3
        # tight lower caps exercise the upward spill; the top class has
        # room for every segment
        caps = (2, 4, 36) if i == 0 else (8, 8, 36)
        got = build_classed_plan_native(dur, olens, (2, 4, 7), caps, Lmax)
        for want in (build_classed_plan(dur, olens, (2, 4, 7), caps, Lmax),
                     jax_native(dur, olens, (2, 4, 7), caps, Lmax)):
            assert got.n_segments == want.n_segments
            np.testing.assert_array_equal(got.utt_gather, want.utt_gather)
            np.testing.assert_array_equal(got.utt_mask, want.utt_mask)
            for cg, cw in zip(got.classes, want.classes):
                for f in cg._fields:
                    np.testing.assert_array_equal(
                        np.asarray(getattr(cg, f)),
                        np.asarray(getattr(cw, f)), err_msg=f)


def test_native_overflow_errors_match_jax():
    _need_cxx()
    from fcl_taco2_tpu.data import native as jn
    from fcl_taco2_tpu_torch.data import native as pn
    dur = np.full((1, 4), 3, np.int32)
    for mod in (pn, jn):
        with pytest.raises(ValueError, match="overflow"):
            mod.build_plan_native(dur, dur.sum(1), max_dur=3,
                                  n_seg_padded=2, max_olen=12)
        with pytest.raises(ValueError, match="top class cap"):
            mod.build_classed_plan_native(dur + 5, (dur + 5).sum(1), (2, 4),
                                          (4, 4), 64)
        with pytest.raises(ValueError, match="max_olen"):
            mod.build_classed_plan_native(dur, dur.sum(1), (2, 4), (4, 4), 8)
        with pytest.raises(ValueError, match="capacities"):
            mod.build_classed_plan_native(dur, dur.sum(1), (2, 4), (4, 1),
                                          12)


def test_converter_prefers_the_native_builder(tmp_path, monkeypatch):
    """The converter's plans come from the library (``_build`` holds it,
    never ``native/``), and equal the numpy builder's."""
    _need_cxx()
    from fcl_taco2_tpu_torch.data import native
    from fcl_taco2_tpu_torch.data.converter import BatchConverter
    from fcl_taco2_tpu_torch.data.manifest import load_manifest
    assert native.native_available()
    assert native.build().parent == native.BUILD_DIR
    utts = load_manifest(write_corpus(str(tmp_path)))
    conv = BatchConverter(max_dur=6, batch_size=4, odim=8)
    calls = []
    orig = native.build_plan_native
    monkeypatch.setattr(native, "build_plan_native",
                        lambda *a: calls.append(1) or orig(*a))
    got = conv(utts[:4])
    assert calls
    monkeypatch.setattr(native, "native_available", lambda: False)
    want = conv(utts[:4])
    for f in ("seg_utt", "seg_tok", "seg_start", "frame_mask", "position",
              "utt_gather", "utt_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_no_compiler_falls_back_once_and_says_so(monkeypatch, capsys):
    from fcl_taco2_tpu_torch.data import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert not native.native_available()
    assert not native.native_available()
    err = capsys.readouterr().err
    assert err.count("numpy plan builders") == 1
    with pytest.raises(RuntimeError, match="unavailable"):
        native.build_plan_native(np.ones((1, 2), np.int32), [2], 3, 4, 8)


# --------------------------------------------------------------------------
# the seam to the native code (utils/cuda_build.py)
# --------------------------------------------------------------------------

# every struct a kernel entry takes or fills, and its ctypes mirror
MIRRORS = [
    ("ar_decode.cu", "DecodeArgs", "ops.decoder_cuda"),
    ("ar_decode.cu", "LaunchInfo", "ops.decoder_cuda"),
    ("attn_decode.cu", "AttnArgs", "ops.attn_decode_cuda"),
    ("attn_decode.cu", "AttnLaunchInfo", "ops.attn_decode_cuda"),
    ("blstm.cu", "BlstmArgs", "ops.blstm_cuda"),
    ("blstm.cu", "BlstmLaunchInfo", "ops.blstm_cuda"),
    ("pwg_stream.cu", "PwgArgs", "vocoder.pwg_cuda"),
    ("pwg_stream.cu", "PwgLaunchInfo", "vocoder.pwg_cuda"),
    ("regroup.cu", "RegroupArgs", "ops.regroup_cuda"),
    ("regroup.cu", "RegroupLaunchInfo", "ops.regroup_cuda"),
]
_C_TYPE_WORDS = {"const", "unsigned", "long", "int", "float", "void", "*"}


def _csrc():
    from fcl_taco2_tpu_torch.utils.cuda_build import CSRC
    return CSRC


def _c_struct(text, name):
    """[(field, C type, array length or None)] of ``struct name`` in a C
    source: pointers as ``void*``, ``const`` dropped, array lengths
    through the file's ``#define``s."""
    import re
    defines = dict(re.findall(r"#define\s+(\w+)\s+(\d+)", text))
    body = re.search(r"struct %s \{(.*?)\};" % name, text, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        words = decl.replace("*", " * ").replace(",", " , ").split()
        if not words:
            continue
        n = next(i for i, w in enumerate(words)
                 if w not in _C_TYPE_WORDS and not w.endswith("_t"))
        kind = [w for w in words[:n] if w != "const"]
        ctype = "void*" if "*" in kind else " ".join(kind)
        for item in " ".join(words[n:]).split(","):
            m = re.fullmatch(r"\s*(\w+)\s*(?:\[\s*(\w+)\s*\])?\s*", item)
            length = m.group(2)
            fields.append((m.group(1), ctype, None if length is None
                           else int(defines.get(length, length))))
    return fields


def _py_struct(cls):
    import ctypes
    names = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_float: "float", ctypes.c_longlong: "long long",
             ctypes.c_uint: "unsigned int"}
    out = []
    for field, t in cls._fields_:
        if issubclass(t, ctypes.Array):
            out.append((field, names[t._type_], t._length_))
        else:
            out.append((field, names[t], None))
    return out


@pytest.mark.parametrize("source,struct,module", MIRRORS,
                         ids=[m[1] for m in MIRRORS])
def test_ctypes_mirror_matches_its_c_struct(source, struct, module):
    """Each ctypes mirror has its C struct's fields: names, C types and
    array lengths, in order (a mirror that disagrees corrupts memory on
    the card, silently)."""
    import importlib
    mod = importlib.import_module(f"fcl_taco2_tpu_torch.{module}")
    want = _c_struct((_csrc() / source).read_text(), struct)
    assert want and _py_struct(getattr(mod, struct)) == want


def test_every_kernel_struct_has_a_mirror():
    """``MIRRORS`` covers every ``*Args`` and launch-info struct under
    ``csrc/``, and each kernel wrapper's entry takes its pair."""
    import importlib
    import re
    found = {(f.name, m) for f in _csrc().glob("*.cu")
             for m in re.findall(r"struct (\w*(?:Args|LaunchInfo)) \{",
                                 f.read_text())}
    assert found == {(s, n) for s, n, _ in MIRRORS}
    for source, struct, module in MIRRORS:
        mod = importlib.import_module(f"fcl_taco2_tpu_torch.{module}")
        entries = [e for e in vars(mod).values()
                   if type(e).__name__ == "Entry" and e.info is not None]
        assert len(entries) == 1 and f"{entries[0].library}.cu" == source
        assert mod.last_launch is entries[0].last
        if struct.endswith("Args"):
            assert entries[0].params[0]._type_ is getattr(mod, struct)
        else:
            assert entries[0].info is getattr(mod, struct)


class _FakeStream:
    cuda_stream = 7


def test_entry_launch_types_calls_raises_and_counts(monkeypatch):
    """``Entry.launch``: typed once, the struct by reference, the stream
    after the arguments, the info cleared and filled, one count a launch;
    a nonzero code raises with the entry, the error and the context, and
    neither fills the info nor counts."""
    import ctypes
    from fcl_taco2_tpu_torch.ops.blstm_cuda import (BlstmArgs,
                                                    BlstmLaunchInfo)
    from fcl_taco2_tpu_torch.utils import cuda_build

    calls = []

    def fake(args, kind, stream, info):
        a = ctypes.cast(args, ctypes.POINTER(BlstmArgs)).contents
        calls.append((a.B, kind, stream.value))
        ctypes.cast(info, ctypes.POINTER(BlstmLaunchInfo)).contents.grid = 5
        return 0 if a.B > 0 else 700

    class Fn:  # a foreign function's typing attributes over ``fake``
        def __call__(self, *a):
            return fake(*a)

    class Lib:
        blstm_launch = Fn()

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _FakeStream)

    def wrapper():
        pass
    wrapper.launches = 0
    e = cuda_build.Entry.kernel("blstm", "blstm_launch", BlstmArgs,
                                BlstmLaunchInfo, kind=True)
    e.bind(Lib)
    assert Lib.blstm_launch.argtypes[-2:] == [ctypes.c_void_p,
                                              ctypes.POINTER(BlstmLaunchInfo)]
    e.last["stale"] = 1
    e.launch(BlstmArgs(B=3), 1, device="cuda:0", count=wrapper)
    assert calls == [(3, 1, 7)] and wrapper.launches == 1
    assert e.last["grid"] == 5 and "stale" not in e.last
    assert set(e.last) == {n for n, _ in BlstmLaunchInfo._fields_}
    with pytest.raises(RuntimeError, match=r"blstm_launch .*error 700 "
                                           r"\(B=0"):
        e.launch(BlstmArgs(B=0), 0, device="cuda:0", count=wrapper,
                 context="B=0")
    assert wrapper.launches == 1 and e.last["grid"] == 5


def test_operand_checks_and_casts():
    from fcl_taco2_tpu_torch.utils.cuda_build import operand
    cpu = torch.device("cpu")
    t = torch.zeros(4, 6)
    assert operand(t, "t", (4, 6), torch.float32, cpu) is t
    for shape, dtype, x, why in (
            ((4, 5), torch.float32, t, "shape"),
            ((4, 6), torch.bfloat16, t, "dtype"),
            ((6, 4), torch.float32, t.t(), "contiguous")):
        with pytest.raises(ValueError, match=why):
            operand(x, "t", shape, dtype, cpu)
    with pytest.raises(ValueError, match="is on"):
        operand(t, "t", (4, 6), torch.float32, torch.device("meta"))
    got = operand(t.t().to(torch.float64), "t", (6, 4), torch.float32, cpu,
                  cast=True, align16=True)
    assert got.dtype == torch.float32 and got.is_contiguous()
    odd = torch.zeros(9)[1:]  # 4 bytes past an aligned start
    assert operand(odd, "t", (8,), torch.float32, cpu,
                   align16=True).data_ptr() % 16 == 0


def test_cached_pack_is_made_again_only_when_a_parameter_changes():
    from fcl_taco2_tpu_torch.utils.cuda_build import cached_pack
    owner = torch.nn.Linear(3, 2)
    made = []

    def pack(tag):
        return cached_pack(owner, tag, owner.parameters(),
                           lambda: made.append(tag) or len(made),
                           extra=(tag,))
    assert pack("a") == pack("a") == 1 and pack("b") == 2
    with torch.no_grad():
        owner.weight.add_(1.0)  # in place: a new version
    assert pack("a") == 3 and pack("a") == 3 and made == ["a", "b", "a"]


def test_seeds_as_the_kernels_and_the_plain_versions_take_them():
    from fcl_taco2_tpu_torch.utils import cuda_build as CB
    cpu = torch.device("cpu")
    s = CB.seed_tensor(2 ** 32 - 5, cpu)
    assert s.dtype == torch.int32 and int(s) == -5
    assert CB.seed_tensor(s, cpu) is s and CB.seed_value(s) == -5
    with pytest.raises(ValueError, match="int32"):
        CB.seed_tensor(s.to(torch.int64), cpu)
    gen = CB.make_generator(3, cpu)
    assert CB.make_generator(gen, cpu) is gen
    a, b = CB.kernel_seed(3, cpu), CB.kernel_seed(CB.make_generator(3, cpu),
                                                  cpu)
    assert a.shape == (1,) and a.dtype == torch.int32 and torch.equal(a, b)
    assert CB.kernel_seed(s, cpu) is s


# --------------------------------------------------------------------------
# profiler, cost analysis, the refusals
# --------------------------------------------------------------------------

def _tiny_trainer(tmp_path, **kw):
    from fcl_taco2_tpu_torch.data.manifest import load_manifest
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
    from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer
    from helpers import tiny_config
    from torch_port_helpers import port_config
    train, valid = write_learnable_corpus(str(tmp_path), 8, 2)
    tcfg = TrainConfig(exp_dir=str(tmp_path / "exp"), batch_size=4,
                       plot_interval_epochs=0, **kw)
    return Trainer(Tacotron2SA(port_config(tiny_config(max_dur=6)),
                               device="cpu", seed=0), tcfg,
                   load_manifest(train), load_manifest(valid),
                   device="cpu")


def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path):
    from fcl_taco2_tpu_torch.train.profiler import TRACE_FILE
    prof = tmp_path / "prof"
    ts = _tiny_trainer(tmp_path, epochs=1, profile_dir=str(prof)).run()
    assert ts.step == 2
    with open(prof / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)


def test_cost_analysis_counts_flops():
    from fcl_taco2_tpu_torch.train.profiler import cost_analysis
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    got = cost_analysis(lambda x, y: x @ y, a, b)
    assert got == {"flops": 2.0 * 8 * 16 * 4, "bytes_accessed": -1.0}


def test_not_ported_refuses_only_multi_device():
    """Every knob is ported; multi-device runs need one process a device
    (``parallel/``), so a single process asked for several refuses with
    that cause, and a mesh of one is the single-process run."""
    from fcl_taco2_tpu_torch.parallel.mesh import mesh_for
    from fcl_taco2_tpu_torch.train.loop import TrainConfig
    for kw in (dict(n_devices=2), dict(n_slices=2)):
        t = TrainConfig(**kw)
        with pytest.raises(ValueError, match="one process a device"):
            mesh_for(t.n_devices, t.n_slices)
    knobs = dict(freeze_mods=("enc.",), enc_init="x", dec_init="y",
                 preprocess_conf="conf.json", profile_dir="prof",
                 device_cache="on", steps_per_dispatch=4, n_devices=1)
    t = TrainConfig(**knobs)
    mesh = mesh_for(t.n_devices, t.n_slices)
    assert (mesh.size, mesh.rank, mesh.distributed) == (1, 0, False)
    assert {f.name for f in dataclasses.fields(TrainConfig)} >= set(knobs)


def test_preprocess_conf_trains_and_streams(tmp_path, capsys):
    """``preprocess_conf`` reaches the converter (train mode for the
    epoch, eval mode for validation), and ``auto`` says why it streams."""
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"process": CONFS["chain"]}))
    trainer = _tiny_trainer(tmp_path, epochs=1, preprocess_conf=str(conf))
    assert trainer._dcache is None
    assert "preprocess_conf" in capsys.readouterr().out
    assert isinstance(trainer.converter.transform,
                      ptransform.Transformation)
    modes = []
    orig = trainer.converter.transform

    class Spy:
        def __call__(self, mel, train=False):
            modes.append(train)
            return orig(mel, train=train)

    trainer.converter.transform = Spy()
    ts = trainer.run()
    assert ts.step == 2 and True in modes and False in modes
    assert os.path.exists(tmp_path / "exp" / "snapshot.ep.1")
