"""The port's ground rules: no JAX inside it, the card by default, the
plain version only for CPU tensors, and an unbiased plain dropout."""

import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# the GPU host has no JAX, flax, optax or msgpack
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "fcl_taco2_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    """The package, ``chip_smoke.py`` and the port's scripts
    (``scripts/torch_*.py``) import neither JAX nor the JAX package; the
    scripts import neither the JAX CLIs (``cli/``) nor a JAX script."""
    files = sorted((REPO / "fcl_taco2_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(files) > 10 and len(scripts) >= 21
    jax_scripts = {f.stem for f in (REPO / "scripts").glob("*.py")
                   if not f.stem.startswith("torch_")}
    bad = [(f.relative_to(REPO), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    bad += [(f.relative_to(REPO), m) for f in scripts
            for m in _imported_roots(f)
            if m in FORBIDDEN | jax_scripts | {"cli"}]
    assert not bad, bad


KERNEL_SIDE = sorted((REPO / "fcl_taco2_tpu_torch" / "ops").glob("*.py")) \
    + [REPO / "fcl_taco2_tpu_torch" / "vocoder" / "pwg_cuda.py"]


@pytest.mark.parametrize("path", KERNEL_SIDE, ids=lambda p: p.name)
def test_kernel_side_imports_no_model(path):
    """The ops and the kernel wrappers sit below the models: no module
    under ``ops/``, nor ``vocoder/pwg_cuda.py``, imports
    ``fcl_taco2_tpu_torch.models`` (at module level or in a function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module] + [f"{node.module}.{a.name}"
                                    for a in node.names]
        else:
            continue
        bad += [m for m in mods if m == "fcl_taco2_tpu_torch.models"
                or m.startswith("fcl_taco2_tpu_torch.models.")]
    assert not bad, (path.name, bad)


def test_port_shell_scripts_name_no_jax_path():
    """The port's shell scripts (``scripts/torch_*.sh``) run only the
    port: every ``python -m`` names a module of ``fcl_taco2_tpu_torch``,
    and nothing names JAX, the JAX package or its CLI shims (``cli/``)."""
    import re
    shells = sorted((REPO / "scripts").glob("torch_*.sh"))
    assert {"torch_teacher_model_training.sh",
            "torch_student_model_training.sh",
            "torch_inference.sh"} <= {f.name for f in shells}
    bad = []
    for f in shells:
        text = f.read_text()
        bad += [(f.name, m) for m in re.findall(r"python3?\s+-m\s+(\S+)",
                                                text)
                if not m.startswith("fcl_taco2_tpu_torch.")]
        for pat in (r"\bjax\b", r"fcl_taco2_tpu(?!_torch)", r"\bcli/fcl_"):
            bad += [(f.name, x) for x in re.findall(pat, text)]
    assert not bad, bad


def test_entry_points_default_to_the_card(monkeypatch):
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from helpers import tiny_config
    from torch_port_helpers import port_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        Tacotron2SA(cfg)
    model = Tacotron2SA(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Synthesizer(model)


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from fcl_taco2_tpu_torch.cli.fcl_train import main
    from fcl_taco2_tpu_torch.data.manifest import load_manifest
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer
    from helpers import tiny_config
    from torch_port_helpers import port_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, valid = write_learnable_corpus(str(tmp_path), 4, 2)
    utts = load_manifest(train)
    model = Tacotron2SA(port_config(tiny_config()), device="cpu")
    tcfg = TrainConfig(exp_dir=str(tmp_path / "exp"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, tcfg, utts, utts)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--train-json", train, "--valid-json", valid,
              "--outdir", str(tmp_path / "cli")])
    assert next(model.parameters()).device.type == "cpu"


def test_cpu_decode_runs_the_plain_version(monkeypatch):
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    from fcl_taco2_tpu_torch.models.decoder import Decoder
    from helpers import tiny_config
    from torch_port_helpers import port_config

    def no_launch(**_):
        raise AssertionError("a CPU tensor reached the CUDA launch")

    monkeypatch.setattr(K, "_launch", no_launch)
    cfg = port_config(tiny_config(dunits=256, max_dur=5))
    dp = Decoder(cfg, device="cpu").jax_layout()
    gen = torch.Generator().manual_seed(0)
    enc = torch.randn(6, cfg.dec_idim, generator=gen)
    pos = torch.rand(6, 5, generator=gen)
    before = (K.fused_ar_decode.launches, K.fused_ar_decode_hbm.launches)
    with torch.no_grad():
        for fn, plain in ((K.fused_ar_decode, K.fused_ar_decode_plain),
                          (K.fused_ar_decode_hbm,
                           K.fused_ar_decode_hbm_plain)):
            got = fn(dp, enc, pos, 3, dropout=0.5)
            want = plain(dp, enc, pos, 3, dropout=0.5)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (K.fused_ar_decode.launches,
            K.fused_ar_decode_hbm.launches) == before


def test_plain_prenet_dropout_keep_rate():
    from fcl_taco2_tpu_torch.models.components import prenet_dropout

    x = torch.ones(1024, 1024)
    for rate in (0.1, 0.5, 0.9):
        m = prenet_dropout(x, rate, torch.Generator().manual_seed(0))
        keep = (m > 0).float().mean().item()
        assert abs(keep - (1 - rate)) < 5e-3, (rate, keep)
        torch.testing.assert_close(m[m > 0],
                                   torch.full_like(m[m > 0], 1 / (1 - rate)))


def _small_pwg_config():
    from fcl_taco2_tpu_torch.vocoder.pwg import PWGConfig
    return PWGConfig(layers=4, stacks=2, residual_channels=8,
                     gate_channels=16, skip_channels=8, aux_channels=8,
                     upsample_scales=(2, 2))


def test_vocoder_entry_points_default_to_the_card(monkeypatch):
    from fcl_taco2_tpu_torch.infer import StreamTTS, TTSPipeline
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN
    from fcl_taco2_tpu_torch.vocoder.pwg_cuda import pwg_stream_state
    from helpers import tiny_config
    from torch_port_helpers import port_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = _small_pwg_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        ParallelWaveGAN(pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pwg_stream_state(pcfg)
    pwg = ParallelWaveGAN(pcfg, device="cpu")
    model = Tacotron2SA(port_config(tiny_config()), device="cpu")
    for cls in (TTSPipeline, StreamTTS):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(model, pwg)


def test_cpu_vocoder_runs_the_plain_version(monkeypatch):
    from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN

    def no_launch(*_, **__):
        raise AssertionError("a CPU tensor reached the CUDA launch")

    monkeypatch.setattr(PC, "_launch", no_launch)
    cfg = _small_pwg_config()
    pwg = ParallelWaveGAN(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    mel = torch.randn(1, 10, 8, generator=g)
    noise = torch.randn(1, 40, generator=g)
    before = (PC.pwg_generate_streaming.launches, PC.pwg_stream_step.launches)
    torch.testing.assert_close(
        PC.pwg_generate_streaming(pwg, cfg, mel, noise, tile=8),
        PC.pwg_generate_streaming_plain(pwg, cfg, mel, noise, tile=8),
        rtol=0, atol=0)
    packed = PC.pack_pwg_weights(pwg, cfg)
    state = PC.pwg_stream_state(cfg, 1, device="cpu")
    aux, nz = torch.randn(1, 16, 8, generator=g), torch.randn(1, 16,
                                                              generator=g)
    got, _ = PC.pwg_stream_step(packed, cfg, state, aux, nz, 0, 40, tile=8)
    want, _ = PC.pwg_stream_step_plain(packed, cfg, state, aux, nz, 0, 40,
                                       tile=8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (PC.pwg_generate_streaming.launches,
            PC.pwg_stream_step.launches) == before


def test_serving_clis_and_kd_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, ``fcl_synth``, ``fcl_vocode``, ``fcl_tts`` (batch
    and ``--stream``), ``fcl_train --perform-KD True``, ``KDStudent`` and
    ``KDTrainer`` raise unless the CPU is asked for; with ``--device cpu``
    each CLI runs (``fcl_vocode`` with PWG v1, the published vocoder)."""
    import json
    import os

    import numpy as np
    from fcl_taco2_tpu_torch.cli import fcl_synth, fcl_train, fcl_tts
    from fcl_taco2_tpu_torch.cli import fcl_vocode
    from fcl_taco2_tpu_torch.data.manifest import load_manifest
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    from fcl_taco2_tpu_torch.infer.ark import ArkScpWriter
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.train import checkpoint as ckpt
    from fcl_taco2_tpu_torch.train.distill import KDTrainer
    from fcl_taco2_tpu_torch.train.loop import TrainConfig
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from helpers import tiny_config
    from torch_port_helpers import port_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, valid = write_learnable_corpus(str(tmp_path), 2, 2)
    cfg = port_config(tiny_config())
    model = Tacotron2SA(cfg, device="cpu")
    exp = str(tmp_path / "exp")
    ckpt.save_model_json(exp, cfg)
    path = os.path.join(exp, "model.loss.best")
    ckpt.save_checkpoint(path, TrainState(model, build_optimizer().init(
        list(model.parameters())), 0), 1)
    scp = str(tmp_path / "feats.scp")
    with ArkScpWriter(str(tmp_path / "feats.ark"), scp) as w:
        w.write("utt", np.random.default_rng(0).normal(
            size=(9, 80)).astype(np.float32))
    pwg_conf = str(tmp_path / "pwg.json")
    with open(pwg_conf, "w") as f:
        json.dump({"layers": 2, "stacks": 1, "residual_channels": 4,
                   "gate_channels": 8, "skip_channels": 4,
                   "upsample_scales": [2]}, f)
    runs = {
        "synth": (fcl_synth.main, ["--model", path, "--json", valid,
                                   "--out", str(tmp_path / "dec")]),
        "vocode": (fcl_vocode.main, ["--feats-scp", scp,
                                     "--outdir", str(tmp_path / "wav")]),
        "tts": (fcl_tts.main, ["--model", path, "--json", valid,
                               "--outdir", str(tmp_path / "tts"),
                               "--pwg-config", pwg_conf]),
        "stream": (fcl_tts.main, ["--model", path, "--json", valid,
                                  "--outdir", str(tmp_path / "stream"),
                                  "--pwg-config", pwg_conf, "--stream"]),
    }
    for name, (fn, argv) in runs.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(argv)
        fn(argv + ["--device", "cpu"])
    assert os.path.exists(str(tmp_path / "dec" / "feats.ark"))
    assert os.listdir(str(tmp_path / "wav")) == ["utt.wav"]
    assert len(os.listdir(str(tmp_path / "stream"))) == 2
    with pytest.raises(RuntimeError, match="CUDA"):
        fcl_train.main(["--train-json", train, "--valid-json", valid,
                        "--outdir", str(tmp_path / "kd"), "--perform-KD",
                        "True", "--teacher-checkpoint", path])
    with pytest.raises(RuntimeError, match="CUDA"):
        KDStudent(cfg, cfg)
    kd = KDStudent(cfg, cfg, device="cpu")
    utts = load_manifest(train)
    with pytest.raises(RuntimeError, match="CUDA"):
        KDTrainer(kd, TrainConfig(exp_dir=str(tmp_path / "kd2")), utts,
                  utts, teacher_checkpoint=path)
    assert next(kd.student.parameters()).device.type == "cpu"


def test_runtime_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, ``DeviceBatchCache``, a chained ``Trainer`` and
    ``fcl_train --enc-init`` raise the no-device error; with
    ``device="cpu"`` (``--device cpu``) each runs."""
    import os

    from fcl_taco2_tpu_torch.cli.fcl_train import main
    from fcl_taco2_tpu_torch.data.converter import BatchConverter
    from fcl_taco2_tpu_torch.data.device_cache import DeviceBatchCache
    from fcl_taco2_tpu_torch.data.manifest import load_manifest
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train import checkpoint as ckpt
    from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from helpers import tiny_config
    from torch_port_helpers import port_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, valid = write_learnable_corpus(str(tmp_path), 4, 2)
    utts = load_manifest(train)
    conv = BatchConverter(max_dur=6, batch_size=2, odim=8).fit_corpus(utts)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceBatchCache(conv, utts)
    assert DeviceBatchCache(conv, utts, device="cpu").rows["mel"].device \
        == torch.device("cpu")
    cfg = port_config(tiny_config())
    model = Tacotron2SA(cfg, device="cpu")
    tcfg = TrainConfig(exp_dir=str(tmp_path / "exp"), epochs=1,
                       batch_size=2, steps_per_dispatch=2,
                       device_cache="on", plot_interval_epochs=0)
    val = load_manifest(valid)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, tcfg, utts, val)
    assert Trainer(model, tcfg, utts, val, device="cpu").run().step == 2
    donor = str(tmp_path / "donor")
    names, params = zip(*model.named_parameters())
    ckpt.save_checkpoint(donor, TrainState(
        model, build_optimizer().init(params, names), 0))
    ckpt.save_model_json(str(tmp_path), cfg)
    args = ["--train-json", train, "--valid-json", valid, "--enc-init",
            donor, "--freeze-mods", "enc.", "--epochs", "1",
            "--batch-size", "2", "--embed-dim", "16", "--eunits", "16",
            "--econv-chans", "16", "--econv-layers", "2", "--dunits", "20",
            "--prenet-units", "12", "--postnet-chans", "10",
            "--postnet-layers", "3", "--duration-predictor-chans", "14",
            "--max-dur", "6", "--duration-classes", "",
            "--compute-dtype", "float32"]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args + ["--outdir", str(tmp_path / "cli")])
    ts = main(args + ["--outdir", str(tmp_path / "cli_cpu"),
                      "--device", "cpu"])
    assert ts.step == 2
    assert os.path.exists(tmp_path / "cli_cpu" / "snapshot.ep.1")


def test_runtime_modules_import_no_jax():
    """The slice's new modules are among the files the import check reads,
    and import neither JAX nor the JAX package."""
    new = ["train/finetune.py", "utils/summary.py", "data/transform.py",
           "data/native.py", "data/device_cache.py", "train/profiler.py",
           "train/step.py", "utils/spans.py"]
    for rel in new:
        path = REPO / "fcl_taco2_tpu_torch" / rel
        assert path.exists(), rel
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, (rel, bad)
    assert (REPO / "fcl_taco2_tpu_torch" / "csrc" / "fclrt.cpp").exists()


def test_preprocess_and_import_modules_import_no_jax():
    """The modules of the preprocessing, reference-import and optimizer
    interchange slice are among the files the import check reads, and
    import neither JAX nor the JAX package."""
    new = ["ops/stft.py", "ops/f0.py", "audio/textgrid.py",
           "audio/synthcorpus.py", "audio/preprocess.py",
           "cli/fcl_preprocess.py", "utils/torch_import.py",
           "train/checkpoint.py"]
    for rel in new:
        path = REPO / "fcl_taco2_tpu_torch" / rel
        assert path.exists(), rel
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, (rel, bad)


def test_preprocess_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, ``Frontend(cfg)``, ``yin_f0`` on its default device
    and ``fcl_preprocess`` without ``--device cpu`` raise; with ``--device
    cpu`` the CLI runs."""
    import os

    import numpy as np
    from fcl_taco2_tpu_torch.audio.preprocess import (Frontend,
                                                      PreprocessConfig)
    from fcl_taco2_tpu_torch.audio.synthcorpus import generate_corpus
    from fcl_taco2_tpu_torch.cli import fcl_preprocess
    from fcl_taco2_tpu_torch.ops.f0 import yin_f0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PreprocessConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        Frontend(cfg)
    assert Frontend(cfg, "cpu").basis.device.type == "cpu"
    x = np.zeros(4096, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        yin_f0(x)
    assert yin_f0(x, device="cpu").device.type == "cpu"
    root = generate_corpus(str(tmp_path / "corpus"), n_utts=4, seed=0)
    args = ["--data-root", root, "--textgrid-root", os.path.join(root, "tg"),
            "--n-val", "1", "--n-test", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        fcl_preprocess.main(args + ["--feature-root", str(tmp_path / "a")],
                            log=lambda *a: None)
    splits, _ = fcl_preprocess.main(
        args + ["--feature-root", str(tmp_path / "b"), "--device", "cpu"],
        log=lambda *a: None)
    assert len(splits["train"]) == 2
    assert os.path.exists(tmp_path / "b" / "train_data.json")


def test_parallel_modules_import_no_jax():
    """The data-parallel slice's modules are among the files the import
    check reads, and import neither JAX nor the JAX package."""
    new = ["parallel/__init__.py", "parallel/mesh.py",
           "parallel/distributed.py", "parallel/_mp_worker.py",
           "ops/masking.py", "ops/conv.py", "train/loop.py",
           "train/distill.py", "infer/synth.py", "cli/fcl_train.py",
           "cli/fcl_synth.py"]
    for rel in new:
        path = REPO / "fcl_taco2_tpu_torch" / rel
        assert path.exists(), rel
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, (rel, bad)


def test_parallel_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, a mesh's ranks default to it too: the worker's and
    the CLIs' ranks run on ``cuda:<rank>`` unless told ``cpu`` (the
    worker's ``main`` and its workloads raise), and the sharded
    ``Synthesizer`` raises like the single one."""
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.parallel import _mp_worker
    from fcl_taco2_tpu_torch.parallel.distributed import (cli_ranks,
                                                          rank_device)
    from fcl_taco2_tpu_torch.parallel.mesh import make_mesh
    from helpers import tiny_config
    from torch_port_helpers import port_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert rank_device("cuda", 1) == torch.device("cuda", 1)
    assert rank_device("cuda:0", 1) == torch.device("cuda", 0)
    assert rank_device("cpu", 1) == torch.device("cpu")
    assert cli_ranks(None, "cpu") == 1 and cli_ranks(3, "cpu") == 3
    model = Tacotron2SA(port_config(tiny_config()), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Synthesizer(model, mesh=make_mesh())
    with pytest.raises(RuntimeError, match="CUDA"):
        _mp_worker.main(["--process-id", "0", "--num-processes", "1",
                         "--port", "1", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
    for run in (_mp_worker.run_training_steps, _mp_worker.run_kd_steps,
                _mp_worker.run_serving, _mp_worker.check_synced_bn,
                lambda: _mp_worker.run_trainers(str(tmp_path))):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


QUALITY_SCRIPTS = {
    "torch_mcd_benchmark": [],
    "torch_dur_quality": ["--feat-dir", "f", "--teacher-exp", "t"],
    "torch_quant_quality": [],
    "torch_decode_protocol": ["--model", "m", "--json", "j"],
    "torch_f0_groundtruth_eval": [],
}


@pytest.mark.parametrize("name", sorted(QUALITY_SCRIPTS))
def test_quality_scripts_default_to_the_card(monkeypatch, tmp_path, name):
    """Each quality script refuses to run without a card unless given
    ``--device cpu``, before it reads or writes a file."""
    import importlib

    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    script = importlib.import_module(name)
    out = tmp_path / "out.json"
    argv = [*QUALITY_SCRIPTS[name], "--out", str(out)]
    if name in ("torch_mcd_benchmark", "torch_quant_quality"):
        argv += ["--workdir", str(tmp_path / "wd")]
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(argv)
    assert not out.exists() and not (tmp_path / "wd").exists()
