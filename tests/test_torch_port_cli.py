"""The port's serving and scoring CLIs against the JAX package's, and the
paper's workflow end to end on the CPU.

- ``fcl_synth``: the port's and JAX's CLI decode one checkpoint (written
  by the port) and one manifest to the same utterances, frame counts and
  mels (fp32, dropout 0), with predicted and with corpus durations, and
  the same ``decode.txt`` layout; a second run with the same seed writes
  the same ark, byte for byte.
- ``fcl_eval`` and ``infer/metrics.py`` equal JAX's.
- ``fcl_vocode``'s per-utterance function equals JAX's ``vocode(...,
  backend="xla")`` on the same noise and a ``.pkl`` written here.
- ``fcl_tts``, batch and ``--stream``, writes one wav per utterance of
  the JAX CLI's length.
- without PyYAML a JSON config parses and a yaml one fails saying why.
- teacher training -> KD -> shards -> decode -> score through the port's
  entry points (``tests/test_cli.py::test_cli_full_workflow``'s shape).
"""

import glob
import json
import os
import wave

import numpy as np
import pytest
import torch

from fcl_taco2_tpu.cli import fcl_eval as jax_eval
from fcl_taco2_tpu.cli import fcl_synth as jax_synth
from fcl_taco2_tpu.cli import fcl_tts as jax_tts
from fcl_taco2_tpu.infer import metrics as jax_metrics
from fcl_taco2_tpu_torch.cli import (fcl_eval, fcl_splitjson, fcl_synth,
                                     fcl_train, fcl_tts, fcl_vocode)
from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
from fcl_taco2_tpu_torch.infer import metrics
from fcl_taco2_tpu_torch.infer.ark import read_ark_matrix
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
from fcl_taco2_tpu_torch.train import checkpoint as ckpt
from fcl_taco2_tpu_torch.train.optim import build_optimizer
from fcl_taco2_tpu_torch.train.state import TrainState

from helpers import tiny_config
from torch_port_helpers import NO_DROPOUT, port_config

MEL_ATOL = 3e-4    # the synthesize tolerance (tests/test_torch_parity.py)
EVAL_TOL = 1e-6
VOCODE_ATOL = 1e-4
SMALL_PWG = {"layers": 4, "stacks": 2, "residual_channels": 8,
             "gate_channels": 16, "skip_channels": 8,
             "upsample_scales": [2, 2]}


def _write_model(exp, cfg, seed=0):
    """model.json + a port checkpoint of a seeded model whose duration
    predictor gives 2-4 frames a token (away from rounding edges)."""
    model = Tacotron2SA(port_config(cfg), device="cpu", seed=seed)
    with torch.no_grad():
        lin = model.duration_predictor.linear
        lin.weight.mul_(0.3)
        lin.bias.fill_(float(np.log(4.0)))
    ckpt.save_model_json(exp, model.cfg)
    tx = build_optimizer()
    path = os.path.join(exp, "model.loss.best")
    ckpt.save_checkpoint(path, TrainState(model, tx.init(
        list(model.parameters())), 1), 1)
    return path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A corpus (5 validation utterances) and a fp32, dropout-0 tiny
    checkpoint written by the port."""
    root = str(tmp_path_factory.mktemp("served"))
    _, valid = write_learnable_corpus(root, 1, 5, odim=8, max_dur=6)
    path = _write_model(os.path.join(root, "exp"), tiny_config(**NO_DROPOUT))
    return root, valid, path


def _read_scp(out):
    with open(os.path.join(out, "feats.scp")) as f:
        pairs = [line.split() for line in f.read().splitlines()]
    return {u: read_ark_matrix(p) for u, p in pairs}


def _layout(out):
    """decode.txt with every number replaced: the line structure."""
    with open(os.path.join(out, "decode.txt")) as f:
        lines = f.read().splitlines()

    def word(t):
        try:
            float(t)
            return "#"
        except ValueError:
            return t
    return [[word(t) for t in line.split()] for line in lines]


@pytest.mark.parametrize("gt", [False, True], ids=["predicted", "gt_durs"])
def test_fcl_synth_matches_jax(served, tmp_path, gt):
    _, valid, path = served
    flags = ["--model", path, "--json", valid, "--batch-size", "2"]
    flags += ["--use-gt-durations"] if gt else []
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_synth.main(flags + ["--out", jax_out])
    fcl_synth.main(flags + ["--out", out, "--device", "cpu"])
    want, got = _read_scp(jax_out), _read_scp(out)
    assert list(got) == list(want) and len(got) == 5
    for u in want:
        assert got[u].shape == want[u].shape, u
        assert want[u].shape[0] > 0
        np.testing.assert_allclose(got[u], want[u], atol=MEL_ATOL, err_msg=u)
    assert _layout(out) == _layout(jax_out)
    frames = [line[2] for line in open(os.path.join(out, "decode.txt"))
              .read().splitlines()[:5] for line in [line.split()]]
    assert frames == [str(want[u].shape[0]) for u in want]


def test_fcl_synth_same_seed_same_ark(served, tmp_path):
    """With dropout on (the prenet's stays on at inference): two runs with
    one seed write byte-equal arks, another seed another ark."""
    root, valid, _ = served
    path = _write_model(os.path.join(root, "exp_dropout"), tiny_config())
    arks = []
    for name, seed in (("a", "3"), ("b", "3"), ("c", "4")):
        out = str(tmp_path / name)
        fcl_synth.main(["--model", path, "--json", valid, "--out", out,
                        "--batch-size", "2", "--seed", seed,
                        "--device", "cpu"])
        with open(os.path.join(out, "feats.ark"), "rb") as f:
            arks.append(f.read())
    assert arks[0] == arks[1]
    assert arks[0] != arks[2]


@pytest.mark.parametrize("stats", [True, False], ids=["denorm", "as_is"])
def test_fcl_eval_matches_jax(served, tmp_path, capsys, stats):
    root, valid, path = served
    out = str(tmp_path / "dec")
    fcl_synth.main(["--model", path, "--json", valid, "--out", out,
                    "--device", "cpu"])
    flags = ["--feats-scp", os.path.join(out, "feats.scp"), "--json", valid]
    if stats:
        rng = np.random.default_rng(0)
        stats_path = str(tmp_path / "mel_stats.npy")
        np.save(stats_path, np.stack([rng.normal(size=8),
                                      rng.uniform(0.5, 2.0, 8)]))
        flags += ["--mel-stats", stats_path]
    capsys.readouterr()
    jax_eval.main(flags)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = str(tmp_path / "report.json")
    got = fcl_eval.main(flags + ["--out", report])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert set(got) == set(want)
    assert (got["n_utts"], got["units"]) == (want["n_utts"], want["units"])
    for k in ("mcd", "l1", "rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_TOL)
    with open(report) as f:
        assert len(json.load(f)["utts"]) == 5


@pytest.mark.parametrize("T", [(40, 40), (33, 41)], ids=["equal", "trim"])
def test_metrics_match_jax(T):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(T[0], 80)).astype(np.float32)
    b = rng.normal(size=(T[1], 80)).astype(np.float32)
    for name in ("mel_cepstral_distortion", "mel_l1", "mel_rmse"):
        np.testing.assert_allclose(getattr(metrics, name)(a, b),
                                   getattr(jax_metrics, name)(a, b),
                                   rtol=EVAL_TOL, err_msg=name)


def test_vocode_utterance_matches_jax(tmp_path):
    """One utterance through ``fcl_vocode.vocode_utterance`` (mel padded to
    64 frames, wav trimmed to T * hop) against JAX's ``vocode(...,
    backend="xla")`` on the same padded mel and noise, both vocoders
    loaded from one ``.pkl``."""
    import jax.numpy as jnp
    from fcl_taco2_tpu.vocoder.pwg import PWGConfig as JaxPWGConfig
    from fcl_taco2_tpu.vocoder.pwg import \
        load_pwg_checkpoint as jax_load_pwg
    from fcl_taco2_tpu.vocoder.pwg_pallas import vocode as jax_vocode
    from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN, PWGConfig,
                                                 load_pwg_checkpoint)

    over = dict(SMALL_PWG, aux_channels=8,
                upsample_scales=tuple(SMALL_PWG["upsample_scales"]))
    cfg, jcfg = PWGConfig(**over), JaxPWGConfig(**over)
    pkl = str(tmp_path / "pwg.pkl")
    torch.save({"model": {"generator": ParallelWaveGAN(
        cfg, device="cpu", seed=3).state_dict()}}, pkl)
    pwg = load_pwg_checkpoint(pkl, cfg, device="cpu")
    rng = np.random.default_rng(0)
    T, Tb = 37, 64
    mel = rng.normal(size=(T, 8)).astype(np.float32)
    noise = rng.normal(size=Tb * cfg.hop).astype(np.float32)
    got = fcl_vocode.vocode_utterance(pwg, cfg, mel, noise)
    mel_p = np.zeros((1, Tb, 8), np.float32)
    mel_p[0, :T] = mel
    want = np.asarray(jax_vocode(jax_load_pwg(pkl, jcfg), jcfg,
                                 jnp.asarray(mel_p),
                                 jnp.asarray(noise[None]),
                                 backend="xla"))[0, :T * cfg.hop]
    assert got.shape == want.shape == (T * cfg.hop,)
    np.testing.assert_allclose(got, want, atol=VOCODE_ATOL)


def _wav_lengths(outdir):
    lengths = {}
    for name in sorted(os.listdir(outdir)):
        with wave.open(os.path.join(outdir, name)) as w:
            lengths[name] = w.getnframes()
    return lengths


@pytest.mark.parametrize("mode", ["batch", "stream"])
def test_fcl_tts_wav_lengths_match_jax(served, tmp_path, mode):
    """The batch path and ``--stream`` each write one wav per utterance,
    of the length JAX's fcl_tts writes in the same mode (the predicted
    frames times the hop; the duration predictor sees each mode's own
    token padding, 16 a batch and 8 a stream, in both packages)."""
    _, valid, path = served
    pwg_conf = str(tmp_path / "pwg.json")
    with open(pwg_conf, "w") as f:
        json.dump(SMALL_PWG, f)
    flags = ["--model", path, "--json", valid, "--pwg-config", pwg_conf,
             "--batch-size", "2"] + (["--stream"] if mode == "stream" else [])
    jax_tts.main(flags + ["--outdir", str(tmp_path / "jax")])
    want = _wav_lengths(str(tmp_path / "jax"))
    assert len(want) == 5 and min(want.values()) > 0
    out = str(tmp_path / "port")
    stats = fcl_tts.main(flags + ["--outdir", out, "--device", "cpu"])
    assert _wav_lengths(out) == want
    assert np.isfinite(stats["rtf_x"])


@pytest.mark.parametrize("text", ["json", "yaml"])
def test_config_without_pyyaml(tmp_path, monkeypatch, text):
    """Where PyYAML is missing a JSON config and a flat yaml one (as
    ``conf/*.yaml`` are) still parse, the yaml one to what PyYAML reads,
    and a yaml file that is not flat fails with an error that says why."""
    import builtins

    from fcl_taco2_tpu_torch.utils.cliconf import parse_with_configs

    real_import = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("No module named 'yaml'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    conf = str(tmp_path / "teacher.conf")
    with open(conf, "w") as f:
        f.write('{"eunits": 20, "max-dur": 6}' if text == "json"
                else TEACHER_YAML)
    argv = ["--train-json", "t.json", "--valid-json", "v.json",
            "--outdir", "o", "--config", conf]
    args = parse_with_configs(fcl_train.get_parser(), argv)
    if text == "json":
        assert (args.eunits, args.max_dur) == (20, 6)
    else:
        monkeypatch.setattr(builtins, "__import__", real_import)
        import yaml
        want = {k.replace("-", "_"): v
                for k, v in yaml.safe_load(TEACHER_YAML).items()}
        assert {k: getattr(args, k) for k in want} == want
        from fcl_taco2_tpu_torch.utils.cliconf import parse_flat_config
        conf_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "conf")
        paths = sorted(glob.glob(os.path.join(conf_dir, "*.yaml")))
        assert len(paths) == 2
        for path in paths:
            with open(path) as f:
                text = f.read()
            assert parse_flat_config(text, path) == yaml.safe_load(text)
        monkeypatch.setattr(builtins, "__import__", no_yaml)
        with open(conf, "w") as f:
            f.write("eunits: 20\nduration-classes:\n  - 8\n  - 16\n")
        with pytest.raises(ImportError, match="PyYAML is not installed"):
            parse_with_configs(fcl_train.get_parser(), argv)


TINY = ["--embed-dim", "16", "--eunits", "16", "--econv-chans", "16",
        "--dunits", "20", "--prenet-units", "12", "--postnet-layers", "3",
        "--postnet-chans", "10", "--duration-predictor-chans", "14",
        "--max-dur", "6", "--duration-classes", "3", "--compute-dtype",
        "float32", "--batch-size", "4", "--device", "cpu"]
TEACHER_YAML = ("embed-dim: 16\neunits: 16\neconv-chans: 16\ndunits: 20\n"
                "prenet-units: 12\npostnet-layers: 3\npostnet-chans: 10\n"
                "duration-predictor-chans: 14\nmax-dur: 6\n"
                "duration-classes: '3'\ncompute-dtype: float32\n")


def test_workflow_end_to_end(tmp_path):
    """Teacher training, KD (remat on, its default), manifest shards,
    decoding the student and scoring, all with ``--device cpu``: the
    asserts of ``tests/test_cli.py::test_cli_full_workflow``."""
    root = str(tmp_path)
    train, valid = write_learnable_corpus(root, 8, 4)
    teacher = os.path.join(root, "exp_teacher")
    fcl_train.main(["--train-json", train, "--valid-json", valid,
                    "--outdir", teacher, "--epochs", "1", *TINY])
    tckpt = os.path.join(teacher, "model.loss.best")
    assert os.path.exists(tckpt)

    tconf = os.path.join(root, "teacher.yaml")
    with open(tconf, "w") as f:
        f.write(TEACHER_YAML)
    student = os.path.join(root, "exp_student")
    ts = fcl_train.main([
        "--train-json", train, "--valid-json", valid, "--outdir", student,
        "--perform-KD", "True", "--teacher-config", tconf,
        "--teacher-checkpoint", tckpt, "--embed-dim", "8", "--eunits", "8",
        "--econv-chans", "8", "--dunits", "12", "--prenet-units", "6",
        "--postnet-layers", "3", "--postnet-chans", "6",
        "--duration-predictor-chans", "14", "--max-dur", "6",
        "--duration-classes", "3", "--epochs", "1", "--batch-size", "4",
        "--compute-dtype", "float32", "--device", "cpu"])
    assert ts.model.cfg.remat_decoder  # the KD default
    sckpt = os.path.join(student, "model.loss.best")
    assert os.path.exists(sckpt)
    with open(os.path.join(student, "log.jsonl")) as f:
        entry = json.loads(f.readline())
    for k in ["main/encoder_loss", "main/decoder_loss", "main/prosody_loss",
              "main/output_l1_loss"]:
        assert k in entry, k
    cfg, extra = ckpt.load_model_json(student)
    assert cfg.dunits == 12 and extra["teacher_config"]["dunits"] == 20
    assert extra["teacher_checkpoint"] == tckpt
    assert "kd_proj" in ckpt.read_checkpoint(sckpt)["params"]

    fcl_splitjson.main([valid, "--parts", "2"])
    shard = os.path.join(root, "split2utt", "valid.1.json")
    out = os.path.join(root, "decode_out")
    # corpus durations: a one-epoch student predicts near-zero ones, and
    # the score needs frames to compare
    fcl_synth.main(["--model", sckpt, "--json", shard, "--out", out,
                    "--batch-size", "2", "--use-gt-durations",
                    "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "feats.scp"))
    with open(os.path.join(out, "decode.txt")) as f:
        txt = f.read()
    assert txt.count("frames_per_sec") >= 2 + 3, txt
    assert "mean_frames_per_sec" in txt
    assert "p50_frames_per_sec" in txt and "p95_frames_per_sec" in txt
    mats = _read_scp(out)
    assert len(mats) == 2
    assert all(m.ndim == 2 and m.shape[1] == 8 for m in mats.values())

    summary = fcl_eval.main(["--feats-scp", os.path.join(out, "feats.scp"),
                             "--json", shard])
    assert summary["n_utts"] == 2 and np.isfinite(summary["mcd"])


def test_multispeaker_training(tmp_path):
    """Multi-speaker training from the CLI
    (``tests/test_cli.py::test_cli_multispeaker_training`` on the port,
    which the JAX trainer fails for its validation manifest sharing the
    training one, ROADMAP §C): the speaker vectors flow manifest ->
    device cache -> batch -> the trainer's steps, and ``model.json``
    keeps their width."""
    from test_data_pipeline import write_corpus
    corpus = write_corpus(str(tmp_path), n_utts=6, spk_embed_dim=16)
    exp = os.path.join(str(tmp_path), "exp_spk")
    fcl_train.main(["--train-json", corpus, "--valid-json", corpus,
                    "--outdir", exp, "--perform-KD", "False",
                    "--spk-embed-dim", "16", "--epochs", "1", *TINY])
    assert os.path.exists(os.path.join(exp, "model.loss.best"))
    with open(os.path.join(exp, "model.json")) as f:
        conf = json.load(f)
    assert conf["model_config"]["spk_embed_dim"] == 16
    with open(os.path.join(exp, "log.jsonl")) as f:
        entry = json.loads(f.readline())
    assert entry["device_cache"] and np.isfinite(entry["main/loss"])
