"""The port's data-parallel layer (``fcl_taco2_tpu_torch/parallel``) against
the JAX package's multi-device runs.

gloo ranks are spawned on the CPU (``parallel/_mp_worker.py``, one process
a rank), all modes in one spawn a world size (the 2-rank one runs while
this process computes the JAX references); every rank starts from the
JAX package's initial weights (``PRNGKey(0)`` / ``(1)``, handed over as an
``.npz`` through the bridge).  The 2-rank train, duration-classed, KD and
serving results are held to JAX's ``_mp_worker`` functions run here on
conftest's 8 virtual devices, at ``tests/test_parallel.py``'s tolerances
(losses rtol 2e-4 / atol 1e-5, checksums rtol 2e-4, mel sums rtol 1e-3,
mels atol 2e-5); a snapshot of a 2-rank run resumes in a fresh 2-rank
run and in one process; 4 ranks as 2 hosts of 2 equal the flat 4 and
one process; synchronized BatchNorm equals one rank on the whole input;
the trainers and the CLIs with 2 ranks equal one process.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fcl_taco2_tpu.models import Tacotron2SA as JaxModel
from fcl_taco2_tpu.models.kd import KDStudent as JaxKD
from fcl_taco2_tpu.parallel import _mp_worker as jax_worker
from fcl_taco2_tpu_torch.data.loader import BatchUploader
from fcl_taco2_tpu_torch.models.components import maybe_dropout
from fcl_taco2_tpu_torch.models.kd import KDStudent
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
from fcl_taco2_tpu_torch.ops.conv import batch_norm_train
from fcl_taco2_tpu_torch.ops.masking import N_UTTS, lengths_to_non_pad_mask
from fcl_taco2_tpu_torch.ops.regroup import (gather_segments, scatter_frames,
                                             scatter_frames_classed)
from fcl_taco2_tpu_torch.parallel import _mp_worker as worker
from fcl_taco2_tpu_torch.parallel import distributed as D
from fcl_taco2_tpu_torch.parallel.mesh import Mesh
from fcl_taco2_tpu_torch.train.step import step_generator
from fcl_taco2_tpu_torch.utils.params import save_trees_npz

from torch_port_helpers import np_tree, port_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # seconds a spawned rank may take
RTOL, ATOL = 2e-4, 1e-5   # tests/test_parallel.py:123-125
SUM_RTOL = 1e-3           # mel sums, tests/test_parallel.py:247
MEL_ATOL = 2e-5           # mels, tests/test_parallel.py:156
BN_TOL = 1e-5             # fp32, one reduction order against another


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    # a few threads a rank: the ranks share the CPU with other tests
    return dict(os.environ, OMP_NUM_THREADS="2")


def _start(n, out, *extra):
    """Start ``n`` worker ranks on the CPU; ``_finish`` waits for them."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "fcl_taco2_tpu_torch.parallel._mp_worker",
         "--process-id", str(i), "--num-processes", str(n),
         "--port", str(port), "--device", "cpu", "--out", str(out),
         *extra],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n)], out


def _spawn(n, out, *extra):
    """Run ``n`` worker ranks to completion; returns rank 0's result and
    arrays."""
    return _finish(*_start(n, out, *extra))


def _finish(procs, out):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
        assert all(p.returncode == 0 for p in procs), \
            "worker failed:\n" + "\n====\n".join(logs)
        with open(out) as f:
            result = json.load(f)
        with np.load(str(out) + ".npz") as z:
            return result, {k: z[k] for k in z.files}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("parallel")


@pytest.fixture(scope="module")
def weights(root):
    """JAX's initial weights of the worker's models, as the workers'
    ``--params`` file and as trees."""
    cfg = jax_worker._tiny_cfg()
    params, state = JaxModel(cfg).init(jax.random.PRNGKey(0))
    kd = JaxKD(cfg, jax_worker._tiny_cfg(embed_dim=24, eunits=24,
                                         econv_chans=24, dunits=24))
    kp, ks = kd.init(jax.random.PRNGKey(0))
    tp, tst = kd.teacher.init(jax.random.PRNGKey(1))
    trees = dict(params=params, state=state, kd_params=kp, kd_state=ks,
                 teacher_params=tp, teacher_state=tst)
    trees = {k: np_tree(v) for k, v in trees.items()}
    path = root / "jax_init.npz"
    save_trees_npz(path, **trees)
    return str(path), trees


@pytest.fixture(scope="module")
def corpus(root):
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    path = root / "corpus"
    write_learnable_corpus(str(path), 16, 6, max_dur=4)
    return path


def _train_cli_args(corpus, exp):
    """``fcl_train`` at the worker's tiny widths, one epoch, 2 ranks."""
    return ["--train-json", str(corpus / "train.json"),
            "--valid-json", str(corpus / "valid.json"),
            "--embed-dim", "16", "--eunits", "16", "--econv-layers", "2",
            "--econv-chans", "16", "--dunits", "16", "--prenet-units", "8",
            "--postnet-layers", "3", "--postnet-chans", "8",
            "--duration-predictor-chans", "8", "--max-dur", "4",
            "--compute-dtype", "float32", "--dropout-rate", "0",
            "--zoneout-rate", "0", "--batch-size", "4", "--epochs", "1",
            "--device", "cpu", "--n-devices", "2", "--outdir", str(exp)]


@pytest.fixture(scope="module")
def started(root, weights, corpus):
    """The rank groups that need no other's output, started at once and
    left running while this process computes the JAX references: a
    2-rank spawn of every mode (dp saves after step 2 of 3; the trainers
    and ``fcl_synth --n-devices 2`` included), 4 ranks as 2 hosts of 2,
    and ``fcl_train --n-devices 2``.  Killed at the module's end."""
    runs = {
        "world2": _start(2, root / "w2.json", "--mode", "all", "--steps",
                         "3", "--save-ckpt", str(root / "dp2.ckpt"),
                         "--save-step", "2", "--params", weights[0],
                         "--corpus", str(corpus)),
        "world4": _start(4, root / "w4.json", "--mode", "hybrid",
                         "--steps", "3", "--n-slices", "2", "--params",
                         weights[0]),
        "cli": ([subprocess.Popen(
            [sys.executable, "-m", "fcl_taco2_tpu_torch.cli.fcl_train",
             *_train_cli_args(corpus, root / "cli_exp")],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)], None)}
    yield runs
    for procs, _ in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def jax_ref(started):
    """JAX's multi-device runs on 8 virtual devices, computed while the
    rank groups run."""
    dp = jax_worker.run_training_steps(4, checksum_steps=(2, 3))
    return {"dp": dp,
            "classed": jax_worker.run_training_steps(2, classes=(2, 4)),
            "kd": jax_worker.run_kd_steps(2),
            "serve": jax_worker.run_serving()}


@pytest.fixture(scope="module")
def world2(root, weights, started, jax_ref):
    """The 2-rank spawn's results, then a fresh 2-rank run resumed from
    its snapshot for 2 steps."""
    ckpt = root / "dp2.ckpt"
    a = _finish(*started["world2"])
    b = _spawn(2, root / "w2r.json", "--mode", "dp", "--steps", "2",
               "--resume-ckpt", str(ckpt), "--params", weights[0])
    return a, b, str(ckpt)


@pytest.fixture(scope="module")
def params(weights):
    from fcl_taco2_tpu_torch.utils.params import load_trees_npz
    return load_trees_npz(weights[0])


def test_two_ranks_train_like_jax(world2, jax_ref):
    (got, _), _, _ = world2
    losses, checksum, mid = jax_ref["dp"]
    assert got["num_processes"] == 2 and got["backend"] == "gloo"
    np.testing.assert_allclose(got["dp"]["losses"], losses[:3], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["dp"]["checksum"], mid[3], rtol=RTOL)
    # one flat bucket of gradients and reports a step, plus BatchNorm's
    # three per layer (5 layers: 2 encoder convs, 3 postnet)
    assert got["dp"]["allreduce_per_step"]["calls"] == 1 + 3 * 5


def test_two_ranks_classed_like_jax(world2, jax_ref):
    (got, _), _, _ = world2
    losses, checksum = jax_ref["classed"]
    np.testing.assert_allclose(got["classed"]["losses"], losses, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["classed"]["checksum"], checksum,
                               rtol=RTOL)


def test_two_ranks_kd_like_jax(world2, jax_ref):
    (got, _), _, _ = world2
    losses, checksum = jax_ref["kd"]
    np.testing.assert_allclose(got["kd"]["losses"], losses, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["kd"]["checksum"], checksum, rtol=RTOL)


def test_two_ranks_serve_like_jax_and_one_rank(world2, jax_ref, weights,
                                               params):
    """Sharded serving: JAX's case (predicted durations) by total frames
    and mel sums; every mel, and those of given durations, against one
    port rank and against JAX's single-device Synthesizer."""
    (got, arrays), _, _ = world2
    sums, frames = jax_ref["serve"]
    assert got["serve_tiny"]["total_frames"] == frames
    np.testing.assert_allclose(got["serve_tiny"]["mel_sums"], sums,
                               rtol=SUM_RTOL)
    one = worker.run_serving(params=params, device="cpu")
    toks, durs, B, kw = worker.serve_requests("tiny")
    from fcl_taco2_tpu.infer.synth import Synthesizer as JaxSynth
    jmels, _ = JaxSynth(JaxModel(jax_worker._tiny_cfg()),
                        weights[1]["params"], weights[1]["state"],
                        batch_size=B, **kw).synth_batch(
        toks, jax.random.PRNGKey(5), durations=durs)
    assert sum(len(m) for m in jmels) == sum(int(d.sum()) for d in durs)
    for case, ref in (("tiny", None), ("tiny_dur", jmels)):
        mels, total = one[case]
        assert got[f"serve_{case}"]["total_frames"] == total
        for i, m in enumerate(mels):
            np.testing.assert_allclose(arrays[f"serve_{case}/{i}"], m,
                                       atol=MEL_ATOL)
            if ref is not None:
                np.testing.assert_allclose(m, ref[i], atol=MEL_ATOL)


def test_snapshot_resumes_in_fresh_runs(world2, jax_ref, params, weights):
    """A 2-rank run's snapshot (rank 0 writes it after step 2): a fresh
    2-rank run and a single process continue JAX's uninterrupted 4 steps;
    the JAX package loads it."""
    (a, _), (b, _), ckpt = world2
    losses, checksum, mid = jax_ref["dp"]
    np.testing.assert_allclose(a["dp"]["losses"][:2], losses[:2], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(b["dp"]["losses"], losses[2:4], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(b["dp"]["checksum"], checksum, rtol=RTOL)
    one, one_sum, _, _ = worker.run_training_steps(2, resume_ckpt=ckpt,
                                                   params=params,
                                                   device="cpu")
    np.testing.assert_allclose(one, losses[2:4], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(one_sum, checksum, rtol=RTOL)
    from fcl_taco2_tpu.train.checkpoint import load_params_only
    jp, _ = load_params_only(ckpt, weights[1]["params"],
                             weights[1]["state"])
    jsum = sum(float(np.abs(np.asarray(x)).sum())
               for x in jax.tree_util.tree_leaves(jp))
    np.testing.assert_allclose(jsum, a["dp"]["checksums"]["2"], rtol=1e-6)


def test_hybrid_four_ranks_equal_flat_and_one_rank(started, params):
    got, _ = _finish(*started["world4"])
    assert got["hybrid"]["shape"] == [2, 2]
    one, one_sum, _, norms = worker.run_training_steps(3, params=params,
                                                       device="cpu")
    for key in ("flat", "hybrid"):
        np.testing.assert_allclose(got[key]["losses"], one, rtol=RTOL,
                                   atol=ATOL, err_msg=key)
        np.testing.assert_allclose(got[key]["checksum"], one_sum, rtol=RTOL,
                                   err_msg=key)
        np.testing.assert_allclose(got[key]["grad_norms"], norms, rtol=RTOL,
                                   err_msg=key)


@pytest.mark.parametrize("case", ["masked", "unmasked"])
def test_synced_batch_norm_equals_one_rank(world2, case):
    """2 ranks' synchronized train-mode BatchNorm (forward, input and
    parameter gradients, running statistics) against one rank on the
    concatenated input through autograd."""
    (_, arrays), _, _ = world2
    x, gy, w, b, rm, rv, lens = worker.bn_inputs()
    t = {k: torch.tensor(v, requires_grad=k in ("x", "w", "b"))
         for k, v in dict(x=x, w=w, b=b).items()}
    mask = lengths_to_non_pad_mask(torch.tensor(lens), x.shape[1]) \
        if case == "masked" else None
    y, (nm, nv) = batch_norm_train(t["x"], t["w"], t["b"],
                                   torch.tensor(rm), torch.tensor(rv),
                                   mask=mask)
    (y * torch.tensor(gy)).sum().backward()
    want = {"y": y, "dx": t["x"].grad, "dw": t["w"].grad,
            "db": t["b"].grad, "mean": nm, "var": nv}
    for k, v in want.items():
        np.testing.assert_allclose(arrays[f"bn_{case}/{k}"],
                                   v.detach().numpy(), atol=BN_TOL,
                                   rtol=BN_TOL, err_msg=k)


def test_ranks_draw_different_dropout_masks():
    """Each rank's step generator is its own: two ranks' masks differ
    (disagreeing on about 2p(1-p) of the entries, as independent draws
    do) and each keeps 1 - p of them; rank 0 draws what a single process
    draws."""
    rate, n = 0.5, 200_000
    x = torch.ones(n)
    masks = [maybe_dropout(x, rate, step_generator(1, 7, "cpu", r), True)
             > 0 for r in range(4)]
    single = maybe_dropout(x, rate, step_generator(1, 7, "cpu"), True) > 0
    assert torch.equal(masks[0], single)
    for m in masks:
        assert abs(float(m.float().mean()) - (1 - rate)) < 0.005
    for i in range(4):
        for j in range(i + 1, 4):
            differ = float((masks[i] != masks[j]).float().mean())
            assert abs(differ - 2 * rate * (1 - rate)) < 0.01, (i, j)
    # the same rank and step draws the same mask: a resume replays it
    again = maybe_dropout(x, rate, step_generator(1, 7, "cpu", 1), True) > 0
    assert torch.equal(masks[1], again)


@pytest.mark.parametrize("classes,n_ranks", [((), 2), ((), 4),
                                             ((2, 4), 2), ((2, 4), 4)])
def test_batch_share_keeps_the_global_plan(classes, n_ranks):
    """Each rank's share regroups its own utterances exactly as the
    global plan does (seg_utt and utt_gather re-based), with the global
    padded shapes and one segment capacity a class for every rank."""
    cfg = worker._tiny_cfg(duration_classes=classes)
    g = worker._tiny_batch(cfg, classes=classes)
    b = g.tokens.shape[0] // n_ranks
    caps = None
    for r in range(n_ranks):
        s = D.batch_share(g, r, n_ranks)
        assert s.counts[N_UTTS] == 8 and s.mel.shape[1] == g.mel.shape[1]
        assert s.tokens.shape == (b, g.tokens.shape[1])
        sc = BatchUploader("cpu")(s)
        mel = sc.mel
        plans = sc.seg_classes or (sc,)
        shape = [p.seg_utt.shape[0] for p in plans]
        assert caps is None or shape == caps
        caps = shape
        segs = [gather_segments(mel, p.seg_utt, p.seg_start, p.frame_mask)
                for p in plans]
        back = scatter_frames(segs[0], sc.utt_gather, sc.utt_mask) \
            if not classes else scatter_frames_classed(segs, sc.utt_gather,
                                                       sc.utt_mask)
        want = mel * sc.utt_mask[..., None]
        assert torch.equal(back, want)
        assert torch.equal(torch.from_numpy(g.mel[r * b:(r + 1) * b]), mel)


@pytest.mark.parametrize("variant", [
    {}, {"use_weighted_masking": True, "use_masking": False},
    {"use_masking": False}, {"reduction_factor": 2}],
    ids=["masked", "weighted", "unmasked", "r2"])
def test_share_losses_sum_to_the_global_loss(variant):
    """Without BatchNorm (whose statistics need the ranks' collective),
    the shares' losses over the global counts sum to the global batch's
    loss, term by term and in their gradients."""
    cfg = worker._tiny_cfg(use_batch_norm=False, **variant)
    g = worker._tiny_batch(cfg)
    model = Tacotron2SA(cfg, device="cpu", seed=0)
    loss, (rep, _, _) = model.loss_fn(port_batch(g), torch.Generator())
    want = torch.autograd.grad(loss, list(model.parameters()))
    total, terms = 0.0, {}
    for r in range(4):
        s = D.batch_share(g, r, 4)
        s_loss, (s_rep, _, _) = model.loss_fn(BatchUploader("cpu")(s),
                                              torch.Generator())
        total = total + s_loss
        for k, v in s_rep.items():
            terms[k] = terms.get(k, 0.0) + float(v)
    got = torch.autograd.grad(total, list(model.parameters()))
    for k, v in rep.items():
        np.testing.assert_allclose(terms[k], float(v), rtol=1e-5, err_msg=k)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_kd_share_losses_sum_to_the_global_loss():
    cfg = worker._tiny_cfg(use_batch_norm=False)
    kd = KDStudent(cfg, worker._tiny_cfg(use_batch_norm=False, embed_dim=24,
                                         eunits=24, econv_chans=24,
                                         dunits=24), device="cpu", seed=0)
    g = worker._tiny_batch(cfg)
    gen = torch.Generator()
    _, (rep, _, _) = kd.loss_fn(port_batch(g), gen)
    terms = {}
    for r in range(2):
        s = D.batch_share(g, r, 2)
        _, (s_rep, _, _) = kd.loss_fn(BatchUploader("cpu")(s), gen)
        for k, v in s_rep.items():
            terms[k] = terms.get(k, 0.0) + float(v)
    for k, v in rep.items():
        np.testing.assert_allclose(terms[k], float(v), rtol=1e-5, err_msg=k)


def test_batch_not_divisible_by_the_ranks_raises():
    from fcl_taco2_tpu_torch.infer.synth import Synthesizer
    from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer
    three = Mesh((3,), ("data",), rank=0)
    cfg = worker._tiny_cfg()
    with pytest.raises(ValueError, match="not divisible by 3"):
        D.batch_share(worker._tiny_batch(cfg), 0, 3)
    model = Tacotron2SA(cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        Synthesizer(model, batch_size=8, device="cpu", mesh=three)
    with pytest.raises(ValueError, match="not divisible by data-parallel"):
        Trainer(model, TrainConfig(batch_size=8), [], [], device="cpu",
                mesh=three)
    # one process cannot be several ranks
    with pytest.raises(ValueError, match="one process a device"):
        Trainer(model, TrainConfig(batch_size=8, n_devices=2), [], [],
                device="cpu")


def test_nccl_with_two_ranks_on_one_card_raises(monkeypatch):
    """NCCL refuses two ranks on one device: the port says so before any
    process group exists."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        D.initialize(f"localhost:{_free_port()}", 2, 0, backend="nccl",
                     device="cuda:0")
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        D.spawn(print, 2, device="cuda:0")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        D.initialize(f"localhost:{_free_port()}", 2, 0, backend="nccl",
                     device="cpu")


def test_initialize_without_a_coordinator_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    D.initialize()
    assert not torch.distributed.is_initialized()
    assert (D.process_index(), D.process_count()) == (0, 1)
    assert not D.is_multiprocess()


def test_trainers_with_two_ranks_equal_one(world2, corpus):
    """``Trainer`` (2 epochs) and ``KDTrainer`` (1 epoch) with 2 ranks log
    the losses of one process, validation included; each rank writes its
    own profiler trace."""
    got = world2[0][0]["trainers"]
    want = worker.run_trainers(str(corpus), device="cpu")
    prof = corpus / "world2" / "train" / "prof"
    assert sorted(os.listdir(prof)) == ["trace.rank0.json",
                                        "trace.rank1.json"]
    assert os.listdir(corpus / "world1" / "train" / "prof") == ["trace.json"]
    for name in ("train", "kd"):
        assert len(got[name]) == len(want[name])
        for a, b in zip(got[name], want[name]):
            assert a["step"] == b["step"]
            for k in ("main/loss", "validation/main/loss"):
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} {k}")


def test_cli_two_ranks(root, corpus, started, world2):
    """``fcl_train --n-devices 2`` spawns 2 ranks (one writes the run's
    files), and ``fcl_synth --n-devices 2``, run in the 2-rank spawn on
    its trainer's snapshot, writes the arks of one process."""
    from fcl_taco2_tpu_torch.cli import fcl_synth
    exp, out1 = root / "cli_exp", root / "syn1"
    out2 = corpus / "world2" / "synth"
    (run,), _ = started["cli"]
    log = run.communicate(timeout=TIMEOUT)[0]
    assert run.returncode == 0, log
    with open(exp / "log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert len(log) == 1 and np.isfinite(log[0]["main/loss"])
    fcl_synth.main(worker.synth_cli_args(str(corpus), 2)
                   + ["--device", "cpu", "--out", str(out1)])
    assert (out2 / "feats.ark").read_bytes() == \
        (out1 / "feats.ark").read_bytes()
    assert (out2 / "decode.txt").exists()
