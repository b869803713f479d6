"""Knowledge distillation in the port against the JAX package, and its
invariants (``tests/test_kd.py``'s cases on the port).

- ``KDStudent.loss_fn``: loss, every report term and every gradient leaf
  (``kd_proj`` included) against JAX's on the same weights and batch
  (fp32, dropout and zoneout 0): shared projections on the single-class
  plan, per-layer projections on the duration-classed plan with
  ``remat_decoder`` in both packages, and ``use_weighted_masking``.
- The decoder's new paths: KD captures through the hand-built backward
  and through checkpointed steps (``remat_decoder``) against autograd
  through the plain loop, with zoneout and dropout on.
- Terms, toggles, a frozen teacher (no gradient; parameters and BatchNorm
  statistics unchanged by KD steps), learning projections, and KD
  snapshots that load in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcl_taco2_tpu.models import Tacotron2SA as JaxModel
from fcl_taco2_tpu.models.kd import KDStudent as JaxKD
from fcl_taco2_tpu.train import checkpoint as jax_ckpt
from fcl_taco2_tpu.utils.device import zeros_like_shapes
from fcl_taco2_tpu_torch.models.decoder import Decoder, _teacher_forced_core
from fcl_taco2_tpu_torch.models.kd import KDStudent
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
from fcl_taco2_tpu_torch.train import checkpoint as ckpt
from fcl_taco2_tpu_torch.train.optim import build_optimizer
from fcl_taco2_tpu_torch.train.state import TrainState
from fcl_taco2_tpu_torch.train.step import make_kd_train_step
from fcl_taco2_tpu_torch.utils.params import params_to_numpy

from helpers import synthetic_batch, tiny_config, with_duration_classes
from torch_port_helpers import (NO_DROPOUT, max_abs_err, max_rel_err,
                                np_tree, port_batch, port_config,
                                port_grads_as_jax, port_state_as_jax)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4   # max|a-b| / max|a| per leaf
STATE_ATOL = 1e-5
VJP_RTOL = 1e-5
KD_TERMS = ["l1_loss", "mse_loss", "dur_loss", "pitch_loss", "energy_loss",
            "output_l1_loss", "output_mse_loss", "encoder_loss",
            "decoder_loss", "prosody_loss", "loss"]
STUDENT = dict(embed_dim=8, eunits=8, econv_chans=8, dunits=12,
               prenet_units=6, postnet_chans=6)


def _kd(share_proj=True, dropout=False, **variant):
    """JAX teacher and student configs (``tests/test_kd.py:12-20``) and a
    port ``KDStudent`` on the CPU."""
    rates = {} if dropout else NO_DROPOUT
    tcfg = tiny_config(**rates, **variant)
    scfg = tiny_config(**STUDENT, **rates, **variant)
    kd = KDStudent(port_config(scfg), port_config(tcfg),
                   share_proj=share_proj, device="cpu", seed=0)
    return tcfg, scfg, kd


def _batch(cfg, classed=False):
    batch = synthetic_batch(cfg, B=3, Tmax=5, seed=1)
    return with_duration_classes(batch, (3, cfg.max_dur)) if classed \
        else batch


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("case", [
    dict(share_proj=True),
    dict(share_proj=False, classed=True, remat_decoder=True),
    dict(share_proj=True, use_weighted_masking=True, use_masking=False),
], ids=["shared_single_class", "per_layer_classed_remat", "weighted"])
def test_kd_loss_and_grads_match_jax(case):
    """One JAX compile a case: the port's weights go through the bridge to
    JAX (``kd_proj`` included); the teacher runs in train mode in both."""
    case = dict(case)
    share_proj, classed = case.pop("share_proj"), case.pop("classed", False)
    tcfg, scfg, kd = _kd(share_proj, **case)
    sp, ss = jax.tree_util.tree_map(
        jnp.asarray, params_to_numpy(kd.student.state_dict()))
    tp, ts = jax.tree_util.tree_map(
        jnp.asarray, params_to_numpy(kd.teacher.state_dict()))
    batch = _batch(tcfg, classed)
    jkd = JaxKD(scfg, tcfg, share_proj=share_proj)

    def loss_of(p):
        return jkd.loss_fn(p, ss, tp, ts, batch, jax.random.PRNGKey(2),
                           train=True)

    (jl, (jrep, jstate, _)), jgrads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(sp)
    loss, (rep, new_state, _) = kd.loss_fn(port_batch(batch), _gen())
    loss.backward()
    assert set(rep) == set(jrep) == set(KD_TERMS)
    for k in rep:
        np.testing.assert_allclose(float(rep[k]), float(jrep[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    got = port_grads_as_jax(kd.student)
    assert set(got["kd_proj"]) == set(jgrads["kd_proj"])
    assert max_rel_err(jgrads, got) < GRAD_RTOL
    assert max_abs_err(jstate, port_state_as_jax(kd.student, new_state)) \
        < STATE_ATOL
    assert all(p.grad is None for p in kd.teacher.parameters())


@pytest.mark.parametrize("share_proj", [True, False],
                         ids=["shared", "per_layer"])
def test_kd_terms_present_and_finite(share_proj):
    tcfg, _, kd = _kd(share_proj, dropout=True)
    loss, (rep, _, _) = kd.loss_fn(port_batch(_batch(tcfg)), _gen(2))
    assert torch.isfinite(loss)
    for k in KD_TERMS:
        assert k in rep and torch.isfinite(rep[k]), k
    proj = kd.student.kd_proj
    n = 1 if share_proj else None
    assert len(proj.convs) == (n or 2) and len(proj.lstm) == (n or 2)
    assert len(proj.post) == (n or 2)


@pytest.mark.parametrize("off", ["output", "encoder", "decoder", "prosody",
                                 "all"])
def test_kd_toggles_remove_terms(off):
    """Each toggle removes its terms and only those; the loss is the sum
    of what is left."""
    tcfg, _, kd = _kd(dropout=True)
    groups = {"output": ["output_l1_loss", "output_mse_loss"],
              "encoder": ["encoder_loss"], "decoder": ["decoder_loss"],
              "prosody": ["prosody_loss"]}
    names = list(groups) if off == "all" else [off]
    for name in names:
        setattr(kd, f"distill_{name}", False)
    loss, (rep, _, _) = kd.loss_fn(port_batch(_batch(tcfg)), _gen(2))
    gone = {k for name in names for k in groups[name]}
    assert set(rep) == set(KD_TERMS) - gone
    parts = sum(float(v) for k, v in rep.items() if k != "loss")
    np.testing.assert_allclose(float(loss), parts, rtol=1e-6)


def test_teacher_is_frozen_through_kd_steps():
    """Three KD train steps: the teacher takes no gradient and its
    parameters and BatchNorm running statistics stay as they were (its
    new batch statistics are thrown away); the student's move."""
    tcfg, _, kd = _kd(dropout=True)
    before = {k: v.clone() for k, v in kd.teacher.state_dict().items()}
    s_before = {k: v.clone() for k, v in kd.student.state_dict().items()}
    tx = build_optimizer(lr=1e-2)
    ts = TrainState(kd.student, tx.init(list(kd.student.parameters())), 0)
    step = make_kd_train_step(kd, tx)
    batch = port_batch(_batch(tcfg, classed=True))
    for i in range(3):
        ts, report = step(ts, batch, _gen(i))
        assert torch.isfinite(report["grad_norm"])
    for k, v in kd.teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(not p.requires_grad and p.grad is None
               for p in kd.teacher.parameters())
    moved = [k for k, v in kd.student.state_dict().items()
             if not torch.equal(v, s_before[k])]
    assert any(k.startswith("kd_proj.") for k in moved)
    assert any("running_mean" in k for k in moved)  # the student's BN


def test_kd_projections_learn_and_student_trains():
    """``tests/test_kd.py:58-86``: 15 adam steps, every projection gets
    gradient, the loss falls."""
    tcfg, _, kd = _kd()
    tx = build_optimizer(lr=1e-3)
    ts = TrainState(kd.student, tx.init(list(kd.student.parameters())), 0)
    step = make_kd_train_step(kd, tx)
    batch = port_batch(_batch(tcfg))
    losses = []
    for i in range(15):
        ts, report = step(ts, batch, _gen(i))
        losses.append(float(report["loss"]))
    loss, _ = kd.loss_fn(batch, _gen(99))
    grads = torch.autograd.grad(loss, list(kd.student.kd_proj.parameters()))
    for (name, _), g in zip(kd.student.kd_proj.named_parameters(), grads):
        assert float(g.abs().max()) > 0, name
    assert losses[-1] < losses[0], losses


def test_per_layer_projections_are_distinct():
    """``tests/test_kd.py:89-106``: no two projections of equal shape are
    equal."""
    _, _, kd = _kd(share_proj=False)
    proj = kd.student.kd_proj
    mats = [lin.weight for lin in [*proj.post, proj.pemb, proj.eemb,
                                   *proj.convs, *proj.lstm]]
    for i in range(len(mats)):
        for j in range(i + 1, len(mats)):
            if mats[i].shape == mats[j].shape:
                assert not torch.equal(mats[i], mats[j]), (i, j)


# --------------------------------------------------------------------------
# the decoder's capture and remat paths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["hand_built", "remat"])
def test_decoder_capture_paths_match_autograd(path):
    """With the KD captures in the loss, zoneout 0.3 (masks from the
    per-step seeds) and prenet dropout 0.3: the hand-built backward and
    the checkpointed steps against autograd through the plain loop; the
    loss is bit-equal and the gradients agree to reduction order."""
    cfg = port_config(tiny_config(zoneout_rate=0.3, dropout_rate=0.3,
                                  postnet_layers=0))
    gen = _gen(0)
    dec = Decoder(cfg, device="cpu")
    with torch.no_grad():
        for p in dec.parameters():
            p.uniform_(-0.3, 0.3, generator=gen)
    P, D = 7, cfg.max_dur
    enc = torch.randn(P, cfg.dec_idim, generator=gen).requires_grad_(True)
    tgt = torch.randn(P, D, cfg.odim, generator=gen)
    pos = torch.linspace(0, 1, D)[None].repeat(P, 1)
    w = [torch.randn(P, D, n, generator=gen)
         for n in (cfg.odim, cfg.prenet_units, cfg.dunits, cfg.dunits)]
    variant = {"hand_built": dict(decoder_custom_vjp=True),
               "remat": dict(remat_decoder=True)}[path]
    out = []
    for c in (cfg.replace(decoder_custom_vjp=False), cfg.replace(**variant)):
        seg, pre, z0, z1 = _teacher_forced_core(dec, c, enc, tgt, pos,
                                                _gen(3), True, 7, True)
        loss = sum(((x * wx) ** 2).sum()
                   for x, wx in zip((seg, pre, z0, z1), w))
        out.append((loss.detach(), torch.autograd.grad(
            loss, [enc, *dec.parameters()])))
    (l0, g0), (l1, g1) = out
    assert float(l0) == float(l1), "the forward must be bit-identical"
    err = max(float((a - b).abs().max() / (1e-8 + a.abs().max()))
              for a, b in zip(g0, g1))
    assert err < VJP_RTOL, err


@pytest.mark.parametrize("classed", [False, True],
                         ids=["single_class", "classed"])
def test_remat_decoder_matches_the_hand_built_backward(classed):
    """The whole ``loss_fn`` with every dropout and zoneout on:
    ``remat_decoder=True`` (checkpointed autograd steps) against the
    hand-built backward: equal loss, gradients within 1e-5."""
    cfg = tiny_config(zoneout_rate=0.3)
    model = Tacotron2SA(port_config(cfg), device="cpu", seed=0)
    batch = port_batch(_batch(cfg, classed))
    params = list(model.parameters())
    out = []
    for remat in (False, True):
        model.cfg = model.cfg.replace(remat_decoder=remat)
        loss, _ = model.loss_fn(batch, _gen(5))
        out.append((float(loss), torch.autograd.grad(loss, params)))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    err = max(float((a - b).abs().max() / (1e-8 + a.abs().max()))
              for a, b in zip(g0, g1))
    assert err < VJP_RTOL, err


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_kd_snapshot_loads_in_both_packages(tmp_path):
    """A port-written KD snapshot: JAX's ``load_params_only`` with the KD
    template restores every leaf (``kd_proj`` included); its student part
    loads with a plain student template in both packages."""
    tcfg, scfg, kd = _kd(share_proj=False, use_batch_norm=False)
    tx = build_optimizer()
    ts = TrainState(kd.student, tx.init(list(kd.student.parameters())), 3)
    path = str(tmp_path / "snapshot.ep.1")
    ckpt.save_checkpoint(path, ts, 1)
    want_p, want_s = params_to_numpy(kd.student.state_dict())

    jkd = JaxKD(scfg, tcfg, share_proj=False)
    tp, tst = zeros_like_shapes(jkd.init, jax.random.PRNGKey(0))
    got_p, got_s = jax_ckpt.load_params_only(path, tp, tst)
    assert max_abs_err(want_p, np_tree(got_p)) == 0.0
    # no BatchNorm: the state holds only the empty bns lists (ROADMAP C1)
    assert jax.tree_util.tree_structure(got_s) \
        == jax.tree_util.tree_structure(want_s)

    sp, sst = zeros_like_shapes(JaxModel(scfg).init, jax.random.PRNGKey(0))
    got_p, got_s = jax_ckpt.load_params_only(path, sp, sst)
    want_p.pop("kd_proj")
    assert max_abs_err(want_p, np_tree(got_p)) == 0.0

    plain = ckpt.load_params_only(
        path, Tacotron2SA(port_config(scfg), device="cpu", seed=7))
    own = kd.student.state_dict()
    for k, v in plain.state_dict().items():
        assert torch.equal(v, own[k]), k
