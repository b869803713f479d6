"""Fine-tuning in the port (``train/finetune.py``, ``utils/summary.py``,
the freeze mask of ``train/optim.py``) against the JAX package's
``fcl_taco2_tpu/train/finetune.py`` and ``utils/summary.py`` on the same
trees: module prefixes, the frozen leaves, ``load_partial`` from a
JAX-written and a port-written checkpoint (BatchNorm state included, and
its three errors), the parameter counts, and the trainer's and
``fcl_train``'s ``--enc-init``/``--freeze-mods`` wiring (as
``tests/test_finetune.py`` does for the JAX package)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcl_taco2_tpu.models import Tacotron2SA as JaxModel
from fcl_taco2_tpu.models.config import student_config as jax_student
from fcl_taco2_tpu.models.config import teacher_config as jax_teacher
from fcl_taco2_tpu.train import finetune as jft
from fcl_taco2_tpu.train.checkpoint import save_checkpoint as jax_save
from fcl_taco2_tpu.train.optim import build_optimizer as jax_optimizer
from fcl_taco2_tpu.train.state import TrainState as JaxState
from fcl_taco2_tpu.train.step import make_train_step as jax_train_step
from fcl_taco2_tpu.utils import summary as jsummary
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA as PortModel
from fcl_taco2_tpu_torch.train import checkpoint as ckpt
from fcl_taco2_tpu_torch.train import finetune as pft
from fcl_taco2_tpu_torch.train.optim import build_optimizer
from fcl_taco2_tpu_torch.train.state import TrainState
from fcl_taco2_tpu_torch.train.step import make_train_step
from fcl_taco2_tpu_torch.utils import summary as psummary
from fcl_taco2_tpu_torch.utils.params import params_to_numpy

from helpers import synthetic_batch, tiny_config
from torch_port_helpers import (NO_DROPOUT, max_abs_err, np_tree,
                                port_batch, port_config, port_model)

MODS = ["enc.", "dec.lstm0", "duration_predictor"]


def _jax_trees(model):
    """The port model's weights as the JAX package's (params, state)."""
    params, state = params_to_numpy(model.state_dict())
    return (jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state))


def _assert_trees_equal(a, b):
    la, lb = (jax.tree_util.tree_leaves(np_tree(t)) for t in (a, b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_normalize_mod_matches_jax():
    for mod in ("enc.", "dec.lstm0", "duration_predictor", "encoder/convs",
                "dec/postnet.", " decoder.feat_out "):
        assert pft.normalize_mod(mod) == jft.normalize_mod(mod), mod
    assert pft.normalize_mod("enc.") == "encoder"
    assert pft.normalize_mod("dec.lstm0") == "decoder/lstm0"
    with pytest.raises(ValueError):
        pft.normalize_mod(".")


@pytest.mark.parametrize("mod", MODS)
def test_frozen_paths_match_jax(mod):
    model = PortModel(port_config(tiny_config()), device="cpu", seed=0)
    params, _ = _jax_trees(model)
    got = pft.frozen_paths(model, [mod])
    assert got and got == jft.frozen_paths(params, [mod])
    mask = pft.freeze_mask_fn([mod])(n for n, _ in model.named_parameters())
    assert sum(mask) == len(got)


def _steps(freeze, weight_decay, n=3, with_jax=True):
    """``n`` port (and, ``with_jax``, JAX) steps (adamw when
    ``weight_decay``, clip 1.0, dropouts 0) from the same weights;
    returns (port params before, port model after, JAX params after or
    None)."""
    cfg = tiny_config(**NO_DROPOUT)
    jm = JaxModel(cfg)
    params, state = jm.init(jax.random.PRNGKey(0))
    batch = synthetic_batch(cfg)
    jts = jstep = None
    if with_jax:
        tx = jax_optimizer(lr=1e-2, weight_decay=weight_decay,
                           freeze_mods=freeze)
        jts = JaxState(params, state, tx.init(params), np.int32(0))
        jstep = jax_train_step(jm, tx, donate=False)
    pm = port_model(cfg, params, state)
    before = {k: v.clone() for k, v in pm.named_parameters()}
    ptx = build_optimizer(lr=1e-2, weight_decay=weight_decay,
                          freeze_mods=freeze)
    names, plist = zip(*pm.named_parameters())
    pts = TrainState(pm, ptx.init(plist, names), 0)
    pstep = make_train_step(ptx)
    pb = port_batch(batch)
    for i in range(n):
        if jstep is not None:
            jts, _ = jstep(jts, batch, jax.random.PRNGKey(i))
        pts, report = pstep(pts, pb, torch.Generator().manual_seed(i))
    assert np.isfinite(float(report["loss"]))
    return before, pm, None if jts is None else jts.params


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_frozen_modules_do_not_move(weight_decay):
    """Three steps with ``enc.`` and ``duration_predictor`` frozen: the
    frozen parameters are bit-unchanged, every other one moved, under
    adamw's decay too, and the parameters stay within 1e-4 of JAX's
    (the clip's norm covers the trainable set only in both)."""
    freeze = ["enc.", "duration_predictor"]
    before, pm, jparams = _steps(freeze, weight_decay)
    for name, p in pm.named_parameters():
        frozen = name.startswith(("encoder.", "duration_predictor."))
        assert torch.equal(p, before[name]) == frozen, name
    ported = params_to_numpy(
        {n: p.detach() for n, p in pm.named_parameters()})[0]
    assert max_abs_err(np_tree(jparams), ported) < 1e-4


def test_freeze_everything_is_a_noop_update():
    mods = ["encoder", "decoder", "duration_predictor", "pitch_predictor",
            "energy_predictor", "pitch_embed", "energy_embed"]
    before, pm, _ = _steps(mods, 0.01, n=1, with_jax=False)
    for name, p in pm.named_parameters():
        assert torch.equal(p, before[name]), name


def test_nan_in_a_frozen_subtree_does_not_veto_the_step():
    """The freeze mask sits outside the non-finite guard
    (``optim.py:68-76``): a NaN gradient confined to a frozen tensor is
    zeroed before the guard, so the step is applied and not counted."""
    model = PortModel(port_config(tiny_config()), device="cpu", seed=0)
    names, params = zip(*model.named_parameters())
    tx = build_optimizer(lr=1e-2, freeze_mods=["enc."])
    state = tx.init(params, names)
    before = [p.detach().clone() for p in params]
    grads = [torch.full_like(p, 0.1) for p in params]
    bad = names.index("encoder.embed.weight")
    grads[bad][0, 0] = float("nan")
    tx.update(list(params), grads, state)
    assert int(state["count"]) == 1
    assert int(state["total_notfinite"]) == 0
    for n, p, b in zip(names, params, before):
        assert torch.equal(p, b) == n.startswith("encoder."), n
    # the same NaN in a trainable tensor skips the step
    grads[names.index("decoder.feat_out.weight")][0, 0] = float("nan")
    moved = [p.detach().clone() for p in params]
    tx.update(list(params), grads, state)
    assert int(state["total_notfinite"]) == 1 and int(state["count"]) == 1
    for p, b in zip(params, moved):
        assert torch.equal(p, b)


def test_init_without_names_raises_for_a_freeze():
    model = PortModel(port_config(tiny_config()), device="cpu", seed=0)
    with pytest.raises(ValueError, match="names"):
        build_optimizer(freeze_mods=["enc."]).init(list(model.parameters()))


def _donor(tmp_path, writer, cfg=None, seed=7):
    """A donor checkpoint written by ``writer`` ("jax" or "port")."""
    cfg = cfg or tiny_config()
    path = str(tmp_path / f"donor_{writer}_{seed}")
    if writer == "jax":
        p, s = JaxModel(cfg).init(jax.random.PRNGKey(seed))
        jax_save(path, JaxState(p, s, (), np.int32(0)))
    else:
        model = PortModel(port_config(cfg), device="cpu", seed=seed)
        with torch.no_grad():  # non-trivial BatchNorm statistics
            for name, b in model.named_buffers():
                b.copy_(torch.rand(b.shape) + (0.5 if "var" in name
                                               else 0.0))
        names, params = zip(*model.named_parameters())
        ckpt.save_checkpoint(path, TrainState(
            model, build_optimizer().init(params, names), 0))
    return path


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mods", [["enc."], ["decoder/lstm0"],
                                  ["enc.", "dec."]],
                         ids=["enc", "dec_lstm0", "enc_dec"])
def test_load_partial_matches_jax(tmp_path, writer, mods):
    path = _donor(tmp_path, writer)
    model = PortModel(port_config(tiny_config()), device="cpu", seed=0)
    params, state = _jax_trees(model)
    want_p, want_s, want_copied = jft.load_partial(params, state, path,
                                                   mods)
    copied = pft.load_partial(model, path, mods)
    assert copied == want_copied and copied
    got_p, got_s = params_to_numpy(model.state_dict())
    _assert_trees_equal(want_p, got_p)
    _assert_trees_equal(want_s, got_s)
    if "enc." in mods:  # BatchNorm statistics ride along
        assert any(p.startswith("encoder/convs/bns") and "mean" in p
                   for p in copied)


def test_load_partial_errors_match_jax(tmp_path):
    path = _donor(tmp_path, "port")
    model = PortModel(port_config(tiny_config()), device="cpu", seed=0)
    params, state = _jax_trees(model)
    cases = [
        (path, ["no_such_module"], ValueError, "matched no parameters"),
        (_donor(tmp_path, "port", tiny_config(eunits=24)), ["enc."],
         ValueError, "shape mismatch"),
        (_donor(tmp_path, "jax", tiny_config(use_batch_norm=False)),
         ["enc."], KeyError, "has no value"),
    ]
    for p, mods, exc, match in cases:
        with pytest.raises(exc, match=match):
            jft.load_partial(params, state, p, mods)
        with pytest.raises(exc, match=match):
            pft.load_partial(model, p, mods)


@pytest.mark.parametrize("which", ["teacher", "student"])
def test_param_counts_match_jax(which):
    from fcl_taco2_tpu_torch.models.config import (student_config,
                                                   teacher_config)
    jcfg = (jax_teacher if which == "teacher" else jax_student)(70, odim=80)
    pcfg = (teacher_config if which == "teacher" else student_config)(
        70, odim=80)
    shapes = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))[0]
    model = PortModel(pcfg, device="cpu", seed=0)
    assert psummary.param_counts(model) == jsummary.param_counts(shapes)
    assert psummary.format_param_report(model) == \
        jsummary.format_param_report(shapes)


TINY = ["--embed-dim", "16", "--eunits", "16", "--econv-chans", "16",
        "--dunits", "20", "--prenet-units", "12", "--postnet-chans", "10",
        "--duration-predictor-chans", "14", "--max-dur", "6",
        "--duration-classes", "3", "--compute-dtype", "float32",
        "--batch-size", "3", "--device", "cpu"]


def test_fcl_train_wires_finetune_flags(tmp_path):
    """``fcl_train --enc-init --freeze-mods enc.`` (as
    ``tests/test_finetune.py:137``): the encoder is the donor's after the
    epoch, bit for bit, and the decoder trained away from it."""
    from fcl_taco2_tpu_torch.cli.fcl_train import main
    from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
    from fcl_taco2_tpu_torch.models.config import ModelConfig
    train, valid = write_learnable_corpus(str(tmp_path), 6, 2)
    base = ["--train-json", train, "--valid-json", valid, *TINY]
    donor_dir = str(tmp_path / "donor")
    main(base + ["--outdir", donor_dir, "--epochs", "1", "--seed", "7"])
    donor = os.path.join(donor_dir, "snapshot.ep.1")
    cfg, _ = ckpt.load_model_json(donor_dir)
    assert isinstance(cfg, ModelConfig)
    ref = ckpt.load_params_only(donor, PortModel(cfg, device="cpu"))
    ts = main(base + ["--outdir", str(tmp_path / "ft"), "--epochs", "1",
                      "--enc-init", donor, "--dec-init", donor,
                      "--dec-init-mods", "dec.lstm0",
                      "--freeze-mods", "enc."])
    assert ts.step > 0
    want = dict(ref.named_parameters())
    for name, p in ts.model.named_parameters():
        if name.startswith("encoder."):
            assert torch.equal(p, want[name]), name
    assert not torch.equal(ts.model.decoder.lstm[0].weight_hh,
                           want["decoder.lstm.0.weight_hh"])
