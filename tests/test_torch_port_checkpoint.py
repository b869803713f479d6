"""Checkpoints across the two packages, and the port's msgpack codec
against flax's.

- A port-written checkpoint restores in JAX (``restore_checkpoint``'s raw
  payload and ``load_params_only``) with params and model state exactly
  equal; a JAX-written one's weights load into the port exactly.
- ``utils/msgpack.py`` decodes ``flax.serialization.msgpack_serialize``
  output (bf16 leaves included) and flax decodes the codec's output.
- Port -> port: the optimizer state and step come back exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from fcl_taco2_tpu.train import checkpoint as jax_ckpt
from fcl_taco2_tpu.train.optim import build_optimizer as jax_optimizer
from fcl_taco2_tpu.train.state import TrainState as JaxState
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA as PortModel
from fcl_taco2_tpu_torch.train import checkpoint as ckpt
from fcl_taco2_tpu_torch.train.optim import build_optimizer
from fcl_taco2_tpu_torch.train.state import TrainState
from fcl_taco2_tpu_torch.utils import msgpack
from fcl_taco2_tpu_torch.utils.params import params_from_jax, params_to_numpy

from helpers import tiny_config
from torch_port_helpers import np_tree, port_config


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(np_tree(a))
    lb, tb = jax.tree_util.tree_flatten(np_tree(b))
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _port_state(seed=0):
    model = PortModel(port_config(tiny_config()), device="cpu", seed=seed)
    with torch.no_grad():  # non-trivial running statistics
        for name, b in model.named_buffers():
            b.copy_(torch.rand(b.shape) + (0.5 if "var" in name else 0.0))
    tx = build_optimizer()
    ts = TrainState(model, tx.init(list(model.parameters())), 7)
    with torch.no_grad():
        for t in ts.opt_state["mu"] + ts.opt_state["nu"]:
            t.uniform_(0.0, 1e-3)
    ts.opt_state["count"] = 7
    return ts


def test_port_checkpoint_restores_in_jax(tmp_path):
    ts = _port_state()
    path = str(tmp_path / "snapshot.ep.3")
    ckpt.save_checkpoint(path, ts, epoch=3, best_val=1.25)
    want_params, want_state = params_to_numpy(ts.model.state_dict())
    payload, epoch, best_val = jax_ckpt.restore_checkpoint(path)
    assert (epoch, best_val, payload["step"]) == (3, 1.25, 7)
    params, state = jax_ckpt.load_params_only(path, want_params, want_state)
    _assert_trees_equal(want_params, params)
    _assert_trees_equal(want_state, state)
    assert set(payload["opt_state"]["mu"]) == {
        n for n, _ in ts.model.named_parameters()}


def test_jax_checkpoint_loads_into_port(tmp_path):
    cfg = tiny_config()
    sd = PortModel(port_config(cfg), device="cpu", seed=1).state_dict()
    params, state = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(sd))
    tx = jax_optimizer()
    path = str(tmp_path / "model.loss.best")
    jax_ckpt.save_checkpoint(
        path, JaxState(params, state, tx.init(params), np.int32(5)), epoch=2)
    model = ckpt.load_params_only(
        path, PortModel(port_config(cfg), device="cpu", seed=2))
    want = params_from_jax(np_tree(params), np_tree(state))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_port_resume_is_exact(tmp_path):
    ts = _port_state(seed=3)
    path = str(tmp_path / "snap")
    ckpt.save_checkpoint(path, ts, epoch=4)
    fresh = _port_state(seed=4)
    got, epoch, best_val = ckpt.restore_checkpoint(path, fresh)
    assert (epoch, best_val, got.step) == (4, float("inf"), 7)
    for a, b in zip(ts.model.state_dict().values(),
                    got.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in ("mu", "nu"):
        for a, b in zip(ts.opt_state[k], got.opt_state[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got.opt_state["count"] == 7


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "bf16": jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16),
        "scalar": np.float32(2.5), "empty": np.zeros((0, 3), np.float16),
        "nested": {"0": {"x": 1, "y": -200, "z": 3.25}, "1": "text",
                   "big": 2 ** 40, "neg": -(2 ** 33), "none": None,
                   "flag": True},
        "bytes": b"\x00\x01\xff" * 100,
        "long": "s" * 300,
        "list": [1, 2.0, "three"],
    }


def test_codec_reads_flax(tmp_path):
    tree = _mixed_tree()
    got = msgpack.restore(serialization.msgpack_serialize(tree))
    for k in ("f32", "i32", "empty"):
        np.testing.assert_array_equal(got[k], tree[k])
        assert got[k].dtype == tree[k].dtype
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  np.asarray(tree["bf16"], np.float32))
    assert got["scalar"] == np.float32(2.5)
    assert got["nested"] == tree["nested"]
    assert got["bytes"] == tree["bytes"] and got["long"] == tree["long"]
    assert got["list"] == tree["list"]


def test_flax_reads_codec():
    tree = _mixed_tree()
    port_tree = dict(tree, bf16=torch.from_numpy(
        np.asarray(tree["bf16"], np.float32)).to(torch.bfloat16))
    got = serialization.msgpack_restore(msgpack.serialize(port_tree))
    for k in ("f32", "i32", "empty", "bf16"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(tree[k]))
        assert np.asarray(got[k]).dtype == np.asarray(tree[k]).dtype
    assert got["scalar"] == np.float32(2.5)
    for k in ("nested", "bytes", "long", "list"):
        assert got[k] == tree[k]
    # bytes written as flax writes them: the same encoding byte for byte
    plain = {k: v for k, v in tree.items() if k not in ("bf16", "list")}
    assert msgpack.serialize(plain) == serialization.msgpack_serialize(plain)


def test_async_writer_skips_coalesces_and_never_blocks(tmp_path,
                                                      monkeypatch):
    """While a job is in flight: droppable jobs are skipped, must-writes
    coalesce by path (the newest state wins), submit never blocks
    (``tests/test_device_transfer.py``'s contract for the JAX writer)."""
    import os
    import threading
    import time

    ts = _port_state()
    gate = threading.Event()
    real = ckpt.start_state_fetch
    calls = []

    def gated_fetch(train_state, opt_state_dtype=None):
        fin = real(train_state, opt_state_dtype=opt_state_dtype)
        first = not calls
        calls.append(1)

        def finish():
            if first:
                assert gate.wait(timeout=30), "test gate never opened"
            return fin()
        return finish

    monkeypatch.setattr(ckpt, "start_state_fetch", gated_fetch)
    w = ckpt.AsyncCheckpointWriter()
    snap1, snap2, best = (str(tmp_path / n) for n in
                          ("snapshot.ep.1", "snapshot.ep.2",
                           "model.loss.best"))
    t0 = time.perf_counter()
    assert w.submit(ts, [(snap1, 1, 2.0)])
    assert not w.submit(ts, [(snap2, 2, 2.0)], droppable=True)
    assert w.submit(ts, [(best, 2, 1.5, True)])
    ts.step = 9
    assert w.submit(ts, [(best, 3, 1.0, True)])
    assert w.skipped == 1 and w.coalesced == 1
    assert time.perf_counter() - t0 < 10, "submit must not block"
    gate.set()
    w.wait()
    payload, epoch, best_val = ckpt.restore_checkpoint(best)
    assert (epoch, best_val, payload["step"]) == (3, 1.0, 9)
    assert os.path.exists(snap1) and not os.path.exists(snap2)


def test_async_writer_reraises_background_errors(tmp_path):
    import pytest

    w = ckpt.AsyncCheckpointWriter()
    bad = tmp_path / "file_not_dir"
    bad.write_text("x")
    w.submit(_port_state(), [(str(bad / "ckpt"), 1, None)])
    with pytest.raises(OSError):
        w.wait()
    w.wait()  # the error is consumed; the writer stays usable


def test_narrowed_optimizer_state_restores_to_fp32(tmp_path):
    """ckpt_opt_dtype="bfloat16": moments stored as bf16 (flax's bfloat16
    ext), cast back to the live fp32 on restore."""
    ts = _port_state()
    path = str(tmp_path / "snap")
    w = ckpt.AsyncCheckpointWriter(opt_state_dtype="bfloat16")
    w.submit(ts, [(path, 1, None)])
    w.wait()
    raw = ckpt.read_checkpoint(path)["opt_state"]["mu"]
    assert all(v.dtype == torch.bfloat16 for v in raw.values())
    got, _, _ = ckpt.restore_checkpoint(path, _port_state(seed=5))
    for a, b in zip(ts.opt_state["mu"], got.opt_state["mu"]):
        assert b.dtype == torch.float32
        torch.testing.assert_close(a.to(torch.bfloat16).float(), b,
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# optimizer state in optax's layout: either package resumes the other's
# snapshot (ROADMAP A3.5)
# ---------------------------------------------------------------------------

TOL_INTERCHANGE = 1e-4  # the three-step limit of the optimizers' tests


def _tree_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _port_list(tree, names):
    """A JAX params-shaped tree of numpy arrays -> the port's per-parameter
    tensors (``names`` order, the port's layouts)."""
    from fcl_taco2_tpu_torch.utils.params import jax_leaf, relayout_tensor
    out = []
    for n in names:
        path, kind = jax_leaf(n)
        out.append(relayout_tensor(
            torch.from_numpy(np.array(_tree_leaf(tree, path))), kind))
    return out


def _interchange_setup(kw, n_steps, model_kw=None):
    """A tiny model's JAX trees, ``n_steps`` seeded gradient trees (JAX
    layout) and the port's and JAX's optimizers for ``kw``."""
    model = PortModel(port_config(tiny_config(**(model_kw or {}))),
                      device="cpu", seed=0)
    params, state = params_to_numpy(model.state_dict())
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: (0.1 * rng.normal(size=p.shape)).astype(np.float32),
        params) for _ in range(n_steps)]
    return model, params, state, grads, build_optimizer(**kw), \
        jax_optimizer(**kw)


_JAX_STEPS = {}  # one compiled optax step per optimizer setting


def _jax_steps(kw, params, opt_state, grads):
    import optax
    key = repr(sorted(kw.items()))
    if key not in _JAX_STEPS:
        tx = jax_optimizer(**kw)

        @jax.jit
        def step(p, s, g):
            upd, s = tx.update(g, s, p)
            return optax.apply_updates(p, upd), s
        _JAX_STEPS[key] = step
    p = jax.tree_util.tree_map(jnp.asarray, params)
    for g in grads:
        p, opt_state = _JAX_STEPS[key](
            p, opt_state, jax.tree_util.tree_map(jnp.asarray, g))
    return p, opt_state


def _port_ts(model, tx):
    names, plist = zip(*model.named_parameters())
    return TrainState(model, tx.init(plist, names), 0, tx), list(names)


def _port_steps(ts, names, grads):
    for g in grads:
        ts.tx.update(list(ts.model.parameters()), _port_list(g, names),
                     ts.opt_state)
        ts.step += 1


def _assert_port_params_close(model, jax_params):
    got = params_to_numpy(model.state_dict())[0]
    lw, tw = jax.tree_util.tree_flatten(np_tree(jax_params))
    lg, tg = jax.tree_util.tree_flatten(got)
    assert tw == tg
    for a, b in zip(lw, lg):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL_INTERCHANGE)


INTERCHANGE = {
    "adam": dict(name="adam", lr=1e-2),
    "adamw": dict(name="adam", lr=1e-2, weight_decay=0.1),
    "lamb": dict(name="lamb", lr=1e-2, weight_decay=0.01),
    "noam": dict(name="noam", lr=10.0, noam_model_size=64, noam_warmup=4),
    "accum_grad": dict(name="adam", lr=1e-2, accum_grad=2),
    "freeze_mods": dict(name="adam", lr=1e-2, weight_decay=0.1,
                        freeze_mods=["enc."]),
    "no_guard_no_clip": dict(name="adam", lr=1e-2, nan_guard=False,
                             grad_clip=0.0),
    "no_batch_norm": dict(name="adam", lr=1e-2),
}
# model configs other than tiny_config()'s, by case
INTERCHANGE_MODEL = {"no_batch_norm": dict(use_batch_norm=False)}


def _interchange_case(case):
    return INTERCHANGE[case], INTERCHANGE_MODEL.get(case, {})


@pytest.mark.parametrize("case", INTERCHANGE)
def test_port_resumes_jax_snapshot(case, tmp_path):
    """JAX steps, writes a snapshot; the port resumes it and steps once,
    equal to JAX's next step.  With ``accum_grad`` the snapshot is taken
    mid-accumulation (3 steps), so the resumed step emits."""
    kw, model_kw = _interchange_case(case)
    n = 3 if kw.get("accum_grad", 1) > 1 else 2
    model, params, state, grads, ptx, jtx = _interchange_setup(
        kw, n + 1, model_kw)
    jp0 = jax.tree_util.tree_map(jnp.asarray, params)
    jp, jopt = _jax_steps(kw, params, jtx.init(jp0), grads[:n])
    path = str(tmp_path / "snapshot.ep.1")
    jax_ckpt.save_checkpoint(path, JaxState(
        jp, jax.tree_util.tree_map(jnp.asarray, state), jopt, np.int32(n)),
        epoch=1)
    want, _ = _jax_steps(kw, np_tree(jp), jopt, grads[n:])

    fresh = PortModel(port_config(tiny_config(**model_kw)), device="cpu",
                      seed=5)
    ts, names = _port_ts(fresh, ptx)
    ts, epoch, _ = ckpt.restore_checkpoint(path, ts)
    assert (epoch, ts.step) == (1, n)
    _port_steps(ts, names, grads[n:])
    _assert_port_params_close(ts.model, want)


@pytest.mark.parametrize("case", INTERCHANGE)
def test_jax_resumes_port_snapshot(case, tmp_path):
    """The reverse: the port steps and writes (optax's layout); JAX's
    ``restore_checkpoint`` with its own template resumes it and steps
    once, equal to the port's next step.  Port -> port is exact."""
    kw, model_kw = _interchange_case(case)
    n = 3 if kw.get("accum_grad", 1) > 1 else 2
    model, params, state, grads, ptx, jtx = _interchange_setup(
        kw, n + 1, model_kw)
    ts, names = _port_ts(model, ptx)
    _port_steps(ts, names, grads[:n])
    path = str(tmp_path / "snapshot.ep.1")
    ckpt.save_checkpoint(path, ts, epoch=1)

    jp0 = jax.tree_util.tree_map(jnp.asarray, params)
    template = JaxState(jp0, jax.tree_util.tree_map(jnp.asarray, state),
                        jtx.init(jp0), np.int32(0))
    got, epoch, _ = jax_ckpt.restore_checkpoint(path, template)
    assert (epoch, int(got.step)) == (1, n)
    want = {k: [t.clone() for t in v] if isinstance(v, list) else int(v)
            for k, v in ts.opt_state.items()}
    jp, _ = _jax_steps(kw, np_tree(got.params), got.opt_state,
                       grads[n:])
    _port_steps(ts, names, grads[n:])
    _assert_port_params_close(ts.model, jp)

    again, _ = _port_ts(PortModel(port_config(tiny_config(**model_kw)),
                                  device="cpu", seed=6),
                        build_optimizer(**kw))
    again, _, _ = ckpt.restore_checkpoint(path, again)
    for k, v in want.items():
        if isinstance(v, list):
            for a, b in zip(v, again.opt_state[k]):
                torch.testing.assert_close(b, a, rtol=0, atol=0)
        else:
            assert int(again.opt_state[k]) == v, k


def test_own_layout_snapshot_restores_into_a_trainer_state(tmp_path):
    """A snapshot in the port's own layout (a ``TrainState`` without its
    optimizer, as written before the optax layout) restores into a state
    that carries one."""
    ts = _port_state(seed=3)
    path = str(tmp_path / "snap")
    ckpt.save_checkpoint(path, ts, epoch=2)
    assert "mu" in ckpt.read_checkpoint(path)["opt_state"]
    fresh, _ = _port_ts(PortModel(port_config(tiny_config()), device="cpu",
                                  seed=4), build_optimizer())
    got, epoch, _ = ckpt.restore_checkpoint(path, fresh)
    assert (epoch, got.step, int(got.opt_state["count"])) == (2, 7, 7)
    for k in ("mu", "nu"):
        for a, b in zip(ts.opt_state[k], got.opt_state[k]):
            torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_optax_layout_mismatch_raises(tmp_path):
    model, *_ = _interchange_setup({}, 0)
    ts, _ = _port_ts(model, build_optimizer(accum_grad=2))
    path = str(tmp_path / "snap")
    ckpt.save_checkpoint(path, ts)
    other, _ = _port_ts(PortModel(port_config(tiny_config()), device="cpu"),
                        build_optimizer())
    with pytest.raises(ValueError, match="optax"):
        ckpt.restore_checkpoint(path, other)
    bare = TrainState(other.model, other.opt_state, 0)
    with pytest.raises(ValueError, match="TrainState.tx"):
        ckpt.restore_checkpoint(path, bare)


def test_narrowed_optax_state_restores_to_fp32(tmp_path):
    """ckpt_opt_dtype="bfloat16" with the optimizer on the state: optax's
    moments stored as bf16, cast back to the live fp32 on restore."""
    model, *_ = _interchange_setup({}, 0)
    ts, names = _port_ts(model, build_optimizer())
    with torch.no_grad():
        for t in ts.opt_state["mu"] + ts.opt_state["nu"]:
            t.uniform_(0.0, 1e-3)
    path = str(tmp_path / "snap")
    w = ckpt.AsyncCheckpointWriter(opt_state_dtype="bfloat16")
    w.submit(ts, [(path, 1, None)])
    w.wait()
    mu = ckpt.read_checkpoint(path)["opt_state"]["inner_state"]["1"]["0"][
        "mu"]
    assert mu["encoder"]["embed"].dtype == torch.bfloat16
    fresh, _ = _port_ts(PortModel(port_config(tiny_config()), device="cpu",
                                  seed=5), build_optimizer())
    got, _, _ = ckpt.restore_checkpoint(path, fresh)
    for a, b in zip(ts.opt_state["mu"], got.opt_state["mu"]):
        assert b.dtype == torch.float32
        torch.testing.assert_close(a.to(torch.bfloat16).float(), b,
                                   rtol=0, atol=0)
