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
