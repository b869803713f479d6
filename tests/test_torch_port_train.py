"""The port's training forward and backward against the JAX package.

Same config, weights and numpy inputs in both packages (fp32, every
dropout and zoneout at 0): ``Tacotron2SA.loss_fn`` (loss, report terms,
every gradient leaf, new BatchNorm statistics) on the single-class and
classed plans and the masking / reduction / conditioning variants; the
hand-built decoder backward (``ops/rnn_vjp.py``) against autograd through
the plain loop; three ``make_train_step`` steps against JAX's; and the
keep rates of the zoneout train masks and the train dropouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcl_taco2_tpu.models import Tacotron2SA as JaxModel
from fcl_taco2_tpu.train.optim import build_optimizer as jax_optimizer
from fcl_taco2_tpu.train.state import TrainState as JaxState
from fcl_taco2_tpu.train.step import make_train_step as jax_train_step
from fcl_taco2_tpu_torch.models.components import maybe_dropout
from fcl_taco2_tpu_torch.models.decoder import Decoder, _teacher_forced_core
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA as PortModel
from fcl_taco2_tpu_torch.ops.rnn import zoneout_keep_masks
from fcl_taco2_tpu_torch.train.optim import build_optimizer
from fcl_taco2_tpu_torch.train.state import TrainState
from fcl_taco2_tpu_torch.train.step import make_train_step
from fcl_taco2_tpu_torch.utils.params import params_to_numpy

from helpers import synthetic_batch, tiny_config, with_duration_classes
from torch_port_helpers import (NO_DROPOUT, max_abs_err, max_rel_err,
                                np_tree, port_batch, port_config,
                                port_grads_as_jax, port_model,
                                port_state_as_jax)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4   # max|a-b| / max|a| per leaf
STATE_ATOL = 1e-5
VJP_RTOL = 1e-5


def _setup(classed=False, **variant):
    """Config, JAX model, weights (drawn by the port's initializer, which
    is faster than JAX's on the CPU, and handed to JAX through the bridge)
    and a synthetic batch."""
    cfg = tiny_config(**NO_DROPOUT, **variant)
    jm = JaxModel(cfg)
    sd = PortModel(port_config(cfg), device="cpu", seed=0).state_dict()
    params, state = jax.tree_util.tree_map(jnp.asarray,
                                           params_to_numpy(sd))
    batch = synthetic_batch(cfg, B=3, Tmax=5, seed=1)
    if classed:
        batch = with_duration_classes(batch, (3, cfg.max_dur))
    return cfg, jm, params, state, batch


@pytest.mark.parametrize("variant", [
    {},
    {"classed": True},
    {"use_weighted_masking": True, "use_masking": False},
    {"reduction_factor": 2},
    {"use_fe_condition": False},
], ids=["single_class", "classed", "weighted", "r2", "no_fe"])
def test_loss_fn_and_grads_match_jax(variant):
    cfg, jm, params, state, batch = _setup(**variant)

    def loss_of(p):
        return jm.loss_fn(p, state, batch, jax.random.PRNGKey(2),
                          train=True)

    (jl, (jrep, jstate, _)), jgrads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(params)
    pm = port_model(cfg, params, state)
    loss, (rep, new_state, _) = pm.loss_fn(
        port_batch(batch), torch.Generator().manual_seed(0), train=True)
    loss.backward()
    assert set(rep) == set(jrep)
    for k in rep:
        np.testing.assert_allclose(float(rep[k]), float(jrep[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert max_rel_err(jgrads, port_grads_as_jax(pm)) < GRAD_RTOL
    assert max_abs_err(jstate, port_state_as_jax(pm, new_state)) \
        < STATE_ATOL


def test_bf16_policy_keeps_fp32_gradients():
    """compute_dtype=bfloat16: a differentiable cast of the fp32 masters,
    so the gradients land in fp32 on them; the loss stays near fp32's."""
    cfg, _, params, state, batch = _setup()
    losses = {}
    for dtype in ("float32", "bfloat16"):
        pm = port_model(cfg.replace(compute_dtype=dtype), params, state)
        loss, _ = pm.loss_fn(port_batch(batch),
                             torch.Generator().manual_seed(0))
        loss.backward()
        assert loss.dtype == torch.float32
        for p in pm.parameters():
            assert p.dtype == torch.float32
            assert p.grad.dtype == torch.float32
            assert torch.isfinite(p.grad).all()
        losses[dtype] = float(loss)
    assert abs(losses["bfloat16"] - losses["float32"]) \
        < 3e-2 * losses["float32"]


# bf16 rounding order differs between XLA and PyTorch (fused biases, excess
# precision inside XLA fusions), so the two bf16 runs differ by rounding
# noise of the same size as bf16's own distance from fp32 (loss 7e-4, terms
# up to 6e-3, gradients 0.09 in global relative norm, on this setup).  The
# values below hold the bf16 run to JAX's at that noise level; the cast
# policy itself (which products run in bf16) is held op by op.
BF16_TERM_RTOL = 1e-2
BF16_GRAD_RTOL = 0.2    # |g - g_jax| / |g_jax| over all leaves together
BF16_STATE_ATOL = 1e-2
_PRODUCTS = ("convolution", "convolution_backward", "mm", "addmm", "bmm")


def _global_rel_err(ref, got):
    leaves = jax.tree_util.tree_leaves
    a = np.concatenate([np.asarray(x, np.float64).ravel()
                        for x in leaves(ref)])
    b = np.concatenate([np.asarray(x, np.float64).ravel()
                        for x in leaves(got)])
    return np.linalg.norm(a - b) / np.linalg.norm(a)


@pytest.mark.parametrize("classed", [False, True],
                         ids=["single_class", "classed"])
def test_bf16_policy_matches_jax(classed):
    """compute_dtype=bfloat16 against JAX's loss_fn (taco2_sa.py:183-195)
    on the same weights and batch, and the policy op by op: every conv
    and matrix product of the forward and the backward takes bf16
    operands and gives bf16; the loss is fp32 and the gradients land in
    fp32 on the fp32 masters."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg, _, params, state, batch = _setup(classed=classed)
    cfg = cfg.replace(compute_dtype="bfloat16")
    jm = JaxModel(cfg)

    def loss_of(p):
        return jm.loss_fn(p, state, batch, jax.random.PRNGKey(2),
                          train=True)

    (jl, (jrep, jstate, _)), jgrads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(params)

    products = []

    class LogProducts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in _PRODUCTS:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                products.append((name, {
                    t.dtype for t in (*args, *outs)
                    if isinstance(t, torch.Tensor) and t.is_floating_point()
                }))
            return out

    pm = port_model(cfg, params, state)
    with LogProducts():
        loss, (rep, new_state, _) = pm.loss_fn(
            port_batch(batch), torch.Generator().manual_seed(0), train=True)
        loss.backward()
    names = {n for n, _ in products}
    assert {"convolution", "convolution_backward", "mm"} <= names, names
    assert all(d == {torch.bfloat16} for _, d in products), \
        [p for p in products if p[1] != {torch.bfloat16}]
    assert loss.dtype == torch.float32
    for p in pm.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    for v in new_state.values():
        assert v.dtype == torch.float32

    for k in rep:
        np.testing.assert_allclose(float(rep[k]), float(jrep[k]),
                                   rtol=BF16_TERM_RTOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jl), rtol=BF16_TERM_RTOL)
    assert _global_rel_err(jgrads, port_grads_as_jax(pm)) < BF16_GRAD_RTOL
    assert max_abs_err(jstate, port_state_as_jax(pm, new_state)) \
        < BF16_STATE_ATOL


@pytest.mark.parametrize("variant", [
    {},
    {"append_position": False},
    {"use_concate": False},
    {"prenet_layers": 0},
    {"dlayers": 1},
    {"dlayers": 3},
    {"reduction_factor": 2, "max_dur": 6},
    {"zoneout_rate": 0.0},
    {"zoneout_rate": 0.5},
    {"P": 37},
])
def test_hand_built_backward_matches_autograd(variant):
    """The variant list of tests/test_decoder_vjp.py:30-41 (less its
    zoneout_rng and scan-unroll cases, which the port does not read, and
    with a heavy zoneout and a wider segment batch instead), with
    train-mode prenet dropout and zoneout masks: the custom Function's loss
    is bit-equal to the plain loop's and its gradients agree to reduction
    order."""
    variant = dict(variant)
    P = variant.pop("P", 5)
    cfg = port_config(tiny_config(postnet_layers=0, **variant))
    gen = torch.Generator().manual_seed(0)
    dec = Decoder(cfg, device="cpu")
    with torch.no_grad():
        for p in dec.parameters():
            p.uniform_(-0.3, 0.3, generator=gen)
    D = cfg.max_dur
    enc = torch.randn(P, cfg.dec_idim, generator=gen)
    tgt = torch.randn(P, D, cfg.odim, generator=gen)
    pos = torch.linspace(0, 1, D)[None].repeat(P, 1)
    enc.requires_grad_(True)
    out = []
    for custom in (False, True):
        c = cfg.replace(decoder_custom_vjp=custom)
        seg = _teacher_forced_core(dec, c, enc, tgt, pos,
                                   torch.Generator().manual_seed(3), True, 7)
        loss = (seg ** 2).sum() + 0.1 * seg.abs().sum()
        out.append((loss.detach(), torch.autograd.grad(
            loss, [enc, *dec.parameters()])))
    (l0, g0), (l1, g1) = out
    assert float(l0) == float(l1), "the forward must be bit-identical"
    err = max(float((a - b).abs().max() / (1e-8 + a.abs().max()))
              for a, b in zip(g0, g1))
    assert err < VJP_RTOL, err


def test_train_steps_match_jax():
    """Three make_train_step steps (adam, clip 1.0) from the same weights
    and batch: the parameters stay within 1e-4 of JAX's."""
    cfg, jm, params, state, batch = _setup(classed=True)
    tx = jax_optimizer(lr=1e-2)
    jts = JaxState(params, state, tx.init(params), np.int32(0))
    jstep = jax_train_step(jm, tx, donate=False)
    pm = port_model(cfg, params, state)
    ptx = build_optimizer(lr=1e-2)
    pts = TrainState(pm, ptx.init(list(pm.parameters())), 0)
    pstep = make_train_step(ptx)
    pb = port_batch(batch)
    for i in range(3):
        jts, jrep = jstep(jts, batch, jax.random.PRNGKey(i))
        pts, prep = pstep(pts, pb, torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(prep["grad_norm"]),
                                   float(jrep["grad_norm"]), rtol=1e-4)
    assert pts.step == 3
    ported = port_grads_as_jax(pm, [p.detach() for p in pm.parameters()])
    assert max_abs_err(np_tree(jts.params), ported) < 1e-4
    assert max_abs_err(np_tree(jts.model_state), port_state_as_jax(pm)) \
        < 1e-4


def test_zoneout_keep_rate_and_reseed():
    """Bernoulli(rate) keep-old masks (torch's Philox can't match JAX's
    bits; the rate is what must match), a function of the seed alone."""
    gen = torch.Generator()
    for rate in (0.1, 0.5, 0.9):
        m = zoneout_keep_masks(gen, 11, 4, 256, 256, rate)
        assert m.dtype == torch.bool and m.shape == (4, 256, 256)
        assert abs(m.float().mean().item() - rate) < 5e-3, rate
    a = zoneout_keep_masks(gen, 5, 2, 64, 64, 0.3)
    zoneout_keep_masks(gen, 6, 2, 64, 64, 0.3)
    assert torch.equal(a, zoneout_keep_masks(gen, 5, 2, 64, 64, 0.3))


def test_train_dropout_keep_rate():
    """The train-mode dropouts: keep fraction 1-rate, kept values scaled
    by 1/(1-rate) (unbiased), nothing drawn in eval mode."""
    x = torch.ones(1024, 1024)
    gen = torch.Generator().manual_seed(0)
    for rate in (0.1, 0.5, 0.9):
        m = maybe_dropout(x, rate, gen, train=True)
        assert abs((m > 0).float().mean().item() - (1 - rate)) < 5e-3
        assert abs(m.mean().item() - 1.0) < 2e-2
        torch.testing.assert_close(m[m > 0],
                                   torch.full_like(m[m > 0], 1 / (1 - rate)))
        assert maybe_dropout(x, rate, gen, train=False) is x
