"""The port's core ops against the JAX package's, fp32 on the CPU.

The same numpy inputs go through ``fcl_taco2_tpu.ops`` and
``fcl_taco2_tpu_torch.ops``; weights are re-laid out as the bridge does
(convs (W, Cin, Cout) -> (Cout, Cin, W), LSTM matrices transposed).
Tolerance 1e-5: fp32 on both sides, only the summation order differs.
"""

import numpy as np
import jax.numpy as jnp
import torch

from fcl_taco2_tpu.ops import conv as jconv
from fcl_taco2_tpu.ops import rnn as jrnn
from fcl_taco2_tpu_torch.ops import conv as pconv
from fcl_taco2_tpu_torch.ops import rnn as prnn

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _lstm_pair(rng, d_in, H):
    """The same LSTM weights as JAX LSTMParams and as an nn.LSTMCell."""
    p = {"wx": _f32(rng, d_in, 4 * H) * 0.3, "wh": _f32(rng, H, 4 * H) * 0.3,
         "bx": _f32(rng, 4 * H) * 0.1, "bh": _f32(rng, 4 * H) * 0.1}
    cell = torch.nn.LSTMCell(d_in, H)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.from_numpy(p["wx"].T))
        cell.weight_hh.copy_(torch.from_numpy(p["wh"].T))
        cell.bias_ih.copy_(torch.from_numpy(p["bx"]))
        cell.bias_hh.copy_(torch.from_numpy(p["bh"]))
    return jrnn.LSTMParams(**{k: jnp.asarray(v) for k, v in p.items()}), cell


def test_conv1d_matches_jax():
    rng = _rng(0)
    x, k, b = _f32(rng, 2, 9, 6), _f32(rng, 5, 6, 7), _f32(rng, 7)
    want = jconv.conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    got = pconv.conv1d(torch.from_numpy(x),
                       torch.from_numpy(k.transpose(2, 1, 0).copy()),
                       torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_batch_norm_eval_matches_jax():
    rng = _rng(1)
    x = _f32(rng, 3, 8, 5)
    scale, bias, mean = _f32(rng, 5), _f32(rng, 5), _f32(rng, 5)
    var = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    want, _ = jconv.batch_norm(
        jnp.asarray(x), jconv.BatchNormParams(jnp.asarray(scale),
                                              jnp.asarray(bias)),
        jconv.BatchNormState(jnp.asarray(mean), jnp.asarray(var)),
        train=False)
    got = pconv.batch_norm(*(torch.from_numpy(a)
                             for a in (x, scale, bias, mean, var)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layer_norm_matches_jax():
    rng = _rng(2)
    x, scale, bias = _f32(rng, 3, 4, 14), _f32(rng, 14), _f32(rng, 14)
    want = jconv.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias))
    got = pconv.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_lstm_cell_matches_jax():
    rng = _rng(3)
    jp, cell = _lstm_pair(rng, 6, 5)
    x, h, c = _f32(rng, 4, 6), _f32(rng, 4, 5), _f32(rng, 4, 5)
    wh, wc = jrnn.lstm_cell(jp, jnp.asarray(x), jnp.asarray(h),
                            jnp.asarray(c))
    gh, gc = prnn.lstm_cell(cell, torch.from_numpy(x), torch.from_numpy(h),
                            torch.from_numpy(c))
    np.testing.assert_allclose(gh.detach().numpy(), np.asarray(wh),
                               atol=ATOL)
    np.testing.assert_allclose(gc.detach().numpy(), np.asarray(wc),
                               atol=ATOL)


def test_bilstm_stack_matches_jax_over_lengths():
    """Two stacked bidirectional layers over ragged lengths: the reverse
    direction must see only each row's valid suffix, padding stays 0."""
    rng = _rng(4)
    j0f, p0f = _lstm_pair(rng, 6, 4)
    j0b, p0b = _lstm_pair(rng, 6, 4)
    j1f, p1f = _lstm_pair(rng, 8, 4)
    j1b, p1b = _lstm_pair(rng, 8, 4)
    xs = _f32(rng, 3, 7, 6)
    lengths = np.array([7, 4, 1], np.int32)
    want = jrnn.bilstm_stack([(j0f, j0b), (j1f, j1b)], jnp.asarray(xs),
                             jnp.asarray(lengths))
    with torch.no_grad():
        got = prnn.bilstm_stack([(p0f, p0b), (p1f, p1b)],
                                torch.from_numpy(xs),
                                torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got.numpy()[1, 4:] == 0).all() and (got.numpy()[2, 1:] == 0).all()


def test_zoneout_eval_matches_jax():
    rng = _rng(5)
    old, new = _f32(rng, 3, 5), _f32(rng, 3, 5)
    for rate in (0.0, 0.1, 0.5):
        want = jrnn.zoneout(jnp.asarray(old), jnp.asarray(new), rate,
                            train=False)
        got = prnn.zoneout(torch.from_numpy(old), torch.from_numpy(new), rate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
