"""The serving BiLSTM kernel (``csrc/blstm.cu``) on the card against its
plain version, ``ops/rnn.py::bilstm`` (the loop the route replaced), run
on the card on the same inputs: the student's (H = 128), the teacher's and
Tacotron2's (H = 256) and widths that leave padded units in the last
block (H = 6, 20, 140), batches 1, 16 and 64 with ragged lengths that
include 1 and the full bucket, Tmax 32 to 128; the CUDA graph's replay
equal to the eager launch and running the weights as they are at the
replay; the launch count and the ``blstm.steps`` counter read back; and
what ``encoder_apply`` routes.
Marked ``cuda``; they skip where no GPU is present.  This file imports no
JAX: ``python -m pytest -m cuda --noconftest
tests/test_torch_port_blstm_cuda.py``."""

import pytest
import torch
import torch.nn as nn

from fcl_taco2_tpu_torch.ops import blstm_cuda as K
from fcl_taco2_tpu_torch.ops import rnn

pytestmark = pytest.mark.cuda

# bf16: both sides round at the same points and differ only in the order
# of the recurrent product's fp32 sum; a last-bit difference there flips
# one bf16 rounding of a gate, which the recurrence carries on (on these
# inputs none has: every value reads bit-equal).  fp32: the kernel's
# 3xTF32 products against cuBLAS's fp32 ones.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
MIN_EQUAL = {torch.bfloat16: 0.99, torch.float32: 0.0}  # share bit-equal


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernel has no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(H, d_in, B, T, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    cells = []
    for _ in range(2):
        c = nn.LSTMCell(d_in, H)
        with torch.no_grad():
            for p in c.parameters():
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1)
                        / H ** 0.5)
        cells.append(c.to(dev, dtype))
    xs = torch.randn(B, T, d_in, generator=g).to(dev, dtype)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0] = T
    if B > 1:
        lens[1] = 1
    return cells, xs, lens.to(dev)


def _compare(got, want):
    err = float((got.float() - want.float()).abs().max())
    equal = float((got == want).float().mean())
    return err, equal


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,d_in", [(128, 256), (256, 512), (6, 8),
                                    (20, 24), (140, 64)])
@pytest.mark.parametrize("B,T", [(1, 32), (16, 96), (16, 128), (64, 64)])
def test_kernel_matches_the_loop(cuda, H, d_in, B, T, dtype):
    cells, xs, lens = _case(H, d_in, B, T, dtype, cuda, seed=H + B + T)
    with torch.no_grad():
        got = K.bilstm_infer(*cells, xs, lens)
        want = rnn.bilstm(*cells, xs, lens)
    torch.cuda.synchronize()
    err, equal = _compare(got, want)
    print(f"H={H} B={B} T={T} {dtype}: max abs gap {err:.3e}, "
          f"{equal:.4f} bit-equal, launch {K.last_launch}")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert err <= TOL[dtype], (err, equal)
    assert equal >= MIN_EQUAL[dtype], (err, equal)
    # zeros past each row's length, as the loop's packed sequences
    pos = torch.arange(T, device=cuda)[None, :]
    assert not got[pos >= lens[:, None]].any()


def test_lengths_past_the_bucket_and_a_fault_the_tolerance_sees(cuda):
    """Lengths beyond T run T steps; the loop without the reverse
    direction's packed start (lengths dropped) is beyond the tolerance."""
    cells, xs, lens = _case(256, 512, 16, 64, torch.bfloat16, cuda)
    with torch.no_grad():
        got = K.bilstm_infer(*cells, xs, lens)
        want = rnn.bilstm(*cells, xs, lens)
        over = K.bilstm_infer(*cells, xs, torch.full_like(lens, 99))
        full = rnn.bilstm(*cells, xs, torch.full_like(lens, 64))
        fault = rnn.bilstm(*cells, xs, None)
    assert _compare(over, full)[0] <= TOL[torch.bfloat16]
    mask = (torch.arange(64, device=cuda)[None, :] < lens[:, None])[..., None]
    assert _compare(got, want)[0] <= TOL[torch.bfloat16]
    assert float(((fault * mask) - want).abs().max()) > TOL[torch.bfloat16]


def test_graph_replay_launches_and_steps(cuda):
    """Inside a ``Graphed`` capture each replay launches the kernel once,
    adds the batch's longest row to ``blstm.steps`` and equals the eager
    launch bit for bit."""
    from fcl_taco2_tpu_torch.utils.graphs import Graphed
    cells, xs, lens = _case(256, 512, 16, 128, torch.bfloat16, cuda)
    lens[0] = 101  # the loop stops short of the bucket

    def fn(inputs, gen):
        with torch.no_grad():
            return K.bilstm_infer(*cells, inputs[0], inputs[1])

    with torch.no_grad():
        eager = K.bilstm_infer(*cells, xs, lens)
    graphed = Graphed(fn, cuda, "blstm_test")
    graphed("b16", (xs, lens))  # captured, then the first replay
    before = K.bilstm_infer.launches
    replays = 3
    for _ in range(replays):
        out = graphed("b16", (xs, lens))
    torch.cuda.synchronize()
    assert K.bilstm_infer.launches - before == replays
    assert torch.equal(out, eager)
    row = graphed.stats()[0]
    steps = int(lens.max())
    assert row["launches"] == {"bilstm_infer": 1}
    assert row["counters"] == {"blstm.steps": row["replays"] * steps}, row


def test_a_graph_reads_the_weights_as_they_are(cuda):
    """The kernel reads the cells' W_hh and b_hh at each launch: weights
    changed in place after the capture are the ones the next replay runs
    (as training's evaluation changes them between replays)."""
    from fcl_taco2_tpu_torch.utils.graphs import Graphed
    cells, xs, lens = _case(128, 256, 16, 64, torch.bfloat16, cuda)

    def fn(inputs, gen):
        with torch.no_grad():
            return K.bilstm_infer(*cells, inputs[0], inputs[1])

    graphed = Graphed(fn, cuda, "blstm_weights_test")
    first = graphed("b16", (xs, lens))
    with torch.no_grad():
        for c in cells:
            c.weight_hh.mul_(-1.0)
            c.bias_hh.add_(0.25)
        want = rnn.bilstm(*cells, xs, lens)
    got = graphed("b16", (xs, lens))
    assert _compare(got, want)[0] <= TOL[torch.bfloat16]
    assert _compare(got, first)[0] > TOL[torch.bfloat16]


def test_encoder_route_on_the_card(cuda):
    """Serving (no grad, eval) launches the kernel once a layer; training
    or grad mode launches none."""
    from fcl_taco2_tpu_torch.models import encoder as E
    from fcl_taco2_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(idim=12, embed_dim=64, eunits=64, econv_layers=1,
                      econv_chans=64, econv_filts=5, elayers=2)
    enc = E.Encoder(cfg, device=cuda).to(torch.bfloat16).eval()
    tokens = torch.randint(1, 12, (3, 32), device=cuda)
    ilens = torch.tensor([32, 9, 1], device=cuda)
    n0 = K.bilstm_infer.launches
    with torch.no_grad():
        served = E.encoder_apply(enc, cfg, tokens, ilens)
    assert K.bilstm_infer.launches == n0 + 2
    trained = E.encoder_apply(enc, cfg, tokens, ilens)  # grad mode
    with torch.no_grad():
        E.encoder_apply(enc, cfg, tokens, ilens,
                        generator=torch.Generator(device=cuda), train=True,
                        bn_out=[])
    assert K.bilstm_infer.launches == n0 + 2
    assert float((served.float() - trained.float()).abs().max()) \
        <= 2 * TOL[torch.bfloat16]


def test_mixed_devices_raise(cuda):
    cells, xs, lens = _case(6, 8, 2, 8, torch.float32, cuda)
    with pytest.raises(ValueError):
        K.bilstm_infer(*cells, xs, lens.cpu())
