"""The regroup gathers' backward kernel (``csrc/regroup.cu``) on the card,
against its plain version, autograd's indexing backward: bit-equal where
the padded positions' gradients are zero, the sentinel row within one
rounding where they are random, the same in a CUDA graph's replay, the
launches of a teacher and a KD step, and the shapes and types it refuses.
The plans are the training cells' (batch 64, corpus-fit Lmax 1,024;
``utils/bench_protocol.py::cell_plans``): classed, single-class and a
data-parallel share.  Marked ``cuda``; they skip where no GPU is present.
This file imports no JAX: ``python -m pytest -m cuda --noconftest
tests/test_torch_port_regroup_cuda.py``."""

import numpy as np
import pytest
import torch

from fcl_taco2_tpu_torch.ops import regroup, regroup_cuda
from fcl_taco2_tpu_torch.parallel.distributed import batch_share
from fcl_taco2_tpu_torch.utils.bench_protocol import cell_plans, plan_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _gathers(plan):
    """Each gather of the cell batch's ``plan`` ("classed", "single" or
    "share": rank 1 of 2 of the classed batch) as (name, rows of x's
    leading dims, index arrays, valid): the token gathers, then the
    scatter into the class flats."""
    dur, olens, classed, single = cell_plans()
    batch = plan_batch(single if plan == "single" else classed,
                       tokens=np.ones(dur.shape, np.int32),
                       ilens=(dur > 0).sum(1).astype(np.int32), olens=olens,
                       durations=dur)
    if plan == "share":
        batch = batch_share(batch, 1, 2)
    B, T = batch.durations.shape
    classes = batch.seg_classes or (batch,)
    out = [(f"tokens{c}", (B, T), (sc.seg_utt, sc.seg_tok),
            np.asarray(sc.frame_mask)[:, 0]) for c, sc in enumerate(classes)]
    rows = sum(np.asarray(sc.frame_mask).size for sc in classes)
    out.append(("scatter", (rows,), (batch.utt_gather,), batch.utt_mask))
    return out


def _case(lead, idx, valid, C, dtype, dev, seed, pad_zero=True):
    g_ = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*lead, C, generator=g_, device=dev).to(dtype)
    idx = tuple(torch.from_numpy(np.asarray(i)).to(dev) for i in idx)
    valid = torch.from_numpy(np.asarray(valid)).to(dev)
    g = torch.randn(*valid.shape, C, generator=g_, device=dev).to(dtype)
    if pad_zero:
        g = g * valid[..., None].to(dtype)  # the padded rows' -0 and +0
    return x, idx, valid, g


def _both(x, idx, valid, g):
    """(output, gradient) through ``regroup._gather`` (the kernel) and
    through plain indexing (autograd's indexing backward)."""
    xk = x.detach().requires_grad_(True)
    out_k = regroup._gather(xk, valid, *idx)
    got = torch.autograd.grad(out_k, xk, g)[0]
    xp = x.detach().requires_grad_(True)
    out_p = xp[idx]
    want = torch.autograd.grad(out_p, xp, g)[0]
    torch.cuda.synchronize()
    return (out_k, got), (out_p, want)


@pytest.mark.parametrize("plan", ["classed", "single", "share"])
@pytest.mark.parametrize("C", [80, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_autograds_indexing_backward(cuda, plan, C, dtype):
    """Padded positions' gradients zero, as the masks make them in
    training: outputs and gradients bit-equal, one launch a gather."""
    for k, (name, lead, idx, valid) in enumerate(_gathers(plan)):
        x, idx, valid, g = _case(lead, idx, valid, C, dtype, cuda, k)
        before = regroup_cuda.gather_backward.launches
        (out_k, got), (out_p, want) = _both(x, idx, valid, g)
        assert regroup_cuda.gather_backward.launches == before + 1
        assert torch.equal(out_k, out_p), name
        assert torch.equal(got, want), name
        assert not torch.signbit(got[got == 0]).any(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sentinel_row_sums_random_padding(cuda, dtype):
    """Random gradients at the padded positions too: every row but the
    sentinel bit-equal, the sentinel within one rounding of the working
    type (after fp32 sums) of the exact sum, and the same bits twice."""
    s = regroup_cuda.SENTINEL
    for k, (name, lead, idx, valid) in enumerate(_gathers("classed")):
        x, idx, valid, g = _case(lead, idx, valid, 256, dtype, cuda, k,
                                 pad_zero=False)
        (_, got), (_, want) = _both(x, idx, valid, g)
        flat_got = got.reshape(-1, 256)
        flat_want = want.reshape(-1, 256)
        assert torch.equal(flat_got[s + 1:], flat_want[s + 1:]), name
        target = idx[0].long() * (lead[1] if len(idx) == 2 else 1)
        if len(idx) == 2:
            target = target + idx[1].long()
        terms = g.reshape(-1, 256)[target.reshape(-1) == s].double()
        exact = terms.sum(0)
        tol = (torch.finfo(dtype).eps * exact.abs()
               + len(terms) * torch.finfo(torch.float32).eps
               * terms.abs().sum(0))
        assert (flat_got[s].double() - exact).abs().le(tol).all(), name
        again = _both(x, idx, valid, g)[0][1]
        assert torch.equal(again, got), name


def test_graph_replay_is_eager(cuda):
    """Inside a ``Graphed`` capture (as the train steps run): each replay
    gives the eager gradient for fresh inputs and adds one launch."""
    from fcl_taco2_tpu_torch.utils.graphs import Graphed
    name, lead, idx_np, valid_np = _gathers("classed")[-1]
    _, idx, valid, _ = _case(lead, idx_np, valid_np, 80, torch.bfloat16,
                             cuda, 7)

    def fn(inputs, generator):
        xi = inputs["x"].detach().requires_grad_(True)
        out = regroup.scatter_frames(xi.reshape(-1, 1, 80), idx[0], valid)
        return torch.autograd.grad(out, xi, inputs["g"])[0]

    graphed = Graphed(fn, cuda, "regroup_test")
    for seed in (1, 2, 3):
        x2, _, _, g2 = _case(lead, idx_np, valid_np, 80, torch.bfloat16,
                             cuda, seed)
        inputs = {"x": x2, "g": g2}
        eager = fn(inputs, None)
        before = regroup_cuda.gather_backward.launches
        got = graphed("k", inputs)
        torch.cuda.synchronize()
        assert regroup_cuda.gather_backward.launches - before == \
            (1 if seed > 1 else 1 + graphed.warmup)
        assert torch.equal(got, eager)


@pytest.mark.parametrize("kd", [False, True])
def test_launches_a_teacher_and_a_kd_step(cuda, kd):
    """A teacher step launches 5 (four class token gathers, one scatter),
    a KD step 8 (the student's four token gathers, the output's and the
    three KD captures' scatters; the frozen teacher takes no gradient),
    eager and in each replay of the step's graph."""
    from fcl_taco2_tpu_torch.models import (Tacotron2SA, student_config,
                                            teacher_config)
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from fcl_taco2_tpu_torch.train.state import TrainState
    from fcl_taco2_tpu_torch.train.step import (loss_and_grads,
                                                make_train_step,
                                                step_generator)
    from fcl_taco2_tpu_torch.utils.bench_protocol import (DURATION_CLASSES,
                                                          IDIM, ODIM,
                                                          train_batch)
    kw = dict(odim=ODIM, duration_classes=DURATION_CLASSES)
    if kd:
        k = KDStudent(student_config(IDIM, **kw), teacher_config(IDIM, **kw),
                      device=cuda, seed=0)
        model, loss_fn, want = k.student, k.loss_fn, 8
    else:
        model = Tacotron2SA(teacher_config(IDIM, **kw), device=cuda, seed=0)
        loss_fn, want = model.loss_fn, 5
    batch, _ = train_batch(4, DURATION_CLASSES, cuda)
    before = regroup_cuda.gather_backward.launches
    loss_and_grads(model, batch, step_generator(0, 0, cuda), loss_fn)
    torch.cuda.synchronize()
    assert regroup_cuda.gather_backward.launches - before == want
    tx = build_optimizer(name="adam", lr=1e-3, grad_clip=1.0)
    ts = TrainState(model, tx.init(list(model.parameters())), 0)
    step = make_train_step(tx, loss_fn)
    ts, _ = step(ts, batch, step_generator(0, ts.step, cuda))
    before = regroup_cuda.gather_backward.launches
    for _ in range(2):
        ts, report = step(ts, batch, step_generator(0, ts.step, cuda))
    torch.cuda.synchronize()
    assert regroup_cuda.gather_backward.launches - before == 2 * want
    assert np.isfinite(float(report["loss"]))


@pytest.mark.parametrize("dtype,C,why", [
    (torch.float16, 256, "float32 or bfloat16"),
    (torch.float64, 256, "float32 or bfloat16"),
    (torch.bfloat16, 6, "16-byte"),
    (torch.float32, 81, "16-byte"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda, dtype, C,
                                                          why):
    n, rows = 64, 32
    idx = torch.randint(0, rows, (n,), device=cuda, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    g = torch.zeros(n, C, dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match=why):
        regroup_cuda.gather_backward(g, (idx,), valid, (rows,))
    x = torch.zeros(rows, 8, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="valid mask"):
        regroup._gather(x, None, idx)
