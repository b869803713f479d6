"""The plans' contract that the regroup gathers' backward kernel
(``csrc/regroup.cu``, ``ops/regroup_cuda.py``) relies on, on the CPU:
every plan builder (numpy, native, a data-parallel share) gives the valid
positions distinct targets and aims every padded position at row 0; the
kernel's four steps, replayed here in PyTorch, equal autograd's indexing
backward; the CPU gathers take autograd's own backward and launch
nothing; the wrapper's checks."""

import numpy as np
import pytest
import torch

from fcl_taco2_tpu_torch.data import native
from fcl_taco2_tpu_torch.models.taco2_sa import SegClass
from fcl_taco2_tpu_torch.ops import regroup, regroup_cuda
from fcl_taco2_tpu_torch.parallel.distributed import batch_share
from fcl_taco2_tpu_torch.utils.bench_protocol import (DURATION_CLASSES,
                                                      MAX_DUR, cell_plans,
                                                      plan_batch)


def _small(seed=0, B=6, T=11):
    """A batch with zero-duration and padded tokens and padded frames."""
    rng = np.random.default_rng(seed)
    dur = rng.integers(0, 12, size=(B, T)).astype(np.int32)
    dur[:, -2:] = 0
    dur[1, 4:] = 0
    olens = dur.sum(1).astype(np.int32)
    return dur, olens, int(olens.max()) + 5


def _batch(dur, olens, plan):
    """A numpy ``Batch`` of a plan (the fields a share reads)."""
    return plan_batch(plan, tokens=np.ones(dur.shape, np.int32),
                      ilens=(dur > 0).sum(1).astype(np.int32), olens=olens,
                      durations=dur)


def _gathers(batch):
    """Each gather of a batch as (target of each position, valid, rows):
    the token gathers (one a class) into the (B, Tmax) grid, then the
    scatter into the class flats."""
    B, T = batch.durations.shape
    classes = batch.seg_classes or (SegClass(
        batch.seg_utt, batch.seg_tok, batch.seg_start, batch.frame_mask,
        batch.position),)
    out = [(np.asarray(sc.seg_utt, np.int64) * T + np.asarray(sc.seg_tok),
            np.asarray(sc.frame_mask)[:, 0], B * T) for sc in classes]
    rows = sum(np.asarray(sc.frame_mask).size for sc in classes)
    out.append((np.asarray(batch.utt_gather, np.int64).reshape(-1),
                np.asarray(batch.utt_mask).reshape(-1), rows))
    return out


def _plans(kind):
    """A classed and a single-class batch of one builder (``share``: both
    ranks' shares of two)."""
    if kind == "cell":
        dur, olens, classed, single = cell_plans()
        return [_batch(dur, olens, classed), _batch(dur, olens, single)]
    dur, olens, Lmax = _small()
    caps = regroup.duration_class_caps(list(dur), (3, 8, 12), dur.shape[0],
                                       cap_bucket=8)
    build = {"numpy": (regroup.build_classed_plan, regroup.build_plan),
             "native": (native.build_classed_plan_native,
                        native.build_plan_native)}
    if kind == "share":
        out = []
        for b in _plans("numpy"):
            out += [batch_share(b, r, 2) for r in range(2)]
        return out
    if kind == "native" and not native.native_available():
        pytest.skip("no C++ compiler here: the native plan builder is not "
                    "built")
    classed_fn, single_fn = build[kind]
    return [_batch(dur, olens,
                   classed_fn(dur, olens, (3, 8, 12), caps, Lmax)),
            _batch(dur, olens, single_fn(dur, olens, 12, 64, Lmax))]


@pytest.mark.parametrize("kind", ["numpy", "native", "share", "cell"])
def test_padded_positions_aim_at_the_sentinel(kind):
    """The contract the kernel relies on: the valid positions' targets are
    distinct and in range, and every padded position (a frame past its
    utterance, a segment of no duration) aims at row 0."""
    seen_pad = 0
    for batch in _plans(kind):
        for target, valid, rows in _gathers(batch):
            assert target.shape == valid.shape
            good = target[valid]
            assert len(np.unique(good)) == len(good)
            assert good.min(initial=0) >= 0 and good.max(initial=0) < rows
            assert (target[~valid] == regroup_cuda.SENTINEL).all()
            seen_pad += int((~valid).sum())
    assert seen_pad > 0


def _replay(g, target, valid, rows, strip=regroup_cuda.STRIP, warps=8):
    """``csrc/regroup.cu``'s four steps in PyTorch, its sums in its order:
    the inverse map, each destination row one source row or zero, each
    strip's padded rows summed by warps (positions in order within a
    warp, then the warps), the strips' sums by warps, added to the
    sentinel row and rounded once."""
    n, C = g.shape
    inv = torch.full((rows,), -1, dtype=torch.int64)
    idx = torch.arange(n)
    inv[target[valid]] = idx[valid]
    out = torch.where((inv >= 0)[:, None], g[inv.clamp(min=0)].float() + 0.0,
                      torch.zeros((), dtype=torch.float32))
    partial = []
    for lo in range(0, n, strip):
        sums = []
        for w in range(warps):
            acc = torch.zeros(C)
            for i in range(lo + w, min(n, lo + strip), warps):
                if not valid[i]:
                    acc = acc + g[i].float()
            sums.append(acc)
        tot = torch.zeros(C)
        for acc in sums:
            tot = tot + acc
        partial.append(tot)
    by_warp = []
    for w in range(warps):
        acc = torch.zeros(C)
        for p in partial[w::warps]:
            acc = acc + p
        by_warp.append(acc)
    pad = torch.zeros(C)
    for acc in by_warp:
        pad = pad + acc
    out = out.to(g.dtype)
    out[regroup_cuda.SENTINEL] = (out[regroup_cuda.SENTINEL].float()
                                  + pad).to(g.dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_schedule_is_autograds_indexing_backward(dtype):
    """On every gather of both plans: bit-equal to autograd when the
    padded positions' gradients are zero (as the masks make them in
    training), and with random ones every row but the sentinel bit-equal
    and the sentinel within one rounding of the exact sum."""
    g_ = torch.Generator().manual_seed(3)
    C = 8
    for batch in _plans("numpy"):
        for target, valid, rows in _gathers(batch):
            t = torch.from_numpy(target)
            v = torch.from_numpy(valid)
            x = torch.zeros(rows, C, dtype=dtype, requires_grad=True)
            g = torch.randn(len(t), C, generator=g_).to(dtype)
            g[::7] = -0.0
            for pad in (-torch.zeros_like(g), g):
                gg = torch.where(v[:, None], g, pad)
                want = torch.autograd.grad(x[t], x, gg)[0]
                got = _replay(gg, t, v, rows)
                s = regroup_cuda.SENTINEL
                rest = torch.arange(rows) != s
                assert torch.equal(got[rest], want[rest])
                # one rounding to the working type, after fp32 sums of k
                # terms (at most (k - 1) fp32 roundings of the partials)
                terms = gg.double()[t == s]
                exact = terms.sum(0)
                tol = (torch.finfo(dtype).eps * exact.abs()
                       + len(terms) * torch.finfo(torch.float32).eps
                       * terms.abs().sum(0))
                assert (got[s].double() - exact).abs().le(tol).all()
                if pad is not g:
                    assert torch.equal(got, want)
                    # -0 gradients come out as +0, as autograd's 0 + g
                    assert not torch.signbit(got[got == 0]).any()


def test_cpu_gathers_take_autograds_backward_and_launch_nothing():
    """On CPU tensors the gathers are plain indexing, with or without a
    valid mask, and the kernel's counter stays at 0."""
    dur, olens, Lmax = _small(1)
    plan = regroup.build_plan(dur, olens, 12, 64, Lmax)
    before = regroup_cuda.gather_backward.launches
    g_ = torch.Generator().manual_seed(0)
    hs = torch.randn(*dur.shape, 8, generator=g_, requires_grad=True)
    su, st = torch.from_numpy(plan.seg_utt), torch.from_numpy(plan.seg_tok)
    valid = torch.from_numpy(plan.frame_mask[:, 0])
    out = regroup.gather_token_vectors(hs, su, st, valid)
    cot = torch.randn(out.shape, generator=g_)
    got = torch.autograd.grad(out, hs, cot)[0]
    want = torch.autograd.grad(hs[su, st], hs, cot)[0]
    assert torch.equal(got, want)
    seg = torch.randn(64, 12, 8, generator=g_, requires_grad=True)
    gather = torch.from_numpy(plan.utt_gather)
    mask = torch.from_numpy(plan.utt_mask)
    out = regroup.scatter_frames(seg, gather, mask)
    got = torch.autograd.grad(out, seg, torch.ones_like(out))[0]
    want = torch.autograd.grad(
        seg.reshape(-1, 8)[gather] * mask[..., None], seg,
        torch.ones_like(out))[0]
    assert torch.equal(got, want)
    assert regroup_cuda.gather_backward.launches == before


def test_gather_backward_plain_is_autograds():
    """``gather_backward`` on CPU tensors is the plain version: autograd's
    indexing backward of ``x[indices]``, two indices into a grid too."""
    dur, olens, Lmax = _small(2)
    plan = regroup.build_plan(dur, olens, 12, 64, Lmax)
    g_ = torch.Generator().manual_seed(1)
    x = torch.zeros(*dur.shape, 8, requires_grad=True)
    idx = (torch.from_numpy(plan.seg_utt), torch.from_numpy(plan.seg_tok))
    valid = torch.from_numpy(plan.frame_mask[:, 0])
    g = torch.randn(len(idx[0]), 8, generator=g_)
    want = torch.autograd.grad(x[idx], x, g)[0]
    got = regroup_cuda.gather_backward(g, idx, valid, x.shape[:-1])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,C,n_idx,why", [
    (torch.float16, 8, 1, "float32 or bfloat16"),
    (torch.float64, 8, 1, "float32 or bfloat16"),
    (torch.bfloat16, 6, 1, "16-byte"),
    (torch.float32, 81, 1, "16-byte"),
    (torch.float32, 8, 3, "one or two index"),
])
def test_wrapper_checks_what_the_kernel_takes(dtype, C, n_idx, why):
    """The checks ``gather_backward`` makes before a launch (they run on
    the host, so here too)."""
    n = 10
    g = torch.zeros(n, C, dtype=dtype)
    idx = tuple(torch.zeros(n, dtype=torch.int32) for _ in range(n_idx))
    with pytest.raises(ValueError, match=why):
        regroup_cuda._check(g, idx, torch.ones(n, dtype=torch.bool),
                            (4,) * n_idx)
    regroup_cuda._check(torch.zeros(n, 8), idx[:1],
                        torch.ones(n, dtype=torch.bool), (4,))


def test_cell_plans_have_the_cells_shapes():
    """``bench_protocol.cell_plans``: batch 64, Tmax 112, the corpus-fit
    Lmax of 1,024 and ~30k padded frames, the four classes."""
    dur, olens, classed, single = cell_plans()
    assert dur.shape == (64, 112)
    assert classed.utt_gather.shape == (64, 1024)
    assert 25_000 < int((~classed.utt_mask).sum()) < 35_000
    assert tuple(c.dur_cap for c in classed.classes) == DURATION_CLASSES
    assert single.frame_mask.shape[1] == MAX_DUR
    assert (olens == dur.sum(1)).all()


def test_mechanism_script_raises_without_a_card(monkeypatch, tmp_path):
    """``scripts/torch_regroup_mechanism.py`` measures on the card only:
    without one it raises before it writes its file."""
    import importlib.util
    from pathlib import Path

    from fcl_taco2_tpu_torch.utils import timing
    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "torch_regroup_mechanism.py"
    spec = importlib.util.spec_from_file_location("regroup_mechanism", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    timing.card.cache_clear()
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["--out", str(out)])
    assert not out.exists()
