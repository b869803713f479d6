"""The port's bench scripts (``scripts/torch_bench*.py``,
``scripts/torch_train_roofline.py``, ``scripts/torch_make_f0_goldens.py``),
``utils/bench_protocol.py`` and ``utils/timing.py``, on the CPU: the
protocol inputs equal the JAX scripts' bit for bit, the analytic roofline
model equals JAX's, the F0 goldens generator reproduces the committed
fixture, the FLOP count of a small train step is positive and repeats,
the timers' arithmetic (spreads, clocks, the trace's split by ranges,
the merge across processes), the KD envelope failing on a crash, and
every card script refusing to run without a card."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from fcl_taco2_tpu_torch.utils import bench_protocol as BP  # noqa: E402
from fcl_taco2_tpu_torch.utils import timing  # noqa: E402

CARD_SCRIPTS = ("torch_bench", "torch_bench_kd", "torch_bench_stream",
                "torch_bench_train_loop", "torch_bench_pwg",
                "torch_bench_decoder", "torch_train_roofline")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six xdist workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_inputs_equal_bench_py(seed):
    import bench
    for got, want in zip(BP.make_inputs(seed), bench.make_inputs(seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _fields(batch):
    return {k: v for k, v in batch._asdict().items()
            if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("classes", [BP.DURATION_CLASSES, ()])
def test_train_batch_equals_bench_py(classes):
    """The port's bench train batch, its classed plan included, equals
    ``bench.py::_train_batch`` as numpy arrays."""
    import bench
    got, got_olens = BP.train_batch_arrays(BP.TRAIN_B, classes)
    want, want_olens = bench._train_batch(classes)
    np.testing.assert_array_equal(got_olens, want_olens)
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys() and len(g) >= 9
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if classes:
        assert len(got.seg_classes) == len(want.seg_classes) == len(classes)
        for gc, wc in zip(got.seg_classes, want.seg_classes):
            for a, b in zip(gc, wc):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert got.seg_classes is None and want.seg_classes is None


@pytest.mark.parametrize("B", [16, 64])
def test_roofline_model_equals_jax_script(B):
    import train_roofline as J
    import torch_train_roofline as P
    classes = BP.DURATION_CLASSES
    got_shapes, got_frames = P.class_shapes(B, classes)
    want_shapes, want_frames = J.class_shapes(B, classes)
    assert got_shapes == want_shapes and got_frames == want_frames
    assert P.analytic_model(got_shapes) == J.analytic_model(want_shapes)


def test_native_bench_batches_equal_jax_script():
    import bench_native as J
    import torch_bench_native as P
    for seed in range(P.N_BATCHES):
        for a, b in zip(P.batch(seed), J._batch(seed)):
            np.testing.assert_array_equal(a, b)
    bs, caps = P.batches()
    from fcl_taco2_tpu.ops.regroup import duration_class_caps
    want = duration_class_caps([b[0][i] for b in bs for i in range(P.B)],
                               J.CLASSES, J.B, cap_bucket=64)
    assert list(caps) == list(want) and P.CLASSES == J.CLASSES


def test_f0_goldens_generator_reproduces_fixture(tmp_path):
    import torch_make_f0_goldens as G
    out = tmp_path / "g.npz"
    G.main(["--out", str(out)])
    got, want = np.load(out), np.load(REPO / "tests" / "fixtures" /
                                      "f0_goldens.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_f0_goldens_generator_defaults_off_the_fixture(monkeypatch,
                                                      tmp_path):
    """Without ``--out`` the generator writes to the temporary directory
    and leaves the committed fixture alone."""
    import tempfile

    import torch_make_f0_goldens as G
    fixture = REPO / "tests" / "fixtures" / "f0_goldens.npz"
    before = fixture.stat().st_mtime_ns
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(G, "make_cases", lambda: {})
    G.main([])
    assert (tmp_path / "f0_goldens.npz").exists()
    assert fixture.stat().st_mtime_ns == before


def test_train_step_flops_positive_and_repeatable():
    """FlopCounterMode's count of one small eager train step (forward,
    the hand-built decoder backward, the update) is positive and the same
    on two runs."""
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train.optim import build_optimizer
    from helpers import tiny_config
    counts = []
    for _ in range(2):
        cfg = tiny_config(idim=BP.IDIM, odim=BP.ODIM, max_dur=BP.MAX_DUR,
                          duration_classes=BP.DURATION_CLASSES)
        model = Tacotron2SA(cfg, device="cpu", seed=0)
        batch, _ = BP.train_batch(2, cfg.effective_duration_classes, "cpu")
        counts.append(BP.train_step_flops(model, build_optimizer(), batch))
    assert counts[0] > 0 and counts[0] == counts[1]


def test_busy_ms_and_spread_known_answers():
    ms = 1_000_000  # ns
    events = [("a", 0, 2 * ms), ("b", 1 * ms, 3 * ms), ("c", 5 * ms, 6 * ms),
              ("d", 5 * ms, 5 * ms + ms // 2)]
    assert timing.busy_ms(events) == pytest.approx(4.0)
    assert timing.busy_ms([]) is None
    s = timing.spread([3.0, 1.0, 2.0, 10.0])
    assert s == {"median": 2.5, "min": 1.0, "max": 10.0, "n": 4}
    s = timing.spread(np.arange(1, 101, dtype=float))
    assert s["n"] == 100 and s["p90"] == pytest.approx(90.1)
    top, classes = timing.top_kernels(
        [("void at::native::vectorized_elementwise_kernel<CUDAFunctor_add>",
          0, 2 * ms), ("sm90_xmma_gemm_bf16", 2 * ms, 5 * ms)])
    assert classes["elementwise"] == (pytest.approx(2.0), 1)
    assert classes["gemm"] == (pytest.approx(3.0), 1)
    assert top[0][1] == pytest.approx(3.0)
    assert timing.bound_ms(3.35e12, 0, torch.bfloat16) == (1e3, "bytes")
    idle, gaps = timing.idle_gaps(events)
    assert idle == pytest.approx(2.0)
    assert gaps == [(pytest.approx(2.0), "b", "c")]


@pytest.mark.parametrize("name", CARD_SCRIPTS)
def test_card_scripts_raise_without_a_card(monkeypatch, tmp_path, name):
    """Each card script refuses to run without a card, before it writes
    its results file; ``timing.card`` raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    script = importlib.import_module(name)
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["--out", str(out)])
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(["--smoke", "--out", str(out)])
    assert not out.exists()
    timing.card.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.card()


def test_readings_carry_clocks_into_spread():
    """``Readings.scaled`` keeps each reading's clocks; ``spread`` gives
    their range and the clock-event reasons any reading names."""
    r = timing.Readings([10.0, 20.0, 30.0], [
        {"sm_mhz": 1980, "mem_mhz": 2619, "power_w": 300.0, "temp_c": 40,
         "reasons": 0x1},
        None,
        {"sm_mhz": 1755, "mem_mhz": 2619, "power_w": 690.0, "temp_c": 52,
         "reasons": 0x4}])
    s = timing.spread(r.scaled(0.1))
    assert s["median"] == pytest.approx(2.0) and s["n"] == 3
    assert s["clocks"] == {"sm_mhz": [1755, 1980], "mem_mhz": [2619, 2619],
                           "power_w": [300.0, 690.0], "temp_c": [40, 52],
                           "reasons": ["gpu_idle", "sw_power_cap"]}
    assert "clocks" not in timing.spread(timing.Readings([1.0], [None]))
    assert timing.clock_range([None]) is None


def test_split_by_ranges_known_answer():
    """A kernel counts for the range its launching host op started in,
    on the range's thread; the inner of two nested ranges wins; a kernel
    whose launch is unknown, or on another thread, is outside."""
    host = [("fwd", 1, 7, 100, 200), ("aten::mul", 2, 7, 110, 120),
            ("inner", 3, 7, 130, 180), ("aten::mm", 4, 7, 140, 150),
            ("aten::add", 5, 7, 210, 220), ("aten::tanh", 6, 9, 115, 125)]
    device = [("mul_kernel", 1000, 1010, 2), ("gemm", 1010, 1030, 4),
              ("add_kernel", 1030, 1040, 5), ("tanh_kernel", 1040, 1050, 6),
              ("memcpy", 1050, 1060, 0)]
    out = timing.split_by_ranges(host, device, {"fwd", "inner"})
    assert out["fwd"] == [("mul_kernel", 1000, 1010)]
    assert out["inner"] == [("gemm", 1010, 1030)]
    assert [e[0] for e in out[None]] == ["add_kernel", "tanh_kernel",
                                          "memcpy"]


def test_merge_processes_adds_the_spread_across_processes():
    def payload(m):
        return {"card": {"name": "x"}, "rows": [
            {"name": "a", "ms": {"median": m, "min": m, "max": m + 1,
                                 "n": 5, "clocks": {"reasons": []}}},
            {"name": "b", "nested": {"t": {"median": 2 * m, "min": 1.0,
                                           "max": 9.0, "n": 3}}}]}
    got = BP.merge_processes([payload(10.0), payload(12.0)])
    a = got["rows"][0]["ms"]["across_processes"]
    assert a["medians"] == [10.0, 12.0] and a["min"] == 10.0
    assert a["max"] == 12.0 and a["rel_range"] == pytest.approx(2 / 11)
    b = got["rows"][1]["nested"]["t"]["across_processes"]
    assert b["medians"] == [20.0, 24.0]
    assert got["rows"][0]["ms"]["median"] == 10.0  # the first process's
    short = payload(1.0)
    short["rows"].pop()
    with pytest.raises(ValueError, match="rows"):
        BP.merge_processes([payload(1.0), short])
    renamed = payload(1.0)
    renamed["rows"][0]["name"] = "c"
    with pytest.raises(ValueError, match="rows"):
        BP.merge_processes([payload(1.0), renamed])


@pytest.mark.parametrize("tail,oom", [
    ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate", True),
    ("RuntimeError: non-finite loss", False)])
def test_kd_envelope_stops_only_on_out_of_memory(monkeypatch, tail, oom):
    """A child that ran out of device memory ends the doubling with an
    OOM row; any other failure fails the run with the child's output."""
    import subprocess
    import types

    import torch_bench_kd as KD
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.
                        SimpleNamespace(returncode=1, stdout="",
                                        stderr=f"Traceback\n{tail}\n"))
    if oom:
        assert KD._subprocess_row(["--one", "128"])["status"] == "OOM"
    else:
        with pytest.raises(RuntimeError, match="non-finite loss"):
            KD._subprocess_row(["--one", "128"])


def test_processes_runner_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runner = importlib.import_module("torch_bench_processes")
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.main(["--out", str(out), "scripts/torch_bench.py",
                     "--train-scaling"])
    assert not out.exists()
