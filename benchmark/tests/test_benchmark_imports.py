"""Nothing under ``benchmark/`` imports JAX or the JAX package, compared
by whole top-level name (the port's name begins with the JAX package's,
so a prefix test would be wrong), and the plain reference imports nothing
of the program."""

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "fcl_taco2_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def _files(sub=""):
    for root, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(root, n)


def test_no_jax_anywhere_in_the_benchmark():
    found = [(p, m) for p in _files() for m in _imports(p)
             if m.split(".")[0] in FORBIDDEN]
    assert not found


def test_the_whole_name_is_compared():
    assert "fcl_taco2_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "fcl_taco2_tpu.models".split(".")[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    found = [(p, m) for p in _files("reference") for m in _imports(p)
             if m.split(".")[0] not in {"torch", "numpy", "math",
                                        "contextlib", "benchmark"}]
    assert not found
    for p in _files("reference"):
        assert all(not m.startswith("benchmark.") or
                   m.startswith("benchmark.reference")
                   for m in _imports(p)), p


def test_runtime_check_names_forbidden_modules(monkeypatch, capsys):
    import sys
    import time
    import types

    import torch

    from benchmark import harness
    from benchmark.drivers.common import ClosedLoop
    from benchmark.tests import tiny
    monkeypatch.setitem(sys.modules, "fcl_taco2_tpu.x",
                        types.ModuleType("fcl_taco2_tpu.x"))
    assert harness.forbidden_modules() == ["fcl_taco2_tpu"]
    monkeypatch.delitem(sys.modules, "fcl_taco2_tpu.x")
    monkeypatch.setitem(sys.modules, "fcl_taco2_tpu_torch_x",
                        types.ModuleType("fcl_taco2_tpu_torch_x"))
    assert "fcl_taco2_tpu" not in harness.forbidden_modules()

    # a module loaded by the output check, after the window, still stops
    # the run before its result
    real = ClosedLoop.check

    def check(self, answers=None):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(self, answers)
    monkeypatch.setattr(ClosedLoop, "check", check)
    assert "jax" not in sys.modules
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = harness.run_cell(
            harness.load_spec(tiny.ROOT), "teacher-synth-b16", 5, 0.2,
            False, time.perf_counter(), device="cpu",
            config_override=tiny.config("fcl-taco2-T", "float32"),
            mix_override=tiny.mix(batch=4))
    finally:
        torch.set_num_threads(n)
    assert rc == 3
    assert "jax" in capsys.readouterr().err
    assert harness.forbidden_modules() == ["jax"]
