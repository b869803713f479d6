"""The port's ground rules: no JAX inside it, the card by default, the
plain version only for CPU tensors, and an unbiased plain dropout."""

import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "fcl_taco2_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((REPO / "fcl_taco2_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(REPO), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_the_card(monkeypatch):
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from helpers import tiny_config
    from torch_port_helpers import port_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        Tacotron2SA(cfg)
    model = Tacotron2SA(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Synthesizer(model)


def test_cpu_decode_runs_the_plain_version(monkeypatch):
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    from fcl_taco2_tpu_torch.models.decoder import Decoder
    from helpers import tiny_config
    from torch_port_helpers import port_config

    def no_launch(**_):
        raise AssertionError("a CPU tensor reached the CUDA launch")

    monkeypatch.setattr(K, "_launch", no_launch)
    cfg = port_config(tiny_config(dunits=256, max_dur=5))
    dp = Decoder(cfg, device="cpu").jax_layout()
    gen = torch.Generator().manual_seed(0)
    enc = torch.randn(6, cfg.dec_idim, generator=gen)
    pos = torch.rand(6, 5, generator=gen)
    before = (K.fused_ar_decode.launches, K.fused_ar_decode_hbm.launches)
    with torch.no_grad():
        for fn, plain in ((K.fused_ar_decode, K.fused_ar_decode_plain),
                          (K.fused_ar_decode_hbm,
                           K.fused_ar_decode_hbm_plain)):
            got = fn(dp, enc, pos, 3, dropout=0.5)
            want = plain(dp, enc, pos, 3, dropout=0.5)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (K.fused_ar_decode.launches,
            K.fused_ar_decode_hbm.launches) == before


def test_plain_prenet_dropout_keep_rate():
    from fcl_taco2_tpu_torch.models.components import prenet_dropout

    x = torch.ones(1024, 1024)
    for rate in (0.1, 0.5, 0.9):
        m = prenet_dropout(x, rate, torch.Generator().manual_seed(0))
        keep = (m > 0).float().mean().item()
        assert abs(keep - (1 - rate)) < 5e-3, (rate, keep)
        torch.testing.assert_close(m[m > 0],
                                   torch.full_like(m[m > 0], 1 / (1 - rate)))
