"""Checks that need the card (marked ``cuda``; they skip elsewhere, the
card looked for inside a fixture): the reference's Philox keying against
the decoder kernel's own dropout draws.  Run on the card with
``python3 -m pytest -q -m cuda benchmark/tests``."""

import pytest
import torch

from benchmark.reference.philox import prenet_keep


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the decoder kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 2])
def test_philox_keying_matches_the_kernel(card, seed):
    from fcl_taco2_tpu_torch.ops.decoder_cuda import dropout_keep_mask
    for step, layer in ((0, 0), (7, 1), (49, 0)):
        kernel = dropout_keep_mask(seed, 0.5, 300, 256, step=step,
                                   layer=layer, device=card) > 0
        ref = prenet_keep(seed, 0.5, torch.arange(300, device=card), step,
                          layer, 256, device=card)
        assert torch.equal(kernel, ref)
