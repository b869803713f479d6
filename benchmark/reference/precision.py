"""Rounding rules of the plain reference.

``Precision("stated")`` computes every part in the precision the
configuration states for it: products of the ``compute_dtype`` parts
(bf16) take bf16 operands, and products of the fp32 parts (the student's
decoder loop, the vocoder) are exact fp32 products with fp32 sums, TF32
off.  ``Precision("control")`` is the same computation one precision
lower, the control of the output check: the operands of every bf16
product rounded to fp8 (e4m3, one scale a tensor), the operands of every
fp32 product rounded to TF32 (10 mantissa bits, round to nearest).
The reference's products take fp32 or bf16 operands, so the rounding
follows the operand's type.
"""

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _through(x, q):
    """``q``'s values with ``x``'s gradient (the rounding of an operand
    does not round the gradient that flows back through it)."""
    return x + (q - x).detach() if x.requires_grad else q


def round_tf32(x):
    """``x`` (fp32) with its mantissa rounded to TF32's 10 bits, ties away
    from zero, as the tensor cores read an fp32 operand in TF32 mode."""
    bits = x.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return _through(x.float(), bits.view(torch.float32))


def round_fp8(x):
    """``x`` rounded to float8_e4m3fn with one scale for the tensor (its
    largest magnitude maps to the format's largest value), back in
    ``x``'s dtype."""
    d = x.detach()
    amax = d.abs().max().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (d.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return _through(x, q.to(x.dtype))


class Precision:
    """``lo(t)``: an operand of a product in the compute dtype;
    ``f32(t)``: an operand of an fp32 product; ``loop(t, dtype)``: an
    operand of a decoder-loop product."""

    def __init__(self, mode="stated"):
        if mode not in ("stated", "control"):
            raise ValueError(f"mode must be 'stated' or 'control', got "
                             f"{mode!r}")
        self.mode = mode

    def lo(self, t):
        if self.mode == "stated":
            return t
        return round_tf32(t) if t.dtype == torch.float32 else round_fp8(t)

    def f32(self, t):
        t = t.float()
        return t if self.mode == "stated" else round_tf32(t)

    def loop(self, t, dtype):
        """An operand of a decoder-loop product whose weights are stated
        in ``dtype`` (fp32 or bf16), as fp32."""
        if self.mode == "stated":
            return t.to(dtype).float()
        if dtype == torch.bfloat16:
            return round_fp8(t.to(dtype)).float()
        return round_tf32(t.float())


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls and convolutions without TF32 inside the block (the
    products of TF32-rounded operands are then exact as well)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
