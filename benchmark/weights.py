"""Seeded weights, made on the device in two large draws.

Every tensor of a model's state dict gets its values here, by its name
and shape alone, so the program and the plain reference are handed the
same tensors:

- the phoneme embedding: N(0, 1), the padding row 0 zero;
- BatchNorm and LayerNorm scales 1, shifts 0, running means 0, running
  variances 1;
- the vocoder's smoothing taps 1 / (2s + 1) (nearest-neighbour smoothing);
- LSTM tensors U(+-1/sqrt(H)), H the cell's hidden size;
- every other weight and bias U(+-1/sqrt(fan_in)), fan_in the weight's
  elements over its output channels (PyTorch's default bounds).

Serving rounds each value to the type it is served in (bf16), so the
program's cast to its compute type is exact.
"""

import math

import torch

from benchmark.corpus import split_seed


def _kind(name):
    if name.endswith("encoder.embed.weight"):
        return "embed"
    if ".bns." in name or ".lns." in name:
        return "norm"
    if "upsample.up_layers" in name:
        return "taps"
    if name.endswith("num_batches_tracked"):
        return "count"
    return "uniform"


def _bounds(shapes):
    """The uniform bound of each tensor of kind ``uniform``."""
    out = {}
    for name, shape in shapes.items():
        if _kind(name) != "uniform":
            continue
        stem, leaf = name.rsplit(".", 1)
        if stem + ".weight_hh" in shapes:
            out[name] = 1.0 / math.sqrt(shapes[stem + ".weight_hh"][1])
            continue
        wname = stem + "." + leaf.replace("bias", "weight")
        w = shapes[wname]
        out[name] = 1.0 / math.sqrt(math.prod(w[1:]))
    return out


@torch.no_grad()
def seeded_state(module, seed, device, round_to=None, tag="weights"):
    """A state dict for ``module`` (its names and shapes) drawn from
    ``seed`` on ``device``: one uniform draw for every uniform tensor, one
    normal draw for the embedding.  ``round_to``: a dtype each value is
    rounded to (kept in the module's own dtype)."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    dtypes = {k: v.dtype for k, v in module.state_dict().items()}
    bounds = _bounds(shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(split_seed(seed, tag))
    n_uni = sum(math.prod(shapes[k]) for k in bounds)
    uni = torch.rand(n_uni, generator=gen, device=device)
    embeds = [k for k in shapes if _kind(k) == "embed"]
    n_emb = sum(math.prod(shapes[k]) for k in embeds)
    nrm = torch.randn(n_emb, generator=gen, device=device)
    out, at_u, at_n = {}, 0, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        kind = _kind(name)
        if kind == "uniform":
            t = (uni[at_u:at_u + n] * 2 - 1) * bounds[name]
            at_u += n
        elif kind == "embed":
            t = nrm[at_n:at_n + n].clone()
            at_n += n
            t.view(shape)[0] = 0.0
        elif kind == "norm":
            fill = 1.0 if name.endswith(("weight", "running_var")) else 0.0
            t = torch.full((n,), fill, device=device)
        elif kind == "taps":
            t = torch.full((n,), 1.0 / n, device=device)
        else:
            t = torch.zeros(n, device=device)
        t = t.view(shape)
        if round_to is not None and t.is_floating_point():
            t = t.to(round_to)
        out[name] = t.to(dtypes[name])
    return out
