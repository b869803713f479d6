"""Fine-tuning: partial init from checkpoints and module freezing (port of
``fcl_taco2_tpu/train/finetune.py``).

Reference parity: ``--enc-init``/``--dec-init`` (+ ``*-init-mods``) copy
matching module subtrees from a pretrained snapshot (tts.py:353-355,
tts_train.py:258-281); ``--freeze-mods`` keeps matching parameters out of
the optimizer and out of the grad-norm clip (tts.py:380-393).

Modules are selected by prefixes of the JAX package's tree paths
(``encoder/convs/0/kernel``, ``decoder/lstm0/wx``, ...), read from each
``state_dict`` key through the weight bridge (``utils/params.py``), so one
``--freeze-mods`` string selects the same leaves in both packages.  The
reference's torch names ``enc``/``dec`` are accepted as aliases
(``"enc."`` -> ``"encoder"``, ``"dec.lstm0"`` -> ``"decoder/lstm0"``).
"""

from typing import Iterable, List, Sequence

import numpy as np
import torch

from fcl_taco2_tpu_torch.utils.params import (jax_path, params_from_jax,
                                              params_to_numpy)

_ALIASES = {"enc": "encoder", "dec": "decoder"}


def normalize_mod(mod: str) -> str:
    """``"enc."`` -> ``"encoder"``, ``"dec.lstm0"`` -> ``"decoder/lstm0"``."""
    mod = mod.strip().strip(".").strip("/").replace(".", "/")
    if not mod:
        raise ValueError("empty module prefix")
    head, sep, rest = mod.partition("/")
    return _ALIASES.get(head, head) + sep + rest


def _matches(path: str, prefixes: Sequence[str]) -> bool:
    return any(path == p or path.startswith(p + "/") for p in prefixes)


def path_str(key: str) -> str:
    """A ``state_dict`` key's JAX tree path, ``/``-joined."""
    return "/".join(str(p) for p in jax_path(key))


def freeze_mask_fn(freeze_mods: Sequence[str]):
    """Callable: parameter names (``named_parameters`` order) -> one bool
    per parameter (True = frozen)."""
    prefixes = [normalize_mod(m) for m in freeze_mods]

    def mask(names: Iterable[str]) -> List[bool]:
        return [_matches(path_str(n), prefixes) for n in names]

    return mask


def frozen_paths(model, freeze_mods: Sequence[str]) -> List[str]:
    """The JAX leaf paths a freeze spec selects, in the JAX params tree's
    leaf order (for logging; tts.py:388)."""
    prefixes = [normalize_mod(m) for m in freeze_mods]
    paths = sorted(jax_path(n) for n, _ in model.named_parameters())
    return [p for p in ("/".join(str(x) for x in t) for t in paths)
            if _matches(p, prefixes)]


def _flax(tree):
    """Lists as flax's ``{"0": ..., "1": ...}`` maps; dict keys in
    sorted order (a JAX tree's leaf order)."""
    if isinstance(tree, dict):
        return {str(k): _flax(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _flax(v) for i, v in enumerate(tree)}
    return tree


def _unflax(tree):
    """Inverse of ``_flax``: maps keyed "0".."n-1" become lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _unflax(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _copy_matching(dst: dict, src, prefixes, at: str, copied: list):
    """Copy ``src`` leaves into ``dst`` under matched prefixes, both in
    flax's state-dict form (``finetune.py:714-741``).  A matched leaf
    missing from ``src`` or of another shape raises."""
    for key, val in dst.items():
        path = f"{at}/{key}" if at else key
        if isinstance(val, dict):
            sub = src.get(key) if isinstance(src, dict) else None
            _copy_matching(val, sub if isinstance(sub, dict) else {},
                           prefixes, path, copied)
            continue
        if not _matches(path, prefixes):
            continue
        if not isinstance(src, dict) or key not in src:
            raise KeyError(
                f"checkpoint has no value for selected param {path!r}")
        new, old = _as_numpy(src[key]), np.asarray(val)
        if new.shape != old.shape:
            raise ValueError(
                f"shape mismatch for {path!r}: checkpoint "
                f"{new.shape} vs model {old.shape}")
        dst[key] = new.astype(old.dtype)
        copied.append(path)


def load_partial(model, ckpt_path: str, mods: Sequence[str]) -> List[str]:
    """Copy the ``mods`` subtrees of a checkpoint written by either
    package into ``model``'s parameters and BatchNorm statistics, in place
    (``finetune.py:744-773``).  Returns the copied leaf paths; raises when
    the prefixes select no parameter (a typo guard), on a selected leaf
    the checkpoint lacks and on a shape mismatch."""
    from fcl_taco2_tpu_torch.train.checkpoint import read_checkpoint
    prefixes = [normalize_mod(m) for m in mods]
    payload = read_checkpoint(ckpt_path)
    params, state = params_to_numpy(model.state_dict())
    dst_p, dst_s = _flax(params), _flax(state)
    copied: List[str] = []
    _copy_matching(dst_p, payload["params"], prefixes, "", copied)
    n_params = len(copied)
    _copy_matching(dst_s, payload.get("model_state", {}), prefixes, "",
                   copied)
    if n_params == 0:
        raise ValueError(
            f"init mods {list(mods)!r} matched no parameters; available "
            f"top-level modules: {sorted(dst_p)}")
    sd = params_from_jax(_unflax(dst_p), _unflax(dst_s))
    live = model.state_dict()
    with torch.no_grad():
        for k, t in live.items():
            t.copy_(sd[k].to(t.dtype))
    return copied
