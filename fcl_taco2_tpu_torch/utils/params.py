"""Weight bridge between the JAX package's param/state trees and the port's
modules.

The JAX trees are nested dicts/lists of numpy arrays in the JAX layout:
matrices ``(in, out)``, conv kernels ``(W, Cin, Cout)``, LSTM ``wx``/``wh``
(gates packed i, f, g, o) with both ``bx`` and ``bh``, BatchNorm
``scale``/``bias`` plus running ``mean``/``var`` in the state tree,
LayerNorm ``scale``/``bias``.  The port's side is a ``state_dict`` of
``Tacotron2SA`` in PyTorch layouts (``nn.Linear`` ``(out, in)``,
``nn.Conv1d`` ``(Cout, Cin, W)``, ``nn.LSTMCell`` ``weight_ih``...).
Both directions are pure re-layouts, so a round trip is exact.
"""

import re

import numpy as np
import torch

# JAX leaf name -> (torch leaf name, layout change)
_LEAVES = {
    "kernel": ("weight", "conv"), "w": ("weight", "T"), "b": ("bias", None),
    "scale": ("weight", None), "bias": ("bias", None),
    "wx": ("weight_ih", "T"), "wh": ("weight_hh", "T"),
    "bx": ("bias_ih", None), "bh": ("bias_hh", None),
    "mean": ("running_mean", None), "var": ("running_var", None),
}
_LSTM_LEAVES = {"weight_ih": "wx", "weight_hh": "wh", "bias_ih": "bx",
                "bias_hh": "bh"}


def _relayout(arr, kind):
    """Both layout changes are their own inverse."""
    if kind == "T":
        arr = arr.T
    elif kind == "conv":
        arr = arr.transpose(2, 1, 0)
    return np.array(arr, order="C", copy=True)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (i,))
    else:
        yield prefix, tree


def _torch_key(path):
    """JAX tree path -> (state_dict key, layout change)."""
    mods, leaf = [str(p) for p in path[:-1]], path[-1]
    out, i = [], 0
    while i < len(mods):
        m = mods[i]
        if m in ("blstm_fwd", "blstm_bwd"):
            out += ["blstm", "0", m[len("blstm_"):]]
        elif m == "blstm_extra":
            out += ["blstm", str(int(mods[i + 1]) + 1)]
            i += 1
        elif re.fullmatch(r"lstm\d+", m):
            out += ["lstm", m[len("lstm"):]]
        else:
            out.append(m)
        i += 1
    if leaf == "embed":
        return ".".join(out + ["embed", "weight"]), None
    name, kind = _LEAVES[leaf]
    return ".".join(out + [name]), kind


def _jax_path(key):
    """state_dict key -> (JAX tree path, layout change, is a state leaf)."""
    parts = key.split(".")
    mods, leaf = parts[:-1], parts[-1]
    if mods[0] == "kd_proj":  # KD projections: bias-free {"w": (in, out)}
        return (tuple(int(m) if m.isdigit() else m for m in mods)
                + ("w",)), "T", False
    out, i = [], 0
    while i < len(mods):
        m = mods[i]
        if m == "blstm":
            layer, d = int(mods[i + 1]), mods[i + 2]
            out += [f"blstm_{d}"] if layer == 0 else ["blstm_extra",
                                                      layer - 1, d]
            i += 3
            continue
        if m == "lstm":
            out.append(f"lstm{mods[i + 1]}")
            i += 2
            continue
        out.append(int(m) if m.isdigit() else m)
        i += 1
    if leaf in _LSTM_LEAVES:
        name = _LSTM_LEAVES[leaf]
        return tuple(out + [name]), _LEAVES[name][1], False
    if leaf in ("running_mean", "running_var"):
        return tuple(out + [leaf[len("running_"):]]), None, True
    if mods[-1] == "embed":
        return tuple(out), None, False
    in_list = mods[-1].isdigit()
    container = mods[-2] if in_list else mods[-1]
    if container in ("bns", "lns"):
        name = "scale" if leaf == "weight" else "bias"
    elif (in_list and container == "convs") or container.endswith("_embed"):
        name = "kernel" if leaf == "weight" else "bias"
    else:  # linear layers: feat_out, prenet, predictor heads
        name = "w" if leaf == "weight" else "b"
    return tuple(out + [name]), _LEAVES[name][1], False


def jax_path(key):
    """A ``state_dict`` key's path in the JAX package's params or state
    tree (a tuple of names and list indices)."""
    return _jax_path(key)[0]


def relayout_tensor(t, kind):
    """``_relayout`` of a torch tensor (any dtype, bf16 included): a
    contiguous tensor in the other package's layout."""
    if kind == "T":
        t = t.t()
    elif kind == "conv":
        t = t.permute(2, 1, 0)
    return t.contiguous()


def jax_leaf(key):
    """A parameter's (JAX tree path, layout change): ``relayout_tensor``
    with the change turns its tensor into the JAX array and back."""
    path, kind, _ = _jax_path(key)
    return path, kind


def param_tree(named):
    """(``state_dict`` key, tensor) pairs of parameters -> a tree shaped
    as the JAX params tree (lists, and the empty ``bns`` lists of conv
    stacks without BatchNorm), its leaves the tensors in the JAX layout
    on the CPU: the form of an optimizer's per-parameter state in optax."""
    tree = {}
    for key, t in named:
        path, kind = jax_leaf(key)
        _insert(tree, path, relayout_tensor(t.detach().cpu(), kind))
    tree = _lists(tree)
    _restore_empty_bns(tree)
    return tree


def _restore_empty_bns(tree):
    """JAX carries an empty ``bns`` list in each conv stack without
    BatchNorm; a tree built from tensors has none."""
    for part, stack in (("encoder", "convs"), ("decoder", "postnet")):
        if stack in tree.get(part, {}):
            tree[part][stack].setdefault("bns", [])


def params_from_jax(params_np, state_np):
    """JAX (params, state) trees of numpy arrays -> a ``state_dict`` for
    ``models.taco2_sa.Tacotron2SA`` (CPU float tensors)."""
    sd = {}
    for tree in (params_np, state_np):
        for path, arr in _flatten(tree):
            key, kind = _torch_key(path)
            sd[key] = torch.from_numpy(_relayout(np.asarray(arr), kind))
    return sd


def _insert(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _lists(node):
    """Dicts keyed 0..n-1 become lists (the JAX trees' layer lists)."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def params_to_numpy(state_dict):
    """Inverse of ``params_from_jax``: a port ``state_dict`` -> JAX
    (params, state) trees of numpy arrays.  Subtrees that hold no tensor
    but that JAX always carries are restored: the state's ``encoder`` and
    ``decoder``, and without BatchNorm (``use_batch_norm=False``) each
    conv stack's empty ``bns`` list, in params and state alike."""
    params, state = {}, {}
    for key, t in state_dict.items():
        path, kind, is_state = _jax_path(key)
        arr = _relayout(t.detach().cpu().float().numpy(), kind)
        _insert(state if is_state else params, path, arr)
    params, state = _lists(params), _lists(state)
    for part in ("encoder", "decoder"):  # JAX always carries both
        state.setdefault(part, {})
    _restore_empty_bns(params)
    for part, stack in (("encoder", "convs"), ("decoder", "postnet")):
        if stack in params.get(part, {}):
            state[part].setdefault(stack, {}).setdefault("bns", [])
    return params, state


def save_trees_npz(path, **trees):
    """JAX trees of numpy arrays (params, state, ...) -> one ``.npz``,
    each leaf under ``<tree>/<path>`` (list indices as numbers); read back
    with ``load_trees_npz``.  Empty lists are not kept (no weight lives
    in one)."""
    flat = {}
    for name, tree in trees.items():
        for where, arr in _flatten(tree):
            flat["/".join([name] + [str(p) for p in where])] = \
                np.asarray(arr)
    np.savez(path, **flat)


def load_trees_npz(path):
    """``save_trees_npz``'s file -> {tree name: JAX tree of numpy arrays}
    (for ``params_from_jax``)."""
    trees = {}
    with np.load(path) as data:
        for key in data.files:
            name, *parts = key.split("/")
            _insert(trees.setdefault(name, {}),
                    tuple(int(p) if p.isdigit() else p for p in parts),
                    data[key])
    return {k: _lists(v) for k, v in trees.items()}


# --------------------------------------------------------------------------
# Parallel WaveGAN: the JAX ``pwg_init`` tree <-> ``ParallelWaveGAN``
# --------------------------------------------------------------------------

_PWG_BLOCK = {"conv": "conv", "aux": "conv1x1_aux", "out": "conv1x1_out",
              "skip": "conv1x1_skip"}
_PWG_TOP = {"first_conv": "first_conv", "conv_in": "upsample_net.conv_in",
            "last1": "last_conv_layers.1", "last2": "last_conv_layers.3"}


def _up_key(i):
    return f"upsample_net.upsample.up_layers.{2 * i + 1}.weight"


def pwg_params_from_jax(tree_np):
    """JAX PWG param tree of numpy arrays -> a ``state_dict`` for
    ``vocoder.pwg.ParallelWaveGAN``.  Conv kernels (W, Cin, Cout) become
    (Cout, Cin, W); the smoothing taps (1, 1, 2s+1, 1) become
    (1, 1, 1, 2s+1)."""
    sd = {}

    def conv(prefix, node):
        sd[f"{prefix}.weight"] = torch.from_numpy(
            _relayout(np.asarray(node["kernel"]), "conv"))
        if "bias" in node:
            sd[f"{prefix}.bias"] = torch.from_numpy(
                np.array(node["bias"], copy=True))

    for jname, tname in _PWG_TOP.items():
        conv(tname, tree_np[jname])
    for i, up in enumerate(tree_np["upsample"]):
        sd[_up_key(i)] = torch.from_numpy(np.array(
            np.asarray(up["kernel"]).transpose(0, 1, 3, 2), order="C",
            copy=True))
    for i, blk in enumerate(tree_np["blocks"]):
        for jname, tname in _PWG_BLOCK.items():
            conv(f"conv_layers.{i}.{tname}", blk[jname])
    return sd


def pwg_params_to_numpy(state_dict):
    """Inverse of ``pwg_params_from_jax``: a ``ParallelWaveGAN``
    ``state_dict`` -> the JAX PWG param tree of numpy arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}

    def conv(prefix):
        node = {"kernel": _relayout(sd[f"{prefix}.weight"], "conv")}
        if f"{prefix}.bias" in sd:
            node["bias"] = np.array(sd[f"{prefix}.bias"], copy=True)
        return node

    tree = {jname: conv(tname) for jname, tname in _PWG_TOP.items()}
    n_up = sum(1 for k in sd if k.startswith("upsample_net.upsample."))
    tree["upsample"] = [
        {"kernel": np.ascontiguousarray(sd[_up_key(i)].transpose(0, 1, 3, 2))}
        for i in range(n_up)]
    n_blocks = len({k.split(".")[1] for k in sd
                    if k.startswith("conv_layers.")})
    tree["blocks"] = [{jname: conv(f"conv_layers.{i}.{tname}")
                       for jname, tname in _PWG_BLOCK.items()}
                      for i in range(n_blocks)]
    return tree
