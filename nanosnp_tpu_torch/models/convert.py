"""Parameter converters and archives, without JAX.

  - reference torch checkpoints -> the port's parameter tree
    (`pileup_params_from_torch`, `haplotype_params_from_torch`), and the
    reverse for the pileup checkpoint (`pileup_checkpoint_from_params`);
  - a reference CatModel state_dict -> the legacy CatModel's tree
    (`catmodel_params_from_torch`: conv weights stay OIHW, BatchNorm
    becomes `scale/bias/mean/var`);
  - the fp16 npz parameter archive (`load_params_npz`/`save_params_npz`),
    whose keys encode the tree path (`k:name` for a dict key, `i:3` for a
    list index), as written by the JAX package's train_pileup.py;
  - `params_from_jax`, the carrier from the JAX package's parameter tree
    (as numpy arrays: `jax.tree.map(np.asarray, params)`) to the port's,
    also for an optax LookaheadParams (fast, slow) pair; `params_to_numpy`,
    the reverse, which the training checkpoints store. Both, and the
    archive, walk any nested dict/list tree, the CatModel's included;
  - `flatten_tree` / `unflatten_like`, a tree's leaves with their paths in
    JAX's order (dict keys sorted), for the optimizer and the archives.

Torch LSTM layout: weight_ih_l{k}[_reverse] is [4H, D], gate order i,f,g,o.
The parameter tree stores x @ W with the direction stacked first,
[2, D, 4H], and folds b_ih + b_hh into one bias, exactly as the JAX
package does, so carrying JAX parameters across is a copy.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    # a copy: arrays from JAX are read-only, and training updates in place
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def lstm_layers_from_torch(sd: Mapping[str, Any], prefix: str, n_layers: int):
    layers = []
    for k in range(n_layers):
        dirs_ih, dirs_hh, dirs_b = [], [], []
        for suffix in ("", "_reverse"):
            w_ih = _np(sd[f"{prefix}weight_ih_l{k}{suffix}"])  # [4H, D]
            w_hh = _np(sd[f"{prefix}weight_hh_l{k}{suffix}"])  # [4H, H]
            b = (_np(sd[f"{prefix}bias_ih_l{k}{suffix}"])
                 + _np(sd[f"{prefix}bias_hh_l{k}{suffix}"]))
            dirs_ih.append(w_ih.T)
            dirs_hh.append(w_hh.T)
            dirs_b.append(b)
        layers.append({"w_ih": _t(np.stack(dirs_ih)),
                       "w_hh": _t(np.stack(dirs_hh)),
                       "b": _t(np.stack(dirs_b))})
    return layers


def _linear_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict:
    return {"w": _t(_np(sd[f"{prefix}.weight"]).T),
            "b": _t(sd[f"{prefix}.bias"])}


def pileup_params_from_torch(checkpoint: Mapping[str, Any],
                             n_layers: int = 2) -> Dict[str, Any]:
    """The reference pileup checkpoint ({'encoder': state_dict,
    'forward_layer': state_dict}) -> the port's parameter tree."""
    enc = checkpoint["encoder"]
    fwd = checkpoint["forward_layer"]
    return {
        "encoder": lstm_layers_from_torch(enc, "lstm.", n_layers),
        "proj": _linear_from_torch(enc, "output_proj"),
        "dense": _linear_from_torch(fwd, "dense"),
        "gt": _linear_from_torch(fwd, "genotype_layer"),
        "zy": _linear_from_torch(fwd, "zygosity_layer"),
        "id1": _linear_from_torch(fwd, "indel1_layer"),
        "id2": _linear_from_torch(fwd, "indel2_layer"),
    }


def load_pileup_checkpoint(path: str, n_layers: int = 2) -> Dict[str, Any]:
    # weights_only: the checkpoint holds state dicts of tensors, and
    # unpickling arbitrary objects could run code
    ck = torch.load(path, map_location="cpu", weights_only=True)
    return pileup_params_from_torch(ck, n_layers)


def pileup_checkpoint_from_params(params: Mapping[str, Any]) -> Dict:
    """The port's pileup parameter tree -> a reference-layout checkpoint
    dict (the folded bias goes to bias_ih, bias_hh is zero)."""
    enc: Dict[str, torch.Tensor] = {}
    for k, layer in enumerate(params["encoder"]):
        for d, suffix in enumerate(("", "_reverse")):
            enc[f"lstm.weight_ih_l{k}{suffix}"] = _t(_np(layer["w_ih"][d]).T)
            enc[f"lstm.weight_hh_l{k}{suffix}"] = _t(_np(layer["w_hh"][d]).T)
            enc[f"lstm.bias_ih_l{k}{suffix}"] = _t(layer["b"][d])
            enc[f"lstm.bias_hh_l{k}{suffix}"] = torch.zeros_like(
                _t(layer["b"][d]))

    def lin(p):
        return {"weight": _t(_np(p["w"]).T), "bias": _t(p["b"])}

    for name, v in lin(params["proj"]).items():
        enc[f"output_proj.{name}"] = v
    fwd: Dict[str, torch.Tensor] = {}
    for key, name in (("dense", "dense"), ("gt", "genotype_layer"),
                      ("zy", "zygosity_layer"), ("id1", "indel1_layer"),
                      ("id2", "indel2_layer")):
        for part, v in lin(params[key]).items():
            fwd[f"{name}.{part}"] = v
    return {"encoder": enc, "forward_layer": fwd}


def haplotype_params_from_torch(sd: Mapping[str, Any],
                                n_layers: int = 3) -> Dict[str, Any]:
    """A reference haplotype state_dict (model_dev.LSTMNetwork) -> tree."""
    return {
        "pileup_encoder": lstm_layers_from_torch(sd, "pileup_encoder.lstm.",
                                                 n_layers),
        "pileup_proj": _linear_from_torch(sd, "pileup_encoder.output_proj"),
        "haplotype_encoder": lstm_layers_from_torch(
            sd, "haplotype_encoder.lstm.", n_layers),
        "haplotype_proj": _linear_from_torch(sd,
                                             "haplotype_encoder.output_proj"),
        "dense": _linear_from_torch(sd, "forward_layer.dense"),
        "gt": _linear_from_torch(sd, "forward_layer.genotype_layer"),
        "zy": _linear_from_torch(sd, "forward_layer.zygosity_layer"),
    }


def catmodel_params_from_torch(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference CatModel state_dict (HaplotypeModel/model.py:201) ->
    the legacy CatModel's parameter tree. Values may be tensors or numpy
    arrays."""
    def bn(prefix):
        return {"scale": _t(_np(sd[f"{prefix}.weight"])),
                "bias": _t(_np(sd[f"{prefix}.bias"])),
                "mean": _t(_np(sd[f"{prefix}.running_mean"])),
                "var": _t(_np(sd[f"{prefix}.running_var"]))}

    def lin(prefix):
        return {"w": _t(_np(sd[f"{prefix}.weight"]).T),
                "b": _t(_np(sd[f"{prefix}.bias"]))}

    blocks = []
    for i in range(6):
        base = f"haplotype_base.cnn.conv{i}"
        blocks.append({
            "conv1": _t(_np(sd[f"{base}.base.conv{i}_base_conv1.weight"])),
            "bn1": bn(f"{base}.base.conv{i}_base_bn1"),
            "conv2": _t(_np(sd[f"{base}.base.conv{i}_base_conv2.weight"])),
            "bn2": bn(f"{base}.base.conv{i}_base_bn2"),
            "shortcut": _t(_np(
                sd[f"{base}.shortcut.conv{i}_shortcut_conv1.weight"])),
        })
    return {
        "percentage_rnn": lstm_layers_from_torch(
            sd, "haplotype_percentage.rnn.", 3),
        "percentage_proj": lin("haplotype_percentage.out_layer"),
        "res_blocks": blocks,
        "crnn_lstm1": lstm_layers_from_torch(
            sd, "haplotype_base.rnn.0.rnn.", 1),
        "crnn_proj1": lin("haplotype_base.rnn.0.embedding"),
        "crnn_lstm2": lstm_layers_from_torch(
            sd, "haplotype_base.rnn.1.rnn.", 1),
        "crnn_proj2": lin("haplotype_base.rnn.1.embedding"),
        "out": lin("out_layer"),
    }


def params_from_jax(tree):
    """JAX parameter tree of numpy arrays -> the same tree of f32 tensors.
    An optax LookaheadParams (anything with `fast` and `slow`) becomes
    {"fast": ..., "slow": ...}."""
    if hasattr(tree, "fast") and hasattr(tree, "slow"):
        return {"fast": params_from_jax(tree.fast),
                "slow": params_from_jax(tree.slow)}
    if isinstance(tree, Mapping):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    return _t(tree)


def params_to_numpy(tree):
    """Parameter tree of tensors -> the same tree of f32 numpy arrays (the
    layout the JAX package's checkpoints hold)."""
    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return _np(tree)


def flatten_tree(tree, path=()):
    """[(path, leaf)] of a nested dict/list tree, dict keys sorted (the
    leaf order of jax.tree.leaves)."""
    if isinstance(tree, Mapping):
        return [item for k in sorted(tree)
                for item in flatten_tree(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_tree(v, path + (i,))]
    return [(path, tree)]


def unflatten_like(tree, leaves):
    """The tree `tree` with its leaves replaced, in flatten_tree order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(tree)


def save_params_npz(path: str, params, dtype=np.float16) -> None:
    """Compact parameter archive; tree paths are encoded in the keys."""
    arrays = {}

    def walk(node, toks):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, toks + [f"k:{k}"])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, toks + [f"i:{i}"])
        else:
            arrays["/".join(toks)] = _np(node).astype(dtype)

    walk(params, [])
    np.savez_compressed(path, **arrays)


def load_params_npz(path: str):
    """npz archive -> parameter tree of f32 tensors (nested dict/list)."""
    root: Dict = {}
    with np.load(path) as z:
        for name in z.files:
            toks = name.split("/")
            node = root
            for j, t in enumerate(toks):
                key = t[2:] if t.startswith("k:") else int(t[2:])
                if j == len(toks) - 1:
                    node[key] = _t(z[name])
                else:
                    node = node.setdefault(key, {})

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [listify(node[i]) for i in sorted(node)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)

