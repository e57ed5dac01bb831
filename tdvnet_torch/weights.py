"""Weight bridge between the JAX package's flax variables and the port's
state dict, both ways (`from_flax_variables`, `to_flax_variables`).

The torch modules carry the flax submodule names, so each flax leaf maps to
one state-dict entry and only its layout rule differs:
- conv kernel [k..., in, out] -> [out, in, k...] (depthwise [kh, kw, 1, C]
  -> [C, 1, kh, kw] and Dense [in, out] -> [out, in] are the same rule);
- the input-dilated up-convs (`ConvTransposeUp3d_*`, `MaskedUpConv3d_*`)
  [3, 3, 3, in, out] -> ConvTranspose3d [in, out, 3, 3, 3], spatially
  flipped;
- BatchNorm/GroupNorm `scale`/`bias` -> `weight`/`bias`; batch_stats
  `mean`/`var` -> `running_mean`/`running_var`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tdvnet_torch.config import ModelConfig, resolve_device

_SEP = "//"
_UP_CONVS = ("ConvTransposeUp3d_", "MaskedUpConv3d_")


def _unflatten(flat):
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        keys = path.split(_SEP)
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def load_npz(path: str) -> Tuple[dict, int]:
    """Load an exported `.npz` into {params[, batch_stats]} (floats as fp32)
    and its epoch (a copy of the JAX package's `checkpoints.load_npz`)."""
    with np.load(path) as z:
        epoch = int(z["__epoch__"]) if "__epoch__" in z else 0
        flat = {}
        for k in z.files:
            if k == "__epoch__":
                continue
            v = z[k]
            if np.issubdtype(v.dtype, np.floating):
                v = v.astype(np.float32)
            flat[k] = v
    return _unflatten(flat), epoch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _leaf(collection: str, path: Tuple[str, ...], arr: np.ndarray):
    """(state-dict key, tensor) of one flax leaf."""
    *mods, leaf = path
    if collection == "batch_stats":
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif leaf == "kernel":
        name = "weight"
        nd = arr.ndim
        if any(m.startswith(_UP_CONVS) for m in mods):
            # input-dilated conv == transposed conv with the kernel flipped
            arr = np.flip(arr, axis=tuple(range(nd - 2)))
            arr = np.transpose(arr, (nd - 2, nd - 1, *range(nd - 2)))
        else:
            arr = np.transpose(arr, (nd - 1, nd - 2, *range(nd - 2)))
    elif leaf in ("scale", "bias"):
        name = "weight" if leaf == "scale" else "bias"
    else:
        raise KeyError(f"unknown flax leaf {collection}/{'/'.join(path)}")
    key = ".".join([*mods, name])
    return key, torch.from_numpy(np.ascontiguousarray(arr, np.float32))


def from_flax_variables(variables: dict) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} as numpy -> torch state dict."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})).items():
            key, t = _leaf(collection, path, arr)
            if key in sd:
                raise KeyError(f"two flax leaves map to {key}")
            sd[key] = t
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown flax collections {sorted(unknown)}")
    return sd


def _flax_leaf(key: str, t: torch.Tensor):
    """(collection, flax path, array) of one state-dict entry: the inverse
    of `_leaf`."""
    *mods, name = key.split(".")
    arr = t.detach().cpu().numpy()
    if name in ("running_mean", "running_var"):
        return "batch_stats", (*mods, name[len("running_"):]), arr
    if name == "bias":
        return "params", (*mods, "bias"), arr
    if name != "weight":
        raise KeyError(f"no flax leaf for the tensor {key}")
    if arr.ndim == 1:                       # a norm's scale
        return "params", (*mods, "scale"), arr
    nd = arr.ndim
    if any(m.startswith(_UP_CONVS) for m in mods):
        arr = np.transpose(arr, (*range(2, nd), 0, 1))
        arr = np.flip(arr, axis=tuple(range(nd - 2)))
    else:
        arr = np.transpose(arr, (*range(2, nd), 1, 0))
    return "params", (*mods, "kernel"), arr


def to_flax_variables(module) -> dict:
    """A module's (or a state dict's) tensors as flax variables
    {"params": ..., "batch_stats": ...} of fp32 numpy arrays: the inverse of
    `from_flax_variables` (BatchNorm's `num_batches_tracked` has no flax
    leaf and is left out)."""
    sd = module.state_dict() if isinstance(module, torch.nn.Module) \
        else module
    out = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        collection, path, arr = _flax_leaf(key, t)
        node = out[collection]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr, np.float32)
    return {c: tree for c, tree in out.items() if tree}


def load_flax_into(module: torch.nn.Module, variables: dict) -> None:
    """Fill every tensor of `module` from flax variables. Raises on a flax
    leaf that no tensor takes, on a tensor that no leaf fills (BatchNorm's
    `num_batches_tracked` aside) and on a shape mismatch."""
    sd = from_flax_variables(variables)
    own = {k: v for k, v in module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    extra = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if extra or missing:
        raise KeyError(f"weight bridge: unconsumed flax leaves {extra}; "
                       f"unfilled torch tensors {missing}")
    for k, t in sd.items():
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"weight bridge: {k} has shape {tuple(t.shape)}"
                             f", the module wants {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=False)


def load_threedvnet(npz_path: str, cfg: ModelConfig = ModelConfig(),
                    device=None):
    """Build `ThreeDVNet(cfg)` with the weights of an exported `.npz`, on
    `device` (the card when None), in eval mode."""
    from tdvnet_torch.models.threedvnet import ThreeDVNet

    dev = resolve_device(device)
    variables, _ = load_npz(npz_path)
    model = ThreeDVNet(cfg)
    load_flax_into(model, variables)
    return model.to(dev).eval()
