"""Checkpoints of a training state and the committable `.npz` weights (port
of `tdvnet/train/checkpoints.py`, without orbax).

A checkpoint directory holds `epoch_<05d>.pt` (torch.save of the model's
state dict, the optimizer's state and the epoch), `meta.json` with the last
epoch and `config.json`. The `.npz` form holds the weights alone in the JAX
package's layout (flat `params//...` and `batch_stats//...` keys, floats as
fp16, `__epoch__`): a port export loads in the JAX package's `load_npz`,
and the JAX package's exports load here (`load_npz`).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tdvnet_torch.weights import _SEP, load_npz, to_flax_variables

__all__ = ["save", "latest_epoch", "restore", "restore_params",
           "export_npz", "load_npz"]


def _cfg_to_json(cfg) -> str:
    def enc(o):
        if dataclasses.is_dataclass(o):
            return {f.name: enc(getattr(o, f.name))
                    for f in dataclasses.fields(o)}
        if isinstance(o, (tuple, list)):
            return [enc(x) for x in o]
        try:
            json.dumps(o)
            return o
        except TypeError:
            return str(o)

    return json.dumps(enc(cfg), indent=2)


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"epoch_{epoch:05d}.pt")


def save(ckpt_dir: str, state, epoch: int, cfg=None) -> str:
    """Write the state's model and optimizer at `epoch`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, epoch)
    tmp = path + ".tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "epoch": epoch}, tmp)
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump({"last_epoch": epoch}, f)
    if cfg is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            f.write(_cfg_to_json(cfg))
    return path


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    meta = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return int(json.load(f)["last_epoch"])


def _load(ckpt_dir: str, epoch: int, device) -> dict:
    return torch.load(_path(ckpt_dir, epoch), map_location=device,
                      weights_only=True)


def restore(ckpt_dir: str, state) -> Optional[Tuple[object, int]]:
    """Load the latest checkpoint into `state` (its model and optimizer, in
    place; an accumulating optimizer resumes at its mini-step with its
    accumulated means). None when there is none; ValueError when the
    optimizer's parameter groups or its accumulation (`grad_accum_steps`)
    do not fit (another regime)."""
    ep = latest_epoch(ckpt_dir)
    if ep is None:
        return None
    dev = next(state.model.parameters()).device
    raw = _load(ckpt_dir, ep, dev)
    n_saved = sum(len(g["params"]) for g in
                  raw["optimizer"]["adam"]["param_groups"])
    if n_saved != len(state.optimizer.params):
        raise ValueError(f"checkpoint optimizer holds {n_saved} parameters, "
                         f"this regime trains {len(state.optimizer.params)}")
    k = raw["optimizer"].get("accum_steps", 1)
    if k != state.optimizer.accum_steps:
        raise ValueError(f"checkpoint optimizer accumulates {k} "
                         f"microbatches, this regime "
                         f"{state.optimizer.accum_steps}")
    state.model.load_state_dict(raw["model"])
    state.optimizer.load_state_dict(raw["optimizer"])
    return state, ep


def restore_params(path: str) -> Optional[Tuple[dict, int]]:
    """The weights alone, as flax-style variables {"params", "batch_stats"}
    of numpy arrays, and their epoch: from the latest checkpoint of a
    directory, or from an exported `.npz`. None when there is nothing."""
    if path.endswith(".npz"):
        return load_npz(path) if os.path.exists(path) else None
    ep = latest_epoch(path)
    if ep is None:
        return None
    return to_flax_variables(_load(path, ep, "cpu")["model"]), ep


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
        return out
    out[prefix] = np.asarray(tree)
    return out


def export_npz(path: str, variables: dict, epoch: int = 0,
               dtype=np.float16) -> str:
    """Write flax-style variables (`weights.to_flax_variables`) to one
    compressed `.npz`, floats as `dtype` (fp16 by default, as the JAX
    package's exports)."""
    flat = _flatten({k: v for k, v in variables.items()
                     if k in ("params", "batch_stats")})
    stored = {k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating)
              else v for k, v in flat.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __epoch__=np.int64(epoch), **stored)
    return path
