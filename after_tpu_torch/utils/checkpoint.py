"""Checkpoint save and restore of train states (counterpart of
after_tpu/utils/checkpoint.py): the same functions, on torch state.

A checkpoint is ``<model_dir>/checkpoint_<step>/state.pt``, a ``torch.save``
of a nested dict of tensors, numbers and lists (read back with
``weights_only``), beside the run's ``config.json`` in the JSON form both
packages share.  The JAX package's orbax checkpoints are not read here: the
port takes JAX weights through ``load_jax`` (utils/from_jax.py).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_STATE = "state.pt"


def _ckpt_dir(model_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(model_dir), f"checkpoint_{step}")


def save_checkpoint(model_dir: str, step: int, tree: Any,
                    config_json: Optional[str] = None) -> str:
    """Save ``tree`` (a train state's contents) at
    ``model_dir/checkpoint_<step>``, and ``config_json`` as the run's
    ``config.json``; returns the checkpoint's directory."""
    path = _ckpt_dir(model_dir, step)
    os.makedirs(path, exist_ok=True)
    torch.save(tree, os.path.join(path, _STATE))
    if config_json is not None:
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            f.write(config_json)
    return path


def available_steps(model_dir: str) -> List[int]:
    if not os.path.isdir(model_dir):
        return []
    steps = []
    for name in os.listdir(model_dir):
        m = re.fullmatch(r"checkpoint_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def _path(model_dir: str, step: Optional[int]) -> str:
    steps = available_steps(model_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {model_dir}")
    step = step if step is not None else steps[-1]
    return os.path.join(_ckpt_dir(model_dir, step), _STATE)


def restore_checkpoint(model_dir: str, step: Optional[int] = None) -> Any:
    """The tree saved at ``step`` (default: the latest), its tensors on the
    CPU."""
    return torch.load(_path(model_dir, step), map_location="cpu",
                      weights_only=True)


def checkpoint_keys(model_dir: str, step: Optional[int] = None) -> List[str]:
    """Top-level keys of the checkpoint at ``step`` (default: the latest)."""
    tree = restore_checkpoint(model_dir, step)
    return list(tree.keys()) if isinstance(tree, dict) else []


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def shapes_compatible(a, b) -> bool:
    """True when two trees (nested dicts, lists and tuples) carry the same
    multiset of leaf shapes."""
    def shapes(t):
        return sorted(tuple(x.shape) if hasattr(x, "shape")
                      else tuple(np.shape(x)) for x in _leaves(t))
    return shapes(a) == shapes(b)


def filter_partial_load(restored: Dict, current: Dict,
                        load_encoders=(True, True, True)) -> Dict:
    """Partial-load mask for restarts with frozen or absent encoders:
    ``load_encoders`` gives (encoder, encoder_time, net).

    Every subtree the current model has comes from the checkpoint when its
    leaf shapes match (the classifier included); a False flag keeps that
    subtree as it is now.  Subtrees only the checkpoint has are dropped, and
    one whose shapes no longer match the config stays fresh."""
    out = {}
    for k, v in current.items():
        if k in restored and shapes_compatible(restored[k], v):
            out[k] = restored[k]
        else:
            if k in restored:
                print(f"[restore] checkpoint subtree '{k}' doesn't match "
                      "the current config; keeping fresh init")
            out[k] = v
    for name, load in (("encoder", load_encoders[0]),
                       ("encoder_time", load_encoders[1]),
                       ("net", load_encoders[2])):
        if not load and name in current:
            out[name] = current[name]
    return out
