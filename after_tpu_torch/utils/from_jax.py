"""Load the JAX package's variables into the port's modules.

The caller converts the flax variables to nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, variables)``); this module imports no
JAX.  The layout is the JAX pipeline's::

    {"codec": {"params": ...},
     "diffusion": {"net": {"params": ...},
                   "encoder": {"params": ..., "batch_stats": ...},
                   "encoder_time": {"params": ..., "batch_stats": ...},
                   "classifier": {"params": ..., "batch_stats": ...}}}

(``diffusion`` alone is the diffusion trainer's ``variables``.)

The port's submodules carry the flax names (``down_2/res_1/block1/conv``,
``block_0/attn/qkv``, ...), so loading is a walk over both trees.  Leaf
mappings:

- Dense kernel (in, out) -> nn.Linear weight (out, in);
- conv kernel (k, in, out) -> weight (out, in, k); weight-norm ``g`` stays a
  parameter of its own; a 2-D conv kernel (kh, kw, in, out) -> nn.Conv2d
  weight (out, in, kh, kw);
- transposed-conv kernel (k, in, out) -> weight (in, out, k) flipped along k;
- norm ``scale`` -> weight; BatchNorm ``mean`` / ``var`` -> running buffers
  (the port's ``BatchNorm`` and torch's).

A denoiser stored with ``scan_layers`` (``blocks/block`` with a leading
layer axis) is unstacked into ``block_i`` first.  Every flax leaf must land
on a tensor of the same shape and every tensor of the port must be set, or
loading raises.

``load_discriminator`` loads the JAX ``EncodecDiscriminator``, whose tree
puts each weight-normed conv's kernel and bias under flax's auto-names
(``disc_i/Conv_j``) and its scale under the wrapper's name
(``disc_i/conv_in/"Conv_0/kernel/scale"``); the HWIO kernel becomes an OIHW
weight.

``load_stream_state`` carries a JAX ``StreamState`` across in the same way:
both states flatten to flax cache paths (streaming/state.py), and every leaf
is copied into the port's state in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from ..ops.conv import StreamConv1d, StreamConvTranspose1d
from ..ops.norms import BatchNorm, GroupNorm
from ..ops.snake import SnakeBeta
from ..streaming.state import StreamState, flatten_state


def _set(t: torch.Tensor, value: np.ndarray, path: str) -> None:
    value = np.array(value, dtype=np.float32, order="C")  # a writable copy
    if tuple(t.shape) != value.shape:
        raise ValueError(f"{path}: port shape {tuple(t.shape)} != "
                         f"JAX shape {value.shape}")
    with torch.no_grad():
        t.copy_(torch.from_numpy(value))


class _Walk:

    def __init__(self):
        self.unused: List[str] = []

    def leaf(self, module: nn.Module, params: Mapping, stats: Mapping,
             path: str) -> bool:
        p = dict(params)
        s = dict(stats)

        def take(d, name):
            if name not in d:
                raise KeyError(f"{path}/{name} missing from the JAX variables")
            return d.pop(name)

        if isinstance(module, StreamConv1d):
            _set(module.weight, take(p, "kernel").transpose(2, 1, 0),
                 path + "/kernel")
            _set(module.g, take(p, "g"), path + "/g")
        elif isinstance(module, StreamConvTranspose1d):
            _set(module.weight, take(p, "kernel")[::-1].transpose(1, 2, 0),
                 path + "/kernel")
            _set(module.g, take(p, "g"), path + "/g")
        elif isinstance(module, nn.Linear):
            _set(module.weight, take(p, "kernel").T, path + "/kernel")
        elif isinstance(module, nn.Conv1d):
            _set(module.weight, take(p, "kernel").transpose(2, 1, 0),
                 path + "/kernel")
        elif isinstance(module, nn.Conv2d):
            _set(module.weight, take(p, "kernel").transpose(3, 2, 0, 1),
                 path + "/kernel")
        elif isinstance(module, SnakeBeta):
            _set(module.alpha, take(p, "alpha"), path + "/alpha")
            _set(module.beta, take(p, "beta"), path + "/beta")
        elif isinstance(module, (GroupNorm, nn.LayerNorm, BatchNorm,
                                 _BatchNorm)):
            _set(module.weight, take(p, "scale"), path + "/scale")
            if isinstance(module, (BatchNorm, _BatchNorm)):
                _set(module.running_mean, take(s, "mean"), path + "/mean")
                _set(module.running_var, take(s, "var"), path + "/var")
        else:
            return False
        if getattr(module, "bias", None) is not None:
            _set(module.bias, take(p, "bias"), path + "/bias")
        self.unused += [f"{path}/{k}" for k in list(p) + list(s)]
        return True

    def walk(self, module: nn.Module, params: Mapping, stats: Mapping,
             path: str) -> None:
        if self.leaf(module, params, stats, path):
            return
        own = dict(module.named_parameters(recurse=False))
        for name, value in own.items():
            if name not in params:
                raise KeyError(f"{path}/{name} missing from the JAX variables")
            _set(value, params[name], f"{path}/{name}")
        children = dict(module.named_children())
        for name in set(params) | set(stats):
            if name not in children and name not in own:
                self.unused.append(f"{path}/{name}")
        for name, child in children.items():
            if not any(True for _ in child.parameters()):
                continue
            if name not in params:
                raise KeyError(f"{path}/{name} missing from the JAX variables")
            self.walk(child, params[name], stats.get(name, {}),
                      f"{path}/{name}")


def unstack_scan_blocks(params: Mapping[str, Any]) -> Dict[str, Any]:
    """``blocks/block`` with a leading layer axis -> ``block_0 .. block_{n-1}``."""
    if "blocks" not in params:
        return dict(params)
    out = {k: v for k, v in params.items() if k != "blocks"}
    stacked = params["blocks"]["block"]

    def index(tree, i):
        if isinstance(tree, Mapping):
            return {k: index(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    n = len(np.asarray(_first_leaf(stacked)))
    for i in range(n):
        out[f"block_{i}"] = index(stacked, i)
    return out


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def load_module(module: nn.Module, variables: Mapping[str, Any],
                path: str = "") -> None:
    """Load one flax module's variables ({"params", "batch_stats"})."""
    w = _Walk()
    w.walk(module, variables["params"], variables.get("batch_stats", {}),
           path)
    if w.unused:
        raise ValueError("JAX variables with no place in the port: "
                         + ", ".join(sorted(w.unused)))


def load_denoiser(net: nn.Module, variables: Mapping[str, Any]) -> None:
    load_module(net, {"params": unstack_scan_blocks(variables["params"])},
                "net")


def load_diffusion(rf: nn.Module, variables: Mapping[str, Any],
                   classifier: bool = True) -> None:
    """Load a RectifiedFlow's models from the JAX ``variables``: the
    denoiser, both encoders and, with ``classifier``, the adversarial
    classifier (which the JAX variables then must hold)."""
    load_denoiser(rf.net, variables["net"])
    load_module(rf.encoder, variables["encoder"], "encoder")
    if rf.encoder_time is not None:
        load_module(rf.encoder_time, variables["encoder_time"], "encoder_time")
    if classifier and rf.classifier is not None:
        load_module(rf.classifier, variables["classifier"], "classifier")


def load_pipeline(pipeline, variables: Mapping[str, Any]) -> None:
    """Load a TransferPipeline's codec and diffusion models (the
    classifier too where the JAX variables hold one; inference never runs
    it)."""
    load_module(pipeline.codec, variables["codec"], "codec")
    dv = variables["diffusion"]
    load_diffusion(pipeline.rf, dv, classifier="classifier" in dv)


def load_basic_pitch(model, variables: Mapping[str, Any]) -> None:
    """Load a ``dataset.basic_pitch.BasicPitch`` from the JAX pipeline's
    variables ({"net": {"params", "batch_stats"}, "cqt_bn": {"mean",
    "var"}})."""
    load_module(model.net, variables["net"], "net")
    _set(model.cqt_bn_mean, variables["cqt_bn"]["mean"], "cqt_bn/mean")
    _set(model.cqt_bn_var, variables["cqt_bn"]["var"], "cqt_bn/var")


def load_beat_this(net: nn.Module, variables: Mapping[str, Any]) -> None:
    """Load a ``dataset.beat_tracker.BeatThis`` from the JAX module's
    variables ({"params", "batch_stats"})."""
    load_module(net, variables)


def load_discriminator(disc: nn.Module, variables: Mapping[str, Any]) -> None:
    """Load an ``EncodecDiscriminator``'s variables ({"params": ...}); every
    JAX leaf must land on a tensor of the same shape and every tensor of the
    port must be set, or loading raises."""
    params = {k: dict(v) for k, v in variables["params"].items()}
    for name, scale in disc.named_children():
        if name not in params:
            raise KeyError(f"{name} missing from the JAX variables")
        p = {k: dict(v) for k, v in params.pop(name).items()}
        for j, (wrapper, conv) in enumerate(scale.named_children()):
            path = f"{name}/Conv_{j}"
            if f"Conv_{j}" not in p or wrapper not in p:
                raise KeyError(f"{path} or {name}/{wrapper} missing from the "
                               f"JAX variables")
            leaf = p.pop(f"Conv_{j}")
            _set(conv.weight, np.asarray(leaf.pop("kernel")).transpose(
                3, 2, 0, 1), path + "/kernel")
            _set(conv.bias, leaf.pop("bias"), path + "/bias")
            wn = p.pop(wrapper)
            _set(conv.scale, wn.pop(f"Conv_{j}/kernel/scale"),
                 f"{name}/{wrapper}/Conv_{j}/kernel/scale")
            if leaf or wn:
                raise ValueError("JAX variables with no place in the port: "
                                 + ", ".join(f"{path}/{k}" for k in
                                             list(leaf) + list(wn)))
        if p:
            raise ValueError("JAX variables with no place in the port: "
                             + ", ".join(f"{name}/{k}" for k in sorted(p)))
    if params:
        raise ValueError("JAX variables with no place in the port: "
                         + ", ".join(sorted(params)))


def load_stream_state(streamer, state: StreamState, jax_state: Any) -> None:
    """Copy a JAX ``StreamState`` (its fields as nested dicts, tuples and
    dataclasses of numpy arrays; a ``scan_layers`` denoiser cache is
    unstacked) into ``state``, a state of ``streamer``, in place.  Every
    leaf must land on a tensor of the same shape and every tensor of the
    port's state must be set, or loading raises."""
    ours = flatten_state(state)
    theirs: Dict[str, Any] = {}
    for f in ("codec_struct", "codec_timbre", "codec_dec", "enc_time",
              "denoiser", "prev_timbre"):
        node = (jax_state[f] if isinstance(jax_state, Mapping)
                else getattr(jax_state, f))
        if f == "denoiser":
            node = unstack_scan_blocks(node)
        theirs.update(flatten_state(node, f))
    missing = sorted(ours.keys() - theirs.keys())
    extra = sorted(theirs.keys() - ours.keys())
    if missing or extra:
        raise ValueError(f"stream states differ: missing from the JAX state "
                         f"{missing}, with no place in the port {extra}")
    with torch.no_grad():
        for path, t in ours.items():
            if t.device != streamer.device:
                raise ValueError(f"{path} is on {t.device}, the streamer on "
                                 f"{streamer.device}")
            value = np.array(theirs[path])
            if tuple(t.shape) != value.shape:
                raise ValueError(f"{path}: port shape {tuple(t.shape)} != "
                                 f"JAX shape {value.shape}")
            t.copy_(torch.from_numpy(value).to(t.dtype))
