"""Carry a training run of the JAX package into the PyTorch port.

    python scripts/convert_jax_checkpoint.py JAX_RUN PORT_RUN [--step N]

JAX_RUN is a run directory that ``after-tpu train`` or ``after-tpu
train_autoencoder`` wrote (orbax ``checkpoint_<step>/`` directories and
``config.json``); PORT_RUN receives the port's checkpoint of the same step
and the same ``config.json``, from which ``after-tpu-torch train`` or
``train_autoencoder --restart`` continues as the JAX run would.

- a diffusion run (its tree holds ``variables``): ``DiffusionTrainer`` on
  the CPU takes the models and the EMA through ``load_jax``;
- a codec run (``codec_vars``): ``AutoencoderTrainer`` takes the codec and
  the discriminator through ``load_jax``; the discriminator's width and
  number of scales are read from its weights (the JAX CLI trains the
  default discriminator, whose other fields change no weight's shape);
- each optax state (``apply_if_finite`` over AdamW): the non-finite counts,
  Adam's count and its moments ``mu`` and ``nu``, which are trees shaped
  like the parameters, walked onto the port's parameter order as the
  weights are (``utils/from_jax.py``: every layout change there is a
  permutation, so it maps moments as it maps weights);
- the step.

It needs JAX, flax and orbax on the host that runs it (it restores through
``after_tpu.utils.checkpoint``); the port itself imports none of them.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from after_tpu_torch import config as port_config  # noqa: E402
from after_tpu_torch.utils.from_jax import (load_denoiser,  # noqa: E402
                                            load_discriminator, load_module)


def _fields(node: Any) -> Optional[Mapping[str, Any]]:
    """A node of a restored optax state by its field names: orbax gives a
    namedtuple back as a dict when restoring without a target."""
    if isinstance(node, Mapping):
        return node
    if hasattr(node, "_asdict"):
        return node._asdict()
    return None


def _find(node: Any, keys: set) -> Optional[Mapping[str, Any]]:
    """The first node (depth first) whose fields include ``keys``."""
    fields = _fields(node)
    if fields is not None and keys <= set(fields):
        return fields
    children = (fields.values() if fields is not None
                else node if isinstance(node, (list, tuple)) else ())
    for child in children:
        found = _find(child, keys)
        if found is not None:
            return found
    return None


def _ordered(module, tree: Mapping[str, Any], load) -> List[np.ndarray]:
    """``tree`` (shaped like the module's JAX params) in the order of
    ``module.parameters()``: loaded into a copy of the module by ``load``."""
    holder = copy.deepcopy(module)
    load(holder, tree)
    return [p.detach().clone() for p in holder.parameters()]


def optimizer_state(opt_state: Any, loads) -> Dict[str, Any]:
    """The port's ``AdamW.state_dict`` of a restored
    ``optax.apply_if_finite(... adamw ...)`` state.  ``loads`` lists
    (module, key, load): the moments' subtree ``mu[key]`` (the whole tree
    where key is None) goes to ``module``'s parameters through
    ``load(module, subtree)``; the port's parameters are the modules' in
    that order."""
    top = _find(opt_state, {"notfinite_count", "total_notfinite"})
    adam = _find(opt_state, {"count", "mu", "nu"})
    if top is None or adam is None:
        raise ValueError("not an apply_if_finite state over Adam")
    out = {"count": int(np.asarray(adam["count"])),
           "notfinite_count": int(np.asarray(top["notfinite_count"])),
           "total_notfinite": int(np.asarray(top["total_notfinite"]))}
    for moment in ("mu", "nu"):
        tree = adam[moment]
        out[moment] = [t for module, key, load in loads
                       for t in _ordered(module, tree if key is None
                                         else tree[key], load)]
    return out


def _numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def convert_diffusion(restored: Mapping[str, Any], config_json: str):
    from after_tpu_torch.diffusion.trainer import DiffusionTrainer
    cfg = port_config.from_json(config_json)
    variables = _numpy(restored["variables"])
    trainer = DiffusionTrainer(cfg, device="cpu").load_jax(
        variables, _numpy(restored["ema_params"])
        if "ema_params" in restored else None)

    def params(tree):
        return {"params": tree}

    def module_loader(name):
        stats = variables[name].get("batch_stats", {})
        return lambda m, t: load_module(
            m, {"params": t, "batch_stats": stats}, name)

    def net_loader(m, t):
        load_denoiser(m, params(t))

    main = [(module, name, net_loader if name == "net"
             else module_loader(name))
            for name, module in trainer.groups.items()]
    if "opt_state" in restored:
        trainer.optimizer.load_state_dict(
            optimizer_state(restored["opt_state"], main))
    if "cls_opt_state" in restored and trainer.cls_optimizer is not None:
        trainer.cls_optimizer.load_state_dict(optimizer_state(
            restored["cls_opt_state"],
            [(trainer.rf.classifier, None, module_loader("classifier"))]))
    trainer.step = int(np.asarray(restored["step"]))
    return trainer


def discriminator_config(disc_vars: Mapping[str, Any]):
    """The ``DiscriminatorConfig`` whose weights have the shapes of
    ``disc_vars``: the default's, at their number of scales and width."""
    params = disc_vars["params"]
    scales = sorted(k for k in params if k.startswith("disc_"))
    default = port_config.DiscriminatorConfig()
    if not scales or len(scales) > len(default.n_ffts):
        raise ValueError(f"{len(scales)} discriminator scales: expected 1 "
                         f"to {len(default.n_ffts)}")
    filters = int(np.shape(params[scales[0]]["Conv_0"]["kernel"])[-1])
    n = len(scales)
    return port_config.DiscriminatorConfig(
        filters=filters, n_ffts=default.n_ffts[:n],
        hop_lengths=default.hop_lengths[:n],
        win_lengths=default.win_lengths[:n])


def convert_codec(restored: Mapping[str, Any], config_json: str):
    from after_tpu_torch.autoencoder import AutoencoderTrainer
    codec_vars = _numpy(restored["codec_vars"])
    disc_vars = _numpy(restored["disc_vars"])
    trainer = AutoencoderTrainer(
        port_config.ae_from_json(config_json), port_config.AETrainConfig(),
        discriminator_config(disc_vars), device="cpu").load_jax(
            codec_vars, disc_vars)
    if "opt_state" in restored:
        trainer.optimizer.load_state_dict(optimizer_state(
            restored["opt_state"],
            [(trainer.codec, None,
              lambda m, t: load_module(m, {"params": t}, "codec"))]))
    if "disc_opt_state" in restored:
        trainer.disc_optimizer.load_state_dict(optimizer_state(
            restored["disc_opt_state"],
            [(trainer.disc, None,
              lambda m, t: load_discriminator(m, {"params": t}))]))
    trainer.step = int(np.asarray(restored["step"]))
    return trainer


def convert(jax_run: str, port_run: str, step: Optional[int] = None) -> str:
    """Convert the checkpoint of ``jax_run`` at ``step`` (the latest by
    default) into ``port_run``; returns the port checkpoint's directory."""
    from after_tpu.utils.checkpoint import restore_checkpoint
    from after_tpu_torch.utils.checkpoint import save_checkpoint

    restored = restore_checkpoint(jax_run, step)
    with open(os.path.join(jax_run, "config.json")) as f:
        config_json = f.read()
    if "variables" in restored:
        trainer = convert_diffusion(restored, config_json)
    elif "codec_vars" in restored:
        trainer = convert_codec(restored, config_json)
    else:
        raise ValueError(f"{jax_run}: neither a diffusion run (variables) "
                         f"nor a codec run (codec_vars): "
                         f"{sorted(restored)}")
    return save_checkpoint(port_run, trainer.step, trainer.state_tree(),
                           config_json=config_json)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("jax_run", help="run directory of the JAX package")
    p.add_argument("port_run", help="run directory to write for the port")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the latest)")
    args = p.parse_args(argv)
    import jax
    # restoring needs a device; the CPU's keeps any accelerator free
    jax.config.update("jax_platforms", "cpu")
    path = convert(args.jax_run, args.port_run, args.step)
    print(f"[convert_jax_checkpoint] {args.jax_run} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
