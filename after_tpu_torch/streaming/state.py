"""Stream state of the port (counterpart of after_tpu/streaming/state.py and
of the state dataclasses of after_tpu/streaming/{streamer,crossfade}.py).

The JAX package keeps every streaming buffer (conv left contexts,
transposed-conv overlap tails, GroupNorm pads, KV caches) in flax's
``cache`` collection.  Here a module cache is a flat dict from the flax cache
path (``encoder/to_in/block1/gn/pad``) to a tensor.  A module that streams
mixes in :class:`Streaming`: its root model gives it its path
(:func:`name_slots`) and it finds its buffers with :meth:`Streaming.slot`.

A cache is made by one pass over zeros with an empty dict, in which every
module creates its buffers at the shape it needs, then zeroed
(:func:`init_cache`, the counterpart of ``init_stream_state``); the
crossfade path keeps what that pass left, as the JAX package does.  From then
on each step writes into those tensors in place, so their addresses stay
fixed across buffers (the counterpart of ``donate_argnums`` in the JAX
``Streamer``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Sequence

import torch
from torch import nn

Cache = Dict[str, torch.Tensor]


class Streaming:
    """Mixin of a module with streaming buffers."""

    cache_path = ""

    def slot(self, cache: Cache, name: str,
             make: Callable[[], torch.Tensor]) -> torch.Tensor:
        """The buffer ``name`` of this module in ``cache``, created by
        ``make()`` on the pass that builds the cache."""
        if cache is None:
            raise ValueError(f"{type(self).__name__} streams: pass its cache")
        key = f"{self.cache_path}/{name}" if self.cache_path else name
        t = cache.get(key)
        if t is None:
            t = cache[key] = make()
        return t


def name_slots(root: nn.Module) -> None:
    """Give every streaming module under ``root`` its flax cache path."""
    for name, m in root.named_modules():
        if isinstance(m, Streaming):
            m.cache_path = name.replace(".", "/")


def init_cache(run: Callable[[Cache], Any], zero: bool = True) -> Cache:
    """A new cache: ``run(cache)`` makes one pass over zero inputs that
    creates every buffer, which is then set back to zero, or, with ``zero``
    unset, left as that pass over silence left it."""
    cache: Cache = {}
    with torch.no_grad():
        run(cache)
        if zero:
            for t in cache.values():
                t.zero_()
    return cache


@dataclasses.dataclass
class CrossfadeState:
    """Decode state of a crossfaded (non-causal) codec: the last ``n_fade``
    latent frames, the overlap tail of the last output, and the streaming
    GroupNorm pads (empty without GroupNorm)."""

    z_buffer: torch.Tensor
    out_buffer: torch.Tensor
    cache: Cache


@dataclasses.dataclass(eq=False)
class StreamState:
    """Everything a stream carries from one buffer to the next.  States
    compare and hash by identity: a streamer keys the CUDA graphs that
    capture a state's addresses by the state itself."""

    codec_struct: Any      # codec encode caches, structure stream
    codec_timbre: Any      # codec encode caches, timbre stream
    codec_dec: Any         # codec decode caches
    enc_time: Cache        # structure-encoder conv caches
    denoiser: Cache        # per-step KV caches (batch 3B)
    prev_timbre: torch.Tensor   # (B, n_signal, z) latent ring of the timbre


def clone_state(node):
    """A copy of a cache, or of a tuple of caches and tensors, with every
    tensor cloned."""
    if isinstance(node, torch.Tensor):
        return node.clone()
    if isinstance(node, Mapping):
        return {k: clone_state(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(clone_state(v) for v in node)
    raise TypeError(f"not a stream state node: {type(node)}")


def flatten_state(node, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} of a state tree: mappings by key, dataclasses by field,
    tuples by position, joined with ``/``.  The same walk flattens the JAX
    package's state (nested dicts of arrays), so the two compare by path."""
    out: Dict[str, Any] = {}

    def walk(n, path):
        if isinstance(n, Mapping):
            items = n.items()
        elif dataclasses.is_dataclass(n):
            items = ((f.name, getattr(n, f.name))
                     for f in dataclasses.fields(n))
        elif isinstance(n, tuple):
            items = enumerate(n)
        else:
            out[path] = n
            return
        for k, v in items:
            walk(v, f"{path}/{k}" if path else str(k))

    walk(node, prefix)
    return out


def unflatten_state(template, leaves: Sequence[Any]):
    """The inverse of ``flatten_state``: a tree of ``template``'s structure
    (its mappings, dataclasses and tuples) whose leaves are ``leaves``, in
    ``flatten_state``'s order.  A traced program takes a state as its list
    of leaves and rebuilds the tree with this."""
    it = iter(leaves)
    end = object()

    def walk(n):
        if isinstance(n, Mapping):
            return {k: walk(v) for k, v in n.items()}
        if dataclasses.is_dataclass(n):
            return dataclasses.replace(n, **{
                f.name: walk(getattr(n, f.name))
                for f in dataclasses.fields(n)})
        if isinstance(n, tuple):
            return tuple(walk(v) for v in n)
        return next(it)

    out = walk(template)
    if next(it, end) is not end:
        raise ValueError("more leaves than the template has")
    return out
