"""CUDA graphs of the port's serving calls and training steps: the
counterpart of the JAX package's compiled calls (``jax.jit`` of a transfer,
of a streamed buffer, of a diffusion training step).

A ``GraphPool`` captures callables as ``torch.cuda.CUDAGraph``s that share
one memory pool and one side stream, and replays them.  A captured call
reads and writes fixed addresses: the caller owns static input buffers,
copies each call's inputs into them (``utils.device.copy_from_host`` for
host arrays), replays, and copies out what it returns, since the next
replay overwrites the outputs.  Capture runs nothing: the callable runs
once on the side stream first (``warm``), which fills every lazily built
constant, loads the kernels and sets their attributes, so that no
host-to-device copy and no one-time setup falls inside a capture.

What a graph bakes in besides its buffers (the weights' addresses, the
kept weight-normed weights, the TF32 switches) is summed up by
``capture_key``; an owner captures again when it changes.  A training
step writes its state in place, so its graph is keyed by ``state_key``
(addresses and switches, not versions).  A step that draws random values
names its generators to ``capture``: a replay then draws fresh values, the
ones the same step run op by op would draw from the generator's state.  A
capture or a replay that fails raises: nothing falls back to running
eagerly.

A replay runs no Python: forward hooks and counters kept in Python (such as
``fused_snake_conv.launches``) see the warm-up and the capture only.  The
snake+conv kernel counts its launches on the device, replays included
(``ops.kernels.fused_conv.device_launches``).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import time
from typing import Any, Callable, Iterable, Optional, Sequence

import torch
from torch import nn


def capture_key(*modules: nn.Module) -> tuple:
    """The addresses and versions of the modules' parameters and buffers
    (a write in place bumps the version) and the TF32 switches: what a
    captured call reads that its static buffers do not hold."""
    tensors = itertools.chain.from_iterable(
        itertools.chain(m.parameters(), m.buffers()) for m in modules)
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            tuple((t.data_ptr(), t._version) for t in tensors))


def state_key(tensors: Iterable[torch.Tensor]) -> tuple:
    """The addresses of a training state's tensors (parameters, optimizer
    state, EMA) and the TF32 switches.  Unlike ``capture_key`` it leaves out
    the versions: a training step writes these tensors in place, so its
    warm-up, its capture and every step run op by op bump them, while what
    its graph reads stays where it was."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            tuple(t.data_ptr() for t in tensors))


@contextlib.contextmanager
def restored(tensors: Iterable[torch.Tensor]):
    """Runs the body, then writes each tensor back, in place, to what it
    held before: a warm-up that writes a stream state leaves it as it was,
    at the same addresses."""
    tensors = list(tensors)
    saved = [t.clone() for t in tensors]
    try:
        yield
    finally:
        for t, s in zip(tensors, saved):
            t.copy_(s)


class Graph:
    """One captured call: replays it and returns its static outputs."""

    def __init__(self, pool: "GraphPool", graph: "torch.cuda.CUDAGraph",
                 outputs: Any):
        self.pool = pool
        self.graph = graph
        self.outputs = outputs

    def replay(self) -> Any:
        self.graph.replay()
        self.pool.replays += 1
        return self.outputs


class GraphPool:
    """Captures and replays the CUDA graphs of one owner (a pipeline, a
    streamer) on ``device``: one memory pool and one side stream for all
    of them, since they run one after another on one stream.  Counts
    ``captures``, ``replays`` and the seconds spent capturing."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def warm(self, fn: Callable[[], Any]) -> Any:
        """fn() run eagerly on the side stream that captures use, ordered
        after and before the current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable[[], Any],
                generators: Sequence[torch.Generator] = ()) -> Graph:
        """fn() captured (run before with ``warm``); its outputs become the
        graph's static outputs.  ``generators`` are the CUDA generators fn
        draws from: registered with the graph, each replay draws the values
        fn would draw from the generator's state at that point, and moves
        the state on as fn would.  Raises if the capture fails."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        # a garbage collection inside the capture that frees another
        # owner's graphs (an earlier trainer left in a reference cycle)
        # destroys them mid-capture, which invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = fn()
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return Graph(self, graph, outputs)

    def held_bytes(self) -> Optional[int]:
        """Device memory reserved by this pool's segments (from the caching
        allocator's snapshot), or None where the snapshot does not say."""
        total, found = 0, False
        for seg in torch.cuda.memory_snapshot():
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            found = True
            if tuple(pid) == tuple(self.pool):
                total += seg["total_size"]
        return total if found else None

