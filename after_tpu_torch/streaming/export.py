"""Export of a streamer into a streaming artifact, and the hosts that play
one (counterpart of after_tpu/streaming/export.py).

An artifact is a directory:

    <out>/
      manifest.json     methods, stages, chunk and ratio, attributes, state
      <stage>.pt2       one torch.export program a stage
      state/            initial_state.npz and raw leaf_<i>.bin of the state

A buffer runs as a sequence of stages (``Streamer``'s): ``structure`` and
``timbre`` (audio -> structure codes, timbre vector), ``step`` (one Euler
step on one KV slot, the slot an int64 0-d input, so that one program, with
one copy of the denoiser's weights, serves every slot) and ``decode``
(latents -> audio); a MIDI model adds ``piano_roll`` (note pairs -> roll).
Each method of the manifest is one such sequence (``stages``), ``step``
standing for ``nb_steps`` steps.  A stage program takes the flat stream
state (``state_paths``, the ``flatten_state`` paths) as its first input and
writes it in place; the weights are constants of the program, folded from
the weight-normed convs (``ops.conv.fold_weights``), each program holding
only the weights it reads.  The snake+conv convs are nodes of the op
``after_tpu_torch::snake_conv``: a process that loads an artifact imports
``after_tpu_torch.ops.kernels.fused_conv`` first (this module does), or
``torch.export.load`` fails.

Where the port's artifact differs from the JAX package's: the diffusing
methods take the sampler's noise ``x0`` where the JAX artifact takes an rng
key, by the port's rule that every random draw is an argument (the host
draws it from its own seeded ``torch.Generator``); ``nb_steps`` and the
guidances are runtime inputs in both, and the manifest keeps the JAX keys,
adding ``runtime``, ``stages`` and ``state_paths``; and it holds
torch.export programs, no StableHLO, MLIR bytecode or compile options.

A streamer with a ``compute_dtype`` exports at it: its programs hold bf16
weights (each snake+conv a node of the op's bf16 form), its state leaves
are bf16 (``state_dtypes`` says "bfloat16"), stored as their raw 16 bits
(uint16 in ``initial_state.npz``, two bytes a value in ``leaf_<i>.bin``),
as the JAX exporter stores them; the hosts read them back as bf16 from the
manifest's ``state_dtypes``, a JAX artifact's state too.  Inputs and
outputs stay f32.

Export on the device that will serve: a program traced on the CPU holds CPU
constants, and a host that loads it onto the card moves them
(``torch.export.passes.move_to_device_pass``), as the hosts below do.

``ExportedStreamer`` and ``ExportedCodec`` play an artifact.  They keep the
state and every stage's inputs at fixed addresses; on the card each stage's
loaded program is captured once as a CUDA graph when the artifact is
loaded (``utils.graphs.GraphPool``), and a buffer replays 3 + nb_steps of
them, as a ``Streamer`` does.  On the CPU they run op by op.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..config import AutoEncoderConfig, EDMConfig, to_json
from ..diffusion import edm, rectified_flow
from ..models.autoencoder import AudioCodec, decoder_band_delay
from ..ops.conv import fold_weights
from ..ops.kernels import fused_conv  # noqa: F401  registers the op
from ..utils.device import copy_from_host, resolve_device, to_device
from ..utils.graphs import GraphPool, restored
from .state import flatten_state, unflatten_state
from .streamer import StreamStages, Streamer, piano_roll

FORMAT_VERSION = 2
RUNTIME = "torch.export"
# each method as its sequence of stages ("step": nb_steps Euler steps)
METHOD_STAGES = {
    "forward": ["structure", "timbre", "step", "decode"],
    "structure": ["structure"],
    "timbre": ["timbre"],
    "diffuse": ["step"],
    "decode": ["decode"],
    "generate": ["step", "decode"],
    "generate_timbre": ["structure", "step", "decode"],
    "diffuse_midi": ["piano_roll", "step"],
}
# the host buffers each method's inputs go into, in argument order
METHOD_INPUTS = {
    "forward": ("audio_s", "audio_t"),
    "structure": ("audio_s",),
    "timbre": ("audio_t",),
    "diffuse": ("tcond", "zt"),
    "decode": ("x",),
    "generate": ("tcond", "zt"),
    "generate_timbre": ("audio_s", "zt"),
    "diffuse_midi": ("notes", "zt"),
}
CODEC_METHODS = ("encode", "decode", "forward")


def _without(module: nn.Module, *names: str) -> nn.Module:
    """A shallow copy of ``module`` without the submodules ``names`` (set
    to None), sharing every other submodule: a program traced from it holds
    none of their weights."""
    part = copy.copy(module)
    part._modules = {k: None if k in names else v
                     for k, v in module._modules.items()}
    return part


def _skeleton(state):
    """``state``'s tree with None for every leaf."""
    flat = flatten_state(state)
    return unflatten_state(state, [None] * len(flat))


class _Stage(nn.Module, StreamStages):
    """One stage of a buffer as a program: forward(state leaves, *inputs)
    rebuilds the stream state from its leaves and runs the stage
    (``StreamStages``), writing the leaves in place.  The step stage takes
    (x, zt, tcond, scalars, slot) and returns the next x."""

    def __init__(self, key: str, template, latent_range: float,
                 codec: Optional[nn.Module] = None, crossfade=None,
                 rf: Optional[nn.Module] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.key = key
        self.template = template
        self.latent_range = latent_range
        self.compute_dtype = compute_dtype
        self.codec = codec
        self.rf = rf
        if crossfade is not None:
            crossfade = copy.copy(crossfade)
            crossfade.codec = codec
        self.crossfade = crossfade

    def forward(self, state: List[torch.Tensor], *inputs: torch.Tensor
                ) -> torch.Tensor:
        st = unflatten_state(self.template, state)
        if self.key == "structure":
            return self.structure_stage(st, *inputs)
        if self.key == "timbre":
            return self.timbre_stage(st, *inputs)
        if self.key == "decode":
            return self.decode_stage(st, *inputs)
        x, zt, tcond, scalars, slot = inputs
        return self.step_stage(st, slot, x, zt * self.latent_range, tcond,
                               scalars)


class _Stateless(nn.Module):
    """A program without state: the MIDI piano roll, or a projector map
    (``latent2map``: timbre vector -> pad position, ``map2latent``: the
    inverse) over ``projector`` (utils/latent_map.py)."""

    def __init__(self, key: str, latent_range: float = 1.0,
                 projector: Optional[nn.Module] = None):
        super().__init__()
        self.key = key
        self.latent_range = latent_range
        self.projector = projector

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.key == "piano_roll":
            return piano_roll(x)
        if self.key == "latent2map":
            return self.projector.encode(x * self.latent_range)
        return self.projector.decode(x) / self.latent_range


class _CodecStage(nn.Module, StreamStages):
    """A codec-only program: encode, decode, or forward (decode of encode,
    its state the pair of theirs), each over its own state's leaves."""

    def __init__(self, key: str, template, codec: nn.Module, crossfade=None):
        super().__init__()
        self.key = key
        self.template = template
        self.codec = codec
        self.crossfade = crossfade

    def forward(self, state: List[torch.Tensor], x: torch.Tensor
                ) -> torch.Tensor:
        st = unflatten_state(self.template, state)
        if self.key == "encode":
            return self._codec_encode(st, x)
        if self.key == "decode":
            return self._codec_decode(st, x)
        return self._codec_decode(st[1], self._codec_encode(st[0], x))


def _export(module: nn.Module, args: tuple, path: str) -> None:
    """``module(*args)`` run once (which fills every constant a module
    keeps, so that the trace reads real tensors), traced with torch.export
    and saved to ``path`` without its example inputs (the state would be
    stored again in every program)."""
    with torch.no_grad():
        module(*args)
        program = torch.export.export(module, args)
    program.example_inputs = None
    torch.export.save(program, path)


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype ("float32", "int32", ...), and
    "bfloat16" for bf16, as the JAX exporter names it."""
    return str(t.dtype).replace("torch.", "")


def _storable(t: torch.Tensor) -> np.ndarray:
    """A state leaf as numpy stores it: a bf16 one as the uint16 view of its
    bits (numpy has no bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _write_state(sdir: str, name: str, leaves: Sequence[torch.Tensor]
                 ) -> None:
    """``<name>.npz`` of the leaves (leaf_<i>) and, for the stream state,
    the raw leaf_<i>.bin of each."""
    os.makedirs(sdir, exist_ok=True)
    arrays = [_storable(t) for t in leaves]
    np.savez(os.path.join(sdir, f"{name}.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    if name == "initial_state":
        for i, a in enumerate(arrays):
            a.tofile(os.path.join(sdir, f"leaf_{i}.bin"))


def _state_keys(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {"n_state_leaves": len(flat),
            "state_shapes": [list(t.shape) for t in flat.values()],
            "state_dtypes": [_dtype_name(t) for t in flat.values()],
            "state_paths": list(flat)}


@torch.no_grad()
def export_streamer(streamer: Streamer, out_dir: str, nb_steps: int = 1,
                    guidance_timbre: float = 1.0,
                    guidance_structure: float = 1.0, batch_size: int = 1,
                    projector: Optional[nn.Module] = None) -> str:
    """Write ``streamer`` (its weights as they are now) as an artifact in
    ``out_dir``, traced on the streamer's device: a program a stage, the
    projector's two maps when ``projector`` is given, the initial state of
    ``batch_size`` voices and the manifest.  ``nb_steps`` and the guidances
    are the defaults of the runtime attributes."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = streamer.cfg
    device = streamer.device
    B, T, A = batch_size, streamer.chunk_size, streamer.audio_chunk
    S = cfg.denoiser.max_diffusion_steps
    state = streamer.new_state(B)
    flat = flatten_state(state)
    template = _skeleton(state)

    # the export copies: weights folded into buffers, each stage holding
    # only the submodules it runs
    codec = fold_weights(copy.deepcopy(streamer.codec)).eval()
    rf = fold_weights(copy.deepcopy(streamer.rf)).eval()
    enc = _without(codec, "decoder", "pqmf_inv")
    dec = _without(codec, "encoder", "pqmf")
    lr, cf = streamer.latent_range, streamer.crossfade
    cd = streamer.compute_dtype
    stages = {
        "structure": _Stage("structure", template, lr, enc, cf,
                            _without(rf, "net", "encoder", "classifier"), cd),
        "timbre": _Stage("timbre", template, lr, enc, cf,
                         _without(rf, "net", "encoder_time", "classifier"),
                         cd),
        "step": _Stage("step", template, lr, rf=_without(
            rf, "encoder", "encoder_time", "classifier"), compute_dtype=cd),
        "decode": _Stage("decode", template, lr, dec, cf, compute_dtype=cd),
    }

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    audio = zeros(B, A, 1)
    x = zeros(B, T, cfg.denoiser.n_channels)
    zt = zeros(B, cfg.zt_channels)
    tcond = zeros(B, T, cfg.zs_channels)
    scalars = torch.from_numpy(streamer.rf.stream_scalars()[1]).to(device)
    slot = torch.zeros((), dtype=torch.int64, device=device)
    args = {"structure": (audio,), "timbre": (audio,),
            "step": (x, zt, tcond, scalars, slot), "decode": (x,)}
    # each stage traced on a copy of the state, which its run writes
    for key, module in stages.items():
        leaves = [t.clone() for t in flat.values()]
        _export(module, (leaves, *args[key]),
                os.path.join(out_dir, f"{key}.pt2"))
    if streamer.is_midi:
        _export(_Stateless("piano_roll"),
                (zeros(B, T, streamer.n_poly, 2),),
                os.path.join(out_dir, "piano_roll.pt2"))
    if projector is not None:
        proj = copy.deepcopy(projector).eval().to(device)
        for key, arg in (("latent2map", zt), ("map2latent", zeros(B, 2))):
            _export(_Stateless(key, lr, proj), (arg,),
                    os.path.join(out_dir, f"{key}.pt2"))

    _write_state(os.path.join(out_dir, "state"), "initial_state",
                 list(flat.values()))
    methods = streamer.method_specs()
    manifest = {
        "format_version": FORMAT_VERSION,
        "runtime": RUNTIME,
        "methods": methods,
        "stages": {m: METHOD_STAGES[m] for m in methods
                   if m in METHOD_STAGES},
        "chunk_size": T,
        "audio_chunk": A,
        "batch_size": B,
        "ratio": streamer.ratio,
        "sr": cfg.sr,
        "decode_lag_frames": streamer.decode_lag_frames,
        "decode_lag_samples": streamer.decode_lag_samples,
        "streaming": "crossfade" if cf is not None else "cached",
        "nb_steps": nb_steps,
        "attributes": {
            "nb_steps": {"default": int(nb_steps), "dtype": "int32",
                         "min": 1, "max": int(S)},
            "guidance_timbre": {"default": float(guidance_timbre),
                                "dtype": "float32"},
            "guidance_structure": {"default": float(guidance_structure),
                                   "dtype": "float32"},
        },
        "latent_map": int(projector is not None),
        "n_poly": int(streamer.n_poly) if streamer.is_midi else 0,
        **_state_keys(flat),
        "config": json.loads(to_json(cfg)),
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


@torch.no_grad()
def export_codec(cfg: AutoEncoderConfig, codec_state: Dict[str, Any],
                 out_dir: str, chunk_size: int = 4, n_fade: int = 4,
                 crossfade: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None) -> str:
    """The codec-only artifact (encode, decode and their round trip
    ``forward``, each with its own state) of a codec's weights
    (``codec_state``, its state dict): through cached convs for a causal
    codec, through the crossfade path for a non-causal one or with
    ``crossfade`` set, traced on ``device`` (the card unless "cpu")."""
    from .crossfade import CrossfadeDecoder
    from .state import init_cache

    device = resolve_device(device)
    crossfade = (not cfg.causal) if crossfade is None else crossfade
    os.makedirs(out_dir, exist_ok=True)
    A = chunk_size * cfg.ratio
    audio = torch.zeros((1, A, 1), device=device)
    z = torch.zeros((1, chunk_size, cfg.z_channels), device=device)
    if crossfade:
        cf = CrossfadeDecoder(dataclasses.replace(cfg, causal=False),
                              n_fade=n_fade, chunk_size=chunk_size)
        codec = cf.codec
        codec.load_state_dict(codec_state)
        codec.to(device).eval()
        fold_weights(codec)
        states = {"encode": cf.init_encode_state(1),
                  "decode": cf.init_state(1)}
    else:
        cf = None
        codec = AudioCodec(cfg, streaming=True)
        codec.load_state_dict(codec_state)
        codec = fold_weights(codec.to(device).eval())
        states = {
            "encode": init_cache(lambda c: codec.encode(audio, c)),
            "decode": init_cache(lambda c: codec.decode(z, c))}
    states["forward"] = (states["encode"], states["decode"])
    for name in CODEC_METHODS:
        flat = flatten_state(states[name])
        leaves = [t.clone() for t in flat.values()]
        _export(_CodecStage(name, _skeleton(states[name]), codec, cf),
                (leaves, z if name == "decode" else audio),
                os.path.join(out_dir, f"{name}.pt2"))
        _write_state(out_dir, f"{name}_state", list(flat.values()))
    fwd = flatten_state(states["forward"])
    _write_state(os.path.join(out_dir, "state"), "initial_state",
                 list(fwd.values()))
    manifest = {
        "format_version": FORMAT_VERSION,
        "runtime": RUNTIME,
        "stages": {m: [m] for m in CODEC_METHODS},
        "ratio": cfg.ratio, "z_channels": cfg.z_channels, "sr": cfg.sr,
        "chunk_size": chunk_size, "audio_chunk": A, "batch_size": 1,
        "codec_only": 1,
        "streaming": "crossfade" if crossfade else "cached",
        "n_fade": n_fade if crossfade else 0,
        "decode_lag_frames": n_fade if crossfade else 0,
        "decode_lag_samples": (n_fade * cfg.ratio if crossfade
                               else decoder_band_delay(cfg) * cfg.pqmf_bands),
        **_state_keys(fwd),
        "config": dataclasses.asdict(cfg),
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def stream_scalars_of(manifest: Dict[str, Any]):
    """The ``stream_scalars`` function (nb_steps, guidance_timbre,
    guidance_structure) -> (nb, scalars) of an artifact's model, from its
    manifest: the rectified flow's or, where the config's
    ``diffusion_type`` is "edm", EDM's over the config's ladder."""
    S = int(manifest["attributes"]["nb_steps"]["max"])
    if manifest["config"].get("diffusion_type") == "edm":
        e = EDMConfig(**manifest["config"]["edm"])
        return lambda *a: edm.stream_scalars(e, S, *a)
    return lambda *a: rectified_flow.stream_scalars(S, *a)


def load_program(path: str, device: torch.device) -> nn.Module:
    """The program saved at ``path`` as a module on ``device``: moved there
    (``move_to_device_pass``) when it was traced on another device."""
    from torch.export.passes import move_to_device_pass
    program = torch.export.load(path)
    tensors = [*program.state_dict.values(), *program.constants.values()]
    if any(isinstance(t, torch.Tensor) and t.device != device
           for t in tensors):
        program = move_to_device_pass(program, device)
    return program.module()


def load_state(path: str, device: torch.device,
               dtypes: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """The leaves of a state ``.npz`` (leaf_<i>) on ``device``; a leaf whose
    entry of ``dtypes`` (a manifest's ``state_dtypes``) is "bfloat16" holds
    the uint16 bits of bf16 values (the port's and the JAX exporter's
    storage) and comes back as bf16."""
    z = np.load(path)
    leaves = []
    for i in range(len(z.files)):
        a = z[f"leaf_{i}"]
        if dtypes is not None and dtypes[i] == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        leaves.append(t.to(device))
    return leaves


class _Host:
    """What both hosts share: the device, the manifest, the programs, and
    on the card the CUDA graph of each stage, captured once at load after
    a warm-up whose writes to the state are undone.  Setting ``eager``
    runs the same stage calls op by op instead (for comparisons: a graph
    keeps the math switches, such as TF32, of its capture)."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.device = resolve_device(device)
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.graphs: Optional[GraphPool] = None
        self._graphs: Dict[Any, Any] = {}
        self.eager = False

    def _programs(self, names) -> Dict[str, nn.Module]:
        return {n: load_program(os.path.join(self.path, f"{n}.pt2"),
                                self.device)
                for n in names
                if os.path.exists(os.path.join(self.path, f"{n}.pt2"))}

    def _capture(self, stages: Dict[Any, Any], state) -> None:
        """On the card: every stage run once (the state restored after),
        then captured."""
        if self.device.type != "cuda":
            return
        self.graphs = GraphPool(self.device)
        with torch.no_grad():
            with restored(state):
                self.graphs.warm(lambda: [fn() for fn in stages.values()])
            for key, fn in stages.items():
                self._graphs[key] = self.graphs.capture(fn)

    def _run(self, stages: Dict[Any, Any], key):
        if self._graphs and not self.eager:
            return self._graphs[key].replay()
        with torch.no_grad():
            return stages[key]()


@dataclasses.dataclass
class _HostBuffers:
    """The inputs and outputs of an artifact's stages, at fixed
    addresses."""

    audio_s: torch.Tensor
    audio_t: torch.Tensor
    zs: torch.Tensor        # structure output (tcond itself for a2a models)
    tcond: torch.Tensor
    zt: torch.Tensor
    x: torch.Tensor
    scalars: torch.Tensor
    notes: Optional[torch.Tensor]


class ExportedStreamer(_Host):
    """Host of a streaming artifact: holds the stream state and plays the
    methods of the manifest buffer by buffer, on the card unless ``device``
    is "cpu".

    Runtime attributes (``set_attribute("nb_steps" | "guidance_timbre" |
    "guidance_structure", v)``, clamped to the manifest's bounds) take
    effect on the next buffer without a new capture: the step programs read
    them as device scalars.  The diffusing methods take the sampler's noise
    ``x0`` (B, chunk, latents); without it the host draws it from its own
    generator (``generator``, seeded 0)."""

    def __init__(self, path: str, device=None):
        super().__init__(path, device)
        m = self.manifest
        cfg = m["config"]
        self.S = int(m["attributes"]["nb_steps"]["max"])
        self.stream_scalars = stream_scalars_of(m)
        self.attributes = {k: v["default"]
                           for k, v in m["attributes"].items()}
        self.programs = self._programs(
            ["structure", "timbre", "step", "decode", "piano_roll",
             "latent2map", "map2latent"])
        self.state = load_state(
            os.path.join(path, "state", "initial_state.npz"), self.device,
            m["state_dtypes"])
        B, T = int(m["batch_size"]), int(m["chunk_size"])

        def zeros(*shape):
            return torch.zeros(shape, device=self.device)
        tcond = zeros(B, T, cfg["zs_channels"])
        struct_out = m["methods"]["structure"]["out_channels"]
        self.bufs = _HostBuffers(
            audio_s=zeros(B, m["audio_chunk"], 1),
            audio_t=zeros(B, m["audio_chunk"], 1),
            zs=(tcond if struct_out == cfg["zs_channels"]
                else zeros(B, T, struct_out)),
            tcond=tcond, zt=zeros(B, cfg["zt_channels"]),
            x=zeros(B, T, cfg["denoiser"]["n_channels"]),
            scalars=to_device(self.stream_scalars(1)[1], self.device),
            notes=(zeros(B, T, m["n_poly"], 2) if m["n_poly"] else None))
        self.slots = [torch.tensor(i, dtype=torch.int64, device=self.device)
                      for i in range(self.S)]
        self.generator = torch.Generator(self.device).manual_seed(0)
        self._stages = self._stage_calls()
        self._capture(self._stages, self.state)

    def _stage_calls(self) -> Dict[Any, Any]:
        """The calls of every stage, by key (a step by its KV slot), over
        the state and the buffers."""
        P, b, st = self.programs, self.bufs, self.state
        calls = {
            "structure": lambda: b.zs.copy_(P["structure"](st, b.audio_s)),
            "timbre": lambda: b.zt.copy_(P["timbre"](st, b.audio_t)),
            "decode": lambda: P["decode"](st, b.x)}
        for i in range(self.S):
            calls[i] = (lambda s=self.slots[i]: b.x.copy_(
                P["step"](st, b.x, b.zt, b.tcond, b.scalars, s)))
        if "piano_roll" in P:
            calls["piano_roll"] = lambda: b.tcond.copy_(
                P["piano_roll"](b.notes))
        return calls

    def has_method(self, name: str) -> bool:
        if self.manifest["methods"].get(name, {}).get("stateless"):
            return name in self.programs
        return name in self.manifest["stages"]

    def set_attribute(self, name: str, value):
        spec = self.manifest["attributes"].get(name)
        if spec is None:
            raise KeyError(f"no such attribute: {name}")
        value = int(value) if spec["dtype"] == "int32" else float(value)
        if "min" in spec:
            value = max(spec["min"], min(spec["max"], value))
        self.attributes[name] = value
        return value

    def get_attribute(self, name: str):
        return self.attributes[name]

    def call(self, name: str, *xs, x0=None) -> torch.Tensor:
        """Method ``name`` of the manifest on one buffer of inputs ``xs``
        (tensors or host arrays, the JAX artifact's inputs without the rng
        key); returns its output, a copy."""
        if not self.has_method(name):
            raise KeyError(f"the artifact has no method {name!r}")
        if self.manifest["methods"][name].get("stateless"):
            with torch.no_grad():
                return self.programs[name](to_device(xs[0], self.device))
        b = self.bufs
        for buf, x in zip(METHOD_INPUTS[name], xs):
            dst = getattr(b, buf)
            if tuple(np.shape(x)) != tuple(dst.shape):
                raise ValueError(f"{name}: input {buf} of shape "
                                 f"{tuple(np.shape(x))}, the artifact takes "
                                 f"{tuple(dst.shape)}")
            copy_from_host(dst, x)
        out = None
        for stage in self.manifest["stages"][name]:
            if stage != "step":
                out = self._run(self._stages, stage)
                continue
            if x0 is None:
                b.x.normal_(generator=self.generator)
            else:
                copy_from_host(b.x, x0)
            nb, values = self.stream_scalars(
                self.attributes["nb_steps"],
                self.attributes["guidance_timbre"],
                self.attributes["guidance_structure"])
            copy_from_host(b.scalars, values)
            for i in range(nb):
                self._run(self._stages, i)
            out = b.x
        return out.clone()

    def reset(self, path: Optional[str] = None) -> None:
        """The initial state (of ``path``'s artifact, by default this one's)
        written into the state's tensors, in place."""
        init = load_state(os.path.join(path or self.path, "state",
                                       "initial_state.npz"), self.device,
                          self.manifest["state_dtypes"])
        for t, v in zip(self.state, init):
            t.copy_(v)


class ExportedCodec(_Host):
    """Host of a codec-only artifact (``after-tpu-torch
    export_autoencoder``): ``encode``, ``decode`` and their fused round trip
    ``forward``, each with its own state, on the card unless ``device`` is
    "cpu"."""

    def __init__(self, path: str, device=None):
        super().__init__(path, device)
        m = self.manifest
        self.programs = self._programs(CODEC_METHODS)
        self._states = {n: load_state(os.path.join(path, f"{n}_state.npz"),
                                       self.device) for n in self.programs}
        A, T = int(m["audio_chunk"]), int(m["chunk_size"])
        self._inputs = {
            n: torch.zeros((1, T, m["z_channels"]) if n == "decode"
                           else (1, A, 1), device=self.device)
            for n in self.programs}
        P = self.programs
        self._calls = {n: (lambda n=n: P[n](self._states[n],
                                            self._inputs[n]))
                       for n in P}
        self._capture(self._calls, [t for s in self._states.values()
                                    for t in s])

    def _call(self, name: str, x) -> torch.Tensor:
        copy_from_host(self._inputs[name], x)
        return self._run(self._calls, name).clone()

    def encode(self, audio) -> torch.Tensor:
        """(1, chunk * ratio, 1) audio -> (1, chunk, z) latents."""
        return self._call("encode", audio)

    def decode(self, z) -> torch.Tensor:
        """(1, chunk, z) latents -> (1, chunk * ratio, 1) audio (delayed by
        manifest["decode_lag_frames"] latent frames on crossfade codecs)."""
        return self._call("decode", z)

    def forward(self, audio) -> torch.Tensor:
        """decode(encode(audio)) in one program, over its own state."""
        return self._call("forward", audio)

    def reset(self, path: Optional[str] = None) -> None:
        for n, state in self._states.items():
            init = load_state(os.path.join(path or self.path,
                                            f"{n}_state.npz"), self.device)
            for t, v in zip(state, init):
                t.copy_(v)
