"""Beat This! beat and downbeat tracker: the port of
after_tpu/dataset/beat_tracker.py (a RoFormer over a log-mel spectrogram).

The network runs on (B, C, F, T) grids (torch's NCHW with H = mel
frequency and W = time), the reference PyTorch model's layout, so that its
weights load as they are; submodules carry the flax names of the JAX
package's ``BeatThis``.  The attention is two matmuls and a softmax, as the
JAX package computes it.  ``log_mel_spect`` is the front end, the
postprocessors (peak picking and the bar-pointer DBN) are numpy copies, and
``Audio2Beats`` runs the whole tracker over chunks with borders.
``load_torch_weights`` reads a reference state dict,
``reference_state_dict`` writes one.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rotary import apply_rotary, rotary_angles
from ..ops.stft import mel_filterbank, on_device, spectrogram
from ..utils.device import resolve_device

FPS = 50                # 22050 / 441
SR = 22050
N_FFT, HOP, N_MELS = 1024, 441, 128


# ---------------------------------------------------------------------------
# RoFormer pieces
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """x / max(|x|, 1e-12) * sqrt(size) * gamma over the last axis."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size
        self.gamma = nn.Parameter(torch.ones(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp_min(norm, 1e-12) * float(np.sqrt(self.size)) \
            * self.gamma


class RoFeedForward(nn.Module):
    """RMSNorm -> Dense (x mult) -> exact GELU -> Dense."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.add_module("in", nn.Linear(dim, dim * mult))
        self.out = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = getattr(self, "in")(self.norm(x))
        return self.out(F.gelu(h))


class RoAttention(nn.Module):
    """Gated rotary attention: RMSNorm -> qkv -> rotary(q, k) -> softmax
    attention -> sigmoid gates per head -> out projection."""

    def __init__(self, dim: int, heads: int, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Linear(heads * dim_head, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        H, D = self.heads, self.dim_head
        h = self.norm(x)
        qkv = self.to_qkv(h).reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        ang = on_device(x.device, _angles, N, D)
        q = apply_rotary(q, ang)
        k = apply_rotary(k, ang)
        logits = torch.matmul(q, k.transpose(-1, -2)) / float(np.sqrt(D))
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        gates = torch.sigmoid(self.to_gates(h))              # (B, N, H)
        out = out * gates.transpose(1, 2)[..., None]
        return self.to_out(out.transpose(1, 2).reshape(B, N, H * D))


def _angles(n: int, dim_head: int) -> np.ndarray:
    return rotary_angles(np.arange(n, dtype=np.float64), dim_head)


class RoTransformer(nn.Module):

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int = 32,
                 ff_mult: int = 4):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_{i}", RoAttention(dim, heads, dim_head))
            self.add_module(f"ff_{i}", RoFeedForward(dim, ff_mult))
        self.norm = RMSNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return self.norm(x)


# ---------------------------------------------------------------------------
# the BeatThis network
# ---------------------------------------------------------------------------


class PartialFTTransformer(nn.Module):
    """Attention and feed-forward once across frequencies, once across
    time, on a (B, C, F, T) grid."""

    def __init__(self, dim: int, dim_head: int = 32):
        super().__init__()
        heads = dim // dim_head
        self.attnF = RoAttention(dim, heads, dim_head)
        self.ffF = RoFeedForward(dim)
        self.attnT = RoAttention(dim, heads, dim_head)
        self.ffT = RoFeedForward(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, Fq, T = x.shape
        # frequency-directed: sequences of F per (b, t)
        h = x.permute(0, 3, 2, 1).reshape(B * T, Fq, C)
        h = self.attnF(h) + h
        h = self.ffF(h) + h
        # time-directed: sequences of T per (b, f)
        h = h.reshape(B, T, Fq, C).transpose(1, 2).reshape(B * Fq, T, C)
        h = self.attnT(h) + h
        h = self.ffT(h) + h
        return h.reshape(B, Fq, T, C).permute(0, 3, 1, 2)


class BeatThis(nn.Module):
    """Spectrogram (B, T, 128 mel) -> framewise beat / downbeat logits
    {"beat": (B, T), "downbeat": (B, T)} (the sum-head variant: the beat
    logits absorb the downbeat logits)."""

    def __init__(self, spect_dim: int = N_MELS, transformer_dim: int = 512,
                 ff_mult: int = 4, n_layers: int = 6, head_dim: int = 32,
                 stem_dim: int = 32):
        super().__init__()
        self.stem_bn1d = nn.BatchNorm1d(spect_dim)
        self.stem_conv = nn.Conv2d(1, stem_dim, (4, 3), stride=(4, 1),
                                   padding=(0, 1), bias=False)
        self.stem_bn2d = nn.BatchNorm2d(stem_dim)
        dim, fq = stem_dim, spect_dim // 4
        for i in range(3):
            self.add_module(f"partial_{i}", PartialFTTransformer(dim, head_dim))
            self.add_module(f"conv_{i}", nn.Conv2d(
                dim, 2 * dim, (2, 3), stride=(2, 1), padding=(0, 1),
                bias=False))
            self.add_module(f"bn_{i}", nn.BatchNorm2d(2 * dim))
            dim, fq = 2 * dim, fq // 2
        self.linear = nn.Linear(dim * fq, transformer_dim)
        self.transformer = RoTransformer(transformer_dim, n_layers,
                                         transformer_dim // head_dim,
                                         head_dim, ff_mult)
        self.head = nn.Linear(transformer_dim, 2)

    def forward(self, spect: torch.Tensor) -> Dict[str, torch.Tensor]:
        # per-mel-bin BatchNorm, then the (4, 3) / (4, 1) conv over (F, T)
        h = self.stem_bn1d(spect.transpose(1, 2))[:, None]   # (B, 1, F, T)
        h = F.gelu(self.stem_bn2d(self.stem_conv(h)))
        for i in range(3):
            h = getattr(self, f"partial_{i}")(h)
            h = getattr(self, f"conv_{i}")(h)
            h = F.gelu(getattr(self, f"bn_{i}")(h))
        # "b c f t -> b t (c f)": channel-major over the remaining freqs
        B, C, Fq, T = h.shape
        h = self.linear(h.permute(0, 3, 1, 2).reshape(B, T, C * Fq))
        bd = self.head(self.transformer(h))                   # (B, T, 2)
        beat, downbeat = bd[..., 0], bd[..., 1]
        return {"beat": beat + downbeat, "downbeat": downbeat}


# ---------------------------------------------------------------------------
# log-mel front end
# ---------------------------------------------------------------------------


def log_mel_spect(x: torch.Tensor) -> torch.Tensor:
    """(T,) 22.05 kHz waveform -> (frames, 128) log1p(1000 * mel):
    Hann 1024 / 441, centred, magnitudes over sqrt(n_fft), the Slaney mel
    scale from 30 Hz to 11 kHz without area normalisation."""
    spec = spectrogram(x, N_FFT, HOP, power=1.0, normalized=False,
                       center=True) / float(np.sqrt(N_FFT))
    fb = on_device(x.device, mel_filterbank, SR, N_FFT, N_MELS, 30.0,
                   11000.0, False, False)
    return torch.log1p(1000.0 * (spec @ fb.T))


# ---------------------------------------------------------------------------
# postprocessors (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _pick_peaks(logits: np.ndarray, fps: int) -> np.ndarray:
    """Local maxima within +/-3 frames with logit > 0 -> times in seconds."""
    T = len(logits)
    padded = np.pad(logits, (3, 3), constant_values=-1000.0)
    windows = np.stack([padded[i:i + T] for i in range(7)], axis=0)
    is_peak = (logits >= windows.max(axis=0)) & (logits > 0)
    frames = np.nonzero(is_peak)[0]
    # deduplicate adjacent peaks (postprocessor.deduplicate_peaks width=1)
    keep = []
    for f in frames:
        if keep and f - keep[-1] <= 1:
            continue
        keep.append(f)
    return np.asarray(keep, dtype=np.float64) / fps


def postprocess_minimal(beat_logits: np.ndarray,
                        downbeat_logits: np.ndarray,
                        fps: int = FPS) -> Tuple[np.ndarray, np.ndarray]:
    beat = _pick_peaks(np.asarray(beat_logits), fps)
    down = _pick_peaks(np.asarray(downbeat_logits), fps)
    if len(beat):
        down = np.unique([beat[np.argmin(np.abs(beat - d))] for d in down])
    return beat, down


# ---------------------------------------------------------------------------
# DBN postprocessor: the bar-pointer hidden-Markov model of madmom's
# DBNDownBeatTrackingProcessor(beats_per_bar=[3,4], min_bpm=55,
# max_bpm=215, transition_lambda=100) (Boeck et al., "Joint beat and
# downbeat tracking with recurrent neural networks", ISMIR 2016), in numpy:
#   states   (meter b, beat interval tau, beat-in-bar, position-in-beat)
#   obs      each beat split into 16 cells; cell 0 observes the (down)beat
#            activation, the rest (1 - beat - down)/(16 - 1)
#   trans    deterministic position advance; at beat boundaries the tempo
#            may change with penalty exp(-lambda * |tau'/tau - 1|)
#   decode   exact Viterbi; beats = frames entering position 0, downbeats =
#            beats with beat-in-bar 0, each snapped to the max activation
#            inside its cell-0 window (madmom correct=True)
# ---------------------------------------------------------------------------

_OBS_LAMBDA = 16  # observation cells per beat (madmom default)


def _tempo_transition(taus: np.ndarray, lam: float) -> np.ndarray:
    """log P(tau_to | tau_from): exponential_transition, rows normalized."""
    ratio = taus[None, :] / taus[:, None].astype(np.float64)
    p = np.exp(-lam * np.abs(ratio - 1.0))
    p /= p.sum(axis=1, keepdims=True)
    return np.log(p)


def postprocess_dbn(beat_logits: np.ndarray, downbeat_logits: np.ndarray,
                    fps: int = FPS, beats_per_bar=(3, 4),
                    min_bpm: float = 55.0, max_bpm: float = 215.0,
                    transition_lambda: float = 100.0,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Joint beat/downbeat decode of framewise logits via the bar-pointer
    DBN (the reference Postprocessor(type="dbn") path)."""
    eps = 1e-5
    # tanh form is overflow-free for the -1000 border fills
    beat = 0.5 * (1.0 + np.tanh(0.5 * np.asarray(beat_logits, np.float64)))
    down = 0.5 * (1.0 + np.tanh(0.5 * np.asarray(downbeat_logits,
                                                 np.float64)))
    beat = beat * (1 - eps) + eps / 2
    down = down * (1 - eps) + eps / 2
    # artificial multiclass activations (postp_dbn_item): [beat-only, down]
    act = np.stack([np.maximum(beat - down, eps / 2), down], axis=1)
    T = len(act)
    # per-frame log-densities of the 3 observation classes
    log_obs = np.log(np.stack([
        np.maximum((1.0 - act.sum(1)) / (_OBS_LAMBDA - 1), 1e-30),
        act[:, 0], act[:, 1]], axis=1))          # (T, 3)

    taus = np.arange(int(round(60.0 * fps / max_bpm)),
                     int(round(60.0 * fps / min_bpm)) + 1)
    n_tau, tau_max = len(taus), int(taus[-1])
    log_trans = _tempo_transition(taus, transition_lambda)
    pos_valid = np.arange(tau_max)[None, :] < taus[:, None]   # (n_tau, pos)

    best = (-np.inf, None)  # (final log prob, decoded per-frame path)
    for b in beats_per_bar:
        # observation class per state (n_tau, b, pos)
        cell = (np.arange(tau_max)[None, :] * _OBS_LAMBDA) // taus[:, None]
        obs_idx = np.where(cell == 0, 1, 0)[:, None, :] * np.ones(
            (1, b, 1), np.int64)
        obs_idx[:, 0, :][cell == 0] = 2        # first beat of bar: downbeat
        n_states = b * int(taus.sum())
        delta = np.where(pos_valid[:, None, :], -np.log(float(n_states)),
                         -np.inf) + log_obs[0][obs_idx]
        bp_tau = np.zeros((T, n_tau, b), np.int64)   # argmax tau' at pos 0
        tau_end = taus - 1                           # last position per tau
        for t in range(1, T):
            ends = delta[np.arange(n_tau), :, tau_end]       # (n_tau, b)
            prev_beat = ends[:, (np.arange(b) - 1) % b]      # wrap bar
            # scores of entering pos 0 at tempo tau from each tau'
            score = prev_beat[:, None, :] + log_trans[:, :, None]
            bp_tau[t] = np.argmax(score, axis=0)
            new0 = np.max(score, axis=0)                     # (n_tau, b)
            delta[:, :, 1:] = delta[:, :, :-1]
            delta[:, :, 0] = new0
            delta = np.where(pos_valid[:, None, :], delta, -np.inf)
            delta += log_obs[t][obs_idx]
        flat = np.argmax(delta)
        if delta.flat[flat] > best[0]:
            ti, bi, pi = np.unravel_index(flat, delta.shape)
            path = np.empty((T, 3), np.int64)                # tau_i, beat, pos
            path[T - 1] = (ti, bi, pi)
            for t in range(T - 1, 0, -1):
                ti, bi, pi = path[t]
                path[t - 1] = ((ti, bi, pi - 1) if pi > 0 else
                               (bp_tau[t, ti, bi], (bi - 1) % b,
                                int(tau_end[bp_tau[t, ti, bi]])))
            best = (delta.flat[flat], path)

    path = best[1]
    if path is None or T == 0:
        return np.array([]), np.array([])
    onsets = np.nonzero(path[:, 2] == 0)[0]
    # snap each beat to the max combined activation inside its cell-0
    # window (madmom correct=True)
    window = (np.arange(tau_max)[None, :] * _OBS_LAMBDA
              < taus[:, None]).sum(1)            # cell-0 width per tempo
    comb = act.sum(1)
    times, numbers = [], []
    for f in onsets:
        w = int(window[path[f, 0]])
        seg = comb[f:min(f + w, T)]
        times.append((f + int(np.argmax(seg))) / fps)
        numbers.append(int(path[f, 1]))
    times = np.asarray(times, np.float64)
    numbers = np.asarray(numbers)
    return times, times[numbers == 0]


class Postprocessor:
    """Reference-API postprocessor (model/postprocessor.py:9-38): maps
    framewise beat/downbeat LOGITS to (beat_times, downbeat_times) seconds
    via "minimal" peak picking or the "dbn" bar-pointer decode."""

    def __init__(self, type: str = "minimal", fps: int = FPS):
        if type not in ("minimal", "dbn"):
            raise ValueError(f"unknown postprocessor type: {type}")
        self.type = type
        self.fps = fps

    def __call__(self, beat_logits, downbeat_logits
                 ) -> Tuple[np.ndarray, np.ndarray]:
        fn = (postprocess_minimal if self.type == "minimal"
              else postprocess_dbn)
        return fn(np.asarray(beat_logits), np.asarray(downbeat_logits),
                  fps=self.fps)


# ---------------------------------------------------------------------------
# inference driver: chunks with borders
# ---------------------------------------------------------------------------


class Audio2Beats:
    """waveform -> (beat_times, downbeat_times) in seconds.

    ``checkpoint_path``: a reference BeatThis state dict; without one the
    network keeps its random initialisation (for tests).  ``dbn`` picks
    the bar-pointer decode instead of peak picking.  On the card unless
    ``device="cpu"``."""

    CHUNK, BORDER = 1500, 6

    def __init__(self, checkpoint_path: Optional[str] = None,
                 dbn: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 net: Optional[BeatThis] = None):
        self.device = resolve_device(device)
        self.postprocessor = Postprocessor(type="dbn" if dbn else "minimal")
        self.net = (net or BeatThis()).eval().to(self.device)
        if checkpoint_path:
            self.net.load_state_dict(load_torch_weights(checkpoint_path))

    @torch.inference_mode()
    def logits(self, waveform: np.ndarray, sr: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Framewise (beat, downbeat) logits of the whole waveform; frames
        no chunk predicts hold -1000."""
        from .audio import resample
        x = np.asarray(waveform, np.float32).reshape(-1)
        if sr != SR:
            x = resample(x, sr, SR)
        spect = log_mel_spect(torch.as_tensor(x, device=self.device))
        T = spect.shape[0]
        C, Bd = self.CHUNK, self.BORDER
        beat = np.full(T, -1000.0, np.float32)
        down = np.full(T, -1000.0, np.float32)
        starts = list(range(-Bd, T - Bd, C - 2 * Bd)) or [-Bd]
        for s in starts:
            lo, hi = max(s, 0), min(s + C, T)
            front = max(0, -s)
            chunk = F.pad(spect[lo:hi], (0, 0, front, C - (hi - lo) - front))
            out = self.net(chunk[None])
            b = out["beat"][0].cpu().numpy()
            d = out["downbeat"][0].cpu().numpy()
            take_lo, take_hi = lo + Bd, min(hi, T)
            src_lo = take_lo - s
            beat[take_lo:take_hi] = b[src_lo:src_lo + take_hi - take_lo]
            down[take_lo:take_hi] = d[src_lo:src_lo + take_hi - take_lo]
        return beat, down

    def __call__(self, waveform: np.ndarray, sr: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        # the first border frames never get predictions; they stay at -1000
        # (never peaks)
        return self.postprocessor(*self.logits(waveform, sr))


# ---------------------------------------------------------------------------
# reference checkpoints: the reference PyTorch model's state-dict names
# ---------------------------------------------------------------------------

_BN = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
_ATTN = [("norm.gamma", "norm.gamma"), ("to_qkv.weight", "to_qkv.weight"),
         ("to_gates.weight", "to_gates.weight"),
         ("to_gates.bias", "to_gates.bias"),
         ("to_out.weight", "to_out.0.weight")]
_FF = [("norm.gamma", "net.0.gamma"), ("in.weight", "net.1.weight"),
       ("in.bias", "net.1.bias"), ("out.weight", "net.4.weight"),
       ("out.bias", "net.4.bias")]


def _names(n_layers: int) -> List[Tuple[str, str]]:
    """(this port's name, the reference's name) of every tensor of a
    BeatThis with ``n_layers`` transformer layers."""
    pairs = [(f"{p}.{t}", f"frontend.stem.{r}.{t}")
             for p, r in (("stem_bn1d", "bn1d"), ("stem_bn2d", "bn2d"))
             for t in _BN]
    pairs.append(("stem_conv.weight", "frontend.stem.conv2d.weight"))
    for i in range(3):
        base = f"frontend.blocks.{i}"
        for part, sub in (("attnF", _ATTN), ("ffF", _FF), ("attnT", _ATTN),
                          ("ffT", _FF)):
            pairs += [(f"partial_{i}.{part}.{p}",
                       f"{base}.partial.{part}.{r}") for p, r in sub]
        pairs.append((f"conv_{i}.weight", f"{base}.conv2d.weight"))
        pairs += [(f"bn_{i}.{t}", f"{base}.norm.{t}") for t in _BN]
    pairs += [(f"linear.{t}", f"frontend.linear.{t}")
              for t in ("weight", "bias")]
    for i in range(n_layers):
        layer = f"transformer_blocks.layers.{i}"
        pairs += [(f"transformer.attn_{i}.{p}", f"{layer}.0.{r}")
                  for p, r in _ATTN]
        pairs += [(f"transformer.ff_{i}.{p}", f"{layer}.1.{r}")
                  for p, r in _FF]
    pairs.append(("transformer.norm.gamma", "transformer_blocks.norm.gamma"))
    pairs += [(f"head.{t}", f"task_heads.beat_downbeat_lin.{t}")
              for t in ("weight", "bias")]
    return pairs


def _strip(key: str) -> str:
    # torch.compile may wrap the outer module: strip '_orig_mod.' first, so
    # that '_orig_mod.model.*' keys also lose the 'model.' prefix
    key = key.replace("_orig_mod.", "")
    return key[len("model."):] if key.startswith("model.") else key


def map_torch_state_dict(sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A reference BeatThis state dict -> this port's ``BeatThis`` state
    dict (a BatchNorm's ``num_batches_tracked`` is 0 where the reference
    has none)."""
    sd = {_strip(k): v for k, v in sd.items()}
    layers = {int(m.group(1)) for k in sd
              for m in [re.match(r"transformer_blocks\.layers\.(\d+)\.", k)]
              if m}
    out = {}
    for ours, ref in _names(len(layers)):
        if ref in sd:
            out[ours] = torch.as_tensor(sd[ref])
        elif ours.endswith("num_batches_tracked"):
            out[ours] = torch.zeros((), dtype=torch.long)
        else:
            raise KeyError(f"{ref} missing from the BeatThis state dict")
    return out


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """The reference BeatThis checkpoint at ``path`` as this port's
    ``BeatThis`` state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return map_torch_state_dict(sd)


def reference_state_dict(net: BeatThis) -> Dict[str, torch.Tensor]:
    """``net``'s weights under the reference model's names, the inverse of
    ``map_torch_state_dict``."""
    ours = net.state_dict()
    return {ref: ours[name].detach().cpu().clone()
            for name, ref in _names(net.transformer.depth)}
