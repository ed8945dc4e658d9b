"""Automatic music transcription (audio -> MIDI): the port of
after_tpu/dataset/basic_pitch.py, basic-pitch's ICASSP-2022 model.

    22.05 kHz audio -> CQT (27.5 Hz base, 3 bins a semitone, hop 256)
    -> log-normalised dB -> harmonic stacking (0.5x..7x)
    -> a small conv net with contour / note / onset heads
    -> polyphonic note extraction -> MidiFile

The net runs on (B, H=8, T, F=264) tensors (torch's NCHW with H = time and
W = frequency), the layout of the reference PyTorch model, so that its
weights load as they are; the JAX package's flax convs run channels-last on
(B, T, F, H) with the same kernels.  ``load_torch_weights`` reads a
reference state dict, ``reference_state_dict`` writes one.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .midi import MidiFile, Note

FFT_HOP = 256
CONTOURS_BINS_PER_SEMITONE = 3
ANNOTATIONS_BASE_FREQUENCY = 27.5
ANNOTATIONS_N_SEMITONES = 88
AUDIO_SAMPLE_RATE = 22050
MAX_N_SEMITONES = int(np.floor(12.0 * np.log2(0.5 * AUDIO_SAMPLE_RATE
                                              / ANNOTATIONS_BASE_FREQUENCY)))
N_FREQ_BINS_CONTOURS = ANNOTATIONS_N_SEMITONES * CONTOURS_BINS_PER_SEMITONE
STACK_HARMONICS = (0.5, 1, 2, 3, 4, 5, 6, 7)
BN_EPS = 1e-3


def _n_cqt_bins() -> int:
    n_semi = min(int(np.ceil(12.0 * np.log2(len(STACK_HARMONICS)))
                     + ANNOTATIONS_N_SEMITONES), MAX_N_SEMITONES)
    return n_semi * CONTOURS_BINS_PER_SEMITONE


def normalized_log(x: torch.Tensor) -> torch.Tensor:
    """dB-scale each (T, F) plane of (B, T, F) to [0, 1]."""
    log_power = 10.0 * torch.log10(x * x + 1e-10)
    off = log_power - log_power.amin(dim=(1, 2), keepdim=True)
    mx = off.amax(dim=(1, 2), keepdim=True)
    return torch.nan_to_num(off / torch.clamp_min(mx, 1e-10))


def harmonic_stacking(x: torch.Tensor) -> torch.Tensor:
    """(B, T, F) -> (B, H, T, N_FREQ_BINS_CONTOURS): the CQT shifted by each
    harmonic's bins (zero-filled), one channel a harmonic."""
    shifts = [int(round(12.0 * CONTOURS_BINS_PER_SEMITONE * math.log2(h)))
              for h in STACK_HARMONICS]
    out = []
    for s in shifts:
        if s > 0:
            cur = F.pad(x[:, :, s:], (0, s))
        elif s < 0:
            cur = F.pad(x[:, :, :s], (-s, 0))
        else:
            cur = x
        out.append(cur[:, :, :N_FREQ_BINS_CONTOURS])
    return torch.stack(out, dim=1)


class BasicPitchNet(nn.Module):
    """Conv heads over the harmonically stacked CQT (B, 8, T, 264) ->
    {"contour": (B, T, 264), "note": (B, T, 88), "onset": (B, T, 88)}, each
    in [0, 1].  Submodules carry the flax names."""

    def __init__(self):
        super().__init__()
        H = len(STACK_HARMONICS)
        self.contour_conv1 = nn.Conv2d(H, 8, (3, 39), padding=(1, 19))
        self.contour_bn = nn.BatchNorm2d(8, eps=BN_EPS)
        self.contour_conv2 = nn.Conv2d(8, 1, (5, 5), padding=(2, 2))
        self.note_conv1 = nn.Conv2d(1, 32, (7, 7), stride=(1, 3))
        self.note_conv2 = nn.Conv2d(32, 1, (7, 3), padding=(3, 1))
        self.onset_conv1 = nn.Conv2d(H, 32, (5, 5), stride=(1, 3))
        self.onset_bn = nn.BatchNorm2d(32, eps=BN_EPS)
        self.onset_conv2 = nn.Conv2d(33, 1, (3, 3), padding=(1, 1))

    def forward(self, hcqt: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = F.relu(self.contour_bn(self.contour_conv1(hcqt)))
        contour = torch.sigmoid(self.contour_conv2(h))
        # note head: the stride-3 conv over frequency after explicit pads
        h = F.relu(self.note_conv1(F.pad(contour, (2, 2, 3, 3))))
        note = torch.sigmoid(self.note_conv2(h))
        # onset head: a stride-3 conv on the hCQT, then with the note head
        h = self.onset_bn(self.onset_conv1(F.pad(hcqt, (1, 1, 2, 2))))
        h = torch.cat([note, F.relu(h)], dim=1)
        onset = torch.sigmoid(self.onset_conv2(h))
        return {"contour": contour[:, 0], "note": note[:, 0],
                "onset": onset[:, 0]}


class BasicPitch(nn.Module):
    """The transcription pipeline: CQT front end, the scalar batch norm of
    the CQT (``cqt_bn``: running mean and variance only, as the JAX package
    applies it), the net and the note extraction.  On the card unless
    ``device="cpu"``."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.net = BasicPitchNet()
        self.register_buffer("cqt_bn_mean", torch.zeros(()))
        self.register_buffer("cqt_bn_var", torch.ones(()))
        self.eval().to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.cqt_bn_mean.device

    @torch.inference_mode()
    def activations(self, audio: np.ndarray) -> Dict[str, np.ndarray]:
        """22.05 kHz mono audio -> onset/note/contour activations (T, bins)."""
        from ..ops.streaming_spectral import multirate_cqt
        x = torch.as_tensor(np.asarray(audio, np.float32).reshape(1, -1),
                            device=self.device)
        spec = multirate_cqt(x, AUDIO_SAMPLE_RATE, ANNOTATIONS_BASE_FREQUENCY,
                             _n_cqt_bins(), 12 * CONTOURS_BINS_PER_SEMITONE,
                             FFT_HOP)
        spec = normalized_log(spec)
        spec = (spec - self.cqt_bn_mean) / torch.sqrt(self.cqt_bn_var + BN_EPS)
        out = self.net(harmonic_stacking(spec))
        return {k: v[0].cpu().numpy() for k, v in out.items()}

    def transcribe(self, audio: np.ndarray, sr: int,
                   onset_thresh: float = 0.5, frame_thresh: float = 0.3,
                   min_note_len: int = 11) -> MidiFile:
        """Audio at ``sr`` -> MidiFile by polyphonic note extraction."""
        from .audio import resample
        if sr != AUDIO_SAMPLE_RATE:
            audio = resample(np.asarray(audio), sr, AUDIO_SAMPLE_RATE)
        acts = self.activations(audio)
        return notes_from_activations(acts["onset"], acts["note"],
                                      onset_thresh, frame_thresh,
                                      min_note_len)


def notes_from_activations(onsets: np.ndarray, frames: np.ndarray,
                           onset_thresh: float = 0.5,
                           frame_thresh: float = 0.3,
                           min_note_len: int = 11,
                           energy_tol: int = 11) -> MidiFile:
    """Polyphonic note extraction: onset peaks start notes; a note ends
    after ``energy_tol`` consecutive frames below ``frame_thresh``; notes
    shorter than ``min_note_len`` frames are dropped."""
    T, n_bins = frames.shape
    fps = AUDIO_SAMPLE_RATE / FFT_HOP
    # local onset peaks above threshold (boundary frames can be peaks too)
    padded = np.pad(onsets, ((1, 1), (0, 0)), constant_values=-1.0)
    peaks = ((padded[1:-1] > padded[:-2]) & (padded[1:-1] >= padded[2:])
             & (onsets > onset_thresh))

    notes: List[Note] = []
    remaining = frames.copy()
    for t0, pitch_bin in zip(*np.where(peaks)):
        t = t0 + 1
        gap = 0
        while t < T and gap < energy_tol:
            if remaining[t, pitch_bin] < frame_thresh:
                gap += 1
            else:
                gap = 0
            t += 1
        t_end = t - gap
        if t_end - t0 < min_note_len:
            continue
        amp = float(frames[t0:t_end, pitch_bin].mean())
        remaining[t0:t_end, pitch_bin] = 0
        notes.append(Note(pitch=int(pitch_bin) + 21,  # bin 0 = A0 (midi 21)
                          velocity=int(np.clip(amp, 0, 1) * 127),
                          start=float(t0 / fps), end=float(t_end / fps)))
    notes.sort(key=lambda n: n.start)
    return MidiFile(notes=notes)


# ---------------------------------------------------------------------------
# reference checkpoints: the reference PyTorch model's state-dict names
# ---------------------------------------------------------------------------

# reference module -> this port's module (the layers' tensors are alike)
_REFERENCE_NAMES = {
    "conv_contour.0": "net.contour_conv1", "conv_contour.1": "net.contour_bn",
    "conv_contour.3": "net.contour_conv2", "conv_note.0": "net.note_conv1",
    "conv_note.2": "net.note_conv2", "conv_onset_pre.0": "net.onset_conv1",
    "conv_onset_pre.1": "net.onset_bn", "conv_onset_post.0":
        "net.onset_conv2"}
_TENSORS = ("weight", "bias", "running_mean", "running_var")


def map_torch_state_dict(sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A reference basic-pitch state dict -> this port's ``BasicPitch``
    state dict; of the CQT's ``bn_layer`` only its running mean and
    variance are read, as the JAX package reads them."""
    out = {}
    for ref, ours in _REFERENCE_NAMES.items():
        for t in _TENSORS:
            if f"{ref}.{t}" in sd:
                out[f"{ours}.{t}"] = sd[f"{ref}.{t}"]
            elif t in ("weight", "bias") or ours.endswith("_bn"):
                raise KeyError(f"{ref}.{t} missing from the basic-pitch "
                               f"state dict")
    out["cqt_bn_mean"] = sd["bn_layer.running_mean"].reshape(-1)[0]
    out["cqt_bn_var"] = sd["bn_layer.running_var"].reshape(-1)[0]
    return out


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """The reference basic-pitch checkpoint at ``path`` as this port's
    ``BasicPitch`` state dict (``model.load_state_dict(...)``)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return map_torch_state_dict(sd)


def reference_state_dict(model: BasicPitch) -> Dict[str, torch.Tensor]:
    """``model``'s weights under the reference model's names, the inverse
    of ``map_torch_state_dict`` (``bn_layer`` a BatchNorm2d(1) with unit
    scale and zero shift)."""
    ours = model.state_dict()
    sd = {f"{ref}.{t}": ours[f"{name}.{t}"].detach().cpu().clone()
          for ref, name in _REFERENCE_NAMES.items() for t in _TENSORS
          if f"{name}.{t}" in ours}
    sd.update({"bn_layer.weight": torch.ones(1), "bn_layer.bias":
               torch.zeros(1),
               "bn_layer.running_mean": ours["cqt_bn_mean"].cpu().reshape(1),
               "bn_layer.running_var": ours["cqt_bn_var"].cpu().reshape(1)})
    return sd
