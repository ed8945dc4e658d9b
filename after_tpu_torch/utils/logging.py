"""Training metrics (the port's copy of after_tpu/utils/logging.py).

- ``MetricsLogger``: window-averaged scalars, always to
  ``model_dir/metrics.jsonl`` and to TensorBoard where
  ``torch.utils.tensorboard`` imports, with the steps per second of each
  window;
- ``log_audio``: a WAV file under ``model_dir/audio/`` (and TensorBoard);
- ``profile_trace``: a ``torch.profiler`` trace of a block of steps.

The trainers hand the logger device tensors, and a graphed diffusion step
reads nothing back, so ``log`` only keeps them: ``flush`` stacks the
window's tensors on each device and copies them to the host once.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

FLUSH_EVERY = 100   # steps a metrics.jsonl line averages


class MetricsLogger:

    def __init__(self, model_dir: str):
        os.makedirs(model_dir, exist_ok=True)
        self.model_dir = model_dir
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)
        self._pending: Dict[str, list] = {}
        self._jsonl = open(os.path.join(model_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(log_dir=os.path.join(model_dir, "logs"))
        self._t_last = time.perf_counter()
        self._steps_since = 0

    def log(self, step: int, metrics: Dict[str, object],
            n_steps: int = 1) -> None:
        """Keep ``metrics`` (numbers or 0-dim tensors) for the window;
        ``n_steps`` > 1 when they sum up a ``steps_per_call`` window.
        Flushes every FLUSH_EVERY steps."""
        for k, v in metrics.items():
            self._pending.setdefault(k, []).append(v)
        self._steps_since += n_steps
        if step % FLUSH_EVERY == 0 and step > 0:
            self.flush(step)

    def _fetch_pending(self) -> None:
        """One copy to the host per device for the whole window: a read per
        scalar would wait for the device at every step."""
        flat = [(k, v) for k, vals in self._pending.items() for v in vals]
        values = [v for _, v in flat]
        by_device: Dict[torch.device, list] = {}
        for i, v in enumerate(values):
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append(i)
        for idx in by_device.values():
            stacked = torch.stack([values[i].detach().reshape(())
                                   .to(torch.float64) for i in idx])
            for i, f in zip(idx, stacked.cpu().numpy()):
                values[i] = f
        for (k, _), v in zip(flat, values):
            self._sums[k] += float(v)
            self._counts[k] += 1
        self._pending.clear()

    def flush(self, step: int) -> None:
        now = time.perf_counter()
        self._fetch_pending()
        avg = {k: self._sums[k] / max(self._counts[k], 1)
               for k in self._sums}
        avg["steps_per_sec"] = self._steps_since / max(now - self._t_last,
                                                       1e-9)
        self._jsonl.write(json.dumps({"step": step, **avg}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in avg.items():
                self._tb.add_scalar(f"Loss/{k}", v, global_step=step)
        self._sums.clear()
        self._counts.clear()
        self._t_last = now
        self._steps_since = 0

    def log_audio(self, step: int, name: str, audio: np.ndarray,
                  sr: int) -> None:
        from ..dataset.audio import save_wav
        audio = np.asarray(audio).reshape(-1)
        adir = os.path.join(self.model_dir, "audio")
        os.makedirs(adir, exist_ok=True)
        save_wav(os.path.join(adir, f"{name.replace('/', '_')}_{step}.wav"),
                 audio, sr)
        if self._tb is not None:
            self._tb.add_audio(name, audio[None], global_step=step,
                               sample_rate=sr)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def profile_trace(log_dir: str):
    """A ``torch.profiler`` context over the card and the host whose trace
    lands in ``log_dir`` (TensorBoard's trace format) when it closes."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
