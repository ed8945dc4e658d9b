"""Minimal standard-MIDI-file parser and piano roll (the port's copy of
after_tpu/dataset/midi.py, numpy only).

SMF format 0/1 parsing with tempo-map tick-to-second conversion, note
extraction, ``get_piano_roll(times)`` (what the diffusion collate reads),
``slice`` (what ``prepare_dataset`` stores a chunk) and ``save``.

Record stores keep a record's MIDI as ``pickle.dumps`` of a ``MidiFile``
that names ``after_tpu.dataset.midi``'s classes: the JAX package pickles
its own, and the port writes the same bytes by hand (``dumps``), so that
the JAX collate reads either store without torch.  Stores that earlier
versions of the port prepared name this module's classes.  ``loads`` reads
all of them onto this module's classes without importing the JAX package.  The
JAX package's transcriptions carry numpy integers and floats, which load as
Python numbers; a pickle that names any other global is refused.
"""

from __future__ import annotations

import io
import pickle
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Note:
    pitch: int
    velocity: int
    start: float   # seconds
    end: float


class MidiFile:

    def __init__(self, path: Optional[str] = None,
                 notes: Optional[List[Note]] = None,
                 data: Optional[bytes] = None):
        self.notes: List[Note] = notes or []
        if path is not None:
            with open(path, "rb") as f:
                self._parse(f.read())
        elif data is not None:
            self._parse(data)

    # -- parsing -----------------------------------------------------------

    @staticmethod
    def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
        value = 0
        while True:
            b = data[pos]
            pos += 1
            value = (value << 7) | (b & 0x7F)
            if not b & 0x80:
                return value, pos

    def _parse(self, data: bytes) -> None:
        if data[:4] != b"MThd":
            raise ValueError("not a MIDI file")
        _, fmt, ntrk, division = struct.unpack(">IHHH", data[4:14])
        if division & 0x8000:
            raise ValueError("SMPTE time division not supported")
        pos = 14

        # first pass: (tick, tempo) changes and raw note events per track
        tempo_changes: List[Tuple[int, int]] = [(0, 500000)]  # 120 bpm
        raw_tracks = []
        for _ in range(ntrk):
            if data[pos:pos + 4] != b"MTrk":
                raise ValueError("bad track chunk")
            (length,) = struct.unpack(">I", data[pos + 4:pos + 8])
            chunk = data[pos + 8:pos + 8 + length]
            pos += 8 + length
            raw_tracks.append(self._parse_track(chunk, tempo_changes))

        tempo_changes.sort()
        ticks = np.array([t for t, _ in tempo_changes], dtype=np.float64)
        tempos = np.array([q for _, q in tempo_changes], dtype=np.float64)
        sec_at = np.zeros(len(ticks))
        for i in range(1, len(ticks)):
            sec_at[i] = sec_at[i - 1] + (ticks[i] - ticks[i - 1]) \
                * tempos[i - 1] / 1e6 / division

        def to_sec(tick: float) -> float:
            i = int(np.searchsorted(ticks, tick, side="right") - 1)
            return float(sec_at[i] + (tick - ticks[i])
                         * tempos[i] / 1e6 / division)

        for events in raw_tracks:
            active = {}
            for tick, status, p1, p2 in events:
                kind = status & 0xF0
                if kind == 0x90 and p2 > 0:         # note on
                    active.setdefault((status & 0x0F, p1), []).append(
                        (tick, p2))
                elif kind == 0x80 or (kind == 0x90 and p2 == 0):  # note off
                    key = (status & 0x0F, p1)
                    if active.get(key):
                        start_tick, vel = active[key].pop(0)
                        self.notes.append(Note(p1, vel, to_sec(start_tick),
                                               to_sec(tick)))
        self.notes.sort(key=lambda n: n.start)

    def _parse_track(self, chunk: bytes, tempo_changes) -> List[Tuple]:
        events = []
        pos, tick, running = 0, 0, 0
        while pos < len(chunk):
            delta, pos = self._read_varint(chunk, pos)
            tick += delta
            status = chunk[pos]
            if status < 0x80:        # running status
                status = running
            else:
                pos += 1
                running = status
            if status == 0xFF:       # meta
                meta_type = chunk[pos]
                pos += 1
                mlen, pos = self._read_varint(chunk, pos)
                if meta_type == 0x51 and mlen == 3:
                    tempo = int.from_bytes(chunk[pos:pos + 3], "big")
                    tempo_changes.append((tick, tempo))
                pos += mlen
            elif status in (0xF0, 0xF7):   # sysex
                slen, pos = self._read_varint(chunk, pos)
                pos += slen
            else:
                kind = status & 0xF0
                if kind in (0xC0, 0xD0):   # 1-byte messages
                    pos += 1
                else:
                    p1, p2 = chunk[pos], chunk[pos + 1]
                    pos += 2
                    if kind in (0x80, 0x90):
                        events.append((tick, status, p1, p2))
        return events

    # -- rendering ---------------------------------------------------------

    def duration(self) -> float:
        return max((n.end for n in self.notes), default=0.0)

    def slice(self, start: float, end: float) -> "MidiFile":
        """Notes overlapping [start, end), re-based to start=0."""
        out = []
        for n in self.notes:
            if n.end > start and n.start < end:
                out.append(Note(n.pitch, n.velocity,
                                max(n.start - start, 0.0),
                                min(n.end - start, end - start)))
        return MidiFile(notes=out)

    def get_piano_roll(self, times: np.ndarray) -> np.ndarray:
        """(128, len(times)) velocity roll sampled at ``times`` seconds."""
        roll = np.zeros((128, len(times)), dtype=np.float32)
        t = np.asarray(times)
        for n in self.notes:
            mask = (t >= n.start) & (t < n.end)
            roll[n.pitch, mask] = n.velocity
        return roll

    def get_note_pairs(self, times: np.ndarray, n_poly: int) -> np.ndarray:
        """(len(times), n_poly, 2) active (pitch, velocity) pairs a frame,
        zero-padded: the note-pair input of a MIDI artifact's
        ``diffuse_midi``.  Slots fill in note-list order; notes beyond
        n_poly at once are dropped.  ``times`` ascend."""
        t = np.asarray(times)
        out = np.zeros((len(t), n_poly, 2), np.float32)
        counts = np.zeros(len(t), np.int64)
        for n in self.notes:
            i0 = int(np.searchsorted(t, n.start, side="left"))
            i1 = int(np.searchsorted(t, n.end, side="left"))
            for i in range(i0, i1):
                if counts[i] < n_poly:
                    out[i, counts[i]] = (n.pitch, n.velocity)
                    counts[i] += 1
        return out

    # -- writing -------------------------------------------------------------

    def save(self, path: str, tempo_bpm: float = 120.0,
             division: int = 480) -> None:
        """A format-0 SMF of the notes at one tempo."""
        events = []
        for n in self.notes:
            tick_s = int(round(n.start * division * tempo_bpm / 60.0))
            tick_e = int(round(n.end * division * tempo_bpm / 60.0))
            events.append((tick_s, 0x90, n.pitch, n.velocity))
            events.append((tick_e, 0x80, n.pitch, 0))
        events.sort()
        out = bytearray()
        # tempo meta
        tempo = int(60_000_000 / tempo_bpm)
        out += b"\x00\xff\x51\x03" + tempo.to_bytes(3, "big")
        last = 0
        for tick, status, p1, p2 in events:
            delta = tick - last
            last = tick
            var = bytearray()
            var.insert(0, delta & 0x7F)
            delta >>= 7
            while delta:
                var.insert(0, 0x80 | (delta & 0x7F))
                delta >>= 7
            out += bytes(var) + bytes([status, p1, p2])
        out += b"\x00\xff\x2f\x00"
        with open(path, "wb") as f:
            f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, division))
            f.write(b"MTrk" + struct.pack(">I", len(out)) + bytes(out))


# the globals a stored MIDI pickle may name: the JAX package's classes and
# this module's, each read as this module's
_ALLOWED = {(module, name): cls
            for module in ("after_tpu.dataset.midi", __name__)
            for name, cls in (("MidiFile", MidiFile), ("Note", Note))}


def _numeric_dtype(spec, align=False, copy=False) -> np.dtype:
    dtype = np.dtype(spec, align, copy)
    if dtype.kind not in "iuf":
        raise pickle.UnpicklingError(
            f"a stored MIDI record may hold numpy integers and floats, not "
            f"{dtype}")
    return dtype


def _numeric_scalar(dtype, data=None):
    """numpy's scalar reconstructor, for an integer or float only: the
    Python number of ``data``'s bytes."""
    if not (isinstance(dtype, np.dtype) and dtype.kind in "iuf"
            and dtype.names is None and dtype.subdtype is None
            and not dtype.hasobject and isinstance(data, bytes)
            and len(data) == dtype.itemsize):
        raise pickle.UnpicklingError(
            "a stored MIDI record may hold numpy integers and floats only")
    return np.frombuffer(data, dtype)[0].item()


# numpy's scalars of a JAX package's transcription: its dtype and its
# reconstructor, under numpy 2's module names and numpy 1's
_ALLOWED.update({("numpy", "dtype"): _numeric_dtype,
                 ("numpy._core.multiarray", "scalar"): _numeric_scalar,
                 ("numpy.core.multiarray", "scalar"): _numeric_scalar})


class _MidiUnpickler(pickle.Unpickler):

    def find_class(self, module: str, name: str):
        cls = _ALLOWED.get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"a stored MIDI record may name only MidiFile, Note and "
                f"numpy's numbers, not {module}.{name}")
        return cls


def loads(data: bytes) -> MidiFile:
    """The ``MidiFile`` of a record's ``midi_bytes`` (``pickle.dumps`` of a
    ``MidiFile`` of either package), built from this module's classes."""
    midi = _MidiUnpickler(io.BytesIO(data)).load()
    if not isinstance(midi, MidiFile):
        raise pickle.UnpicklingError(
            f"midi_bytes hold a {type(midi).__name__}, not a MidiFile")
    return midi


# ---------------------------------------------------------------------------
# writing: the JAX package's pickle stream
# ---------------------------------------------------------------------------

JAX_MODULE = "after_tpu.dataset.midi"


class _JaxPickler(pickle._Pickler):
    """Python's own pickler, naming this module's ``MidiFile`` and ``Note``
    as the JAX package's and numpy numbers as Python numbers, batching as
    ``pickle.dumps`` (the C pickler) does."""

    def save(self, obj, save_persistent_id=True):
        if isinstance(obj, np.generic):
            obj = obj.item()
        super().save(obj, save_persistent_id)

    def _batch_appends(self, items, *rest):
        # as the C pickler batches a list: a list of one item with APPEND,
        # any other in batches of MARK ... APPENDS, a last one of one too
        items = list(items)
        if len(items) == 1:
            self.save(items[0])
            self.write(pickle.APPEND)
            return
        for i in range(0, len(items), self._BATCHSIZE):
            self.write(pickle.MARK)
            for x in items[i:i + self._BATCHSIZE]:
                self.save(x)
            self.write(pickle.APPENDS)

    def save_global(self, obj, name=None):
        if obj not in (MidiFile, Note):
            return super().save_global(obj, name)
        self.save(JAX_MODULE)
        self.save(obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dumps(midi: MidiFile) -> bytes:
    """A record's ``midi_bytes`` for ``midi``: the bytes the JAX package
    stores (``pickle.dumps`` of its own ``MidiFile`` of these notes), so
    that the JAX collate reads a store the port prepared with a plain
    ``pickle.loads``, without torch or the port.  Nothing of the JAX package
    is imported.  ``loads`` reads it back."""
    out = io.BytesIO()
    _JaxPickler(out, pickle.DEFAULT_PROTOCOL).dump(midi)
    return out.getvalue()
