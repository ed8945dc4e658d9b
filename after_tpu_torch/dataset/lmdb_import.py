"""Import datasets prepared by the PyTorch reference (protobuf-over-LMDB):
the port's copy of after_tpu/dataset/lmdb_import.py, pure Python and numpy.

The reference's ``prepare_dataset`` writes AudioExample protobufs into an
LMDB environment.  Neither liblmdb nor protobuf is needed here:

- ``LmdbReader`` - a read-only walker of the LMDB 0.9.x file format (meta
  pages -> main-DB B+tree -> leaf nodes, with overflow pages for large
  values);
- ``parse_reference_example`` - a protobuf wire-format parser for the
  reference's AudioExample schema, whose field numbers differ from this
  package's (reference: shape=1, sampling_rate=2, data=3, precision=4 with
  FLOAT16=0..RAW=6; ours: shape=1, precision=2, data=3);
- ``convert_example`` - a reference record as this package's
  ``AudioExample``, with pickled ``pretty_midi.PrettyMIDI`` blobs rebuilt as
  ``dataset.midi.MidiFile`` without pretty_midi (a stub unpickler keeps the
  note attributes).

LMDB format facts used (LMDB 0.9.x):
- the environment is a single memory-mapped file of ``psize``-byte pages;
  pages 0 and 1 are meta pages (magic 0xBEEFC0DE at byte 16); the live
  meta is the one with the larger txnid;
- MDB_meta (at page offset 16): magic u32, version u32, address u64,
  mapsize u64, dbs[2] of 48 bytes each - dbs[0].md_pad aliases the page
  size, dbs[1] is the main DB (md_entries at +32, md_root at +40) - then
  last_pg u64 and txnid u64;
- page header (16 bytes): pgno u64, pad u16, flags u16, then lower u16 /
  upper u16 (or, for P_OVERFLOW pages, the page count as u32);
- the node-pointer array of u16 page-relative offsets starts at byte 16;
  node count = (lower - 16) / 2;
- node header: lo u16, hi u16, flags u16, ksize u16, then the key bytes,
  then the value. Branch child pgno = lo | hi<<16 | flags<<32; leaf value
  size = lo | hi<<16; leaf flag F_BIGDATA (0x01) means the node stores a
  u64 pgno of a contiguous overflow chain whose payload starts 16 bytes
  into the first overflow page.
"""

from __future__ import annotations

import io
import json
import mmap
import os
import pickle
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .audio_example import AudioExample
from .midi import MidiFile, Note
from .midi import dumps as midi_dumps

P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
P_LEAF2, P_SUBP = 0x20, 0x40
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
MDB_MAGIC = 0xBEEFC0DE
_INVALID_PGNO = (1 << 64) - 1


class LmdbReader:
    """Read-only iterator over the main DB of an LMDB environment file."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._file = open(path, "rb")
        self._m = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = self._read_meta(0)
        meta1 = self._read_meta(meta0["psize"])
        meta = meta0 if meta0["txnid"] >= meta1["txnid"] else meta1
        self.psize: int = meta["psize"]
        self.root: int = meta["root"]
        self.entries: int = meta["entries"]

    def close(self):
        self._m.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _read_meta(self, off: int) -> Dict[str, int]:
        flags = struct.unpack_from("<H", self._m, off + 10)[0]
        if not flags & P_META:
            raise ValueError(f"page at {off} is not an LMDB meta page")
        magic, version = struct.unpack_from("<II", self._m, off + 16)
        if magic != MDB_MAGIC:
            raise ValueError(f"bad LMDB magic {magic:#x} at offset {off}")
        if version != 1:
            raise ValueError(f"unsupported LMDB data version {version}")
        # meta struct at off+16; dbs[] at +24 within it (magic+version+
        # address+mapsize = 24 bytes)
        dbs = off + 16 + 24
        psize = struct.unpack_from("<I", self._m, dbs)[0]
        entries, root = struct.unpack_from("<QQ", self._m, dbs + 48 + 32)
        txnid = struct.unpack_from("<Q", self._m, dbs + 96 + 8)[0]
        return dict(psize=psize, root=root, entries=entries, txnid=txnid)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs in key order."""
        if self.root != _INVALID_PGNO:
            yield from self._walk(self.root, depth=0)

    def _walk(self, pgno: int, depth: int) -> Iterator[Tuple[bytes, bytes]]:
        if depth > 64:
            raise ValueError("LMDB tree depth > 64 (corrupt file?)")
        m, off = self._m, pgno * self.psize
        flags, lower = struct.unpack_from("<HH", m, off + 10)
        n = (lower - 16) >> 1
        if flags & (P_LEAF2 | P_SUBP):
            raise ValueError("dupsort/dupfixed databases are not supported")
        for i in range(n):
            noff = off + struct.unpack_from("<H", m, off + 16 + 2 * i)[0]
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", m, noff)
            if flags & P_BRANCH:
                yield from self._walk(lo | hi << 16 | nflags << 32, depth + 1)
                continue
            if not flags & P_LEAF:
                raise ValueError(f"page {pgno}: unexpected flags {flags:#x}")
            if nflags & (F_SUBDATA | F_DUPDATA):
                raise ValueError("dupsort values are not supported")
            key = bytes(m[noff + 8:noff + 8 + ksize])
            dsize = lo | hi << 16
            if nflags & F_BIGDATA:
                opg = struct.unpack_from("<Q", m, noff + 8 + ksize)[0]
                ooff = opg * self.psize
                oflags = struct.unpack_from("<H", m, ooff + 10)[0]
                if not oflags & P_OVERFLOW:
                    raise ValueError(f"page {opg} is not an overflow page")
                if ooff + 16 + dsize > len(m):
                    raise ValueError(
                        f"overflow chain at page {opg} extends past EOF "
                        f"(truncated data.mdb?)")
                yield key, bytes(m[ooff + 16:ooff + 16 + dsize])
            else:
                doff = noff + 8 + ksize
                if doff + dsize > len(m):
                    raise ValueError(
                        f"leaf value on page {pgno} extends past EOF "
                        f"(truncated data.mdb?)")
                yield key, bytes(m[doff:doff + dsize])


# ---------------------------------------------------------------------------
# Reference AudioExample wire format
# ---------------------------------------------------------------------------

# reference Precision enum (audio_example_pb2: FLOAT16=0 ... RAW=6)
_REF_PRECISION_DTYPE = {0: np.float16, 1: np.float32, 2: np.float64,
                        3: np.int16, 4: np.int32, 5: np.int64, 6: None}


class RefBuffer:
    __slots__ = ("shape", "sampling_rate", "data", "precision")

    def __init__(self):
        self.shape: List[int] = []
        self.sampling_rate = 0
        self.data = b""
        self.precision = 0


def _iter_fields(b: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """(field_number, wire_type, payload) triples of one message."""
    i, n = 0, len(b)
    while i < n:
        tag, i = _varint(b, i)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            v, i = _varint(b, i)
            yield fnum, 0, v
        elif wtype == 2:
            ln, i = _varint(b, i)
            if i + ln > n:
                raise ValueError("truncated length-delimited field")
            yield fnum, 2, b[i:i + ln]
            i += ln
        elif wtype == 5:
            if i + 4 > n:
                raise ValueError("truncated fixed32 field")
            yield fnum, 5, b[i:i + 4]
            i += 4
        elif wtype == 1:
            if i + 8 > n:
                raise ValueError("truncated fixed64 field")
            yield fnum, 1, b[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")


def _varint(b: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if i >= len(b) or shift > 63:
            raise ValueError("truncated or over-long varint")
        c = b[i]
        out |= (c & 0x7F) << shift
        i += 1
        if not c & 0x80:
            return out, i
        shift += 7


def _parse_buffer(b: bytes) -> RefBuffer:
    out = RefBuffer()
    for fnum, wtype, v in _iter_fields(b):
        if fnum == 1:          # repeated int32 shape: packed or not
            if wtype == 2:
                i = 0
                while i < len(v):
                    d, i = _varint(v, i)
                    out.shape.append(d)
            else:
                out.shape.append(v)
        elif fnum == 2 and wtype == 0:
            out.sampling_rate = v
        elif fnum == 3 and wtype == 2:
            out.data = v
        elif fnum == 4 and wtype == 0:
            out.precision = v
    return out


def parse_reference_example(
        b: bytes) -> Tuple[Dict[str, RefBuffer], Dict[str, str]]:
    """Reference AudioExample bytes -> ({name: RefBuffer}, metadata map)."""
    buffers: Dict[str, RefBuffer] = {}
    metadata: Dict[str, str] = {}
    for fnum, wtype, v in _iter_fields(b):
        if wtype != 2:
            continue
        key, val = b"", b""
        for efnum, ewtype, ev in _iter_fields(v):
            if efnum == 1 and ewtype == 2:
                key = ev
            elif efnum == 2 and ewtype == 2:
                val = ev
        if fnum == 1:
            buffers[key.decode()] = _parse_buffer(val)
        elif fnum == 2:
            metadata[key.decode()] = val.decode()
    return buffers, metadata


# ---------------------------------------------------------------------------
# pretty_midi pickle rescue (without pretty_midi installed)
# ---------------------------------------------------------------------------

class _Stub:
    """Attribute sponge standing in for any unavailable pickled class."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)


class _StubUnpickler(pickle.Unpickler):

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


def midi_from_pretty_midi_pickle(b: bytes) -> MidiFile:
    """Pickled pretty_midi.PrettyMIDI bytes -> dataset.midi.MidiFile.

    pretty_midi pickles as plain attribute state; the notes live at
    obj.instruments[*].notes[*].{pitch, velocity, start, end}.  Drum tracks
    are skipped (the reference's piano-roll path ignores them too:
    pretty_midi.get_piano_roll skips is_drum instruments).
    """
    obj = _StubUnpickler(io.BytesIO(b)).load()
    notes: List[Note] = []
    for inst in getattr(obj, "instruments", []) or []:
        if getattr(inst, "is_drum", False):
            continue
        for n in getattr(inst, "notes", []) or []:
            try:
                notes.append(Note(int(n.pitch), int(n.velocity),
                                  float(n.start), float(n.end)))
            except (AttributeError, TypeError, ValueError):
                continue
    notes.sort(key=lambda n: (n.start, n.pitch))
    return MidiFile(notes=notes)


# ---------------------------------------------------------------------------
# record conversion
# ---------------------------------------------------------------------------

# our proto has no FLOAT64/INT64 precisions; narrow on import
_NARROW = {np.float64: np.float32, np.int64: np.int32}


def convert_example(buffers: Dict[str, RefBuffer],
                    metadata: Dict[str, str]) -> AudioExample:
    """One reference record -> this package's AudioExample.

    - "metadata" is stored by the reference as a JSON *buffer*; it lands in
      our typed metadata map;
    - "midi" is a pickled pretty_midi.PrettyMIDI; it becomes a MidiFile
      under "midi_bytes" (what the collate reads), in the JAX package's
      pickle stream (``dataset.midi.dumps``);
    - everything else ("waveform" int16, "z"/augments/descriptors float32)
      maps dtype-for-dtype.
    """
    ae = AudioExample()
    meta: Dict[str, object] = dict(metadata)
    for name, buf in buffers.items():
        if name == "metadata":
            try:
                decoded = json.loads(buf.data.decode())
            except (ValueError, UnicodeDecodeError):
                decoded = None
            if isinstance(decoded, dict):
                meta.update(decoded)
            continue
        if name == "midi":
            blob = midi_dumps(midi_from_pretty_midi_pickle(buf.data))
            ae.put_buffer("midi_bytes", blob, [len(blob)])
            continue
        dtype = _REF_PRECISION_DTYPE.get(buf.precision, None)
        if dtype is None:      # RAW / unknown: keep the bytes
            ae.put_buffer(name, buf.data, [len(buf.data)])
            continue
        arr = np.frombuffer(buf.data, dtype=dtype)
        if buf.shape:
            arr = arr.reshape(buf.shape)
        if dtype is np.int64 and arr.size and (
                arr.max() > np.iinfo(np.int32).max
                or arr.min() < np.iinfo(np.int32).min):
            # silent int32 wraparound would corrupt the migrated store
            raise ValueError(
                f"buffer {name!r}: int64 values exceed the int32 range "
                "supported by the record store")
        arr = arr.astype(_NARROW.get(dtype, dtype), copy=False)
        ae.put_array(name, arr, sampling_rate=buf.sampling_rate)
    if meta:
        ae.put_metadata(meta)
    return ae


def import_lmdb(input_path: str, output_path: str,
                max_records: Optional[int] = None,
                log=print) -> int:
    """Convert a reference LMDB dataset into a record store of the port.

    Returns the number of records written.
    """
    from .store import RecordWriter
    n = skipped = 0
    with LmdbReader(input_path) as reader, \
            RecordWriter(output_path) as writer:
        for key, value in reader.items():
            # one unparseable record (truncated protobuf, foreign value,
            # bad pickle) must not abort an hours-long migration
            try:
                buffers, metadata = parse_reference_example(value)
                if not buffers:
                    continue    # not an AudioExample (stray bookkeeping key)
                example = convert_example(buffers, metadata).serialize()
            except (ValueError, TypeError, KeyError, UnicodeDecodeError,
                    pickle.UnpicklingError, EOFError) as e:
                skipped += 1
                log(f"[import_dataset] skipping record "
                    f"{key.decode('utf-8', 'replace')!r}: {e}")
                continue
            writer.put(key.decode("utf-8", "replace"), example)
            n += 1
            if n % 500 == 0:
                log(f"[import_dataset] {n} records...")
            if max_records is not None and n >= max_records:
                break
    log(f"[import_dataset] wrote {n} records to {output_path}"
        + (f" ({skipped} unparseable records skipped)" if skipped else ""))
    return n
