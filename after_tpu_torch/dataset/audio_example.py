"""AudioExample: a typed named-tensor record (the port's copy of
after_tpu/dataset/audio_example.py, with the same API and bytes).

Named buffers with a shape and a precision, int16 waveforms rescaled to
float on read, and a metadata dict.  A record is the proto3 message
``after_tpu.AudioExample`` of after_tpu/dataset/audio_example.proto::

    message AudioBuffer {repeated int32 shape = 1; Precision precision = 2;
                         bytes data = 3; int32 sampling_rate = 4;
                         string metadata = 5;}
    message AudioExample {map<string, AudioBuffer> buffers = 1;
                          map<string, string> metadata = 2;}

written and read here by hand, since the port may not need
``google.protobuf``: varint tags, ``shape`` packed, the other fields of a
buffer left out at their default as proto3 leaves them, each map entry a
message of its key (field 1) and value (field 2), both always written, as
protobuf writes them.  Reading accepts ``shape`` packed or not, lets a
later field or map entry replace an earlier one and skips unknown fields,
as protobuf does (a map entry with an unknown field is left out of the
map, as protobuf's upb leaves it).  A buffer's ``data`` is a view of the
record's bytes (``memoryview``), so ``get`` reads it with
``np.frombuffer`` and no copy; no loop runs over the payload in Python.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

# Precision enum values
FLOAT32, INT16, FLOAT16, INT32, UINT8 = range(5)

_DTYPE_TO_PRECISION = {
    np.dtype(np.float32): FLOAT32,
    np.dtype(np.int16): INT16,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.int32): INT32,
    np.dtype(np.uint8): UINT8,
}
_PRECISION_TO_DTYPE = {v: k for k, v in _DTYPE_TO_PRECISION.items()}

_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = range(6)

Bytes = Union[bytes, bytearray, memoryview]


# -- wire format ------------------------------------------------------------

def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1      # a negative int32: ten bytes, two's complement
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _len_field(number: int, payload: Bytes) -> bytes:
    return _field(number, _LEN) + _varint(len(payload)) + bytes(payload)


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than ten bytes")


def _int32(value: int) -> int:
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value & 0x80000000 else value


def _fields(buf: memoryview):
    """(field number, wire type, value) of each field of a message: an int
    for varints and fixed widths, a memoryview for length-delimited fields;
    groups are skipped."""
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if number == 0:
            raise ValueError("field number 0")
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _I64:
            value, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif wire == _I32:
            value, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        elif wire == _LEN:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == _SGROUP:
            pos = _skip_group(buf, pos, number)
            continue
        else:
            raise ValueError(f"unexpected wire type {wire}")
        if pos > end:
            raise ValueError("truncated message")
        yield number, wire, value


def _skip_group(buf: memoryview, pos: int, number: int) -> int:
    while True:
        if pos >= len(buf):
            raise ValueError("unterminated group")
        tag, pos = _read_varint(buf, pos)
        wire = tag & 7
        if wire == _EGROUP:
            if tag >> 3 != number:
                raise ValueError("mismatched end group")
            return pos
        if wire == _VARINT:
            _, pos = _read_varint(buf, pos)
        elif wire == _I64:
            pos += 8
        elif wire == _I32:
            pos += 4
        elif wire == _LEN:
            n, pos = _read_varint(buf, pos)
            pos += n
        elif wire == _SGROUP:
            pos = _skip_group(buf, pos, tag >> 3)
        else:
            raise ValueError(f"unexpected wire type {wire}")


def _text(value: memoryview) -> str:
    return bytes(value).decode("utf-8")


class _Buffer:
    """One ``AudioBuffer``."""

    __slots__ = ("shape", "precision", "data", "sampling_rate", "metadata")

    def __init__(self):
        self.shape: List[int] = []
        self.precision = FLOAT32
        self.data: Bytes = b""
        self.sampling_rate = 0
        self.metadata = ""

    def serialize(self) -> bytes:
        out = bytearray()
        if self.shape:
            packed = b"".join(_varint(d) for d in self.shape)
            out += _len_field(1, packed)
        if self.precision:
            out += _field(2, _VARINT) + _varint(self.precision)
        if len(self.data):
            out += _len_field(3, self.data)
        if self.sampling_rate:
            out += _field(4, _VARINT) + _varint(self.sampling_rate)
        if self.metadata:
            out += _len_field(5, self.metadata.encode("utf-8"))
        return bytes(out)

    @classmethod
    def parse(cls, buf: memoryview) -> "_Buffer":
        b = cls()
        for number, wire, value in _fields(buf):
            if number == 1 and wire == _LEN:
                pos = 0
                while pos < len(value):
                    d, pos = _read_varint(value, pos)
                    b.shape.append(_int32(d))
            elif number == 1 and wire == _VARINT:
                b.shape.append(_int32(value))
            elif number == 2 and wire == _VARINT:
                b.precision = _int32(value)
            elif number == 3 and wire == _LEN:
                b.data = value
            elif number == 4 and wire == _VARINT:
                b.sampling_rate = _int32(value)
            elif number == 5 and wire == _LEN:
                b.metadata = _text(value)
        return b


def _map_entry(buf: memoryview
               ) -> Optional[Tuple[str, Optional[memoryview]]]:
    """(key, value) of a map entry; None for an entry holding any other
    field, which protobuf (upb) keeps aside as unknown and leaves out of the
    map."""
    key, value = "", None
    for number, wire, v in _fields(buf):
        if number == 1 and wire == _LEN:
            key = _text(v)
        elif number == 2 and wire == _LEN:
            value = v
        else:
            return None
    return key, value


# -- the record ---------------------------------------------------------------

class AudioExample:

    def __init__(self, b: Optional[Bytes] = None):
        self._buffers: Dict[str, _Buffer] = {}
        self._metadata: Dict[str, str] = {}
        if b is not None:
            self._parse(memoryview(b).cast("B"))

    def _parse(self, buf: memoryview) -> None:
        for number, wire, value in _fields(buf):
            if wire != _LEN or number not in (1, 2):
                continue
            entry = _map_entry(value)
            if entry is None:
                continue
            key, v = entry
            if number == 1:
                self._buffers[key] = (_Buffer.parse(v) if v is not None
                                      else _Buffer())
            else:
                self._metadata[key] = _text(v) if v is not None else ""

    # -- writing -----------------------------------------------------------

    def _buffer(self, key: str) -> _Buffer:
        return self._buffers.setdefault(key, _Buffer())

    def put_array(self, key: str, array: np.ndarray,
                  dtype: Optional[np.dtype] = None,
                  sampling_rate: int = 0) -> None:
        array = np.asarray(array)
        if dtype is not None:
            if np.dtype(dtype) == np.int16 and array.dtype.kind == "f":
                array = (np.clip(array, -1, 1)
                         * (2 ** 15 - 1)).astype(np.int16)
            else:
                array = array.astype(dtype)
        buf = self._buffer(key)
        buf.shape = [int(d) for d in array.shape]
        buf.precision = _DTYPE_TO_PRECISION[array.dtype]
        buf.data = array.tobytes()
        buf.sampling_rate = int(sampling_rate)

    def put_metadata(self, metadata: Dict[str, Any]) -> None:
        for k, v in metadata.items():
            self._metadata[k] = v if isinstance(v, str) else json.dumps(v)

    def put_buffer(self, key: str, data: bytes, shape: List[int]) -> None:
        buf = self._buffer(key)
        buf.shape = [int(d) for d in shape]
        buf.precision = UINT8
        buf.data = bytes(data)

    # -- reading -----------------------------------------------------------

    def get(self, key: str) -> np.ndarray:
        if key == "metadata":
            return self.get_metadata()
        if key not in self._buffers:
            raise KeyError(f"{key} not in example (has {self.get_keys()})")
        buf = self._buffers[key]
        array = np.frombuffer(buf.data,
                              dtype=_PRECISION_TO_DTYPE[buf.precision])
        array = array.reshape(tuple(buf.shape))
        if buf.precision == INT16:
            # int16 waveforms rescale to float
            array = array.astype(np.float32) / (2 ** 15 - 1)
        return array

    def get_bytes(self, key: str) -> bytes:
        return bytes(self._buffers[key].data)

    def get_metadata(self) -> Dict[str, str]:
        return dict(self._metadata)

    def get_keys(self) -> List[str]:
        return list(self._buffers.keys())

    def as_dict(self, keys: Optional[List[str]] = None) -> Dict[str, Any]:
        keys = keys if keys is not None else self.get_keys()
        return {k: self.get(k) for k in keys}

    def serialize(self) -> bytes:
        out = bytearray()
        for key, buf in self._buffers.items():
            entry = (_len_field(1, key.encode("utf-8"))
                     + _len_field(2, buf.serialize()))
            out += _len_field(1, entry)
        for key, value in self._metadata.items():
            entry = (_len_field(1, key.encode("utf-8"))
                     + _len_field(2, value.encode("utf-8")))
            out += _len_field(2, entry)
        return bytes(out)

    def __contains__(self, key):
        return key in self._buffers
