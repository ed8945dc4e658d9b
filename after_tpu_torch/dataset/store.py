"""Sharded record store (the port's copy of after_tpu/dataset/store.py:
the same files, byte for byte).

An append-only sharded format for mmap reads from Python or native C++
loaders (native/record_store.cc):

    store_dir/
      MANIFEST.json           {"version": 1, "shards": [...], "count": N}
      data-00000.bin          [u64le length][payload] ...
      index.bin               [u32le keylen][key][u32le shard][u64le offset]
                              [u64le length] ...

Offsets point at the payload (after the length prefix).  Keys iterate in
insertion order.  Writers are single-process append-only; readers mmap the
shards lazily and are fork/thread safe.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

_LEN = struct.Struct("<Q")
_IDX_FIX = struct.Struct("<IQQ")  # shard, offset, length
SHARD_BYTES = 1 << 30   # a shard is closed once it holds more than this


class RecordWriter:

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.shards: List[str] = []
        self.count = 0
        self._index = open(os.path.join(path, "index.bin"), "wb")
        self._shard_file = None
        self._shard_id = -1
        self._offset = 0
        self._new_shard()

    def _new_shard(self):
        if self._shard_file:
            self._shard_file.close()
        self._shard_id += 1
        name = f"data-{self._shard_id:05d}.bin"
        self.shards.append(name)
        self._shard_file = open(os.path.join(self.path, name), "wb")
        self._offset = 0

    def put(self, key: str, value: bytes) -> None:
        if self._offset > SHARD_BYTES:
            self._new_shard()
        self._shard_file.write(_LEN.pack(len(value)))
        self._shard_file.write(value)
        kb = key.encode("utf-8")
        self._index.write(struct.pack("<I", len(kb)))
        self._index.write(kb)
        self._index.write(_IDX_FIX.pack(self._shard_id,
                                        self._offset + _LEN.size, len(value)))
        self._offset += _LEN.size + len(value)
        self.count += 1

    def close(self) -> None:
        self._shard_file.close()
        self._index.close()
        with open(os.path.join(self.path, "MANIFEST.json"), "w") as f:
            json.dump({"version": 1, "shards": self.shards,
                       "count": self.count}, f)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordReader:

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        self.shards = manifest["shards"]
        self._index: Dict[str, Tuple[int, int, int]] = {}
        self._keys: List[str] = []
        with open(os.path.join(path, "index.bin"), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (klen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            key = data[pos:pos + klen].decode("utf-8")
            pos += klen
            entry = _IDX_FIX.unpack_from(data, pos)
            pos += _IDX_FIX.size
            self._index[key] = entry
            self._keys.append(key)
        self._mmaps: List[Optional[mmap.mmap]] = [None] * len(self.shards)

    def _shard(self, i: int) -> mmap.mmap:
        if self._mmaps[i] is None:
            with open(os.path.join(self.path, self.shards[i]), "rb") as f:
                self._mmaps[i] = mmap.mmap(f.fileno(), 0,
                                           access=mmap.ACCESS_READ)
        return self._mmaps[i]

    def keys(self) -> List[str]:
        return list(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def get(self, key: str) -> bytes:
        shard, offset, length = self._index[key]
        return bytes(self._shard(shard)[offset:offset + length])

    def items(self) -> Iterator[Tuple[str, bytes]]:
        for k in self._keys:
            yield k, self.get(k)
