"""A reader of TensorFlow's V2 checkpoint format (the "tensor bundle"), in
numpy, without TensorFlow.

A checkpoint `<prefix>` is two files or more:

- `<prefix>.index`, a LevelDB-format table (TensorFlow's `lib/io/table`):
  uncompressed blocks of prefix-compressed entries (shared, unshared and
  value-length varints, then the key's unshared bytes and the value), each
  block ending in its restart offsets and their count, and followed by a
  trailer of its compression byte and the masked crc32c of the block and
  that byte; an index block whose values are the handles (offset and size
  varints) of the data blocks; and a 48-byte footer holding the metaindex
  and index handles and the magic number 0xdb4775248b80fb57. Key "" holds
  the `BundleHeaderProto` (num_shards = 1, endianness = 2); every other key
  is a variable's name, and its value a `BundleEntryProto` (dtype = 1,
  shape = 2, shard_id = 3, offset = 4, size = 5, crc32c = 6, slices = 7).
- `<prefix>.data-<k>-of-<n>`, the tensors' little-endian bytes at each
  entry's offset and size.

`load_checkpoint(path)` takes the prefix, or a directory whose `checkpoint`
file names it (`model_checkpoint_path`), and checks every block's and every
tensor's crc32c as it reads them. It reads float32, float64, int32 and
int64 tensors, and refuses, with the reason, a compressed block, a V1
checkpoint (one file, no `.index`), a big-endian bundle, a sliced
(partitioned) variable and any other dtype.
"""

from __future__ import annotations

import os
import re

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
# TensorFlow's DataType enum -> numpy dtype, for the dtypes the reader takes
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"), 9: np.dtype("<i8")}

# ---------------------------------------------------------------- crc32c

_POLY = 0x82F63B78  # Castagnoli, reflected


def _table() -> np.ndarray:
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(_POLY), c >> 1).astype(np.uint32)
    return c


_TABLE = _table()
_TABLE_LIST = [int(v) for v in _TABLE]
_LANE = 1024  # bytes a lane of the vectorised crc


def _apply(op: list[int], v: int) -> int:
    """A linear map of 32-bit registers (the images of the 32 unit bits) on v."""
    out, k = 0, 0
    while v:
        if v & 1:
            out ^= op[k]
        v >>= 1
        k += 1
    return out


def _zeros_op(n: int) -> list[int]:
    """The register map of feeding n zero bytes (squared up from one byte)."""
    step = [_TABLE_LIST[(1 << k) & 0xFF] ^ ((1 << k) >> 8) for k in range(32)]
    op = [1 << k for k in range(32)]
    while n:
        if n & 1:
            op = [_apply(step, v) for v in op]
        step = [_apply(step, v) for v in step]
        n >>= 1
    return op


def _byte_tables(op: list[int]) -> list[list[int]]:
    return [[_apply(op, b << (8 * j)) for b in range(256)] for j in range(4)]


_LANE_TABLES = _byte_tables(_zeros_op(_LANE))


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`. Long inputs run in lanes of 1,024
    bytes side by side in numpy, each lane from a zero register; the lanes'
    registers are then chained (the register after lane i is lane i's, plus
    the previous register carried over 1,024 zero bytes), and the initial
    all-ones register is carried over the whole length: the CRC is linear
    in the register and the data."""
    n = len(data)
    if n < 16 * _LANE:
        reg = 0xFFFFFFFF
        for b in data:
            reg = _TABLE_LIST[(reg ^ b) & 0xFF] ^ (reg >> 8)
        return reg ^ 0xFFFFFFFF
    pad = (-n) % _LANE  # leading zeros leave a zero register at zero
    lanes = np.frombuffer(b"\0" * pad + bytes(data), np.uint8).reshape(-1, _LANE)
    reg = np.zeros(lanes.shape[0], np.uint32)
    for j in range(_LANE):
        reg = _TABLE[(reg ^ lanes[:, j]) & 0xFF] ^ (reg >> 8)
    t0, t1, t2, t3 = _LANE_TABLES
    acc = 0
    for r in reg.tolist():
        acc = (t0[acc & 0xFF] ^ t1[(acc >> 8) & 0xFF] ^ t2[(acc >> 16) & 0xFF]
               ^ t3[acc >> 24] ^ r)
    return _apply(_zeros_op(n), 0xFFFFFFFF) ^ acc ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """LevelDB's and TensorFlow's stored form of a CRC."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------- encodings

def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _proto_fields(buf: bytes) -> dict[int, list]:
    """A protobuf message -> {field number: [values]}: varints as ints,
    fixed32 / fixed64 as ints, length-delimited fields as bytes."""
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        kind = tag & 7
        if kind == 0:
            value, pos = _varint(buf, pos)
        elif kind == 1:
            value, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif kind == 2:
            size, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        elif kind == 5:
            value, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        else:
            raise ValueError(f"tf_bundle: unknown protobuf wire type {kind}")
        fields.setdefault(tag >> 3, []).append(value)
    return fields


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _block(table: bytes, offset: int, size: int, where: str) -> bytes:
    """A table block's contents, its trailer's compression byte and masked
    crc32c checked."""
    contents = table[offset:offset + size]
    kind = table[offset + size]
    stored = int.from_bytes(table[offset + size + 1:offset + size + 5], "little")
    if len(contents) != size or stored != mask_crc(crc32c(contents + bytes([kind]))):
        raise ValueError(f"tf_bundle: {where}: block at {offset} fails its crc32c")
    if kind != 0:
        raise ValueError(f"tf_bundle: {where}: block at {offset} is compressed (type {kind}); "
                         "TensorFlow writes bundles uncompressed and this reader takes no other")
    return contents


def _entries(block: bytes):
    """(key, value) of each entry of a block, keys rebuilt from their shared
    prefixes."""
    restarts = int.from_bytes(block[-4:], "little")
    end = len(block) - 4 * (restarts + 1)
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        size, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + size]
        pos += size


# ---------------------------------------------------------------- the reader

def checkpoint_prefix(path: str) -> str:
    """A checkpoint path as users pass it -> its prefix: a directory is
    resolved through its `checkpoint` file's model_checkpoint_path."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if not os.path.isfile(state):
            raise FileNotFoundError(f"tf_bundle: {path!r} is a directory without a checkpoint file")
        with open(state) as f:
            m = re.search(r'^model_checkpoint_path:\s*"(.*)"', f.read(), re.M)
        if m is None:
            raise ValueError(f"tf_bundle: {state} names no model_checkpoint_path")
        prefix = m.group(1)
        return prefix if os.path.isabs(prefix) else os.path.join(path, prefix)
    return path


class BundleReader:
    """The variables of one V2 checkpoint: names, shapes, dtypes and values
    (`get_tensor`), as TensorFlow's `CheckpointReader` gives them."""

    def __init__(self, path: str):
        self.prefix = checkpoint_prefix(path)
        index = self.prefix + ".index"
        if not os.path.isfile(index):
            if os.path.isfile(self.prefix):
                raise ValueError(f"tf_bundle: {self.prefix!r} is one file without an .index: a V1 "
                                 "checkpoint, which this reader does not take (re-save it as V2)")
            raise FileNotFoundError(f"tf_bundle: no checkpoint at {self.prefix!r}")
        with open(index, "rb") as f:
            table = f.read()
        footer = table[-FOOTER_BYTES:]
        if len(table) < FOOTER_BYTES or int.from_bytes(footer[-8:], "little") != TABLE_MAGIC:
            raise ValueError(f"tf_bundle: {index} is not a table (bad magic number)")
        pos = _varint(footer, _varint(footer, 0)[1])[1]  # past the metaindex handle
        idx_off, pos = _varint(footer, pos)
        idx_size, _ = _varint(footer, pos)
        self.entries: dict[str, dict] = {}
        header = None
        for _, handle in _entries(_block(table, idx_off, idx_size, index)):
            off, p = _varint(handle, 0)
            size, _ = _varint(handle, p)
            for key, value in _entries(_block(table, off, size, index)):
                if key == b"":
                    header = _proto_fields(value)
                else:
                    self.entries[key.decode()] = _proto_fields(value)
        if header is None:
            raise ValueError(f"tf_bundle: {index} holds no bundle header")
        if header.get(2, [0])[0] != 0:
            raise ValueError(f"tf_bundle: {index} is a big-endian bundle; this reader takes "
                             "little-endian ones")
        self.num_shards = header.get(1, [1])[0]

    def _shape(self, entry: dict) -> list[int]:
        shape = _proto_fields(entry.get(2, [b""])[0])
        return [_int64(_proto_fields(d).get(1, [0])[0]) for d in shape.get(2, [])]

    def get_variable_to_shape_map(self) -> dict[str, list[int]]:
        return {name: self._shape(e) for name, e in self.entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self.entries:
            raise KeyError(f"tf_bundle: {name!r} is not in {self.prefix}")
        e = self.entries[name]
        if e.get(7):
            raise ValueError(f"tf_bundle: {name!r} is a sliced (partitioned) variable, which "
                             "this reader does not take")
        code = e.get(1, [0])[0]
        if code not in DTYPES:
            raise ValueError(f"tf_bundle: {name!r} has TensorFlow dtype {code}; this reader "
                             "takes float32 (1), float64 (2), int32 (3) and int64 (9)")
        shard = e.get(3, [0])[0]
        offset, size = e.get(4, [0])[0], e.get(5, [0])[0]
        path = f"{self.prefix}.data-{shard:05d}-of-{self.num_shards:05d}"
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(size)
        if len(raw) != size or e.get(6, [0])[0] != mask_crc(crc32c(raw)):
            raise ValueError(f"tf_bundle: {name!r} fails its crc32c in {path}")
        native = DTYPES[code].newbyteorder("=")  # a writable copy in the host's byte order
        return np.frombuffer(raw, DTYPES[code]).reshape(self._shape(e)).astype(native)


def load_checkpoint(path: str) -> BundleReader:
    """The reader of the V2 checkpoint at `path` (a prefix, or a directory
    with a `checkpoint` file): `tf.train.load_checkpoint` without TensorFlow."""
    return BundleReader(path)
