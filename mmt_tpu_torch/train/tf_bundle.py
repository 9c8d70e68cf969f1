"""TF object checkpoints read without TensorFlow.

What ``tf.train.load_checkpoint`` and ``tf.train.latest_checkpoint`` do for
the JAX package (``mmt_tpu/train/tf_checkpoint.py``, ``mmt_tpu/cli/
train.py``), in numpy and the standard library, so that a machine without
tensorflow can warm-start from such a checkpoint.

A checkpoint ``<prefix>`` (``tf.train.Checkpoint.write``) is two kinds of
file (tensorflow/core/util/tensor_bundle/tensor_bundle.proto):

* ``<prefix>.index``, a LevelDB-format table (tensorflow/core/lib/io/
  table_format.md): data blocks of prefix-compressed entries (shared,
  non-shared and value-length varints, then the key's new bytes and the
  value), each block ending in its restart offsets and their count and
  followed by a 5-byte trailer (a type byte, 0 for uncompressed, and the
  masked crc32c of the block and that byte); an index block with one
  ``BlockHandle`` (offset and size varints) per data block; a 48-byte
  footer holding the metaindex and index handles and the magic
  ``0xdb4775248b80fb57``.  The entry under the empty key is the
  ``BundleHeaderProto`` (``num_shards`` 1, ``endianness`` 2, ``version``
  3); every other key names a tensor and holds its ``BundleEntryProto``
  (``dtype`` 1, ``shape`` 2, ``shard_id`` 3, ``offset`` 4, ``size`` 5,
  ``crc32c`` 6 as fixed32, ``slices`` 7).
* ``<prefix>.data-<shard:05d>-of-<num_shards:05d>``: the tensors' raw
  little-endian bytes at their entries' offsets.

Every tensor read is checked against its entry's masked crc32c, as TF's
``BundleReader`` does (``data/tfrecord.crc32c``, which runs many chunks
of a buffer as numpy lanes and combines their CRCs).
bfloat16 tensors are widened to float32 exactly (numpy has no bfloat16;
the converters cast to the model's float32 in any case).  Refused:
compressed blocks, big-endian bundles, sliced (partitioned) variables, and
remote paths such as ``gs://``.  String tensors (the object graph) are
listed but never decoded.
"""

from __future__ import annotations

import ast
import os
import re
import struct
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from mmt_tpu_torch.data.tfrecord import _read_varint, masked_crc32c

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_BYTES = 48
_BLOCK_TRAILER_BYTES = 5

# tensorflow/core/framework/types.proto -> numpy (little-endian).
DT_STRING, DT_BFLOAT16 = 7, 14
_DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"), 4: np.dtype("u1"),
           5: np.dtype("<i2"), 6: np.dtype("i1"), 9: np.dtype("<i8"), 10: np.dtype("?"),
           19: np.dtype("<f2"), DT_BFLOAT16: np.dtype("<u2")}
_DTYPE_NAMES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16", 6: "int8",
                7: "string", 9: "int64", 10: "bool", 14: "bfloat16", 19: "float16"}


# ----------------------------------------------------------------- paths

def check_local(path: str) -> str:
    """``path``, or ValueError for a remote one (``gs://`` and the like)."""
    if re.match(r"^[A-Za-z][A-Za-z0-9+.-]*://", path):
        raise ValueError(f"{path!r}: the port reads local checkpoint paths only (it has no "
                         f"tensorflow file systems and no network); copy the checkpoint to a "
                         f"local directory first")
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The prefix that ``<directory>/checkpoint`` names as
    ``model_checkpoint_path`` (relative paths resolved against
    ``directory``), as ``tf.train.latest_checkpoint``; None without that
    file.  A named prefix without its ``.index`` raises FileNotFoundError."""
    state = os.path.join(check_local(directory), "checkpoint")
    if not os.path.exists(state):
        return None
    with open(state, encoding="utf-8") as f:
        m = re.search(r'^\s*model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', f.read(), re.MULTILINE)
    if m is None:
        raise ValueError(f"{state} names no model_checkpoint_path")
    # Text-format strings are C-escaped bytes.
    name = ast.literal_eval(f'"{m.group(1)}"').encode("latin-1").decode("utf-8")
    path = name if os.path.isabs(name) else os.path.join(directory, name)
    if not os.path.exists(path + ".index"):
        raise FileNotFoundError(f"{state} names the TF checkpoint {path!r}, which has no "
                                f"{os.path.basename(path)}.index")
    return path


# ---------------------------------------------------------------- protos

def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a proto message:
    varints as int, fixed32/64 as int, length-delimited as bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = bytes(buf[pos:pos + n]), pos + n
        else:
            raise ValueError(f"unsupported proto wire type {wire}")
        yield field, wire, value


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


class Entry(NamedTuple):
    """A tensor's ``BundleEntryProto``."""
    dtype: int
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    crc32c: int  # masked
    sliced: bool


def _parse_entry(buf: bytes) -> Entry:
    f = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0, "crc32c": 0,
         "sliced": False}
    for field, _, value in _fields(buf):
        if field == 1:
            f["dtype"] = value
        elif field == 2:  # TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}
            dims = []
            for dfield, _, dim in _fields(value):
                if dfield == 2:
                    dims.append(next((_int64(v) for n, _, v in _fields(dim) if n == 1), 0))
            f["shape"] = tuple(dims)
        elif field == 3:
            f["shard_id"] = value
        elif field == 4:
            f["offset"] = _int64(value)
        elif field == 5:
            f["size"] = _int64(value)
        elif field == 6:
            f["crc32c"] = value
        elif field == 7:
            f["sliced"] = True
    return Entry(**f)


# ----------------------------------------------------------------- table

def _block(data: bytes, offset: int, size: int, path: str) -> memoryview:
    end = offset + size
    if end + _BLOCK_TRAILER_BYTES > len(data):
        raise ValueError(f"{path}: block at {offset} runs past the end of the file")
    kind = data[end]
    if kind != 0:
        raise ValueError(f"{path}: block at {offset} has compression type {kind}; only "
                         f"uncompressed tables (type 0) are read")
    want = struct.unpack_from("<I", data, end + 1)[0]
    if masked_crc32c(data[offset:end + 1]) != want:
        raise ValueError(f"{path}: block at {offset} fails its crc32c check")
    return memoryview(data)[offset:end]


def _block_entries(block: memoryview) -> Iterator[Tuple[bytes, bytes]]:
    restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    limit = len(block) - 4 - 4 * restarts
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        length, pos = _read_varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + unshared])
        pos += unshared
        yield key, bytes(block[pos:pos + length])
        pos += length


def read_table(path: str) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) of a LevelDB-format table, in key order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_BYTES or \
            struct.unpack_from("<Q", data, len(data) - 8)[0] != _TABLE_MAGIC:
        raise ValueError(f"{path}: not a TF checkpoint index (no table magic)")
    footer = data[len(data) - _FOOTER_BYTES:]
    pos = 0
    for _ in range(2):  # the metaindex handle, unused
        _, pos = _read_varint(footer, pos)
    index_offset, pos = _read_varint(footer, pos)
    index_size, pos = _read_varint(footer, pos)
    out = []
    for _, handle in _block_entries(_block(data, index_offset, index_size, path)):
        offset, p = _read_varint(handle, 0)
        size, _ = _read_varint(handle, p)
        out.extend(_block_entries(_block(data, offset, size, path)))
    return out


# ---------------------------------------------------------------- reader

class BundleReader:
    """The tensors of the checkpoint ``prefix``, by name."""

    def __init__(self, prefix: str):
        self.prefix = check_local(prefix)
        index = prefix + ".index"
        if not os.path.exists(index):
            raise FileNotFoundError(f"no TF checkpoint at {prefix!r} (no {index})")
        self.num_shards = 1
        self.entries: Dict[str, Entry] = {}
        for key, value in read_table(index):
            if key == b"":
                self._read_header(value)
            else:
                self.entries[key.decode("utf-8")] = _parse_entry(value)

    def _read_header(self, value: bytes) -> None:
        for field, _, v in _fields(value):
            if field == 1:
                self.num_shards = v
            elif field == 2 and v != 0:
                raise ValueError(f"{self.prefix}: a big-endian bundle is not read")

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every key's shape (``get_variable_to_shape_map``)."""
        return {k: e.shape for k, e in self.entries.items()}

    def dtype_name(self, key: str) -> str:
        d = self.entries[key].dtype
        return _DTYPE_NAMES.get(d, f"DataType {d}")

    def data_path(self, shard: int) -> str:
        return f"{self.prefix}.data-{shard:05d}-of-{self.num_shards:05d}"

    def get_tensor(self, key: str) -> np.ndarray:
        """The tensor ``key`` (bfloat16 widened to float32), its bytes
        checked against the entry's crc32c."""
        e = self.entries[key]
        if e.sliced:
            raise ValueError(f"{key!r} is a sliced (partitioned) variable; such entries are "
                             f"not read")
        if e.dtype not in _DTYPES:
            raise ValueError(f"{key!r} has dtype {self.dtype_name(key)}, which is not read")
        dtype = _DTYPES[e.dtype]
        count = int(np.prod(e.shape, dtype=np.int64))
        if e.size != count * dtype.itemsize:
            raise ValueError(f"{key!r}: {e.size} bytes for {count} elements of "
                             f"{self.dtype_name(key)}")
        buf = bytearray(e.size)
        with open(self.data_path(e.shard_id), "rb") as f:
            f.seek(e.offset)
            if f.readinto(buf) != e.size:
                raise ValueError(f"{key!r}: {self.data_path(e.shard_id)} ends before its bytes")
        if masked_crc32c(buf) != e.crc32c:
            raise ValueError(f"{key!r}: its bytes in {self.data_path(e.shard_id)} fail their "
                             f"crc32c check (the checkpoint is corrupt)")
        array = np.frombuffer(buf, dtype).reshape(e.shape)
        if e.dtype == DT_BFLOAT16:  # the high half of a float32, exactly
            return (array.astype(np.uint32) << 16).view(np.float32)
        return array
