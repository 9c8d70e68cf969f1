"""TFRecord container + tf.train.Example wire-format codec, dependency-free.

The port's own copy of ``mmt_tpu/data/tfrecord.py`` (the port imports
nothing of the JAX package); records written by either parse in the other.

Re-provides the capability of the reference's ``tf.data.TFRecordDataset``
+ ``tf.io.parse_single_example`` input path (``src/data/
pretrain_dataloader.py:129-150``) without the TensorFlow runtime: the
TFRecord framing (length + masked crc32c) and the tiny subset of
protobuf needed for ``tf.train.Example`` are hand-implemented.

Wire format facts (stable, public):
* TFRecord frame: uint64 length | uint32 masked_crc(length) |
  payload | uint32 masked_crc(payload); masked = rotr(crc,15)+0xa282ead8.
* Example = { features(1): Features }, Features = { feature(1):
  map<string, Feature> }, map entry = { key(1), value(2) },
  Feature = oneof { bytes_list(1), float_list(2), int64_list(3) },
  each list = repeated field 1 (packed or unpacked).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
_POLY = 0x82F63B78
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- container


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader:
    """Iterates raw record payloads from one file."""

    def __init__(self, path: str, check_crc: bool = False):
        self.path = path
        self.check_crc = check_crc

    def __iter__(self) -> Iterator[bytes]:
        with open(self.path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    return
                (length,) = struct.unpack("<Q", header)
                hcrc = f.read(4)
                payload = f.read(length)
                pcrc = f.read(4)
                if len(payload) < length or len(pcrc) < 4:
                    raise IOError(f"truncated TFRecord in {self.path}")
                if self.check_crc:
                    if struct.unpack("<I", hcrc)[0] != _masked_crc(header):
                        raise IOError("header crc mismatch")
                    if struct.unpack("<I", pcrc)[0] != _masked_crc(payload):
                        raise IOError("payload crc mismatch")
                yield payload


def skim_open(path: str, skip: int):
    """Opens ``path`` seeked past up to ``skip`` records without reading
    payloads (length-header hops only -- the cheap fast-forward used by
    resumable input streams, ``loaders.RecordCursor.seek``).

    Returns ``(n, f)``: ``n`` records were skipped; ``f`` is the
    positioned file object, or None when the file ended before ``skip``
    records (then ``n`` is the file's record count).
    """
    f = open(path, "rb")
    n = 0
    while n < skip:
        header = f.read(8)
        if len(header) < 8:
            f.close()
            return n, None
        (length,) = struct.unpack("<Q", header)
        f.seek(length + 8, 1)  # header crc (4) + payload + payload crc (4)
        n += 1
    return n, f


def iter_open_records(f) -> Iterator[bytes]:
    """Yields payloads from an already-positioned TFRecord file object
    (the continuation reader after ``skim_open``); closes it at the end."""
    with f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.seek(4, 1)
            payload = f.read(length)
            pcrc = f.read(4)
            if len(payload) < length or len(pcrc) < 4:
                raise IOError("truncated TFRecord")
            yield payload


# ------------------------------------------------------ protobuf en/decode


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _encode_feature(value: FeatureValue) -> bytes:
    inner = bytearray()
    if not value:
        list_field = 1  # empty bytes_list
        body = b""
    elif isinstance(value[0], (bytes, str)):
        list_field = 1
        body_arr = bytearray()
        for v in value:
            if isinstance(v, str):
                v = v.encode()
            _write_varint(body_arr, _tag(1, 2))
            _write_varint(body_arr, len(v))
            body_arr += v
        body = bytes(body_arr)
    elif isinstance(value[0], float):
        list_field = 2
        body_arr = bytearray()
        packed = struct.pack(f"<{len(value)}f", *value)
        _write_varint(body_arr, _tag(1, 2))
        _write_varint(body_arr, len(packed))
        body_arr += packed
        body = bytes(body_arr)
    else:
        list_field = 3
        body_arr = bytearray()
        packed = bytearray()
        for v in value:
            _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF if v >= 0 else (1 << 64) + v)
        _write_varint(body_arr, _tag(1, 2))
        _write_varint(body_arr, len(packed))
        body_arr += packed
        body = bytes(body_arr)
    _write_varint(inner, _tag(list_field, 2))
    _write_varint(inner, len(body))
    inner += body
    return bytes(inner)


def build_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serializes a dict to a tf.train.Example payload."""
    feats = bytearray()
    for key, value in features.items():
        kb = key.encode()
        fb = _encode_feature(value)
        entry = bytearray()
        _write_varint(entry, _tag(1, 2))
        _write_varint(entry, len(kb))
        entry += kb
        _write_varint(entry, _tag(2, 2))
        _write_varint(entry, len(fb))
        entry += fb
        _write_varint(feats, _tag(1, 2))
        _write_varint(feats, len(entry))
        feats += entry
    out = bytearray()
    _write_varint(out, _tag(1, 2))
    _write_varint(out, len(feats))
    out += feats
    return bytes(out)


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        size, pos = _read_varint(buf, pos)
        pos += size
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _parse_feature(buf: bytes) -> FeatureValue:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != 2:
            pos = _skip_field(buf, pos, wire)
            continue
        size, pos = _read_varint(buf, pos)
        body = buf[pos : pos + size]
        pos += size
        if field == 1:  # bytes_list
            out_b: List[bytes] = []
            p = 0
            while p < len(body):
                t, p = _read_varint(body, p)
                if t >> 3 == 1 and t & 7 == 2:
                    ln, p = _read_varint(body, p)
                    out_b.append(body[p : p + ln])
                    p += ln
                else:
                    p = _skip_field(body, p, t & 7)
            return out_b
        if field == 2:  # float_list
            out_f: List[float] = []
            p = 0
            while p < len(body):
                t, p = _read_varint(body, p)
                if t >> 3 == 1 and t & 7 == 2:  # packed
                    ln, p = _read_varint(body, p)
                    out_f.extend(struct.unpack(f"<{ln // 4}f", body[p : p + ln]))
                    p += ln
                elif t >> 3 == 1 and t & 7 == 5:  # unpacked
                    out_f.append(struct.unpack("<f", body[p : p + 4])[0])
                    p += 4
                else:
                    p = _skip_field(body, p, t & 7)
            return out_f
        if field == 3:  # int64_list
            out_i: List[int] = []
            p = 0
            while p < len(body):
                t, p = _read_varint(body, p)
                if t >> 3 == 1 and t & 7 == 2:  # packed
                    ln, p = _read_varint(body, p)
                    end = p + ln
                    while p < end:
                        v, p = _read_varint(body, p)
                        out_i.append(v - (1 << 64) if v >= (1 << 63) else v)
                elif t >> 3 == 1 and t & 7 == 0:  # unpacked
                    v, p = _read_varint(body, p)
                    out_i.append(v - (1 << 64) if v >= (1 << 63) else v)
                else:
                    p = _skip_field(body, p, t & 7)
            return out_i
    return []


def parse_example(payload: bytes) -> Dict[str, FeatureValue]:
    """Parses a tf.train.Example payload into a feature dict."""
    out: Dict[str, FeatureValue] = {}
    pos = 0
    while pos < len(payload):
        tag, pos = _read_varint(payload, pos)
        if tag >> 3 != 1 or tag & 7 != 2:
            pos = _skip_field(payload, pos, tag & 7)
            continue
        size, pos = _read_varint(payload, pos)
        features_buf = payload[pos : pos + size]
        pos += size
        fpos = 0
        while fpos < len(features_buf):
            ftag, fpos = _read_varint(features_buf, fpos)
            if ftag >> 3 != 1 or ftag & 7 != 2:
                fpos = _skip_field(features_buf, fpos, ftag & 7)
                continue
            esize, fpos = _read_varint(features_buf, fpos)
            entry = features_buf[fpos : fpos + esize]
            fpos += esize
            key = b""
            feature_buf = b""
            p = 0
            while p < len(entry):
                etag, p = _read_varint(entry, p)
                if etag >> 3 == 1 and etag & 7 == 2:
                    ln, p = _read_varint(entry, p)
                    key = entry[p : p + ln]
                    p += ln
                elif etag >> 3 == 2 and etag & 7 == 2:
                    ln, p = _read_varint(entry, p)
                    feature_buf = entry[p : p + ln]
                    p += ln
                else:
                    p = _skip_field(entry, p, etag & 7)
            out[key.decode()] = _parse_feature(feature_buf)
    return out
