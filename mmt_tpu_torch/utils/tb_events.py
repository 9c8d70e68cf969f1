"""TensorBoard scalar event files without TensorFlow.

The port's own copy of ``mmt_tpu/utils/tb_events.py``: the two protos a
scalar summary needs (``Event`` and ``Summary.Value.simple_value``) are
encoded by hand and framed as TFRecords by ``data/tfrecord.py``, so
TensorBoard reads the run's scalars where neither TF nor tensorboard is
installed.  For the same scalars at the same ``time.time()`` the file is
byte for byte the JAX package's.

Wire format (tensorflow/core/util/event.proto,
tensorflow/core/framework/summary.proto):

    Event:   double wall_time = 1;  int64 step = 2;
             string file_version = 3;  Summary summary = 5;
    Summary: repeated Value value = 1;
    Value:   string tag = 1;  float simple_value = 2;

An event file is a TFRecord stream of Event protos whose first record is
``file_version: "brain.Event:2"``; TensorBoard discovers files named
``events.out.tfevents.*`` under the log dir.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping

from mmt_tpu_torch.data.tfrecord import TFRecordWriter, _tag, _write_varint


def _encode_value(tag: str, simple_value: float) -> bytes:
    out = bytearray()
    tag_b = tag.encode("utf-8")
    _write_varint(out, _tag(1, 2))  # Value.tag (length-delimited)
    _write_varint(out, len(tag_b))
    out += tag_b
    _write_varint(out, _tag(2, 5))  # Value.simple_value (32-bit float)
    out += struct.pack("<f", float(simple_value))
    return bytes(out)


def encode_scalar_event(step: int, metrics: Mapping[str, float], wall_time: float) -> bytes:
    """One Event proto carrying all of ``metrics`` as simple_value tags."""
    summary = bytearray()
    for tag, value in metrics.items():
        v = _encode_value(tag, value)
        _write_varint(summary, _tag(1, 2))  # Summary.value (repeated)
        _write_varint(summary, len(v))
        summary += v
    out = bytearray()
    out += bytes([_tag(1, 1)])  # Event.wall_time (64-bit double)
    out += struct.pack("<d", wall_time)
    _write_varint(out, _tag(2, 0))  # Event.step (varint)
    _write_varint(out, int(step) & 0xFFFFFFFFFFFFFFFF)
    _write_varint(out, _tag(5, 2))  # Event.summary
    _write_varint(out, len(summary))
    out += summary
    return bytes(out)


def encode_file_version_event(wall_time: float) -> bytes:
    out = bytearray()
    out += bytes([_tag(1, 1)])
    out += struct.pack("<d", wall_time)
    ver = b"brain.Event:2"
    _write_varint(out, _tag(3, 2))  # Event.file_version
    _write_varint(out, len(ver))
    out += ver
    return bytes(out)


class TBEventWriter:
    """Appends scalar Events to one ``events.out.tfevents.*`` file in
    ``log_dir``; flushes after every write so a live TensorBoard tails
    the run."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s" % (int(time.time()), socket.gethostname())
        self.path = os.path.join(log_dir, name)
        self._w = TFRecordWriter(self.path)
        self._w.write(encode_file_version_event(time.time()))
        self._w.flush()

    def scalars(self, step: int, metrics: Mapping[str, float]) -> None:
        self._w.write(encode_scalar_event(step, metrics, time.time()))
        self._w.flush()

    def close(self) -> None:
        self._w.close()
