"""ctypes bindings for the native data-loading core (libmmt_data.so).

The C++ library (``native/mmt_data.cc``) provides buffered TFRecord
reading with CRC32C and zero-copy tf.train.Example field extraction --
the framework's native equivalent of the TensorFlow C++ input kernels
the reference relied on.  Falls back to the pure-Python codec
transparently when the library isn't built or does not load (it links
libjpeg; a machine without that library takes the pure-Python path).

The port's own copy of ``mmt_tpu/data/native.py``; the library itself is
shared with the JAX package and not changed.

Build once with ``native/build.sh`` (or let this module attempt it, once
per process: a build or a load that failed is remembered, so the callers'
per-record and per-string checks stay cheap on the pure-Python path).  No
build is attempted where ``ctypes.util.find_library("jpeg")`` finds no
libjpeg: the library links it, so that build cannot succeed (it took ~3 s
a process to fail).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import subprocess
from typing import Dict, Iterator, List, Optional, Union

import numpy as np

FeatureValue = Union[List[bytes], np.ndarray]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO_PATH = os.path.join(_ROOT, "native", "libmmt_data.so")

_lib = None
_unavailable = False  # a build or load was tried in this process and failed


def _load(build_if_missing: bool = True):
    global _lib, _unavailable
    if _lib is not None:
        return _lib
    if _unavailable:
        return None
    if not os.path.exists(_SO_PATH) and build_if_missing:
        if ctypes.util.find_library("jpeg") is None:  # the build would fail
            _unavailable = True
            return None
        script = os.path.join(_ROOT, "native", "build.sh")
        try:
            subprocess.run(["sh", script], check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError):
            _unavailable = True
            return None
    if not os.path.exists(_SO_PATH):
        _unavailable = build_if_missing
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:  # built elsewhere, a dependency is missing here
        _unavailable = True
        return None
    lib.mmt_tfrecord_open.restype = ctypes.c_void_p
    lib.mmt_tfrecord_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mmt_tfrecord_next.restype = ctypes.c_int64
    lib.mmt_tfrecord_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    ]
    lib.mmt_tfrecord_error.restype = ctypes.c_char_p
    lib.mmt_tfrecord_error.argtypes = [ctypes.c_void_p]
    lib.mmt_tfrecord_close.argtypes = [ctypes.c_void_p]
    for name, out_t in [
        ("mmt_example_bytes_feature", None),
        ("mmt_example_int64_feature", ctypes.POINTER(ctypes.c_int64)),
        ("mmt_example_float_feature", ctypes.POINTER(ctypes.c_float)),
    ]:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        if name == "mmt_example_bytes_feature":
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ]
        else:
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_char_p,
                out_t, ctypes.c_int64,
            ]
    if hasattr(lib, "mmt_jpeg_decode"):  # older .so builds lack it
        lib.mmt_jpeg_probe.restype = ctypes.c_int64
        lib.mmt_jpeg_probe.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mmt_jpeg_decode.restype = ctypes.c_int64
        lib.mmt_jpeg_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def jpeg_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mmt_jpeg_decode")


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [H, W, 3] RGB via libjpeg-turbo.

    Returns None when the payload isn't a JPEG this decoder handles
    (PNG, CMYK/YCCK, truncated stream): the caller falls back to PIL.
    Native equivalent of the reference's in-graph tf.io.decode_image
    (src/data/data_utils.py:185-206); byte-parity with PIL is pinned by
    tests/test_native_image.py.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "mmt_jpeg_decode"):
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    w = ctypes.c_int32(0)
    h = ctypes.c_int32(0)
    if lib.mmt_jpeg_probe(buf, len(data), ctypes.byref(w), ctypes.byref(h)) < 0:
        return None
    out = np.empty((int(h.value), int(w.value), 3), np.uint8)
    n = lib.mmt_jpeg_decode(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size, ctypes.byref(w), ctypes.byref(h),
    )
    if n != out.size:
        return None
    return out


def iter_records(path: str, check_crc: bool = False) -> Iterator[bytes]:
    """Native TFRecord iteration (copies each payload into Python bytes)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    handle = lib.mmt_tfrecord_open(path.encode(), int(check_crc))
    if not handle:
        raise IOError(f"cannot open {path}")
    try:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = lib.mmt_tfrecord_next(handle, ctypes.byref(ptr))
            if n == 0:
                return
            if n < 0:
                raise IOError(
                    f"{path}: {lib.mmt_tfrecord_error(handle).decode()}"
                )
            yield ctypes.string_at(ptr, n)
    finally:
        lib.mmt_tfrecord_close(handle)


class NativeExample:
    """Zero-copy-ish field access over one serialized Example."""

    _MAX_ITEMS = 4096

    def __init__(self, payload: bytes):
        self._payload = payload
        self._buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")

    def bytes_feature(self, key: str) -> Optional[List[bytes]]:
        ptrs = (ctypes.POINTER(ctypes.c_uint8) * self._MAX_ITEMS)()
        lens = (ctypes.c_int64 * self._MAX_ITEMS)()
        n = self._lib.mmt_example_bytes_feature(
            self._buf, len(self._payload), key.encode(), ptrs, lens, self._MAX_ITEMS
        )
        if n < 0:
            return None
        return [ctypes.string_at(ptrs[i], lens[i]) for i in range(min(n, self._MAX_ITEMS))]

    def int64_feature(self, key: str) -> Optional[np.ndarray]:
        out = np.empty((self._MAX_ITEMS,), np.int64)
        n = self._lib.mmt_example_int64_feature(
            self._buf, len(self._payload), key.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), self._MAX_ITEMS,
        )
        if n < 0:
            return None
        return out[:n].copy()

    def float_feature(self, key: str) -> Optional[np.ndarray]:
        out = np.empty((self._MAX_ITEMS,), np.float32)
        n = self._lib.mmt_example_float_feature(
            self._buf, len(self._payload), key.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self._MAX_ITEMS,
        )
        if n < 0:
            return None
        return out[:n].copy()
