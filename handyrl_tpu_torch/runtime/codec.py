"""Pickle-free binary wire codec.

The port's copy of ``handyrl_tpu/runtime/codec.py``, byte for byte the same
format, so episode blocks and frames written by either package decode in
the other.  The wire vocabulary is closed: None/bool/int/float/str/bytes/
list/tuple/dict and numpy arrays (raw buffer + dtype/shape header, no
object dtypes).

Format: one tag byte per value, big-endian fixed-width lengths.  Arrays
are C-contiguous raw buffers.

Two interchangeable implementations share the format: this pure-Python
module (the specification, and the fallback) and a C extension
(``_codec_accel.c``, the port's own copy, built at first use by
``_codec_build.py``) that removes the per-small-object overhead of episode
blocks.  ``dumps``/``loads`` dispatch to the accelerator when it loaded;
``HANDYRL_NO_CODEC_ACCEL=1`` forces pure Python, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
import struct
import sys
from typing import Any

import numpy as np

_U32 = struct.Struct("!I")
_I64 = struct.Struct("!q")
_F64 = struct.Struct("!d")


class CodecError(ValueError):
    pass


# shared with the C accelerator (MAX_DEPTH in _codec_accel.c): both
# implementations must accept and reject the same nesting, or a frame
# encoded on an accelerated host would fail to decode on a fallback host
# (and deep nesting must surface as CodecError, not RecursionError, so
# connection loops handle it)
_MAX_DEPTH = 500


def _pack_u32(n: int) -> bytes:
    """Length header pack that fails the same way the C accelerator does:
    a >= 2**32 str/bytes/array/container length must raise CodecError on
    BOTH implementations (the accelerator's enc_len_u32 does; bare
    _U32.pack would let struct.error escape from the fallback host)."""
    try:
        return _U32.pack(n)
    except struct.error as exc:
        raise CodecError(f"length out of u32 range: {n}") from exc


def _encode(obj: Any, out: list, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        raise CodecError("nesting too deep")
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, int):
        out.append(b"i")
        try:
            out.append(_I64.pack(obj))
        except struct.error as exc:
            raise CodecError(f"int out of i64 range: {obj}") from exc
    elif isinstance(obj, float):
        out.append(b"f")
        out.append(_F64.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(b"s")
        out.append(_pack_u32(len(raw)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(b"b")
        out.append(_pack_u32(len(raw)))
        out.append(raw)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise CodecError("object-dtype arrays are not wire-encodable")
        shape = obj.shape  # before ascontiguousarray, which promotes 0-d to 1-d
        arr = np.ascontiguousarray(obj)
        dt = arr.dtype.str.encode("ascii")
        out.append(b"a")
        out.append(_pack_u32(len(dt)))
        out.append(dt)
        out.append(_pack_u32(len(shape)))
        for d in shape:
            out.append(_pack_u32(d))
        raw = arr.tobytes()
        out.append(_pack_u32(len(raw)))
        out.append(raw)
    elif isinstance(obj, (np.bool_, np.integer, np.floating)):
        _encode(obj.item(), out, depth + 1)
    elif isinstance(obj, list):
        out.append(b"l")
        out.append(_pack_u32(len(obj)))
        for item in obj:
            _encode(item, out, depth + 1)
    elif isinstance(obj, tuple):
        out.append(b"t")
        out.append(_pack_u32(len(obj)))
        for item in obj:
            _encode(item, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(b"d")
        out.append(_pack_u32(len(obj)))
        for key, value in obj.items():
            _encode(key, out, depth + 1)
            _encode(value, out, depth + 1)
    else:
        raise CodecError(f"type {type(obj).__name__} is not wire-encodable")


def py_dumps(obj: Any) -> bytes:
    out: list = []
    _encode(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise CodecError("truncated message")
        raw = self.buf[self.pos : end]
        self.pos = end
        return raw

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]


def _decode(r: _Reader, depth: int = 0) -> Any:
    if depth > _MAX_DEPTH:
        raise CodecError("nesting too deep")
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return _I64.unpack(r.take(8))[0]
    if tag == b"f":
        return _F64.unpack(r.take(8))[0]
    if tag == b"s":
        return r.take(r.u32()).decode("utf-8")
    if tag == b"b":
        return r.take(r.u32())
    if tag == b"a":
        dt = np.dtype(r.take(r.u32()).decode("ascii"))
        shape = tuple(r.u32() for _ in range(r.u32()))
        raw = r.take(r.u32())
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag == b"l":
        return [_decode(r, depth + 1) for _ in range(r.u32())]
    if tag == b"t":
        return tuple(_decode(r, depth + 1) for _ in range(r.u32()))
    if tag == b"d":
        return {_decode(r, depth + 1): _decode(r, depth + 1) for _ in range(r.u32())}
    raise CodecError(f"unknown tag {tag!r}")


def py_loads(buf: bytes) -> Any:
    r = _Reader(bytes(buf))
    try:
        obj = _decode(r)
    except CodecError:
        raise
    except Exception as exc:
        # a hostile/garbled frame must surface as CodecError so connection
        # receive loops (which catch CodecError/OSError) drop the peer
        # instead of dying: np.dtype(<junk>) raises TypeError, frombuffer /
        # reshape size mismatches raise bare ValueError, unhashable decoded
        # dict keys raise TypeError
        raise CodecError(f"malformed frame: {type(exc).__name__}: {exc}") from exc
    if r.pos != len(r.buf):
        raise CodecError("trailing bytes after message")
    return obj


# -- accelerator dispatch ----------------------------------------------------

def _accel_disabled() -> bool:
    # "0"/"false"/"no"/empty leave the accelerator on: bare truthiness
    # would read "=0" as disable, the opposite of what is meant
    return os.environ.get("HANDYRL_NO_CODEC_ACCEL", "").strip().lower() not in (
        "", "0", "false", "no",
    )


@functools.lru_cache(maxsize=None)
def get_accel():
    """The C accelerator module, built and loaded at the first call, or None
    when it is disabled or cannot be built (the pure-Python codec runs).

    Every user of the accelerator (these ``dumps``/``loads``, batch.py's
    columnar fill) asks here, so a process makes one build/load/disable
    decision.  A process that forks batchers calls this before it forks."""
    if _accel_disabled():
        return None
    try:
        from . import _codec_build

        mod = _codec_build.load()
        mod.init(CodecError, np)
    except Exception as exc:  # no compiler, read-only checkout, exotic platform
        print(f"[handyrl_tpu_torch] codec accelerator unavailable ({type(exc).__name__}: "
              f"{exc}); running the pure-Python codec", file=sys.stderr)
        return None
    return mod


def dumps(obj: Any) -> bytes:
    acc = get_accel()
    return py_dumps(obj) if acc is None else acc.dumps(obj)


def loads(buf: bytes) -> Any:
    acc = get_accel()
    return py_loads(buf) if acc is None else acc.loads(buf)
