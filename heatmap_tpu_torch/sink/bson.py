"""Minimal BSON codec (encode/decode) for the Mongo wire client.

A copy of ``heatmap_tpu/sink/bson.py``.

The reference talks to MongoDB through pymongo's C extension
(heatmap_stream.py:17,156; app.py:7,16); this image has no pymongo, so the
framework carries its own codec covering every type the sink and serving
layers actually move: documents, arrays, UTF-8 strings, doubles, int32/64,
booleans, null, UTC datetimes, and (decode-only) ObjectId.

Spec: bsonspec.org version 1.1.  Ints encode as int32 when they fit,
else int64.  Datetimes encode as millisecond UTC (type 0x09) and decode
back to timezone-aware ``datetime``; naive datetimes are treated as UTC,
matching how the rest of the sink builds docs (sink/base.py).
"""

from __future__ import annotations

import datetime as dt
import struct

UTC = dt.timezone.utc

_EPOCH = dt.datetime(1970, 1, 1, tzinfo=UTC)


class Int64(int):
    """Force int64 encoding (type 0x12) regardless of magnitude — some
    server fields (e.g. getMore's cursor id) are type-checked as long."""


class ObjectId:
    """Opaque 12-byte id (decode-only; the sink always supplies string _ids)."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 12:
            raise ValueError("ObjectId must be 12 bytes")
        self.raw = raw

    def __repr__(self):
        return f"ObjectId({self.raw.hex()})"

    def __eq__(self, other):
        return isinstance(other, ObjectId) and self.raw == other.raw

    def __hash__(self):
        return hash(self.raw)


def _dt_to_ms(v: dt.datetime) -> int:
    if v.tzinfo is None:
        v = v.replace(tzinfo=UTC)
    return round(v.timestamp() * 1000)


def _encode_value(name: bytes, v, out: bytearray) -> None:
    if isinstance(v, bool):  # before int: bool is an int subclass
        out += b"\x08" + name + b"\x00" + (b"\x01" if v else b"\x00")
    elif isinstance(v, float):
        out += b"\x01" + name + b"\x00" + struct.pack("<d", v)
    elif isinstance(v, Int64):
        out += b"\x12" + name + b"\x00" + struct.pack("<q", v)
    elif isinstance(v, int):
        if -(2**31) <= v < 2**31:
            out += b"\x10" + name + b"\x00" + struct.pack("<i", v)
        elif -(2**63) <= v < 2**63:
            out += b"\x12" + name + b"\x00" + struct.pack("<q", v)
        else:
            raise OverflowError(f"int too large for BSON: {v}")
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out += b"\x02" + name + b"\x00" + struct.pack("<i", len(b) + 1) + b + b"\x00"
    elif v is None:
        out += b"\x0a" + name + b"\x00"
    elif isinstance(v, dt.datetime):
        out += b"\x09" + name + b"\x00" + struct.pack("<q", _dt_to_ms(v))
    elif isinstance(v, dict):
        out += b"\x03" + name + b"\x00" + encode(v)
    elif isinstance(v, (list, tuple)):
        out += b"\x04" + name + b"\x00"
        doc = bytearray()
        for i, item in enumerate(v):
            _encode_value(str(i).encode(), item, doc)
        out += struct.pack("<i", len(doc) + 5) + bytes(doc) + b"\x00"
    elif isinstance(v, (bytes, bytearray)):
        out += (b"\x05" + name + b"\x00" + struct.pack("<i", len(v)) + b"\x00"
                + bytes(v))
    elif isinstance(v, ObjectId):
        out += b"\x07" + name + b"\x00" + v.raw
    else:
        raise TypeError(f"cannot BSON-encode {type(v).__name__}: {v!r}")


def encode(doc: dict) -> bytes:
    body = bytearray()
    for k, v in doc.items():
        _encode_value(str(k).encode("utf-8"), v, body)
    return struct.pack("<i", len(body) + 5) + bytes(body) + b"\x00"


def _decode_cstring(buf: bytes, i: int) -> tuple[str, int]:
    end = buf.index(b"\x00", i)
    return buf[i:end].decode("utf-8"), end + 1


def _decode_value(t: int, buf: bytes, i: int):
    if t == 0x01:
        return struct.unpack_from("<d", buf, i)[0], i + 8
    if t == 0x02:
        (n,) = struct.unpack_from("<i", buf, i)
        s = buf[i + 4:i + 4 + n - 1].decode("utf-8", "surrogatepass")
        return s, i + 4 + n
    if t in (0x03, 0x04):
        (n,) = struct.unpack_from("<i", buf, i)
        sub = decode(buf[i:i + n])
        if t == 0x04:
            sub = [sub[k] for k in sub]
        return sub, i + n
    if t == 0x05:
        (n,) = struct.unpack_from("<i", buf, i)
        return bytes(buf[i + 5:i + 5 + n]), i + 5 + n
    if t == 0x07:
        return ObjectId(bytes(buf[i:i + 12])), i + 12
    if t == 0x08:
        return buf[i] != 0, i + 1
    if t == 0x09:
        (ms,) = struct.unpack_from("<q", buf, i)
        return _EPOCH + dt.timedelta(milliseconds=ms), i + 8
    if t == 0x0A:
        return None, i
    if t == 0x10:
        return struct.unpack_from("<i", buf, i)[0], i + 4
    if t == 0x11:  # timestamp (internal) — surface as int
        return struct.unpack_from("<Q", buf, i)[0], i + 8
    if t == 0x12:
        return Int64(struct.unpack_from("<q", buf, i)[0]), i + 8
    raise ValueError(f"unsupported BSON type 0x{t:02x}")


def decode(buf: bytes) -> dict:
    (total,) = struct.unpack_from("<i", buf, 0)
    if total > len(buf):
        raise ValueError("truncated BSON document")
    out: dict = {}
    i = 4
    while i < total - 1:
        t = buf[i]
        name, i = _decode_cstring(buf, i + 1)
        out[name], i = _decode_value(t, buf, i)
    return out
