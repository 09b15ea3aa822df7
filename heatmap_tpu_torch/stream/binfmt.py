"""Fixed-layout binary event encoding (``HEATMAP_EVENT_FORMAT=binary``).

A copy of ``heatmap_tpu/stream/binfmt.py``.  Per-event JSON is the ingest
ceiling at millions of events/sec; this module defines a fixed-layout
binary event value and its portable codec (the plain version); the C++
decoder (native/decoder.cpp ``dec_decode_binary``,
``native.NativeDecoder.decode_binary``) consumes the same layout.

One event value (little-endian, 32 bytes + strings):

    u8   magic      = 0xB1
    u8   version    = 1
    u8   P          provider byte length
    u8   V          vehicleId byte length
    f32  lat        degrees
    f32  lon        degrees
    f32  speedKmh
    f32  bearing
    f32  accuracyM
    i64  ts         epoch seconds
    P bytes         provider (UTF-8)
    V bytes         vehicleId (UTF-8)

The JSON format stays the default and the reference contract; binary is an
extension both ends opt into via the same env knob.  Validation semantics on decode are identical to
the JSON path (stream/events.py): bad magic/layout, out-of-range
lat/lon/ts → dropped; non-finite speed → 0.
"""

from __future__ import annotations

import math
import struct

from heatmap_tpu_torch.stream.events import parse_ts

MAGIC = 0xB1
VERSION = 1
_HEAD = struct.Struct("<BBBB5fq")
HEADER_SIZE = _HEAD.size  # 32


def encode_event(e: dict) -> bytes:
    """Canonical event dict -> binary value bytes.  Raises KeyError /
    ValueError on events missing required fields (producers validate)."""
    provider = str(e["provider"]).encode("utf-8")
    vehicle = str(e["vehicleId"]).encode("utf-8")
    if len(provider) > 255 or len(vehicle) > 255:
        raise ValueError("provider/vehicleId longer than 255 bytes")
    ts = parse_ts(e.get("ts"))
    if ts is None:
        raise ValueError(f"unparseable ts: {e.get('ts')!r}")

    def f(key):
        v = e.get(key)
        try:
            v = float(v) if v is not None else 0.0
        except (TypeError, ValueError):
            v = 0.0
        return v if math.isfinite(v) else 0.0

    return _HEAD.pack(MAGIC, VERSION, len(provider), len(vehicle),
                      float(e["lat"]), float(e["lon"]), f("speedKmh"),
                      f("bearing"), f("accuracyM"),
                      int(ts)) + provider + vehicle


def decode_event(b: bytes) -> dict | None:
    """Binary value bytes -> event dict; None when the envelope is invalid
    (bad magic/version/length).  Field-level validation is left to
    parse_events so drop semantics match the JSON path exactly."""
    if len(b) < HEADER_SIZE:
        return None
    magic, ver, pn, vn, lat, lon, speed, bearing, acc, ts = \
        _HEAD.unpack_from(b)
    if magic != MAGIC or ver != VERSION or len(b) != HEADER_SIZE + pn + vn:
        return None
    try:
        provider = b[HEADER_SIZE:HEADER_SIZE + pn].decode("utf-8")
        vehicle = b[HEADER_SIZE + pn:HEADER_SIZE + pn + vn].decode("utf-8")
    except UnicodeDecodeError:
        return None
    return {"provider": provider, "vehicleId": vehicle, "lat": lat,
            "lon": lon, "speedKmh": speed, "bearing": bearing,
            "accuracyM": acc, "ts": ts}


def decode_events(values) -> tuple[list[dict], int]:
    """(event dicts, n_envelope_dropped) for a batch of binary values."""
    out, dropped = [], 0
    for v in values:
        d = decode_event(v)
        if d is None:
            dropped += 1
        else:
            out.append(d)
    return out, dropped


def frame_lp(values) -> bytes:
    """Length-prefix (u32 LE) and join values — the framing
    dec_decode_binary consumes (and kafka_codec emits in mode 1)."""
    parts = []
    for v in values:
        parts.append(struct.pack("<I", len(v)))
        parts.append(v)
    return b"".join(parts)
