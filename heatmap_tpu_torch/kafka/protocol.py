"""Kafka protocol primitives and request/response framing.

A copy of ``heatmap_tpu/kafka/protocol.py``.

Non-flexible (pre-KIP-482) encodings only — no tagged fields.  The
client negotiates per-connection version RANGES within that encoding
family (client.py `_SUPPORTED`): ApiVersions v0, Metadata v1-v7,
ListOffsets v1-v3, Produce v3-v7, Fetch v4-v11 — floors serve pre-KIP
brokers (0.11+, message format v2), ceilings survive the KIP-896
(Kafka 4.0) removals of early versions.  Kept deliberately small; see
kafka/client.py for negotiation and use.
"""

from __future__ import annotations

import struct


class Reader:
    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes, i: int = 0):
        self.buf = buf
        self.i = i

    def _take(self, n: int) -> bytes:
        b = self.buf[self.i:self.i + n]
        if len(b) != n:
            raise EOFError("truncated Kafka frame")
        self.i += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> str | None:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)

    def array(self, fn):
        n = self.i32()
        if n < 0:
            return None
        return [fn() for _ in range(n)]

    def varint(self) -> int:
        """Zigzag varint (record encoding)."""
        shift, acc = 0, 0
        while True:
            b = self.buf[self.i]
            self.i += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def remaining(self) -> int:
        return len(self.buf) - self.i


class Writer:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: list[bytes] = []

    def i8(self, v: int):
        self.parts.append(struct.pack(">b", v))
        return self

    def i16(self, v: int):
        self.parts.append(struct.pack(">h", v))
        return self

    def i32(self, v: int):
        self.parts.append(struct.pack(">i", v))
        return self

    def i64(self, v: int):
        self.parts.append(struct.pack(">q", v))
        return self

    def u32(self, v: int):
        self.parts.append(struct.pack(">I", v))
        return self

    def string(self, v: str | None):
        if v is None:
            return self.i16(-1)
        b = v.encode("utf-8")
        self.i16(len(b))
        self.parts.append(b)
        return self

    def bytes_(self, v: bytes | None):
        if v is None:
            return self.i32(-1)
        self.i32(len(v))
        self.parts.append(bytes(v))
        return self

    def array(self, items, fn):
        self.i32(len(items))
        for it in items:
            fn(it)
        return self

    def varint(self, v: int):
        """Zigzag varint (record encoding)."""
        z = (v << 1) ^ (v >> 63) if v < 0 else v << 1
        while True:
            b = z & 0x7F
            z >>= 7
            if z:
                self.parts.append(bytes([b | 0x80]))
            else:
                self.parts.append(bytes([b]))
                return self

    def raw(self, b: bytes):
        self.parts.append(bytes(b))
        return self

    def build(self) -> bytes:
        return b"".join(self.parts)


def frame_request(api_key: int, api_version: int, correlation_id: int,
                  client_id: str, body: bytes) -> bytes:
    head = Writer().i16(api_key).i16(api_version).i32(correlation_id) \
                   .string(client_id).build()
    return struct.pack(">i", len(head) + len(body)) + head + body


def read_frame(recv_exact) -> tuple[int, Reader]:
    """(correlation_id, body reader) from a length-prefixed response."""
    (size,) = struct.unpack(">i", recv_exact(4))
    buf = recv_exact(size)
    r = Reader(buf)
    return r.i32(), r


# API keys used by the client
API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_VERSIONS = 18

ERRORS = {
    0: "NONE",
    1: "OFFSET_OUT_OF_RANGE",
    3: "UNKNOWN_TOPIC_OR_PARTITION",
    5: "LEADER_NOT_AVAILABLE",
    6: "NOT_LEADER_OR_FOLLOWER",
    7: "REQUEST_TIMED_OUT",
    35: "UNSUPPORTED_VERSION",
}
