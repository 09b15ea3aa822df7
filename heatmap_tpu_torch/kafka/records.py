"""Kafka RecordBatch v2 (magic 2) encode/decode with CRC32C.

A copy of ``heatmap_tpu/kafka/records.py`` with its Python paths only.
This is the on-wire unit both Produce and Fetch move (message format v2,
the only format modern brokers write).  Compression is not used, so
attributes are always 0 (no codec, create-time timestamps).  Compressed
inbound batches raise; the source logs and skips them.

CRC32C (Castagnoli) is a table walk in Python, one step per byte (the
reference's native codec is not ported); the checksum covers the bytes from
``attributes`` through the end of the batch, per the spec.
"""

from __future__ import annotations

import dataclasses
import struct

from heatmap_tpu_torch.kafka.protocol import Reader, Writer

# ---- CRC32C ----------------------------------------------------------------

_POLY = 0x82F63B78


def _make_table():
    tbl = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        tbl.append(c)
    return tbl


_TABLE = _make_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C by table walk."""
    crc ^= 0xFFFFFFFF
    tbl = _TABLE
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---- records ---------------------------------------------------------------

@dataclasses.dataclass
class Record:
    offset: int
    timestamp_ms: int
    key: bytes | None
    value: bytes | None
    headers: list[tuple[str, bytes]] = dataclasses.field(default_factory=list)


def encode_batch(records: list[Record], base_offset: int = 0) -> bytes:
    """One RecordBatch v2; offsets/timestamps are taken from the records
    relative to records[0]."""
    if not records:
        raise ValueError("empty batch")
    base_ts = records[0].timestamp_ms
    max_ts = max(r.timestamp_ms for r in records)
    body = Writer()
    for i, r in enumerate(records):
        rec = Writer()
        rec.i8(0)  # record attributes (unused)
        rec.varint(r.timestamp_ms - base_ts)
        rec.varint(i)
        for blob in (r.key, r.value):
            if blob is None:
                rec.varint(-1)
            else:
                rec.varint(len(blob))
                rec.raw(blob)
        rec.varint(len(r.headers))
        for hk, hv in r.headers:
            kb = hk.encode("utf-8")
            rec.varint(len(kb))
            rec.raw(kb)
            rec.varint(len(hv))
            rec.raw(hv)
        payload = rec.build()
        body.varint(len(payload))
        body.raw(payload)
    records_bytes = body.build()

    crced = Writer()
    crced.i16(0)                       # attributes: no compression
    crced.i32(len(records) - 1)        # lastOffsetDelta
    crced.i64(base_ts)
    crced.i64(max_ts)
    crced.i64(-1).i16(-1).i32(-1)      # producerId/Epoch, baseSequence
    crced.i32(len(records))
    crced.raw(records_bytes)
    crced_bytes = crced.build()

    head = Writer()
    head.i64(base_offset)
    head.i32(4 + 1 + 4 + len(crced_bytes))  # batchLength: after this field
    head.i32(-1)                       # partitionLeaderEpoch
    head.i8(2)                         # magic
    head.u32(crc32c(crced_bytes))
    return head.build() + crced_bytes


def decode_batches(buf: bytes, verify_crc: bool = True) -> list[Record]:
    """All records from a (possibly multi-batch, possibly truncated-tail)
    Fetch records blob; a truncated final batch is skipped, matching broker
    semantics (brokers may return partial batches at the end).  Raises
    ValueError on corrupt/compressed batches — streaming consumers that
    must keep moving use ``decode_batches_tolerant``."""
    return _decode(buf, verify_crc, tolerant=False)[0]


def decode_batches_tolerant(buf: bytes, start_offset: int,
                            verify_crc: bool = True
                            ) -> tuple[list[Record], int, int]:
    """(records, next_offset, n_skipped_batches): undecodable batches
    (bad CRC, unsupported compression/magic) are skipped whole — their
    offset range is still advanced past via the batch header, so a
    poisoned batch can never wedge the consumer at the same offset."""
    return _decode(buf, verify_crc, tolerant=True, start_offset=start_offset)


def _decode(buf: bytes, verify_crc: bool, tolerant: bool,
            start_offset: int = 0) -> tuple[list[Record], int, int]:
    out: list[Record] = []
    next_offset = start_offset
    skipped = 0
    i = 0
    while i + 12 <= len(buf):
        base_offset, batch_len = struct.unpack_from(">qi", buf, i)
        end = i + 12 + batch_len
        if batch_len <= 0 or end > len(buf):
            break  # truncated tail
        r = Reader(buf, i + 12)
        r.i32()  # partitionLeaderEpoch
        magic = r.i8()
        crc = r.u32()
        try:
            if magic != 2:
                raise ValueError(f"unsupported record magic {magic}")
            crced = buf[r.i:end]
            if verify_crc and crc32c(crced) != crc:
                raise ValueError("record batch CRC32C mismatch")
            attributes = r.i16()
            if attributes & 0x07:
                raise ValueError("compressed record batches unsupported")
        except ValueError:
            if not tolerant:
                raise
            # lastOffsetDelta sits at a fixed position (after epoch(4) +
            # magic(1) + crc(4) + attributes(2)); readable even when the
            # CRC/codec check failed
            try:
                last_delta = struct.unpack_from(">i", buf, i + 12 + 11)[0]
                next_offset = max(next_offset, base_offset + last_delta + 1)
            except struct.error:
                next_offset = max(next_offset, base_offset + 1)
            skipped += 1
            i = end
            continue
        r.i32()  # lastOffsetDelta
        base_ts = r.i64()
        r.i64()  # maxTimestamp
        r.i64()  # producerId
        r.i16()  # producerEpoch
        r.i32()  # baseSequence
        n = r.i32()
        for _ in range(n):
            length = r.varint()
            rec_end = r.i + length
            r.i8()  # record attributes
            ts_delta = r.varint()
            off_delta = r.varint()
            kn = r.varint()
            key = bytes(r.buf[r.i:r.i + kn]) if kn >= 0 else None
            r.i += max(kn, 0)
            vn = r.varint()
            value = bytes(r.buf[r.i:r.i + vn]) if vn >= 0 else None
            r.i += max(vn, 0)
            hn = r.varint()
            headers = []
            for _ in range(hn):
                hkn = r.varint()
                hk = bytes(r.buf[r.i:r.i + hkn]).decode("utf-8")
                r.i += hkn
                hvn = r.varint()
                hv = bytes(r.buf[r.i:r.i + hvn]) if hvn >= 0 else b""
                r.i += max(hvn, 0)
                headers.append((hk, hv))
            r.i = rec_end
            out.append(Record(base_offset + off_delta, base_ts + ts_delta,
                              key, value, headers))
            next_offset = max(next_offset, base_offset + off_delta + 1)
        i = end
    return out, next_offset, skipped
