"""Kafka broker client: metadata, produce, fetch, list_offsets.

A copy of ``heatmap_tpu/kafka/client.py``: ``fetch_values`` frames the
values with the native codec (``native.kafka_decode_values``) and takes the
Python record decoder only for a blob that codec refuses.

``BrokerClient`` is one TCP connection to one broker.  ``KafkaClient``
adds cluster awareness: it bootstraps metadata, routes produce/fetch to
each partition's leader, and refreshes + retries once on leadership
errors (NOT_LEADER_OR_FOLLOWER / LEADER_NOT_AVAILABLE / UNKNOWN_TOPIC).

API versions are NEGOTIATED per connection: ``BrokerClient`` reads the
broker's ApiVersions response and uses the highest version inside both
the broker's range and this client's implemented range (``_SUPPORTED``,
all non-flexible encodings), failing at connect with an actionable
message when there is no overlap (e.g. a post-4.x broker that finally
drops them).
Offsets are the caller's responsibility (framework checkpoint ownership,
see package docstring).
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
import time
import typing

from heatmap_tpu_torch.kafka import records as rec
from heatmap_tpu_torch.kafka.protocol import (
    API_FETCH, API_LIST_OFFSETS, API_METADATA, API_PRODUCE, API_VERSIONS,
    ERRORS, Reader, Writer, frame_request, read_frame,
)

_corr = itertools.count(1)

# Implemented per-API version RANGES (all non-flexible encodings; flexible
# starts at Produce v9 / Fetch v12 / Metadata v9 / ListOffsets v6).  Each
# connection negotiates the highest version inside both this range and the
# broker's advertised range (ApiVersions), so the client works against any
# broker era with an overlap: the floors are what kafka-python-era clients
# use (kept by every broker through at least 4.x), the ceilings cover the
# KIP-896 (Kafka 4.0) removals of early versions.
_SUPPORTED = {API_PRODUCE: (3, 7), API_FETCH: (4, 11),
              API_LIST_OFFSETS: (1, 3), API_METADATA: (1, 7),
              API_VERSIONS: (0, 0)}

EARLIEST = -2
LATEST = -1


def murmur2(data: bytes) -> int:
    """Kafka's murmur2 (the Java client's default partitioner hash), so
    keys produced here land on the same partitions any stock client uses."""
    mask = 0xFFFFFFFF
    m, r = 0x5BD1E995, 24
    h = (0x9747B28C ^ len(data)) & mask
    i = 0
    while len(data) - i >= 4:
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * m) & mask
        k ^= k >> r
        k = (k * m) & mask
        h = (h * m) & mask
        h ^= k
        i += 4
    rem = len(data) - i
    if rem >= 3:
        h ^= data[i + 2] << 16
    if rem >= 2:
        h ^= data[i + 1] << 8
    if rem >= 1:
        h ^= data[i]
        h = (h * m) & mask
    h ^= h >> 13
    h = (h * m) & mask
    h ^= h >> 15
    return h


def partition_for_key(key: bytes, n_partitions: int) -> int:
    return (murmur2(key) & 0x7FFFFFFF) % n_partitions


class KafkaError(RuntimeError):
    def __init__(self, code: int, where: str):
        super().__init__(f"{where}: {ERRORS.get(code, code)} ({code})")
        self.code = code


_RETRIABLE = {3, 5, 6}  # unknown topic/partition, leader not available/moved


class FetchResult(typing.NamedTuple):
    """``next_offset`` is where the next fetch should resume: past every
    decoded record AND past any skipped (corrupt/compressed) batch, so a
    poisoned batch or a tail tombstone can never wedge the consumer."""

    high_watermark: int
    records: list
    next_offset: int
    skipped_batches: int


class BrokerClient:
    """One connection, synchronous request/response."""

    def __init__(self, host: str, port: int, client_id: str = "heatmap-tpu",
                 timeout_s: float = 10.0):
        self.host, self.port = host, port
        self.client_id = client_id
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._dead = False
        # per-API versions in use on THIS connection; ApiVersions itself
        # must go out before negotiation completes, hence the seed entry
        self._use: dict[int, int] = {API_VERSIONS: 0}
        try:
            self._check_versions()
        except Exception:
            # fail-at-connect must not leak the just-opened socket (a
            # reconnect loop against an incompatible broker would pile
            # up open connections until GC)
            self.close()
            raise

    def _recv_exact(self, n: int) -> bytes:
        from heatmap_tpu_torch.utils.netio import recv_exact

        return recv_exact(self._sock, n)

    def request(self, api_key: int, body: bytes) -> Reader:
        if self._dead:
            raise ConnectionError("connection poisoned; reconnect")
        cid = next(_corr)
        msg = frame_request(api_key, self._use[api_key], cid,
                            self.client_id, body)
        with self._lock:
            try:
                self._sock.sendall(msg)
                got_cid, r = read_frame(self._recv_exact)
            except OSError:
                self._dead = True
                self.close()
                raise
        if got_cid != cid:
            self._dead = True
            self.close()
            raise ConnectionError(
                f"correlation id {got_cid} != {cid} (desynced)")
        return r

    def _check_versions(self) -> None:
        r = self.request(API_VERSIONS, b"")
        err = r.i16()
        if err:
            raise KafkaError(err, "ApiVersions")
        supported = {}
        for _ in range(r.i32()):
            k, lo, hi = r.i16(), r.i16(), r.i16()
            supported[k] = (lo, hi)
        names = {API_PRODUCE: "Produce", API_FETCH: "Fetch",
                 API_LIST_OFFSETS: "ListOffsets", API_METADATA: "Metadata"}
        for k, (lo_i, hi_i) in _SUPPORTED.items():
            if k == API_VERSIONS:
                continue
            lo_b, hi_b = supported.get(k, (0, -1))
            use = min(hi_i, hi_b)
            if use < max(lo_i, lo_b):
                # no overlap between what we implement and what the broker
                # serves — fail AT CONNECT with the ranges and a remedy
                raise KafkaError(
                    35,
                    f"broker serves {names.get(k, f'api {k}')} "
                    f"v{lo_b}..v{hi_b}; this client implements "
                    f"v{lo_i}..v{hi_i} (non-flexible encodings) with no "
                    f"overlap — use a broker within Kafka 2.1..4.x-era "
                    f"protocol support")
            self._use[k] = use

    # ---- requests ---------------------------------------------------------

    def metadata(self, topics: list[str] | None = None) -> dict:
        v = self._use[API_METADATA]
        w = Writer()
        if topics is None:
            w.i32(-1)
        else:
            w.array(topics, w.string)
        if v >= 4:
            w.i8(1)  # allow_auto_topic_creation (v1-v3 behavior)
        r = self.request(API_METADATA, w.build())
        if v >= 3:
            r.i32()  # throttle_time_ms
        brokers = {}
        for _ in range(r.i32()):
            node, host, port = r.i32(), r.string(), r.i32()
            r.string()  # rack
            brokers[node] = (host, port)
        if v >= 2:
            r.string()  # cluster_id
        r.i32()  # controller id
        topics_out = {}
        for _ in range(r.i32()):
            terr, name = r.i16(), r.string()
            r.i8()  # is_internal
            parts = {}
            for _ in range(r.i32()):
                perr, pid, leader = r.i16(), r.i32(), r.i32()
                if v >= 7:
                    r.i32()  # leader_epoch
                r.array(r.i32)  # replicas
                r.array(r.i32)  # isr
                if v >= 5:
                    r.array(r.i32)  # offline_replicas
                parts[pid] = {"leader": leader, "error": perr}
            topics_out[name] = {"error": terr, "partitions": parts}
        return {"brokers": brokers, "topics": topics_out}

    def list_offsets(self, topic: str, partitions: dict[int, int]) -> dict[int, int]:
        """partitions: {partition: timestamp(-1 latest / -2 earliest)} →
        {partition: offset}."""
        v = self._use[API_LIST_OFFSETS]
        w = Writer()
        w.i32(-1)  # replica_id
        if v >= 2:
            w.i8(0)  # isolation_level: read_uncommitted
        w.i32(1)   # one topic
        w.string(topic)
        w.i32(len(partitions))
        for p, ts in partitions.items():
            w.i32(p).i64(ts)
        r = self.request(API_LIST_OFFSETS, w.build())
        if v >= 2:
            r.i32()  # throttle_time_ms
        out = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                pid, err = r.i32(), r.i16()
                r.i64()  # timestamp
                off = r.i64()
                if err:
                    raise KafkaError(err, f"ListOffsets {topic}[{pid}]")
                out[pid] = off
        return out

    def produce(self, topic: str, partition: int, batch: bytes,
                acks: int = 1, timeout_ms: int = 10_000) -> int:
        """Returns the base offset assigned to the batch."""
        v = self._use[API_PRODUCE]
        w = Writer()
        w.string(None)  # transactional_id
        w.i16(acks).i32(timeout_ms)
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition)
        w.bytes_(batch)  # request encoding is identical across v3-v7
        r = self.request(API_PRODUCE, w.build())
        base = -1
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                pid, err, base = r.i32(), r.i16(), r.i64()
                r.i64()  # log_append_time (v2+)
                if v >= 5:
                    r.i64()  # log_start_offset
                if err:
                    raise KafkaError(err, f"Produce {topic}[{pid}]")
        return base

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20, max_wait_ms: int = 100,
              min_bytes: int = 1) -> tuple[int, bytes]:
        """(high_watermark, raw records blob)."""
        v = self._use[API_FETCH]
        w = Writer()
        w.i32(-1)                       # replica_id
        w.i32(max_wait_ms).i32(min_bytes).i32(max_bytes)
        w.i8(0)                         # isolation: read_uncommitted
        if v >= 7:
            # sessionless full fetch: no incremental-session state to
            # carry for a single-partition request
            w.i32(0).i32(-1)            # session_id, session_epoch
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition)
        if v >= 9:
            w.i32(-1)                   # current_leader_epoch: unknown
        w.i64(offset)
        if v >= 5:
            w.i64(-1)                   # log_start_offset (consumer: -1)
        w.i32(max_bytes)
        if v >= 7:
            w.i32(0)                    # forgotten_topics_data: none
        if v >= 11:
            w.string("")                # rack_id
        r = self.request(API_FETCH, w.build())
        r.i32()  # throttle
        if v >= 7:
            err = r.i16()               # session-level error
            r.i32()                     # session_id
            if err:
                raise KafkaError(err, f"Fetch {topic} (session)")
        hw, blob = 0, b""
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                pid, err = r.i32(), r.i16()
                hw = r.i64()
                r.i64()       # last_stable_offset
                if v >= 5:
                    r.i64()   # log_start_offset
                r.array(lambda: (r.i64(), r.i64()))  # aborted txns
                if v >= 11:
                    r.i32()   # preferred_read_replica (KIP-392)
                blob = r.bytes_() or b""
                if err:
                    raise KafkaError(err, f"Fetch {topic}[{pid}]")
        return hw, blob

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _parse_bootstrap(bootstrap: str) -> list[tuple[str, int]]:
    out = []
    for hp in bootstrap.split(","):
        hp = hp.strip()
        if not hp:
            continue
        host, sep, port = hp.rpartition(":")
        if sep and port.isdigit():
            out.append((host or "localhost", int(port)))
        else:
            out.append((hp, 9092))  # bare hostname: Kafka default port
    return out


class KafkaClient:
    """Cluster-aware client: leader routing + one metadata-refresh retry."""

    def __init__(self, bootstrap: str, client_id: str = "heatmap-tpu",
                 timeout_s: float = 10.0):
        self.client_id = client_id
        self.timeout_s = timeout_s
        self._bootstrap = _parse_bootstrap(bootstrap)
        self._conns: dict[tuple[str, int], BrokerClient] = {}
        self._leaders: dict[tuple[str, int], tuple[str, int]] = {}
        self._bootstrap_conn()  # fail fast when nothing is reachable

    def _connect(self, host: str, port: int) -> BrokerClient:
        key = (host, port)
        c = self._conns.get(key)
        if c is None or c._dead:
            c = BrokerClient(host, port, self.client_id, self.timeout_s)
            self._conns[key] = c
        return c

    def _bootstrap_conn(self) -> BrokerClient:
        """A live connection to any bootstrap broker; reconnects after the
        previous one was poisoned (a transient socket error must not kill
        the client for good)."""
        last_err: Exception | None = None
        for host, port in self._bootstrap:
            try:
                return self._connect(host, port)
            except OSError as e:
                last_err = e
        raise ConnectionError(f"no bootstrap broker reachable: {last_err}")

    def refresh_metadata(self, topic: str) -> dict[int, tuple[str, int]]:
        md = self._bootstrap_conn().metadata([topic])
        t = md["topics"].get(topic)
        if t is None or t["error"] not in (0, 5):
            raise KafkaError(t["error"] if t else 3, f"Metadata {topic}")
        for pid, p in t["partitions"].items():
            if p["leader"] in md["brokers"]:
                self._leaders[(topic, pid)] = md["brokers"][p["leader"]]
        return {pid: self._leaders[(topic, pid)]
                for pid in t["partitions"]
                if (topic, pid) in self._leaders}

    def partitions(self, topic: str) -> list[int]:
        return sorted(self.refresh_metadata(topic))

    def _leader_conn(self, topic: str, partition: int) -> BrokerClient:
        key = (topic, partition)
        if key not in self._leaders:
            self.refresh_metadata(topic)
        if key not in self._leaders:
            raise KafkaError(5, f"no leader for {topic}[{partition}]")
        return self._connect(*self._leaders[key])

    def _with_retry(self, topic: str, partition: int, fn):
        try:
            return fn(self._leader_conn(topic, partition))
        except (KafkaError, ConnectionError, OSError) as e:
            if isinstance(e, KafkaError) and e.code not in _RETRIABLE:
                raise
            time.sleep(0.1)
            self.refresh_metadata(topic)
            return fn(self._leader_conn(topic, partition))

    # ---- public ops -------------------------------------------------------

    def produce(self, topic: str, partition: int,
                records: list[rec.Record], acks: int = 1) -> int:
        batch = rec.encode_batch(records)
        return self._with_retry(
            topic, partition, lambda c: c.produce(topic, partition, batch,
                                                  acks=acks))

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20,
              max_wait_ms: int = 100) -> "FetchResult":
        hw, blob = self._with_retry(
            topic, partition,
            lambda c: c.fetch(topic, partition, offset, max_bytes,
                              max_wait_ms))
        records, next_off, skipped = rec.decode_batches_tolerant(blob, offset)
        records = [r for r in records if r.offset >= offset]
        return FetchResult(hw, records, max(next_off, offset), skipped)

    def fetch_values(self, topic: str, partition: int, offset: int,
                     max_bytes: int = 1 << 20, max_wait_ms: int = 100,
                     framing: str = "newline"):
        """Fetch + decode straight to a joined values blob via the C++
        batch decoder (native.kafka_decode_values), the consumer hot path,
        skipping per-record Python entirely.  ``framing``: "newline" for
        JSON values, "lp" (u32 length prefixes) for binary event values.
        Returns (high_watermark, KafkaValues) or, when the native framing
        refuses this blob (malformed varints, newline-bearing values under
        newline framing), (high_watermark, FetchResult) from the Python
        decoder, as the reference does."""
        from heatmap_tpu_torch.native import kafka_decode_values

        hw, blob = self._with_retry(
            topic, partition,
            lambda c: c.fetch(topic, partition, offset, max_bytes,
                              max_wait_ms))
        kv = kafka_decode_values(blob, offset, framing=framing)
        if kv is not None:
            kv.next_offset = max(kv.next_offset, offset)
            return hw, kv
        records, next_off, skipped = rec.decode_batches_tolerant(blob, offset)
        records = [r for r in records if r.offset >= offset]
        return hw, FetchResult(hw, records, max(next_off, offset), skipped)

    def list_offsets(self, topic: str, timestamp: int = LATEST) -> dict[int, int]:
        parts = self.partitions(topic)
        out: dict[int, int] = {}
        by_leader: dict[tuple[str, int], list[int]] = {}
        for p in parts:
            by_leader.setdefault(self._leaders[(topic, p)], []).append(p)
        for leader, pids in by_leader.items():
            c = self._connect(*leader)
            out.update(c.list_offsets(topic, {p: timestamp for p in pids}))
        return out

    def close(self) -> None:
        for c in self._conns.values():
            c.close()
        self._conns.clear()
