"""In-process mock Kafka broker speaking the binary protocol over TCP.

A copy of ``heatmap_tpu/testing/mock_kafka.py``.

Serves the version RANGES the framework's client implements
(kafka/client.py ``_SUPPORTED``): Metadata v1-v7, ListOffsets v1-v3,
Produce v3-v7, Fetch v4-v11 — encoding each response per the requested
version, so the client's per-connection negotiation is exercised for
real.  Partition logs are decoded Records in memory; Produce decodes the
inbound batch (verifying CRC32C) and Fetch re-encodes from the requested
offset, so both directions of the record codec are exercised against
each other.

Topics auto-create on first metadata request with ``num_partitions``
(default 3, the reference topic's layout, README.md:100-101).
"""

from __future__ import annotations

import bisect
import socket
import socketserver
import struct
import threading
from typing import Any

from heatmap_tpu_torch.kafka import records as rec
from heatmap_tpu_torch.kafka.protocol import (
    API_FETCH, API_LIST_OFFSETS, API_METADATA, API_PRODUCE, API_VERSIONS,
    Reader, Writer,
)


class _State:
    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions
        self.topics: dict[str, list[list[rec.Record]]] = {}
        # fetch-path memo: (topic, partition, start_offset, n) -> encoded
        # RecordBatch bytes.  The log is append-only and entries are
        # immutable, so encodes never invalidate; steady sequential
        # consumption hits the same aligned segments every run, and
        # re-encoding per fetch was a measured slice of every at-rate
        # ingest test (the broker time-shares the host core).
        self.enc_cache: dict[tuple, bytes] = {}
        # produced-batch start offsets per (topic, partition): fetch
        # segments align to these (like a real broker's on-disk batches),
        # so a consumer resuming at any batch boundary — the steady
        # pattern — hits the memo instead of forcing an offset-shifted
        # re-encode of everything behind it
        self.bounds: dict[tuple, list] = {}
        self.lock = threading.Lock()

    def logs(self, topic: str) -> list[list[rec.Record]]:
        return self.topics.setdefault(
            topic, [[] for _ in range(self.num_partitions)])

    def encoded_segment(self, topic: str, pid: int, log, start: int,
                        n: int) -> bytes:
        key = (topic, pid, start, n)
        blob = self.enc_cache.get(key)
        if blob is None:
            blob = rec.encode_batch(
                [rec.Record(i, p.timestamp_ms, p.key, p.value, p.headers)
                 for i, p in enumerate(log[start:start + n])],
                base_offset=start)
            if len(self.enc_cache) >= 4096:
                self.enc_cache.clear()
            self.enc_cache[key] = blob
        return blob


class _Handler(socketserver.BaseRequestHandler):
    def _recv_exact(self, n: int) -> bytes | None:
        from heatmap_tpu_torch.utils.netio import recv_exact_or_none

        return recv_exact_or_none(self.request, n)

    def setup(self):
        # track live connections so close() can sever them — a broker
        # shutdown must look like an outage to already-connected clients,
        # not a zombie socket still serving the old in-memory state
        self.server._conns.add(self.request)  # type: ignore[attr-defined]
        if getattr(self.server, "_closing", False):
            # accepted in the races of shutdown: sever immediately
            try:
                self.request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def finish(self):
        self.server._conns.discard(self.request)  # type: ignore[attr-defined]

    def handle(self):
        while True:
            raw = self._recv_exact(4)
            if raw is None:
                return
            (size,) = struct.unpack(">i", raw)
            body = self._recv_exact(size)
            if body is None:
                return
            r = Reader(body)
            api_key, api_version, corr_id = r.i16(), r.i16(), r.i32()
            r.string()  # client_id
            st: _State = self.server.state  # type: ignore[attr-defined]
            with st.lock:
                out = self._dispatch(st, api_key, api_version, r)
            payload = struct.pack(">i", corr_id) + out
            self.request.sendall(struct.pack(">i", len(payload)) + payload)

    def _dispatch(self, st: _State, api_key: int, api_version: int,
                  r: Reader) -> bytes:
        if api_key == API_VERSIONS:
            w = Writer().i16(0)
            apis = self.server.api_versions  # type: ignore[attr-defined]
            w.i32(len(apis))
            for k, lo, hi in apis:
                w.i16(k).i16(lo).i16(hi)
            return w.build()
        v = api_version
        if api_key == API_METADATA:
            topics = r.array(r.string)
            if v >= 4:
                r.i8()  # allow_auto_topic_creation
            if topics is None:
                topics = list(st.topics)
            host, port = self.server.server_address[:2]  # type: ignore
            w = Writer()
            if v >= 3:
                w.i32(0)                # throttle_time_ms
            w.i32(1)                    # one broker
            w.i32(0).string(host).i32(port).string(None)
            if v >= 2:
                w.string("mock-cluster")
            w.i32(0)                    # controller id
            w.i32(len(topics))
            for t in topics:
                logs = st.logs(t)
                w.i16(0).string(t).i8(0)
                w.i32(len(logs))
                for pid in range(len(logs)):
                    w.i16(0).i32(pid).i32(0)
                    if v >= 7:
                        w.i32(0)         # leader_epoch
                    w.array([0], w.i32)  # replicas
                    w.array([0], w.i32)  # isr
                    if v >= 5:
                        w.array([], w.i32)  # offline_replicas
            return w.build()
        if api_key == API_LIST_OFFSETS:
            r.i32()  # replica_id
            if v >= 2:
                r.i8()  # isolation_level
            w = Writer()
            if v >= 2:
                w.i32(0)  # throttle_time_ms
            n_topics = r.i32()
            w.i32(n_topics)
            for _ in range(n_topics):
                topic = r.string()
                logs = st.logs(topic)
                n_parts = r.i32()
                w.string(topic)
                w.i32(n_parts)
                for _ in range(n_parts):
                    pid, ts = r.i32(), r.i64()
                    log = logs[pid] if pid < len(logs) else []
                    off = 0 if ts == -2 else len(log)
                    w.i32(pid).i16(0).i64(-1).i64(off)
            return w.build()
        if api_key == API_PRODUCE:
            r.string()  # transactional_id
            r.i16()     # acks
            r.i32()     # timeout
            w = Writer()
            n_topics = r.i32()
            w.i32(n_topics)
            for _ in range(n_topics):
                topic = r.string()
                logs = st.logs(topic)
                n_parts = r.i32()
                w.string(topic)
                w.i32(n_parts)
                for _ in range(n_parts):
                    pid = r.i32()
                    blob = r.bytes_() or b""
                    log = logs[pid]
                    base = len(log)
                    try:
                        batch = rec.decode_batches(blob)
                        for j, record in enumerate(batch):
                            log.append(rec.Record(
                                base + j, record.timestamp_ms,
                                record.key, record.value, record.headers))
                        if batch:
                            st.bounds.setdefault((topic, pid),
                                                 []).append(base)
                        w.i32(pid).i16(0).i64(base).i64(-1)
                    except ValueError:
                        w.i32(pid).i16(87).i64(-1).i64(-1)  # INVALID_RECORD
                    if v >= 5:
                        w.i64(0)  # log_start_offset
            if v >= 1:
                w.i32(0)  # throttle_time_ms (trails the topics array)
            return w.build()
        if api_key == API_FETCH:
            r.i32()  # replica_id
            r.i32()  # max_wait
            r.i32()  # min_bytes
            max_bytes = r.i32()
            r.i8()   # isolation
            if v >= 7:
                r.i32()  # session_id
                r.i32()  # session_epoch
            w = Writer()
            w.i32(0)  # throttle
            if v >= 7:
                w.i16(0).i32(0)  # session error + session_id
            n_topics = r.i32()
            w.i32(n_topics)
            for _ in range(n_topics):
                topic = r.string()
                logs = st.logs(topic)
                n_parts = r.i32()
                w.string(topic)
                w.i32(n_parts)
                for _ in range(n_parts):
                    pid = r.i32()
                    if v >= 9:
                        r.i32()  # current_leader_epoch
                    offset = r.i64()
                    if v >= 5:
                        r.i64()  # log_start_offset
                    r.i32()  # partition max bytes
                    log = logs[pid] if pid < len(logs) else []
                    hw = len(log)
                    if offset > hw:
                        w.i32(pid).i16(1).i64(hw).i64(hw)  # OFFSET_OUT_OF_RANGE
                        if v >= 5:
                            w.i64(0)     # log_start_offset
                        w.i32(0)         # aborted txns: empty array
                        if v >= 11:
                            w.i32(-1)    # preferred_read_replica (KIP-392)
                        w.bytes_(None)
                        continue
                    # serve segments aligned to PRODUCED batches (memo
                    # hits for any consumer resuming at a batch
                    # boundary), from the requested offset; at least one
                    # segment always goes out (Kafka semantics: the
                    # first batch may exceed max_bytes)
                    bounds = st.bounds.get((topic, pid), [])
                    idx = bisect.bisect_right(bounds, offset)
                    starts = [offset] + bounds[idx:]
                    parts_out = []
                    size = 0
                    for i, s in enumerate(starts):
                        if s >= hw:
                            break
                        end = starts[i + 1] if i + 1 < len(starts) else hw
                        enc = st.encoded_segment(topic, pid, log, s,
                                                 end - s)
                        parts_out.append(enc)
                        size += len(enc)
                        if size >= max_bytes:
                            break
                    blob = b"".join(parts_out)
                    w.i32(pid).i16(0).i64(hw).i64(hw)
                    if v >= 5:
                        w.i64(0)         # log_start_offset
                    w.i32(0)             # aborted txns
                    if v >= 11:
                        w.i32(-1)        # preferred_read_replica (KIP-392)
                    w.bytes_(blob if blob else None)
            # v7+ forgotten_topics_data and v11+ rack_id trail the request;
            # nothing further is read from it, so they need no handling
            return w.build()
        return Writer().i16(35).build()  # UNSUPPORTED_VERSION fallback


# Advertised ApiVersions tables.  LEGACY mirrors a 2.x/3.x broker (every
# historical version still served).  KIP896 mirrors a Kafka 4.x broker
# after the KIP-896 removals of pre-2.1 protocol versions, with
# DELIBERATELY aggressive minima (Metadata>=4, ListOffsets>=2 — above the
# client's old floor pins): a client that hard-pinned the floors would be
# rejected here, so passing against this table proves the per-connection
# version NEGOTIATION (kafka/client.py _SUPPORTED) actually engages the
# higher encodings end to end.
API_VERSIONS_LEGACY = (
    (API_PRODUCE, 0, 8), (API_FETCH, 0, 11), (API_LIST_OFFSETS, 0, 5),
    (API_METADATA, 0, 8), (API_VERSIONS, 0, 0),
)
API_VERSIONS_KIP896 = (
    (API_PRODUCE, 3, 11), (API_FETCH, 4, 16), (API_LIST_OFFSETS, 2, 9),
    (API_METADATA, 4, 12), (API_VERSIONS, 0, 4),
)


class MockKafkaBroker:
    """``with MockKafkaBroker() as bootstrap: KafkaClient(bootstrap)``

    ``api_versions`` overrides the advertised ApiVersions table (e.g.
    ``API_VERSIONS_KIP896`` to emulate a Kafka 4.x broker, or a custom
    table whose minima exceed the client pins to emulate a future broker
    that dropped them)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_partitions: int = 3,
                 api_versions: tuple = API_VERSIONS_LEGACY):
        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._server.state = _State(num_partitions)  # type: ignore
        self._server.api_versions = tuple(api_versions)  # type: ignore
        self._server._conns = set()  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def state(self) -> _State:
        return self._server.state  # type: ignore[attr-defined]

    @property
    def bootstrap(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def close(self) -> None:
        self._server._closing = True  # type: ignore[attr-defined]
        self._server.shutdown()
        self._server.server_close()
        for conn in list(self._server._conns):  # type: ignore[attr-defined]
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def __enter__(self) -> str:
        return self.bootstrap

    def __exit__(self, *exc) -> None:
        self.close()
