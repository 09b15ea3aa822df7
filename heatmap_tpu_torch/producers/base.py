"""Publisher transports + the shared producer polling loop.

A copy of ``heatmap_tpu/producers/base.py`` over the port's own Kafka wire
client.  The reference producer publishes JSON to Kafka keyed by vehicleId
with a flush per poll and survives API hiccups with tiered error handling
and backoff; ``run_poll_loop`` reproduces that loop shape for any
fetcher/publisher pair.
"""

from __future__ import annotations

import abc
import collections
import json
import logging
import os
import time
from typing import Callable, Iterable, Sequence

from heatmap_tpu_torch._build import KernelBuildError

log = logging.getLogger(__name__)


class Publisher(abc.ABC):
    @abc.abstractmethod
    def publish(self, events: Sequence[dict]) -> None:
        """Send a batch of canonical events (keyed by vehicleId)."""

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemoryPublisher(Publisher):
    """In-process queue; doubles as a stream.Source feeder in tests."""

    def __init__(self):
        self.queue: collections.deque = collections.deque()

    def publish(self, events: Sequence[dict]) -> None:
        self.queue.extend(events)


class JsonlPublisher(Publisher):
    """Append events to a JSONL capture (replayable by JsonlReplaySource)."""

    def __init__(self, path: str):
        self._fh = open(path, "a", encoding="utf-8")

    def publish(self, events: Sequence[dict]) -> None:
        for e in events:
            self._fh.write(json.dumps(e) + "\n")

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class KafkaPublisher(Publisher):
    """Kafka producer over the port's wire client
    (``heatmap_tpu_torch.kafka``), keyed by vehicleId and partitioned by
    murmur2(key) exactly like stock clients: the reference's wire mode.
    ``event_format`` (default ``HEATMAP_EVENT_FORMAT``, else json): "json"
    (the reference's schema), "binary" (stream/binfmt.py, one value per
    event) or "columnar" (stream/colfmt.py: events buffered until
    ``flush`` and sent as struct-of-arrays values of up to ``_COL_CHUNK``
    events, round-robin over the partitions; ``publish_columns`` sends an
    ``EventColumns`` batch the same way).  ``impl="confluent"`` (or
    ``HEATMAP_KAFKA_IMPL=confluent``) raises: no such client is ported."""

    def __init__(self, bootstrap: str, topic: str, impl: str | None = None,
                 event_format: str | None = None):
        self.topic = topic
        self.event_format = event_format or os.environ.get(
            "HEATMAP_EVENT_FORMAT", "json")
        self._colbuf: list[dict] = []
        self._rr = 0
        if self.event_format == "binary":
            from heatmap_tpu_torch.stream.binfmt import encode_event

            self._encode_value = encode_event
        elif self.event_format == "columnar":
            self._encode_value = None  # batched: see publish()/flush()
        else:
            self._encode_value = lambda e: json.dumps(e).encode("utf-8")
        impl = impl or os.environ.get("HEATMAP_KAFKA_IMPL", "auto")
        if impl == "confluent":
            raise NotImplementedError(
                "HEATMAP_KAFKA_IMPL='confluent': only the wire client is "
                "ported to heatmap_tpu_torch (use 'wire' or 'auto')")
        from heatmap_tpu_torch.kafka import KafkaClient

        self._p = KafkaClient(bootstrap)
        self._parts: list[int] = []
        self._pending: dict[int, list] = {}
        # NOT resolved here: a topic mid-auto-creation would make the
        # constructor raise and make_publisher permanently downgrade;
        # publish() resolves lazily and the poll loop retries

    def _ensure_parts(self) -> list[int]:
        """Partition list, re-queried until the topic has leaders (a topic
        mid-auto-creation reports none) so keys are never pinned to a
        guessed partition count."""
        if not self._parts:
            self._parts = self._p.partitions(self.topic)
            if not self._parts:
                from heatmap_tpu_torch.kafka import KafkaError

                raise KafkaError(5, f"topic {self.topic} has no leaders yet")
        return self._parts

    def publish(self, events: Sequence[dict]) -> None:
        if self.event_format == "columnar":
            # batches can't be keyed per vehicle; buffered until flush(),
            # then one columnar value round-robins across partitions
            self._colbuf.extend(events)
            return
        from heatmap_tpu_torch.kafka import Record
        from heatmap_tpu_torch.kafka.client import partition_for_key

        parts = self._ensure_parts()
        now_ms = int(time.time() * 1000)
        for e in events:
            key = str(e.get("vehicleId", "")).encode("utf-8")
            p = partition_for_key(key, len(parts))
            self._pending.setdefault(p, []).append(
                Record(0, now_ms, key, self._encode_value(e)))

    # events per columnar record: ~36 B/event + strings keeps a chunk
    # well inside the broker's default 1 MB message.max.bytes, and bounds
    # how much a failed produce re-encodes on retry
    _COL_CHUNK = 16384

    def _produce_columnar_value(self, value: bytes) -> None:
        from heatmap_tpu_torch.kafka import Record

        parts = self._ensure_parts()
        p = parts[self._rr % len(parts)]
        self._p.produce(self.topic, p,
                        [Record(0, int(time.time() * 1000), None, value)])
        self._rr += 1

    def _flush_columnar(self) -> None:
        from heatmap_tpu_torch.stream.colfmt import encode_batch

        while self._colbuf:
            chunk = self._colbuf[:self._COL_CHUNK]
            self._produce_columnar_value(encode_batch(chunk))
            # dropped only after a successful produce; a failure keeps the
            # unpublished remainder for the poll loop's retry
            del self._colbuf[:len(chunk)]

    def publish_columns(self, cols) -> int:
        """High-rate columnar path: publish an EventColumns batch directly
        (array-native encode, no per-event Python) in bounded chunks;
        returns the number of events produced.  Requires
        event_format=columnar.

        At-least-once: a failure mid-batch raises with
        ``e.events_published`` set to the count already on the wire, so a
        caller can resume from that row instead of re-sending (a blind
        retry duplicates the delivered prefix, like any Kafka producer
        retry)."""
        if self.event_format != "columnar":
            raise ValueError("publish_columns requires event_format="
                             f"'columnar', not {self.event_format!r}")
        from heatmap_tpu_torch.stream.colfmt import encode_batch_columns
        from heatmap_tpu_torch.stream.events import slice_columns

        published = 0
        try:
            for k in range(0, len(cols), self._COL_CHUNK):
                end = min(k + self._COL_CHUNK, len(cols))
                self._produce_columnar_value(
                    encode_batch_columns(slice_columns(cols, k, end)))
                published = end
        except Exception as e:
            e.events_published = published
            raise
        return published

    def flush(self) -> None:
        if self.event_format == "columnar":
            self._flush_columnar()
            return
        pending, self._pending = self._pending, {}
        try:
            for p in list(pending):
                if pending[p]:
                    self._p.produce(self.topic, self._parts[p], pending[p])
                del pending[p]
        except Exception:
            # keep undelivered batches for the caller's retry (the poll
            # loop backs off and re-flushes)
            for p, recs in pending.items():
                self._pending.setdefault(p, [])[:0] = recs
            raise

    def close(self) -> None:
        self.flush()
        self._p.close()


def make_publisher(cfg, kind: str = "auto", path: str | None = None) -> Publisher:
    """``memory``, ``jsonl`` (``path``, default events.jsonl), ``kafka``
    (raises when no broker answers), or ``auto``: Kafka, else a JSONL
    capture when no broker answers, as in the reference.  An unported
    client impl or a codec that cannot be built raises either way."""
    if kind == "memory":
        return MemoryPublisher()
    if kind == "jsonl":
        return JsonlPublisher(path or "events.jsonl")
    if kind == "kafka":
        return KafkaPublisher(cfg.kafka_bootstrap, cfg.kafka_topic)
    try:
        return KafkaPublisher(cfg.kafka_bootstrap, cfg.kafka_topic)
    except (NotImplementedError, KernelBuildError):
        raise
    except (ImportError, OSError, RuntimeError) as e:
        # RuntimeError covers KafkaError (topic/leader not available)
        log.warning("kafka unavailable (%s); capturing to events.jsonl", e)
        return JsonlPublisher(path or "events.jsonl")


def _http_error_tiers() -> tuple[tuple, tuple]:
    """(HTTP errors, other network errors) of ``requests``, or two empty
    tiers where it is not installed (a fetch over an injected session then
    raises none of them)."""
    try:
        import requests
    except ImportError:
        return (), ()
    return (requests.HTTPError,), (requests.RequestException,)


def run_poll_loop(
    fetch: Callable[[], Iterable[dict]],
    publisher: Publisher,
    period_s: float,
    max_polls: int | None = None,
    error_backoff_s: float = 5.0,
) -> int:
    """The reference producer's loop shape: fetch → publish → flush →
    sleep, with tiered error handling (HTTP errors, network errors, the
    rest), each tier backing off ``error_backoff_s``."""
    http_errors, network_errors = _http_error_tiers()
    n = 0
    polls = 0
    while max_polls is None or polls < max_polls:
        polls += 1
        try:
            events = list(fetch())
            publisher.publish(events)
            publisher.flush()
            n += len(events)
            log.info("fetched %d events / published (total %d)", len(events), n)
            time.sleep(period_s)
        except KeyboardInterrupt:
            log.info("interrupted; stopping")
            break
        except http_errors as e:
            log.error("HTTP error from API: %s", e)
            time.sleep(error_backoff_s)
        except network_errors as e:
            log.error("network error: %s", e)
            time.sleep(error_backoff_s)
        except Exception:
            log.exception("unexpected producer error")
            time.sleep(error_backoff_s)
    return n
