"""Pull sources with replayable offsets.

A copy of ``Source``, ``MemorySource``, ``SyntheticSource`` and
``KafkaSource`` (its wire impl, JSON values) from
``heatmap_tpu/stream/source.py``: ``poll`` returns up to ``max_events``
events past the current position (``EventColumns``, or a list of event
dicts that the runtime parses), ``offset``/``seek`` expose a serializable
position.  ``SyntheticSource`` generates the same bytes as the reference's
for the same arguments; ``KafkaSource`` polls a topic to the same columns,
counters and offsets as the reference's wire impl with its Python decoder.

Not ported (they raise ``NotImplementedError`` where the reference would
take them): the confluent and kafka-python consumers, and the binary and
columnar event formats with the native decoders.
"""

from __future__ import annotations

import abc
import collections
import json
import logging
import math
import os
import time as _time
from typing import Any, Iterable, Sequence

import numpy as np

from heatmap_tpu_torch.stream.events import (
    EventColumns, columns_from_arrays, parse_events,
)


class Source(abc.ABC):
    @abc.abstractmethod
    def poll(self, max_events: int) -> Sequence[dict] | EventColumns:
        """Up to max_events events at the current position (may be empty)."""

    def offset(self) -> Any:
        """JSON-serializable replay position."""
        return None

    def seek(self, offset: Any) -> None:
        pass

    @property
    def exhausted(self) -> bool:
        """True when no more data will ever arrive (bounded replays)."""
        return False

    @property
    def counters(self) -> dict:
        """Transport-health counters (fetch errors, offset resets), merged
        into the runtime's metrics; sources with no transport report
        nothing."""
        return {}

    def take_spans(self) -> dict:
        """Seconds spent inside poll() since the last call, by sub-span
        (e.g. {"fetch": ..., "decode": ...}), then reset.  The runtime
        books them into its per-batch spans; sources with no meaningful
        split report nothing."""
        return {}

    def close(self) -> None:
        pass


def _decode_json_values(values: list[bytes], intern_p: dict,
                        intern_v: dict):
    """Raw JSON event values -> EventColumns (the reference's Python
    codec): undecodable values are dropped and counted in n_dropped with
    the ones that fail validation.  [] for no values."""
    if not values:
        return []
    out = []
    malformed = 0
    for v in values:
        try:
            out.append(json.loads(v))
        except (json.JSONDecodeError, UnicodeDecodeError):
            malformed += 1  # -> dropped (ref: filters)
    cols = parse_events(out, intern_p, intern_v)
    cols.n_dropped += malformed
    return cols


class MemorySource(Source):
    """Deque-fed source of event dicts, for hermetic tests."""

    def __init__(self, events: Iterable[dict] = ()):
        self._q: collections.deque = collections.deque(events)
        self._consumed = 0
        self._done = False

    def push(self, events: Iterable[dict]) -> None:
        self._q.extend(events)

    def finish(self) -> None:
        self._done = True

    def poll(self, max_events: int):
        out = []
        while self._q and len(out) < max_events:
            out.append(self._q.popleft())
        self._consumed += len(out)
        return out

    def offset(self):
        return self._consumed

    def seek(self, offset) -> None:
        """Fast-forward to a committed offset (checkpoint resume over a
        freshly re-fed deque).  The deque is consume-once, so rewinding
        below the consumed position is impossible: refuse loudly rather
        than silently replaying rows a resume already covered."""
        target = int(offset or 0)
        if target < self._consumed:
            raise ValueError(
                f"MemorySource cannot rewind: consumed {self._consumed}, "
                f"seek target {target}; re-feed the deque from the start")
        while self._consumed < target and self._q:
            self._q.popleft()
            self._consumed += 1

    @property
    def exhausted(self) -> bool:
        return self._done and not self._q


class SyntheticSource(Source):
    """Deterministic synthetic city traffic (BASELINE.json config #3).

    Every event is a pure function of its absolute index: vehicle
    ``i % n_vehicles`` follows a parametric orbit around a per-vehicle
    anchor inside the city box.  That makes ``seek`` exact and O(1) — a
    resumed replay is bit-identical regardless of batch chunking — and the
    generator is fully vectorized (no JSON on the bench hot path).
    Offset = number of events emitted.
    """

    def __init__(
        self,
        n_events: int | None = None,
        n_vehicles: int = 2000,
        center=(42.3601, -71.0589),      # Boston (reference default view)
        radius_deg: float = 0.15,
        t0: int = 1_700_000_000,
        events_per_second: int = 100_000,
        seed: int = 0,
    ):
        self.n_events = n_events  # None = unbounded
        self.n_vehicles = n_vehicles
        self.center = center
        self.radius = radius_deg
        self.t0 = t0
        self.eps = events_per_second
        self.seed = seed
        self._emitted = 0
        rng = np.random.default_rng(seed)  # init-time only: fixed draw order
        self._anchor = np.stack([
            center[0] + rng.uniform(-radius_deg, radius_deg, n_vehicles),
            center[1] + rng.uniform(-radius_deg, radius_deg, n_vehicles),
        ], axis=1)
        self._orbit_r = rng.uniform(0.002, 0.03, n_vehicles)      # deg
        self._speed = rng.uniform(10, 90, n_vehicles).astype(np.float32)
        # angular velocity (rad/s of sim time) consistent with the speed
        self._omega = (self._speed / 3.6) / (self._orbit_r * 111_000.0)
        self._phase = rng.uniform(0, 2 * math.pi, n_vehicles)
        self._vehicles = [f"veh-{i}" for i in range(n_vehicles)]

    def poll(self, max_events: int) -> EventColumns:
        n = max_events
        if self.n_events is not None:
            n = min(n, self.n_events - self._emitted)
        if n <= 0:
            return columns_from_arrays([], [], [], [])
        i = self._emitted + np.arange(n, dtype=np.int64)
        vid = (i % self.n_vehicles).astype(np.int32)
        sim_t = i / self.eps
        ang = self._omega[vid] * sim_t + self._phase[vid]
        lat = self._anchor[vid, 0] + self._orbit_r[vid] * np.cos(ang)
        lng = self._anchor[vid, 1] + self._orbit_r[vid] * np.sin(ang)
        # deterministic per-event speed jitter
        speed = np.maximum(
            self._speed[vid] + 2.0 * np.sin(0.7 * i).astype(np.float32), 0.0
        )
        ts = self.t0 + i // self.eps
        cols = columns_from_arrays(
            lat.astype(np.float32),
            lng.astype(np.float32),
            speed.astype(np.float32),
            ts.astype(np.int32),
            provider_id=np.zeros(n, np.int32),
            vehicle_id=vid,
            providers=["synthetic"],
            vehicles=self._vehicles,
        )
        self._emitted += n
        return cols

    def offset(self):
        return self._emitted

    def seek(self, offset) -> None:
        self._emitted = int(offset or 0)

    @property
    def exhausted(self) -> bool:
        return self.n_events is not None and self._emitted >= self.n_events


class KafkaSource(Source):
    """Kafka consumer source (the reference's ingress contract) over the
    port's own wire client, ``heatmap_tpu_torch.kafka``: the reference's
    wire impl with its Python decoder (per-record ``json.loads``, then
    ``parse_events``).

    Starts at LATEST offsets like the reference (startingOffsets=latest);
    ``seek`` with a checkpointed {partition: offset} map overrides that on
    resume.  Round-robins partitions each poll so no partition starves
    under a small max_events.  Offsets are tracked per partition and
    committed through the runtime's checkpoint, not the broker.

    HEATMAP_KAFKA_IMPL: ``auto`` and ``wire`` take this client (the
    reference's ``auto`` prefers confluent_kafka when installed; no such
    client is ported); ``confluent`` and ``kafka-python`` raise.
    HEATMAP_EVENT_FORMAT: only the reference contract's ``json`` values
    are ported; ``binary`` and ``columnar`` raise rather than decode
    something else.
    """

    # extra fetch sweeps per poll may start within this wall budget (the
    # first sweep always runs); see _fetch_values
    sweep_budget_s = 0.2

    def __init__(self, bootstrap: str, topic: str):
        impl = os.environ.get("HEATMAP_KAFKA_IMPL", "auto")
        if impl in ("confluent", "kafka-python"):
            raise NotImplementedError(
                f"HEATMAP_KAFKA_IMPL={impl!r}: only the wire client is "
                f"ported to heatmap_tpu_torch (use 'wire' or 'auto')")
        if impl not in ("auto", "wire"):
            raise ValueError(f"HEATMAP_KAFKA_IMPL must be auto|wire|"
                             f"confluent|kafka-python, got {impl!r}")
        fmt = os.environ.get("HEATMAP_EVENT_FORMAT", "json")
        if fmt != "json":
            raise NotImplementedError(
                f"HEATMAP_EVENT_FORMAT={fmt!r}: only 'json' is ported to "
                f"heatmap_tpu_torch (binary and columnar values need the "
                f"reference's native decoders)")
        from heatmap_tpu_torch.kafka import KafkaClient

        self.log = logging.getLogger(__name__)
        self.c = KafkaClient(bootstrap)
        self.topic = topic
        self._offsets: dict[int, int] = {}
        # transport-health counters: every handled fetch/discovery error
        # and retention-forced offset reset counts
        self._counters = {"kafka_fetch_errors": 0,
                          "kafka_offset_resets": 0,
                          "kafka_discover_errors": 0}
        self._discover()
        self._rr = 0  # round-robin cursor
        self._intern_p: dict = {}
        self._intern_v: dict = {}
        # per-fetch response cap (read here, not at import, so a caller
        # setting the env var after import is honored)
        self.fetch_max_bytes = int(os.environ.get(
            "HEATMAP_FETCH_MAX_BYTES", str(4 << 20)))
        # poll sub-spans: wall spent in broker fetch round trips vs value
        # decode, drained by the runtime per batch
        self._spans = {"fetch": 0.0, "decode": 0.0}

    @property
    def counters(self) -> dict:
        return dict(self._counters)

    def take_spans(self) -> dict:
        out = {k: v for k, v in self._spans.items() if v > 0.0}
        self._spans = {"fetch": 0.0, "decode": 0.0}
        return out

    def _discover(self) -> None:
        """(Re)initialize offsets for newly visible partitions at LATEST.
        Tolerates a topic mid-auto-creation (empty partition set): poll
        retries until leaders exist."""
        from heatmap_tpu_torch.kafka import KafkaError
        from heatmap_tpu_torch.kafka.client import LATEST

        try:
            for p, off in self.c.list_offsets(self.topic, LATEST).items():
                self._offsets.setdefault(p, off)
        except (KafkaError, ConnectionError, OSError) as e:
            self._counters["kafka_discover_errors"] += 1
            self.log.warning("kafka partition discovery failed: %s", e)

    def _guarded_fetch(self, p: int, fn):
        """One fetch with the consumer's retriable-error policy; None on a
        handled error (the partition is retried next poll)."""
        from heatmap_tpu_torch.kafka import KafkaError
        from heatmap_tpu_torch.kafka.client import EARLIEST

        t0 = _time.monotonic()
        try:
            return fn()
        except KafkaError as e:
            if e.code == 1:  # OFFSET_OUT_OF_RANGE: retention truncated
                # past our checkpoint — resume from the log start
                self._counters["kafka_offset_resets"] += 1
                try:
                    earliest = self.c.list_offsets(self.topic, EARLIEST)
                    self.log.warning(
                        "offset %d for %s[%d] out of range; resetting "
                        "to earliest %d", self._offsets[p], self.topic,
                        p, earliest.get(p, 0))
                    self._offsets[p] = earliest.get(p, 0)
                except (KafkaError, ConnectionError, OSError) as e2:
                    self.log.warning("offset reset failed: %s", e2)
            else:
                self._counters["kafka_fetch_errors"] += 1
                self.log.warning("fetch %s[%d]: %s", self.topic, p, e)
        except (ConnectionError, OSError) as e:
            self._counters["kafka_fetch_errors"] += 1
            self.log.warning("fetch %s[%d]: %s", self.topic, p, e)
        finally:
            self._spans["fetch"] += _time.monotonic() - t0
        return None

    def _fetch_values(self, max_events) -> list[bytes]:
        """Up to ``max_events`` non-null record values: round-robin the
        partitions, guarded fetch, advance the offset past every record
        (tombstones too) and past skipped batches when a fetch is fully
        consumed."""
        values: list[bytes] = []
        if not self._offsets:
            self._discover()
        parts = sorted(self._offsets)
        if not parts:
            return values
        # Sweep the partitions repeatedly until the request is filled or a
        # full sweep makes no progress: one fetch returns at most
        # ~fetch_max_bytes of records.  Only the first sweep's fetches wait
        # (max_wait_ms); follow-up sweeps use 0 so a drained topic never
        # stalls the loop, and start only within ``sweep_budget_s``, so a
        # live tail returns a partial batch instead of waiting for a
        # trickle producer to fill it.
        sweep_wait = 50
        t0 = _time.monotonic()
        while len(values) < max_events:
            progressed = False
            for k in range(len(parts)):
                if len(values) >= max_events:
                    break
                p = parts[(self._rr + k) % len(parts)]
                fr = self._guarded_fetch(
                    p, lambda p=p, w=sweep_wait: self.c.fetch(
                        self.topic, p, self._offsets[p],
                        max_bytes=self.fetch_max_bytes, max_wait_ms=w))
                if fr is None:
                    continue
                if fr.skipped_batches:
                    self.log.warning(
                        "skipped %d undecodable batches on %s[%d]",
                        fr.skipped_batches, self.topic, p)
                taken = 0
                for r in fr.records:
                    if len(values) >= max_events:
                        break
                    taken += 1
                    self._offsets[p] = r.offset + 1
                    if r.value is not None:
                        values.append(r.value)
                if taken:
                    progressed = True
                if taken == len(fr.records):
                    # consumed everything fetched: also jump past skipped
                    # batches / trailing tombstones
                    self._offsets[p] = max(self._offsets[p], fr.next_offset)
            if not progressed:
                break
            if _time.monotonic() - t0 >= self.sweep_budget_s:
                break
            sweep_wait = 0
        self._rr = (self._rr + 1) % max(len(parts), 1)
        return values

    def poll(self, max_events):
        values = self._fetch_values(max_events)
        t0 = _time.monotonic()
        cols = _decode_json_values(values, self._intern_p, self._intern_v)
        self._spans["decode"] += _time.monotonic() - t0
        return cols

    def offset(self):
        return dict(self._offsets)

    def seek(self, offset):
        if offset:
            # a committed map comes back from meta.json with string keys
            self._offsets.update({int(p): int(o) for p, o in offset.items()})

    def close(self):
        self.c.close()
