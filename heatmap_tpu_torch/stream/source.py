"""Pull sources with replayable offsets.

A copy of ``Source``, ``MemorySource``, ``JsonlReplaySource``,
``SyntheticSource``, ``RampSource`` and ``KafkaSource`` (its wire impl) from
``heatmap_tpu/stream/source.py``: ``poll`` returns up to ``max_events``
events past the current position (``EventColumns``, or a list of event
dicts that the runtime parses), ``offset``/``seek`` expose a serializable
position.  ``SyntheticSource`` generates the same bytes as the reference's
for the same arguments; ``KafkaSource`` polls a topic to the same columns,
counters and offsets as the reference's wire impl, in each event format
``HEATMAP_EVENT_FORMAT`` names (``json``, ``binary``: stream/binfmt.py,
``columnar``: stream/colfmt.py): with the native codecs
(``heatmap_tpu_torch.native``: record framing, the JSON-lines and binary
decoders, the columnar string-table parser) by default, or with the Python
codecs, their plain versions, when the caller passes ``decoder="python"``.

Not ported (they raise ``NotImplementedError`` where the reference would
take them): the confluent and kafka-python consumers.
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


EVENT_FORMATS = ("json", "binary", "columnar")


def event_format() -> str:
    """``HEATMAP_EVENT_FORMAT`` (default json), read at call time; a name
    outside ``EVENT_FORMATS`` raises rather than decode as JSON."""
    fmt = os.environ.get("HEATMAP_EVENT_FORMAT", "json")
    if fmt not in EVENT_FORMATS:
        raise ValueError(f"HEATMAP_EVENT_FORMAT must be one of "
                         f"{'|'.join(EVENT_FORMATS)}, got {fmt!r}")
    return fmt


def _decode_raw_values(dec, values: list[bytes], intern_p: dict,
                       intern_v: dict, fmt: str = "json"):
    """Raw event value byte-strings (JSON or binary) -> EventColumns, via
    the C++ decoder ``dec`` (a ``native.NativeDecoder``), or the Python
    codecs, their plain versions, when ``dec`` is None.  Both paths drop
    the same documents AND count them in n_dropped.  [] for no values."""
    if not values:
        return []
    if fmt == "binary":
        from heatmap_tpu_torch.stream import binfmt

        if dec is not None:
            cols, _ = dec.decode_binary(binfmt.frame_lp(values))
            return cols
        dicts, dropped = binfmt.decode_events(values)
        cols = parse_events(dicts, intern_p, intern_v)
        cols.n_dropped += dropped
        return cols
    if dec is not None:
        from heatmap_tpu_torch.native import decode_lines

        return decode_lines(dec, values)
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


class JsonlReplaySource(Source):
    """Replay a JSON-lines event capture; offset = line number.  Lines
    decode in batches through the C++ decoder (``decoder="native"``, the
    default) or per line with ``json.loads`` (``decoder="python"``, the
    plain version)."""

    def __init__(self, path: str, loop: bool = False,
                 decoder: str = "native"):
        if decoder not in ("native", "python"):
            raise ValueError(f"decoder must be native|python, got "
                             f"{decoder!r}")
        self.path = path
        self.loop = loop
        from heatmap_tpu_torch.native import NativeDecoder

        self._dec = NativeDecoder() if decoder == "native" else None
        self._fh = open(path, "rb")
        self._line = 0
        self._eof = False
        self._intern_p: dict = {}
        self._intern_v: dict = {}

    def poll(self, max_events: int):
        raw: list[bytes] = []
        wrapped = False
        while len(raw) < max_events:
            line = self._fh.readline()
            if not line:
                if self.loop and not wrapped:
                    # at most one wrap per poll, so an empty/unparseable
                    # file can't spin this loop forever
                    self._fh.seek(0)
                    self._line = 0
                    wrapped = True
                    continue
                self._eof = not self.loop
                break
            self._line += 1
            line = line.strip()
            if not line:
                continue
            raw.append(line)
        return _decode_raw_values(self._dec, raw,
                                  self._intern_p, self._intern_v)

    def offset(self):
        return self._line

    def seek(self, offset) -> None:
        self._fh.seek(0)
        for _ in range(int(offset or 0)):
            self._fh.readline()
        self._line = int(offset or 0)
        self._eof = False

    @property
    def exhausted(self) -> bool:
        return self._eof and not self.loop

    def close(self) -> None:
        self._fh.close()
        if self._dec is not None:
            self._dec.close()


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


class RampSource(Source):
    """Piecewise offered-load schedule with a REAL backlog queue.

    The governor's ramp needs a source whose staleness is honest: a
    producer emits events at a scheduled rate against the clock, and a
    consumer that falls behind receives genuinely OLD events — exactly
    the event-age signal the BatchGovernor (stream/govern.py) governs
    against.  ``poll`` returns ``min(requested, backlog)`` events whose
    timestamps are their PRODUCTION times, so event age == how long the
    engine left them queued.

    ``schedule`` is ``[(events_per_second, duration_s), ...]`` in the
    injected clock's units — tests drive it (and the runtime's lineage
    clock) with an accelerated virtual clock so second-resolution event
    timestamps resolve sub-second real dynamics.  Exhausted once the
    schedule has elapsed and the backlog drained.  Events cycle a small
    fixed vehicle/cell population (deterministic function of the event
    index), keeping state-slab occupancy flat so a governed soak can
    never trip a slab-growth retrace by itself.
    """

    def __init__(self, schedule, clock=_time.monotonic, t0: float = 0.0,
                 n_vehicles: int = 64,
                 center=(42.3601, -71.0589), radius_deg: float = 0.05):
        self.schedule = [(float(r), float(d)) for r, d in schedule]
        if not self.schedule or any(d <= 0 for _, d in self.schedule):
            raise ValueError("schedule must be non-empty (rate, "
                             "duration>0) pairs")
        self.clock = clock
        self._t0 = t0 or None      # anchored at the first poll
        self.n_vehicles = int(n_vehicles)
        rng = np.random.default_rng(7)
        self._lat = (center[0] + rng.uniform(-radius_deg, radius_deg,
                                             self.n_vehicles)
                     ).astype(np.float32)
        self._lng = (center[1] + rng.uniform(-radius_deg, radius_deg,
                                             self.n_vehicles)
                     ).astype(np.float32)
        self._speed = rng.uniform(10, 90, self.n_vehicles
                                  ).astype(np.float32)
        self._vehicles = [f"veh-{i}" for i in range(self.n_vehicles)]
        # cumulative produced-event counts / elapsed at phase starts
        self._phase_t = np.cumsum([0.0] + [d for _, d in self.schedule])
        self._phase_n = np.cumsum(
            [0.0] + [r * d for r, d in self.schedule])
        self._consumed = 0
        self._stopped = False

    def _elapsed(self) -> float:
        if self._t0 is None:
            self._t0 = self.clock()
        return max(0.0, self.clock() - self._t0)

    def _produced(self, elapsed: float) -> int:
        i = int(np.searchsorted(self._phase_t, elapsed, side="right")) - 1
        if i >= len(self.schedule):
            return int(self._phase_n[-1])
        rate, _ = self.schedule[i]
        return int(self._phase_n[i]
                   + rate * (elapsed - self._phase_t[i]))

    def _produce_times(self, i0: int, i1: int) -> np.ndarray:
        """Production clock time of events [i0, i1) — the inverse of
        the cumulative schedule, per phase."""
        idx = np.arange(i0, i1, dtype=np.float64)
        ph = np.searchsorted(self._phase_n[1:], idx, side="right")
        ph = np.minimum(ph, len(self.schedule) - 1)
        rates = np.array([r for r, _ in self.schedule])
        return (self._phase_t[ph]
                + (idx - self._phase_n[ph]) / rates[ph])

    def stop(self) -> None:
        """Give up on the remaining backlog: the source reads exhausted
        on the next poll.  The ramp bench's drain bound — a static
        config that fell 10x behind must not stretch the run by the
        whole backlog's drain time."""
        self._stopped = True

    def poll(self, max_events: int):
        if self._stopped:
            return None
        elapsed = self._elapsed()
        backlog = self._produced(elapsed) - self._consumed
        n = min(int(max_events), backlog)
        if n <= 0:
            return None
        i0, i1 = self._consumed, self._consumed + n
        t_prod = self._produce_times(i0, i1)
        idx = np.arange(i0, i1, dtype=np.int64)
        vid = (idx % self.n_vehicles).astype(np.int32)
        cols = columns_from_arrays(
            self._lat[vid], self._lng[vid], self._speed[vid],
            (self._t0 + t_prod).astype(np.int64).astype(np.int32),
            vehicle_id=vid, providers=["ramp"], vehicles=self._vehicles)
        self._consumed = i1
        return cols

    @property
    def backlog(self) -> int:
        return self._produced(self._elapsed()) - self._consumed

    def offset(self):
        return self._consumed

    def seek(self, offset) -> None:
        self._consumed = int(offset or 0)

    @property
    def exhausted(self) -> bool:
        return self._stopped or (self._elapsed() >= self._phase_t[-1]
                                 and self._consumed
                                 >= int(self._phase_n[-1]))


class KafkaSource(Source):
    """Kafka consumer source (the reference's ingress contract) over the
    port's own wire client, ``heatmap_tpu_torch.kafka``: the reference's
    wire impl, in the event format ``HEATMAP_EVENT_FORMAT`` names.

    - ``json`` and ``binary``, ``decoder="native"`` (the default, the
      reference's path whenever g++ can build its codecs): each fetch's
      records blob is framed in C++ (newline-joined JSON values, or u32
      length prefixes for binary values) and the joined values decode in
      C++ to columns, with the decoder's own persistent intern tables; a
      blob that the native framing refuses (malformed varints, a JSON
      value holding a newline) takes the Python record decoder, as the
      reference's does, and counts in ``kafka_native_fallback_blobs``.
    - ``columnar``: each record value is a whole struct-of-arrays batch
      (stream/colfmt.py), decoded with numpy views; its string table is
      parsed in C++ (``decoder="native"``) or in Python.  Values are taken
      whole, so a poll may return up to one value more than
      ``max_events``; the runtime carries the overshoot.
    - ``decoder="python"``: the plain versions, per-record ``json.loads``
      or ``binfmt.decode_events`` then ``parse_events``, and colfmt's
      Python string-table parse.

    ``values_decoded_native`` and ``values_decoded_python`` count the
    record values each path decoded.

    Starts at LATEST offsets like the reference (startingOffsets=latest);
    ``seek`` with a checkpointed {partition: offset} map overrides that on
    resume.  Round-robins partitions each poll so no partition starves
    under a small max_events.  Offsets are tracked per partition and
    committed through the runtime's checkpoint, not the broker.

    HEATMAP_KAFKA_IMPL: ``auto`` and ``wire`` take this client (the
    reference's ``auto`` prefers confluent_kafka when installed; no such
    client is ported); ``confluent`` and ``kafka-python`` raise.
    """

    # extra fetch sweeps per poll may start within this wall budget (the
    # first sweep always runs); see _poll_record_loop
    sweep_budget_s = 0.2

    def __init__(self, bootstrap: str, topic: str, decoder: str = "native"):
        impl = os.environ.get("HEATMAP_KAFKA_IMPL", "auto")
        if impl in ("confluent", "kafka-python"):
            raise NotImplementedError(
                f"HEATMAP_KAFKA_IMPL={impl!r}: only the wire client is "
                f"ported to heatmap_tpu_torch (use 'wire' or 'auto')")
        if impl not in ("auto", "wire"):
            raise ValueError(f"HEATMAP_KAFKA_IMPL must be auto|wire|"
                             f"confluent|kafka-python, got {impl!r}")
        self._fmt = event_format()
        if decoder not in ("native", "python"):
            raise ValueError(f"decoder must be native|python, got "
                             f"{decoder!r}")
        from heatmap_tpu_torch.kafka import KafkaClient
        from heatmap_tpu_torch.native import NativeDecoder

        # built before the broker is reached: a codec that cannot be
        # built raises here, never as an unreachable broker
        self._native = decoder == "native"
        self._dec = NativeDecoder() if self._native else None
        self.log = logging.getLogger(__name__)
        self.c = KafkaClient(bootstrap)
        self.topic = topic
        self._offsets: dict[int, int] = {}
        # transport-health counters: every handled fetch/discovery error
        # and retention-forced offset reset counts
        self._counters = {"kafka_fetch_errors": 0,
                          "kafka_offset_resets": 0,
                          "kafka_discover_errors": 0,
                          "kafka_native_fallback_blobs": 0,
                          "values_decoded_native": 0,
                          "values_decoded_python": 0}
        self._discover()
        self._rr = 0  # round-robin cursor
        self._intern_p: dict = {}
        self._intern_v: dict = {}
        self._col_cache: dict = {}  # colfmt LUT memo (same lifetime)
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

    def _poll_record_loop(self, max_events, handle) -> None:
        """Per-record fetch skeleton: round-robin the partitions, guarded
        fetch, advance the offset past every record (tombstones too) and
        past skipped batches when a fetch is fully consumed.
        ``handle(p, r) -> n`` consumes one non-null record and returns how
        many events it contributed toward ``max_events``."""
        if not self._offsets:
            self._discover()
        parts = sorted(self._offsets)
        if not parts:
            return
        n_out = 0
        # Sweep the partitions repeatedly until the request is filled or a
        # full sweep makes no progress: one fetch returns at most
        # ~fetch_max_bytes of records.  Only the first sweep's fetches wait
        # (max_wait_ms); follow-up sweeps use 0 so a drained topic never
        # stalls the loop, and start only within ``sweep_budget_s``, so a
        # live tail returns a partial batch instead of waiting for a
        # trickle producer to fill it.
        sweep_wait = 50
        t0 = _time.monotonic()
        while n_out < max_events:
            progressed = False
            for k in range(len(parts)):
                if n_out >= max_events:
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
                    if n_out >= max_events:
                        break
                    taken += 1
                    self._offsets[p] = r.offset + 1
                    if r.value is not None:
                        n_out += handle(p, r)
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

    def poll(self, max_events):
        if self._fmt == "columnar":
            return self._poll_colfmt(max_events)
        if self._dec is not None:
            return self._poll_native(max_events)
        return self._poll_records(max_events)

    def _poll_colfmt(self, max_events):
        """HEATMAP_EVENT_FORMAT=columnar: each record value is a whole
        struct-of-arrays batch (stream/colfmt.py); decode is numpy views,
        no per-event work.  Values are consumed whole (a poll may
        overshoot max_events by up to one value)."""
        from heatmap_tpu_torch.stream.colfmt import (concat_columns,
                                                     decode_batch)

        out = []
        counter = ("values_decoded_native" if self._native
                   else "values_decoded_python")

        def handle(p, r):
            t0 = _time.monotonic()
            cols = decode_batch(r.value, self._intern_p, self._intern_v,
                                self._col_cache, native=self._native)
            self._spans["decode"] += _time.monotonic() - t0
            self._counters[counter] += 1
            if cols is None:
                self.log.warning("dropping malformed columnar value at "
                                 "%s[%d]@%d", self.topic, p, r.offset)
                return 0
            if len(cols) or cols.n_dropped:
                out.append(cols)
            return len(cols)

        self._poll_record_loop(max_events, handle)
        if not out:
            return []
        return concat_columns(out, self._intern_p, self._intern_v)

    def _poll_records(self, max_events):
        """The plain version: per-record Python decode."""
        values: list[bytes] = []

        def handle(p, r):
            values.append(r.value)
            return 1

        self._poll_record_loop(max_events, handle)
        t0 = _time.monotonic()
        cols = _decode_raw_values(None, values, self._intern_p,
                                  self._intern_v, self._fmt)
        self._spans["decode"] += _time.monotonic() - t0
        self._counters["values_decoded_python"] += len(values)
        return cols

    def _poll_native(self, max_events):
        """One sweep of the partitions: each fetch's blob decodes to a
        joined values buffer in C++ (``KafkaClient.fetch_values``, newline
        framing for JSON, length prefixes for binary), and the joined
        buffers decode to columns in C++.  Per-record Python runs only for
        a blob that the native framing refused, whose values are re-framed
        into the same stream."""
        binary = self._fmt == "binary"
        framing = "lp" if binary else "newline"
        if not self._offsets:
            self._discover()
        parts = sorted(self._offsets)
        if not parts:
            return []
        blobs: list[bytes] = []
        n_out = n_native = n_python = pre_dropped = 0
        for k in range(len(parts)):
            if n_out >= max_events:
                break
            p = parts[(self._rr + k) % len(parts)]
            res = self._guarded_fetch(
                p, lambda p=p: self.c.fetch_values(
                    self.topic, p, self._offsets[p],
                    max_bytes=self.fetch_max_bytes, max_wait_ms=50,
                    framing=framing))
            if res is None:
                continue
            _hw, fv = res
            if fv.skipped_batches:
                self.log.warning("skipped %d undecodable batches on %s[%d]",
                                 fv.skipped_batches, self.topic, p)
            if hasattr(fv, "blob"):  # native KafkaValues
                room = max_events - n_out
                nv = len(fv)
                if nv <= room:
                    if nv:
                        blobs.append(fv.blob)
                        n_out += nv
                        n_native += nv
                    # next_offset covers every value, null and skipped batch
                    self._offsets[p] = max(self._offsets[p], fv.next_offset)
                else:
                    blobs.append(fv.blob[:int(fv.val_pos[room])])
                    # resume at the first untaken value, so nulls and
                    # skipped batches between the last taken and the first
                    # untaken value are not fetched (and warned) again
                    self._offsets[p] = int(fv.val_off[room])
                    n_out += room
                    n_native += room
                continue
            # FetchResult: the native framing refused this blob
            self._counters["kafka_native_fallback_blobs"] += 1
            taken = 0
            for r in fv.records:
                if n_out >= max_events:
                    break
                taken += 1
                self._offsets[p] = r.offset + 1
                if r.value is None:
                    continue
                n_python += 1
                if binary:
                    from heatmap_tpu_torch.stream.binfmt import frame_lp

                    blobs.append(frame_lp([r.value]))
                    n_out += 1
                    continue
                try:
                    blobs.append(
                        json.dumps(json.loads(r.value)).encode() + b"\n")
                    n_out += 1
                except (ValueError, UnicodeDecodeError):
                    pre_dropped += 1  # malformed -> dropped (ref filters)
            if taken == len(fv.records):
                self._offsets[p] = max(self._offsets[p], fv.next_offset)
        self._rr = (self._rr + 1) % max(len(parts), 1)
        self._counters["values_decoded_native"] += n_native
        self._counters["values_decoded_python"] += n_python
        if not blobs:
            if pre_dropped:
                cols = columns_from_arrays([], [], [], [])
                cols.n_dropped = pre_dropped
                return cols
            return []
        t0 = _time.monotonic()
        joined = b"".join(blobs)
        if binary:
            cols, _ = self._dec.decode_binary(joined)
        else:
            cols, _ = self._dec.decode(joined, final=True)
        self._spans["decode"] += _time.monotonic() - t0
        cols.n_dropped += pre_dropped
        return cols

    def offset(self):
        return dict(self._offsets)

    def seek(self, offset):
        if offset:
            # a committed map comes back from meta.json with string keys
            self._offsets.update({int(p): int(o) for p, o in offset.items()})

    def close(self):
        self.c.close()
        if self._dec is not None:
            self._dec.close()
