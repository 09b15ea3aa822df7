"""Kafka ingest in a separate OS process over shared memory
(``HEATMAP_FEEDER=proc``).

A copy of ``heatmap_tpu/stream/shmfeed.py``.  A FEEDER process owns the
wire fetch and the decode (the port's ``KafkaSource``, native codecs, in
whatever ``HEATMAP_EVENT_FORMAT`` names) and hands finished
``EventColumns`` batches to the runtime through a SharedMemory slot ring,
so the runtime's step thread never shares an interpreter lock with socket
reads and record decoding.

Protocol
--------
* a SharedMemory block holds ``slots`` fixed-capacity columnar slabs
  (8 f32/i32 lanes x ``cap`` rows, the EventColumns array fields);
* ``full_q`` carries (slot, n, gen, final, offsets, prov_delta,
  veh_delta, n_dropped, counters, spans) metas feeder -> runtime;
  ``free_q`` returns slot ids.  A poll that overshoots the slot capacity
  (the wire source consumes whole columnar records) spans MULTIPLE slots:
  only the last carries ``final=True`` and the post-poll offset, and the
  runtime side reassembles them into one logical batch, so a checkpointed
  offset can never advance past rows still sitting in the ring;
* provider/vehicle intern tables are synchronized by DELTA: the feeder
  sends only newly-interned names, both sides append in order, so the id
  arrays index identical tables;
* ``seek`` bumps a generation counter: the feeder re-seeks its
  KafkaSource and stamps subsequent metas with the new generation; stale
  in-flight metas are discarded (slots recycled) on arrival;
* a feeder that fails sends ("error", traceback) before it exits, and the
  runtime side raises it from ``poll``; a feeder that dies without a word
  is found dead by ``poll``, which raises too.

Start-up does not wait for the child's interpreter: the constructor pins
the topic's LATEST offsets with a consumer of its own (the construction
contract of ``KafkaSource``: a producer may publish as soon as it
returns) and spawns the child, which attaches and then waits for a
("start", offsets) command, sent by the first ``poll``: a ``seek`` before
it (a resume) only moves those offsets, so the feeder's first fetch is at
the resumed position with its partition cursor where a fresh in-process
source's would be.  The child is spawned, before the caller builds its
runtime (never forked from a process that may hold a CUDA context), and
imports no ``torch``: only this module, the wire client and the native
codecs (``tests/test_torch_shmfeed.py`` pins its imports).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import queue as queue_mod
import time
import traceback
from multiprocessing import shared_memory
from typing import Any

import numpy as np

from heatmap_tpu_torch.stream.events import EventColumns, empty_columns
from heatmap_tpu_torch.stream.source import KafkaSource, Source

log = logging.getLogger(__name__)

# lane name -> dtype; fixed order defines the shm layout
_LANES = (
    ("lat_rad", np.float32), ("lng_rad", np.float32),
    ("lat_deg", np.float32), ("lng_deg", np.float32),
    ("speed_kmh", np.float32), ("ts_s", np.int32),
    ("provider_id", np.int32), ("vehicle_id", np.int32),
)
_IDLE_SLEEP_S = 0.01


def _slot_views(buf, slots: int, cap: int):
    """Per-slot dict of lane views into the shared buffer."""
    out = []
    lane_bytes = cap * 4
    slot_bytes = lane_bytes * len(_LANES)
    for s in range(slots):
        views = {}
        off = s * slot_bytes
        for name, dt in _LANES:
            views[name] = np.frombuffer(buf, dtype=dt, count=cap,
                                        offset=off)
            off += lane_bytes
        out.append(views)
    return out


def _feeder_main(shm_name: str, slots: int, cap: int, bootstrap: str,
                 topic: str, full_q, free_q, cmd_q) -> None:
    """Child entry: attach the shm, run the loop in its own frame (so
    every numpy view into the mmap is freed before close), detach.  An
    error reaches the runtime side as an ("error", traceback) meta."""
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        _feeder_loop(shm, slots, cap, bootstrap, topic, full_q, free_q,
                     cmd_q)
    except BaseException:
        full_q.put(("error", traceback.format_exc()))
        raise
    finally:
        shm.close()


def _feeder_loop(shm, slots: int, cap: int, bootstrap: str, topic: str,
                 full_q, free_q, cmd_q) -> None:
    src = KafkaSource(bootstrap, topic)
    try:
        cmd = cmd_q.get()  # ("start", offsets) from the first poll, or stop
        if cmd[0] == "stop":
            return
        src.seek(cmd[1])
        views = _slot_views(shm.buf, slots, cap)
        gen = 0
        sent_p = sent_v = 0
        while True:
            # commands take priority (seek must not race new fills)
            try:
                cmd = cmd_q.get_nowait()
            except queue_mod.Empty:
                cmd = None
            if cmd is not None:
                if cmd[0] == "stop":
                    break
                if cmd[0] == "seek":
                    _g, off = cmd[1], cmd[2]
                    src.seek(off)
                    gen = _g
                    continue
            try:
                slot = free_q.get(timeout=0.25)
            except queue_mod.Empty:
                continue
            cols = src.poll(cap)
            n = len(cols) if cols is not None else 0
            if n == 0:
                free_q.put(slot)
                # an EMPTY meta keeps the runtime's poll from blocking a
                # full timeout when the topic is simply drained, but only
                # when none is pending, or a slow-polling runtime would
                # accumulate stale metas without bound; a poll whose rows
                # were all rejected always reports, or its drops are lost
                dropped = getattr(cols, "n_dropped", 0)
                if dropped or full_q.empty():
                    full_q.put((None, 0, gen, True, src.offset(), [], [],
                                dropped, src.counters, src.take_spans()))
                time.sleep(_IDLE_SLEEP_S)
                continue
            # intern-table deltas: cols carries the source's GLOBAL
            # tables; send only what the runtime has not seen
            pd = cols.providers[sent_p:]
            vd = cols.vehicles[sent_v:]
            sent_p, sent_v = len(cols.providers), len(cols.vehicles)
            off = src.offset()
            # the wire source consumes whole records and may overshoot
            # cap: span slots, final flag + offset on the LAST slice
            start = 0
            while start < n:
                if start > 0:
                    slot = free_q.get()  # blocking: the batch must land
                take = min(cap, n - start)
                v = views[slot]
                for name, _dt in _LANES:
                    v[name][:take] = getattr(cols, name)[start:start + take]
                final = start + take >= n
                full_q.put((slot, take, gen, final, off,
                            pd if final else [], vd if final else [],
                            cols.n_dropped if final else 0,
                            src.counters if final else None,
                            src.take_spans() if final else {}))
                start += take
    finally:
        src.close()


class ShmFeederSource(Source):
    """A ``KafkaSource`` running in its own OS process, delivering decoded
    columnar batches through shared memory (see the module docstring).
    ``counters`` are the feeder's ``KafkaSource`` counters as of its last
    delivered batch; ``take_spans`` reports the step thread's ``wait`` on
    the feeder and ``copy`` out of the ring, beside the feeder's own
    ``fetch`` and ``decode`` (spent in the other process)."""

    def __init__(self, bootstrap: str, topic: str, batch_size: int,
                 slots: int = 4):
        self.cap = int(batch_size)
        self.slots = int(slots)
        # the topic's LATEST offsets, pinned before the child exists: the
        # child starts there however long its interpreter takes to start,
        # and a broker or codec that cannot start raises here
        probe = KafkaSource(bootstrap, topic)
        try:
            start = probe.offset()
        finally:
            probe.close()
        nbytes = self.slots * self.cap * 4 * len(_LANES)
        self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
        self._views = _slot_views(self._shm.buf, self.slots, self.cap)
        ctx = mp.get_context("spawn")
        self._full_q = ctx.Queue()
        self._free_q = ctx.Queue()
        self._cmd_q = ctx.Queue()
        for s in range(self.slots):
            self._free_q.put(s)
        self._proc = ctx.Process(
            target=_feeder_main,
            args=(self._shm.name, self.slots, self.cap, bootstrap, topic,
                  self._full_q, self._free_q, self._cmd_q),
            name="heatmap-feeder", daemon=True)
        self._proc.start()
        self._gen = 0
        self._started = False  # the child waits for the first poll
        self._offset: Any = start
        self._providers: list[str] = []
        self._vehicles: list[str] = []
        self._counters: dict = {}
        self.n_dropped_total = 0
        self._spans = {"wait": 0.0, "copy": 0.0}

    @property
    def counters(self) -> dict:
        return dict(self._counters)

    def take_spans(self):
        out = {k: v for k, v in self._spans.items() if v > 0.0}
        self._spans = {"wait": 0.0, "copy": 0.0}
        return out

    def _book_child_spans(self, spans: dict) -> None:
        for k, v in spans.items():
            self._spans[k] = self._spans.get(k, 0.0) + v

    def _check_alive(self) -> None:
        if self._proc.is_alive():
            return
        try:  # its last word may have landed after the wait timed out
            meta = self._full_q.get(timeout=0.1)
        except queue_mod.Empty:
            meta = None
        if meta is not None and meta[0] == "error":
            raise RuntimeError(f"shm feeder process failed:\n{meta[1]}")
        raise RuntimeError(
            f"shm feeder process exited (code {self._proc.exitcode}) "
            f"without reporting an error")

    # ------------------------------------------------------------- source
    def poll(self, max_events: int):
        """Like KafkaSource's columnar behaviour, a poll may return MORE
        than ``max_events``: the feeder consumes whole records, and an
        oversize poll arrives as a multi-slot spanning batch reassembled
        here (offset stamped only on the final slice).  The runtime
        carries the rows past its batch and commits no offset mid-carry,
        so offsets never advance past undelivered rows."""
        if not self._started:
            self._cmd_q.put(("start", self._offset))
            self._started = True
        deadline = time.monotonic() + 1.0
        parts: list[dict] = []
        while True:
            timeout = max(0.05, deadline - time.monotonic())
            t_wait = time.monotonic()
            try:
                meta = self._full_q.get(timeout=timeout)
                self._spans["wait"] += time.monotonic() - t_wait
            except queue_mod.Empty:
                self._spans["wait"] += time.monotonic() - t_wait
                self._check_alive()
                if parts:  # mid-assembly: the final slice is coming
                    deadline = time.monotonic() + 1.0
                    continue
                return empty_columns(self._providers, self._vehicles)
            if meta[0] == "error":
                raise RuntimeError(f"shm feeder process failed:\n{meta[1]}")
            (slot, n, gen, final, off, pd, vd, dropped, counters,
             spans) = meta
            # intern deltas are generation-INDEPENDENT (append-only, and
            # the feeder never resends them): a stale post-seek meta must
            # still contribute its names or later ids point past the
            # runtime-side tables
            self._providers.extend(pd)
            self._vehicles.extend(vd)
            if counters is not None:
                self._counters = counters
            self._book_child_spans(spans)
            if gen != self._gen:
                if slot is not None:
                    self._free_q.put(slot)  # pre-seek leftover
                parts = []  # any assembly in flight was pre-seek too
                continue
            if slot is None:
                if parts:
                    continue  # stray empty meta between slices
                self._offset = off
                cols = empty_columns(self._providers, self._vehicles)
                cols.n_dropped = dropped
                self.n_dropped_total += dropped
                return cols
            t_copy = time.monotonic()
            v = self._views[slot]
            parts.append({name: v[name][:n].copy()
                          for name, _dt in _LANES})
            self._free_q.put(slot)
            self._spans["copy"] += time.monotonic() - t_copy
            if not final:
                continue
            self._offset = off
            self.n_dropped_total += dropped
            t_copy = time.monotonic()
            if len(parts) == 1:
                lanes = parts[0]
            else:
                lanes = {name: np.concatenate([p[name] for p in parts])
                         for name, _dt in _LANES}
            self._spans["copy"] += time.monotonic() - t_copy
            return EventColumns(**lanes, providers=self._providers,
                                vehicles=self._vehicles,
                                n_dropped=dropped)

    def offset(self):
        return self._offset

    def seek(self, offset) -> None:
        self._offset = offset
        if self._started:
            self._gen += 1
            self._cmd_q.put(("seek", self._gen, offset))

    def close(self) -> None:
        if self._proc.is_alive():
            self._cmd_q.put(("stop",))
            # drain the metas while the child winds down (a child blocked
            # on a full pipe, or on a slot, could not exit), handing the
            # slots back
            deadline = time.monotonic() + 5.0
            while self._proc.is_alive() and time.monotonic() < deadline:
                try:
                    meta = self._full_q.get(timeout=0.05)
                except queue_mod.Empty:
                    continue
                if meta[0] not in ("error", None):
                    self._free_q.put(meta[0])
            if self._proc.is_alive():  # wedged on a dead broker socket
                self._proc.terminate()
            self._proc.join(timeout=5)
        self._views = None  # release exported pointers into the mmap
        for q in (self._full_q, self._free_q, self._cmd_q):
            q.close()
            q.join_thread()
        if self._shm is not None:
            self._shm.close()
            self._shm.unlink()
            self._shm = None
