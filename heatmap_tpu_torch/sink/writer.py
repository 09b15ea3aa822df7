"""AsyncWriter — background sink thread overlapping store I/O with compute.

A copy of ``heatmap_tpu/sink/writer.py`` without its audit hooks (the
integrity observatory is ROADMAP A6c).  With ``metrics=`` (the runtime's
``stream.metrics.Metrics``) it registers the reference's families: the
queue depth, the retries counter and the poisoned gauge.  The materialized
tile view (``view=``) is fed on this thread right after each tile write,
and ``last_view_seq`` records the view's seq after each apply, which the
runtime's lineage stamps as the batch's ``view_apply``.

The device step for batch N+1 runs while batch N's docs are upserted; the
runtime's checkpoint commit waits on ``drain()`` so offsets only advance
past durably-written batches.

Transient sink failures are retried with backoff before the writer poisons
(the reference's producer survives API hiccups the same way); every store
write is an idempotent upsert, so a retry after a half-applied bulk is
safe.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Sequence

from heatmap_tpu_torch.sink.base import Store

log = logging.getLogger(__name__)


class AsyncWriter:
    def __init__(self, store: Store, max_queue: int = 64,
                 retries: int = 3, backoff_s: float = 0.2, metrics=None,
                 view=None):
        self.store = store
        # materialized tile view (query.matview): fed on THIS thread
        # right after each tile write returns from the store — i.e.
        # strictly after the rows are durable, so the query tier never
        # exposes a tile a Store read-back couldn't return.  A view
        # apply failure poisons the VIEW only (serving falls back to
        # Store renders); read-path trouble never takes the pipeline
        # down.
        self.view = view
        # view seq recorded right after each successful apply, read by
        # the runtime's lineage view_applied stamp: the batch whose
        # commit-ack mark runs next is visible in the view at this seq.
        # Written only on the writer thread; torn reads are impossible
        # (int store).
        self.last_view_seq: int | None = None
        self.retries = retries
        self.backoff_s = backoff_s
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._exc: BaseException | None = None
        self._written_tiles = 0
        self._written_positions = 0
        self._retried = 0
        # wall spent BLOCKED on a full queue at submit time: the emit ring
        # hands the writer up to K batches of packed bodies in one flush,
        # and a store that cannot absorb the burst stalls the step thread
        # here
        self._backpressure_s = 0.0
        self._c_retries = self._g_poisoned = None
        if metrics is not None:
            # the queue depth read at scrape time; retries and the poison
            # live in the registry so /metrics shows sink trouble
            metrics.gauge("heatmap_sink_queue_depth",
                          "pending write batches in the async sink queue",
                          fn=self._q.qsize)
            self._c_retries = metrics.registry.counter(
                "heatmap_sink_retries_total",
                "sink write attempts that failed and were retried")
            self._g_poisoned = metrics.gauge(
                "heatmap_sink_poisoned",
                "1 once a sink write exhausted its retries (writer "
                "permanently failed; offsets can no longer advance)")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sink-writer")
        self._thread.start()

    def _apply(self, kind: str, docs) -> int:
        """One write with bounded retry (idempotent upserts → safe)."""
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                if kind == "tiles":
                    return self.store.upsert_tiles(docs)
                if kind == "tiles_packed":
                    body, meta = docs
                    return self.store.upsert_tiles_packed(body, meta)
                if kind == "positions_packed":
                    return self.store.upsert_positions_packed(docs)
                return self.store.upsert_positions(docs)
            except Exception:
                if attempt == self.retries:
                    raise
                self._retried += 1
                if self._c_retries is not None:
                    self._c_retries.inc()
                log.warning("sink write failed (attempt %d/%d); retrying "
                            "in %.1fs", attempt + 1, self.retries, delay,
                            exc_info=True)
                time.sleep(delay)
                delay *= 4
        raise AssertionError("unreachable")

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                kind, docs = item
                if kind == "mark":
                    # barrier (submit_mark): every write submitted before
                    # it has been applied by now.  A broken callback does
                    # not poison the writer, and a poisoned writer runs no
                    # marks: its writes were dropped
                    if self._exc is None:
                        try:
                            docs()
                        except Exception:
                            log.exception("sink commit-mark callback "
                                          "failed")
                elif self._exc is None:
                    n = self._apply(kind, docs)
                    if kind.startswith("tiles"):
                        self._written_tiles += n
                        if n and self.view is not None \
                                and not self.view.poisoned:
                            self._feed_view(kind, docs)
                    else:
                        self._written_positions += n
            except BaseException as e:  # poisons the writer permanently
                log.exception("sink write failed after %d retries",
                              self.retries)
                self._exc = e
                if self._g_poisoned is not None:
                    self._g_poisoned.set(1)
            finally:
                self._q.task_done()

    def _feed_view(self, kind: str, docs) -> None:
        try:
            if kind == "tiles_packed":
                # decoded once, here, with the same oracle the portable
                # store write path uses, so view content is exactly what
                # a Store read-back would return
                from heatmap_tpu_torch.sink.base import packed_tile_docs

                body, meta = docs
                docs = packed_tile_docs(body, meta)
            self.view.apply_docs(docs)
            self.last_view_seq = getattr(self.view, "seq", None)
        except Exception:
            log.exception("materialized view apply failed; query tier "
                          "falls back to store renders")
            self.view.poison()

    @property
    def poisoned(self) -> bool:
        return self._exc is not None

    def _check(self) -> None:
        # sticky: once a write is lost the writer stays failed, so a later
        # checkpoint can never commit offsets past the dropped batch
        if self._exc is not None:
            raise RuntimeError("async sink write failed") from self._exc

    def _put(self, item) -> None:
        """Enqueue, booking any time spent blocked on a full queue."""
        try:
            self._q.put_nowait(item)
            return
        except queue.Full:
            pass
        t0 = time.monotonic()
        self._q.put(item)
        self._backpressure_s += time.monotonic() - t0

    def submit_tiles(self, docs: Sequence[dict]) -> None:
        self._check()
        if docs:
            self._put(("tiles", docs))

    def submit_tiles_packed(self, body, meta) -> None:
        """Packed emit body rows + TilePackMeta; the store-side encode
        (C++ on the Mongo wire backend) runs on this writer thread,
        overlapping the next batch's device step."""
        self._check()
        self._put(("tiles_packed", (body, meta)))

    def submit_positions_packed(self, rows) -> None:
        """Columnar changed-vehicle rows (sink.base.PositionRows)."""
        self._check()
        if len(rows.ts_ms):
            self._put(("positions_packed", rows))

    def submit_positions(self, docs: Sequence[dict]) -> None:
        self._check()
        if docs:
            self._put(("positions", docs))

    def submit_mark(self, fn) -> None:
        """Run ``fn`` on the writer thread once every previously
        submitted write has been applied."""
        self._check()
        self._put(("mark", fn))

    def drain(self) -> None:
        """Block until every submitted write has been applied."""
        self._q.join()
        self._check()
        self.store.flush()

    def close(self) -> None:
        if not self.poisoned:
            self.drain()
        self._q.put(None)
        self._thread.join(timeout=10)
        self._check()

    @property
    def counters(self) -> dict:
        return {"tiles_written": self._written_tiles,
                "positions_written": self._written_positions,
                "sink_retries": self._retried,
                "sink_backpressure_ms": int(self._backpressure_s * 1e3)}
