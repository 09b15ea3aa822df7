"""Fault injection for resilience tests: a copy of
``heatmap_tpu/testing/faults.py``.

Wrappers are deterministic (seeded schedules), so every chaos test is
reproducible:

- ``FlakyStore``   — delegates to a real Store, failing writes according
                     to a seeded schedule (transient by default: each
                     scheduled failure fires once, then the op succeeds on
                     retry — exactly the shape AsyncWriter's backoff must
                     absorb).
- ``BrokenStore``  — fails every write permanently (poison-path tests).
- ``CrashingSource`` — wraps a Source and raises ``InjectedCrash`` after a
                     set number of polls, simulating a hard process death
                     mid-stream; a new runtime resuming from the checkpoint
                     must reproduce the uncrashed run bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from heatmap_tpu_torch.sink.base import Store
from heatmap_tpu_torch.stream.source import Source


class InjectedCrash(RuntimeError):
    """Raised by fault injectors; never caught by framework code."""


class FlakyStore(Store):
    """Store proxy whose writes fail transiently on a seeded schedule.

    ``fail_rate`` is the probability a given write op raises; the retry
    immediately after a failure succeeds, so bounded-retry writers always
    recover (``sticky=True`` fails every write instead)."""

    def __init__(self, inner: Store, fail_rate: float = 0.3, seed: int = 0,
                 sticky: bool = False):
        self.inner = inner
        self.rng = np.random.default_rng(seed)
        self.fail_rate = fail_rate
        self.sticky = sticky
        self.injected = 0
        self._just_failed: set[str] = set()

    def _maybe_fail(self, op: str) -> None:
        if self.sticky:
            self.injected += 1
            raise IOError(f"injected sink fault: {op}")
        if op in self._just_failed:
            # transient semantics: the retry right after a failure succeeds
            # (one failure per attempt sequence keeps chaos deterministic —
            # independent draws could exhaust any bounded retry budget)
            self._just_failed.discard(op)
            return
        if self.rng.random() < self.fail_rate:
            self.injected += 1
            self._just_failed.add(op)
            raise IOError(f"injected sink fault: {op}")

    def upsert_tiles(self, docs):
        self._maybe_fail("tiles")
        return self.inner.upsert_tiles(docs)

    def upsert_positions(self, docs):
        self._maybe_fail("positions")
        return self.inner.upsert_positions(docs)

    def latest_window_start(self, grid=None):
        return self.inner.latest_window_start(grid)

    def tiles_in_window(self, window_start, grid=None):
        return self.inner.tiles_in_window(window_start, grid)

    def all_positions(self):
        return self.inner.all_positions()

    def flush(self):
        self.inner.flush()

    def close(self):
        self.inner.close()


class BrokenStore(Store):
    """Every write fails, always (exercises the poison path)."""

    def upsert_tiles(self, docs):
        raise IOError("injected: sink permanently down")

    def upsert_positions(self, docs):
        raise IOError("injected: sink permanently down")

    def latest_window_start(self, grid=None):
        return None

    def tiles_in_window(self, window_start, grid=None):
        return []

    def all_positions(self):
        return []


class CrashingSource(Source):
    """Source proxy that hard-crashes after ``crash_after_polls`` polls."""

    def __init__(self, inner: Source, crash_after_polls: int):
        self.inner = inner
        self.remaining = crash_after_polls

    def poll(self, max_events: int):
        if self.remaining <= 0:
            raise InjectedCrash("injected source crash")
        self.remaining -= 1
        return self.inner.poll(max_events)

    def offset(self):
        return self.inner.offset()

    def seek(self, offset) -> None:
        self.inner.seek(offset)

    @property
    def exhausted(self) -> bool:
        return self.inner.exhausted

    def close(self) -> None:
        self.inner.close()
