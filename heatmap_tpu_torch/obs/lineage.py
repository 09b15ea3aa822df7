"""Per-batch freshness lineage: event time -> sink-commit ack, staged.

A copy of ``heatmap_tpu/obs/lineage.py``.  One record (a plain JSON-
friendly dict) is opened per polled batch and stamped at every stage
boundary with one shared clock, so the decomposition telescopes exactly:

    event ts --poll_wait--> poll --prefetch_queue--> dispatch
      --fold--> ring-enter --ring--> flush/pull --sink_commit--> ack

    age(mean event ts -> ack) == poll_wait + prefetch_queue + fold
                                 + ring + sink_commit      (exactly)

The tracker keeps a bounded tail of closed (sink-acked) records for
``/debug/freshness`` and the flight recorder, and the newest committed
event timestamp the serve tier samples into the ingest->serve freshness
gauge.  The clock is injectable, so tests drive it.

Stamping is lock-free on the record itself: each stage has one owner (the
step thread through the flush, the writer thread for the commit ack) and
the writer queue is the happens-before edge between them.  Only the tail
append and the newest-committed watermark take the tracker lock.
"""

from __future__ import annotations

import collections
import threading
import time

# Stage keys, in pipeline order (the decomposition /debug/freshness and
# the conservation test enumerate).  view_apply is the cross-process
# extension stage: time from the sink-commit ack until the batch is
# visible in a materialized tile view — stamped by the process that
# applies the view (the writer-fed view in-process today; a replicated
# serve worker in the scale-out shape), and stitched into the fleet
# decomposition by lineage id (obs.fleet).  Records without a view
# stay 5-stage; conservation holds over whichever stages exist.
STAGES = ("poll_wait", "prefetch_queue", "fold", "ring", "sink_commit",
          "view_apply")


def json_safe(obj):
    """Best-effort conversion to JSON-serializable types: numpy scalars
    via ``.item()``, containers recursively, anything else via repr.
    Lineage records carry source offsets (arbitrary per-source objects)
    and must stay dump-able for /debug/freshness and flightrec."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    item = getattr(obj, "item", None)
    if item is not None and getattr(obj, "shape", None) == ():
        try:
            return item()  # numpy scalar
        except Exception:  # noqa: BLE001 - fall through to repr
            pass
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return repr(obj)


class LineageTracker:
    """Opens, stamps, and retains per-batch freshness lineage records."""

    def __init__(self, capacity: int = 256, clock=time.time,
                 origin: str = "local"):
        self.clock = clock
        # the lineage-id namespace: records are stamped
        # ``lid="<origin>-<seq>"`` so contributions from DIFFERENT
        # processes (a runtime shard's fold stages, a serve worker's
        # view-apply stage) stitch back together in the fleet
        # aggregator.  The runtime passes its fleet tag; "local" keeps
        # standalone trackers unique-enough within one process.
        self.origin = str(origin)
        self._lock = threading.Lock()
        self._seq = 0
        self._tail: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._newest_committed_ts: float | None = None

    # ------------------------------------------------------------ stages
    def open(self, *, n_events: int, ev_min_ts: int, ev_max_ts: int,
             ev_mean_ts: float, offset=None,
             t_poll: float | None = None) -> dict:
        """Create a record at poll time (t_poll = now).  ``t_poll``
        overrides the stamp for rows fetched by an EARLIER poll — a
        carry-drained overshoot tail must bill its wait since that poll
        as queue time, not hide it inside poll_wait."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        return {
            "seq": seq,
            "lid": f"{self.origin}-{seq}",  # cross-process stitch key
            "epoch": None,              # stamped at dispatch
            "n_events": int(n_events),
            "ev_min_ts": int(ev_min_ts),
            "ev_max_ts": int(ev_max_ts),
            "ev_mean_ts": float(ev_mean_ts),
            "offset": json_safe(offset),
            "t_poll": self.clock() if t_poll is None else float(t_poll),
        }

    def dispatched(self, rec: dict, epoch: int) -> None:
        """The batch left the prefetch queue and entered the fold."""
        rec["epoch"] = int(epoch)
        rec["t_dispatch"] = self.clock()

    def ring_entered(self, rec: dict) -> None:
        """The fold dispatched; its packed emits parked in the EmitRing."""
        rec["t_ring"] = self.clock()

    def flushed(self, rec: dict, ring_batches: int | None = None) -> None:
        """The flush covering this batch pulled it off the device."""
        rec["t_flush"] = self.clock()
        if ring_batches is not None:
            rec["ring_batches"] = int(ring_batches)

    def committed(self, rec: dict) -> dict:
        """Sink-commit ack: close the record — derive the per-stage
        decomposition and event ages, append to the tail, and advance
        the newest-committed event-time watermark.  Returns ``rec``."""
        t_sink = rec["t_sink"] = self.clock()
        rec["stages"] = {
            "poll_wait": rec["t_poll"] - rec["ev_mean_ts"],
            "prefetch_queue": rec["t_dispatch"] - rec["t_poll"],
            "fold": rec["t_ring"] - rec["t_dispatch"],
            "ring": rec["t_flush"] - rec["t_ring"],
            "sink_commit": t_sink - rec["t_flush"],
        }
        rec["age_s"] = {
            # ages keyed by which event of the batch they describe: the
            # oldest event (min ts) has aged the most by ack time
            "oldest": t_sink - rec["ev_min_ts"],
            "mean": t_sink - rec["ev_mean_ts"],
            "newest": t_sink - rec["ev_max_ts"],
        }
        with self._lock:
            self._tail.append(rec)
            if (self._newest_committed_ts is None
                    or rec["ev_max_ts"] > self._newest_committed_ts):
                self._newest_committed_ts = rec["ev_max_ts"]
        return rec

    def view_applied(self, rec: dict, view_seq=None) -> dict:
        """The materialized view covering this batch is applied: stamp
        the ``view_apply`` stage (ack → view-visible) and the visible
        age.  In the writer-fed view the apply completes before the ack
        returns, so in-process this stage measures ~0 — its value is
        the FORMAT: a replicated serve worker (ROADMAP item 1) stamps
        its own view_applied on delta arrival, and the fleet stitch
        (obs.fleet) merges it under the same lineage id.  Called on the
        writer thread after :meth:`committed`; mutations run under the
        tracker lock because the record is already in the tail."""
        with self._lock:
            t_view = rec["t_view"] = self.clock()
            if "stages" in rec:
                rec["stages"]["view_apply"] = t_view - rec["t_sink"]
                rec["age_s"]["visible"] = t_view - rec["ev_mean_ts"]
            if view_seq is not None:
                rec["view_seq"] = int(view_seq)
        return rec

    # ------------------------------------------------------------ reads
    @property
    def newest_committed_ts(self) -> float | None:
        """Max event timestamp across sink-acked batches — what the
        ingest→serve freshness gauge subtracts from render wall time."""
        with self._lock:
            return self._newest_committed_ts

    def newest_event_age_s(self, now: float | None = None) -> float:
        """Age of the newest sink-acked event right now — the
        ``event_age`` leg the delivery lineage (obs.delivery) seeds its
        telescoping decomposition with.  O(1): one watermark read, no
        tail scan.  0.0 before any commit (the leg is simply absent,
        not negative)."""
        with self._lock:
            ts = self._newest_committed_ts
        if ts is None:
            return 0.0
        t = self.clock() if now is None else float(now)
        return max(0.0, t - ts)

    def tail(self, n: int = 50) -> list:
        """Newest-first closed records.  Copies are taken UNDER the
        tracker lock, and the nested ``stages``/``age_s`` dicts are
        copied too: :meth:`view_applied` mutates records already in the
        tail (under the same lock), so a shallow copy handed out here
        would share dicts a writer-thread callback is still inserting
        into — and callers serialize these outside any lock."""
        out = []
        with self._lock:
            for r in list(self._tail)[::-1][: max(0, int(n))]:
                c = dict(r)
                for k in ("stages", "age_s"):
                    if k in c:
                        c[k] = dict(c[k])
                out.append(c)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._tail)
