"""Delivery observatory — conservation-exact read-path lineage.

A copy of ``heatmap_tpu/obs/delivery.py``.  The freshness lineage
(obs.lineage) telescopes event age from poll to sink ack ON THE WRITER;
this module extends the same discipline across the read tier, so
"delivered freshness" — the age of the newest event a subscriber's
socket has actually received — decomposes exactly:

    delivered_age == event_age + publish_queue + feed_transit
                     + replica_apply + fanout_queue + socket_write

Stamp points (one stamp per boundary, stages are adjacent differences,
so the identity telescopes with residual exactly 0 by construction —
the synthetic-clock cross-process tests pin that no leg is lost,
double-counted, or rounded):

- ``event_age``      age already accumulated when the writer's view
                     hook enqueued the mutation (the freshness
                     lineage's newest committed batch age; 0 when
                     unknown);
- ``publish_queue``  hook enqueue → segment-log publish (writer clock);
- ``feed_transit``   publish → follower receipt of the record batch.
                     THE CROSS-HOST LEG: a writer-wall vs replica-wall
                     difference, reported separately (the skew
                     discipline of the replication tier) and never
                     folded into a same-clock percentile — with skewed
                     clocks it absorbs the skew and may even go
                     negative;
- ``replica_apply``  receipt → ``replica_apply`` returned (local);
- ``fanout_queue``   apply → the subscriber generator began the socket
                     write of a frame carrying that seq (local; the
                     per-channel encode stamp rides the sample for
                     diagnosis but is not its own stage);
- ``socket_write``   write begin → the blocking WSGI write returned
                     (local).

The writer-side feed stamp is knob-gated (``HEATMAP_DELIVERY=1``):
with the knob off the feed records are byte-identical to an
uninstrumented build, and no frame is ever tagged.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from heatmap_tpu_torch.obs.registry import DEFAULT_LAG_BUCKETS

#: stage order of the telescoping decomposition (worst-stage reporting,
#: /debug/delivery payloads, obs_top rows)
DELIVERY_STAGES = ("event_age", "publish_queue", "feed_transit",
                   "replica_apply", "fanout_queue", "socket_write")

#: legs whose endpoints live on DIFFERENT hosts' wall clocks — reported
#: separately, never mixed into a same-clock sum (the skew discipline)
CROSS_HOST_STAGES = ("feed_transit",)

ENV_DELIVERY = "HEATMAP_DELIVERY"
ENV_SLO_DELIVERED_P50_MS = "HEATMAP_SLO_DELIVERED_P50_MS"


def delivery_enabled(env=None) -> bool:
    """The writer-side publish-stamp knob (``HEATMAP_DELIVERY=1``)."""
    e = os.environ if env is None else env
    return str(e.get(ENV_DELIVERY, "")).strip().lower() in (
        "1", "true", "yes", "on")


def _q(sorted_vals: list, q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]


class DeliveryTracker:
    """Per-replica delivery-lineage state: upstream stamps keyed by
    view seq (installed by the follower as records apply), completed
    end-to-end samples (installed by the SSE subscriber generators as
    socket writes return), and the ``heatmap_delivered_age_seconds``
    histogram per measurement bound.

    One shared injectable ``clock`` stamps every local boundary, so the
    decomposition telescopes exactly — the same conservation rule as
    obs.lineage."""

    def __init__(self, capacity: int = 512, clock=time.time,
                 registry=None):
        self.clock = clock
        self._lock = threading.Lock()
        self._cap = max(16, int(capacity))
        self._recs: collections.OrderedDict = collections.OrderedDict()
        self._samples: collections.deque = collections.deque(
            maxlen=self._cap)
        # newest upstream stamps, for the stalled-feed view: when the
        # writer goes quiet the NEXT record's transit keeps growing
        # even though no completed sample moves
        self._last_pub: float | None = None
        self._last_rx: float | None = None
        self._h_age = self._g_stage = None
        if registry is not None:
            self._h_age = registry.histogram(
                "heatmap_delivered_age_seconds",
                "age of the newest event a read-path consumer has "
                "received, per measurement bound: apply (replica view "
                "updated), encode (SSE frame encoded once per channel)"
                ", socket (a subscriber's blocking socket write "
                "returned) — the delivered-freshness decomposition "
                "behind /debug/delivery",
                labels=("bound",), buckets=DEFAULT_LAG_BUCKETS)
            self._g_stage = registry.gauge(
                "heatmap_delivery_stage_seconds",
                "recent mean of each delivery-lineage stage "
                "(event_age/publish_queue/feed_transit/replica_apply/"
                "fanout_queue/socket_write); feed_transit is the "
                "cross-host leg and is reported on its own clock pair",
                labels=("stage",))

    # ------------------------------------------------- follower side
    def record_applied(self, seq: int, pt, rx: float,
                       ap: float) -> None:
        """Install one applied record's upstream stamps.  ``pt`` is the
        feed record's knob-gated writer-clock stamp ``[eq, pub, ea]``
        (hook-enqueue time, publish time, event age at enqueue); ``rx``
        / ``ap`` are this process's receipt-of-batch and apply-returned
        stamps from the shared tracker clock."""
        if (not isinstance(pt, (list, tuple)) or len(pt) != 3
                or not all(isinstance(v, (int, float)) for v in pt)):
            return
        eq, pub, ea = float(pt[0]), float(pt[1]), float(pt[2])
        rec = {"seq": int(seq), "eq": eq, "pub": pub, "ea": ea,
               "rx": float(rx), "ap": float(ap)}
        with self._lock:
            self._recs[int(seq)] = rec
            while len(self._recs) > self._cap:
                self._recs.popitem(last=False)
            self._last_pub = pub
            self._last_rx = float(rx)
        if self._h_age is not None:
            age = (ea + (pub - eq) + (rx - pub) + (ap - rx))
            self._h_age.labels(bound="apply").observe(max(0.0, age))

    def _lookup(self, seq: int) -> dict | None:
        """The record that advanced the view to ``seq`` — or, when
        frames coalesce several seqs, the newest stamped record at or
        below it (the frame's newest content is what ages)."""
        rec = self._recs.get(int(seq))
        if rec is not None:
            return rec
        best = None
        for s, r in self._recs.items():
            if s <= seq and (best is None or s > best["seq"]):
                best = r
        return best

    # ---------------------------------------------------- serve side
    def encoded(self, seq: int) -> dict | None:
        """One per-channel encode stamp for the frame at view ``seq``;
        returns the frame's sidecar meta (ridden to each subscriber via
        ``Channel.broadcast(frame, meta=...)``) or None when no
        upstream stamps cover the seq — then the frame is broadcast
        plain and stays byte-identical to an uninstrumented run."""
        with self._lock:
            rec = self._lookup(int(seq))
            if rec is None:
                return None
            rec = dict(rec)
        enc = self.clock()
        if self._h_age is not None:
            age = (rec["ea"] + (rec["pub"] - rec["eq"])
                   + (rec["rx"] - rec["pub"]) + (enc - rec["rx"]))
            self._h_age.labels(bound="encode").observe(max(0.0, age))
        return {"rec": rec, "enc": enc}

    def delivered(self, meta: dict, wb: float, we: float) -> None:
        """Complete one subscriber's end-to-end sample: ``wb``/``we``
        bracket the tagged frame's socket write.  Both serve cores
        call this with the same contract — the thread core around the
        blocking ``send()`` in its subscriber generator, the epoll
        core from ``wb`` = the loop staging the frame to ``we`` = the
        loop completing the (possibly multi-``send``, offset-resumed)
        drain — so fanout_queue + socket_write still telescope and
        the residual stays identically 0 on either core."""
        rec = meta.get("rec")
        if not isinstance(rec, dict):
            return
        stages = {
            "event_age": rec["ea"],
            "publish_queue": rec["pub"] - rec["eq"],
            "feed_transit": rec["rx"] - rec["pub"],
            "replica_apply": rec["ap"] - rec["rx"],
            "fanout_queue": wb - rec["ap"],
            "socket_write": we - wb,
        }
        # the independent end-to-end recomputation, grouped by clock
        # domain (writer leg + cross leg + local leg from FIRST and
        # LAST stamps only): residual != 0 would mean a leg was lost
        # or double-counted, exactly like the lineage's invariant
        age = (rec["ea"] + (rec["pub"] - rec["eq"])
               + (rec["rx"] - rec["pub"]) + (we - rec["rx"]))
        sample = {
            "seq": rec["seq"],
            "stages": stages,
            "age_s": age,
            "residual_s": age - sum(stages.values()),
            "enc": meta.get("enc"),
            "t": we,
        }
        with self._lock:
            self._samples.append(sample)
        if self._h_age is not None:
            self._h_age.labels(bound="socket").observe(max(0.0, age))
        if self._g_stage is not None:
            with self._lock:
                tail = list(self._samples)[-64:]
            for st in DELIVERY_STAGES:
                vals = [s["stages"][st] for s in tail]
                if vals:
                    self._g_stage.labels(stage=st).set(
                        round(sum(vals) / len(vals), 6))

    # ------------------------------------------------------ surfaces
    def summary(self) -> dict:
        """The compact rollup: completed-sample count, delivered-age
        p50/p99, per-stage p50s, the worst (slowest) stage, and the
        max |residual|."""
        with self._lock:
            samples = list(self._samples)
            last_pub, last_rx = self._last_pub, self._last_rx
        out: dict = {"count": len(samples)}
        if samples:
            ages = sorted(s["age_s"] for s in samples)
            out["age_p50_s"] = round(_q(ages, 0.5), 6)
            out["age_p99_s"] = round(_q(ages, 0.99), 6)
            stages: dict = {}
            for st in DELIVERY_STAGES:
                vals = sorted(s["stages"][st] for s in samples)
                stages[st] = round(_q(vals, 0.5), 6)
            out["stages_p50_s"] = stages
            out["worst_stage"] = max(stages, key=lambda k: stages[k])
            out["max_abs_residual_s"] = round(
                max(abs(s["residual_s"]) for s in samples), 9)
        if last_pub is not None:
            # the stalled-feed view: how long since the newest applied
            # record was PUBLISHED (cross-clock, like feed_transit
            # itself) — rises while a wedged writer publishes nothing,
            # even though no completed sample moves
            out["feed_transit_current_s"] = round(
                max(0.0, self.clock() - last_pub), 6)
        if last_rx is not None:
            out["since_last_receipt_s"] = round(
                max(0.0, self.clock() - last_rx), 6)
        return out

    def snapshot(self, n: int = 32) -> dict:
        """The ``/debug/delivery`` payload."""
        with self._lock:
            recent = list(self._samples)[-max(0, int(n)):][::-1]
        return {
            "stage_order": list(DELIVERY_STAGES),
            "cross_host": list(CROSS_HOST_STAGES),
            "summary": self.summary(),
            "recent": recent,
        }

    def member_block(self) -> dict | None:
        """The fleet member snapshot's ``delivery`` block (compact —
        published every HEATMAP_FLEET_PUBLISH_S; /fleet/delivery
        stitches it)."""
        s = self.summary()
        if not s.get("count") and "feed_transit_current_s" not in s:
            return None
        return s
