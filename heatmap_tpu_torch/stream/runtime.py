"""Micro-batch streaming runtime: source -> device fold -> store, with
checkpoints, slab growth, a prefetched feed, the positions fold and the
sink writer thread.

The counterpart of the single-device path of
``heatmap_tpu/stream/runtime.py``:

  poll (columns, or event dicts parsed here with the reference's
  validation; rejects count as ``events_invalid``) -> pad into pinned
  host buffers -> host->device copy (on a side stream, one batch ahead
  of the fold: ``prefetch_batches``) -> fused fold
  of every (res, window) pair (engine.multi) -> the packed emits parked in
  an ``EmitRing`` on the device -> one pull of every parked batch (a live
  prefix of each on CUDA) -> the packed tile rows handed to the
  ``AsyncWriter`` thread, which upserts them into the store -> every
  ``checkpoint_every`` batches a checkpoint: the ring flushed, a device
  copy of each slab taken on the step thread, then on a background thread
  the writer drained (offsets never move past a write that has not
  landed), the copy to the host and the commit to disk.

With ``HEATMAP_REDUCERS=count,kalman`` the inference engine
(``infer.InferenceEngine``) folds each batch's host columns after the
step's ring flush and before the fold's dispatch (the ``infer`` span): its
rounds scan runs on a CUDA stream of the engine's own, so its wait for the
outputs does not queue behind the fold.  Its anomalies are published into
the materialized view on the writer thread, after the tile writes handed
over before them (``TileMatView.publish_anomalies`` via ``submit_mark``),
where the continuous-query engine's anomaly queries read them; its
per-cell velocity field rides the tile docs of each flush as ``vxKmh`` /
``vyKmh``, and its entity table commits with the window state as
``extra-infer.npz``.  With ``count`` alone nothing of it is built.

``HEATMAP_H3_IMPL`` picks the snap that keys the fold, as the reference's
runtime resolves it (``resolve_snap_route``): ``native`` snaps the live
rows of each batch on the host with the f64 C++ snap
(``hexgrid.native_snap``) while the batch is padded, and hands the keys to
the fold as ``prekeys`` (no snap launch); ``auto`` takes ``native`` on the
CPU and the in-program snap (the fused CUDA kernel, its plain version on
the CPU) on the card; ``xla`` and ``pallas`` take the in-program snap, as
does every value above res 10.  Every commit records the route under the
reference's names (``native`` | ``pallas``), and a resume under ``auto``
pins the route its checkpoint names (``_pin_snap_impl``), so edge events
are never re-keyed in the middle of a stream; a host snap that cannot be
built raises.

A source that takes whole records (columnar values, the feeder process)
may return more rows than a batch: the overshoot is carried
(``_carry_cols``) and folded as the next batch before the source is polled
again, and the dispatched offsets, and so the commits, advance only once
the last row of the poll has been dispatched.

At each dispatch the positions fold (``_fold_positions``, numpy on the
host, as in the reference) picks the newest event of each vehicle in the
batch, keeps it only if it is newer than the last one emitted for that
vehicle (``_pos_ts``, in memory only, as in the reference: after a resume
the stores' own newer-only guard keeps ``positions_latest`` monotonic),
and hands the changed vehicles' rows to the writer.  A write that fails
past the writer's retries poisons it: nothing flushes or commits again,
and the last good commit's tail replays on resume.

The ring is flushed when it holds ``emit_flush_k`` batches, when the
watermark cutoff crosses a boundary of the smallest window (so closing
windows reach the sink now, not up to K batches later), when the slab
could grow (growth pressure: the occupancy stats lag the parked batches),
before a checkpoint, on an idle poll, and at the end of a run (``close``).
The cutoff of each batch is ``max_event_ts - watermark_minutes * 60``, as
in the reference; since the device's ``batch_max_ts`` arrives only with a
flush, ``max_event_ts`` advances on the host from each batch's own
timestamps under the fold's late and future masks (``_host_batch_max_ts``),
and each flush maxes in the device's value.  Docs, counters and the cutoff
sequence are therefore the same for every K.

The slab grows (``_maybe_grow``) before it can overflow: a batch mints at
most one group per event per pair, so the grower keeps ``_grow_margin``
free rows, up to ``2^state_max_log2`` rows (default: the configured size
x 16).  Overflow past the ceiling is counted and logged (``on_overflow=
"error"``) or stops the run without a commit (``"fail"``).  A new runtime
resumes from the latest commit in ``checkpoint_dir`` (``_maybe_resume``):
the offset, the watermark and each pair's slab, grown to a larger
snapshot or padded to a larger configuration.

With ``HEATMAP_QUERY_VIEW`` on (the default) the runtime keeps the
materialized tile view (``matview``, query.matview), which the writer
thread feeds after each durable tile write and the serve tier reads.  The
step thread publishes a plain-dict metrics snapshot at each batch end
(``metrics_snapshot``): an HTTP thread reads that, never the runtime's
device state.

The run's own introspection is the reference's: one registry a runtime
(``telemetry``, a ``stream.metrics.Metrics``; ``metrics`` stays the
port's dict of counters, pulls, commits and median spans) with the batch,
span, freshness, event-age and ring-residency histograms and every drop
under its closed reason; a trace record a batch (``tracering``, served at
``/trace/recent``, exported to ``HEATMAP_TRACE_JSONL``); a freshness
lineage record a polled batch, stamped at poll, dispatch, ring entry,
flush and the writer's commit ack (``lineage``, ``/debug/freshness``);
the compile tracker on the fold's entry points and the memory monitor,
sampled at 1 Hz (``runtimeinfo``); a ``torch.profiler`` window over
``HEATMAP_PROFILE_DIR`` or ``POST /debug/profile`` (``tracer``); and with
``HEATMAP_FLIGHTREC_DIR`` the flight recorder, dumped at an abnormal close
(``flightrec``), and the SLO watchdog with the stack sampler.  With
``HEATMAP_TSDB`` the telemetry history (``tsdb``, a recorder thread that
scrapes this registry and the /healthz verdict into rings and blocks under
``HEATMAP_TSDB_DIR``) and the SLO burn-rate engine (``slo_engine``); with
``HEATMAP_QUALITY`` and the kalman reducer the quality observatory
(``quality``), fed by the engine's fold, read by
``/api/tiles/forecast``'s scorecards, and committed with the entity table
as ``extra-quality.npz``.  The spans those read carry the reference's
names and boundaries (poll, build, pad, transfer, pull, snap, device,
sink_submit, prefetch, poll_fetch, poll_decode, poll_wait, infer);
``span_ms`` keeps the port's finer ones.

With ``HEATMAP_AUDIT`` the integrity observatory (``audit``, an
``obs.audit.AuditState``): the conservation ledger stamped at poll,
dispatch, flush (``folded`` on the primary pair, ``docs_emitted`` with the
fold's digest table), the writer's commit and view apply, and every
tagged drop; the view keeps a digest table and publishes each touched
window's digest in its feed records.  With ``HEATMAP_DELIVERY`` the feed
publisher stamps each record's delivery lineage (``pt``), its event age
read from this runtime's lineage.  With ``HEATMAP_SUPERVISOR_CHANNEL`` the
runtime publishes its member snapshot beside the channel on the step loop
(``_publish_member_snapshot``, at most every ``HEATMAP_FLEET_PUBLISH_S``,
and at close, a clean one as a departure tombstone) and its freshness
summary from the writer thread, and its SLO watchdog and burn-rate engine
correlate their dumps under the fleet's episodes.

With ``HEATMAP_SHARDS`` > 1 this process is one shard of an H3-partitioned
fleet (``stream.shardmap``; ``python -m heatmap_tpu_torch.stream
--supervise --shards N`` runs the fleet): each poll takes
``HEATMAP_SHARD_OVERSAMPLE`` feed batches of rows, the ownership filter
keeps the rows whose cell (the fold's own snap) this shard owns, in
order, and the rest count as ``out_of_shard``/``oversample`` drops; the
watermark still advances from the rows before the filter, and a batch
whose rows are all foreign still dispatches, empty.  A shard commits
under ``<CHECKPOINT>/shard<i>``, tags itself ``shard<i>``, keeps no view
of its own (``view=`` fans several shards into one), and with a
supervisor channel publishes its watermark beside it and holds its
cutoff at the fleet's low bound (``_effective_max_ts``, never moving
back).  Under ``HEATMAP_HEARTBEAT_FILE`` the step loop writes the
supervisor's liveness beacon after each step (``_touch_heartbeat``), kept
alive through a long step by a watchdog thread for up to
``HEATMAP_DISPATCH_GRACE_S``.  With ``HEATMAP_GOVERN`` a
``stream.govern.BatchGovernor`` moves the live feed batch
(``_feed_batch``, along a ladder of pad buckets each dispatched once at
startup), the ring's flush-K and the prefetch depth at step boundaries.
The mesh of the reference (``parallel/``) is not ported yet.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from heatmap_tpu_torch.config import Config
from heatmap_tpu_torch.engine import step
from heatmap_tpu_torch.engine.multi import MultiAggregator, stats_from_packed
from heatmap_tpu_torch.engine.state import TileState, to_host
from heatmap_tpu_torch.engine.step import FUTURE_WINDOWS, I32_MIN, EmitRing
from heatmap_tpu_torch.obs.lineage import LineageTracker
from heatmap_tpu_torch.obs.runtimeinfo import RuntimeIntrospection
from heatmap_tpu_torch.obs.tracebuf import TraceRing
from heatmap_tpu_torch.obs.xproc import ENV_FLEET_TAG
from heatmap_tpu_torch.sink.base import (PositionRows, Store, TilePackMeta,
                                         packed_tile_docs)
from heatmap_tpu_torch.sink.writer import AsyncWriter
from heatmap_tpu_torch.stream.checkpoint import CheckpointManager
from heatmap_tpu_torch.stream.events import (EventColumns, parse_events,
                                             slice_columns)
from heatmap_tpu_torch.stream.metrics import Metrics
from heatmap_tpu_torch.stream.shardmap import ShardMap, join_words
from heatmap_tpu_torch.stream.source import Source
from heatmap_tpu_torch.stream.trace import Tracer

log = logging.getLogger(__name__)


class StateOverflowError(RuntimeError):
    """Raised (HEATMAP_ON_OVERFLOW=fail) when distinct (cell, window)
    groups exceed the state slab capacity and aggregates would be
    dropped."""


class _FeedBatch(NamedTuple):
    """One polled batch, padded and on its way to the device.  ``offset``
    is the source position right after THIS batch's poll: it becomes the
    committed offset only when the batch is dispatched, so a checkpoint
    never covers a batch that was polled ahead but not folded."""

    cols: EventColumns   # the host columns: the watermark advance and the
                         # positions fold read them
    n: int               # live rows
    feed: dict           # lat/lng/speed/ts/valid, padded, on the device
    host: dict           # the pinned host buffers the copies read from
    ready: object        # CUDA event after the copies (None on the CPU)
    offset: object       # source offset after this batch's poll
    carried: bool        # rows of this batch's poll are still carried:
                         # its offset may not be committed yet
    spans: dict          # poll and feed seconds (feed split into pad,
                         # snap on the native route, and transfer), and
                         # the source's own poll sub-spans (fetch, decode)
                         # when it has them
    lineage: dict | None  # the freshness lineage record opened at poll
    wm_ts: np.ndarray | None  # a shard's poll before the ownership
                              # filter: the watermark advances from it


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; a CUDA device without a card raises (the port
    runs on the CPU only when the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return device


# the names a checkpoint's ``snap_impl`` may carry for the in-program snap:
# the reference's ("pallas", "xla") and the port's before the reference's
# names were adopted ("cuda", "torch")
_IN_PROGRAM_SNAP_NAMES = ("pallas", "xla", "cuda", "torch")


def resolve_snap_route(h3_impl: str, device: torch.device,
                       resolutions) -> str:
    """The snap that keys the fold, as the reference's runtime resolves
    ``HEATMAP_H3_IMPL`` (heatmap_tpu/stream/runtime.py:747-757):
    ``"native"`` (the f64 host snap, keys fed as ``prekeys``) for
    ``native``, and for ``auto`` on the CPU; ``"pallas"`` (the in-program
    snap: the CUDA kernel, its plain version on the CPU) otherwise, and
    for any resolution above 10, which the host snap does not cover."""
    want_native = (h3_impl == "native"
                   or (h3_impl == "auto" and device.type == "cpu"))
    if want_native and all(r <= 10 for r in resolutions):
        return "native"
    return "pallas"


def _wrap32(x):
    """int64 -> int32 two's-complement wrap (numpy arrays)."""
    return ((x + 2**31) % 2**32) - 2**31


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


class MicroBatchRuntime:
    def __init__(self, cfg: Config, source: Source, store: Store,
                 device: str | torch.device = "cuda",
                 checkpoint_every: int = 20, positions_enabled: bool = True,
                 view=None):
        self.cfg = cfg
        self.source = source
        self.store = store
        self.device = resolve_device(device)
        self.checkpoint_every = checkpoint_every
        self.positions_enabled = positions_enabled
        self.pairs = list(dict.fromkeys(
            (res, wmin * 60) for res in cfg.resolutions
            for wmin in cfg.windows_minutes))
        cap = 1 << cfg.state_capacity_log2
        self._cap_max = 1 << (cfg.state_max_log2
                              or cfg.state_capacity_log2 + 4)
        if (cfg.grow_margin == "worst" and self._cap_max > cap
                and cap < 2 * cfg.batch_size):
            # one batch can mint up to batch_size new groups: below this
            # floor the first batches could overflow before stats-driven
            # growth sees them, so start at the floor (loudly)
            grown = cap
            while grown < 2 * cfg.batch_size and grown < self._cap_max:
                grown *= 2
            log.warning(
                "STATE_CAPACITY_LOG2=%d holds less than one batch of new "
                "groups; starting at 2^%d rows (set "
                "HEATMAP_STATE_MAX_LOG2=%d to pin the configured size)",
                cfg.state_capacity_log2, grown.bit_length() - 1,
                cfg.state_capacity_log2)
            cap = grown
        self.multi = MultiAggregator(
            self.pairs, capacity=cap, batch_size=cfg.batch_size,
            emit_capacity=min(cfg.batch_size, cap),
            hist_bins=cfg.speed_hist_bins,
            speed_hist_max=cfg.speed_hist_max_kmh, device=self.device)
        self.aggs = {pair: self.multi.view(*pair) for pair in self.pairs}
        self._pack_meta = {
            (res, win_s): TilePackMeta(
                city=cfg.city,
                grid=cfg.pair_grid(res, win_s // 60),
                window_s=win_s,
                ttl_minutes=cfg.ttl_minutes,
                window_minutes_tag=(0 if win_s // 60 == cfg.tile_minutes
                                    else win_s // 60),
                with_p95=cfg.speed_hist_bins > 0,
            )
            for res, win_s in self.pairs}
        # the pair whose stats define the batch-level counters
        primary = (cfg.h3_res, cfg.tile_minutes * 60)
        self._primary = primary if primary in self.pairs else self.pairs[0]
        # unique window lengths: the host-side watermark advance and the
        # watermark-pressure flush trigger read them
        self._uniq_windows = sorted({win_s for _, win_s in self.pairs})
        self.epoch = 0
        self.max_event_ts = I32_MIN
        self._last_flush_cutoff = I32_MIN  # watermark-pressure tracking
        self._ring = EmitRing(cfg.emit_flush_k)
        # the live feed shape and prefetch depth: the config's values,
        # which the governor moves (_govern_step)
        self._feed_batch = cfg.batch_size
        self._prefetch_n = max(0, cfg.prefetch_batches)
        self._prefix_pull = (self.device.type == "cuda"
                             if cfg.emit_pull == "auto"
                             else cfg.emit_pull == "prefix")
        self._prefetched: collections.deque = collections.deque()
        self._closing = False       # stops the prefetch refill at close
        cuda = self.device.type == "cuda"
        # the feed's host->device copies and the checkpoint's device->host
        # copies run on streams of their own, off the fold's
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._ckpt_stream = torch.cuda.Stream(self.device) if cuda else None
        # overflow policy and growth bookkeeping
        self._fatal = False         # a fail-mode overflow: no exit commit
        self._overflow_logged_at = -float("inf")
        self._n_active_peak = 0     # max live groups (any pair)
        self._prev_active: dict = {}  # last n_active per pair
        self._mint_peak = 0         # max per-batch new-group count seen
        if cfg.grow_margin == "observed" and cfg.on_overflow != "fail":
            log.warning(
                "HEATMAP_GROW_MARGIN=observed with HEATMAP_ON_OVERFLOW=%s:"
                " a minting burst beyond the observed margin DROPS groups"
                " (loudly) — set HEATMAP_ON_OVERFLOW=fail for the lossless"
                " stop-and-replay backstop", cfg.on_overflow)
        # the snap that keys the fold: the host snap's keys ride the feed
        # as prekeys; a host snap that cannot be built raises here
        self._h3_env = os.environ.get("HEATMAP_H3_IMPL", "auto")
        self._host_snap = None
        if resolve_snap_route(self._h3_env, self.device,
                              cfg.resolutions) == "native":
            self._use_host_snap()
        # H3-parent stream partitioning (stream/shardmap.py): with
        # HEATMAP_SHARDS > 1 this process folds only the cell space its
        # shard owns, the owner read from the cell the fold keys the row
        # with (_fold_cells); None when unsharded
        self.shardmap = ShardMap.from_config(cfg, snap_fn=self._fold_cells)
        self._shard_oversample = 1
        if self.shardmap is not None:
            self._shard_oversample = cfg.shard_oversample or cfg.shards
            log.info("sharded runtime: %s, oversample %d",
                     self.shardmap.describe(), self._shard_oversample)
        self._shard_wm_pub_last = 0.0   # aligned-watermark publish limit
        self._shard_wm_read_last = 0.0  # aligned-watermark read cache
        self._shard_wm_floor = None     # cached fleet low bound
        self._shard_wm_eff_last = I32_MIN  # monotone cutoff floor
        # the supervisor's liveness beacon (HEATMAP_HEARTBEAT_FILE)
        self._step_began = None   # monotonic start of the step in flight
        self._hb_last = 0.0       # last beacon write (monotonic)
        self._hb_stop: threading.Event | None = None
        self._hb_watchdog: threading.Thread | None = None
        # a batch-granular poll's rows past the batch, folded next, and
        # their ownership cells (a shard's native-route keys)
        self._carry_cols: EventColumns | None = None
        self._carry_shard_cells: np.ndarray | None = None
        self._carried_last = False  # the last dispatch left rows carried
        self._ckpt_due = False      # cadence hit while carrying
        # checkpoints: the commit runs on a background thread; its error
        # surfaces on the step thread at the next join
        # a shard commits under its own namespace, so a restarted shard
        # resumes and replays only its own stream position
        self.ckpt = CheckpointManager(
            f"{cfg.checkpoint_dir}/shard{cfg.shard_index}"
            if self.shardmap is not None else cfg.checkpoint_dir)
        self._ckpt_thread: threading.Thread | None = None
        self._ckpt_err: BaseException | None = None
        # one record per commit: epoch, capture ms on the step thread, and
        # (once landed) background seconds and bytes on disk
        self.commits: list[dict] = []
        # the runtime's metrics and its one registry (the view's, the
        # serve tier's, the writer's and the engine's families live in
        # it too); ``counters`` reads the event counters back under the
        # port's names
        self.telemetry = Metrics()
        self.registry = self.telemetry.registry
        # this member's tag: lineage ids, the quality observatory, the
        # telemetry history's directory and the shard watermark file
        # carry it (the reference's single-process runtime takes "p0", a
        # shard "shard<i>", so two shards never share a member file)
        self._fresh_tag = os.environ.get(ENV_FLEET_TAG) or (
            f"shard{cfg.shard_index}" if self.shardmap is not None
            else "p0")
        # rate limits of the channel publishes (per-child freshness on the
        # writer thread, the member snapshot on the step loop)
        self._fresh_pub_last = 0.0
        self._member_pub_last = 0.0
        self._n_batches = 0       # batches folded by this runtime
        self._n_polled = 0        # events those batches carried
        # emit pulls: flushes in all and by trigger, batches and bytes
        # pulled (these depend on K, the counters above do not)
        self.pulls = {"flushes": 0, "full": 0, "watermark": 0, "grow": 0,
                      "checkpoint": 0, "idle": 0, "close": 0, "govern": 0,
                      "batches": 0, "bytes": 0}
        self.batch_ms: list[float] = []
        # per-batch spans (ms) on the host clock: poll and feed (pad + H2D
        # enqueue) of the batch dispatched, whichever step paid them; pull
        # and sink (a flush of the parked batches before this batch's
        # fold, device wait + D2H, then the stats and the hand-off to the
        # writer thread; 0 when the batch flushes nothing), dispatch (fold
        # enqueue, the predicate wait excluded), predicate (the host's wait
        # on the fold's tier predicate read, engine.step._read_flags),
        # positions (the positions fold and its hand-off to the writer),
        # snap (the host snap of the batch's live rows on the native
        # route, inside feed), wait and copy (inside the poll, from the
        # feeder process's source: the wait on the feeder and the copy
        # out of its ring),
        # prefetch (the next batch's poll and feed, after this dispatch),
        # checkpoint (the flush before it and the capture on this thread;
        # 0 on most batches); infer (the Kalman reducer's fold of the
        # batch, when HEATMAP_REDUCERS names kalman); fetch and decode
        # (inside the poll, from a source that reports them: a Kafka
        # source's broker round trips and value decode); and, when
        # time_device_fold is set on a CUDA run, the fold's device time
        # from CUDA events (off by default: two events per batch that only
        # a profiling run reads)
        self.time_device_fold = False
        self.span_ms: dict[str, list[float]] = {
            k: [] for k in ("poll", "feed", "pull", "sink", "dispatch",
                            "predicate", "positions", "prefetch",
                            "checkpoint", "infer", "fetch", "decode",
                            "snap", "wait", "copy", "device_fold")}
        # the last flush's batches: [([host matrix per pair], epoch)]
        self.last_flush: list = []
        self._fold_events: list = []  # CUDA event pairs not yet read
        # seconds a resume spent reading the commit's npz files (load) and
        # putting the slabs on the device (restore); empty without one
        self.resume_s: dict[str, float] = {}
        # provider/vehicle intern maps for sources that poll event dicts
        self._intern_p: dict = {}
        self._intern_v: dict = {}
        # per-vehicle-intern-id last emitted ts (monotonic guard), grown on
        # demand; -2^62 = "never seen", below any valid epoch
        self._pos_ts = np.full(1024, -(2**62), np.int64)
        self._pos_win: np.ndarray | None = None  # the fold's scatter buffer
        # the Kalman reducer, when HEATMAP_REDUCERS names it; with count
        # alone nothing is built and the count path is what it was
        self.infer = None
        if "kalman" in cfg.reducers:
            from heatmap_tpu_torch.infer import InferenceEngine

            self.infer = InferenceEngine(cfg, device=self.device,
                                         metrics=self.telemetry,
                                         partition_snap=self._fold_cells)
        self._maybe_resume()
        # offsets as of the last DISPATCHED batch: checkpoints commit
        # these, so a batch polled but not dispatched always replays
        self._offsets_dispatched = self.source.offset()
        # the materialized tile view the writer thread feeds, under
        # HEATMAP_QUERY_VIEW; no store scan here: the serve layer seeds
        # a grid the view has not seen from the store on first access
        # A shard keeps no view of its own: it sinks only its cell space,
        # so a process-local view would serve a partial city; a caller
        # passes ``view=`` to fan several shards into one shared view
        # (cell spaces are disjoint, so the merge is upsert-only)
        self.matview = None
        if view is not None:
            self.matview = view
        elif cfg.query_view and self.shardmap is None:
            from heatmap_tpu_torch.query import TileMatView

            # under HEATMAP_AUDIT the view keeps a per-window digest table
            # and publishes each touched window's digest in its feed
            # records ("dg")
            view_audit = None
            if cfg.audit:
                from heatmap_tpu_torch.obs.audit import DigestTable

                view_audit = DigestTable()
            self.matview = TileMatView(
                delta_log=cfg.delta_log,
                pyramid_levels=cfg.pyramid_levels,
                registry=self.registry,
                audit=view_audit)
        # Delta-log view replication (query.repl): with HEATMAP_REPL_DIR
        # set, every view mutation the writer thread applies is
        # published to the feed, so serve-only replicas
        # (HEATMAP_REPL_FEED) hold a hot seq-consistent copy with zero
        # steady-state store reads.  Only a self-owned view publishes: a
        # shared fan-in view gets one publisher from its owner, never one
        # a shard.
        self.repl_pub = None
        self.hist_compactor = None
        if self.matview is not None and view is None and cfg.repl_dir:
            from heatmap_tpu_torch.query.repl import DeltaLogPublisher

            # space-time history tier (query/history.py,
            # HEATMAP_HIST_DIR): the publisher retires rotated
            # segments into the durable log instead of deleting them,
            # and a compactor thread folds them into the immutable
            # chunk store — built BEFORE the publisher so the boot
            # sweep retires the dead epoch's tail instead of erasing it
            hist_log = None
            if cfg.hist_dir:
                from heatmap_tpu_torch.query.history import (
                    HistoryCompactor, HistoryLog)

                hist_log = HistoryLog(cfg.hist_dir)
            # the delivery lineage's event_age leg (obs.delivery): under
            # HEATMAP_DELIVERY the publisher stamps the newest sink-acked
            # event's age into each record at hook enqueue; late-bound,
            # since the lineage is built below and the hook fires only
            # once the step loop mutates the view
            self.repl_pub = DeltaLogPublisher(
                self.matview, cfg.repl_dir,
                seg_bytes=cfg.repl_seg_bytes,
                segments=cfg.repl_segments,
                registry=self.registry,
                hist=hist_log,
                event_age_fn=lambda: self.lineage.newest_event_age_s())
            if hist_log is not None:
                self.hist_compactor = HistoryCompactor(
                    cfg.hist_dir, feed_dir=cfg.repl_dir,
                    bucket_s=cfg.hist_bucket_s,
                    parent_res=cfg.hist_parent_res,
                    retention_s=cfg.hist_retention_s,
                    registry=self.registry,
                    interval_s=cfg.hist_compact_s)
                self.hist_compactor.start()
        # the inference quality observatory (obs.quality), under
        # HEATMAP_QUALITY with the kalman reducer: live forecast scoring
        # and calibration ledgers attached to the engine's fold, observe-
        # only; without the knob nothing is built and no family registers
        self.quality = None
        if cfg.quality and self.infer is not None:
            from heatmap_tpu_torch.obs.quality import QualityObservatory

            self.quality = QualityObservatory(
                cfg, registry=self.registry, view=self.matview,
                tag=self._fresh_tag)
            self.infer.quality = self.quality
            # pending scorecards survive a restart and score against the
            # history tier when their spans have left the rebuilt view
            data = self.ckpt.load_extra("quality")
            if data is not None:
                n = self.quality.restore_extra(data)
                log.info("restored quality ledger: %d pending "
                         "scorecards", n)
        # the integrity observatory (obs.audit), under HEATMAP_AUDIT: the
        # conservation ledger in this registry (heatmap_audit_* families),
        # stamped at every boundary — polled and dispatched on the step
        # thread, folded and docs_emitted (with the fold's digest table,
        # shard "self") at each flush, docs_committed and
        # docs_view_applied on the writer thread, and every tagged drop
        # (Metrics.drop).  Observe-only; without the knob nothing is built
        self.audit = None
        if cfg.audit:
            from heatmap_tpu_torch.obs.audit import AuditState

            self.audit = AuditState(self.registry, tag=self._fresh_tag,
                                    settle_s=cfg.audit_settle_s)
            self.audit.attach(view=self.matview, repl_pub=self.repl_pub)
            self.telemetry.audit = self.audit
        # the sink thread: tiles at each flush, positions at each dispatch
        self.writer = AsyncWriter(store, metrics=self.telemetry,
                                  view=self.matview, audit=self.audit)
        self._init_introspection()
        # adaptive micro-batching (stream/govern.py): under HEATMAP_GOVERN
        # the static batch, flush-K and prefetch knobs become initial
        # values that a feedback governor moves at step boundaries.
        # Built after the resume, so a restored and grown slab is warmed
        # at its final shape
        self.governor = None
        if cfg.govern:
            from heatmap_tpu_torch.stream.govern import BatchGovernor

            gov = BatchGovernor(
                cfg, self.registry,
                event_age=self.telemetry.event_age.labels(bound="mean"),
                compile_tracker=self.runtimeinfo.compile,
                memory=self.runtimeinfo.memory)
            # the ladder's dispatches below run through the instrumented
            # step before steady state: widen the tracker's warmup so
            # they never read as post-warmup builds
            self.runtimeinfo.compile.warmup += len(gov.ladder)
            self._warm_ladder(gov.ladder)
            # re-baseline after warming: a build from here on freezes it
            gov._retrace_base = gov._retraces()
            self.governor = gov
            if self.flightrec is not None:
                self.flightrec.add_source(
                    "govern", lambda: (self.governor.snapshot()
                                       if self.governor else None))
        # the metrics snapshot the step thread publishes at each batch end
        # (metrics_snapshot); HTTP threads read it under this lock
        self._snap_lock = threading.Lock()
        self._snapshot: dict = {}
        self._publish_snapshot()
        # the SLO watchdog and the stack sampler, armed with the flight
        # recorder; started last, since its thread reads this runtime
        self.slo_watchdog = None
        if self.flightrec is not None:
            from heatmap_tpu_torch.obs.prof import get_sampler
            from heatmap_tpu_torch.obs.runtimeinfo import SloWatchdog

            get_sampler().ensure_started()
            # fleet mode under a supervisor channel: a degraded
            # transition claims or joins one episode, tagged by member
            self.slo_watchdog = SloWatchdog(self, tag=self._fresh_tag)
            self.slo_watchdog.start()
        # the telemetry time machine (obs.tsdb) and the SLO burn-rate
        # engine (obs.slo), under HEATMAP_TSDB: a sampler thread records
        # this member's exposition and /healthz verdict into history
        # rings (blocks under HEATMAP_TSDB_DIR) and evaluates the error
        # budgets at each scrape; without the knob neither module is
        # imported and no family registers
        self.tsdb = None
        self.slo_engine = None
        if cfg.tsdb:
            self._start_tsdb()

    def _start_tsdb(self) -> None:
        """Build and start the recorder and the SLO engine.  The scrape
        renders the registry with the writer's counters (less the
        retries, a registry series already) and the source's, as
        ``/metrics`` does; the verdict is ``serve.api.healthz_payload``.
        Both run on the recorder's thread, which reads host state only
        (the memory gauges are sampled on the step thread)."""
        from heatmap_tpu_torch.obs.slo import SloEngine
        from heatmap_tpu_torch.obs.tsdb import TsdbRecorder
        from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL

        cfg = self.cfg

        def scrape() -> str:
            extra = dict(self.writer.counters)
            extra.pop("sink_retries", None)
            extra.update(getattr(self.source, "counters", None) or {})
            return self.telemetry.expose_text(extra_counters=extra)

        def healthz() -> dict:
            from heatmap_tpu_torch.serve.api import healthz_payload

            return healthz_payload(self)[0]

        self.tsdb = TsdbRecorder(
            scrape, tag=self._fresh_tag, dir_path=cfg.tsdb_dir or None,
            healthz_fn=healthz, registry=self.registry,
            scrape_s=cfg.tsdb_scrape_s, retain_s=cfg.tsdb_retain_s,
            hot_s=cfg.tsdb_hot_s, flush_s=cfg.tsdb_flush_s)
        self.slo_engine = SloEngine(
            self.tsdb, registry=self.registry, tag=self._fresh_tag,
            budget_frac=cfg.slo_budget_frac,
            budget_window_s=cfg.slo_budget_window_s,
            channel_path=os.environ.get(ENV_CHANNEL),
            flightrec=self.flightrec)
        self.tsdb.start()

    def _init_introspection(self) -> None:
        """The reference's observability wiring: the profiler window, the
        trace ring, the lineage, the flight recorder and its sources, the
        pipeline gauges and the runtime introspection, whose compile
        tracker wraps the fold's entry points."""
        cfg = self.cfg
        self.tracer = Tracer(device=self.device)
        self.tracering = TraceRing()
        self._trace_cum = (0, 0, 0)
        # lineage ids are origin-tagged (``<tag>-<seq>``), the tag the
        # reference's single-process runtime takes
        self.lineage = LineageTracker(capacity=cfg.lineage_tail,
                                      origin=self._fresh_tag)
        self._lineage_open: dict[int, dict] = {}
        self._carry_polled_at = 0.0  # the lineage poll stamp of a carry
        self.flightrec = None
        if cfg.flightrec_dir:
            import dataclasses

            from heatmap_tpu_torch.obs.flightrec import FlightRecorder
            from heatmap_tpu_torch.obs.prof import get_sampler

            fr = FlightRecorder(cfg.flightrec_dir)
            fr.add_source("trace_tail", lambda: self.tracering.recent(64))
            fr.add_source("lineage_tail", lambda: self.lineage.tail(64))
            fr.add_source("metrics", lambda: self.telemetry.snapshot())
            fr.add_source("config", lambda: dataclasses.asdict(self.cfg))
            fr.add_source("run_state", lambda: {
                "epoch": self.epoch,
                "max_event_ts": self.max_event_ts,
                "ring_pending": len(self._ring),
                "prefetched": len(self._prefetched),
                "writer_poisoned": self.writer.poisoned,
            })
            # the conservation ledger's residuals and digest state ride
            # every dump (None without HEATMAP_AUDIT)
            fr.add_source("audit", lambda: (self.audit.snapshot()
                                            if self.audit else None))
            # the calibration picture rides every dump, the SLO engine's
            # drift-burn dump included
            fr.add_source("quality", lambda: (self.quality.snapshot()
                                              if self.quality else None))
            fr.add_source("runtimeinfo", lambda: self.runtimeinfo.snapshot())
            fr.add_source("stacks", lambda: get_sampler().tail(20))
            self.flightrec = fr
            if self.audit is not None:
                # digest-mismatch dumps correlate under the fleet episode
                # through this recorder (obs.audit._dump_mismatch)
                self.audit.flightrec = fr
        # pipeline-state gauges
        self._g_watermark = self.telemetry.gauge(
            "heatmap_watermark_age_seconds",
            "wall clock minus the event-time high watermark "
            "(max event ts seen)")
        self._g_capacity = self.telemetry.gauge(
            "heatmap_state_capacity_rows",
            "state slab capacity per shard (rows)")
        self._g_capacity.set(self.multi.capacity_per_shard)
        self._g_active = self.telemetry.gauge(
            "heatmap_state_active_groups_peak",
            "max live (cell,window) groups seen on any pair")
        # sampled by serve/api.py at every /api/tiles/latest render
        self._g_serve_fresh = self.telemetry.gauge(
            "heatmap_serve_freshness_seconds",
            "/tiles render wall time minus the newest sink-committed "
            "event timestamp (ingest-to-serve freshness; NaN before "
            "the first render)")
        self._g_serve_fresh.set(float("nan"))
        # the fold's host dispatch clock, read at scrape time
        self.telemetry.gauge(
            "heatmap_device_dispatch_seconds",
            "cumulative host wall seconds spent dispatching the fused "
            "device step (one clock per local dispatch stream)",
            labels=("shard",)).labels(shard="0").fn = (
                lambda: self.multi.device_seconds[0])
        self.telemetry.gauge(
            "heatmap_emit_ring_pending",
            "packed emit batches parked on device awaiting the next flush",
            fn=lambda: len(self._ring))
        # the reference's fast-path pin (a knob pinned down for a
        # topology: multi-host lockstep, a governor the topology cannot
        # take); the one-device port pins nothing, so the family has no
        # child
        self.telemetry.gauge(
            "heatmap_fastpath_pinned",
            "1 per reason the runtime pinned fast-path knobs down "
            "(emit_flush_k=1 / prefetch_batches=0 for multi-host "
            "lockstep, a governor request the topology cannot honor) — "
            "a run silently serving degraded throughput is diagnosable "
            "from telemetry",
            labels=("reason",))
        self._g_shard_wm_lag = None
        if self.shardmap is not None:
            self.telemetry.gauge(
                "heatmap_shard_index",
                "this runtime's shard in the H3-partitioned fleet "
                "(stream/shardmap.py)").set(cfg.shard_index)
            self.telemetry.gauge(
                "heatmap_shard_count",
                "total runtime shards partitioning the stream "
                "(HEATMAP_SHARDS)").set(cfg.shards)
            # own watermark minus the fleet low bound: how far this shard
            # runs ahead of the slowest peer (0 when aligned or without a
            # channel; the cutoff is held at the low bound either way)
            self._g_shard_wm_lag = self.telemetry.gauge(
                "heatmap_shard_watermark_lag_seconds",
                "this shard's event-time high watermark minus the "
                "fleet's low watermark bound (how far ahead of the "
                "slowest shard this one runs; 0 when aligned or "
                "channel-less)")
            self._g_shard_wm_lag.set(0.0)
        self.runtimeinfo = RuntimeIntrospection(
            self.registry, ring_bytes_fn=lambda: self._ring.nbytes,
            live_bytes_fn=self._held_bytes, device=self.device)
        self.multi.instrument(self.runtimeinfo.compile.wrap)

    def _held_bytes(self) -> int:
        """Bytes of the tensors this runtime holds: the state slabs, the
        emit ring and the staged feeds of the prefetched batches."""
        slabs = sum(t.nbytes for st in self.multi.states for t in st)
        feeds = sum(t.nbytes for e in self._prefetched
                    for t in e.feed.values())
        return slabs + self._ring.nbytes + feeds

    # ------------------------------------------------------------------
    @property
    def snap_impl(self) -> str:
        """The snap keying this run's state, under the reference's
        checkpoint names: ``"native"`` (the host snap) or ``"pallas"``
        (the in-program snap)."""
        return "native" if self._host_snap is not None else "pallas"

    def _use_host_snap(self) -> None:
        """Key the fold with the host snap; builds it now, so a library
        that cannot be built raises with the compiler's output."""
        from heatmap_tpu_torch.hexgrid import native_snap

        self._host_snap = native_snap.host_snap()

    def _fold_cells(self, lat_rad: np.ndarray, lng_rad: np.ndarray,
                    res: int) -> np.ndarray:
        """uint64 cells at ``res`` from the snap that keys this run's
        fold: the host snap on the native route, else the in-program snap
        (the fused kernel on the card, on the copy stream, so only that
        stream is waited for; its plain version on the CPU).  The shard
        map's ownership reads these, so a row belongs to the shard whose
        space its fold cell lies in, even at a cell edge where the host
        and the kernel snaps disagree."""
        if self._host_snap is not None:
            hi, lo = self._host_snap.snap(lat_rad, lng_rad, res)
            return join_words(hi, lo)
        lat = torch.from_numpy(np.ascontiguousarray(lat_rad, np.float32))
        lng = torch.from_numpy(np.ascontiguousarray(lng_rad, np.float32))
        snap = step._snap_impl(res)
        if self._copy_stream is None:
            hi, lo = snap(lat, lng, res)
        else:
            with torch.cuda.stream(self._copy_stream):
                hi, lo = snap(lat.to(self.device), lng.to(self.device), res)
                hi, lo = hi.cpu(), lo.cpu()
        return join_words(hi.numpy(), lo.numpy())

    def _pin_snap_impl(self, ck_snap: str | None) -> None:
        """Keep the snap fixed across a resume, as the reference's
        ``_pin_snap_impl`` does: the host (f64) and in-program (f32) snaps
        disagree on points at cell edges, and switching between them
        mid-stream would re-key those events and split their groups across
        the resume.  Under ``auto`` the checkpoint's route wins; an
        explicit ``HEATMAP_H3_IMPL`` is honoured and the hazard logged, as
        in the reference.  A checkpoint without a known name pins
        nothing."""
        if ck_snap != "native" and ck_snap not in _IN_PROGRAM_SNAP_NAMES:
            return
        ck_route = "native" if ck_snap == "native" else "pallas"
        if ck_route == self.snap_impl:
            return
        was = self.snap_impl
        if self._h3_env != "auto":
            log.warning(
                "checkpoint state was keyed with the %r H3 snap but "
                "HEATMAP_H3_IMPL=%s forces %r; events on f32 cell edges may "
                "re-key across this resume", ck_snap, self._h3_env, was)
            return
        if ck_route == "native":
            self._use_host_snap()
        else:
            self._host_snap = None
        log.info("pinned H3 snap %r from checkpoint (was %r under "
                 "HEATMAP_H3_IMPL=auto)", self.snap_impl, was)

    def _maybe_resume(self) -> None:
        """Resume from the latest commit, if there is one: epoch,
        watermark, source offset and each pair's slab."""
        meta = self.ckpt.load_meta()
        if not meta:
            return
        log.info("resuming from checkpoint: %s", meta)
        self._pin_snap_impl(meta.get("snap_impl"))
        snap_shards = meta.get("shards")
        if snap_shards is not None and snap_shards != self.multi.n_shards:
            # rows would be reinterpreted as different shard blocks
            raise RuntimeError(
                f"checkpoint written with {snap_shards} local shard(s), "
                f"this run has {self.multi.n_shards}; restore the original "
                f"device topology or clear {self.cfg.checkpoint_dir}")
        self.epoch = meta.get("epoch", 0)
        self.max_event_ts = meta.get("max_event_ts", I32_MIN)
        self.source.seek(meta.get("offset"))
        self.resume_s = {"load": 0.0, "restore": 0.0}
        for (res, win_s), view in self.aggs.items():
            t0 = time.monotonic()
            st = self.ckpt.load_state(res, win_s)
            t1 = time.monotonic()
            self.resume_s["load"] += t1 - t0
            if st is None:
                continue
            try:
                view.restore(st)
            except ValueError as e:
                # a capacity change across restarts is absorbed (pad up, or
                # grow to a larger snapshot); anything else refuses
                try:
                    self._restore_resized(view, st, snap_shards)
                except (ValueError, RuntimeError) as e2:
                    raise RuntimeError(
                        f"checkpoint state for (res={res}, window="
                        f"{win_s // 60}m) does not match the config ({e}; "
                        f"resize: {e2}); restore STATE_CAPACITY_LOG2/"
                        f"SPEED_HIST_BINS or clear {self.cfg.checkpoint_dir}"
                    ) from e2
            self.resume_s["restore"] += time.monotonic() - t1
        if self.infer is not None:
            # a commit written with kalman off has no extra: the engine
            # starts cold and re-seeds from the replayed stream
            data = self.ckpt.load_extra("infer")
            if data is not None:
                self.infer.restore(data, self._intern_v)
                log.info("restored inference entity table: %d entities",
                         self.infer.table.occupancy)

    def _restore_resized(self, view, st: TileState,
                         snap_shards: int | None) -> None:
        if snap_shards is None:
            raise ValueError(
                "checkpoint does not record its shard count; only an "
                "exact-shape restore is safe")
        snap_cap = st.key_hi.shape[0]
        if snap_cap > view.capacity_per_shard:
            self.multi.grow(snap_cap)  # capacity is shared across pairs
            view.restore(st)
        else:
            view.restore(st, pad=True)

    def _checkpoint(self) -> None:
        """Commit offsets and state: flush the ring (the commit must cover
        every batch its offset covers), take a device copy of each slab
        here, then copy to the host and write on a background thread.
        Skipped while the last dispatched batch left rows of its poll
        carried: the commit would cover rows not folded yet, and the
        slices already folded would fold twice on replay."""
        if self._carried_last:
            return
        self.flush_pending("checkpoint")
        self._ckpt_join()  # one commit in flight at a time
        t0 = time.monotonic()
        snaps = {pair: view.device_snapshot()
                 for pair, view in self.aggs.items()}
        ready = None
        if self._ckpt_stream is not None:
            # the commit thread copies after this event, on its own
            # stream: not behind the folds enqueued after the capture
            ready = torch.cuda.Event()
            ready.record()
        offset, epoch, max_ts = (self._offsets_dispatched, self.epoch,
                                 self.max_event_ts)
        # the entity table is captured here, on the step thread: it must
        # cover exactly the batches the offsets cover, and the next
        # batch's fold would change it under the commit thread
        extras = None
        if self.infer is not None:
            extras = {"infer": self.infer.snapshot()}
            # the pending scorecards ride the same commit: torn, a resume
            # would double-count or lose cards
            if self.quality is not None:
                extras["quality"] = self.quality.snapshot_extra()
        rec = {"epoch": epoch, "capture_ms": (time.monotonic() - t0) * 1e3}
        self.commits.append(rec)

        def commit():
            t1 = time.monotonic()
            try:
                # writes queued before the capture must be durable before
                # the offsets move; later writes draining too is harmless
                # (idempotent upserts)
                self.writer.drain()
                if ready is not None:
                    with torch.cuda.stream(self._ckpt_stream):
                        self._ckpt_stream.wait_event(ready)
                        states = {k: to_host(s) for k, s in snaps.items()}
                else:
                    states = {k: to_host(s) for k, s in snaps.items()}
                self.ckpt.commit(offset, max_ts, epoch, states,
                                 shards=self.multi.n_shards,
                                 snap_impl=self.snap_impl, extras=extras)
                rec["background_s"] = time.monotonic() - t1
                rec["bytes"] = _dir_bytes(self.ckpt._commit_dir(epoch))
                self.telemetry.count("checkpoints")
            except BaseException as e:  # surfaced on the step thread
                self._ckpt_err = e

        self._ckpt_thread = threading.Thread(target=commit,
                                             name="ckpt-commit", daemon=True)
        self._ckpt_thread.start()

    def _ckpt_join(self, raise_errors: bool = True) -> None:
        """Wait for the commit in flight; raise its error here."""
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None
        if self._ckpt_err is not None:
            err, self._ckpt_err = self._ckpt_err, None
            if raise_errors:
                raise RuntimeError("async checkpoint commit failed") from err
            log.error("async checkpoint commit failed", exc_info=err)

    # ------------------------------------------------------------------
    def _read_fold_events(self, wait: bool) -> None:
        """Move the device fold times of finished batches into
        ``span_ms["device_fold"]``; with ``wait``, wait for all."""
        while self._fold_events and (wait or self._fold_events[0][1].query()):
            start, end = self._fold_events.pop(0)
            end.synchronize()
            self.span_ms["device_fold"].append(start.elapsed_time(end))

    @property
    def counters(self) -> dict:
        """The run's event counters under the port's names (batches and
        events_polled of this runtime's batches; the rest read from
        ``telemetry``, ``state_overflow`` being the reference's
        ``state_overflow_groups``)."""
        c = self.telemetry.counters
        out = {"batches": self._n_batches, "events_polled": self._n_polled}
        for k in ("events_valid", "events_late", "events_invalid",
                  "tiles_emitted", "positions_emitted"):
            out[k] = c[k]
        out["state_overflow"] = c["state_overflow_groups"]
        out["state_grown"] = c["state_grown"]
        out["checkpoints"] = c["checkpoints"]
        for k in ("state_overflow_last_epoch", "infer_events_folded",
                  "infer_entities_untracked", "events_out_of_shard"):
            if k in c:
                out[k] = c[k]
        return out

    @property
    def metrics(self) -> dict:
        """Counters (the source's transport counters and the writer's
        merged in), emit pulls, slab capacity, commits, and the median
        batch wall time and spans (ms)."""
        self._read_fold_events(wait=True)
        p50 = lambda xs: float(np.median(xs)) if xs else None
        out = dict(self.counters)
        out.update(self.source.counters)
        out.update(self.writer.counters)
        out["pulls"] = dict(self.pulls)
        out["capacity"] = self.multi.capacity_per_shard
        out["commits"] = [dict(c) for c in self.commits]
        out["p50_batch_ms"] = p50(self.batch_ms)
        out["p50_span_ms"] = {k: p50(v) for k, v in self.span_ms.items()}
        return out

    def _publish_snapshot(self) -> None:
        """Publish ``telemetry.snapshot()`` (the reference's
        ``Metrics.snapshot()`` keys) for readers on other threads."""
        snap = self.telemetry.snapshot()
        with self._snap_lock:
            self._snapshot = snap

    def metrics_snapshot(self) -> dict:
        """The last published metrics snapshot (a copy): safe from any
        thread, never waits on the device."""
        with self._snap_lock:
            return dict(self._snapshot)

    def _cutoff(self) -> int:
        return (self.max_event_ts - self.cfg.watermark_minutes * 60
                if self.max_event_ts > I32_MIN else I32_MIN)

    def _build_batch(self, polled) -> EventColumns | None:
        """A poll's result as columns: event dicts are parsed with the
        reference's validation (persistent intern maps), and the rejects
        of either form count as ``events_invalid``; None when no valid
        event is left."""
        if isinstance(polled, EventColumns):
            cols = polled
        else:
            if not polled:
                return None
            cols = parse_events(polled, self._intern_p, self._intern_v)
        self.telemetry.drop("invalid", cols.n_dropped)
        if self.audit is not None and (len(cols) or cols.n_dropped):
            # the ledger's feed side: rows polled = rows kept + parse
            # drops (a carried remainder was counted at its own poll)
            self.audit.add("polled", len(cols) + cols.n_dropped)
        return cols if len(cols) else None

    def _next_batch(self) -> _FeedBatch | None:
        """The next batch: the carried rows of the last poll, else a fresh
        poll, its rows past the batch carried; padded to the feed shape in
        fresh host buffers (with the host snap's keys on the native route)
        and its copies to the device started.  None on a poll with no
        valid event.  On CUDA the buffers are pinned, from PyTorch's
        caching host allocator (which hands a buffer out again only once
        its copy has finished), and the copies run on the side stream:
        the fold's stream waits on ``ready`` when the batch is
        dispatched."""
        t0 = time.monotonic()
        src_spans = {}
        wm_ts = shard_cells = None
        if self._carry_cols is not None:
            # the carried rows bill their wait since the original poll as
            # lineage queue time
            cols, self._carry_cols = self._carry_cols, None
            shard_cells, self._carry_shard_cells = \
                self._carry_shard_cells, None
            t_polled = self._carry_polled_at
        else:
            polled = self.source.poll(
                self._feed_batch * self._shard_oversample)
            src_spans = self.source.take_spans()
            cols = self._build_batch(polled)
            t_polled = self.lineage.clock()
            if cols is None:
                return None
            if self.shardmap is not None:
                # the ownership filter: foreign rows drop here, before the
                # pad, under a closed reason; the watermark still
                # advances from the rows before it (wm_ts), so the cutoff
                # sequence is the unsharded fold's.  A batch of foreign
                # rows only still dispatches, empty: the offsets advance
                # and the dispatch count matches the unsharded run's
                t_f = time.monotonic()
                wm_ts = cols.ts_s
                cols, n_foreign, shard_cells = \
                    self.shardmap.filter_columns(cols)
                if n_foreign:
                    self.telemetry.drop(
                        "oversample" if self._shard_oversample > 1
                        else "out_of_shard", n_foreign)
                src_spans["shard_filter"] = time.monotonic() - t_f
        size = self._feed_batch
        if len(cols) > size:
            self._carry_cols = slice_columns(cols, size, len(cols))
            if shard_cells is not None:
                self._carry_shard_cells = shard_cells[size:]
                shard_cells = shard_cells[:size]
            self._carry_polled_at = t_polled
            cols = slice_columns(cols, 0, size)
        n = len(cols)
        # offsets as of this poll: committed once the batch is dispatched
        # and no row of the poll is carried any more
        offset = self.source.offset()
        # the freshness lineage opens at poll time over the event-time
        # extrema of the rows this batch dispatches; clock-skew poison
        # rows (far-future timestamps) are left out of them, as the fold
        # drops them
        ts_col = cols.ts_s
        sane = ts_col.astype(np.int64) <= int(t_polled) + 3600
        lin = None
        if sane.any():
            tv = ts_col if sane.all() else ts_col[sane]
            lin = self.lineage.open(
                n_events=n, ev_min_ts=int(tv.min()),
                ev_max_ts=int(tv.max()), ev_mean_ts=float(tv.mean()),
                offset=offset, t_poll=t_polled)
        t1 = time.monotonic()
        pin = self._copy_stream is not None
        host = {}
        for name, arr, dtype in (
                ("lat", cols.lat_rad, torch.float32),
                ("lng", cols.lng_rad, torch.float32),
                ("speed", cols.speed_kmh, torch.float32),
                ("ts", cols.ts_s, torch.int32)):
            buf = torch.empty(size, dtype=dtype, pin_memory=pin)
            a = buf.numpy()
            a[:n] = arr
            a[n:] = 0
            host[name] = buf
        host["valid"] = torch.zeros(size, dtype=torch.bool, pin_memory=pin)
        host["valid"].numpy()[:n] = True
        t_pad = time.monotonic()
        snap_s = 0.0
        if self._host_snap is not None:
            # only the live prefix is snapped; the padding keys are masked
            # by the fold's valid lane
            t_snap = time.monotonic()
            for res in self.multi._uniq_res:
                if (shard_cells is not None
                        and res == self.shardmap.snap_res):
                    # the ownership filter's host cells are this
                    # resolution's keys: no second snap
                    hi = (shard_cells >> np.uint64(32)).astype(np.uint32)
                    lo = shard_cells.astype(np.uint32)
                else:
                    hi, lo = self._host_snap.snap(cols.lat_rad,
                                                  cols.lng_rad, res)
                for name, words in (("hi", hi), ("lo", lo)):
                    buf = torch.zeros(size, dtype=torch.int32,
                                      pin_memory=pin)
                    buf.numpy()[:n] = words.view(np.int32)
                    host[f"{name}{res}"] = buf
            snap_s = time.monotonic() - t_snap
        feed, ready = host, None
        t_xfer = time.monotonic()
        if pin:
            with torch.cuda.stream(self._copy_stream):
                feed = {k: v.to(self.device, non_blocking=True)
                        for k, v in host.items()}
                ready = torch.cuda.Event()
                ready.record()
        t2 = time.monotonic()
        spans = {**src_spans, "poll": t1 - t0, "feed": t2 - t1,
                 "pad": t_pad - t1, "transfer": t2 - t_xfer}
        if self._host_snap is not None:
            spans["snap"] = snap_s
        return _FeedBatch(cols=cols, n=n, feed=feed, host=host,
                          ready=ready, offset=offset,
                          carried=self._carry_cols is not None, spans=spans,
                          lineage=lin, wm_ts=wm_ts)

    def _host_batch_max_ts(self, ts_s: np.ndarray) -> int:
        """Watermark advance for one batch, computed on the host with the
        device fold's late/future masks (engine.step._drop_and_evict, its
        int32 wrap included), as the reference's runtime does.  A row
        counts only if some pair's masks keep it, so this never counts
        more than the device; the flush maxes in the device's value."""
        if ts_s.size == 0 or int(ts_s.max()) <= self.max_event_ts:
            return I32_MIN          # nothing can advance the watermark
        cutoff = self._cutoff()
        cand = ts_s[ts_s > self.max_event_ts].astype(np.int64)
        best = I32_MIN
        for win in self._uniq_windows:
            ws = (cand // win) * win
            keep = _wrap32(ws + win) > cutoff            # not late
            if FUTURE_WINDOWS and cutoff > I32_MIN:
                keep &= _wrap32(ws - cutoff) < FUTURE_WINDOWS * win
            if keep.any():
                best = max(best, int(cand[keep].max()))
        return best

    def _fold_positions(self, cols: EventColumns) -> PositionRows | None:
        """Latest position per vehicle, monotonic in ts: the newest row of
        each vehicle in the batch, kept if newer than the last one emitted
        for it; columnar rows for the changed vehicles (None when none).
        The reference's ``_fold_positions``: a scatter-max of the packed
        key ts * 2^shift + row index (the row index breaks equal
        timestamps toward the later row; arithmetic, not bitwise, so
        pre-1970 negative ts order correctly) instead of a sort."""
        if not len(cols):
            return None
        vid = cols.vehicle_id
        n = len(vid)
        shift = max(20, int(n - 1).bit_length())
        key = cols.ts_s.astype(np.int64) * (1 << shift) + np.arange(n)
        # grow the persistent per-vehicle last-ts table to cover new ids
        need = int(vid.max()) + 1
        if need > len(self._pos_ts):
            grown = np.full(max(need, 2 * len(self._pos_ts)), -(2**62),
                            np.int64)
            grown[:len(self._pos_ts)] = self._pos_ts
            self._pos_ts = grown
        # persistent scatter buffer, reset only at this batch's ids so the
        # fold stays O(batch) however many vehicles are known
        if self._pos_win is None or len(self._pos_win) < len(self._pos_ts):
            self._pos_win = np.empty(len(self._pos_ts), np.int64)
        self._pos_win[vid] = -(2**62)     # below any key, negatives too
        np.maximum.at(self._pos_win, vid, key)
        # row i wins iff it holds its vehicle's max key (one winner per
        # vehicle present in the batch)
        rows = np.nonzero(self._pos_win[vid] == key)[0]
        newer = cols.ts_s[rows].astype(np.int64) > self._pos_ts[vid[rows]]
        rows = rows[newer]
        if rows.size == 0:
            return None
        self._pos_ts[vid[rows]] = cols.ts_s[rows]
        providers, vehicles = cols.providers, cols.vehicles
        return PositionRows(
            lat=cols.lat_deg[rows],
            lon=cols.lng_deg[rows],
            ts_ms=cols.ts_s[rows].astype(np.int64) * 1000,
            providers=[providers[int(p)] if int(p) < len(providers) else "?"
                       for p in cols.provider_id[rows]],
            vehicles=[vehicles[int(v)] if int(v) < len(vehicles) else str(v)
                      for v in vid[rows]],
        )

    def _wm_flush_due(self) -> bool:
        """Watermark pressure: the cutoff crossed a boundary of the
        smallest window since the last flush, so closed windows may evict
        in this batch, and their final emits should reach the sink now."""
        if not len(self._ring):
            return False
        cutoff = self._cutoff()
        if cutoff == I32_MIN:
            return False
        win = self._uniq_windows[0]
        return cutoff // win > self._last_flush_cutoff // win

    def _grow_margin(self) -> int:
        """Free rows the grower keeps.  The occupancy stats lag the parked
        batches, so each parked batch adds one batch's worth of
        worst-case minting (or half the observed margin) to the base
        rule: worst = 2x batch; observed = 4x the largest per-batch
        minting seen, floored at batch/8."""
        pend = len(self._ring)
        if self.cfg.grow_margin == "observed":
            base = max(4 * self._mint_peak, self.cfg.batch_size // 8)
        else:
            base = 2 * self.cfg.batch_size
        return base * (pend + 2) // 2

    def _grow_would_trigger(self) -> bool:
        """The growth inequality on the current (possibly ring-stale)
        stats: when true, flush first (fresh stats), then _maybe_grow."""
        return (self._n_active_peak + self._grow_margin()
                > self.multi.capacity_per_shard)

    def _maybe_grow(self) -> None:
        """Grow the slabs BEFORE they can overflow: keep the margin free,
        doubling up to the ceiling.  Runs right after a flush, so no
        parked emit straddles the emit-capacity change."""
        cap = self.multi.capacity_per_shard
        margin = self._grow_margin()
        peak = self._n_active_peak
        if peak + margin <= cap:
            return
        new_cap = cap
        while peak + margin > new_cap and new_cap < self._cap_max:
            new_cap *= 2
        if new_cap == cap:
            return  # at the ceiling; the overflow accounting stands guard
        if len(self._ring):
            raise RuntimeError("slab growth with emits parked in the ring")
        t0 = time.monotonic()
        self.multi.grow(new_cap)
        self.telemetry.count("state_grown")
        self.telemetry.counters["state_capacity_per_shard"] = new_cap
        self._g_capacity.set(new_cap)
        log.warning("state slabs grown 2^%d -> 2^%d rows (%d live groups; "
                    "%.2fs)", cap.bit_length() - 1, new_cap.bit_length() - 1,
                    peak, time.monotonic() - t0)

    def flush_pending(self, reason: str = "close") -> tuple[float, float]:
        """Pull and account every batch parked in the emit ring, in order:
        one pull for up to K batches.  ``reason`` names the trigger (full,
        watermark, grow, checkpoint, idle, close, govern: a flush-K
        change).  Returns the seconds
        spent pulling and handing the rows to the writer."""
        if self.writer.poisoned:
            # the writer dropped a write of an earlier flush, whose batches
            # the state and the dispatched offsets cover: nothing may flush
            # or commit again
            raise RuntimeError(
                "an earlier flush lost parked batches before the sink; "
                "restart from the last checkpoint") from self.writer._exc
        if not len(self._ring):
            return 0.0, 0.0
        t0 = time.monotonic()
        flushed = self._ring.flush_stacked(self._prefix_pull)
        t1 = time.monotonic()
        self.last_flush = flushed
        self.pulls["flushes"] += 1
        self.pulls[reason] += 1
        self.pulls["batches"] += len(flushed)
        residency = self._ring.last_flush_residency
        batch_max = I32_MIN
        for i, (bufs, epoch) in enumerate(flushed):
            bm = I32_MIN
            for idx, pair in enumerate(self.pairs):
                bm = max(bm, self._account(pair, bufs[idx], epoch))
            self.pulls["bytes"] += sum(b.nbytes for b in bufs)
            if bm > I32_MIN:
                # freshness at the emit boundary: wall clock minus the
                # batch's newest event time
                self.telemetry.freshness.add(time.time() - bm)
                batch_max = max(batch_max, bm)
            self._note_flushed(
                epoch, residency[i] if i < len(residency) else None)
        self.telemetry.count("emit_pulls", 1)
        self.telemetry.count("emit_pull_batches", len(flushed))
        # the device's own batch_max_ts heals any undercount of the host's
        self.max_event_ts = max(self.max_event_ts, batch_max)
        if self.max_event_ts > I32_MIN:
            self._g_watermark.set(time.time() - self.max_event_ts)
        self._last_flush_cutoff = self._cutoff()
        return t1 - t0, time.monotonic() - t1

    def _note_flushed(self, epoch: int, residency) -> None:
        """A flushed batch's emit-ring residency and its lineage flush
        stamp, then a sink-commit mark: the record closes on the writer
        thread once every write of the batch has been applied."""
        if residency is not None:
            self.telemetry.ring_residency.observe(residency[0])
            self.telemetry.ring_residency_batches.observe(residency[1])
        rec = self._lineage_open.pop(epoch, None)
        if rec is None:
            return
        self.lineage.flushed(
            rec, ring_batches=residency[1] if residency else None)
        self.writer.submit_mark(lambda: self._lineage_commit(rec))

    def _lineage_commit(self, rec: dict) -> None:
        """The sink-commit ack, on the writer thread: close the lineage
        record, observe the event ages and, the view having applied the
        batch before this mark, stamp its ``view_apply``."""
        rec = self.lineage.committed(rec)
        for bound, age in rec["age_s"].items():
            self.telemetry.event_age.labels(bound=bound).observe(age)
        view = self.writer.view
        if view is not None and not view.poisoned:
            self.lineage.view_applied(rec,
                                      view_seq=self.writer.last_view_seq)
        self._publish_child_freshness()

    def _publish_child_freshness(self) -> None:
        """The per-child freshness summary beside the supervisor channel
        (obs.xproc ``<channel>.fresh-<tag>``), when one is attached:
        rate-limited to 1/s, on the writer thread, so the step loop pays
        nothing."""
        from heatmap_tpu_torch.obs.xproc import (ENV_CHANNEL,
                                                 publish_child_freshness)

        path = os.environ.get(ENV_CHANNEL)
        if not path:
            return
        now = time.monotonic()
        if now - self._fresh_pub_last < 1.0:
            return
        self._fresh_pub_last = now
        publish_child_freshness(path, self._fresh_tag,
                                self.telemetry.freshness_summary())

    def _publish_member_snapshot(self, force: bool = False,
                                 left: bool = False) -> None:
        """This member's snapshot beside the supervisor channel (obs.xproc
        ``<channel>.member-<tag>``, role ``runtime``): the registry's
        exposition, the freshness summary, the /healthz verdict, a compact
        lineage tail and the audit, history, inference and quality
        blocks, which the fleet aggregator (obs.fleet) federates.  At most
        every ``HEATMAP_FLEET_PUBLISH_S`` (default 2 s; 0 disables) unless
        ``force``; ``left`` marks a departure tombstone (a clean close).
        Runs on the step loop, guarded: telemetry never takes the
        pipeline down."""
        from heatmap_tpu_torch.obs.xproc import (ENV_CHANNEL,
                                                 fleet_publish_s,
                                                 publish_member_snapshot)

        path = os.environ.get(ENV_CHANNEL)
        if not path:
            return
        interval = fleet_publish_s()
        if interval <= 0:
            return
        now = time.monotonic()
        if not force and now - self._member_pub_last < interval:
            return
        self._member_pub_last = now
        try:
            from heatmap_tpu_torch.obs.fleet import compact_lineage
            from heatmap_tpu_torch.serve.api import healthz_payload

            extra = dict(self.writer.counters)
            extra.pop("sink_retries", None)  # a registry series already
            extra.update(getattr(self.source, "counters", None) or {})
            publish_member_snapshot(
                path, self._fresh_tag, role="runtime",
                metrics_text=self.telemetry.expose_text(
                    extra_counters=extra),
                freshness=self.telemetry.freshness_summary(),
                healthz=healthz_payload(self)[0],
                lineage=compact_lineage(self.lineage.tail(16)),
                audit=(self.audit.member_block()
                       if self.audit is not None else None),
                hist=(self.hist_compactor.member_block()
                      if self.hist_compactor is not None else None),
                infer=(self.infer.member_block()
                       if self.infer is not None else None),
                quality=(self.quality.member_block()
                         if self.quality is not None else None),
                left=left)
        except Exception:  # noqa: BLE001 - never kill the step loop
            log.warning("fleet member snapshot publish failed",
                        exc_info=True)

    # ------------------------------------------------------- shard fleet
    def _effective_max_ts(self) -> int:
        """The event-time high watermark the fold's cutoff derives from.

        Unsharded and channel-less runs: this process's ``max_event_ts``.
        A shard with a supervisor channel: its own max bounded by the
        fleet's low watermark, the min over every fresh peer's published
        watermark (``obs.xproc.shard_watermarks_from``, read at most 1/s),
        so no shard closes a window a straggling peer still folds into; a
        peer whose file goes stale past ``HEATMAP_FLEET_MAX_AGE_S`` drops
        out of the bound.  Monotone: alignment only holds a cutoff back,
        never rolls it back (a peer resumed from an older checkpoint
        republishes an older watermark; without the clamp this shard
        would re-admit rows into windows it already evicted, and their
        partial counts would upsert over complete tile docs)."""
        own = self.max_event_ts
        if self.shardmap is None or own <= I32_MIN:
            return own
        from heatmap_tpu_torch.obs.xproc import (ENV_CHANNEL,
                                                 shard_watermarks_from)

        path = os.environ.get(ENV_CHANNEL)
        if not path:
            return own
        now = time.monotonic()
        if now - self._shard_wm_read_last >= 1.0:
            self._shard_wm_read_last = now
            wms = shard_watermarks_from(path)
            wms.pop(self._fresh_tag, None)  # own max is live, not a file
            self._shard_wm_floor = min(wms.values()) if wms else None
        floor = self._shard_wm_floor
        eff = own if floor is None else min(own, int(floor))
        eff = max(eff, self._shard_wm_eff_last)
        self._shard_wm_eff_last = eff
        if self._g_shard_wm_lag is not None:
            self._g_shard_wm_lag.set(max(0, own - eff))
        return eff

    def _publish_shard_watermark(self) -> None:
        """Publish this shard's own high watermark beside the channel (at
        most 1/s) so peers can hold their cutoffs at the fleet's low
        bound; nothing without a channel or when unsharded."""
        if self.shardmap is None or self.max_event_ts <= I32_MIN:
            return
        from heatmap_tpu_torch.obs.xproc import (ENV_CHANNEL,
                                                 publish_shard_watermark)

        path = os.environ.get(ENV_CHANNEL)
        if not path:
            return
        now = time.monotonic()
        if now - self._shard_wm_pub_last < 1.0:
            return
        self._shard_wm_pub_last = now
        publish_shard_watermark(path, self._fresh_tag, self.max_event_ts)

    # ---------------------------------------------------------- governor
    def _warm_ladder(self, ladder) -> None:
        """Dispatch the fold once at every governor pad bucket, before
        the first batch: one all-invalid batch a bucket through the
        instrumented step, its results thrown away.  Every row masked
        invalid makes the fold an identity on the state (no key mints,
        nothing emits, cutoff I32_MIN evicts nothing), and the ring, the
        epoch and the offsets are not touched.  Eager PyTorch has no
        per-shape program to compile; the dispatches build the kernel
        libraries the fold loads and let the caching allocator and the
        pinned staging see each shape before the governor moves."""
        t0 = time.monotonic()
        for n in ladder:
            zf = torch.zeros(n, dtype=torch.float32, device=self.device)
            ts = torch.zeros(n, dtype=torch.int32, device=self.device)
            valid = torch.zeros(n, dtype=torch.bool, device=self.device)
            prekeys = None
            if self._host_snap is not None:
                z = torch.zeros(n, dtype=torch.int32, device=self.device)
                prekeys = {r: (z, z) for r in self.multi._uniq_res}
            self.multi.step_packed_all(zf, zf, zf, ts, valid, I32_MIN,
                                       prekeys=prekeys)
        log.info("governor bucket ladder warmed: %s rows (%.2fs)",
                 ladder, time.monotonic() - t0)

    def _govern_step(self) -> None:
        """Apply the governor's decisions at a step boundary: the feed
        reads ``_feed_batch`` at each poll (each entry keeps its own
        offset, so commits stay dispatch-aligned across size changes); a
        flush-K change flushes the ring first, so its entries drain
        under the old interval; the prefetch refill reads
        ``_prefetch_n``."""
        gov = self.governor
        gov.check_retrace()
        gov.decide()
        self._feed_batch = gov.batch_rows
        k = gov.flush_k
        if k != self._ring.capacity:
            self.flush_pending("govern")
            self._ring.capacity = max(1, int(k))
        self._prefetch_n = gov.prefetch

    # --------------------------------------------------------- heartbeat
    def _touch_heartbeat(self) -> None:
        """The supervisor's liveness beacon (stream.supervisor): write
        the wall time into ``HEATMAP_HEARTBEAT_FILE`` at most once a
        second, from the step loop, so a wedged device op stops it.  The
        first write starts the in-flight watchdog, which keeps the
        beacon alive through a long step for up to
        ``HEATMAP_DISPATCH_GRACE_S`` (default 300 s); before the first
        completed step the supervisor's startup grace applies."""
        path = os.environ.get("HEATMAP_HEARTBEAT_FILE")
        if not path:
            return
        now = time.monotonic()
        if now - self._hb_last < 1.0:
            return
        self._hb_last = now
        self._hb_write(path)
        if self._hb_watchdog is None:
            self._hb_stop = threading.Event()
            self._hb_watchdog = threading.Thread(
                target=self._hb_watchdog_loop, args=(path,),
                name="heartbeat", daemon=True)
            self._hb_watchdog.start()

    def _hb_write(self, path: str) -> None:
        try:
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(f"{time.time():.3f} epoch={self.epoch}\n")
        except OSError:  # the beacon never takes the pipeline down
            pass

    def _hb_watchdog_loop(self, path: str) -> None:
        grace = float(os.environ.get("HEATMAP_DISPATCH_GRACE_S", "300"))
        while not self._hb_stop.wait(1.0):
            began = self._step_began
            if began is not None and time.monotonic() - began < grace:
                self._hb_write(path)

    def step_once(self) -> bool:
        """Fold one batch (the prefetched one, else a fresh poll); False
        when the source had nothing (an idle poll, which flushes the
        parked batches).  Runs inside the profiler window's batch, and
        samples device memory at 1 Hz."""
        self._step_began = time.monotonic()
        try:
            with self.tracer.batch(self.epoch):
                return self._step_once_inner()
        finally:
            self._step_began = None
            self.runtimeinfo.memory.sample(min_interval_s=1.0)

    def _step_once_inner(self) -> bool:
        t0 = time.monotonic()
        if self.governor is not None:
            # the control step and its decisions at the step boundary:
            # the poll below reads the (possibly resized) bucket
            self._govern_step()
        entry = (self._prefetched.popleft() if self._prefetched
                 else self._next_batch())
        if entry is None:
            self.flush_pending("idle")
            if self.governor is not None:
                self.governor.note_idle()
            self._publish_snapshot()
            return False
        pull_s = sink_s = 0.0
        grow_due = self._grow_would_trigger()
        reason = ("full" if self._ring.full
                  else "watermark" if self._wm_flush_due()
                  else "grow" if grow_due else None)
        if reason is not None:
            if grow_due and self.governor is not None:
                # the growth-pressure flush steps the governor's flush-K
                # down: parked batches held unaccounted minting
                self.governor.note_growth_pressure()
            pull_s, sink_s = self.flush_pending(reason)
            self._maybe_grow()
        wm_max = self._effective_max_ts()
        cutoff = (wm_max - self.cfg.watermark_minutes * 60
                  if wm_max > I32_MIN else I32_MIN)
        infer_s = None
        if self.infer is not None:
            # after the ring flush, before the dispatch, as in the
            # reference: the flushed docs carry the velocity of the batches
            # before this one
            t_inf = time.monotonic()
            self.infer.fold_batch(entry.cols)
            ievents = self.infer.drain_anomalies()
            if ievents and self.matview is not None:
                # anomaly records ride the writer thread like every view
                # mutation (single-writer discipline), after the tile
                # writes handed over before them
                grid = self.cfg.default_grid()
                view = self.matview
                self.writer.submit_mark(
                    lambda: view.publish_anomalies(grid, ievents))
            infer_s = time.monotonic() - t_inf
        t2 = time.monotonic()
        feed = entry.feed
        if entry.ready is not None:
            # the fold's stream waits for the batch's copies, and the
            # allocator keeps its buffers until the fold is done with them
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(entry.ready)
            for t in feed.values():
                t.record_stream(cur)
        events = None
        if self.time_device_fold and self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        prekeys = None
        if self._host_snap is not None:
            prekeys = {res: (feed[f"hi{res}"], feed[f"lo{res}"])
                       for res in self.multi._uniq_res}
        lin = entry.lineage
        if lin is not None:
            # the batch leaves the prefetch queue and enters the fold
            self.lineage.dispatched(lin, self.epoch)
        wait0 = step._read_flags.wait_s
        packed = self.multi.step_packed_all(
            feed["lat"], feed["lng"], feed["speed"], feed["ts"],
            feed["valid"], cutoff, prekeys=prekeys)
        predicate_s = step._read_flags.wait_s - wait0
        if events is not None:
            events[1].record()
        self._ring.append(packed, self.epoch)
        if self.governor is not None:
            self.governor.note_dispatch(entry.n)
        if self.audit is not None and entry.n:
            # rows entering the fold; its counts arrive with the flush,
            # so the gap between reads as a draining residual
            self.audit.add("dispatched", entry.n)
        if lin is not None:
            self.lineage.ring_entered(lin)
            self._lineage_open[self.epoch] = lin
        self._carried_last = entry.carried
        if not entry.carried:
            # offsets advance only once every row of the poll is
            # dispatched; the entry's own snapshot, since the prefetch may
            # have polled further ahead
            self._offsets_dispatched = entry.offset
        t3 = time.monotonic()
        # host-side watermark advance: the next batch's cutoff, whatever
        # K; a shard advances from its poll before the ownership filter
        bm = self._host_batch_max_ts(
            entry.wm_ts if entry.wm_ts is not None else entry.cols.ts_s)
        if bm > self.max_event_ts:
            if (self.max_event_ts == I32_MIN
                    and self._last_flush_cutoff == I32_MIN):
                # first activation: seed the pressure tracker so that
                # _wm_flush_due measures window-boundary crossings, not
                # the jump from "no watermark yet"
                self._last_flush_cutoff = (
                    bm - self.cfg.watermark_minutes * 60)
            self.max_event_ts = bm
            self._g_watermark.set(time.time() - bm)
        self._publish_shard_watermark()
        t_pos = time.monotonic()
        if self.positions_enabled:
            prows = self._fold_positions(entry.cols)
            if prows is not None:
                self.writer.submit_positions_packed(prows)
                self.telemetry.count("positions_emitted", len(prows.ts_ms))
        self.epoch += 1
        self._n_batches += 1
        self._n_polled += entry.n
        t4 = time.monotonic()
        # refill the prefetch queue AFTER the dispatch: the next batch's
        # poll, pad and copy run while the device folds this one
        while (not self._closing
               and len(self._prefetched) < self._prefetch_n):
            nxt = self._next_batch()
            if nxt is None:
                break
            self._prefetched.append(nxt)
        t5 = time.monotonic()
        self._observe_batch(entry, t5 - t0, pull_s + sink_s, infer_s,
                            t_pos - t2, t4 - t_pos, t5 - t4)
        if self.checkpoint_every and self.epoch % self.checkpoint_every == 0:
            # a cadence hit while carrying holds the commit until the
            # first carry-free step: a fixed record-to-batch size ratio
            # could otherwise keep every cadence epoch mid-carry
            self._ckpt_due = True
        if self._ckpt_due and not self._carried_last:
            self._ckpt_due = False
            self._checkpoint()
        t6 = time.monotonic()
        for name in ("fetch", "decode", "snap", "wait", "copy"):
            if name in entry.spans:
                self.span_ms[name].append(entry.spans[name] * 1e3)
        if infer_s is not None:
            self.span_ms["infer"].append(infer_s * 1e3)
        for name, dt in (("poll", entry.spans["poll"]),
                         ("feed", entry.spans["feed"]),
                         ("pull", pull_s), ("sink", sink_s),
                         ("dispatch", t3 - t2 - predicate_s),
                         ("predicate", predicate_s),
                         ("positions", t4 - t_pos),
                         ("prefetch", t5 - t4), ("checkpoint", t6 - t5)):
            self.span_ms[name].append(dt * 1e3)
        if events is not None:
            # read once the device is done, without waiting for it here
            self._fold_events.append(events)
            self._read_fold_events(wait=False)
        self.batch_ms.append((t6 - t0) * 1e3)
        self._publish_snapshot()
        return True

    def _observe_batch(self, entry: _FeedBatch, latency_s: float,
                       pull_s: float, infer_s: float | None,
                       device_s: float, sink_s: float,
                       prefetch_s: float) -> None:
        """The batch's spans under the reference's names and boundaries
        into the registry, and its trace record.  ``latency_s`` runs from
        the step's start to the end of its prefetch (the checkpoint after
        it is not in the batch, as in the reference); ``device`` is the
        dispatch with the host watermark advance, ``sink_submit`` the
        positions fold and its hand-off; ``pull`` the whole flush before
        the fold."""
        es = entry.spans
        spans = {
            "poll": es["poll"],
            "build": es["pad"] + es["transfer"],
            "pad": es["pad"],
            "transfer": es["transfer"],
            "pull": pull_s,
            "snap": es.get("snap", 0.0),
            "device": device_s,
            "sink_submit": sink_s,
            "prefetch": prefetch_s,
        }
        for k in ("fetch", "decode", "wait"):
            if k in es:
                spans[f"poll_{k}"] = es[k]
        if "shard_filter" in es:
            spans["shard_filter"] = es["shard_filter"]
        if infer_s is not None:
            spans["infer"] = infer_s
        self.telemetry.observe_batch(latency_s, spans)
        # late and overflow counts arrive up to K batches behind (at the
        # flush), so the record carries the change since the last one
        c = self.telemetry.counters
        cum = (c["events_late"], c["state_overflow_groups"],
               c["events_bucket_dropped"])
        last, self._trace_cum = self._trace_cum, cum
        self.tracering.record(
            self.epoch - 1, latency_s, spans, n_events=entry.n,
            n_late=cum[0] - last[0], overflow_groups=cum[1] - last[1],
            late_dropped=cum[2] - last[2])

    def _account(self, pair, packed_pair: np.ndarray, epoch: int) -> int:
        """Sink one pair's emit rows and book its stats (overflow policy,
        occupancy and minting peaks); returns its batch_max_ts."""
        stats = stats_from_packed(packed_pair)
        body = packed_pair[1:]
        n_docs = int(np.count_nonzero(
            (body[:, 8] != 0) & (body[:, 3].view(np.int32) > 0)))
        vel = (self.infer.velocity_field(pair[0])
               if n_docs and self.infer is not None else None)
        if vel:
            # the Kalman reducer's per-cell velocity rides the docs as two
            # optional columns, rounded to 2 places as the reference does
            docs = packed_tile_docs(body, self._pack_meta[pair])
            for d in docs:
                v = vel.get(int(d["cellId"], 16))
                if v is not None:
                    d["vxKmh"] = round(v[0], 2)
                    d["vyKmh"] = round(v[1], 2)
            self.writer.submit_tiles(docs)
            if self.audit is not None:
                # the digest table takes the same enriched docs, so the
                # velocity columns are covered by the digests
                self.audit.add("docs_emitted", n_docs)
                self.audit.shard_table(None).apply_docs(docs)
        elif n_docs:
            self.writer.submit_tiles_packed(body, self._pack_meta[pair])
            if self.audit is not None:
                # the emit-side stamp and the fold's digest table, decoded
                # with the oracle the store and the view use, so the table
                # is exactly the docs downstream will hold
                self.audit.add("docs_emitted", n_docs)
                self.audit.shard_table(None).apply_docs(
                    packed_tile_docs(body, self._pack_meta[pair]))
        self.telemetry.count("tiles_emitted", n_docs)
        if pair == self._primary:
            self.telemetry.count("events_valid", stats.n_valid)
            # watermark-late, with the future-window poison the fold
            # drops under the same mask: a tagged drop, so the ledger's
            # identity closes: polled == folded + dropped
            self.telemetry.drop("late", stats.n_late)
            if self.audit is not None:
                self.audit.add("folded", stats.n_valid)
        else:
            self.telemetry.count(
                f"events_late_r{pair[0]}m{pair[1] // 60}", stats.n_late)
        self._n_active_peak = max(self._n_active_peak, stats.n_active)
        self._g_active.set(self._n_active_peak)
        # per-batch group minting (grow_margin=observed): the n_active
        # delta undercounts when evictions freed rows in the same batch,
        # so add them back; a pair's first observation only seeds the
        # baseline (after a restore n_active starts at the whole restored
        # population, which no single batch minted)
        prev = self._prev_active.get(pair)
        self._prev_active[pair] = stats.n_active
        if prev is not None:
            self._mint_peak = max(self._mint_peak, stats.n_active - prev
                                  + stats.n_evicted)
        ovf = stats.state_overflow
        if ovf:
            # data loss is never silent: every overflowing batch counts;
            # the log is rate-limited to once a minute
            self.telemetry.count("state_overflow_groups", ovf)
            self.telemetry.counters["state_overflow_last_epoch"] = epoch
            now = time.monotonic()
            if now - self._overflow_logged_at >= 60.0:
                self._overflow_logged_at = now
                log.error(
                    "STATE OVERFLOW: %d distinct (cell,window) groups "
                    "dropped this batch (%d total); raise "
                    "STATE_CAPACITY_LOG2 (currently 2^%d rows)", ovf,
                    self.telemetry.counters["state_overflow_groups"],
                    self.multi.capacity_per_shard.bit_length() - 1)
            if self.cfg.on_overflow == "fail":
                # no exit commit: offsets and state stay at the last good
                # checkpoint, so the lost batch replays after the operator
                # raises the capacity
                self._fatal = True
                raise StateOverflowError(
                    f"{ovf} aggregate groups dropped at state capacity "
                    f"{self.multi.capacity_per_shard} rows; raise "
                    f"STATE_CAPACITY_LOG2, or set HEATMAP_ON_OVERFLOW=error "
                    f"to keep running with the loss counted")
        return stats.batch_max_ts

    def close(self) -> None:
        """Fold the carried and prefetched batches, flush the ring, commit the exit
        checkpoint and wait for it, then close the source and the writer
        (which drains it).  After a fail-mode overflow or a poisoned
        writer, nothing is folded or committed: the last good commit
        stays, and its tail replays; a poisoned writer's close raises.

        First the watchdog stops, then the telemetry history stops its
        sampler, takes a last scrape and flushes, and the flight recorder
        dumps (before
        the drain, so the ring and prefetch depths still describe the
        incident) when the close is abnormal: a fail-mode overflow, a
        poisoned writer, or an exception unwinding through ``run()``
        (SIGTERM included, as ``stream/__main__.py`` turns it into
        ``SystemExit``); a clean close dumps only with
        ``HEATMAP_FLIGHTREC_ALWAYS=1``, else disarms it.  Then the
        profiler window is written; the trace export closes last."""
        import sys

        if self.slo_watchdog is not None:
            self.slo_watchdog.stop()
        if self.tsdb is not None:
            # one last scrape (final counters and verdict) and a forced
            # flush, so the timeline covers the run's last window; the
            # sampler is joined first, so that scrape never runs beside
            # one of its own (they would race on the SLO engine's state
            # and its slo-state.json)
            self.tsdb.stop()
            try:
                self.tsdb.scrape_once()
                self.tsdb.flush()
            except Exception:  # noqa: BLE001 - telemetry never blocks
                pass           # the teardown
        exc = sys.exc_info()[1]
        if isinstance(exc, SystemExit) and not exc.code:
            exc = None  # sys.exit(0) mid-run is a clean shutdown
        clean_close = not (self._fatal or self.writer.poisoned
                           or exc is not None)
        if self.flightrec is not None:
            if not clean_close:
                why = ("fatal state overflow" if self._fatal
                       else "poisoned sink" if self.writer.poisoned
                       else f"abnormal exit: {type(exc).__name__}: {exc}")
                self.flightrec.dump(why)
            elif os.environ.get("HEATMAP_FLIGHTREC_ALWAYS") == "1":
                self.flightrec.dump("clean close "
                                    "(HEATMAP_FLIGHTREC_ALWAYS=1)")
            else:
                self.flightrec.disarm()
        # the last member snapshot: a bounded run leaves its final counters
        # and lineage on the channel, a clean close as a departure
        # tombstone (a finished job must not read as a stale member), an
        # abnormal one as a live snapshot that goes stale
        self._publish_member_snapshot(force=True, left=clean_close)
        self.tracer.stop()  # write a partial profiler window, if any
        self._closing = True
        if self._hb_stop is not None:
            self._hb_stop.set()
        failed = lambda: self._fatal or self.writer.poisoned
        try:
            try:
                # fold the carried and prefetched rows, so the exit commit
                # covers every row the source handed out
                while ((self._carry_cols is not None or self._prefetched)
                       and not failed()):
                    self.step_once()
                if not self.writer.poisoned:
                    self.flush_pending("close")
                    self._publish_snapshot()
            finally:
                if not failed():
                    self._checkpoint()
                self._ckpt_join(raise_errors=not failed())
                self._publish_snapshot()  # the exit commit counted
        finally:
            try:
                self.source.close()
            finally:
                try:
                    self.writer.close()
                finally:
                    # AFTER the writer close: every view apply has run
                    # by now, so the final feed flush + closed-meta
                    # marker cover the run's full mutation stream even
                    # when the writer close raised (poisoned)
                    if self.repl_pub is not None:
                        self.repl_pub.close()
                    # AFTER the publisher close: its final flush may
                    # have rotated one last segment into the history
                    # log, and the compactor's closing step drains it
                    if self.hist_compactor is not None:
                        self.hist_compactor.close()
                    self.tracering.close()  # the JSONL trace export

    def run(self, max_batches: int | None = None) -> None:
        """Drive the loop until the source is exhausted (or max_batches),
        then close.  With ``trigger_ms``, a batch that progressed is
        followed by a sleep for what is left of its trigger interval, as
        in the reference."""
        trigger_s = self.cfg.trigger_ms / 1e3
        n = 0
        try:
            while max_batches is None or n < max_batches:
                t0 = time.monotonic()
                progressed = self.step_once()
                # the beacon after the step: its first write proves a
                # completed step (the kernels' first build included), so
                # the supervisor's startup grace holds until then
                self._touch_heartbeat()
                # the member snapshot rides the loop, idle polls included,
                # so a quiet stream still reads as alive at /fleet/healthz
                self._publish_member_snapshot()
                if progressed:
                    n += 1
                elif self.source.exhausted:
                    break
                else:
                    time.sleep(0.05)
                    continue
                if trigger_s:
                    dt_left = trigger_s - (time.monotonic() - t0)
                    if dt_left > 0:
                        time.sleep(dt_left)
        finally:
            self.close()
