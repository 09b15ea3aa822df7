"""Micro-batch streaming runtime (lean): source -> device fold -> store.

The counterpart of the main loop of ``heatmap_tpu/stream/runtime.py``
for one device:

  poll -> pad into pinned host buffers -> host->device copy -> fused fold
  of every (res, window) pair (engine.multi) -> the packed emits parked in
  an ``EmitRing`` on the device -> one pull of every parked batch (a live
  prefix of each on CUDA) -> tile docs into the store.

The ring is flushed when it holds ``emit_flush_k`` batches, when the
watermark cutoff crosses a boundary of the smallest window (so closing
windows reach the sink now, not up to K batches later), on an idle poll,
and at the end of a run (``close``).  The cutoff of each batch is
``max_event_ts - watermark_minutes * 60``, as in the reference; since the
device's ``batch_max_ts`` arrives only with a flush, ``max_event_ts``
advances on the host from each batch's own timestamps under the fold's
late and future masks (``_host_batch_max_ts``), and each flush maxes in
the device's value.  Docs, counters and the cutoff sequence are therefore
the same for every K.  Checkpoints, growth, prefetch, positions and the
observability stack of the reference runtime are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from heatmap_tpu_torch.config import Config
from heatmap_tpu_torch.engine import step
from heatmap_tpu_torch.engine.multi import MultiAggregator, stats_from_packed
from heatmap_tpu_torch.engine.step import FUTURE_WINDOWS, I32_MIN, EmitRing
from heatmap_tpu_torch.sink.base import Store, TilePackMeta
from heatmap_tpu_torch.stream.source import Source


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; a CUDA device without a card raises (the port
    runs on the CPU only when the caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return device


def _wrap32(x):
    """int64 -> int32 two's-complement wrap (numpy arrays)."""
    return ((x + 2**31) % 2**32) - 2**31


class MicroBatchRuntime:
    def __init__(self, cfg: Config, source: Source, store: Store,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.source = source
        self.store = store
        self.device = resolve_device(device)
        self.pairs = list(dict.fromkeys(
            (res, wmin * 60) for res in cfg.resolutions
            for wmin in cfg.windows_minutes))
        cap = 1 << cfg.state_capacity_log2
        self.multi = MultiAggregator(
            self.pairs, capacity=cap,
            emit_capacity=min(cfg.batch_size, cap),
            hist_bins=cfg.speed_hist_bins,
            speed_hist_max=cfg.speed_hist_max_kmh, device=self.device)
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
        self.max_event_ts = I32_MIN
        self._last_flush_cutoff = I32_MIN  # watermark-pressure tracking
        self._ring = EmitRing(cfg.emit_flush_k)
        self._prefix_pull = (self.device.type == "cuda"
                             if cfg.emit_pull == "auto"
                             else cfg.emit_pull == "prefix")
        self.counters = {"batches": 0, "events_polled": 0, "events_valid": 0,
                         "events_late": 0, "tiles_emitted": 0,
                         "state_overflow": 0}
        # emit pulls: flushes in all and by trigger, batches and bytes
        # pulled (these depend on K, the counters above do not)
        self.pulls = {"flushes": 0, "full": 0, "watermark": 0, "idle": 0,
                      "close": 0, "batches": 0, "bytes": 0}
        self.batch_ms: list[float] = []
        # per-batch spans (ms) on the host clock: poll, feed (pad + H2D
        # enqueue), pull and sink (a flush of the parked batches before
        # this batch's fold, device wait + D2H then the store; 0 when the
        # batch flushes nothing), dispatch (fold enqueue, the predicate
        # wait excluded), predicate (the host's wait on the fold's tier
        # predicate read, engine.step._read_flags); and, when
        # time_device_fold is set on a CUDA run, the fold's device time
        # from CUDA events (off by default: two events per batch that
        # only a profiling run reads)
        self.time_device_fold = False
        self.span_ms: dict[str, list[float]] = {
            k: [] for k in ("poll", "feed", "pull", "sink", "dispatch",
                            "predicate", "device_fold")}
        # the last flush's batches: [([host matrix per pair], batch index)]
        self.last_flush: list = []
        self._fold_events: list = []  # CUDA event pairs not yet read

    def _read_fold_events(self, wait: bool) -> None:
        """Move the device fold times of finished batches into
        ``span_ms["device_fold"]``; with ``wait``, wait for all."""
        while self._fold_events and (wait or self._fold_events[0][1].query()):
            start, end = self._fold_events.pop(0)
            end.synchronize()
            self.span_ms["device_fold"].append(start.elapsed_time(end))

    @property
    def metrics(self) -> dict:
        """Counters, emit pulls, and the median batch wall time and spans
        (ms)."""
        self._read_fold_events(wait=True)
        p50 = lambda xs: float(np.median(xs)) if xs else None
        out = dict(self.counters)
        out["pulls"] = dict(self.pulls)
        out["p50_batch_ms"] = p50(self.batch_ms)
        out["p50_span_ms"] = {k: p50(v) for k, v in self.span_ms.items()}
        return out

    def _cutoff(self) -> int:
        return (self.max_event_ts - self.cfg.watermark_minutes * 60
                if self.max_event_ts > I32_MIN else I32_MIN)

    def _feed(self, cols) -> dict:
        """Pad one polled batch to the feed shape in fresh host buffers and
        start their copies to the device.  On CUDA the buffers are pinned,
        from PyTorch's caching host allocator, which hands a buffer out
        again only once its copy has finished: no wait here."""
        n = len(cols)
        size = self.cfg.batch_size
        pin = self.device.type == "cuda"
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
        return {k: v.to(self.device, non_blocking=True)
                for k, v in host.items()}

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

    def flush_pending(self, reason: str = "close") -> tuple[float, float]:
        """Pull and account every batch parked in the emit ring, in order:
        one pull for up to K batches.  ``reason`` names the trigger (full,
        watermark, idle, close).  Returns the seconds spent pulling and
        sinking."""
        if not len(self._ring):
            return 0.0, 0.0
        t0 = time.monotonic()
        flushed = self._ring.flush_stacked(self._prefix_pull)
        t1 = time.monotonic()
        batch_max = I32_MIN
        for bufs, _tag in flushed:
            for idx, pair in enumerate(self.pairs):
                batch_max = max(batch_max, self._account(pair, bufs[idx]))
            self.pulls["bytes"] += sum(b.nbytes for b in bufs)
        self.last_flush = flushed
        self.pulls["flushes"] += 1
        self.pulls[reason] += 1
        self.pulls["batches"] += len(flushed)
        # the device's own batch_max_ts heals any undercount of the host's
        self.max_event_ts = max(self.max_event_ts, batch_max)
        self._last_flush_cutoff = self._cutoff()
        return t1 - t0, time.monotonic() - t1

    def step_once(self) -> bool:
        """Fold one polled batch; False when the source had nothing (an
        idle poll, which flushes the parked batches)."""
        t0 = time.monotonic()
        cols = self.source.poll(self.cfg.batch_size)
        n = len(cols)
        if not n:
            self.flush_pending("idle")
            return False
        if n > self.cfg.batch_size:
            raise ValueError(f"source returned {n} events for a batch of "
                             f"{self.cfg.batch_size}")
        t1 = time.monotonic()
        feed = self._feed(cols)
        t2 = time.monotonic()
        pull_s = sink_s = 0.0
        if self._ring.full:
            pull_s, sink_s = self.flush_pending("full")
        elif self._wm_flush_due():
            pull_s, sink_s = self.flush_pending("watermark")
        cutoff = self._cutoff()
        t3 = time.monotonic()
        events = None
        if self.time_device_fold and self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        wait0 = step._read_flags.wait_s
        packed = self.multi.step_packed_all(
            feed["lat"], feed["lng"], feed["speed"], feed["ts"],
            feed["valid"], cutoff)
        predicate_s = step._read_flags.wait_s - wait0
        if events is not None:
            events[1].record()
        self._ring.append(packed, self.counters["batches"])
        t4 = time.monotonic()
        # host-side watermark advance: the next batch's cutoff, whatever K
        bm = self._host_batch_max_ts(cols.ts_s)
        if bm > self.max_event_ts:
            if (self.max_event_ts == I32_MIN
                    and self._last_flush_cutoff == I32_MIN):
                # first activation: seed the pressure tracker so that
                # _wm_flush_due measures window-boundary crossings, not
                # the jump from "no watermark yet"
                self._last_flush_cutoff = (
                    bm - self.cfg.watermark_minutes * 60)
            self.max_event_ts = bm
        self.counters["batches"] += 1
        self.counters["events_polled"] += n
        t5 = time.monotonic()
        for name, dt in (("poll", t1 - t0), ("feed", t2 - t1),
                         ("pull", pull_s), ("sink", sink_s),
                         ("dispatch", t4 - t3 - predicate_s),
                         ("predicate", predicate_s)):
            self.span_ms[name].append(dt * 1e3)
        if events is not None:
            # read once the device is done, without waiting for it here
            self._fold_events.append(events)
            self._read_fold_events(wait=False)
        self.batch_ms.append((t5 - t0) * 1e3)
        return True

    def _account(self, pair, packed_pair: np.ndarray) -> int:
        """Sink one pair's emit rows and book its stats; returns its
        batch_max_ts."""
        stats = stats_from_packed(packed_pair)
        body = packed_pair[1:]
        n_docs = int(np.count_nonzero(
            (body[:, 8] != 0) & (body[:, 3].view(np.int32) > 0)))
        if n_docs:
            self.store.upsert_tiles_packed(body, self._pack_meta[pair])
        self.counters["tiles_emitted"] += n_docs
        self.counters["state_overflow"] += stats.state_overflow
        if pair == self._primary:
            self.counters["events_valid"] += stats.n_valid
            self.counters["events_late"] += stats.n_late
        return stats.batch_max_ts

    def close(self) -> None:
        """Flush the batches still parked in the emit ring."""
        self.flush_pending("close")

    def run(self, max_batches: int | None = None) -> None:
        """Drive the loop until the source is exhausted (or max_batches),
        then flush what is parked."""
        n = 0
        while max_batches is None or n < max_batches:
            if self.step_once():
                n += 1
            elif self.source.exhausted:
                break
            else:
                time.sleep(0.05)
        self.close()
