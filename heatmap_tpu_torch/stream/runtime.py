"""Micro-batch streaming runtime (lean): source -> device fold -> store.

The counterpart of the main loop of ``heatmap_tpu/stream/runtime.py``
for one device and an emit pull every batch:

  poll -> pad into pinned host buffers -> host->device copy -> fused fold
  of every (res, window) pair (engine.multi) -> one device->host pull of
  the packed emits -> tile docs into the store.

The watermark cutoff of each batch is ``max_event_ts - watermark_minutes *
60``, with ``max_event_ts`` the largest ``batch_max_ts`` of the batches
before it, as in the reference.  Checkpoints, growth, the emit ring,
prefetch, positions and the observability stack of the reference runtime
are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from heatmap_tpu_torch.config import Config
from heatmap_tpu_torch.engine.multi import MultiAggregator, stats_from_packed
from heatmap_tpu_torch.engine.step import I32_MIN
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
        self.max_event_ts = I32_MIN
        self.counters = {"batches": 0, "events_polled": 0, "events_valid": 0,
                         "events_late": 0, "tiles_emitted": 0,
                         "state_overflow": 0}
        self.batch_ms: list[float] = []
        # per-batch spans (ms) on the host clock: poll, feed (pad + H2D
        # enqueue), dispatch (fold enqueue), pull (device wait + D2H),
        # sink; and, when time_device_fold is set on a CUDA run, the fold's
        # device time from CUDA events (off by default: two events per
        # batch that only a profiling run reads)
        self.time_device_fold = False
        self.span_ms: dict[str, list[float]] = {
            k: [] for k in ("poll", "feed", "dispatch", "pull", "sink",
                            "device_fold")}
        self.last_packed: np.ndarray | None = None  # last batch's pull
        # feed buffers, pinned on a CUDA run so the host->device copy is
        # asynchronous.  Each batch's pull synchronises the stream, so the
        # copy out of a buffer has finished before the next poll refills it
        pin = self.device.type == "cuda"
        n = cfg.batch_size
        self._host = {
            "lat": torch.empty(n, dtype=torch.float32, pin_memory=pin),
            "lng": torch.empty(n, dtype=torch.float32, pin_memory=pin),
            "speed": torch.empty(n, dtype=torch.float32, pin_memory=pin),
            "ts": torch.empty(n, dtype=torch.int32, pin_memory=pin),
            "valid": torch.empty(n, dtype=torch.bool, pin_memory=pin),
        }

    @property
    def metrics(self) -> dict:
        """Counters plus the median batch wall time and spans (ms)."""
        p50 = lambda xs: float(np.median(xs)) if xs else None
        out = dict(self.counters)
        out["p50_batch_ms"] = p50(self.batch_ms)
        out["p50_span_ms"] = {k: p50(v) for k, v in self.span_ms.items()}
        return out

    def _feed(self, cols) -> dict:
        """Pad one polled batch to the feed shape in the host buffers and
        start their copies to the device."""
        n = len(cols)
        for name, arr in (("lat", cols.lat_rad), ("lng", cols.lng_rad),
                          ("speed", cols.speed_kmh), ("ts", cols.ts_s)):
            buf = self._host[name].numpy()
            buf[:n] = arr
            buf[n:] = 0
        valid = self._host["valid"].numpy()
        valid[:n] = True
        valid[n:] = False
        return {k: v.to(self.device, non_blocking=True)
                for k, v in self._host.items()}

    def step_once(self) -> bool:
        """Fold one polled batch; False when the source had nothing."""
        t0 = time.monotonic()
        cols = self.source.poll(self.cfg.batch_size)
        n = len(cols)
        if not n:
            return False
        if n > self.cfg.batch_size:
            raise ValueError(f"source returned {n} events for a batch of "
                             f"{self.cfg.batch_size}")
        t1 = time.monotonic()
        feed = self._feed(cols)
        cutoff = (self.max_event_ts - self.cfg.watermark_minutes * 60
                  if self.max_event_ts > I32_MIN else I32_MIN)
        t2 = time.monotonic()
        events = None
        if self.time_device_fold and self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        packed = self.multi.step_packed_all(
            feed["lat"], feed["lng"], feed["speed"], feed["ts"],
            feed["valid"], cutoff)
        if events is not None:
            events[1].record()
        t3 = time.monotonic()
        host = packed.cpu().numpy().view(np.uint32)   # the one pull
        self.last_packed = host
        t4 = time.monotonic()
        batch_max = I32_MIN
        for idx, pair in enumerate(self.pairs):
            batch_max = max(batch_max, self._account(pair, host[idx]))
        self.max_event_ts = max(self.max_event_ts, batch_max)
        self.counters["batches"] += 1
        self.counters["events_polled"] += n
        t5 = time.monotonic()
        for name, dt in (("poll", t1 - t0), ("feed", t2 - t1),
                         ("dispatch", t3 - t2), ("pull", t4 - t3),
                         ("sink", t5 - t4)):
            self.span_ms[name].append(dt * 1e3)
        if events is not None:
            self.span_ms["device_fold"].append(
                events[0].elapsed_time(events[1]))
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

    def run(self, max_batches: int | None = None) -> None:
        """Drive the loop until the source is exhausted (or max_batches)."""
        n = 0
        while max_batches is None or n < max_batches:
            if self.step_once():
                n += 1
            elif self.source.exhausted:
                break
            else:
                time.sleep(0.05)
