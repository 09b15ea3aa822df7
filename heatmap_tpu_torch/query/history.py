"""Space-time history tier: durable compacted log + time-travel queries.

A copy of ``heatmap_tpu/query/history.py``.  Under ``HEATMAP_AUDIT=1`` the
writer's feed records carry each touched window's ``"dg"`` digest, which
the compactor verifies against its chunks, as in the reference.

Without this tier serving is latest-only: eviction destroys every
window that ages out, and the repl segment log — an ordered,
epoch/dense-seq, byte-exact-replayable record of every tile mutation —
is deleted at rotation.  This tier stops deleting it and turns the
feed into the system's durable log of record (immutable parent-cell x
time-bucket columnar chunks; serving RANGES, not just instants):

Store layout (``HEATMAP_HIST_DIR``)::

    log/seg-<epoch>-<startseq>.jsonl    rotated repl segments, moved
                                        here (os.replace) instead of
                                        deleted — the raw log of record
    log/snap-<epoch>-<seq>.json         the feed snapshot ADOPTED at
                                        publisher boot and at every
                                        rotation — the replay bases
                                        view-at-seq reconstruction
                                        starts from
    chunks/chunk-<grid>-<parent>-<bucket>.hst
                                        immutable compacted chunks: one
                                        per (grid, H3 parent cell at
                                        HEATMAP_HIST_PARENT_RES, time
                                        bucket of HEATMAP_HIST_BUCKET_S)
    hist-state.json                     compactor watermarks, atomically
                                        rewritten AFTER a flush — the
                                        crash-safety anchor

Chunk format: line 1 is a JSON meta header (grid, parent, bucket,
chunk shape, per-window ``{digest, docs, seq, stale, verified}``),
then one length-prefixed block per window: the ``serve/wire.py``
columnar frame (byte-exact doc round-trip) plus two side columns the
serving frame deliberately omits — per-doc centroids (range rollups
need the count-weighted mean position) and per-doc 64-bit content
hashes (``obs.audit.doc_hash``), which make the window digest
incrementally recomputable across a compactor restart.

Crash-safety / zero-loss retention invariant: a raw log segment is
pruned ONLY when (1) every record in it is at or below the persisted
ingest watermark — which is advanced AFTER the chunks covering the
flush are durably written — and (2) no digest mismatch is outstanding,
and (3) the segment has aged past ``HEATMAP_HIST_RETENTION_S``.  A
crash between chunk write and state/prune re-ingests the segments on
restart; re-applying the same records over the chunk-seeded
accumulator is content-idempotent, so nothing is lost and nothing
double-counts.  Digest verification (under ``HEATMAP_AUDIT=1``): the writer
publishes its post-apply per-(grid, window) XOR digest inside feed
records (``"dg"``), and the compactor recomputes its own digest from
the accumulated cells per ingested record — compaction is verified
against the live view's books, not trusted.

Read side (:class:`HistoryReader`, served by ``serve/api.py``):
``/api/tiles/range?grid&t0&t1[&res][&fmt=bin]`` (per-window series +
pyramid-math rollup), ``/api/tiles/at?seq=`` (view-at-seq replay from
adopted snapshot + log segments, byte-identical to the live view at
that seq — differential-pinned in the tests), and
``/api/tiles/diff?t0&t1`` (day-over-day per-cell deltas).  Replicas
also cold-start BACKFILL pre-snapshot windows from chunks
(query.repl.ReplicaViewFollower), so a writer restart that shrank the
snapshot no longer silently narrows the fleet's history.

Compactor entry point::

    python -m heatmap_tpu_torch.query.history --hist DIR [--feed DIR] [--once]
"""

from __future__ import annotations

import glob
import json
import logging
import os
import struct
import threading
import time

from heatmap_tpu_torch.obs.audit import doc_hash
from heatmap_tpu_torch.obs.xproc import atomic_write_json
from heatmap_tpu_torch.query import repl as replmod
from heatmap_tpu_torch.query.pyramid import cell_to_parent

log = logging.getLogger(__name__)

STATE = "hist-state.json"
LOG_DIR = "log"
CHUNK_DIR = "chunks"

_BLOCK_WIRE = 0   # window block payload is a serve/wire.py frame
_BLOCK_JSON = 1   # fallback: repl-codec JSON docs (unrepresentable doc)

RES_SHIFT = 52


def _cell_parent_key(cid: str, parent_res: int) -> int:
    """Chunk partition key for one cellId: its H3 parent at
    ``parent_res`` (clamped to the cell's own resolution so coarse
    grids never raise), or 0 for non-H3 cell ids — junk must land in a
    bucket, not break compaction."""
    try:
        cell = int(cid, 16)
        res = (cell >> RES_SHIFT) & 0xF
        return cell_to_parent(cell, min(parent_res, res))
    except (TypeError, ValueError):
        return 0


def _seg_name_parts(path: str) -> tuple[str, int] | None:
    """(epoch, start_seq) of a ``seg-<epoch>-<start>.jsonl`` name."""
    base = os.path.basename(path)
    if not base.startswith("seg-") or not base.endswith(".jsonl"):
        return None
    body = base[4:-6]
    epoch, _, start = body.rpartition("-")
    try:
        return (epoch, int(start)) if epoch else None
    except ValueError:
        return None


def _snap_name_parts(path: str) -> tuple[str, int] | None:
    """(epoch, seq) of a ``snap-<epoch>-<seq>.json`` name."""
    base = os.path.basename(path)
    if not base.startswith("snap-") or not base.endswith(".json"):
        return None
    body = base[5:-5]
    epoch, _, seq = body.rpartition("-")
    try:
        return (epoch, int(seq)) if epoch else None
    except ValueError:
        return None


def _read_segment(path: str) -> list:
    """Decoded records of one sealed segment, in file order.  A torn
    tail line (only possible on an adopted dead-epoch LIVE segment)
    stops the scan — everything before it is intact."""
    try:
        with open(path, encoding="utf-8") as fh:
            raw = fh.read()
    except OSError:
        return []
    out = []
    for line in raw.splitlines():
        if not line:
            continue
        try:
            rec = replmod.loads(line)
        except ValueError:
            break
        if isinstance(rec, dict):
            out.append(rec)
    return out


# ----------------------------------------------------------------- log
class HistoryLog:
    """The durable-log half the feed publisher hands rotated segments
    to (query.repl.DeltaLogPublisher ``hist=``): ``retire`` moves a
    segment into ``log/`` atomically instead of deleting it, and
    ``adopt_snapshot`` copies the rotation/boot snapshot next to it as
    a replay base.  Never raises into the publisher — a full history
    disk degrades to the pre-history delete, loudly."""

    def __init__(self, hist_dir: str):
        self.dir = hist_dir
        self.log_dir = os.path.join(hist_dir, LOG_DIR)
        os.makedirs(self.log_dir, exist_ok=True)

    def retire(self, seg_path: str) -> bool:
        dst = os.path.join(self.log_dir, os.path.basename(seg_path))
        try:
            os.replace(seg_path, dst)
            return True
        except OSError as e:
            log.warning("history retire of %s failed (%s); deleting",
                        seg_path, e)
            try:
                os.remove(seg_path)
            except OSError:
                pass
            return False

    def adopt_snapshot(self, epoch: str, seq: int, payload: dict) -> None:
        """Copy one feed snapshot ({"epoch", "seq", "state"}) into the
        log as ``snap-<epoch>-<seq>.json`` — the base view-at-seq
        replay resets from.  One file per (epoch, seq); rewriting the
        same seq is idempotent."""
        try:
            atomic_write_json(
                os.path.join(self.log_dir,
                             f"snap-{epoch}-{int(seq):012d}.json"),
                payload)
        except OSError as e:
            log.warning("history snapshot adopt failed: %s", e)


# --------------------------------------------------------------- chunks
def encode_chunk(grid: str, parent: int, bucket: int, bucket_s: int,
                 parent_res: int, windows: dict, native=None) -> bytes:
    """One immutable chunk: JSON meta line + per-window blocks.

    ``windows``: {ws: {"docs": [full tile docs, window order],
    "digest": int, "seq": int, "stale": float|None,
    "verified": bool}}.  Docs ride the serve/wire.py columnar frame
    (byte-exact round-trip of every serving-visible field) plus the
    centroid and content-hash side columns."""
    from heatmap_tpu_torch.serve import wire

    meta_w: dict = {}
    body = bytearray()
    for ws in sorted(windows):
        w = windows[ws]
        docs = w["docs"]
        meta_w[str(ws)] = {
            "digest": format(int(w.get("digest", 0)), "016x"),
            "docs": len(docs),
            "seq": int(w.get("seq", 0)),
            "stale": w.get("stale"),
            "verified": bool(w.get("verified", False)),
            "closed": bool(w.get("closed", False)),
            "epoch": w.get("epoch"),
            "rebased": bool(w.get("rebased", False)),
        }
        ws_dt = docs[0]["windowStart"] if docs else None
        block = bytearray()
        try:
            frame = wire.encode("full", int(w.get("seq", 0)), grid,
                                ws_dt, docs, native=native)
            block.append(_BLOCK_WIRE)
        except ValueError:
            # a doc the compact layout cannot represent exactly: the
            # JSON fallback keeps the chunk lossless rather than wrong
            frame = replmod.dumps(docs).encode("utf-8")
            block.append(_BLOCK_JSON)
        block += struct.pack("<I", len(frame))
        block += frame
        # centroid side column: presence bitmap + f64 lon/lat pairs
        bitmap = bytearray((len(docs) + 7) // 8)
        cents = []
        for i, d in enumerate(docs):
            try:
                lon, lat = d["centroid"]["coordinates"]
                lon, lat = float(lon), float(lat)
            except (KeyError, TypeError, ValueError):
                continue
            bitmap[i // 8] |= 1 << (i % 8)
            cents.append((lon, lat))
        block += bytes(bitmap)
        for lon, lat in cents:
            block += struct.pack("<dd", lon, lat)
        # content-hash side column (obs.audit.doc_hash, doc order):
        # what lets a restarted compactor keep the window digest
        # incrementally exact over chunk-seeded cells
        hashes = w.get("hashes")
        for i, d in enumerate(docs):
            h = (hashes.get(d.get("cellId")) if isinstance(hashes, dict)
                 else None)
            block += struct.pack("<Q", int(h if h is not None
                                           else doc_hash(d)))
        body += struct.pack("<I", len(block))
        body += block
    meta = {"v": 1, "grid": grid, "parent": format(parent, "016x"),
            "parent_res": int(parent_res), "bucket": int(bucket),
            "bucket_s": int(bucket_s), "windows": meta_w}
    return json.dumps(meta, separators=(",", ":")).encode("utf-8") \
        + b"\n" + bytes(body)


def decode_chunk(buf: bytes) -> tuple[dict, dict]:
    """(meta, {ws: {"docs": [...], "hashes": {cid: int}}}) — docs carry
    every serving-visible field EXACTLY (wire decode) plus the merged
    centroid; raises ValueError on a malformed chunk."""
    from heatmap_tpu_torch.serve import wire

    nl = buf.find(b"\n")
    if nl < 0:
        raise ValueError("chunk has no meta line")
    meta = json.loads(buf[:nl].decode("utf-8"))
    if not isinstance(meta, dict) or meta.get("v") != 1:
        raise ValueError("unsupported chunk version")
    pos = nl + 1
    windows: dict = {}
    order = sorted(int(ws) for ws in (meta.get("windows") or {}))
    for ws in order:
        if pos + 4 > len(buf):
            raise ValueError("chunk truncated in block header")
        (blen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        block = buf[pos:pos + blen]
        if len(block) != blen:
            raise ValueError("chunk truncated in window block")
        pos += blen
        kind = block[0]
        (flen,) = struct.unpack_from("<I", block, 1)
        frame = block[5:5 + flen]
        bpos = 5 + flen
        if kind == _BLOCK_WIRE:
            docs = wire.decode(frame)["docs"]
        elif kind == _BLOCK_JSON:
            docs = replmod.loads(frame.decode("utf-8"))
        else:
            raise ValueError(f"unknown chunk block kind {kind}")
        n = len(docs)
        bitmap = block[bpos:bpos + (n + 7) // 8]
        bpos += (n + 7) // 8
        for i, d in enumerate(docs):
            if bitmap[i // 8] & (1 << (i % 8)):
                lon, lat = struct.unpack_from("<dd", block, bpos)
                bpos += 16
                d["centroid"] = {"type": "Point",
                                 "coordinates": [lon, lat]}
        hashes = {}
        for d in docs:
            (h,) = struct.unpack_from("<Q", block, bpos)
            bpos += 8
            hashes[d.get("cellId")] = h
        windows[ws] = {"docs": docs, "hashes": hashes}
    return meta, windows


def _chunk_name(grid: str, parent: int, bucket: int) -> str:
    return f"chunk-{grid}-{parent:016x}-{int(bucket)}.hst"


_CHUNK_NAME_OK = None  # compiled lazily


def chunk_name_ok(name: str) -> bool:
    """Validate a client-supplied chunk name (the /api/hist/chunk
    re-export must never open an attacker-chosen path)."""
    global _CHUNK_NAME_OK
    if _CHUNK_NAME_OK is None:
        import re

        _CHUNK_NAME_OK = re.compile(
            r"^chunk-[A-Za-z0-9_.:\-]{1,64}-[0-9a-f]{16}-\d{1,12}"
            r"\.hst$")
    return bool(_CHUNK_NAME_OK.match(name))


# -------------------------------------------------------------- sources
class FileHistorySource:
    """Same-host chunk access: scan + read the chunk directory.  Chunk
    metas are memoized by (name, size, mtime) — chunks are immutable
    between atomic rewrites, so the memo is exact."""

    def __init__(self, hist_dir: str):
        self.dir = hist_dir
        self.chunk_dir = os.path.join(hist_dir, CHUNK_DIR)
        self._meta_memo: dict = {}

    def index(self) -> list:
        out = []
        for p in sorted(glob.glob(os.path.join(
                glob.escape(self.chunk_dir), "chunk-*.hst"))):
            name = os.path.basename(p)
            if not chunk_name_ok(name):
                continue
            try:
                st = os.stat(p)
                key = (st.st_size, st.st_mtime_ns)
                memo = self._meta_memo.get(name)
                if memo is not None and memo[0] == key:
                    out.append(memo[1])
                    continue
                with open(p, "rb") as fh:
                    meta = json.loads(
                        fh.readline().decode("utf-8"))
            except (OSError, ValueError):
                continue
            if not isinstance(meta, dict):
                continue
            meta = dict(meta)
            meta["name"] = name
            meta["bytes"] = st.st_size
            meta["mtime_ns"] = st.st_mtime_ns
            if len(self._meta_memo) >= 4096:
                self._meta_memo.pop(next(iter(self._meta_memo)))
            self._meta_memo[name] = (key, meta)
            out.append(meta)
        return out

    def chunk_bytes(self, name: str) -> bytes | None:
        if not chunk_name_ok(name):
            return None
        try:
            with open(os.path.join(self.chunk_dir, name), "rb") as fh:
                return fh.read()
        except OSError:
            return None


class HttpHistorySource:
    """Remote chunk access over the writer's /api/hist/* re-export
    (serve/api.py) — what a remote replica backfills from."""

    def __init__(self, base_url: str, timeout_s: float = 10.0):
        self.base = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _get(self, path: str) -> bytes:
        import urllib.request

        req = urllib.request.Request(self.base + path)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return r.read()

    def index(self) -> list:
        """Raises OSError/ValueError on transport or framing trouble —
        callers must be able to tell a failed read from a genuinely
        empty store (a transient error must not cancel a replica's
        one-shot backfill)."""
        d = json.loads(self._get("/api/hist/index").decode("utf-8"))
        chunks = d.get("chunks") if isinstance(d, dict) else None
        return chunks if isinstance(chunks, list) else []

    def chunk_bytes(self, name: str) -> bytes | None:
        import urllib.error
        from urllib.parse import quote

        if not chunk_name_ok(name):
            return None
        try:
            return self._get(f"/api/hist/chunk?name={quote(name)}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None  # legitimately pruned underneath us
            raise


def history_source(spec: str):
    """``HEATMAP_HIST_DIR``/feed value -> source: an http(s):// URL
    gets the TCP transport, anything else is a same-host directory."""
    if spec.startswith("http://") or spec.startswith("https://"):
        return HttpHistorySource(spec)
    return FileHistorySource(spec)


# ------------------------------------------------------------ compactor
class _Window:
    """One accumulated (grid, windowStart): full docs by cell, content
    hashes, the newest seq that touched it, the writer's published
    digest for it (when auditing), and the dirty/loaded bookkeeping."""

    __slots__ = ("cells", "hashes", "stale", "seq", "want_dg",
                 "verified", "dirty", "loaded", "closed", "epoch",
                 "rebased")

    def __init__(self):
        self.cells: dict = {}     # cid -> full doc (insertion order)
        self.hashes: dict = {}    # cid -> doc_hash
        self.stale: float | None = None
        self.seq = 0              # newest seq applied, WITHIN .epoch
        self.want_dg: int | None = None
        self.verified = False
        self.dirty = False
        self.loaded = True
        # the view EVICTED this window: its content here is final.  A
        # later apply into the same (grid, ws) re-creates the window
        # fresh on the writer, so the accumulator must start fresh too
        # or its digest would diverge from the view's books.
        self.closed = False
        # seqs are only comparable within one writer epoch; a window
        # touched from a NEW epoch rebases (seq restarts at 0 and the
        # new records upsert over the old epoch's final content).  A
        # rebased window's digest is a cross-epoch union the new
        # writer's books never described, so verification is suspended
        # until its content is exactly re-established (resync, or
        # evict + recreate).
        self.epoch: str | None = None
        self.rebased = False

    def enter_epoch(self, epoch: str) -> None:
        if self.epoch == epoch:
            return
        if self.epoch is not None:
            self.rebased = True
            self.verified = False
        self.epoch = epoch
        self.seq = 0

    def digest(self) -> int:
        out = 0
        for h in self.hashes.values():
            out ^= h
        return out


class HistoryCompactor:
    """Compacts retired repl segments into the immutable chunk store.

    Drive it with :meth:`step` (tests, the CLI ``--once`` mode) or
    :meth:`start` (a daemon thread at ``interval_s``).  One compactor
    per history directory."""

    def __init__(self, hist_dir: str, feed_dir: str | None = None,
                 bucket_s: int = 3600, parent_res: int = 3,
                 retention_s: float = 7 * 86400.0,
                 registry=None, clock=time.time, interval_s: float = 2.0,
                 native=None):
        self.dir = hist_dir
        self.feed_dir = feed_dir
        self.bucket_s = max(60, int(bucket_s))
        self.parent_res = max(0, min(15, int(parent_res)))
        self.retention_s = float(retention_s)
        self.clock = clock
        self.interval_s = max(0.05, float(interval_s))
        self.native = native
        self.log_dir = os.path.join(hist_dir, LOG_DIR)
        self.chunk_dir = os.path.join(hist_dir, CHUNK_DIR)
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.chunk_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # grid -> ws -> _Window
        self._accum: dict[str, dict[int, _Window]] = {}
        # end-capless segments (a closed feed's final segment) would
        # otherwise re-read every tick: memoize (mtime_ns, size,
        # max seq seen) and skip while unchanged and covered
        self._seg_memo: dict = {}
        self._state = self._load_state()
        self.records_ingested = 0
        self.chunk_writes = 0
        self.verified = 0
        # a persisted mismatch keeps the prune freeze across restarts —
        # an operator clears it by deleting hist-state.json after the
        # incident, not by bouncing the process
        self.mismatches = int(self._state.get("mismatches", 0))
        self.segments_pruned = 0
        self.chunks_pruned = 0
        self.last_mismatch: dict | None = None
        self._lag_s = 0.0
        self._chunks = 0
        self._chunk_bytes = 0
        self._span_s = 0.0
        self._refresh_chunk_stats()
        if registry is not None:
            self._c_records = registry.counter(
                "heatmap_hist_records_total",
                "repl feed records ingested by the history compactor "
                "(apply/evict/resync, across epochs)")
            self._c_chunk_writes = registry.counter(
                "heatmap_hist_chunk_writes_total",
                "immutable space-time chunk files written (atomic "
                "rewrites of a (grid, parent cell, time bucket) chunk "
                "count once each)")
            self._c_verified = registry.counter(
                "heatmap_hist_digest_verified_total",
                "compacted windows whose recomputed content digest "
                "matched the writer's published per-window digest "
                "(HEATMAP_AUDIT=1 feeds)")
            self._c_mismatch = registry.counter(
                "heatmap_hist_digest_mismatch_total",
                "compacted-vs-published window digest mismatches — a "
                "corrupted segment or diverged compaction; any nonzero "
                "degrades /healthz and FREEZES raw-segment pruning")
            self._c_seg_pruned = registry.counter(
                "heatmap_hist_pruned_segments_total",
                "raw log segments pruned after their chunks were "
                "durably written, digest-verified, and aged past "
                "HEATMAP_HIST_RETENTION_S")
            registry.gauge(
                "heatmap_hist_chunks",
                "space-time chunk files currently on disk",
                fn=lambda: self._chunks)
            registry.gauge(
                "heatmap_hist_chunk_bytes",
                "total bytes of space-time chunk files on disk",
                fn=lambda: self._chunk_bytes)
            registry.gauge(
                "heatmap_hist_covered_span_seconds",
                "wall-clock span covered by the chunk store (newest "
                "bucket end minus oldest bucket start; 0 when empty)",
                fn=lambda: self._span_s)
            registry.gauge(
                "heatmap_hist_compaction_lag_seconds",
                "age of the oldest retired segment still holding "
                "records above the persisted ingest watermark (0 when "
                "fully compacted) — the /healthz compaction-lag check",
                fn=lambda: self._lag_s)
        else:
            self._c_records = self._c_chunk_writes = None
            self._c_verified = self._c_mismatch = None
            self._c_seg_pruned = None

    # ------------------------------------------------------------ state
    def _state_path(self) -> str:
        return os.path.join(self.dir, STATE)

    def _load_state(self) -> dict:
        try:
            with open(self._state_path(), encoding="utf-8") as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            return {"v": 1, "epochs": {}}
        if not isinstance(d, dict) or not isinstance(d.get("epochs"),
                                                     dict):
            return {"v": 1, "epochs": {}}
        return d

    def _save_state(self) -> None:
        # mismatches persist so serve workers (which run no compactor)
        # can degrade /healthz off the state file alone
        self._state["mismatches"] = self.mismatches
        atomic_write_json(self._state_path(), self._state)

    # ------------------------------------------------------- accumulate
    def _window(self, grid: str, ws: int) -> _Window:
        wins = self._accum.setdefault(grid, {})
        w = wins.get(ws)
        if w is None:
            w = wins[ws] = _Window()
            self._seed_from_chunks(grid, ws, w)
        elif not w.loaded:
            self._seed_from_chunks(grid, ws, w)
        return w

    def _seed_from_chunks(self, grid: str, ws: int, w: _Window) -> None:
        """Reload one window's cells from its on-disk chunks (compactor
        restart: the accumulator is chunks + un-pruned segments, by
        construction)."""
        bucket = ws - ws % self.bucket_s
        pat = os.path.join(glob.escape(self.chunk_dir),
                           f"chunk-{glob.escape(grid)}-*-{bucket}.hst")
        for p in sorted(glob.glob(pat)):
            try:
                with open(p, "rb") as fh:
                    meta, windows = decode_chunk(fh.read())
            except (OSError, ValueError):
                continue
            part = windows.get(ws)
            if part is None:
                continue
            for d in part["docs"]:
                cid = d.get("cellId")
                w.cells[cid] = d
                w.hashes[cid] = part["hashes"].get(cid, 0)
            wm = (meta.get("windows") or {}).get(str(ws)) or {}
            w.seq = max(w.seq, int(wm.get("seq", 0)))
            if wm.get("stale") is not None:
                w.stale = wm["stale"]
            w.verified = w.verified or bool(wm.get("verified"))
            w.closed = w.closed or bool(wm.get("closed"))
            w.rebased = w.rebased or bool(wm.get("rebased"))
            if wm.get("epoch") and w.epoch is None:
                w.epoch = wm["epoch"]
        w.loaded = True

    def _ingest(self, rec: dict, dirty: set, epoch: str) -> None:
        kind = rec.get("kind")
        seq = int(rec.get("seq", 0))
        touched: set = set()
        if kind == "apply":
            for doc in rec.get("docs") or []:
                self._ingest_doc(doc, seq, touched, epoch)
        elif kind == "resync":
            grid = rec.get("grid") or ""
            ws = rec.get("ws")
            if grid and ws is not None:
                # the window's state is REPLACED at this seq; older
                # accumulated windows of the grid keep their last
                # content — they were true at their time, which is the
                # whole point of a history tier
                w = self._window(grid, int(ws))
                w.enter_epoch(epoch)
                if seq > w.seq:
                    w.cells.clear()
                    w.hashes.clear()
                    w.closed = False
                    w.rebased = False  # content exactly known again
                    touched.add((grid, int(ws)))
                    for doc in rec.get("docs") or []:
                        self._ingest_doc(doc, seq, touched, epoch,
                                         grid=grid)
                    w.seq = max(w.seq, seq)
                    w.dirty = True
        elif kind == "evict":
            # eviction is the live view forgetting; history keeps the
            # final content but CLOSES the window (persisted in the
            # chunk meta): a later apply into the same ws is a fresh
            # window on the writer and must be one here too
            grid = rec.get("grid") or ""
            for ws in rec.get("ws") or []:
                if not grid:
                    break
                # through _window(): an evict REPLAYED after a restart
                # must seed the window from its chunks first, or the
                # closed flag is lost and a later re-create would
                # merge the stale chunk cells into fresh content
                w = self._window(grid, int(ws))
                w.enter_epoch(epoch)
                if seq > w.seq:
                    w.seq = seq
                    w.closed = True
                    w.dirty = True
                    dirty.add((grid, int(ws)))
        self._verify(rec, seq, touched)
        dirty.update(touched)
        self.records_ingested += 1
        if self._c_records is not None:
            self._c_records.inc()

    def _ingest_doc(self, doc: dict, seq: int, touched: set,
                    epoch: str, grid: str | None = None) -> None:
        import datetime as dt

        g = grid or doc.get("grid")
        ws_dt = doc.get("windowStart")
        cid = doc.get("cellId")
        if not g or cid is None or not isinstance(ws_dt, dt.datetime):
            return
        ws = int(ws_dt.timestamp())
        w = self._window(g, ws)
        w.enter_epoch(epoch)
        if seq <= w.seq and (g, ws) not in touched:
            # replay idempotence (per window, like the replica's
            # per-view rule): a re-ingested record at or below the
            # chunk-seeded seq is already folded into the window —
            # re-applying its older doc would regress content and its
            # digest check would compare final state to an
            # intermediate one.  Same-record siblings (equal seq) pass
            # via the touched set.
            return
        if w.closed:
            w.cells.clear()
            w.hashes.clear()
            w.closed = False
            w.verified = False
            w.rebased = False  # fresh window: content exactly known
        w.cells[cid] = doc
        w.hashes[cid] = doc_hash(doc)
        w.seq = max(w.seq, seq)
        w.dirty = True
        stale = doc.get("staleAt")
        if isinstance(stale, dt.datetime):
            w.stale = stale.timestamp()
        touched.add((g, ws))

    def _verify(self, rec: dict, seq: int, touched: set) -> None:
        """Per-record digest verification against the writer's books
        (``"dg"``, published under HEATMAP_AUDIT=1): recompute the
        accumulated window's digest and compare.  Only windows this
        record actually touched verify — a dg entry for a window whose
        history predates this store must not read as divergence."""
        dg = rec.get("dg")
        if not isinstance(dg, dict):
            return
        for grid, per_ws in dg.items():
            if not isinstance(per_ws, dict):
                continue
            for ws_s, expect in per_ws.items():
                try:
                    ws, want = int(ws_s), int(expect, 16)
                except (TypeError, ValueError):
                    continue
                if (grid, ws) not in touched:
                    continue
                w = (self._accum.get(grid) or {}).get(ws)
                if w is None:
                    continue
                if w.rebased:
                    # cross-epoch union: the writer's books never
                    # described this content — verification resumes
                    # once the window's content is exactly known again
                    continue
                w.want_dg = want
                if w.digest() == want:
                    w.verified = True
                    self.verified += 1
                    if self._c_verified is not None:
                        self._c_verified.inc()
                else:
                    w.verified = False
                    self.mismatches += 1
                    self.last_mismatch = {
                        "grid": grid, "ws": ws, "seq": seq,
                        "have": format(w.digest(), "016x"),
                        "want": format(want, "016x")}
                    if self._c_mismatch is not None:
                        self._c_mismatch.inc()
                    log.error(
                        "HIST digest mismatch: grid=%s window=%d "
                        "seq=%d (have %016x, want %016x)", grid, ws,
                        seq, w.digest(), want)

    # ------------------------------------------------------------ flush
    def _flush(self, dirty: set) -> None:
        """Rewrite every chunk a dirty window belongs to.  A rewrite
        loads the existing chunk, overlays the dirty windows' slices,
        and replaces it atomically — readers only ever see complete
        chunks."""
        by_chunk: dict = {}
        for grid, ws in dirty:
            w = (self._accum.get(grid) or {}).get(ws)
            if w is None:
                continue
            bucket = ws - ws % self.bucket_s
            parents: set = set()
            for cid in w.cells:
                parents.add(_cell_parent_key(cid, self.parent_res))
            # ALSO rewrite chunks that hold a now-stale slice of this
            # window under a parent its current cells no longer touch
            # (a resync / evict+recreate dropped every cell of that
            # parent) — without this the stale slice would serve (and
            # re-seed a restarted compactor) forever
            pat = os.path.join(glob.escape(self.chunk_dir),
                               f"chunk-{glob.escape(grid)}-*-"
                               f"{bucket}.hst")
            for p in glob.glob(pat):
                try:
                    with open(p, "rb") as fh:
                        meta = json.loads(
                            fh.readline().decode("utf-8"))
                    if str(ws) in (meta.get("windows") or {}):
                        parents.add(int(meta.get("parent", "0"), 16))
                except (OSError, ValueError):
                    continue
            for parent in parents:
                by_chunk.setdefault((grid, parent, bucket),
                                    set()).add(ws)
        for (grid, parent, bucket), ws_set in sorted(by_chunk.items()):
            path = os.path.join(self.chunk_dir,
                                _chunk_name(grid, parent, bucket))
            windows: dict = {}
            try:
                with open(path, "rb") as fh:
                    meta, existing = decode_chunk(fh.read())
                for ws, part in existing.items():
                    wm = (meta.get("windows") or {}).get(str(ws)) or {}
                    windows[ws] = {
                        "docs": part["docs"],
                        "hashes": part["hashes"],
                        "digest": int(wm.get("digest", "0"), 16),
                        "seq": int(wm.get("seq", 0)),
                        "stale": wm.get("stale"),
                        "verified": bool(wm.get("verified")),
                        "closed": bool(wm.get("closed")),
                        "epoch": wm.get("epoch"),
                        "rebased": bool(wm.get("rebased")),
                    }
            except FileNotFoundError:
                pass
            except (OSError, ValueError):
                log.warning("unreadable chunk %s; rewriting from the "
                            "accumulator alone", path)
            for ws in ws_set:
                w = self._accum[grid][ws]
                docs = [d for cid, d in w.cells.items()
                        if _cell_parent_key(cid, self.parent_res)
                        == parent]
                if not docs:
                    # this parent's slice of the window is gone
                    # (resync/recreate): drop it from the chunk
                    windows.pop(ws, None)
                    continue
                hashes = {d.get("cellId"):
                          w.hashes.get(d.get("cellId"), 0)
                          for d in docs}
                windows[ws] = {
                    "docs": docs, "hashes": hashes,
                    "digest": w.digest(), "seq": w.seq,
                    "stale": w.stale, "verified": w.verified,
                    "closed": w.closed, "epoch": w.epoch,
                    "rebased": w.rebased,
                }
            if not windows:
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            data = encode_chunk(grid, parent, bucket, self.bucket_s,
                                self.parent_res, windows,
                                native=self.native)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            self.chunk_writes += 1
            if self._c_chunk_writes is not None:
                self._c_chunk_writes.inc()
        for grid, ws in dirty:
            w = (self._accum.get(grid) or {}).get(ws)
            if w is not None:
                w.dirty = False

    # ------------------------------------------------------------- step
    def _log_segments(self) -> tuple[list, dict]:
        """([(epoch, start, path, mtime)], {epoch: end cap}) of sealed
        segments, ordered epoch-boot-first (min mtime per epoch), then
        by start seq.  The cap is the excluded live segment's start −
        1: it bounds the newest sealed segment's records, so a
        caught-up compactor skips it by watermark instead of
        re-reading it every tick.

        Includes the FEED directory's sealed rotated segments: the
        newest ``HEATMAP_REPL_SEGMENTS - 1`` rotated segments stay in
        the feed for follower tailing and only retire at a later
        rotation — without reading them in place the compactor would
        sit one retention window behind (and see a seq gap after a
        clean shutdown retired the live tail around them).  The feed's
        LIVE segment (max start per epoch) is excluded unless the feed
        is cleanly closed — it is still being appended to.  A segment
        read both here and after retirement dedups via the watermark
        (identical bytes, os.replace keeps the name)."""
        segs = []
        caps: dict = {}
        for p in glob.glob(os.path.join(glob.escape(self.log_dir),
                                        "seg-*.jsonl")):
            parts = _seg_name_parts(p)
            if parts is None:
                continue
            try:
                mtime = os.stat(p).st_mtime
            except OSError:
                continue
            segs.append((parts[0], parts[1], p, mtime))
        if self.feed_dir:
            meta = replmod.read_meta(self.feed_dir)
            closed = bool(meta.get("closed"))
            feed_epoch = meta.get("epoch")
            feed_segs: dict = {}
            for p in glob.glob(os.path.join(
                    glob.escape(self.feed_dir), "seg-*.jsonl")):
                parts = _seg_name_parts(p)
                if parts is None:
                    continue
                try:
                    mtime = os.stat(p).st_mtime
                except OSError:
                    continue
                feed_segs.setdefault(parts[0], []).append(
                    (parts[1], p, mtime))
            for epoch, eseg in feed_segs.items():
                eseg.sort()
                live_ok = closed and epoch == feed_epoch
                for i, (start, p, mtime) in enumerate(eseg):
                    if i + 1 == len(eseg) and not live_ok:
                        caps[epoch] = start - 1
                        continue  # the live (appended-to) segment
                    segs.append((epoch, start, p, mtime))
        first_seen: dict = {}
        for epoch, _s, _p, mtime in segs:
            first_seen[epoch] = min(first_seen.get(epoch, mtime), mtime)
        segs.sort(key=lambda t: (first_seen[t[0]], t[0], t[1]))
        return segs, caps

    def _seed_epoch(self, epoch: str, dirty: set) -> int:
        """First sight of an epoch: seed the accumulator from its
        adopted BOOT snapshot (the oldest snap) so windows that
        predate the first rotated segment are complete, and return the
        snapshot seq as the initial watermark."""
        snaps = []
        for p in glob.glob(os.path.join(
                glob.escape(self.log_dir),
                f"snap-{glob.escape(epoch)}-*.json")):
            parts = _snap_name_parts(p)
            if parts is not None:
                snaps.append((parts[1], p))
        if not snaps:
            return 0
        seq0, path = min(snaps)
        try:
            with open(path, encoding="utf-8") as fh:
                snap = replmod.loads(fh.read())
        except (OSError, ValueError):
            return 0
        state = (snap or {}).get("state") or {}
        touched: set = set()
        for grid, gs in (state.get("grids") or {}).items():
            for ws_key, cells in (gs.get("windows") or {}).items():
                for cid, doc in cells.items():
                    self._ingest_doc(doc, seq0, touched, epoch,
                                     grid=grid)
        dirty.update(touched)
        return int(seq0)

    def step(self) -> int:
        """One compaction round: ingest new records from sealed
        segments, flush dirty windows to chunks, persist the
        watermarks, then prune.  Returns records ingested."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> int:
        segs, caps = self._log_segments()
        epochs = self._state["epochs"]
        ingested = 0
        dirty: set = set()
        pending_oldest: float | None = None
        # per-epoch segment end bounds: records of seg i span
        # [start_i, start_{i+1} - 1]; the newest segment's end is
        # unknown and always read
        by_epoch: dict = {}
        for epoch, start, path, mtime in segs:
            by_epoch.setdefault(epoch, []).append((start, path, mtime))
        seeded = False
        for epoch, eseg in by_epoch.items():
            eseg.sort()
            if epoch not in epochs:
                epochs[epoch] = self._seed_epoch(epoch, dirty)
                seeded = True
            wm = int(epochs[epoch])
            for i, (start, path, mtime) in enumerate(eseg):
                end = (eseg[i + 1][0] - 1) if i + 1 < len(eseg) \
                    else caps.get(epoch)
                if end is not None and end <= wm:
                    continue
                try:
                    st = os.stat(path)
                    stat_key = (st.st_mtime_ns, st.st_size)
                except OSError:
                    stat_key = None
                memo = self._seg_memo.get(path)
                if memo is not None and stat_key is not None \
                        and memo[0] == stat_key and memo[1] <= wm:
                    continue
                top = 0
                for rec in _read_segment(path):
                    seq = int(rec.get("seq", 0))
                    top = max(top, seq)
                    if seq <= wm:
                        continue
                    self._ingest(rec, dirty, epoch)
                    wm = max(wm, seq)
                    ingested += 1
                if stat_key is not None and top > 0:
                    # only a read that actually saw records memoizes —
                    # an empty or failed read must retry next tick
                    if len(self._seg_memo) >= 1024:
                        self._seg_memo.pop(next(iter(self._seg_memo)))
                    self._seg_memo[path] = (stat_key, top)
            epochs[epoch] = wm
        if dirty:
            self._flush(dirty)
        if ingested or dirty or seeded:
            # AFTER the flush: the persisted watermark only ever claims
            # records whose chunks are durably on disk — the ordering
            # the zero-loss retention invariant rests on
            self._save_state()
        self._prune(by_epoch)
        # compaction lag: oldest sealed segment still above the
        # persisted watermark (after this round: normally none)
        now = self.clock()
        for epoch, eseg in by_epoch.items():
            wm = int(self._state["epochs"].get(epoch, 0))
            for i, (start, path, mtime) in enumerate(eseg):
                end = (eseg[i + 1][0] - 1) if i + 1 < len(eseg) \
                    else caps.get(epoch)
                if end is None or end > wm:
                    # conservatively: unread tail counts only when it
                    # still exists (the prune may have removed it)
                    if os.path.exists(path) and (end is not None):
                        pending_oldest = (mtime if pending_oldest is None
                                          else min(pending_oldest, mtime))
        self._lag_s = (max(0.0, now - pending_oldest)
                       if pending_oldest is not None else 0.0)
        self._refresh_chunk_stats()
        return ingested

    # ------------------------------------------------------------ prune
    def _prune(self, by_epoch: dict) -> None:
        """Retention prune.  Raw segments go ONLY when fully ingested
        (below the persisted watermark), aged past retention, and no
        digest mismatch is outstanding — the zero-loss ordering
        invariant.  Chunks and accumulator windows age out past
        retention; replay snapshots keep the newest base at or below
        every retained segment."""
        now = self.clock()
        horizon = now - self.retention_s
        # the live epoch's newest segment can still GROW (the retired
        # live tail of a crashed writer re-appears at the next boot
        # sweep); a dead epoch's newest segment cannot, so once the
        # watermark covers what we read of it, it is fully ingested
        live_epoch = None
        if self.feed_dir:
            meta = replmod.read_meta(self.feed_dir)
            if not meta.get("closed"):
                live_epoch = meta.get("epoch")
        if self.mismatches == 0:
            for epoch, eseg in by_epoch.items():
                wm = int(self._state["epochs"].get(epoch, 0))
                eseg = sorted(eseg)
                for i, (start, path, mtime) in enumerate(eseg):
                    end = (eseg[i + 1][0] - 1) if i + 1 < len(eseg) \
                        else None
                    if end is None and epoch != live_epoch \
                            and start <= wm:
                        end = wm
                    if end is None or end > wm or mtime > horizon:
                        continue
                    if os.path.dirname(path) != self.log_dir:
                        # feed-resident segments are the publisher's to
                        # prune (follower tail retention) — never ours
                        continue
                    try:
                        os.remove(path)
                        self.segments_pruned += 1
                        if self._c_seg_pruned is not None:
                            self._c_seg_pruned.inc()
                    except OSError:
                        pass
        # chunks whose whole bucket aged out
        for p in glob.glob(os.path.join(glob.escape(self.chunk_dir),
                                        "chunk-*.hst")):
            name = os.path.basename(p)
            try:
                bucket = int(name[:-4].rsplit("-", 1)[1])
            except (IndexError, ValueError):
                continue
            if bucket + self.bucket_s < horizon:
                try:
                    os.remove(p)
                    self.chunks_pruned += 1
                except OSError:
                    pass
        for grid in list(self._accum):
            wins = self._accum[grid]
            for ws in [ws for ws in wins if ws + self.bucket_s
                       < horizon]:
                del wins[ws]
            if not wins:
                del self._accum[grid]
        # replay snapshots: drop aged ones, but ALWAYS keep, per epoch,
        # the newest snap at or below the oldest retained segment start
        # (the replay base) and the newest snap overall
        remaining: dict = {}
        for p in glob.glob(os.path.join(glob.escape(self.log_dir),
                                        "seg-*.jsonl")):
            parts = _seg_name_parts(p)
            if parts is not None:
                e, s = parts
                remaining[e] = min(remaining.get(e, s), s)
        for p in glob.glob(os.path.join(glob.escape(self.log_dir),
                                        "snap-*.json")):
            parts = _snap_name_parts(p)
            if parts is None:
                continue
            epoch, seq = parts
            try:
                mtime = os.stat(p).st_mtime
            except OSError:
                continue
            if mtime > horizon:
                continue
            oldest_seg = remaining.get(epoch)
            if oldest_seg is not None:
                # the newest snap <= the oldest retained segment is
                # the replay base — keep it regardless of age
                bases = [s for s in self._epoch_snap_seqs(epoch)
                         if s <= oldest_seg]
                if bases and seq == max(bases):
                    continue
            else:
                keep = self._epoch_snap_seqs(epoch)
                if keep and seq == max(keep):
                    # epoch fully compacted: the newest snap is still
                    # the only view-at-seq base for its tail
                    continue
            try:
                os.remove(p)
            except OSError:
                pass

    def _epoch_snap_seqs(self, epoch: str) -> list:
        out = []
        for p in glob.glob(os.path.join(
                glob.escape(self.log_dir),
                f"snap-{glob.escape(epoch)}-*.json")):
            parts = _snap_name_parts(p)
            if parts is not None:
                out.append(parts[1])
        return out

    def _refresh_chunk_stats(self) -> None:
        n = b = 0
        lo = hi = None
        for p in glob.glob(os.path.join(glob.escape(self.chunk_dir),
                                        "chunk-*.hst")):
            try:
                b += os.stat(p).st_size
            except OSError:
                continue
            n += 1
            try:
                bucket = int(os.path.basename(p)[:-4].rsplit("-", 1)[1])
            except (IndexError, ValueError):
                continue
            lo = bucket if lo is None else min(lo, bucket)
            hi = bucket if hi is None else max(hi, bucket)
        self._chunks = n
        self._chunk_bytes = b
        self._span_s = (hi + self.bucket_s - lo) if lo is not None \
            else 0.0

    def member_block(self) -> dict:
        """The compact history block a fleet member snapshot publishes
        (obs.xproc) — what ``obs_top --fleet`` renders per member."""
        return {"chunks": self._chunks,
                "chunk_bytes": self._chunk_bytes,
                "covered_span_s": round(self._span_s, 3),
                "lag_s": round(self._lag_s, 3),
                "records": self.records_ingested,
                "chunk_writes": self.chunk_writes,
                "verified": self.verified,
                "mismatches": self.mismatches,
                "segments_pruned": self.segments_pruned}

    # ----------------------------------------------------------- thread
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hist-compactor")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                log.exception("history compaction step failed")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            self.step()  # final drain: nothing rotated is left behind
        except Exception:
            log.exception("history compactor final step failed")


# --------------------------------------------------------------- status
def compaction_status(hist_dir: str, now: float | None = None) -> dict:
    """File-derived compaction status — what serve workers (which run
    no compactor) feed /healthz and the fleet member snapshot:
    chunks/bytes/covered span, pending (not-yet-ingested) sealed
    segments, and the compaction lag in seconds."""
    now = time.time() if now is None else now
    out = {"chunks": 0, "chunk_bytes": 0, "covered_span_s": 0.0,
           "pending_segments": 0, "lag_s": 0.0, "backfills": None}
    chunk_dir = os.path.join(hist_dir, CHUNK_DIR)
    lo = hi = None
    bucket_s = None
    for p in glob.glob(os.path.join(glob.escape(chunk_dir),
                                    "chunk-*.hst")):
        try:
            st = os.stat(p)
        except OSError:
            continue
        out["chunks"] += 1
        out["chunk_bytes"] += st.st_size
        if bucket_s is None:
            try:
                with open(p, "rb") as fh:
                    meta = json.loads(fh.readline().decode("utf-8"))
                bucket_s = int(meta.get("bucket_s", 0)) or None
            except (OSError, ValueError):
                pass
        try:
            bucket = int(os.path.basename(p)[:-4].rsplit("-", 1)[1])
        except (IndexError, ValueError):
            continue
        lo = bucket if lo is None else min(lo, bucket)
        hi = bucket if hi is None else max(hi, bucket)
    if lo is not None:
        out["covered_span_s"] = float(hi - lo + (bucket_s or 0))
    try:
        with open(os.path.join(hist_dir, STATE),
                  encoding="utf-8") as fh:
            state = json.load(fh)
        epochs = (state.get("epochs") or {}) \
            if isinstance(state, dict) else {}
        out["mismatches"] = int(state.get("mismatches", 0)) \
            if isinstance(state, dict) else 0
    except (OSError, ValueError):
        epochs = {}
        out["mismatches"] = 0
    log_dir = os.path.join(hist_dir, LOG_DIR)
    by_epoch: dict = {}
    for p in glob.glob(os.path.join(glob.escape(log_dir),
                                    "seg-*.jsonl")):
        parts = _seg_name_parts(p)
        if parts is None:
            continue
        try:
            mtime = os.stat(p).st_mtime
        except OSError:
            continue
        by_epoch.setdefault(parts[0], []).append((parts[1], p, mtime))
    oldest: float | None = None
    for epoch, eseg in by_epoch.items():
        wm = int(epochs.get(epoch, 0))
        eseg.sort()
        for i, (start, path, mtime) in enumerate(eseg):
            end = (eseg[i + 1][0] - 1) if i + 1 < len(eseg) else None
            if end is not None and end <= wm:
                continue
            if end is None and wm >= start:
                # the epoch's newest sealed segment has no end bound;
                # once the watermark has ENTERED it, the compactor is
                # at most one segment behind — counting it pending
                # forever would read as multi-day lag after every
                # rotation (and for every dead epoch's tail)
                continue
            out["pending_segments"] += 1
            oldest = mtime if oldest is None else min(oldest, mtime)
    if oldest is not None:
        out["lag_s"] = max(0.0, now - oldest)
    return out


# --------------------------------------------------------------- reader
# per-request scan accounting: the serve tier calls scan_reset() before
# a history query and attaches last_scan() to the request span after —
# thread-local so concurrent workers never mix counts.  The registry
# counters (heatmap_hist_scan_*) always accrue, reset or not.
_scan_tls = threading.local()

#: the fields one request's scan accounting carries
SCAN_FIELDS = ("chunks_opened", "blocks_scanned", "blocks_used",
               "bytes_decoded", "rows_surfaced")


def scan_reset() -> None:
    """Zero this thread's per-request scan accounting."""
    _scan_tls.scan = dict.fromkeys(SCAN_FIELDS, 0)


def last_scan() -> dict | None:
    """This thread's accounting since the last :func:`scan_reset`,
    with the scan-efficiency ratio (blocks the query actually needed /
    blocks materialized to find them): today's whole-chunk decodes
    pin it well below 1; a window index would drive it
    toward 1.  None when never reset on this thread."""
    s = getattr(_scan_tls, "scan", None)
    if s is None:
        return None
    out = dict(s)
    out["scan_ratio"] = round(
        out["blocks_used"] / max(1, out["blocks_scanned"]), 4)
    return out


def _scan_add(field: str, n: int) -> None:
    s = getattr(_scan_tls, "scan", None)
    if s is not None:
        s[field] += n


class HistoryReader:
    """Range / at-seq / diff queries over a history source (+ an
    optional live view whose windows overlay the chunks — latest and
    not-yet-compacted windows serve without waiting for the
    compactor).  Decoded chunks are memoized by (name, bytes) bounded
    at ``cache_chunks``.

    Every query is scan-accounted: chunks opened, window blocks
    scanned vs actually used, bytes decoded, rows surfaced — the
    process counters feed ``heatmap_hist_scan_*`` and the thread-local
    per-request tally feeds the serve request span."""

    def __init__(self, source, view=None, cache_chunks: int = 64,
                 registry=None):
        self.source = source
        self.view = view
        self._cache: dict = {}
        self._cache_max = max(4, int(cache_chunks))
        self._c_chunks = self._c_blocks = None
        self._c_bytes = self._c_rows = None
        if registry is not None:
            self._c_chunks = registry.counter(
                "heatmap_hist_scan_chunks_total",
                "history chunks consulted by range/at/diff queries "
                "(cache hits included — the chunk was still the scan "
                "unit)")
            self._c_blocks = registry.counter(
                "heatmap_hist_scan_blocks_total",
                "window blocks materialized by history queries; with "
                "whole-chunk decodes every block in a consulted chunk "
                "counts, wanted or not — the denominator of the "
                "scan-efficiency ratio the window index must improve")
            self._c_bytes = registry.counter(
                "heatmap_hist_scan_bytes_total",
                "chunk bytes decoded by history queries (cache misses "
                "only — what the query actually paid in decode I/O)")
            self._c_rows = registry.counter(
                "heatmap_hist_scan_rows_total",
                "cell documents surfaced to history query responses")

    def _chunk_windows(self, meta: dict) -> dict:
        name = meta.get("name")
        # mtime in the key: an atomic rewrite can keep the byte size
        # (varint count bumps, f64 changes) — size alone served stale
        key = (name, meta.get("bytes"), meta.get("mtime_ns"))
        if self._c_chunks is not None:
            self._c_chunks.inc()
        _scan_add("chunks_opened", 1)
        hit = self._cache.get(name)
        if hit is not None and hit[0] == key:
            self._count_blocks(len(hit[1]))
            return hit[1]
        buf = self.source.chunk_bytes(name)
        if buf is None:
            return {}
        try:
            _meta, windows = decode_chunk(buf)
        except ValueError:
            return {}
        if self._c_bytes is not None:
            self._c_bytes.inc(len(buf))
        _scan_add("bytes_decoded", len(buf))
        # whole-chunk decode: every window block was materialized to
        # answer the query, however few it wanted.  Counted on cache
        # hits too (the decoded form is block-complete either way) so
        # the efficiency ratio doesn't flatter a warm cache.
        self._count_blocks(len(windows))
        if len(self._cache) >= self._cache_max:
            self._cache.pop(next(iter(self._cache)))
        self._cache[name] = (key, windows)
        return windows

    def _count_blocks(self, n: int) -> None:
        if n <= 0:
            return
        if self._c_blocks is not None:
            self._c_blocks.inc(n)
        _scan_add("blocks_scanned", n)

    def _count_rows(self, n: int) -> None:
        if n <= 0:
            return
        if self._c_rows is not None:
            self._c_rows.inc(n)
        _scan_add("rows_surfaced", n)

    def windows_in_range(self, grid: str, t0: float,
                         t1: float) -> dict:
        """{ws: {"docs": [...]}} for windows with t0 <= ws < t1, cells
        merged across parent chunks, live-view windows overlaid (the
        view is fresher than any chunk)."""
        out: dict = {}
        for meta in self.source.index():
            if meta.get("grid") != grid:
                continue
            wanted = [int(ws) for ws in (meta.get("windows") or {})
                      if t0 <= int(ws) < t1]
            if not wanted:
                continue
            windows = self._chunk_windows(meta)
            used = 0
            for ws in wanted:
                part = windows.get(ws)
                if part is None:
                    continue
                used += 1
                cells = out.setdefault(ws, {})
                for d in part["docs"]:
                    cells[d.get("cellId")] = d
            _scan_add("blocks_used", used)
        if self.view is not None:
            try:
                live = self.view.window_docs(grid)
            except Exception:  # noqa: BLE001 - history must not 500 on a view bug
                live = {}
            for ws, (_ws_dt, _we_dt, docs) in live.items():
                if t0 <= ws < t1:
                    out[ws] = {d.get("cellId"): d for d in docs}
        self._count_rows(sum(len(c) for c in out.values()))
        return {ws: {"docs": [cells[c] for c in sorted(cells)]}
                for ws, cells in out.items()}

    def window_at(self, grid: str, t: float) -> tuple[int, list] | None:
        """(ws, docs) of the newest window with ws <= t (the window
        state a diff anchors at), or None."""
        best: int | None = None
        for meta in self.source.index():
            if meta.get("grid") != grid:
                continue
            for ws_s in (meta.get("windows") or {}):
                ws = int(ws_s)
                if ws <= t and (best is None or ws > best):
                    best = ws
        if self.view is not None:
            try:
                for ws in self.view.window_docs(grid):
                    if ws <= t and (best is None or ws > best):
                        best = ws
            except Exception:  # noqa: BLE001
                pass
        if best is None:
            return None
        got = self.windows_in_range(grid, best, best + 1)
        part = got.get(best)
        return (best, part["docs"]) if part else (best, [])


def rollup_window(docs: list, res: int, base_res: int, ws_dt,
                  we_dt) -> list:
    """One window's docs rolled up to coarser H3 resolution ``res`` via
    the pyramid math (query.pyramid — counts sum, speed and centroid
    recombine as count-weighted means; p95/stddev are non-combinable
    and omitted, same contract as the live ``?res=`` rollup)."""
    from heatmap_tpu_torch.query.pyramid import Pyramid

    pyr = Pyramid(base_res, base_res - res)
    ws = int(ws_dt.timestamp()) if ws_dt is not None else 0
    for d in docs:
        try:
            pyr.apply(ws, int(d["cellId"], 16), None, d)
        except (KeyError, TypeError, ValueError):
            continue
    try:
        return pyr.docs(res, ws, we_dt, ws_dt)
    except KeyError:
        return []


def aggregate_range(per_window: dict, t0_dt, t1_dt) -> list:
    """Cross-window aggregate of a range response: per cell, counts
    sum and speeds/centroids recombine count-weighted — the rollup row
    a day-over-day heatmap draws."""
    agg: dict = {}
    for ws in sorted(per_window):
        for d in per_window[ws]["docs"]:
            cid = d.get("cellId")
            c = int(d.get("count", 0))
            a = agg.get(cid)
            if a is None:
                a = agg[cid] = [0, 0.0, 0.0, 0.0, False]
            a[0] += c
            a[1] += float(d.get("avgSpeedKmh", 0.0)) * c
            try:
                lon, lat = d["centroid"]["coordinates"]
                a[2] += float(lon) * c
                a[3] += float(lat) * c
                a[4] = True
            except (KeyError, TypeError, ValueError):
                pass
    out = []
    for cid in sorted(agg):
        c, sw, slon, slat, has_cent = agg[cid]
        if c <= 0:
            continue
        doc = {"cellId": cid, "count": int(c), "avgSpeedKmh": sw / c,
               "windowStart": t0_dt, "windowEnd": t1_dt}
        if has_cent:
            doc["centroid"] = {"type": "Point",
                               "coordinates": [slon / c, slat / c]}
        out.append(doc)
    return out


# --------------------------------------------------------------- replay
def replay_records(hist_dir: str, epoch: str, since: int, until: int,
                   feed_dir: str | None = None) -> list:
    """Records of ``epoch`` with since < seq <= until, merged from the
    sealed log and (for the not-yet-rotated tail) the live feed.  The
    feed is globbed FIRST so a segment racing retirement lands in at
    least one of the two scans; duplicates dedup by seq (identical
    bytes either way)."""
    recs: dict = {}
    if feed_dir:
        for rec in replmod.read_records(feed_dir, epoch, since,
                                        max_n=1 << 30):
            seq = int(rec.get("seq", 0))
            if since < seq <= until:
                recs[seq] = rec
    log_dir = os.path.join(hist_dir, LOG_DIR)
    segs = []
    for p in glob.glob(os.path.join(glob.escape(log_dir),
                                    f"seg-{glob.escape(epoch)}-*"
                                    f".jsonl")):
        parts = _seg_name_parts(p)
        if parts is not None:
            segs.append((parts[1], p))
    for start, p in sorted(segs):
        if start > until:
            continue
        for rec in _read_segment(p):
            seq = int(rec.get("seq", 0))
            if since < seq <= until and seq not in recs:
                recs[seq] = rec
    return [recs[s] for s in sorted(recs)]


def view_at_seq(hist_dir: str, seq: int, feed_dir: str | None = None,
                epoch: str | None = None):
    """Reconstruct the materialized view at ``seq``: reset a
    replica-mode TileMatView from the newest adopted snapshot at or
    below ``seq``, then replay the log records up to it.  Raises
    ValueError when the seq predates the retained history or overruns
    the feed head (a dense-seq gap would silently diverge — refuse
    instead)."""
    from heatmap_tpu_torch.query.matview import TileMatView

    if epoch is None and feed_dir:
        epoch = replmod.read_meta(feed_dir).get("epoch")
    log_dir = os.path.join(hist_dir, LOG_DIR)
    if epoch is None:
        # newest epoch by snap mtime — the forensics default
        cand = []
        for p in glob.glob(os.path.join(glob.escape(log_dir),
                                        "snap-*.json")):
            parts = _snap_name_parts(p)
            if parts is not None:
                try:
                    cand.append((os.stat(p).st_mtime, parts[0]))
                except OSError:
                    pass
        if not cand:
            raise ValueError("no history snapshots retained")
        epoch = max(cand)[1]
    snaps = []
    for p in glob.glob(os.path.join(glob.escape(log_dir),
                                    f"snap-{glob.escape(epoch)}-*"
                                    f".json")):
        parts = _snap_name_parts(p)
        if parts is not None:
            snaps.append((parts[1], p))
    bases = [(s, p) for s, p in snaps if s <= seq]
    if not bases:
        raise ValueError(
            f"seq {seq} predates the retained history of epoch "
            f"{epoch!r}")
    base_seq, base_path = max(bases)
    try:
        with open(base_path, encoding="utf-8") as fh:
            snap = replmod.loads(fh.read())
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable replay base: {e}") from e
    view = TileMatView(replica=True)
    view.replica_reset((snap or {}).get("state") or {})
    applied = base_seq
    for rec in replay_records(hist_dir, epoch, base_seq, seq,
                              feed_dir=feed_dir):
        if int(rec.get("seq", 0)) != applied + 1:
            raise ValueError(
                f"history gap at seq {applied + 1} (epoch {epoch!r}); "
                f"the range was pruned or never retired")
        view.replica_apply(rec)
        applied = int(rec.get("seq", 0))
    if applied != seq:
        raise ValueError(
            f"seq {seq} is beyond the retained history head "
            f"({applied})")
    return view


# ------------------------------------------------------------------ CLI
def main(argv=None) -> int:
    """Standalone compactor: compact a feed's retired history once (or
    on an interval) without a runtime attached."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hist", required=True,
                    help="history directory (HEATMAP_HIST_DIR)")
    ap.add_argument("--feed", default=None,
                    help="feed directory (for lag vs the live head)")
    ap.add_argument("--bucket-s", type=int, default=3600)
    ap.add_argument("--parent-res", type=int, default=3)
    ap.add_argument("--retention-s", type=float, default=7 * 86400.0)
    ap.add_argument("--interval", type=float, default=0.0,
                    help="compaction cadence in seconds; 0 = one round")
    ap.add_argument("--once", action="store_true",
                    help="one compaction round (same as --interval 0)")
    args = ap.parse_args(argv)
    if args.once:
        args.interval = 0.0
    comp = HistoryCompactor(args.hist, feed_dir=args.feed,
                            bucket_s=args.bucket_s,
                            parent_res=args.parent_res,
                            retention_s=args.retention_s)
    while True:
        n = comp.step()
        print(json.dumps({"records": n, "chunks": comp._chunks,
                          "chunk_bytes": comp._chunk_bytes,
                          "mismatches": comp.mismatches}))
        if args.interval <= 0:
            return 1 if comp.mismatches else 0
        time.sleep(args.interval)


if __name__ == "__main__":
    import sys

    sys.exit(main())
