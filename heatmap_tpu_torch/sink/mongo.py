"""MongoDB Store over either backend: pymongo if installed, else the
framework's own wire-protocol client (sink/mongowire.py).

A copy of ``heatmap_tpu/sink/mongo.py``; on the wire backend the packed
tile rows and the position rows encode to BSON ops in C++ (the port's
``native.NativeTileOps`` / ``NativePositionOps``).

Keeps the reference's write shape — chunked unordered bulk upserts of 1000
ops (heatmap_stream.py:188-196,230-235) — and fixes its conditional-upsert
race: the reference's ``{$or: [ts missing, ts < incoming]} + upsert:true``
attempts an _id insert when an equal-or-newer doc exists, colliding with the
unique index.  Here the same monotonic intent is expressed
as a pipeline-style conditional $replaceRoot on an upsert matched by _id
only, which can never insert a duplicate.

Index DDL the reference documents as a manual mongosh step
(README.md:139-150) is applied automatically by ``ensure_indexes``.
"""

from __future__ import annotations

import logging
from typing import Iterable, Sequence

from heatmap_tpu_torch.sink.base import Store

log = logging.getLogger(__name__)

CHUNK = 1000  # reference flush size (heatmap_stream.py:191)

# (name→direction/kind maps, unique, ttl) triplets; shared by both backends
_TILE_INDEXES = [
    ({"city": 1, "grid": 1, "windowStart": -1}, False, None),
    ({"cellId": 1, "windowStart": -1}, False, None),
    # serves latest_window_start's unprefixed max-windowStart lookup
    # (the reference's manual DDL lacks it, forcing a COLLSCAN)
    ({"windowStart": -1}, False, None),
    ({"centroid": "2dsphere"}, False, None),
    ({"staleAt": 1}, False, 0),
]
_POSITION_INDEXES = [
    ({"provider": 1, "vehicleId": 1}, True, None),
    ({"loc": "2dsphere"}, False, None),
    ({"ts": -1}, False, None),
]


def _monotonic_update_pipeline(doc: dict) -> list[dict]:
    """Pipeline update applying ``doc`` only when it is newer than what is
    stored (or nothing is stored); matched by _id alone so the upsert can
    never collide with the unique index."""
    return [{"$replaceRoot": {"newRoot": {
        "$cond": [
            {"$or": [
                {"$lte": [{"$ifNull": ["$ts", None]}, None]},
                {"$lt": ["$ts", doc["ts"]]},
            ]},
            doc,
            "$$ROOT",
        ]
    }}}]


class _PymongoBackend:
    def __init__(self, uri: str, db_name: str):
        from pymongo import MongoClient

        # tz_aware: the Store contract promises timezone-aware UTC
        # datetimes (sink/base.py), matching the wire backend's codec
        self.client = MongoClient(uri, tz_aware=True)
        self.db = self.client[db_name]

    def ensure_indexes(self) -> None:
        for coll, specs in (("tiles", _TILE_INDEXES),
                            ("positions_latest", _POSITION_INDEXES)):
            c = self.db[coll]
            for keys, unique, ttl in specs:
                kw: dict = {}
                if unique:
                    kw["unique"] = True
                if ttl is not None:
                    kw["expireAfterSeconds"] = ttl
                c.create_index(list(keys.items()), **kw)

    def bulk_update(self, coll: str, updates: list[dict]) -> int:
        from pymongo import UpdateOne

        ops = [UpdateOne(u["q"], u["u"], upsert=u.get("upsert", False))
               for u in updates]
        n = 0
        for i in range(0, len(ops), CHUNK):
            r = self.db[coll].bulk_write(ops[i:i + CHUNK], ordered=False)
            n += r.modified_count + len(r.upserted_ids)
        return n

    def find(self, coll: str, filter: dict, sort: dict | None = None,
             limit: int = 0) -> Iterable[dict]:
        cur = self.db[coll].find(filter)
        if sort:
            cur = cur.sort(list(sort.items()))
        if limit:
            cur = cur.limit(limit)
        return cur

    def close(self) -> None:
        self.client.close()


class _WireBackend:
    def __init__(self, uri: str, db_name: str):
        from heatmap_tpu_torch.sink.mongowire import WireClient

        self.client = WireClient.from_uri(uri)
        self.db_name = db_name

    def ensure_indexes(self) -> None:
        for coll, specs in (("tiles", _TILE_INDEXES),
                            ("positions_latest", _POSITION_INDEXES)):
            indexes = []
            for keys, unique, ttl in specs:
                name = "_".join(f"{k}_{v}" for k, v in keys.items())
                idx: dict = {"key": keys, "name": name}
                if unique:
                    idx["unique"] = True
                if ttl is not None:
                    idx["expireAfterSeconds"] = ttl
                indexes.append(idx)
            self.client.create_indexes(self.db_name, coll, indexes)

    def bulk_update(self, coll: str, updates: list[dict]) -> int:
        n = 0
        for i in range(0, len(updates), CHUNK):
            r = self.client.update(self.db_name, coll, updates[i:i + CHUNK],
                                   ordered=False)
            n += int(r.get("nModified", 0)) + len(r.get("upserted", []))
        return n

    def bulk_update_raw(self, coll: str, ops: bytes, end_offsets) -> int:
        """Pre-encoded op docs (native/tile_ops.cpp) as OP_MSG document
        sequences, chunked at the reference's 1000-op bulk size using the
        encoder's per-op end offsets — no per-op Python work."""
        n = 0
        start = 0
        for i in range(CHUNK, len(end_offsets) + CHUNK, CHUNK):
            end = int(end_offsets[min(i, len(end_offsets)) - 1])
            r = self.client.update_docseq(self.db_name, coll,
                                          ops[start:end], ordered=False)
            n += int(r.get("nModified", 0)) + len(r.get("upserted", []))
            start = end
        return n

    def find(self, coll: str, filter: dict, sort: dict | None = None,
             limit: int = 0) -> Iterable[dict]:
        return self.client.find(self.db_name, coll, filter, sort, limit)

    def close(self) -> None:
        self.client.close()


def _make_backend(uri: str, db_name: str):
    try:
        return _PymongoBackend(uri, db_name)
    except ImportError:
        return _WireBackend(uri, db_name)


class MongoStore(Store):
    def __init__(self, uri: str, db_name: str, ensure_indexes: bool = True,
                 backend=None):
        self._b = backend if backend is not None else _make_backend(uri, db_name)
        self._tile_ops = None
        self._pos_ops = None
        self._native_probed = False
        # serve-cache version: valid while THIS process is the only
        # writer (the embedded-UI deployment); external writers are why
        # the serve layer still bounds version-keyed hits with a TTL
        self._version = 0
        if ensure_indexes:
            self.ensure_indexes()

    def version(self) -> int:
        return self._version

    def _probe_native(self) -> None:
        """One-shot set-up of the C++ encoders (wire backend only — the
        doc-sequence write path is the framework's own client).  A
        library that cannot be built raises: no Python encoder stands in
        for it."""
        if self._native_probed:
            return
        self._native_probed = True
        if not isinstance(self._b, _WireBackend):
            return
        from heatmap_tpu_torch.native import NativePositionOps, NativeTileOps

        self._tile_ops = NativeTileOps()
        self._pos_ops = NativePositionOps()

    def ensure_indexes(self) -> None:
        self._b.ensure_indexes()

    def upsert_tiles(self, docs: Sequence[dict]) -> int:
        updates = [{"q": {"_id": d["_id"]}, "u": {"$set": d}, "upsert": True}
                   for d in docs]
        if updates:
            self._b.bulk_update("tiles", updates)
            self._version += 1
        return len(updates)

    def upsert_tiles_packed(self, body, meta) -> int:
        """Fast path: C++ columnar->BSON encode + OP_MSG document-sequence
        writes (wire backend only); the pymongo backend takes the Python
        doc path."""
        self._probe_native()
        if self._tile_ops is None:
            return super().upsert_tiles_packed(body, meta)
        ops, end_offsets, n = self._tile_ops.encode(
            body, meta.city, meta.grid, meta.window_s, meta.ttl_minutes,
            meta.window_minutes_tag, meta.with_p95)
        if n:
            self._b.bulk_update_raw("tiles", ops, end_offsets)
            self._version += 1
        return n

    def upsert_positions_packed(self, rows) -> int:
        """Fast path: C++ pipeline-op encode (positions_ops.cpp) + OP_MSG
        document sequences (wire backend only); same monotonic semantics
        as upsert_positions, whose Python path the pymongo backend
        takes and the tests hold this path against."""
        self._probe_native()
        if self._pos_ops is None or not len(rows.ts_ms):
            return super().upsert_positions_packed(rows)
        ops, end_offsets, _ = self._pos_ops.encode(rows)
        self._version += 1
        return self._b.bulk_update_raw("positions_latest", ops, end_offsets)

    def upsert_positions(self, docs: Sequence[dict]) -> int:
        # race-free monotonic upsert: match on _id alone (upsert can only
        # insert when the doc is truly absent); the newer-ts condition moves
        # into an aggregation-pipeline update so older events are no-ops.
        updates = [{"q": {"_id": d["_id"]},
                    "u": _monotonic_update_pipeline(d),
                    "upsert": True}
                   for d in docs]
        # Store contract: return docs actually APPLIED (stale ones are no-ops)
        if updates:
            self._version += 1
        return self._b.bulk_update("positions_latest", updates) if updates else 0

    def latest_window_start(self, grid=None):
        q = {} if grid is None else {"grid": grid}
        for doc in self._b.find("tiles", q, sort={"windowStart": -1}, limit=1):
            return doc["windowStart"]
        return None

    def tiles_in_window(self, window_start, grid=None) -> Iterable[dict]:
        q = {"windowStart": window_start}
        if grid is not None:
            q["grid"] = grid
        return self._b.find("tiles", q)

    def all_positions(self) -> Iterable[dict]:
        return self._b.find("positions_latest", {})

    def grids(self) -> list:
        # no server-side distinct on the minimal wire backend, so this
        # pages the tiles collection and dedups client-side — cached
        # for 15 s so a /debug/view monitoring probe can't impose a
        # continuous full-collection read load on the store the query
        # tier exists to protect
        import time as _time

        cached = getattr(self, "_grids_cache", None)
        now = _time.monotonic()
        if cached is not None and now - cached[1] < 15.0:
            return cached[0]
        seen = set()
        for doc in self._b.find("tiles", {}):
            g = doc.get("grid")
            if g:
                seen.add(g)
        out = sorted(seen)
        self._grids_cache = (out, now)
        return out

    def close(self) -> None:
        self._b.close()
