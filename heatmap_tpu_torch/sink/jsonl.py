"""JSONL-backed Store: durable single-file sink for demos without MongoDB.

A copy of ``heatmap_tpu/sink/jsonl.py`` without the read-side merge of
per-shard logs (the shard fleet is not ported).

Append-only op log with an in-memory materialized view; compacts on close.
Datetimes serialize as ISO-8601 Z strings and parse back on load, so a
restarted process sees the same view the reference would read from Mongo.
"""

from __future__ import annotations

import datetime as dt
import json
import os
from typing import Sequence

from heatmap_tpu_torch.sink.base import Store, UTC
from heatmap_tpu_torch.sink.memory import MemoryStore

_DT_FIELDS = ("windowStart", "windowEnd", "staleAt", "ts")


def _enc(doc: dict) -> dict:
    out = dict(doc)
    for f in _DT_FIELDS:
        if isinstance(out.get(f), dt.datetime):
            out[f] = out[f].astimezone(UTC).isoformat()
    return out


def _dec(doc: dict) -> dict:
    for f in _DT_FIELDS:
        if isinstance(doc.get(f), str):
            try:
                doc[f] = dt.datetime.fromisoformat(doc[f])
            except ValueError:
                pass
    return doc


class JsonlStore(MemoryStore):
    """``<directory>/store.jsonl``: the op log, replayed into the
    in-memory view on open and compacted to the live view on close."""

    def __init__(self, directory: str, now_fn=None):
        super().__init__(now_fn)
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "store.jsonl")
        if os.path.exists(self.path):
            self._load(self.path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def _load(self, path: str) -> None:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                op = json.loads(line)
                doc = _dec(op["doc"])
                if op["c"] == "tiles":
                    super().upsert_tiles([doc])
                else:
                    super().upsert_positions([doc])

    def _append(self, coll: str, docs: Sequence[dict]) -> None:
        for d in docs:
            self._fh.write(json.dumps({"c": coll, "doc": _enc(d)}) + "\n")

    def upsert_tiles(self, docs: Sequence[dict]) -> int:
        n = super().upsert_tiles(docs)
        self._append("tiles", docs)
        return n

    def upsert_positions(self, docs: Sequence[dict]) -> int:
        n = super().upsert_positions(docs)
        self._append("positions", docs)
        return n

    def upsert_tiles_packed(self, body, meta) -> int:
        # NOT MemoryStore's lazy packed banking: this store's durability
        # contract is the append-only op log, so packed rows must decode
        # to docs NOW and hit the log via upsert_tiles (Store's portable
        # default does exactly that).  Positions need no override:
        # MemoryStore doesn't intercept them, so Store's default already
        # routes through this class's logging upsert_positions.
        return Store.upsert_tiles_packed(self, body, meta)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
        # compact: rewrite the live view only.  Iterate the underlying
        # doc dicts, NOT the ._tiles/._positions properties — those
        # re-acquire self._lock (non-reentrant) and would deadlock here.
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            with self._lock:
                self._compact_tiles()
                for d in self._tile_docs.values():
                    fh.write(json.dumps({"c": "tiles", "doc": _enc(d)}) + "\n")
                for d in self._pos_docs.values():
                    fh.write(json.dumps({"c": "positions", "doc": _enc(d)}) + "\n")
        os.replace(tmp, self.path)
