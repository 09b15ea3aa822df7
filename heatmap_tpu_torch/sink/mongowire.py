"""MongoDB wire-protocol client: OP_MSG over stdlib sockets, no pymongo.

A copy of ``heatmap_tpu/sink/mongowire.py``.

The reference's sink and serving layers are thin wrappers over pymongo
(heatmap_stream.py:156-237; app.py:16,45-88); this image has no pymongo, so
the framework speaks the wire protocol itself.  Only what the pipeline
needs is implemented — which is exactly the modern server surface:

- OP_MSG (opcode 2013) request/response framing, section kind 0
- ``hello`` handshake (maxWireVersion gate for pipeline updates)
- ``update`` with multi-op batches, upserts, and aggregation-pipeline
  update documents (the race-free monotonic positions upsert)
- ``find`` + ``getMore`` cursor iteration, ``createIndexes``, ``ping``

No authentication/SCRAM and no TLS: matches the reference's local dev
deployment (mongodb://localhost:27017, README.md:165).  The client is
synchronous; concurrency comes from the sink's AsyncWriter thread.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
from typing import Iterable, Iterator
from urllib.parse import urlparse

from heatmap_tpu_torch.sink import bson

OP_MSG = 2013
_request_ids = itertools.count(1)


class WireError(RuntimeError):
    """Server returned ok:0 or a malformed/unsupported reply."""


class WriteErrors(WireError):
    """update reported per-op writeErrors (carries the server docs)."""

    def __init__(self, errors):
        super().__init__(f"write errors: {errors[:3]}{'…' if len(errors) > 3 else ''}")
        self.errors = errors


def parse_uri(uri: str) -> tuple[str, int, str | None]:
    """mongodb://host[:port][/db] → (host, port, db or None)."""
    u = urlparse(uri if "://" in uri else f"mongodb://{uri}")
    if u.scheme not in ("mongodb", ""):
        raise ValueError(f"unsupported scheme: {u.scheme}")
    db = u.path.lstrip("/") or None
    return u.hostname or "localhost", u.port or 27017, db


class WireClient:
    """One TCP connection to one mongod, OP_MSG only."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._dead = False
        self.hello = self.command("admin", {"hello": 1})
        self.max_wire_version = int(self.hello.get("maxWireVersion", 0))
        if self.max_wire_version < 8:  # 4.2: pipeline updates + modern OP_MSG
            raise WireError(
                f"server maxWireVersion {self.max_wire_version} < 8; "
                "MongoDB >= 4.2 required")

    @classmethod
    def from_uri(cls, uri: str, timeout_s: float = 10.0) -> "WireClient":
        host, port, _ = parse_uri(uri)
        return cls(host, port, timeout_s)

    # ---- framing ----------------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        from heatmap_tpu_torch.utils.netio import recv_exact

        try:
            return recv_exact(self._sock, n)
        except ConnectionError as e:
            raise WireError(str(e)) from e

    def command(self, db: str, doc: dict) -> dict:
        """Round-trip one command document; raises WireError on ok:0.

        Any socket-level failure (timeout, reset) poisons the connection:
        a late reply left in the kernel buffer would otherwise be consumed
        as the answer to the NEXT command.  Callers reconnect by building a
        new client."""
        body = dict(doc)
        body["$db"] = db
        return self._roundtrip(b"\x00" + bson.encode(body),
                               next(iter(doc), "?"))

    def _roundtrip(self, sections: bytes, label: str) -> dict:
        """Send pre-framed OP_MSG sections; return the kind-0 reply doc."""
        if self._dead:
            raise WireError("connection poisoned by a previous I/O error; "
                            "reconnect with a new WireClient")
        req_id = next(_request_ids)
        msg = struct.pack("<iiii", 16 + 4 + len(sections), req_id, 0,
                          OP_MSG) + struct.pack("<i", 0) + sections
        with self._lock:
            try:
                self._sock.sendall(msg)
                length, _rid, rto, opcode = struct.unpack(
                    "<iiii", self._recv_exact(16))
                rest = self._recv_exact(length - 16)
            except (OSError, WireError):
                self._dead = True
                self.close()
                raise
        if opcode != OP_MSG:
            raise WireError(f"unexpected reply opcode {opcode}")
        if rto != req_id:
            self._dead = True
            self.close()
            raise WireError(f"reply responseTo {rto} != request {req_id} "
                            "(connection desynced)")
        # flagBits(4) + kind byte(1) + document
        if rest[4] != 0:
            raise WireError(f"unexpected section kind {rest[4]}")
        reply = bson.decode(rest[5:])
        if not reply.get("ok"):
            raise WireError(f"{label}: {reply.get('errmsg', reply)}")
        return reply

    # ---- commands the sink/serve layers use -------------------------------

    def ping(self) -> None:
        self.command("admin", {"ping": 1})

    def update(self, db: str, coll: str, updates: list[dict],
               ordered: bool = False) -> dict:
        """updates: [{"q": filter, "u": doc-or-pipeline, "upsert": bool,
        "multi": bool}], chunked by the caller."""
        reply = self.command(db, {"update": coll, "updates": updates,
                                  "ordered": ordered})
        if reply.get("writeErrors"):
            raise WriteErrors(reply["writeErrors"])
        return reply

    def update_docseq(self, db: str, coll: str, ops: bytes,
                      ordered: bool = False) -> dict:
        """update with pre-encoded op documents as an OP_MSG document
        sequence (section kind 1) — the zero-copy path for the C++ tile
        encoder's output: the op bytes go from the native buffer to the
        socket without Python ever materializing the documents."""
        body = bson.encode({"update": coll, "ordered": ordered, "$db": db})
        ident = b"updates\x00"
        sec1 = (b"\x01" + struct.pack("<i", 4 + len(ident) + len(ops))
                + ident + ops)
        reply = self._roundtrip(b"\x00" + body + sec1, "update")
        if reply.get("writeErrors"):
            raise WriteErrors(reply["writeErrors"])
        return reply

    def find(self, db: str, coll: str, filter: dict | None = None,
             sort: dict | None = None, limit: int = 0,
             batch_size: int = 1000) -> Iterator[dict]:
        cmd: dict = {"find": coll, "filter": filter or {},
                     "batchSize": batch_size}
        if sort:
            cmd["sort"] = sort
        if limit:
            cmd["limit"] = limit
        reply = self.command(db, cmd)
        cursor = reply["cursor"]
        yield from cursor["firstBatch"]
        while cursor["id"]:
            # cursor id must encode as int64: mongod type-checks getMore
            reply = self.command(db, {"getMore": bson.Int64(cursor["id"]),
                                      "collection": coll,
                                      "batchSize": batch_size})
            cursor = reply["cursor"]
            yield from cursor["nextBatch"]

    def find_one(self, db: str, coll: str, filter: dict | None = None,
                 sort: dict | None = None) -> dict | None:
        for doc in self.find(db, coll, filter, sort, limit=1):
            return doc
        return None

    def create_indexes(self, db: str, coll: str,
                       indexes: Iterable[dict]) -> None:
        self.command(db, {"createIndexes": coll, "indexes": list(indexes)})

    def drop_collection(self, db: str, coll: str) -> None:
        try:
            self.command(db, {"drop": coll})
        except WireError as e:  # dropping a missing collection is fine
            if "ns not found" not in str(e):
                raise

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
