"""In-process mock MongoDB server speaking OP_MSG over a real TCP socket.

A copy of ``heatmap_tpu/testing/mock_mongod.py``; it binds an ephemeral
port unless one is given.

Implements just enough of the server surface to exercise the framework's
wire client (sink/mongowire.py) and MongoStore end-to-end without a mongod
binary: hello/ping, update (including upserts and the aggregation-pipeline
conditional the monotonic positions upsert uses), find + getMore cursors,
createIndexes, and drop.  Pipeline evaluation follows MongoDB's expression
semantics for the operators the sink emits ($replaceRoot, $cond, $or, $lt,
$lte, $ifNull, field refs, $$ROOT).

This is a test double, not a database: single-threaded per connection,
everything in dicts, no durability.
"""

from __future__ import annotations

import datetime as dt
import itertools
import socketserver
import struct
import threading
from typing import Any

from heatmap_tpu_torch.sink import bson

_MISSING = object()


def _type_rank(v) -> int:
    """BSON comparison type order (subset the pipeline can encounter)."""
    if v is None or v is _MISSING:
        return 0
    if isinstance(v, bool):
        return 3
    if isinstance(v, (int, float)):
        return 1
    if isinstance(v, str):
        return 2
    if isinstance(v, dt.datetime):
        return 4
    return 5


def _cmp(a, b) -> int:
    ra, rb = _type_rank(a), _type_rank(b)
    if ra != rb:
        return -1 if ra < rb else 1
    if ra == 0:
        return 0
    if a == b:
        return 0
    return -1 if a < b else 1


def _eval(expr, doc: dict):
    """Evaluate an aggregation expression against ``doc``."""
    if isinstance(expr, str):
        if expr == "$$ROOT":
            return doc
        if expr.startswith("$$"):
            raise ValueError(f"unsupported system variable {expr}")
        if expr.startswith("$"):
            cur: Any = doc
            for part in expr[1:].split("."):
                if isinstance(cur, dict) and part in cur:
                    cur = cur[part]
                else:
                    return None  # missing resolves to null in expressions
            return cur
        return expr
    if isinstance(expr, dict):
        if len(expr) == 1:
            (op, args), = expr.items()
            if op == "$cond":
                c, t, f = args
                return _eval(t, doc) if _eval(c, doc) else _eval(f, doc)
            if op == "$or":
                return any(bool(_eval(a, doc)) for a in args)
            if op == "$and":
                return all(bool(_eval(a, doc)) for a in args)
            if op == "$lt":
                return _cmp(_eval(args[0], doc), _eval(args[1], doc)) < 0
            if op == "$lte":
                return _cmp(_eval(args[0], doc), _eval(args[1], doc)) <= 0
            if op == "$gt":
                return _cmp(_eval(args[0], doc), _eval(args[1], doc)) > 0
            if op == "$gte":
                return _cmp(_eval(args[0], doc), _eval(args[1], doc)) >= 0
            if op == "$eq":
                return _cmp(_eval(args[0], doc), _eval(args[1], doc)) == 0
            if op == "$ifNull":
                for a in args:
                    v = _eval(a, doc)
                    if v is not None:
                        return v
                return None
        # literal document: keys are output fields, values are expressions
        return {k: _eval(v, doc) for k, v in expr.items()}
    if isinstance(expr, list):
        return [_eval(e, doc) for e in expr]
    return expr


def _match(doc: dict, q: dict) -> bool:
    for k, want in q.items():
        if _cmp(doc.get(k, _MISSING), want) != 0:
            return False
    return True


def _apply_update(existing: dict | None, q: dict, u) -> dict:
    """Returns the post-image document."""
    base = dict(existing) if existing is not None else {
        k: v for k, v in q.items() if not k.startswith("$")}
    if isinstance(u, list):  # aggregation pipeline
        doc = base
        for stage in u:
            (op, args), = stage.items()
            if op == "$replaceRoot":
                doc = _eval(args["newRoot"], doc)
                if not isinstance(doc, dict):
                    raise ValueError("$replaceRoot must produce a document")
            elif op == "$set":
                doc = {**doc, **{k: _eval(v, doc) for k, v in args.items()}}
            elif op == "$unset":
                fields = args if isinstance(args, list) else [args]
                doc = {k: v for k, v in doc.items() if k not in fields}
            else:
                raise ValueError(f"unsupported pipeline stage {op}")
        return doc
    if u and not next(iter(u)).startswith("$"):  # replacement document
        doc = dict(u)
        doc.setdefault("_id", (existing or q).get("_id"))
        return doc
    doc = base
    for op, args in u.items():
        if op == "$set":
            doc.update(args)
        elif op == "$unset":
            for k in args:
                doc.pop(k, None)
        else:
            raise ValueError(f"unsupported update operator {op}")
    return doc


class _State:
    def __init__(self):
        self.dbs: dict[str, dict[str, dict[Any, dict]]] = {}
        self.indexes: dict[tuple[str, str], list[dict]] = {}
        self.cursors: dict[int, list[dict]] = {}
        self.cursor_ids = itertools.count(1000)
        self.lock = threading.Lock()

    def coll(self, db: str, name: str) -> dict[Any, dict]:
        return self.dbs.setdefault(db, {}).setdefault(name, {})


class _Handler(socketserver.BaseRequestHandler):
    def _recv_exact(self, n: int) -> bytes | None:
        from heatmap_tpu_torch.utils.netio import recv_exact_or_none

        return recv_exact_or_none(self.request, n)

    def handle(self):
        while True:
            hdr = self._recv_exact(16)
            if hdr is None:
                return
            length, req_id, _rto, opcode = struct.unpack("<iiii", hdr)
            body = self._recv_exact(length - 16)
            if body is None or opcode != 2013:
                return
            cmd = self._parse_sections(body)
            if cmd is None:
                return
            with self.server.state.lock:  # type: ignore[attr-defined]
                reply = self._dispatch(cmd)
            payload = bson.encode(reply)
            out = struct.pack("<iiii", 16 + 4 + 1 + len(payload), 0, req_id,
                              2013) + struct.pack("<i", 0) + b"\x00" + payload
            self.request.sendall(out)

    @staticmethod
    def _parse_sections(body: bytes) -> dict | None:
        """OP_MSG sections -> one command dict.  Kind-1 document sequences
        are folded in as array fields, which is exactly how the server
        treats them (a sequence is an alternative encoding of a command
        array argument)."""
        cmd: dict | None = None
        seqs: dict[str, list[dict]] = {}
        i = 4  # skip flagBits (always sent 0 by the framework's client)
        while i < len(body):
            kind = body[i]
            i += 1
            (sz,) = struct.unpack_from("<i", body, i)
            if kind == 0:
                doc = bson.decode(body[i:i + sz])
                if cmd is None:
                    cmd = doc
                i += sz
            elif kind == 1:
                end = i + sz
                j = i + 4
                nul = body.index(b"\x00", j)
                ident = body[j:nul].decode("utf-8")
                j = nul + 1
                docs = []
                while j < end:
                    (dsz,) = struct.unpack_from("<i", body, j)
                    docs.append(bson.decode(body[j:j + dsz]))
                    j += dsz
                seqs[ident] = docs
                i = end
            else:
                return None
        if cmd is None:
            return None
        cmd.update(seqs)
        return cmd

    # ---- command dispatch -------------------------------------------------

    def _dispatch(self, cmd: dict) -> dict:
        st: _State = self.server.state  # type: ignore[attr-defined]
        db = cmd.get("$db", "admin")
        try:
            if "hello" in cmd or "ismaster" in cmd:
                return {"ok": 1.0, "isWritablePrimary": True,
                        "maxWireVersion": 17, "minWireVersion": 0,
                        "maxBsonObjectSize": 16 * 1024 * 1024}
            if "ping" in cmd:
                return {"ok": 1.0}
            if "update" in cmd:
                return self._update(st, db, cmd)
            if "find" in cmd:
                return self._find(st, db, cmd)
            if "getMore" in cmd:
                return self._get_more(st, cmd)
            if "createIndexes" in cmd:
                st.indexes.setdefault((db, cmd["createIndexes"]), []).extend(
                    cmd["indexes"])
                return {"ok": 1.0}
            if "drop" in cmd:
                dropped = st.dbs.get(db, {}).pop(cmd["drop"], None)
                if dropped is None:
                    return {"ok": 0.0, "errmsg": "ns not found"}
                return {"ok": 1.0}
            return {"ok": 0.0,
                    "errmsg": f"no such command: {next(iter(cmd))}"}
        except Exception as e:  # surface evaluator errors as server errors
            return {"ok": 0.0, "errmsg": f"{type(e).__name__}: {e}"}

    def _update(self, st: _State, db: str, cmd: dict) -> dict:
        coll = st.coll(db, cmd["update"])
        n, n_modified, upserted = 0, 0, []
        for i, op in enumerate(cmd["updates"]):
            q, u = op["q"], op["u"]
            if set(q) == {"_id"} and not isinstance(q["_id"], dict):
                # point query on the primary key: the collection dict IS
                # the _id index — a real server never scans for these,
                # and the framework's bulk upserts (1000 statements per
                # command) made the O(n_docs) scan per statement the
                # dominant cost of every at-rate test run
                hit = coll.get(q["_id"])
                matches = [hit] if hit is not None else []
            else:
                matches = [d for d in coll.values() if _match(d, q)]
            if matches:
                targets = matches if op.get("multi") else matches[:1]
                for old in targets:
                    new = _apply_update(old, q, u)
                    new.setdefault("_id", old["_id"])
                    if new["_id"] != old["_id"]:
                        raise ValueError("_id is immutable")
                    n += 1
                    if new != old:
                        n_modified += 1
                        coll[new["_id"]] = new
            elif op.get("upsert"):
                new = _apply_update(None, q, u)
                if "_id" not in new:
                    raise ValueError("upsert document missing _id")
                n += 1
                coll[new["_id"]] = new
                upserted.append({"index": i, "_id": new["_id"]})
        reply: dict = {"ok": 1.0, "n": n, "nModified": n_modified}
        if upserted:
            reply["upserted"] = upserted
        return reply

    def _find(self, st: _State, db: str, cmd: dict) -> dict:
        coll = st.coll(db, cmd["find"])
        docs = [d for d in coll.values() if _match(d, cmd.get("filter") or {})]
        sort = cmd.get("sort") or {}
        for key, direction in reversed(list(sort.items())):
            docs.sort(key=lambda d, k=key: (_type_rank(d.get(k)), d.get(k, 0)),
                      reverse=direction < 0)
        limit = cmd.get("limit") or 0
        if limit:
            docs = docs[:limit]
        batch_n = cmd.get("batchSize") or 101
        first, rest = docs[:batch_n], docs[batch_n:]
        cursor_id = 0
        if rest:
            cursor_id = next(st.cursor_ids)
            st.cursors[cursor_id] = rest
        ns = f"{db}.{cmd['find']}"
        return {"ok": 1.0, "cursor": {"id": cursor_id, "ns": ns,
                                      "firstBatch": first}}

    def _get_more(self, st: _State, cmd: dict) -> dict:
        cid = cmd["getMore"]
        if not isinstance(cid, bson.Int64):
            # match the real server's type check so clients that encode the
            # cursor id as int32 fail here too
            return {"ok": 0.0, "errmsg":
                    "BSON field 'getMore.getMore' is the wrong type 'int', "
                    "expected type 'long'"}
        pending = st.cursors.get(cid, [])
        batch_n = cmd.get("batchSize") or 101
        batch, rest = pending[:batch_n], pending[batch_n:]
        if rest:
            st.cursors[cid] = rest
            nid = cid
        else:
            st.cursors.pop(cid, None)
            nid = 0
        return {"ok": 1.0, "cursor": {"id": nid, "ns": "", "nextBatch": batch}}


class MockMongod:
    """``with MockMongod() as uri: MongoStore(uri, "mobility")``"""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._server.state = _State()  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def state(self) -> _State:
        return self._server.state  # type: ignore[attr-defined]

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    @property
    def uri(self) -> str:
        host, port = self.address
        return f"mongodb://{host}:{port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> str:
        return self.uri

    def __exit__(self, *exc) -> None:
        self.close()
