"""Content hashes of tile docs: the digest primitives of the integrity
observatory.

A copy of ``doc_hash``, ``_canon`` and ``combine_digests`` from
``heatmap_tpu/obs/audit.py``.  The history chunks carry one ``doc_hash``
per doc (query/history.py), so a compactor restart keeps each window's
XOR digest exact.  The event-conservation ledger (``AuditState``) and the
per-window ``DigestTable`` the view keeps under ``HEATMAP_AUDIT=1`` belong
to observability (ROADMAP A6) and are not ported yet: the port's view
publishes no ``"dg"`` digest in its feed records.
"""

from __future__ import annotations

import datetime as _dt
import hashlib


def _canon(v) -> str:
    if isinstance(v, _dt.datetime):
        return v.isoformat()
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{k}:{_canon(v[k])}" for k in sorted(v)) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_canon(x) for x in v) + "]"
    return repr(v)


def doc_hash(doc: dict) -> int:
    """Stable 64-bit content hash of one tile doc: salt-free blake2b
    over the canonicalized (sorted-key, ISO-datetime, repr-float) doc,
    so every process, shard, and replica derives the same value from
    the same content — Python's salted ``hash`` is exactly what this
    must NOT be."""
    parts = [f"{k}={_canon(doc[k])}" for k in sorted(doc)]
    h = hashlib.blake2b("|".join(parts).encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def combine_digests(digests) -> int:
    """XOR-combine per-shard window digests (disjoint cell spaces) into
    the merged-view digest; the empty iterable is the identity 0."""
    out = 0
    for d in digests:
        out ^= int(d)
    return out
