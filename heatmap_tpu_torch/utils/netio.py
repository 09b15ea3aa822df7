"""Socket I/O helpers for the Kafka wire client and the mock broker.

A copy of ``heatmap_tpu/utils/netio.py``: one definition of the
exact-read loop (EINTR-safe via Python's default retry semantics; raises
ConnectionError on EOF).
"""

from __future__ import annotations

import socket


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes or raise ConnectionError on EOF.

    recv_into a single preallocated buffer: the chunks+join pattern
    allocated and copied every receive twice, which at multi-MiB fetch
    responses was a measurable slice of the ingest wall (round-5
    profile)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("connection closed by peer")
        got += r
    return bytes(buf)


def recv_exact_or_none(sock: socket.socket, n: int) -> bytes | None:
    """Server-side variant: None on clean EOF (client went away)."""
    try:
        return recv_exact(sock, n)
    except ConnectionError:
        return None
