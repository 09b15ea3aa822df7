"""Socket I/O helpers for the Kafka wire client, the mock servers and
the serve fleet.

A copy of ``heatmap_tpu/utils/netio.py``: one definition of the
exact-read loop (EINTR-safe via Python's default retry semantics; raises
ConnectionError on EOF); and the port's one rule for a socket that must
share its port with the serve fleet's other workers
(``set_reuseport``).
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


def set_reuseport(sock: socket.socket) -> None:
    """Let ``sock`` bind a port the fleet's other workers bind too.  A
    host without ``SO_REUSEPORT`` raises: the reference logs a warning
    and binds exclusively, so a fleet could serve on one worker
    unnoticed."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError) as e:
        raise OSError(f"SO_REUSEPORT unavailable ({e}): a serve worker "
                      f"cannot share its port") from e
