"""Async serve core: a stdlib ``selectors`` (epoll on Linux) event loop
hosting the SAME WSGI app wsgiref does — selected by
``HEATMAP_SERVE_CORE=epoll`` — with single-encode zero-copy SSE fan-out.

A copy of ``heatmap_tpu/serve/evloop.py`` without the delivery-lineage
brackets (ROADMAP A6c).  Unlike the reference, a listener that cannot set
``SO_REUSEPORT`` when asked to raises instead of binding exclusively: a
``--workers`` fleet never quietly serves on one worker.

Why it exists: the wsgiref core spends a thread per request and a parked
writer thread per SSE subscriber, a thread-count wall between the serve
tier and many thousands of subscribers.  The event loop replaces both
with:

- non-blocking accept + incremental HTTP parse on one loop thread,
- a small handler pool (``HEATMAP_SERVE_LOOP_HANDLERS``) that runs the
  WSGI app — blocking store/history work never runs on the loop,
- a per-connection write-interest state machine: EVENT_WRITE is armed
  only while bytes are pending, partial writes resume at the saved
  offset (never splicing frames), and
- zero-copy fan-out: the ``FanoutHub`` channel's ONE immutable frame
  per (grid, fmt, seq) is written to every subscriber socket as the
  SAME bytes object through a shared per-channel ring — a subscriber's
  whole pending state is (cursor, offset) into that ring
  (wire._EvSub), so fan-out memory is O(channels), not O(subscribers).

Response bytes are wsgiref-identical (status line ``HTTP/1.0``, Date +
Server preamble headers, close-per-request) so the thread/epoll
differential is mechanical: byte-identical responses modulo the Date
header, identical SSE frame streams.

Semantics carried over unchanged from the thread core:
- admission control and request spans run inside the app; the span's
  ``write`` stage closes when the LOOP finishes draining the body;
- a subscriber that falls more than ``HEATMAP_SSE_QUEUE`` frames
  behind the ring head is shed with ``event: lagged`` + close, with
  its write stall visible at ``heatmap_sse_write_stall_seconds`` the
  whole time before the shed;
- a subscriber whose in-flight frame write stalls longer than
  ``HEATMAP_SSE_SEND_TIMEOUT_S`` is dropped (the thread core's socket
  send timeout, without the parked thread).
"""

from __future__ import annotations

import collections
import errno
import io
import logging
import queue
import selectors
import socket
import sys
import threading
import time
import urllib.parse
from wsgiref.handlers import format_date_time
from wsgiref.simple_server import software_version

from heatmap_tpu_torch.serve import wire as wiremod
from heatmap_tpu_torch.utils.netio import set_reuseport

log = logging.getLogger(__name__)

_MAX_HEAD = 65536          # request line + headers bound (bytes)
_MAX_BODY = 16 << 20       # request body bound (bytes)
_RECV = 65536
_LAGGED_FRAME = b"event: lagged\ndata: {}\n\n"
_HEARTBEAT = b": hb\n\n"


class EvloopStream:
    """What the app's SSE paths return instead of an ``_SSEBody`` when
    the event loop hosts the request (``environ["heatmap.evloop"]``):
    a descriptor the loop turns into a streaming connection.  The
    status/headers were already passed to ``start_response``; ``first``
    carries the preamble frames (``retry:`` + per-client catch-up)
    computed in the handler, after which the connection consumes the
    channel ring at (cursor, offset)."""

    __slots__ = ("chan", "sub", "first", "on_close", "heartbeat_s",
                 "send_timeout_s")

    def __init__(self, chan, sub, first, on_close, heartbeat_s,
                 send_timeout_s):
        self.chan = chan
        self.sub = sub
        self.first = list(first)
        self.on_close = on_close
        self.heartbeat_s = heartbeat_s
        self.send_timeout_s = send_timeout_s


class _Conn:
    """One connection's state machine: READ (incremental parse) ->
    HANDLE (pool) -> WRITE (drain at offset) -> close, or -> SSE
    streaming for stream endpoints."""

    __slots__ = ("sock", "addr", "rbuf", "out", "off", "sse", "in_frame",
                 "last_beat", "closing", "registered", "events",
                 "handling")

    def __init__(self, sock, addr):
        self.sock = sock
        self.addr = addr
        self.rbuf = b""
        # out: deque of bytes-like pending writes; off: byte offset
        # into out[0] — THE partial-write resume point
        self.out: collections.deque = collections.deque()
        self.off = 0
        self.sse: EvloopStream | None = None
        self.in_frame = False
        self.last_beat = 0.0
        self.closing = False
        self.registered = False
        self.events = 0
        self.handling = False


class EventLoopServer:
    """selectors-based HTTP server with the wsgiref servers' surface
    (``get_app``/``server_address``/``serve_forever``/``shutdown``) so
    ``serve_forever``/``start_background``/the bench harness host it
    unchanged."""

    def __init__(self, host: str, port: int, app,
                 reuse_port: bool = False, handlers: int = 8):
        self.app = app
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            if reuse_port:
                set_reuseport(ls)
            ls.bind((host, port))
        except BaseException:
            ls.close()
            raise
        # same accept backlog rationale as _ThreadingWSGIServer: a
        # polling fleet's connection-per-request bursts overflow small
        # listen queues into kernel SYN retransmit cliffs
        ls.listen(128)
        ls.setblocking(False)
        self._listener = ls
        self.server_address = ls.getsockname()
        self._sel = selectors.DefaultSelector()
        # wake pipe: handler results and fan-out broadcasts land on
        # other threads; one byte unblocks the loop's select()
        self._wr, self._ww = socket.socketpair()
        self._wr.setblocking(False)
        self._ww.setblocking(False)
        self._woken = False
        self._wake_lock = threading.Lock()
        self._results: collections.deque = collections.deque()
        self._chan_wakes: set = set()
        self._requests: queue.Queue = queue.Queue()
        self._handlers = [
            threading.Thread(target=self._handler, daemon=True,
                             name=f"serve-evloop-handler-{i}")
            for i in range(max(1, int(handlers)))]
        self._stop = False
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._conns: set[_Conn] = set()
        self._sse_by_chan: dict = {}
        self._stats = getattr(app, "serve_stats", None)
        # zero-copy fan-out wake: broadcast() calls this once per
        # channel advance (never per subscriber)
        fanout = getattr(app, "fanout", None)
        if fanout is not None:
            fanout.ev_wake = self._wake_chan

    def get_app(self):
        return self.app

    # ------------------------------------------------------------ wake
    def _wake(self) -> None:
        with self._wake_lock:
            if self._woken:
                return
            self._woken = True
        try:
            self._ww.send(b"\x00")
        except (BlockingIOError, OSError):
            pass

    def _wake_chan(self, chan) -> None:
        with self._wake_lock:
            self._chan_wakes.add(chan)
        self._wake()

    def shutdown(self) -> None:
        self._stop = True
        self._wake()
        if self._started.is_set():
            self._stopped.wait(timeout=30)

    def server_close(self) -> None:
        """wsgiref-surface parity: resources are torn down when the
        loop exits; this only covers a server that never served."""
        if not self._started.is_set():
            self._teardown()

    # --------------------------------------------------------- handlers
    def _handler(self) -> None:
        while True:
            item = self._requests.get()
            if item is None:
                return
            conn, environ = item
            captured: dict = {}

            def sr(status, headers, exc_info=None,
                   _captured=captured):
                _captured["status"] = status
                _captured["headers"] = headers
                return lambda b: None  # PEP 3333 write(); unused here

            try:
                result = self.app(environ, sr)
                if isinstance(result, EvloopStream):
                    head = _head_bytes(captured["status"],
                                       captured["headers"])
                    self._results.append(
                        (conn, head, b"", None, result))
                else:
                    try:
                        blocks = len(result)
                    except (TypeError, AttributeError):
                        blocks = None
                    body = b"".join(result)
                    # wsgiref's own Content-Length rules, mirrored
                    # exactly: an empty body gets "0" (finish_content),
                    # a single-chunk body gets its length, multi-chunk
                    # bodies get none
                    if not body:
                        clen = 0
                    elif blocks == 1:
                        clen = len(body)
                    else:
                        clen = None
                    head = _head_bytes(
                        captured["status"], captured["headers"],
                        clen=clen)
                    self._results.append(
                        (conn, head, body, result, None))
            except Exception:  # noqa: BLE001 - one bad request never kills the loop
                log.exception("evloop handler failed")
                self._results.append((conn, None, None, None, None))
            self._wake()

    # ------------------------------------------------------------- loop
    def serve_forever(self) -> None:
        for t in self._handlers:
            t.start()
        self._started.set()
        self._sel.register(self._listener, selectors.EVENT_READ,
                           ("accept", None))
        self._sel.register(self._wr, selectors.EVENT_READ,
                           ("wake", None))
        try:
            while not self._stop:
                timeout = self._tick_timeout()
                events = self._sel.select(timeout)
                t0 = time.perf_counter()
                for key, _mask in events:
                    kind, conn = key.data
                    if kind == "accept":
                        self._accept()
                    elif kind == "wake":
                        self._drain_wake()
                    else:
                        self._conn_event(conn, _mask)
                self._tick()
                if self._stats is not None:
                    self._stats.loop_iter.observe(
                        time.perf_counter() - t0)
        finally:
            self._teardown()

    def _tick_timeout(self) -> float:
        # SSE connections need heartbeat/stall scans; bare request
        # serving can sleep long
        return 0.1 if self._sse_by_chan else 0.5

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                if e.errno in (errno.EMFILE, errno.ENFILE):
                    log.warning("accept: out of file descriptors")
                    return
                if self._stop:
                    return
                raise
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, addr)
            self._conns.add(conn)
            self._register(conn, selectors.EVENT_READ)
            if self._stats is not None:
                self._stats.open_connections.set(len(self._conns))

    def _register(self, conn: _Conn, events: int) -> None:
        if conn.registered:
            if conn.events != events:
                self._sel.modify(conn.sock, events, ("conn", conn))
                conn.events = events
        else:
            self._sel.register(conn.sock, events, ("conn", conn))
            conn.registered = True
            conn.events = events

    def _unregister(self, conn: _Conn) -> None:
        if conn.registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.registered = False
            conn.events = 0

    def _drain_wake(self) -> None:
        try:
            while self._wr.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass
        with self._wake_lock:
            self._woken = False
            chans = list(self._chan_wakes)
            self._chan_wakes.clear()
        while self._results:
            self._on_result(*self._results.popleft())
        for chan in chans:
            for conn in list(self._sse_by_chan.get(chan, ())):
                self._pump_sse(conn)

    # ------------------------------------------------------------- read
    def _conn_event(self, conn: _Conn, mask: int) -> None:
        if conn.closing:
            return
        if mask & selectors.EVENT_READ:
            self._readable(conn)
        if conn.closing:
            return
        if mask & selectors.EVENT_WRITE:
            self._writable(conn)

    def _readable(self, conn: _Conn) -> None:
        if conn.sse is not None or conn.handling or conn.out:
            # data (or EOF) after the request was dispatched: for SSE
            # this is how a client disconnect becomes visible — the
            # read side returns 0/ECONNRESET long before a write fails
            try:
                data = conn.sock.recv(_RECV)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                data = b""
            if not data:
                self._close(conn)
            return
        try:
            data = conn.sock.recv(_RECV)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)
            return
        conn.rbuf += data
        self._try_dispatch(conn)

    def _try_dispatch(self, conn: _Conn) -> None:
        head_end = conn.rbuf.find(b"\r\n\r\n")
        if head_end < 0:
            if len(conn.rbuf) > _MAX_HEAD:
                self._close(conn)
            return
        head = conn.rbuf[:head_end]
        rest = conn.rbuf[head_end + 4:]
        try:
            method, path, version, headers = _parse_head(head)
        except ValueError:
            self._close(conn)
            return
        try:
            clen = int(headers.get("content-length", "0") or "0")
        except ValueError:
            self._close(conn)
            return
        if clen < 0 or clen > _MAX_BODY:
            self._close(conn)
            return
        if len(rest) < clen:
            return  # body still arriving
        body = rest[:clen]
        conn.rbuf = b""
        conn.handling = True
        environ = self._environ(conn, method, path, version, headers,
                                body)
        self._requests.put((conn, environ))

    def _environ(self, conn: _Conn, method: str, path: str,
                 version: str, headers: dict, body: bytes) -> dict:
        if "?" in path:
            path, query = path.split("?", 1)
        else:
            query = ""
        env = {
            "wsgi.version": (1, 0),
            "wsgi.url_scheme": "http",
            "wsgi.input": io.BytesIO(body),
            "wsgi.errors": sys.stderr,
            "wsgi.multithread": True,
            "wsgi.multiprocess": False,
            "wsgi.run_once": False,
            "REQUEST_METHOD": method,
            "SCRIPT_NAME": "",
            # same unquote rule as wsgiref's WSGIRequestHandler
            "PATH_INFO": urllib.parse.unquote(path, "iso-8859-1"),
            "QUERY_STRING": query,
            "SERVER_PROTOCOL": version,
            "SERVER_NAME": self.server_address[0],
            "SERVER_PORT": str(self.server_address[1]),
            "REMOTE_ADDR": conn.addr[0],
            # the loop marker the app's SSE paths branch on; the
            # thread core's "heatmap.socket" is deliberately absent —
            # arming a blocking send timeout on a non-blocking socket
            # would re-block it (the loop enforces the send timeout)
            "heatmap.evloop": True,
        }
        if body:
            env["CONTENT_LENGTH"] = str(len(body))
        ct = headers.pop("content-type", None)
        if ct is not None:
            env["CONTENT_TYPE"] = ct
        headers.pop("content-length", None)
        for k, v in headers.items():
            env["HTTP_" + k.upper().replace("-", "_")] = v
        return env

    # ---------------------------------------------------------- results
    def _on_result(self, conn: _Conn, head, body, result,
                   stream) -> None:
        conn.handling = False
        if conn.closing:
            # client vanished while the handler ran: settle the
            # deferred span/admission state anyway
            _safe_close_result(result)
            if stream is not None:
                self._detach_stream_now(stream)
            return
        if head is None:  # handler crashed
            self._close(conn)
            return
        if stream is None:
            conn.out.append(head + body)
            conn.out.append(_ResultDone(result))
        else:
            conn.sse = stream
            conn.out.append(head)
            for f in stream.first:
                conn.out.append(f)
            conn.last_beat = time.monotonic()
            self._sse_by_chan.setdefault(stream.chan, set()).add(conn)
        self._arm(conn)
        self._writable(conn)

    # ------------------------------------------------------------ write
    def _arm(self, conn: _Conn) -> None:
        want = selectors.EVENT_READ
        if conn.out or (conn.sse is not None and self._sse_ready(conn)):
            want |= selectors.EVENT_WRITE
        self._register(conn, want)

    def _sse_ready(self, conn: _Conn) -> bool:
        s = conn.sse
        with s.chan.hub._lock:
            return s.sub.cursor < s.chan.next_idx or s.chan.ev_closed

    def _writable(self, conn: _Conn) -> None:
        while True:
            if not conn.out and conn.sse is not None:
                if not self._next_sse_item(conn):
                    break
            if not conn.out:
                break
            item = conn.out[0]
            if isinstance(item, _ResultDone):
                # body fully drained: close the span (write stage =
                # the real socket drain) and the connection
                conn.out.popleft()
                _safe_close_result(item.result)
                self._close(conn)
                return
            if isinstance(item, _EndStream):
                conn.out.popleft()
                self._close(conn)
                return
            buf = item
            try:
                n = conn.sock.send(memoryview(buf)[conn.off:])
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close(conn)
                return
            conn.off += n
            if conn.off < len(buf):
                if conn.in_frame:
                    conn.sse.sub.offset = conn.off
                break  # partial write: resume at conn.off next round
            conn.out.popleft()
            conn.off = 0
            if conn.in_frame:
                self._frame_done(conn)
        if not conn.closing:
            self._arm(conn)

    def _next_sse_item(self, conn: _Conn) -> bool:
        """Stage the next pending SSE write (one at a time, so extras
        land only at frame boundaries).  Returns False when idle."""
        s = conn.sse
        sub, chan = s.sub, s.chan
        with chan.hub._lock:
            base = chan.next_idx - len(chan.ring)
            if sub.lagged or sub.cursor < base:
                item = wiremod.LAGGED
            elif sub.cursor < chan.next_idx:
                item = chan.ring[sub.cursor - base]
            elif chan.ev_closed:
                item = wiremod.CLOSED
            else:
                return False
        if item is wiremod.LAGGED:
            chan.hub.shed_ev(sub)
            conn.out.append(_LAGGED_FRAME)
            conn.out.append(_EndStream())
            return True
        if item is wiremod.CLOSED:
            conn.out.append(_EndStream())
            return True
        # the SAME bytes object every other subscriber writes — the
        # zero-copy invariant; (cursor, offset) is this subscriber's
        # whole pending state
        conn.out.append(item)
        conn.in_frame = True
        now = time.monotonic()
        with sub.cond:
            sub.write_begin_mono = now
        return True

    def _frame_done(self, conn: _Conn) -> None:
        s = conn.sse
        sub = s.sub
        conn.in_frame = False
        now = time.monotonic()
        with sub.cond:
            sub.write_begin_mono = None
            sub.last_write_mono = now
            sub.writes += 1
        sub.cursor += 1
        sub.offset = 0
        conn.last_beat = now

    # ------------------------------------------------------------- tick
    def _pump_sse(self, conn: _Conn) -> None:
        if conn.closing or conn.sse is None:
            return
        s = conn.sse
        with s.chan.hub._lock:
            base = s.chan.next_idx - len(s.chan.ring)
            overflowed = s.sub.cursor < base
        if overflowed:
            # the ring advanced past this subscriber's cursor: count
            # the shed NOW (thread-core parity — its counter fires the
            # moment the queue overflows, even while the wedged write
            # is still in flight); the lagged frame + close follow
            # once the in-flight frame drains or times out
            s.chan.hub.shed_ev(s.sub)
        self._arm(conn)
        if conn.events & selectors.EVENT_WRITE:
            self._writable(conn)

    def _tick(self) -> None:
        if self._stats is not None:
            backlog = sum(1 for c in self._conns
                          if c.events & selectors.EVENT_WRITE)
            self._stats.write_backlog.set(backlog)
            self._stats.open_connections.set(len(self._conns))
        if not self._sse_by_chan:
            return
        now = time.monotonic()
        for conns in list(self._sse_by_chan.values()):
            for conn in list(conns):
                s = conn.sse
                if s is None or conn.closing:
                    continue
                # send-timeout: an in-flight frame write stalled past
                # HEATMAP_SSE_SEND_TIMEOUT_S — drop the wedge, exactly
                # like the thread core's socket timeout
                if s.send_timeout_s > 0:
                    with s.sub.cond:
                        wbm = s.sub.write_begin_mono
                    if wbm is not None and now - wbm > s.send_timeout_s:
                        self._close(conn)
                        continue
                # heartbeat through quiet periods (same cadence rule
                # as the thread generator: only when nothing else is
                # flowing), injected at a frame boundary only
                if (not conn.out and not conn.in_frame
                        and not self._sse_ready(conn)
                        and now - conn.last_beat >= s.heartbeat_s):
                    conn.out.append(_HEARTBEAT)
                    conn.last_beat = now
                    self._arm(conn)
                    self._writable(conn)

    # ------------------------------------------------------------ close
    def _detach_stream_now(self, stream: EvloopStream) -> None:
        try:
            stream.on_close()
        except Exception:  # noqa: BLE001 - close accounting must not kill the loop
            log.exception("evloop SSE on_close failed")

    def _close(self, conn: _Conn) -> None:
        if conn.closing:
            return
        conn.closing = True
        self._unregister(conn)
        self._conns.discard(conn)
        # settle any deferred span bodies still queued
        for item in conn.out:
            if isinstance(item, _ResultDone):
                _safe_close_result(item.result)
        conn.out.clear()
        if conn.sse is not None:
            s = conn.sse
            peers = self._sse_by_chan.get(s.chan)
            if peers is not None:
                peers.discard(conn)
                if not peers:
                    self._sse_by_chan.pop(s.chan, None)
            with s.sub.cond:
                s.sub.write_begin_mono = None
            conn.sse = None
            # releases the admission slot and the fan-out registration
            # exactly once — including on a mid-write disconnect
            self._detach_stream_now(s)
        try:
            conn.sock.close()
        except OSError:
            pass
        if self._stats is not None:
            self._stats.open_connections.set(len(self._conns))

    def _teardown(self) -> None:
        fanout = getattr(self.app, "fanout", None)
        if fanout is not None and fanout.ev_wake == self._wake_chan:
            fanout.ev_wake = None
        for conn in list(self._conns):
            self._close(conn)
        for _ in self._handlers:
            self._requests.put(None)
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._listener, self._wr, self._ww):
            try:
                s.close()
            except OSError:
                pass
        self._stopped.set()


class _ResultDone:
    """Queued after a plain response body: the marker that the socket
    drain completed, closing the deferred WSGI result (span commit)."""

    __slots__ = ("result",)

    def __init__(self, result):
        self.result = result


class _EndStream:
    """Queued after a terminal SSE frame (lagged/closed): close the
    connection once everything before it has drained."""

    __slots__ = ()


def _safe_close_result(result) -> None:
    close = getattr(result, "close", None)
    if close is not None:
        try:
            close()
        except Exception:  # noqa: BLE001 - span accounting must not kill the loop
            log.exception("deferred result close failed")


def _parse_head(head: bytes):
    """(method, raw_path, version, {lower-name: value}) from the raw
    request head; raises ValueError on anything malformed."""
    lines = head.decode("iso-8859-1").split("\r\n")
    parts = lines[0].split()
    if len(parts) != 3:
        raise ValueError("bad request line")
    method, path, version = parts
    if not version.startswith("HTTP/"):
        raise ValueError("bad protocol")
    headers: dict = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise ValueError("bad header line")
        headers[name.strip().lower()] = value.strip()
    return method, path, version, headers


def _head_bytes(status: str, headers, clen: int | None = None) -> bytes:
    """The wsgiref-identical response preamble: HTTP/1.0 status line,
    Date + Server (unless the app set them), the app headers in order,
    and the implicit Content-Length wsgiref appends for single-chunk
    bodies."""
    names = {k.lower() for k, _v in headers}
    parts = [f"HTTP/1.0 {status}\r\n"]
    if "date" not in names:
        parts.append(f"Date: {format_date_time(time.time())}\r\n")
    if "server" not in names:
        parts.append(f"Server: {software_version}\r\n")
    for k, v in headers:
        parts.append(f"{k}: {v}\r\n")
    if clen is not None and "content-length" not in names:
        parts.append(f"Content-Length: {clen}\r\n")
    parts.append("\r\n")
    return "".join(parts).encode("iso-8859-1")
