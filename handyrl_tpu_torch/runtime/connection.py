"""Host transport of the remote actor plane: framed codec messages over TCP.

Counterpart of ``handyrl_tpu/runtime/connection.py``, frame for frame: a
``!I`` length prefix, then one message in the pickle-free codec
(runtime/codec.py), so a frame of this package carries the same bytes as
the JAX package's for the same payload.  The wire carries job args,
episodes, evaluation results and parameter blobs; it never carries a
``torch.Tensor`` (the codec refuses one) or pickled code.

* ``FramedConnection``: deadlines on every send and receive.  The default
  bounds the *stall* (time without a byte of progress), so a large blob is
  alive while bytes flow; ``hard=True`` makes it an absolute budget for
  small control frames.  Deadlines are enforced by readiness polling on a
  blocking socket, so a sender and a receiver thread on one connection
  never disturb each other's deadlines.  A payload of 4 GiB or more is
  refused before anything is sent: its length does not fit the header.
* ``send_recv``, ``open_socket_connection``, ``accept_socket_connections``
  and ``connect_socket_connection``: the socket helpers.
* ``QueueCommunicator``: a fan-in hub with one receiver thread, one bounded
  send queue and one sender thread per peer, so one stalled peer is
  dropped while the others keep flowing.
"""

from __future__ import annotations

import queue
import select
import socket
import struct
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import codec

_HEADER = struct.Struct("!I")
MAX_PAYLOAD = (1 << 32) - 1   # the largest length the u32 header holds
_CHUNK = 1 << 24              # receive buffers grow by at most this much at a time
_COALESCE = 1 << 20           # smaller frames go out as one buffer

_UNSET = object()  # "use the connection default" sentinel for timeouts


def frame_header(n: int) -> bytes:
    """The length prefix of an ``n``-byte payload; a payload too long for
    it raises instead of wrapping around."""
    if not 0 <= n <= MAX_PAYLOAD:
        raise codec.CodecError(
            f"frame payload of {n} bytes does not fit the u32 length header "
            f"(at most {MAX_PAYLOAD} bytes): split it or send it out of band")
    return _HEADER.pack(n)


def _wait_io(sock: socket.socket, for_write: bool, deadline: float) -> None:
    """Block until the socket is ready in the given direction, or raise
    ``socket.timeout`` at the deadline.  Polling mutates nothing, unlike
    ``settimeout``, which two threads on one socket would share.  The
    socket is polled once even past the deadline, so a thread that waited
    for the interpreter lock does not time out on ready bytes."""
    remaining = max(0.0, deadline - time.monotonic())
    try:
        fd = sock.fileno()
        if fd < 0:
            raise OSError("socket closed")
        poller = select.poll()
        poller.register(fd, select.POLLOUT if for_write else select.POLLIN)
        if poller.poll(remaining * 1000.0):
            return
    except ValueError:
        raise OSError("socket closed")
    raise socket.timeout(f"{'send' if for_write else 'recv'} deadline exceeded")


class FramedConnection:
    """u32-length-prefixed codec frames over a stream socket.

    ``timeout`` (the constructor's default, overridable per call) bounds the
    silence of each send or receive.  When it fires the call raises
    ``socket.timeout`` and the stream must be taken as dead: a deadline can
    fire mid-frame, so the only safe recovery is to close and reconnect."""

    def __init__(self, conn: socket.socket, timeout: Optional[float] = None):
        self.conn = conn
        self.default_timeout = timeout
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        # frame bytes (headers included) each way, counted under that
        # direction's lock: the serving plane reads them per request
        self.bytes_sent = 0
        self.bytes_received = 0

    def close(self) -> None:
        try:
            # shutdown wakes a thread blocked in a send or recv on this
            # socket, which close alone would leave wedged
            self.conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.conn.close()
        except OSError:
            pass

    def _gap(self, timeout) -> Optional[float]:
        t = self.default_timeout if timeout is _UNSET else timeout
        return None if t is None else float(t)

    @staticmethod
    def _deadline(gap: Optional[float], hard_deadline: Optional[float]) -> Optional[float]:
        now = time.monotonic()
        if hard_deadline is not None and now >= hard_deadline:
            # an absolute budget spent is spent, bytes ready or not
            raise socket.timeout("frame deadline exceeded")
        if gap is None:
            return hard_deadline
        if hard_deadline is None:
            return now + gap
        return min(now + gap, hard_deadline)

    def _recv_exact(self, n: int, gap: Optional[float],
                    hard_deadline: Optional[float] = None) -> bytes:
        """``n`` bytes; the gap deadline restarts on every chunk.  Buffers
        grow with the bytes that arrive, so a garbled length costs no
        memory until its bytes come."""
        chunks: List[bytearray] = []
        got = 0
        while got < n:
            buf = bytearray(min(n - got, _CHUNK))
            view, filled = memoryview(buf), 0
            while filled < len(buf):
                deadline = self._deadline(gap, hard_deadline)
                if deadline is not None:
                    _wait_io(self.conn, False, deadline)
                k = self.conn.recv_into(view[filled:])
                if not k:
                    raise ConnectionResetError("connection closed mid-frame")
                filled += k
            chunks.append(buf)
            got += filled
        return b"".join(chunks)

    def recv(self, timeout=_UNSET, hard: bool = False) -> Any:
        """One message; ``hard`` turns ``timeout`` into an absolute budget
        for the whole frame instead of a stall bound."""
        with self._recv_lock:
            gap = self._gap(timeout)
            hard_deadline = None
            if hard and gap is not None:
                hard_deadline, gap = time.monotonic() + gap, None
            (length,) = _HEADER.unpack(self._recv_exact(4, gap, hard_deadline))
            payload = self._recv_exact(length, gap, hard_deadline) if length else b""
            self.bytes_received += 4 + length
        return codec.loads(payload)

    @staticmethod
    def _frame(obj: Any) -> List[bytes]:
        payload = codec.dumps(obj)
        header = frame_header(len(payload))
        # a large payload goes out after its header, not copied behind it
        return [header + payload] if len(payload) < _COALESCE else [header, payload]

    def send(self, obj: Any, timeout=_UNSET, hard: bool = False) -> None:
        parts = self._frame(obj)
        with self._send_lock:
            self._send_parts(parts, self._gap(timeout), hard)

    def try_send(self, obj: Any, timeout=_UNSET) -> bool:
        """``send`` if no other frame is in flight on this connection, else
        False at once.  For liveness pings: a frame in flight already shows
        the link alive, and a ping thread must not queue behind a long
        upload while its other connections go silent."""
        parts = self._frame(obj)
        if not self._send_lock.acquire(blocking=False):
            return False
        try:
            self._send_parts(parts, self._gap(timeout))
        finally:
            self._send_lock.release()
        return True

    def _send_parts(self, parts: List[bytes], gap: Optional[float], hard: bool = False) -> None:
        """Write one frame; the caller holds the send lock."""
        self.bytes_sent += sum(len(part) for part in parts)
        if gap is None:
            for part in parts:
                self.conn.sendall(part)
            return
        hard_deadline = time.monotonic() + gap if hard else None
        for part in parts:
            view = memoryview(part)
            while view:
                # writable after the poll: send takes >= 1 byte at once
                _wait_io(self.conn, True, self._deadline(None if hard else gap, hard_deadline))
                view = view[self.conn.send(view):]


def send_recv(conn: FramedConnection, sdata: Any, timeout=_UNSET) -> Any:
    conn.send(sdata, timeout=timeout)
    return conn.recv(timeout=timeout)


def open_socket_connection(port: int) -> socket.socket:
    """A TCP socket bound to ``port`` on every interface; port 0 takes a
    free one (``sock.getsockname()[1]`` says which)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("", int(port)))
    return sock


def accept_socket_connections(
    port: Optional[int] = None,
    timeout: Optional[float] = None,
    maxsize: Optional[int] = None,
    sock: Optional[socket.socket] = None,
) -> Iterator[Optional[FramedConnection]]:
    """Yield accepted connections (None at each ``timeout``) until the
    listener closes, or ``maxsize`` have been accepted.  A listener this
    function opened itself is closed when the iteration ends."""
    owned = sock is None
    if owned:
        sock = open_socket_connection(port)
    try:
        sock.listen(1024)
        sock.settimeout(timeout)
        count = 0
        while maxsize is None or count < maxsize:
            try:
                conn, _ = sock.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(None)  # accept() hands on the listener's timeout
                yield FramedConnection(conn)
                count += 1
            except socket.timeout:
                yield None
            except OSError:
                return
    finally:
        if owned:
            sock.close()


def connect_socket_connection(host: str, port: int, timeout: float = 32.0,
                              retry_seconds: float = 0.0) -> FramedConnection:
    """Connect, retrying for ``retry_seconds`` while the peer boots."""
    deadline = time.monotonic() + retry_seconds
    while True:
        try:
            sock = socket.create_connection((host, int(port)), timeout=timeout)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.5)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return FramedConnection(sock)


class _Flushed(threading.Event):
    """A send-queue marker (``QueueCommunicator.flush``), set by the sender
    thread when it reaches it."""


class QueueCommunicator:
    """Fan-in hub over many connections.

    One receiver thread per connection puts ``(conn, message)`` on
    ``input_queue``; one sender thread per connection drains that peer's
    bounded send queue.  A peer that stops reading fills its TCP window,
    then its queue, and is dropped while the others flow.  ``recv_timeout``
    bounds each peer's silence: a peer quiet for longer (no traffic, no
    heartbeat) is presumed dead and dropped."""

    def __init__(self, recv_timeout: Optional[float] = None, send_queue_size: int = 64):
        self.input_queue: "queue.Queue[Tuple[FramedConnection, Any]]" = queue.Queue(maxsize=256)
        self.conns: Dict[FramedConnection, "queue.Queue"] = {}
        self.recv_timeout = recv_timeout
        self.send_queue_size = send_queue_size
        self._lock = threading.Lock()
        self.shutdown_flag = False
        self.silent_drops = 0  # peers dropped for silence past recv_timeout

    def connection_count(self) -> int:
        with self._lock:
            return len(self.conns)

    def connections(self) -> List[FramedConnection]:
        with self._lock:
            return list(self.conns)

    def recv(self, timeout: Optional[float] = None) -> Tuple[FramedConnection, Any]:
        return self.input_queue.get(timeout=timeout)

    def send(self, conn: FramedConnection, send_data: Any, droppable: bool = False) -> None:
        with self._lock:
            send_q = self.conns.get(conn)
        if send_q is None:
            return  # the peer is gone; its jobs were reclaimed on disconnect
        try:
            send_q.put_nowait(send_data)
        except queue.Full:
            if droppable:
                # a ping behind a long transfer: the peer is alive (bytes
                # flow), so drop the ping, not the peer
                return
            print("peer send queue overflow, dropping connection")
            self.disconnect(conn)

    def shutdown(self) -> None:
        self.shutdown_flag = True
        for conn in self.connections():
            self.disconnect(conn)

    def add_connection(self, conn: FramedConnection) -> None:
        send_q: "queue.Queue" = queue.Queue(maxsize=self.send_queue_size)
        with self._lock:
            self.conns[conn] = send_q
        threading.Thread(target=self._recv_loop, args=(conn,), daemon=True).start()
        threading.Thread(target=self._send_loop, args=(conn, send_q), daemon=True).start()

    def flush(self, conn: FramedConnection, timeout: float) -> bool:
        """Wait until every frame queued to ``conn`` so far has been written
        to its socket; False if the peer went away or ``timeout`` passed."""
        with self._lock:
            send_q = self.conns.get(conn)
        if send_q is None:
            return False
        marker = _Flushed()
        try:
            send_q.put(marker, timeout=timeout)
        except queue.Full:
            return False
        return marker.wait(timeout)

    def disconnect(self, conn: FramedConnection) -> None:
        with self._lock:
            send_q = self.conns.pop(conn, None)
        conn.close()
        if send_q is not None:
            try:
                send_q.put_nowait(_UNSET)  # wake the sender thread to exit
            except queue.Full:
                pass  # the sender finds the socket closed on its next send
            self.on_disconnect(conn)

    def on_disconnect(self, conn: FramedConnection) -> None:
        """Hook, called once per peer removed, on whichever thread noticed;
        keep it non-blocking."""

    def _recv_loop(self, conn: FramedConnection) -> None:
        while not self.shutdown_flag:
            try:
                data = conn.recv(timeout=self.recv_timeout)
            except socket.timeout:
                # silent past the deadline: presumed dead (live peers
                # heartbeat well inside it)
                self.silent_drops += 1
                self.disconnect(conn)
                return
            except (OSError, EOFError, codec.CodecError):
                self.disconnect(conn)
                return
            with self._lock:
                if conn not in self.conns:
                    return
            self.input_queue.put((conn, data))

    def _send_loop(self, conn: FramedConnection, send_q: "queue.Queue") -> None:
        while True:
            data = send_q.get()
            if data is _UNSET:
                return  # disconnected while idle
            if isinstance(data, _Flushed):
                data.set()   # every frame queued before it is written
                continue
            with self._lock:
                if conn not in self.conns:
                    return
            try:
                conn.send(data)
            except OSError:
                self.disconnect(conn)
                return
            except Exception as exc:
                # e.g. an unencodable reply: only this peer is dropped
                print("send failed, dropping connection:", exc)
                self.disconnect(conn)
                return
