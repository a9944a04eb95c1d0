"""Real-socket monitor transport: TCP client/server over the wire protocol.

The third implementation of the three-method :class:`~repro_torch.monitor.
transport.Transport` seam (after ``QueueTransport`` and
``FaultyTransport``), carrying the monitor across a real network:

* :class:`SocketTransport` — the producer-side TCP client.  ``send``
  frames the message through :mod:`repro_torch.monitor.wire` (delta
  compression on by default) and writes it; a dead link tears the
  connection down and raises :class:`~repro_torch.monitor.transport.
  TransportError` (the producer's retry/backoff handles it); the next
  send reconnects with jittered exponential backoff and fires
  ``on_reconnect`` hooks — :class:`ProducerLink` uses them to resend
  the producer's unacked deltas, and the fresh connection's encoder
  re-seeds the compression cache from full rows.  Acks stream back on
  the same socket and are applied opportunistically on every send.

* :class:`SocketServer` — the aggregator-side accept/drain loop (one
  ``selectors`` thread for all connections).  Decoded messages queue up
  behind the standard ``recv()``/``pending()`` API, so the resident
  :class:`~repro_torch.monitor.aggregator.Monitor` consumes a socket fleet
  unchanged.  ``send_acks`` pushes cumulative per-host acks back to
  each host's latest connection.

* :class:`SocketChaosProxy` — a seeded TCP fault injector sitting
  between clients and server, exercising the failures an in-process
  ``FaultyTransport`` cannot: connection RESETS, TORN frames (a prefix
  of a chunk delivered, then reset mid-write), injected GARBAGE bytes
  (frame resync on the server), and stalls.

* :func:`socket_chaos_run` — the end-to-end acceptance scenario: a
  known workload streamed through the proxy must leave the monitor's
  converged store AND rendered report bit-identical to the fault-free
  one-shot run.

Everything here is stdlib + numpy; torch enters only through the
monitor's detect backend.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import selectors
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.monitor.clock import Clock, as_clock
from repro_torch.monitor.transport import Transport, TransportError
from repro_torch.monitor.producer import Heartbeat, ShardDelta, ShardProducer
from repro_torch.monitor.validate import (backoff_bounds, port_number,
                                          positive_float, positive_int,
                                          probability)
from repro_torch.monitor.wire import (Ack, DEFAULT_MAX_FRAME, DeltaDecoder,
                                      DeltaEncoder, FrameReader, WireError,
                                      decode_message, encode_message)

_RECV_CHUNK = 1 << 16


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class SocketTransport(Transport):
    """Producer-side TCP transport with reconnect + delta compression.

    One instance per connection; several producers may share it (host
    ids travel inside the messages).  Thread-safe; all socket work
    happens inside the caller's ``send``/``recv``, no background
    thread.

    Reconnect policy: the first ``send`` after a teardown retries the
    TCP connect up to ``connect_attempts`` times with jittered
    exponential backoff (``backoff_base`` doubling to ``backoff_max``,
    each sleep stretched by up to ``jitter`` of itself, seeded) through
    the injected clock — deterministic under a
    :class:`~repro_torch.monitor.clock.ManualClock`.  If every attempt fails,
    ``send`` raises :class:`TransportError` and the producer's own
    backoff takes over.
    """

    def __init__(self, address: Tuple[str, int], *,
                 compress: bool = True,
                 connect_attempts: int = 5,
                 connect_timeout: float = 5.0,
                 send_timeout: float = 5.0,
                 backoff_base: float = 0.05,
                 backoff_max: float = 2.0,
                 jitter: float = 0.5,
                 seed: int = 0,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 clock: Optional[Clock] = None):
        host, port = address
        self.address = (str(host), port_number("address port", port,
                                               allow_zero=False))
        self.compress = bool(compress)
        self.connect_attempts = positive_int("connect_attempts",
                                             connect_attempts)
        self.connect_timeout = positive_float("connect_timeout",
                                              connect_timeout)
        self.send_timeout = positive_float("send_timeout", send_timeout)
        self.backoff_base, self.backoff_max = backoff_bounds(
            "backoff_base", backoff_base, "backoff_max", backoff_max)
        self.jitter = probability("jitter", jitter)
        self.max_frame = positive_int("max_frame", max_frame)
        self.clock = as_clock(clock)
        self.rng = random.Random(seed)
        self.acks: Dict[int, int] = {}
        self.on_reconnect: List[Callable[[], None]] = []
        self.on_ack: List[Callable[[Dict[int, int]], None]] = []
        self.stats: Dict[str, int] = collections.Counter()
        self._sock: Optional[socket.socket] = None
        self._encoder = DeltaEncoder(compress=self.compress)
        self._ack_reader = FrameReader(self.max_frame)
        self._ever_connected = False
        self._in_reconnect_hooks = False
        self._lock = threading.RLock()

    # -- connection lifecycle ------------------------------------------
    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self.stats["disconnects"] += 1

    def _ensure_connected(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        delay = self.backoff_base
        last_err: Optional[Exception] = None
        for attempt in range(self.connect_attempts):
            if attempt:
                self.clock.sleep(delay * (1.0 + self.jitter
                                          * self.rng.random()))
                delay = min(2.0 * delay, self.backoff_max)
            try:
                s = socket.create_connection(
                    self.address, timeout=self.connect_timeout)
            except OSError as e:
                last_err = e
                self.stats["connect_failures"] += 1
                continue
            s.settimeout(self.send_timeout)
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            self._sock = s
            self._encoder = DeltaEncoder(compress=self.compress)
            self._ack_reader = FrameReader(self.max_frame)
            self.stats["connects"] += 1
            was_reconnect = self._ever_connected
            self._ever_connected = True
            if was_reconnect:
                self.stats["reconnects"] += 1
                self._fire_reconnect_hooks()
            if self._sock is not None:
                return self._sock
            # a reconnect hook's own send died and tore the fresh
            # connection down; keep retrying with backoff
            last_err = TransportError("connection lost while replaying "
                                      "unacked deltas")
        raise TransportError(
            f"cannot connect to {self.address[0]}:{self.address[1]} "
            f"after {self.connect_attempts} attempts: {last_err}")

    def _fire_reconnect_hooks(self) -> None:
        # hooks resend unacked deltas, which re-enters send(); guard so
        # a reconnect during that resend does not recurse
        if self._in_reconnect_hooks:
            return
        self._in_reconnect_hooks = True
        try:
            for cb in list(self.on_reconnect):
                cb()
        finally:
            self._in_reconnect_hooks = False

    # -- Transport -----------------------------------------------------
    def send(self, msg) -> None:
        with self._lock:
            sock = self._ensure_connected()
            try:
                data = encode_message(msg, self._encoder,
                                      max_frame=self.max_frame)
            except WireError as e:
                # the receiver would discard the frame as oversize and
                # it would be resent forever; the encoder cache is also
                # ahead of a frame that never left — tear down so both
                # codec caches reset, and fail loudly
                self._teardown()
                raise TransportError(
                    f"frame for {self.address[0]}:{self.address[1]} "
                    f"exceeds max_frame: {e}") from None
            try:
                sock.sendall(data)
            except (OSError, ValueError) as e:
                # the encoder cache is ahead of the wire now; tearing the
                # connection down resets both sides to full rows
                self._teardown()
                raise TransportError(f"send to {self.address[0]}:"
                                     f"{self.address[1]} failed: {e}") \
                    from None
            self.stats["sent"] += 1
            self.stats["sent_bytes"] += len(data)
            if isinstance(msg, ShardDelta):
                self.stats["delta_bytes"] += len(data)
            self._pump_acks_locked()

    def recv(self, max_messages: Optional[int] = None) -> List:
        """The client side delivers nothing; draining it just pumps acks
        (so a composed ``FaultyTransport.recv`` keeps working)."""
        with self._lock:
            if self._sock is not None:
                self._pump_acks_locked()
        return []

    def pending(self) -> int:
        return 0

    def close(self) -> None:
        with self._lock:
            self._teardown()

    # -- acks ----------------------------------------------------------
    def _pump_acks_locked(self) -> None:
        sock = self._sock
        if sock is None:
            return
        import select
        while True:
            try:
                ready, _, _ = select.select([sock], [], [], 0)
            except (OSError, ValueError):
                self._teardown()
                return
            if not ready:
                return
            try:
                data = sock.recv(_RECV_CHUNK)
            except (OSError, ValueError):
                self._teardown()
                return
            if not data:
                self._teardown()
                return
            for msg_type, payload in self._ack_reader.feed(data):
                try:
                    m = decode_message(msg_type, payload)
                except WireError:
                    self.stats["bad_acks"] += 1
                    continue
                if isinstance(m, Ack):
                    self.acks.update(m.acks)
                    self.stats["acks"] += 1
                    for cb in list(self.on_ack):
                        cb(m.acks)


class ProducerLink:
    """Wire one :class:`ShardProducer` to a :class:`SocketTransport`.

    * acks arriving on the socket advance ``producer.ack`` (durable
      forgetting);
    * a successful RE-connect replays the producer's unacked buffer
      (the server's sequence windows drop whatever it already owns);
    * :meth:`tick` resends the unacked buffer when acks have stalled
      for ``resend_after`` seconds — the recovery path for deltas that
      died on the wire without killing the connection (e.g. frames
      lost to a garbage resync).
    """

    def __init__(self, producer: ShardProducer, transport: SocketTransport,
                 *, resend_after: Optional[float] = None,
                 clock: Optional[Clock] = None):
        self.producer = producer
        self.transport = transport
        self.resend_after = positive_float("resend_after", resend_after,
                                           allow_none=True)
        self.clock = as_clock(clock) if clock is not None \
            else transport.clock
        self._last_progress = self.clock.monotonic()
        transport.on_ack.append(self._on_ack)
        transport.on_reconnect.append(self._on_reconnect)

    def _on_ack(self, acks: Dict[int, int]) -> None:
        seq = acks.get(self.producer.host)
        if seq is None:
            return
        if seq > self.producer.acked:
            self._last_progress = self.clock.monotonic()
        self.producer.ack(seq)

    def _on_reconnect(self) -> None:
        self._last_progress = self.clock.monotonic()
        self.producer.resend_unacked()

    def tick(self) -> int:
        """Resend unacked deltas if acks have stalled; returns resent
        count."""
        if self.resend_after is None or not self.producer.unacked:
            return 0
        if self.clock.monotonic() - self._last_progress < self.resend_after:
            return 0
        self._last_progress = self.clock.monotonic()
        return self.producer.resend_unacked()


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _Conn:
    __slots__ = ("sock", "reader", "decoder", "outbuf", "events")

    def __init__(self, sock: socket.socket, max_frame: int):
        self.sock = sock
        self.reader = FrameReader(max_frame)
        self.decoder = DeltaDecoder()
        self.outbuf = bytearray()
        self.events = selectors.EVENT_READ


class SocketServer(Transport):
    """Aggregator-side TCP endpoint implementing the Transport seam.

    ``start()`` spawns ONE IO thread: a ``selectors`` loop that accepts
    connections, reassembles + decodes frames per connection, and queues
    the decoded :class:`ShardDelta` / :class:`Heartbeat` messages for
    ``recv()`` — the resident :class:`~repro_torch.monitor.aggregator.Monitor`
    polls a socket fleet exactly as it polls a ``QueueTransport``.

    ``send_acks({host: seq})`` pushes cumulative acknowledgements back
    over each host's most recent connection; the polling loop typically calls
    it with ``monitor.acked_seq`` after each poll.

    Usable as a context manager (``with SocketServer() as srv:``).
    """

    def __init__(self, address: Tuple[str, int] = ("127.0.0.1", 0), *,
                 backlog: int = 128,
                 max_frame: int = DEFAULT_MAX_FRAME):
        host, port = address
        port = port_number("address port", port)
        self.backlog = positive_int("backlog", backlog)
        self.max_frame = positive_int("max_frame", max_frame)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(self.backlog)
        self._listener.setblocking(False)
        self.address: Tuple[str, int] = self._listener.getsockname()
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._messages: collections.deque = collections.deque()
        self._conns: Dict[socket.socket, _Conn] = {}
        self._host_conn: Dict[int, _Conn] = {}
        self._closed_stats: Dict[str, int] = collections.Counter()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "SocketServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._wake()
        self._thread.join()
        self._thread = None
        with self._lock:
            for conn in list(self._conns.values()):
                self._close_conn(conn)
            try:
                self._listener.close()
            except OSError:
                pass
            for s in (self._wake_r, self._wake_w):
                try:
                    s.close()
                except OSError:
                    pass

    def __enter__(self) -> "SocketServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # -- Transport -----------------------------------------------------
    def send(self, msg) -> None:
        raise RuntimeError("SocketServer is the receive side of the "
                           "transport; producers connect with "
                           "SocketTransport")

    def recv(self, max_messages: Optional[int] = None) -> List:
        out: List = []
        with self._lock:
            while self._messages and (max_messages is None
                                      or len(out) < max_messages):
                out.append(self._messages.popleft())
        return out

    def pending(self) -> int:
        with self._lock:
            return len(self._messages)

    # -- acks ----------------------------------------------------------
    def send_acks(self, acks: Dict[int, int]) -> int:
        """Queue cumulative acks to each host's latest connection.
        Returns how many hosts had a connection to ack on (hosts whose
        connection died are skipped — the cumulative ack reaches them
        next call, on their new connection)."""
        by_conn: Dict[int, Tuple[_Conn, Dict[int, int]]] = {}
        with self._lock:
            for host, seq in acks.items():
                conn = self._host_conn.get(int(host))
                if conn is None or conn.sock not in self._conns:
                    continue
                entry = by_conn.setdefault(id(conn), (conn, {}))
                entry[1][int(host)] = int(seq)
            for conn, payload in by_conn.values():
                conn.outbuf += encode_message(Ack(payload))
        if by_conn:
            self._wake()
        return sum(len(p) for _, p in by_conn.values())

    # -- stats ---------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Aggregated wire statistics across live and closed
        connections (frames, resyncs, crc_errors, truncated,
        undecodable, connections, ...)."""
        with self._lock:
            out = collections.Counter(self._closed_stats)
            for conn in self._conns.values():
                out.update(conn.reader.stats)
                out.update(conn.decoder.stats)
        return dict(out)

    # -- the IO loop ---------------------------------------------------
    def _loop(self) -> None:
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while not self._stop.is_set():
                self._update_write_interest()
                for key, events in self._sel.select(timeout=0.2):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        conn: _Conn = key.data
                        if events & selectors.EVENT_READ:
                            self._read(conn)
                        if events & selectors.EVENT_WRITE \
                                and conn.sock in self._conns:
                            self._write(conn)
        finally:
            try:
                self._sel.close()
            except OSError:
                pass

    def _update_write_interest(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            want = selectors.EVENT_READ
            if conn.outbuf:
                want |= selectors.EVENT_WRITE
            if want != conn.events:
                conn.events = want
                try:
                    self._sel.modify(conn.sock, want, conn)
                except (KeyError, ValueError, OSError):
                    pass

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, self.max_frame)
            with self._lock:
                self._conns[sock] = conn
                self._closed_stats["connections"] += 1
            try:
                self._sel.register(sock, conn.events, conn)
            except (KeyError, ValueError):
                pass

    def _read(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop_conn(conn)
            return
        if not data:
            self._drop_conn(conn)
            return
        for msg_type, payload in conn.reader.feed(data):
            try:
                msg = decode_message(msg_type, payload, conn.decoder)
            except WireError:
                conn.decoder.stats["malformed"] += 1
                continue
            if msg is None:                  # undecodable delta: resent
                continue                     # later via the unacked buffer
            host = getattr(msg, "host", None)
            with self._lock:
                if host is not None:
                    self._host_conn[int(host)] = conn
                self._messages.append(msg)

    def _write(self, conn: _Conn) -> None:
        if not conn.outbuf:
            return
        try:
            n = conn.sock.send(bytes(conn.outbuf))
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop_conn(conn)
            return
        del conn.outbuf[:n]

    def _drop_conn(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        with self._lock:
            self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        """Caller holds the lock."""
        if conn.sock not in self._conns:
            return
        del self._conns[conn.sock]
        conn.reader.close()
        self._closed_stats.update(conn.reader.stats)
        self._closed_stats.update(conn.decoder.stats)
        self._closed_stats["disconnects"] += 1
        for host in [h for h, c in self._host_conn.items() if c is conn]:
            del self._host_conn[host]
        try:
            conn.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# chaos proxy
# ---------------------------------------------------------------------------

class SocketChaosProxy:
    """Seeded TCP fault injector between producers and the server.

    Listens on its own port and pipes every inbound connection to
    ``target``.  The producer->server direction misbehaves, per
    forwarded chunk (faults drawn from one seeded ``random.Random``):

    * ``p_reset`` — both sides are closed with an RST (SO_LINGER 0):
      a crashed peer / middlebox reset.  The client's next send fails
      and reconnects.
    * ``p_tear`` — only a PREFIX of the chunk is forwarded, then the
      connection is reset: a frame torn mid-write.  The server's frame
      reader discards the torn tail.
    * ``p_garbage`` — 1..``garbage_max`` random bytes are injected into
      the stream before the chunk: the server must resync to the next
      frame boundary (frames overlapping the garbage are lost and come
      back via the producers' unacked buffers).
    * ``p_stall`` — delivery of the chunk is delayed ``stall_s``
      seconds.

    The server->producer (ack) direction is forwarded untouched.
    ``stats`` counts every fault fired.
    """

    def __init__(self, target: Tuple[str, int], *,
                 address: Tuple[str, int] = ("127.0.0.1", 0),
                 seed: int = 0,
                 p_reset: float = 0.0, p_tear: float = 0.0,
                 p_garbage: float = 0.0, p_stall: float = 0.0,
                 garbage_max: int = 64, stall_s: float = 0.005,
                 chunk: int = 4096):
        t_host, t_port = target
        self.target = (str(t_host), port_number("target port", t_port,
                                                allow_zero=False))
        self.p_reset = probability("p_reset", p_reset)
        self.p_tear = probability("p_tear", p_tear)
        self.p_garbage = probability("p_garbage", p_garbage)
        self.p_stall = probability("p_stall", p_stall)
        self.garbage_max = positive_int("garbage_max", garbage_max)
        self.stall_s = positive_float("stall_s", stall_s)
        self.chunk = positive_int("chunk", chunk)
        self.rng = random.Random(seed)
        self.stats: Dict[str, int] = collections.Counter()
        self._rng_lock = threading.Lock()
        l_host, l_port = address
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((str(l_host), port_number("listen port",
                                                      l_port)))
        self._listener.listen(128)
        self._listener.settimeout(0.2)
        self.address: Tuple[str, int] = self._listener.getsockname()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._socks: List[socket.socket] = []
        self._socks_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "SocketChaosProxy":
        if self._accept_thread is not None:
            raise RuntimeError("proxy already started")
        self._stop.clear()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        if self._accept_thread is None:
            return
        self._stop.set()
        self._accept_thread.join()
        self._accept_thread = None
        with self._socks_lock:
            socks, self._socks = self._socks, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
        try:
            self._listener.close()
        except OSError:
            pass

    def __enter__(self) -> "SocketChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                inbound, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                upstream = socket.create_connection(self.target,
                                                    timeout=2.0)
            except OSError:
                self.stats["upstream_refused"] += 1
                self._reset(inbound)
                continue
            for s in (inbound, upstream):
                s.settimeout(0.2)
            with self._socks_lock:
                self._socks += [inbound, upstream]
            self.stats["connections"] += 1
            t1 = threading.Thread(target=self._pump, daemon=True,
                                  args=(inbound, upstream, True))
            t2 = threading.Thread(target=self._pump, daemon=True,
                                  args=(upstream, inbound, False))
            self._threads += [t1, t2]
            t1.start()
            t2.start()

    @staticmethod
    def _reset(sock: socket.socket) -> None:
        """Close with an RST instead of FIN (SO_LINGER 0)."""
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _draw(self) -> Tuple[str, float]:
        with self._rng_lock:
            u = self.rng.random()
            aux = self.rng.random()
        if u < self.p_reset:
            return "reset", aux
        u -= self.p_reset
        if u < self.p_tear:
            return "tear", aux
        u -= self.p_tear
        if u < self.p_garbage:
            return "garbage", aux
        u -= self.p_garbage
        if u < self.p_stall:
            return "stall", aux
        return "forward", aux

    def _garbage_bytes(self) -> bytes:
        with self._rng_lock:
            n = self.rng.randint(1, self.garbage_max)
            return bytes(self.rng.getrandbits(8) for _ in range(n))

    def _pump(self, src: socket.socket, dst: socket.socket,
              faulty: bool) -> None:
        try:
            while not self._stop.is_set():
                try:
                    data = src.recv(self.chunk)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                if not faulty:
                    try:
                        dst.sendall(data)
                    except OSError:
                        break
                    continue
                fault, aux = self._draw()
                if fault == "reset":
                    self.stats["resets"] += 1
                    break
                if fault == "tear":
                    self.stats["torn"] += 1
                    cut = max(1, int(len(data) * aux))
                    try:
                        dst.sendall(data[:cut])
                    except OSError:
                        pass
                    break
                if fault == "garbage":
                    self.stats["garbage"] += 1
                    try:
                        dst.sendall(self._garbage_bytes() + data)
                    except OSError:
                        break
                    continue
                if fault == "stall":
                    self.stats["stalls"] += 1
                    time.sleep(self.stall_s)
                try:
                    dst.sendall(data)
                except OSError:
                    break
                self.stats["forwarded"] += 1
        finally:
            self._reset(src)
            self._reset(dst)


# ---------------------------------------------------------------------------
# the socket acceptance scenario
# ---------------------------------------------------------------------------

def _dense_counter(store, name: str, n_vertices: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(values, mask) dense views of one counter; masked-off entries are
    0.0, so entries that are (0.0, unmasked) on one side and absent on
    the other compare equal — they are indistinguishable to every
    reader."""
    vids, values, mask = store.counter_columns(name)
    dv = np.zeros((store.n_procs, n_vertices))
    dm = np.zeros((store.n_procs, n_vertices), bool)
    if len(vids):
        dv[:, vids] = np.where(mask, values, 0.0)
        dm[:, vids] = mask
    return dv, dm


def stores_equal(a, b, n_vertices: int) -> bool:
    """Bit-identical sharded stores: time, variance, and every counter
    (dense semantics — see :func:`_dense_counter`)."""
    if not np.array_equal(a.time_matrix(n_vertices),
                          b.time_matrix(n_vertices)):
        return False
    if not np.array_equal(a.var_matrix(n_vertices),
                          b.var_matrix(n_vertices)):
        return False
    for name in sorted(set(a.counter_names()) | set(b.counter_names())):
        va, ma = _dense_counter(a, name, n_vertices)
        vb, mb = _dense_counter(b, name, n_vertices)
        if not (np.array_equal(va, vb) and np.array_equal(ma, mb)):
            return False
    return True


def socket_chaos_run(*, n_procs: int = 32, n_hosts: int = 4,
                     rounds: int = 3, seed: int = 0,
                     p_reset: float = 0.1, p_tear: float = 0.08,
                     p_garbage: float = 0.12, p_stall: float = 0.05,
                     stall_s: float = 0.002,
                     compress: bool = True,
                     faulty_wrap: Optional[Dict[str, float]] = None,
                     backend: Optional[str] = "torch",
                     device=None,
                     detect_every: Optional[int] = 4,
                     n_comp: int = 12,
                     deadline_s: float = 60.0):
    """Stream a known workload through REAL sockets + the chaos proxy
    and assert the convergence contract (see :mod:`repro_torch.monitor.chaos`
    for the queue-transport sibling): the monitor's converged store and
    rendered report must be bit-identical to the fault-free one-shot
    run.

    ``faulty_wrap`` additionally stacks the seeded in-process
    :class:`~repro_torch.monitor.transport.FaultyTransport` faults (drops,
    dup, ack loss, delay kwargs) OVER each host's socket transport —
    both fault layers at once.  ``backend`` / ``device`` pick where the
    one-shot reference and the monitor detect, as in
    :func:`~repro_torch.monitor.chaos.chaos_run` (torch on ``cuda`` by
    default).  Returns a
    :class:`~repro_torch.monitor.chaos.ChaosResult`.
    """
    from repro_torch.core.backtrack import backtrack
    from repro_torch.core.detect import detect_abnormal
    from repro_torch.core.inject import simulate
    from repro_torch.core.report import render_report
    from repro_torch.core.shard import ShardedStore, shard_ranges
    from repro_torch.monitor.aggregator import Monitor, resolve_detect
    from repro_torch.monitor.chaos import (ChaosResult, _ab_key, _truncated,
                                           build_chaos_psg)
    from repro_torch.monitor.transport import FaultyTransport

    backend, device = resolve_detect(backend, device)
    psg = build_chaos_psg(n_comp)
    V = len(psg.vertices)
    rng = np.random.default_rng(seed)
    straggler = int(rng.integers(n_procs))
    slow_vid = int(rng.integers(1, V - 1))

    def base(p, vid):
        v = psg.vertices[vid]
        return 0.0 if v.kind == "Comm" else 1.0 + 0.01 * vid

    ranges = shard_ranges(n_procs, n_hosts)
    sim = simulate(psg, n_procs, base,
                   inject={(straggler, slow_vid): 4.0},
                   comm_time=lambda *a: 0.05, jitter=0.0, seed=seed,
                   shards=ranges)
    truth_ppg = sim.ppg
    abnormal_ref = detect_abnormal(truth_ppg, backend=backend, device=device)
    paths_ref = backtrack(truth_ppg, [], abnormal_ref)

    server = SocketServer().start()
    proxy = SocketChaosProxy(server.address, seed=seed, p_reset=p_reset,
                             p_tear=p_tear, p_garbage=p_garbage,
                             p_stall=p_stall, stall_s=stall_s).start()
    monitor = Monitor(psg, ranges, server, comm=truth_ppg.comm,
                      detect_every=detect_every, backend=backend,
                      device=device)
    prod_store = ShardedStore(ranges, V)
    transports: List[SocketTransport] = []
    producers: Dict[int, ShardProducer] = {}
    links: List[ProducerLink] = []
    try:
        for h in range(n_hosts):
            tr = SocketTransport(proxy.address, compress=compress,
                                 seed=seed * 1000 + h,
                                 connect_attempts=8, connect_timeout=2.0,
                                 send_timeout=2.0, backoff_base=0.002,
                                 backoff_max=0.05)
            transports.append(tr)
            outer: Transport = tr
            if faulty_wrap:
                outer = FaultyTransport(tr, seed=seed * 7 + h,
                                        **faulty_wrap)
            p = ShardProducer(h, prod_store.shards[h], outer,
                              max_retries=6, base_backoff=0.001,
                              max_backoff=0.01)
            producers[h] = p
            links.append(ProducerLink(p, tr, resend_after=0.05))

        every = {h: np.arange(prod_store.shards[h].n_procs)
                 for h in range(n_hosts)}
        deadline = time.monotonic() + deadline_s
        for r in range(1, rounds + 1):
            c_r = max(1, (V * r) // rounds)
            for h in range(n_hosts):
                truth_block = truth_ppg.perf.shards[h].extract_rows(
                    every[h])
                block = truth_block if r == rounds \
                    else _truncated(truth_block, c_r)
                prod_store.shards[h].apply_rows(block)
                producers[h].flush(heartbeat=False)
            monitor.poll()
            server.send_acks({h: monitor.acked_seq(h)
                              for h in range(n_hosts)})

        # convergence: keep flushing retry backlogs, ticking stalled-ack
        # resends and polling until every stream is fully applied
        while True:
            done = all(monitor.high[h] >= producers[h].seq
                       and not monitor.parked[h] for h in range(n_hosts))
            if done:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "socket chaos run did not converge: "
                    f"high={monitor.high} "
                    f"seqs={ {h: p.seq for h, p in producers.items()} } "
                    f"proxy={dict(proxy.stats)} server={server.stats()}")
            for h in range(n_hosts):
                producers[h].flush(heartbeat=False)
            for link in links:
                link.tick()
            if isinstance(producers[0].transport, FaultyTransport):
                for p in producers.values():
                    try:
                        p.transport.flush_held()   # release delayed msgs
                        p.transport.recv()
                    except TransportError:
                        pass                       # still unacked: resent
            monitor.poll()
            server.send_acks({h: monitor.acked_seq(h)
                              for h in range(n_hosts)})
            time.sleep(0.002)

        report = monitor.force_detect()
    finally:
        for tr in transports:
            tr.close()
        proxy.stop()
        server.stop()

    got = [_ab_key(a) for a in report.abnormal]
    want = [_ab_key(a) for a in abnormal_ref]
    paths_got = [(p.start_reason, p.nodes) for p in report.paths]
    paths_want = [(p.start_reason, p.nodes) for p in paths_ref]

    # converged STORE bit-identical to the producers' shards
    store_match = stores_equal(monitor.store, prod_store, V)

    # rendered report bit-identical to the fault-free one-shot render
    ref_text = render_report(truth_ppg, [], abnormal_ref, paths_ref,
                             title=monitor.title,
                             max_abnormal=monitor.max_abnormal,
                             coverage=report.coverage)
    stats = collections.Counter(proxy.stats)
    stats.update(server.stats())
    return ChaosResult(
        report=report, abnormal_ref=abnormal_ref, paths_ref=paths_ref,
        abnormal_match=got == want, paths_match=paths_got == paths_want,
        coverage_stated="fleet coverage:" in report.text,
        transport_stats=dict(stats),
        duplicates_absorbed=monitor.duplicates,
        deltas_applied=monitor.applied, rounds=rounds,
        store_match=store_match,
        report_match=report.text == ref_text)
