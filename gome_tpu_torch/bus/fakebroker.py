"""In-process AMQP 0-9-1 broker speaking the frame-protocol subset the
client (gome_tpu_torch.bus.amqp) and the reference (rabbitmq.go) use. The
port's copy of ``gome_tpu/bus/fakebroker.py``.

No RabbitMQ exists in this environment, so the AMQP transport is tested
against this: a real TCP server doing the real handshake, queue
declaration, publish/content framing, consumer delivery, multiple-flag
acks, and unacked-requeue on connection loss (the at-least-once semantics
RabbitMQ provides). Tests and local single-host deployments can run the
full reference topology — gateway and consumer processes joined by AMQP —
without an external broker.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import deque

from .amqp import (
    EMPTY_TABLE,
    FLAG_HEADERS,
    FRAME_BODY,
    FRAME_END,
    FRAME_HEADER,
    FRAME_METHOD,
    PROTOCOL_HEADER,
    content_frames,
    frame,
    longstr,
    method,
    read_exact,
    read_frame,
    read_longstr,
    read_shortstr,
    read_table,
    shortstr,
    skip_table,
)


class _BrokerQueue:
    def __init__(self, name: str):
        self.name = name
        # (body, redelivered, headers): the redelivered flag rides
        # Basic.Deliver so a reconnecting consumer can tell replayed
        # deliveries from fresh ones (RabbitMQ semantics; bus.amqp.
        # SupervisedAmqpQueue keys its exact-resume dedup on it); headers
        # are the publisher's basic-properties table, preserved verbatim
        # across delivery AND redelivery (trace propagation relies on it).
        self.pending: deque[tuple[bytes, bool, dict | None]] = deque()
        self.consumers: list["_Connection"] = []  # round-robin order
        self.drain_lock = threading.Lock()  # one drainer at a time (FIFO)
        self._rr = 0

    def next_consumer(self):
        live = [c for c in self.consumers if not c.closed]
        self.consumers = live
        if not live:
            return None
        c = live[self._rr % len(live)]
        self._rr += 1
        return c


class _Connection:
    def __init__(self, broker: "FakeBroker", sock: socket.socket):
        self.broker = broker
        self.sock = sock
        self.closed = False  # single-writer: this connection's reader thread
        self.wlock = threading.Lock()
        self.dlock = threading.Lock()  # delivery-tag + unacked consistency
        # tag -> (queue, body, headers)  # guarded by self.dlock
        self.unacked: dict[int, tuple[str, bytes, dict | None]] = {}
        self.consuming: list[str] = []  # single-writer: the reader thread
        self._next_tag = 1  # guarded by self.dlock
        # (queue, bytearray, [size], [headers])
        self._pending_pub: tuple | None = None  # single-writer: the reader thread
        self._publishes = 0  # single-writer: the reader thread (fault accounting)
        self._confirm = False  # single-writer: the reader thread (Confirm.Select)
        self._pub_tag = 0  # single-writer: the reader thread (ack tag sequence)

    def send(self, data: bytes) -> None:
        with self.wlock:
            self.sock.sendall(data)

    def deliver(
        self,
        queue: str,
        body: bytes,
        redelivered: bool = False,
        headers: dict | None = None,
    ) -> None:
        # Broker threads for DIFFERENT producer connections can deliver to
        # the same consumer concurrently: tag allocation + unacked insert +
        # the send must be one atomic unit or tags duplicate and unacked
        # entries vanish (breaking the redelivery guarantee this broker
        # exists to test).
        with self.dlock:
            tag = self._next_tag
            self._next_tag += 1
            self.unacked[tag] = (queue, body, headers)
            deliver = method(
                60,
                60,
                shortstr(f"c-{queue}")
                + struct.pack(">QB", tag, 1 if redelivered else 0)
                + shortstr("")
                + shortstr(queue),
            )
            parts = [frame(FRAME_METHOD, 1, deliver)] + content_frames(
                1, body, self.broker.frame_max, headers=headers
            )
            self.send(b"".join(parts))

    # -- frame handlers ---------------------------------------------------
    def run(self) -> None:
        try:
            hdr = read_exact(self.sock, 8)
            if hdr != PROTOCOL_HEADER:
                self.sock.close()
                return
            start = method(
                10,
                10,
                bytes([0, 9])
                + EMPTY_TABLE
                + longstr(b"PLAIN")
                + longstr(b"en_US"),
            )
            self.send(frame(FRAME_METHOD, 0, start))
            if self.broker.heartbeat and not self.broker.mute_heartbeats:
                threading.Thread(
                    target=self._heartbeat_loop, daemon=True
                ).start()
            if self.broker.heartbeat:
                # Enforce like RabbitMQ: a peer silent for ~2 intervals is
                # dead. (Heartbeat frames from the client count.)
                self.sock.settimeout(2.0 * self.broker.heartbeat + 0.5)
            while not self.closed:
                ftype, channel, payload = read_frame(self.sock)
                if ftype == FRAME_METHOD:
                    self._method(channel, memoryview(payload))
                elif ftype == FRAME_HEADER and self._pending_pub:
                    (size,) = struct.unpack_from(">Q", payload, 4)
                    (flags,) = struct.unpack_from(">H", payload, 12)
                    if flags & FLAG_HEADERS:
                        hdrs, _ = read_table(memoryview(payload), 14)
                        self._pending_pub[3][0] = hdrs or None
                    self._pending_pub[2][0] = size
                    if size == 0:
                        self._finish_publish()
                elif ftype == FRAME_BODY and self._pending_pub:
                    self._pending_pub[1].extend(payload)
                    if len(self._pending_pub[1]) >= self._pending_pub[2][0]:
                        self._finish_publish()
        except (ConnectionError, OSError, socket.timeout):
            pass
        finally:
            self.closed = True
            try:
                self.sock.close()
            except OSError:
                pass
            self.broker._requeue_unacked(self)

    def _method(self, channel: int, buf: memoryview) -> None:
        class_id, method_id = struct.unpack_from(">HH", buf, 0)
        off = 4
        if (class_id, method_id) == (10, 11):  # StartOk
            off = skip_table(buf, off)
            _mech, off = read_shortstr(buf, off)
            _resp, off = read_longstr(buf, off)
            tune = method(
                10,
                30,
                struct.pack(
                    ">HIH", 2047, self.broker.frame_max,
                    self.broker.heartbeat,
                ),
            )
            self.send(frame(FRAME_METHOD, 0, tune))
        elif (class_id, method_id) == (10, 31):  # TuneOk
            pass
        elif (class_id, method_id) == (10, 40):  # Open
            self.send(frame(FRAME_METHOD, 0, method(10, 41, shortstr(""))))
        elif (class_id, method_id) == (10, 50):  # Close
            self.send(frame(FRAME_METHOD, 0, method(10, 51)))
            self.closed = True
        elif (class_id, method_id) == (20, 10):  # Channel.Open
            self.send(
                frame(FRAME_METHOD, channel, method(20, 11, longstr(b"")))
            )
        elif (class_id, method_id) == (50, 10):  # Queue.Declare
            off += 2  # reserved
            qname, off = read_shortstr(buf, off)
            q = self.broker._queue(qname)
            ok = method(
                50,
                11,
                shortstr(qname) + struct.pack(">II", len(q.pending), 0),
            )
            self.send(frame(FRAME_METHOD, channel, ok))
        elif (class_id, method_id) == (60, 40):  # Basic.Publish
            off += 2  # reserved
            _ex, off = read_shortstr(buf, off)
            rkey, off = read_shortstr(buf, off)
            self._publishes += 1
            if self._publishes == self.broker.close_abruptly_on_publish:
                # Fault mode: the broker process dies mid-stream — no
                # Close method, just a dead socket (kill -9 equivalent).
                # shutdown first so the peer SEES the death immediately
                # (close alone leaves its blocked reader hanging).
                try:
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self.sock.close()
                self.closed = True
                return
            if self._publishes == self.broker.channel_close_on_publish:
                # Fault mode: server-initiated Channel.Close (e.g. 404
                # NOT_FOUND / resource error) instead of accepting.
                self.send(
                    frame(
                        FRAME_METHOD,
                        channel,
                        method(
                            20,
                            40,
                            struct.pack(">H", 404)
                            + shortstr("NOT_FOUND - fault injection")
                            + struct.pack(">HH", 60, 40),
                        ),
                    )
                )
                return
            self._pending_pub = (rkey, bytearray(), [0], [None])
        elif (class_id, method_id) == (60, 20):  # Basic.Consume
            off += 2
            qname, off = read_shortstr(buf, off)
            ctag, off = read_shortstr(buf, off)
            self.consuming.append(qname)
            self.send(
                frame(FRAME_METHOD, channel, method(60, 21, shortstr(ctag)))
            )
            self.broker._attach_consumer(qname, self)
        elif (class_id, method_id) == (60, 80):  # Basic.Ack
            tag, multiple = struct.unpack_from(">QB", buf, off)
            with self.dlock:
                if multiple:
                    for t in [t for t in self.unacked if t <= tag]:
                        self.unacked.pop(t, None)
                else:
                    self.unacked.pop(tag, None)
        elif (class_id, method_id) == (85, 10):  # Confirm.Select
            self._confirm = True
            self.send(frame(FRAME_METHOD, channel, method(85, 11)))
        # anything else: ignore (permissive test broker)

    def _finish_publish(self) -> None:
        qname, body, _, hdr = self._pending_pub
        self._pending_pub = None
        self.broker._publish(qname, bytes(body), headers=hdr[0])
        if self._confirm:
            # Publisher confirm: Basic.Ack AFTER the enqueue — a killed
            # connection whose publish was dropped never acks, which is
            # what lets a supervised publisher retry exactly.
            self._pub_tag += 1
            self.send(
                frame(
                    FRAME_METHOD, 1,
                    method(60, 80, struct.pack(">QB", self._pub_tag, 0)),
                )
            )

    def _heartbeat_loop(self) -> None:
        hb = frame(8, 0, b"")  # FRAME_HEARTBEAT
        while not self.closed:
            import time

            time.sleep(self.broker.heartbeat / 2.0)
            if self.closed:
                return
            try:
                self.send(hb)
            except OSError:
                return


class FakeBroker:
    """Threaded localhost AMQP broker. start() binds an ephemeral port
    (.port); stop() closes everything.

    Fault modes (protocol-strictness testing — behaviors a well-behaved
    fake never produces but a real broker/network does):
      heartbeat       — propose N-second heartbeats in Tune and ENFORCE
                        them (silent peers are dropped after ~2N);
      mute_heartbeats — with heartbeat set, the broker never sends its
                        own (clients must detect the silence and fail);
      frame_max       — propose a small frame size (content must split);
      channel_close_on_publish — the Nth Basic.Publish draws a
                        server-initiated Channel.Close(404);
      close_abruptly_on_publish — the Nth Basic.Publish kills the socket
                        with no Close handshake (broker crash)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat: int = 0,
        mute_heartbeats: bool = False,
        frame_max: int = 131072,
        channel_close_on_publish: int | None = None,
        close_abruptly_on_publish: int | None = None,
    ):
        self.host = host
        self.port = port  # single-writer: start() caller (rebound to the bound port)
        self.heartbeat = heartbeat
        self.mute_heartbeats = mute_heartbeats
        self.frame_max = frame_max
        self.channel_close_on_publish = channel_close_on_publish
        self.close_abruptly_on_publish = close_abruptly_on_publish
        self._server: socket.socket | None = None  # single-writer: start()/stop() caller
        self._lock = threading.Lock()
        self._queues: dict[str, _BrokerQueue] = {}
        self._conns: list[_Connection] = []
        self._stop = False  # single-writer: stop() caller

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "FakeBroker":
        self._server = socket.create_server((self.host, self.port))
        self.port = self._server.getsockname()[1]
        threading.Thread(
            target=self._accept_loop, name="fake-amqp", daemon=True
        ).start()
        return self

    def stop(self) -> None:
        self._stop = True
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
            # Wake the accept thread (a blocked accept() keeps the LISTEN
            # socket's file description open — the port would linger).
            try:
                socket.create_connection(
                    (self.host, self.port), timeout=0.2
                ).close()
            except OSError:
                pass
        for c in list(self._conns):
            c.closed = True
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            conn = _Connection(self, sock)
            self._conns.append(conn)
            threading.Thread(
                target=conn.run, name="fake-amqp-conn", daemon=True
            ).start()

    # -- queue ops --------------------------------------------------------
    def _queue(self, name: str) -> _BrokerQueue:
        with self._lock:
            if name not in self._queues:
                self._queues[name] = _BrokerQueue(name)
            return self._queues[name]

    def _publish(
        self, name: str, body: bytes, headers: dict | None = None
    ) -> None:
        q = self._queue(name)
        with self._lock:
            q.pending.append((body, False, headers))
        self._drain(q)

    def _attach_consumer(self, name: str, conn: _Connection) -> None:
        q = self._queue(name)
        with self._lock:
            q.consumers.append(conn)
        self._drain(q)

    def _drain(self, q: _BrokerQueue) -> None:
        """Deliver pending messages FIFO. Every publish and consumer attach
        funnels through here; the PER-QUEUE drain lock serializes drainers
        (so a new publish can never overtake an older backlog message)
        while the blocking socket send happens outside the broker-global
        lock — one slow consumer must not stall every queue or deadlock
        against a publisher blocked on its own send."""
        with q.drain_lock:
            while True:
                with self._lock:
                    if not q.pending:
                        return
                    consumer = q.next_consumer()
                    if consumer is None:
                        return
                    body, redelivered, headers = q.pending.popleft()
                try:
                    consumer.deliver(q.name, body, redelivered, headers)
                except OSError:
                    with self._lock:
                        q.pending.appendleft((body, redelivered, headers))
                    return

    def _requeue_unacked(self, conn: _Connection) -> None:
        """Connection died: everything it held unacked goes back to its
        queue at the HEAD (FIFO by delivery tag, AHEAD of messages
        published during the outage) — RabbitMQ's at-least-once
        redelivery, which replays requeued messages before younger ones.
        Head placement is what lets a reconnecting consumer rebuild the
        exact arrival order it saw before the drop (bus.amqp.
        SupervisedAmqpQueue relies on it)."""
        with conn.dlock:
            items = sorted(conn.unacked.items())
            conn.unacked.clear()
        by_queue: dict[str, list[tuple]] = {}
        for _tag, (qname, body, headers) in items:
            by_queue.setdefault(qname, []).append((body, headers))
        for qname, entries in by_queue.items():
            q = self._queue(qname)
            with self._lock:
                q.pending.extendleft(
                    (body, True, headers)
                    for body, headers in reversed(entries)
                )
            self._drain(q)

    def kill_connections(self, consuming: str | None = None) -> int:
        """Fault injection: abruptly close live connections (no Close
        handshake — kill -9 / network-partition equivalent). With
        `consuming` set, only connections consuming that queue die (the
        broker-side way to kill a specific consumer mid-stream). Unacked
        deliveries requeue via each connection's normal death path.
        Returns the number of connections killed.

        shutdown() before close(): close() alone does NOT wake a thread
        blocked in recv() on the same socket (neither our conn thread nor
        the peer would notice for seconds), while shutdown sends the FIN
        and interrupts both sides immediately — the kill must be
        OBSERVABLE at the instant it happens for fault schedules to be
        deterministic."""
        killed = 0
        for c in list(self._conns):
            if c.closed:
                continue
            if consuming is not None and consuming not in c.consuming:
                continue
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass
            killed += 1
        return killed

    def queue_depth(self, name: str) -> int:
        """Test introspection: messages waiting with no consumer."""
        with self._lock:
            q = self._queues.get(name)
            return len(q.pending) if q else 0
