"""Dependency-free RESP2 socket client — the wire protocol the reference
speaks to Redis (go-redis v8 client built at gomengine/redis/redis.go:17-28;
every book operation in the reference is a RESP command against the schema
in SURVEY §2.1).

redis-py is not a dependency, so this is a self-contained protocol
implementation, as the reference's bus/amqp.py is for AMQP 0-9-1: the
framework can reach a REAL Redis server (live gome migration, external
pre-pool marker store) with zero dependencies. The fake server half lives in
persist/respserver.py.

Protocol (RESP2): a command is an array of bulk strings
(`*N\r\n` then `$len\r\n<bytes>\r\n` per arg); replies are simple strings
(`+OK`), errors (`-ERR ...`), integers (`:n`), bulk strings (`$n`, `$-1`
null) or arrays (`*n`, `*-1` null). Pipelining is plain batching: write N
commands, read N replies — `pipeline()` exposes that, and it is what makes
a remote pre-pool viable on the hot path (one round trip per FRAME of
HDELs, not one per order).

The port of ``gome_tpu/persist/resp.py``: the same bytes on the wire, so
either package's client talks to either package's server.
"""

from __future__ import annotations

import socket
import threading


class RespError(Exception):
    """Server-side error reply (`-ERR ...`)."""


def encode_command(*args) -> bytes:
    """Encode one command as a RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, str):
            b = a.encode()
        elif isinstance(a, (int, float)):
            b = repr(a).encode() if isinstance(a, float) else b"%d" % a
        else:
            raise TypeError(f"cannot encode {type(a).__name__} as RESP arg")
        out.append(b"$%d\r\n" % len(b))
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


class _Reader:
    """Buffered RESP reply parser over a socket (or any recv(n) source)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()
        self._pos = 0

    def _fill(self) -> None:
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("RESP connection closed by peer")
        # Compact consumed prefix occasionally so the buffer stays bounded.
        if self._pos > 1 << 20:
            del self._buf[: self._pos]
            self._pos = 0
        self._buf.extend(chunk)

    def _readline(self) -> bytes:
        while True:
            nl = self._buf.find(b"\r\n", self._pos)
            if nl >= 0:
                line = bytes(self._buf[self._pos : nl])
                self._pos = nl + 2
                return line
            self._fill()

    def _readn(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n + 2:
            self._fill()
        data = bytes(self._buf[self._pos : self._pos + n])
        self._pos += n + 2  # skip trailing \r\n
        return data

    def read_reply(self):
        line = self._readline()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            return self._readn(n)
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self.read_reply() for _ in range(n)]
        raise RespError(f"malformed RESP reply: {line!r}")


class RespClient:
    """One RESP2 connection. Thread-safe (a lock serializes round trips);
    execute_command matches redis-py's surface so redis_schema's
    export_to_redis works unchanged, and the three read primitives
    (`keys`, `zrange`, `hgetall`) satisfy redis_restore's store contract."""

    def __init__(
        self, host: str = "127.0.0.1", port: int = 6379,
        timeout_s: float = 10.0, db: int = 0, password: str | None = None,
    ):
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = _Reader(self._sock)
        self._lock = threading.Lock()
        # The reference ignores the configured password and uses DB 0
        # (redis.go:20-24); we honor both if given.
        if password:
            self.execute_command("AUTH", password)
        if db:
            self.execute_command("SELECT", db)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def execute_command(self, *args):
        with self._lock:
            self._sock.sendall(encode_command(*args))
            return self._reader.read_reply()

    def pipeline(self, commands: list[tuple]) -> list:
        """Send every command in one write, read all replies — ONE network
        round trip for the whole batch. Errors are returned in-place (as
        RespError instances) rather than raised, so one bad command does
        not orphan the replies behind it."""
        if not commands:
            return []
        payload = b"".join(encode_command(*c) for c in commands)
        out = []
        with self._lock:
            self._sock.sendall(payload)
            for _ in commands:
                try:
                    out.append(self._reader.read_reply())
                except RespError as e:
                    out.append(e)
        return out

    # -- redis_restore's read primitives ----------------------------------
    def keys(self, pattern: str = "*") -> list[str]:
        return [k.decode() for k in self.execute_command("KEYS", pattern)]

    def zrange(self, key: str, start: int = 0, end: int = -1) -> list[str]:
        return [
            m.decode()
            for m in self.execute_command("ZRANGE", key, start, end)
        ]

    def hgetall(self, key: str) -> dict[str, str]:
        flat = self.execute_command("HGETALL", key)
        it = iter(flat)
        return {k.decode(): v.decode() for k, v in zip(it, it)}

    # -- conveniences used by the pre-pool and tests -----------------------
    def ping(self) -> bool:
        return self.execute_command("PING") == "PONG"

    def flushdb(self) -> None:
        self.execute_command("FLUSHDB")

    def hset(self, key: str, field: str, value: str) -> int:
        return self.execute_command("HSET", key, field, value)

    def hdel(self, key: str, *fields: str) -> int:
        return self.execute_command("HDEL", key, *fields)

    def hexists(self, key: str, field: str) -> bool:
        return self.execute_command("HEXISTS", key, field) == 1


class SupervisedRespClient:
    """A RespClient under supervision (utils.resilience.Supervised): a
    dead store connection reconnects under backoff + circuit breaker, the
    session is re-established (AUTH/SELECT replay happens in the
    RespClient constructor), and the failed command retries on the fresh
    connection. Same surface as RespClient, so RespPrePool, redis_schema
    and redis_restore take it unchanged.

    Retry semantics: HSET/HGETALL/KEYS/ZRANGE/… retries are idempotent.
    HDEL (the pre-pool's consume path) has the classic ambiguity window —
    a server that applied the delete but died before replying makes the
    retried command report 0 — which maps onto the engine's at-least-once
    replay exactly like a lost-reply Redis deployment would; exact-once
    marker consumption across store crashes needs transactional markers,
    which neither the reference nor this port has."""

    def __init__(
        self, host: str = "127.0.0.1", port: int = 6379,
        timeout_s: float = 10.0, db: int = 0, password: str | None = None,
        name: str | None = None, policy=None, breaker=None,
    ):
        from ..utils.resilience import Supervised

        def factory():
            return RespClient(host, port, timeout_s, db, password)

        self._sup = Supervised(
            name or f"resp:{host}:{port}", factory,
            policy=policy, breaker=breaker,
        )
        # One eager dial, no backoff: boot fallback (service/app.py keeps
        # the in-process pool when the store is down) must be fast.
        try:
            self._sup.prime()
        except BaseException:
            self._sup.close()
            raise

    def supervisor(self):
        return self._sup

    def execute_command(self, *args):
        return self._sup.call(lambda c: c.execute_command(*args))

    def pipeline(self, commands: list[tuple]) -> list:
        return self._sup.call(lambda c: c.pipeline(commands))

    # RespClient's full read/convenience surface, supervised.
    def keys(self, pattern: str = "*") -> list[str]:
        return self._sup.call(lambda c: c.keys(pattern))

    def zrange(self, key: str, start: int = 0, end: int = -1) -> list[str]:
        return self._sup.call(lambda c: c.zrange(key, start, end))

    def hgetall(self, key: str) -> dict[str, str]:
        return self._sup.call(lambda c: c.hgetall(key))

    def ping(self) -> bool:
        return self._sup.call(lambda c: c.ping())

    def flushdb(self) -> None:
        return self._sup.call(lambda c: c.flushdb())

    def hset(self, key: str, field: str, value: str) -> int:
        return self._sup.call(lambda c: c.hset(key, field, value))

    def hdel(self, key: str, *fields: str) -> int:
        return self._sup.call(lambda c: c.hdel(key, *fields))

    def hexists(self, key: str, field: str) -> bool:
        return self._sup.call(lambda c: c.hexists(key, field))

    def close(self) -> None:
        self._sup.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
