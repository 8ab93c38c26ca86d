"""Python client for the kv/queue data-plane server.

The port's own copy of ``KVClient`` and ``CLIENT_STATS`` from
``rafiki_tpu/native/client.py`` (``_encode``, ``KVClient``): RESP framing
over one socket, the reconnect-with-backoff layer for verbs whose replay
is idempotent, the dedup pushes a reconnecting caller uses, and the
process-wide reconnect/retry counters. The server binary itself
(``KVServer``, ``ensure_built``) belongs to the JAX package's native
build and is not copied: the port talks to a running server.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from rafiki_tpu_torch.obs.metrics import StatsMap

CLIENT_STATS = StatsMap({"hub_reconnects_total": 0,
                         "hub_rpc_retries_total": 0})

#: verbs whose replay is idempotent (reads; SET/DEL/EXPIRE which
#: overwrite; dedup pushes which the server's recent-set makes safe;
#: STATS). Plain pops are included: a retried pop is a fresh command —
#: see the at-most-once note on :meth:`KVClient._cmd`.
_RETRYABLE = frozenset({
    "PING", "GET", "SET", "DEL", "EXISTS", "KEYS", "EXPIRE", "TTL",
    "LLEN", "LPUSHD", "RPUSHD", "LPOP", "RPOP", "STATS", "FLUSHALL"})



def _encode(args: List[bytes]) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


class KVClient:
    """Blocking client; thread-safe (one socket, one lock).

    For concurrent blocking pops (inference workers) use one client per
    thread — a BRPOP holds the socket for up to its timeout.

    ``retry_window_s > 0`` arms the reconnect layer: a connection error
    on a retryable verb triggers reconnect-with-exponential-backoff and
    a transparent re-send for up to that many seconds before a
    ``ConnectionError`` finally surfaces. The window bounds how long a
    caller can stall on a dead data plane — the predictor keeps it
    short (fast-fail into a structured 503), workers keep it long
    enough to ride out a supervised kvd respawn + WAL replay.

    At-most-once edge: a non-blocking pop whose reply is lost between
    the server's WAL append and the socket write loses that one message
    on retry. The window is microseconds around a server crash; queue
    consumers that cannot tolerate it already re-request via their own
    end-to-end protocol (stream resumes, gather timeouts).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 6399,
                 connect_timeout: float = 5.0,
                 retry_window_s: float = 0.0,
                 op_timeout_s: Optional[float] = None) -> None:
        """``op_timeout_s`` bounds every socket read/write (None = the
        default, block forever — what BRPOP holders need). Probe-style
        callers (the admin's cached STATS scrape) set it so a wedged
        or compaction-busy kvd surfaces as a caught timeout instead of
        hanging the prober."""
        self._host, self._port = host, port
        self._connect_timeout = connect_timeout
        self._op_timeout_s = op_timeout_s
        self.retry_window_s = float(retry_window_s)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._connect()  # constructor contract: raises if unreachable

    # ---- connection lifecycle ----
    def _connect(self) -> None:
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._connect_timeout)
        sock.settimeout(self._op_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._buf = b""

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError as e:
                logging.getLogger(__name__).debug(
                    "kv socket close failed: %s", e)
            self._sock = None
        self._buf = b""

    # ---- framing ----
    def _recv_more(self) -> None:
        if self._sock is None:
            raise ConnectionError("kv client not connected")
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("kv server closed connection")
        self._buf += chunk

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            self._recv_more()
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_n(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._recv_more()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_reply(self):
        line = self._read_line()
        tag, rest = line[:1], line[1:]
        if tag == b"+":
            return rest.decode()
        if tag == b"-":
            raise RuntimeError(rest.decode())
        if tag == b":":
            return int(rest)
        if tag == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._read_n(n)
            self._read_n(2)  # CRLF
            return data
        if tag == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RuntimeError(f"bad reply tag {line!r}")

    def _send_recv(self, enc: bytes):
        if self._sock is None:
            raise ConnectionError("kv client not connected")
        self._sock.sendall(enc)
        return self._read_reply()

    def _reconnect_and_retry(self, enc: bytes, verb: str,
                             first_err: Exception,
                             deadline: Optional[float] = None):
        """The reconnect layer: exponential backoff up to
        ``retry_window_s`` (or an explicit monotonic ``deadline``),
        re-sending ``enc`` after each successful reconnect. Caller
        holds the lock. Raises ConnectionError when the window
        closes."""
        log = logging.getLogger(__name__)
        if deadline is None:
            deadline = time.monotonic() + self.retry_window_s
        backoff = 0.05
        last: Exception = first_err
        log.warning("kv connection lost during %s (%s): retrying for "
                    "up to %.1fs", verb, first_err,
                    max(0.0, deadline - time.monotonic()))
        while True:
            self._teardown()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ConnectionError(
                    f"kv server {self._host}:{self._port} unreachable "
                    f"after retry window ({verb}): {last}") from last
            time.sleep(min(backoff, remaining))
            backoff = min(backoff * 2, 1.0)
            try:
                self._connect()
                CLIENT_STATS.inc("hub_reconnects_total")
                CLIENT_STATS.inc("hub_rpc_retries_total")
                return self._send_recv(enc)
            except (OSError, ConnectionError) as e:
                last = e  # next loop iteration backs off and re-tries

    def _cmd(self, *args) -> object:
        enc_args = [a if isinstance(a, bytes) else str(a).encode()
                    for a in args]
        verb = enc_args[0].decode().upper()
        enc = _encode(enc_args)
        with self._lock:
            try:
                if self._sock is None:
                    # a prior drop/teardown left no transport: treat
                    # like a mid-command drop (retry path decides)
                    raise ConnectionError("kv client not connected")
                # _lock is held across the socket round-trip by
                # design: one socket carries one request/response at
                # a time, so the recv IS the critical section
                return self._send_recv(enc)
            except (OSError, ConnectionError) as e:
                if self.retry_window_s <= 0 or verb not in _RETRYABLE:
                    self._teardown()
                    raise ConnectionError(
                        f"kv server {self._host}:{self._port} "
                        f"connection lost ({verb}): {e}") from e
                # reconnect backoff must also stay under _lock: other
                # threads' commands cannot use the dead socket anyway
                return self._reconnect_and_retry(enc, verb, e)

    # ---- api ----
    def set(self, key: str, value: bytes) -> None:
        self._cmd("SET", key, value)

    def get(self, key: str) -> Optional[bytes]:
        return self._cmd("GET", key)

    def delete(self, *keys: str) -> int:
        return int(self._cmd("DEL", *keys))

    def exists(self, key: str) -> bool:
        return bool(self._cmd("EXISTS", key))

    def keys(self, pattern: str = "*") -> List[str]:
        return sorted(k.decode() for k in self._cmd("KEYS", pattern))

    def lpush_dedup(self, key: str, dedup_id: str, *values: bytes) -> int:
        """Deduplicated LPUSH: the server keeps a bounded recent-set of
        ``dedup_id``s (persisted in the WAL), so a RETRY of this exact
        push — after a connection drop or a kvd respawn — never
        double-delivers. The id is client-minted (uuid per logical
        push)."""
        return int(self._cmd("LPUSHD", key, dedup_id, *values))

    def rpop(self, key: str) -> Optional[bytes]:
        return self._cmd("RPOP", key)

    def llen(self, key: str) -> int:
        return int(self._cmd("LLEN", key))

    def expire(self, key: str, seconds: float) -> None:
        """Condemn ``key`` (kv or list) ``seconds`` from now. kvd delta
        vs Redis: the key need not exist yet and the TTL survives
        DEL/recreation until it fires — see kv_server.cc."""
        self._cmd("EXPIRE", key, seconds)

    def brpop(self, keys, timeout: float
              ) -> Optional[Tuple[str, bytes]]:
        """Blocking tail-pop across ``keys``; None on timeout.

        With the reconnect layer armed, a connection lost mid-wait
        RESUMES on a fresh socket with the remaining timeout — an
        in-flight blocking pop survives a kvd respawn (the queue
        content survives via the WAL)."""
        if isinstance(keys, str):
            keys = [keys]
        enc_keys = list(keys)
        deadline = None if timeout <= 0 else time.monotonic() + timeout
        while True:
            remaining = timeout if deadline is None \
                else deadline - time.monotonic()
            if deadline is not None and remaining <= 0:
                return None
            enc = _encode([b"BRPOP"]
                          + [k.encode() if isinstance(k, str) else k
                             for k in enc_keys]
                          + [str(remaining).encode()])
            with self._lock:
                try:
                    if self._sock is None:
                        raise ConnectionError("kv client not connected")
                    # held across the blocking pop on purpose: the
                    # socket is single-flight 
                    reply = self._send_recv(enc)
                except (OSError, ConnectionError) as e:
                    if self.retry_window_s <= 0:
                        self._teardown()
                        raise ConnectionError(
                            f"kv server {self._host}:{self._port} "
                            f"connection lost (BRPOP): {e}") from e
                    # reconnect within the retry window, then LOOP to
                    # reissue with the remaining pop budget (the wait
                    # budget itself is the caller's, not the window's)
                    retry_dl = time.monotonic() + self.retry_window_s
                    if deadline is not None:
                        retry_dl = max(retry_dl, deadline)
                    reply = self._reconnect_and_retry(
                        _encode([b"PING"]), "BRPOP", e,
                        deadline=retry_dl)
                    if reply != "PONG":
                        raise ConnectionError(
                            "kv server answered garbage to the "
                            "reconnect probe") from e
                    continue  # fresh socket: reissue the blocking pop
            if reply is None:
                return None
            k, v = reply
            return k.decode(), v

    def close(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
