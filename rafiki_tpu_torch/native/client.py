"""Python client and lifecycle helpers for the native kv/queue server.

The port's own copy of ``rafiki_tpu/native/client.py``: ``ensure_built``,
``KVServer``, ``KVClient`` (RESP framing over one socket, the
reconnect-with-backoff layer for verbs whose replay is idempotent, the
dedup pushes a reconnecting caller uses), ``CLIENT_STATS`` and
``wait_for_server``. The server is the port's own copy of the JAX
package's ``kv_server.cc`` (``rafiki_tpu_torch/native/kv_server.cc``):
``ensure_built`` compiles it with ``g++`` at first use into
``build/rafiki_tpu_torch/rafiki-kvd`` (a directory ``.gitignore`` lists),
again whenever the source is newer, writing a temporary name and
renaming it so a process that already runs the old binary keeps a valid
file; ``ensure_built(target="librbpe.so")`` builds the byte-BPE encoder
(``native/bpe_encoder.cc``) the same way, as a shared library, and
``ensure_built(target="librjpeg.so")`` the JPEG codec
(``native/jpeg_codec.cc``). The JAX build's sanitizer flavours are not
ported.

Crash survival: :class:`KVServer` can spawn the kvd with a
``--data-dir`` so every mutating command lands in a CRC-checksummed WAL
(compacted into an atomic-rename snapshot); a respawned kvd replays it.
``retry_window_s`` arms the client's reconnect layer; reconnects and
retries count into :data:`CLIENT_STATS` (``hub_reconnects_total`` /
``hub_rpc_retries_total``), which the predictor re-exports on its
``/metrics``.
"""

from __future__ import annotations

import logging
import os
import shutil
import socket
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from rafiki_tpu_torch.obs.metrics import StatsMap

SOURCE = Path(__file__).resolve().parent / "kv_server.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "rafiki_tpu_torch"
CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-pthread")
#: build target -> (source, extra g++ flags)
TARGETS = {"rafiki-kvd": (SOURCE, ()),
           "librbpe.so": (SOURCE.with_name("bpe_encoder.cc"),
                          ("-shared", "-fPIC")),
           "librjpeg.so": (SOURCE.with_name("jpeg_codec.cc"),
                           ("-shared", "-fPIC"))}

#: process-wide client-resilience counters, re-exported on every
#: /metrics surface that talks to the kvd (one socket layer, one truth)
CLIENT_STATS = StatsMap({"hub_reconnects_total": 0,
                         "hub_rpc_retries_total": 0})

#: verbs whose replay is idempotent (reads; SET/DEL/EXPIRE which
#: overwrite; dedup pushes which the server's recent-set makes safe;
#: STATS). Plain pops are included: a retried pop is a fresh command —
#: see the at-most-once note on :meth:`KVClient._cmd`.
_RETRYABLE = frozenset({
    "PING", "GET", "SET", "DEL", "EXISTS", "KEYS", "EXPIRE", "TTL",
    "LLEN", "LPUSHD", "RPUSHD", "LPOP", "RPOP", "STATS", "FLUSHALL"})

_build_lock = threading.Lock()


def ensure_built(force: bool = False, target: str = "rafiki-kvd") -> Path:
    """Compile ``target``'s source (``kv_server.cc`` for the kvd,
    ``bpe_encoder.cc`` for ``librbpe.so``, ``jpeg_codec.cc`` for
    ``librjpeg.so``) into ``build/rafiki_tpu_torch/``
    when the output is missing or older than the source (or ``force``);
    returns its path. ``g++`` writes a temporary name that is then
    renamed over the output. Raises ``RuntimeError`` when there is no
    ``g++`` or the compile fails."""
    source, flags = TARGETS[target]
    out = BUILD_DIR / target
    with _build_lock:
        if not force and out.exists() and \
                out.stat().st_mtime >= source.stat().st_mtime:
            return out
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError(f"g++ not found; cannot build {target} "
                               f"from {source}")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXXFLAGS, *flags, "-o", str(tmp),
                               str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed building {source.name} "
                               f"(exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        return out


class KVServer:
    """Spawn/own a rafiki-kvd process (test + single-host deployments).

    ``data_dir`` arms WAL + snapshot persistence: the server replays it
    at boot, so a respawn on the same dir (and, for live clients, the
    same port) restores every durable blob, queue, and dedup id. A
    boot that refuses a corrupt WAL (server exit code 4) surfaces here
    as a RuntimeError carrying the server's structured JSON error."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 data_dir: Optional[str] = None,
                 fsync: Optional[str] = None,
                 wal_rotate_bytes: Optional[int] = None) -> None:
        binary = ensure_built()
        cmd = [str(binary), "--host", host, "--port", str(port)]
        if data_dir:
            cmd += ["--data-dir", str(data_dir)]
        if fsync:
            if fsync not in ("always", "everysec", "no"):
                raise ValueError(f"bad fsync policy {fsync!r} "
                                 "(always|everysec|no)")
            cmd += ["--fsync", fsync]
        if wal_rotate_bytes:
            cmd += ["--wal-rotate-bytes", str(int(wal_rotate_bytes))]
        self.data_dir = str(data_dir) if data_dir else None
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      text=True)
        line = self._proc.stdout.readline()  # "... listening on H:P"
        if "listening on" not in line:
            # a corrupt WAL prints a structured JSON error and exits 4
            # instead of serving wrong state — surface that verbatim
            self._proc.wait(timeout=5)
            raise RuntimeError(f"rafiki-kvd failed to start: {line!r} "
                               f"(rc={self._proc.returncode})")
        hp = line.rsplit(" ", 1)[-1].strip()
        self.host, _, port_s = hp.partition(":")
        self.port = int(port_s)

    def stop(self) -> None:
        try:
            KVClient(self.host, self.port).shutdown()
        except OSError:
            pass
        try:
            self._proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self._proc.kill()

    def __enter__(self) -> "KVServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


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
        self._buf = bytearray()
        self._connect()  # constructor contract: raises if unreachable

    # ---- connection lifecycle ----
    def _connect(self) -> None:
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._connect_timeout)
        sock.settimeout(self._op_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._buf = bytearray()

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError as e:
                logging.getLogger(__name__).debug(
                    "kv socket close failed: %s", e)
            self._sock = None
        self._buf = bytearray()

    def drop_conn(self) -> None:
        """Force-close the socket (chaos / tests): the next command
        finds a dead transport and exercises the reconnect layer."""
        with self._lock:
            self._teardown()

    # ---- framing ----
    # Linear in the reply's size: the buffer grows in place, and a bulk
    # reply longer than what is buffered is received straight into its
    # own buffer. (The JAX client rebuilds an immutable buffer on every
    # 64 KB chunk, so a reply of n bytes costs O(n^2): a 128 MB GET takes
    # about 1.5 minutes there.)
    def _recv_more(self) -> None:
        if self._sock is None:
            raise ConnectionError("kv client not connected")
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("kv server closed connection")
        self._buf += chunk

    def _read_line(self) -> bytes:
        start = 0
        while True:
            i = self._buf.find(b"\r\n", start)
            if i >= 0:
                break
            start = max(0, len(self._buf) - 1)
            self._recv_more()
        line = bytes(self._buf[:i])
        del self._buf[:i + 2]
        return line

    def _read_n(self, n: int) -> bytes:
        have = len(self._buf)
        if have >= n:
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out
        if self._sock is None:
            raise ConnectionError("kv client not connected")
        out = bytearray(n)
        out[:have] = self._buf
        self._buf = bytearray()
        view = memoryview(out)
        while have < n:
            got = self._sock.recv_into(view[have:], n - have)
            if not got:
                raise ConnectionError("kv server closed connection")
            have += got
        return bytes(out)

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
    def ping(self) -> bool:
        return self._cmd("PING") == "PONG"

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

    def incr(self, key: str) -> int:
        return int(self._cmd("INCR", key))

    def lpush(self, key: str, *values: bytes) -> int:
        return int(self._cmd("LPUSH", key, *values))

    def rpush(self, key: str, *values: bytes) -> int:
        return int(self._cmd("RPUSH", key, *values))

    def lpush_dedup(self, key: str, dedup_id: str, *values: bytes) -> int:
        """Deduplicated LPUSH: the server keeps a bounded recent-set of
        ``dedup_id``s (persisted in the WAL), so a RETRY of this exact
        push — after a connection drop or a kvd respawn — never
        double-delivers. The id is client-minted (uuid per logical
        push)."""
        return int(self._cmd("LPUSHD", key, dedup_id, *values))

    def rpush_dedup(self, key: str, dedup_id: str, *values: bytes) -> int:
        return int(self._cmd("RPUSHD", key, dedup_id, *values))

    def lpop(self, key: str) -> Optional[bytes]:
        return self._cmd("LPOP", key)

    def rpop(self, key: str) -> Optional[bytes]:
        return self._cmd("RPOP", key)

    def llen(self, key: str) -> int:
        return int(self._cmd("LLEN", key))

    def expire(self, key: str, seconds: float) -> None:
        """Condemn ``key`` (kv or list) ``seconds`` from now. kvd delta
        vs Redis: the key need not exist yet and the TTL survives
        DEL/recreation until it fires — see kv_server.cc."""
        self._cmd("EXPIRE", key, seconds)

    def ttl(self, key: str) -> int:
        """Redis semantics: -2 missing key, -1 no expiry, else whole
        seconds remaining."""
        return int(self._cmd("TTL", key))

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

    def stats(self) -> Dict[str, object]:
        """The kvd's ``STATS`` verb (persistence health): wal_bytes,
        snapshot_bytes, snapshot_age_s, last_fsync_age_s,
        replay_seconds, replayed_records, wal_truncated_bytes,
        compactions, dedup_ids, keys, lists, fsync_policy."""
        raw = self._cmd("STATS")
        out: Dict[str, object] = {}
        for line in (raw or b"").decode().splitlines():
            key, _, val = line.partition(" ")
            if not key:
                continue
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
        return out

    def compact(self) -> None:
        """Force a WAL compaction into a fresh snapshot (operator /
        test hook; the server also rotates automatically past
        ``--wal-rotate-bytes``)."""
        self._cmd("COMPACT")

    def flushall(self) -> None:
        self._cmd("FLUSHALL")

    def shutdown(self) -> None:
        try:
            self._cmd("SHUTDOWN")
        except (ConnectionError, RuntimeError):
            pass

    def close(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass


def wait_for_server(host: str, port: int, timeout: float = 10.0) -> KVClient:
    """Connect with retries until the server answers PING."""
    deadline = time.monotonic() + timeout
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            c = KVClient(host, port, connect_timeout=1.0)
            if c.ping():
                return c
        except OSError as e:
            last = e
            time.sleep(0.05)
    raise TimeoutError(f"kv server at {host}:{port} not up: {last}")
